// Scale space of a frame batch for Hopper (sm_90a).
//
// Replaces the TPU kernel rebvo_tpu/kernels/pallas_scale_space.py:
// build_scale_space_pallas (body _sspace_kernel). One launch computes, per
// pixel of a [B, H, W] float32 frame batch, the five maps of the
// reference's sspace::build (src/mtracklib/sspace.cpp:52-85):
//   * img1 and img0, two clipped, normalised Kovesi box chains (sizes1,
//     sizes0), each box pass a vertical then a horizontal shift-and-add
//     sum divided by the clipped window size;
//   * dog = img1 - img0;
//   * dx, dy, the central-difference gradient of img0, zero on the 1-pixel
//     image border.
// The operation order follows the Pallas kernel and the plain PyTorch
// version (kernels/cuda_scale_space.py, build_scale_space_plain), and the
// build uses --fmad=false, so the card gives the plain version's floats.
//
// Bound. Per pixel the kernel must read the frame once (4 B) and write five
// f32 maps once (20 B): 24 B/px, 8.7 MB for one 480x752 frame, against about
// 51 float operations per pixel (counted in chip_smoke.py), so bytes bound it
// (about 2.6 us at the H100 SXM's 3.35 TB/s). Design: K1's tile pipeline
// (tile_pipeline.cuh) without the detector. Phase P writes img0 over a
// 1-pixel band (the gradient's) and img1 over the tile; the output phase
// gives a thread 4 adjacent pixels of one row, float4 loads from shared
// memory and five float4 stores. 5 barriers in all.

#include <stdint.h>

#include "tile_pipeline.cuh"

namespace {

using namespace tp;

struct SSpaceParams {
  int H, W;
  Plan plan;
  int vec_in, vec_out;
};

// The default plan: sizes0 = [3, 3, 5], sizes1 = [3, 5, 5]; img0 is needed
// one pixel past the tile, img1 on it: halo max(4 + 1, 5) = 5.
__host__ __device__ constexpr Plan k2_default_plan() {
  return Plan{5, {3, 3}, {{1, 1, 2, 0}, {1, 2, 2, 0}}, {1, 0}, 0};
}

template <bool FIXED, int HALO, int MAXR>
__global__ void __launch_bounds__(NTHREADS, 2)
sspace_kernel(const float* __restrict__ img, float* __restrict__ o0,
              float* __restrict__ o1, float* __restrict__ odog,
              float* __restrict__ odx, float* __restrict__ ody,
              const SSpaceParams p) {
  const Smem s = carve(dynamic_smem());
  const Plan pl = FIXED ? k2_default_plan() : p.plan;
  constexpr int SEG = (OH + 2 * HALO + NS - 1) / NS;
  const int H = p.H, W = p.W;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * OH;
  const int ox0 = blockIdx.x * OW;
  const size_t plane = (size_t)H * W;

  load_tile(s, pl, img + b * plane, p.vec_in, oy0, ox0, H, W);
  chain_phases<SEG, MAXR, FIXED ? MAX_BOXES : 1>(s, pl, oy0, ox0, H, W);
  // phase P: img0 (outa) over [-1, OH + 1), img1 (outb) over the tile
  chain_final<SEG, MAXR>(s, pl, 0, s.outa, oy0, ox0, H, W);
  chain_final<SEG, MAXR>(s, pl, 1, s.outb, oy0, ox0, H, W);
  __syncthreads();

  // output phase: 4 pixels of one row a thread
  const int tid = threadIdx.y * NX + threadIdx.x;
  if (tid >= GROUPS * OH) return;
  const int rho = tid / GROUPS;
  const int kap0 = 4 * (tid - rho * GROUPS);
  const int gy = oy0 + rho;
  const int gx0 = ox0 + kap0;
  if (gy >= H || gx0 >= W) return;
  const int i = (rho + HP) * NX + kap0 + HP;
  float a0c[12], a0d[4], a0u[4], x1[4];
  load4<3>(a0c, s.outa + i - 4);
  load4<1>(a0d, s.outa + i + NX);
  load4<1>(a0u, s.outa + i - NX);
  load4<1>(x1, s.outb + i);
  float x0[4], dog[4], dx[4], dy[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int gx = gx0 + u;
    x0[u] = a0c[4 + u];
    dog[u] = __fsub_rn(x1[u], x0[u]);
    dx[u] = 0.f;
    dy[u] = 0.f;
    if (gy > 0 && gy < H - 1 && gx > 0 && gx < W - 1) {
      dx[u] = __fsub_rn(a0c[4 + u + 1], a0c[4 + u - 1]);
      dy[u] = __fsub_rn(a0d[u], a0u[u]);
    }
  }
  const size_t o = b * plane + (size_t)gy * W + gx0;
  const int n = min(4, W - gx0);
  const bool vec = p.vec_out && n == 4;
  store4(o0, o, x0, vec, n);
  store4(o1, o, x1, vec, n);
  store4(odog, o, dog, vec, n);
  store4(odx, o, dx, vec, n);
  store4(ody, o, dy, vec, n);
}

// the two instantiations: the default plan, and any plan read at run time
#define K2_FIXED sspace_kernel<true, 5, 2>
#define K2_RUNTIME sspace_kernel<false, MAX_HALO, MAX_HALO>

}  // namespace

#ifndef TP_HOST_EMU
// Allows both instantiations their dynamic shared memory (over 48 KB);
// called once when the library is loaded, before any launch or capture.
extern "C" int build_scale_space_init() {
  cudaError_t e = cudaFuncSetAttribute(
      K2_FIXED, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        K2_RUNTIME, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  return (int)e;
}

// Resident blocks per SM of one instantiation (fixed != 0: the default
// plan's) at the launcher's block and shared memory, from the occupancy
// calculator.
extern "C" int build_scale_space_occupancy(int fixed, int* blocks) {
  const dim3 b = launch_block();
  const int threads = b.x * b.y * b.z;
  return (int)(fixed ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, K2_FIXED, threads, SMEM_BYTES)
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, K2_RUNTIME, threads, SMEM_BYTES));
}
#endif

// The dynamic shared bytes and threads per block the launcher passes.
extern "C" void build_scale_space_launch_config(int* smem_bytes,
                                                int* threads) {
  const dim3 b = launch_block();
  *smem_bytes = SMEM_BYTES;
  *threads = b.x * b.y * b.z;
}

// Launches K2 on a [B, H, W] frame batch with the plan and the gx x gy
// tile grid of kernels/cuda_scale_space.launch_plan (halo, margins e0 of
// img0 and e1 of img1, chain c's n_c radii r_c, fixed != 0 for the default
// plan's instantiation), checked, not recomputed: cudaErrorInvalidValue if
// the kernel cannot run them.
extern "C" int build_scale_space_launch(
    const float* img, float* img0, float* img1, float* dog, float* dx,
    float* dy, int B, int H, int W, int gx, int gy, int halo, int e0, int e1,
    const int* r0, int n0, const int* r1, int n1, int fixed, void* stream) {
  SSpaceParams p;
  if (!plan_from_args(&p.plan, halo, 0, e0, e1, r0, n0, r1, n1) || e0 < 1 ||
      !grid_covers(gx, gy, H, W) ||
      (fixed && !same_plan(p.plan, k2_default_plan())))
    return (int)cudaErrorInvalidValue;
  p.H = H;
  p.W = W;
  p.vec_out = W % 4 == 0;
  p.vec_in = p.vec_out && (uintptr_t)img % 16 == 0;
  const dim3 grid(gx, gy, B);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)launch_kernel(fixed ? K2_FIXED : K2_RUNTIME, grid,
                            launch_block(), SMEM_BYTES, st, img, img0, img1,
                            dog, dx, dy, p);
}
