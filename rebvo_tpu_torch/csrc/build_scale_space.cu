// Scale space of a frame batch for Hopper (sm_90a).
//
// Replaces the TPU kernel rebvo_tpu/kernels/pallas_scale_space.py:
// build_scale_space_pallas (body _sspace_kernel). One launch computes, per
// pixel of a [B, H, W] float32 frame batch, the five maps of the
// reference's sspace::build (src/mtracklib/sspace.cpp:52-85):
//   * img1 and img0, two clipped, normalised Kovesi box chains (sizes1,
//     sizes0), each box pass a vertical then a horizontal shift-and-add
//     sum divided by the clipped window size (scale_space_tile.cuh);
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
// (about 2.6 us at the H100 SXM's 3.35 TB/s). Design: K1's schedule without
// the detector tests. One 256-thread block per 32x32 output tile (a grid
// dimension for the batch); the tile and a halo of max(r0 + 1, r1) pixels
// (5 at the defaults: the sizes1 chain's radius, and the sizes0 chain's
// radius plus the gradient's pixel; passed in by the wrapper) are loaded
// into shared memory once, both chains run there, and each output map is
// written once. Device memory then sees the bound's bytes plus the halo's
// re-reads of the input (42^2/32^2 = 1.7x, mostly served by L2). Like K1,
// this first version keeps one pass at a time behind __syncthreads().

#include <cuda_runtime.h>

#include "scale_space_tile.cuh"

namespace {

using sstile::box_pass;
using sstile::inside;

constexpr int TILE = 32;
constexpr int MAX_HALO = 8;
constexpr int SMAX = TILE + 2 * MAX_HALO;
constexpr int MAX_BOXES = 4;
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;
constexpr int ROWS_PER_THREAD = TILE / BLOCK_Y;

struct SSpaceParams {
  int H, W;
  int halo;
  int n0, n1;
  int sizes0[MAX_BOXES];
  int sizes1[MAX_BOXES];
};

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
sspace_kernel(const float* __restrict__ img, float* __restrict__ o0,
              float* __restrict__ o1, float* __restrict__ odog,
              float* __restrict__ odx, float* __restrict__ ody,
              SSpaceParams p) {
  __shared__ float sh[3][SMAX * SMAX];
  float* A1 = sh[0];   // sizes1 chain
  float* A0 = sh[1];   // sizes0 chain
  float* TMP = sh[2];  // vertical sums

  const int T = TILE + 2 * p.halo;
  const int NT = T * T;
  const int b = blockIdx.z;
  const int gy0 = blockIdx.y * TILE - p.halo;
  const int gx0 = blockIdx.x * TILE - p.halo;
  const size_t plane = (size_t)p.H * p.W;
  const float* src = img + b * plane;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  for (int i = tid; i < NT; i += nthr) {
    const int r = i / T;
    const int c = i - r * T;
    const int gy = gy0 + r;
    const int gx = gx0 + c;
    const float v = inside(gy, gx, p.H, p.W) ? src[(size_t)gy * p.W + gx] : 0.f;
    A1[i] = v;
    A0[i] = v;
    TMP[i] = 0.f;
  }
  __syncthreads();

  for (int k = 0; k < p.n1; ++k)
    if (p.sizes1[k] > 1) box_pass(A1, TMP, p.sizes1[k], T, gy0, gx0, p.H, p.W);
  for (int k = 0; k < p.n0; ++k)
    if (p.sizes0[k] > 1) box_pass(A0, TMP, p.sizes0[k], T, gy0, gx0, p.H, p.W);

  const int ox = threadIdx.x;
  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    const int oy = threadIdx.y + BLOCK_Y * j;
    const int gy = blockIdx.y * TILE + oy;
    const int gx = blockIdx.x * TILE + ox;
    if (gy >= p.H || gx >= p.W) continue;
    const int i = (p.halo + oy) * T + p.halo + ox;
    const float x0 = A0[i];
    const float x1 = A1[i];
    float dx = 0.f, dy = 0.f;
    if (gy > 0 && gy < p.H - 1 && gx > 0 && gx < p.W - 1) {
      dx = __fsub_rn(A0[i + 1], A0[i - 1]);
      dy = __fsub_rn(A0[i + T], A0[i - T]);
    }
    const size_t o = b * plane + (size_t)gy * p.W + gx;
    o0[o] = x0;
    o1[o] = x1;
    odog[o] = __fsub_rn(x1, x0);
    odx[o] = dx;
    ody[o] = dy;
  }
}

}  // namespace

extern "C" int build_scale_space_launch(
    const float* img, float* img0, float* img1, float* dog, float* dx,
    float* dy, int B, int H, int W, const int* sizes0, int n0,
    const int* sizes1, int n1, int halo, void* stream) {
  if (halo > MAX_HALO || n0 > MAX_BOXES || n1 > MAX_BOXES)
    return (int)cudaErrorInvalidValue;
  SSpaceParams p;
  p.H = H;
  p.W = W;
  p.halo = halo;
  p.n0 = n0;
  p.n1 = n1;
  for (int k = 0; k < MAX_BOXES; ++k) {
    p.sizes0[k] = k < n0 ? sizes0[k] : 1;
    p.sizes1[k] = k < n1 ? sizes1[k] : 1;
  }
  dim3 block(BLOCK_X, BLOCK_Y);
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  sspace_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, img0, img1,
                                                          dog, dx, dy, p);
  return (int)cudaGetLastError();
}
