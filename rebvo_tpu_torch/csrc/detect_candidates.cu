// Fused frame -> edge-detector candidates for Hopper (sm_90a).
//
// Replaces the TPU kernel rebvo_tpu/kernels/pallas_scale_space.py:
// detect_candidates_pallas (body _detect_kernel). One launch computes, per
// pixel of a [B, H, W] float32 frame batch:
//   * two clipped, normalised Kovesi box chains (sizes0, sizes1), each box
//     pass a vertical then a horizontal shift-and-add sum, divided by the
//     clipped window size rebuilt from global coordinates (one multiply by
//     the row reciprocal, then one by the column reciprocal);
//   * the DoG img1 - img0 and the central-difference gradient of img0
//     (zero on the 1-pixel image border);
//   * the detector tests t1 (gradient norm), t2 (DoG sign balance over a
//     (2w+1)^2 window), t3 (plane-fit offsets <= 0.5), t4 (plane-fit slope)
//     and the w-pixel interior;
// and writes six maps: mask (uint8 0/1), theta_x, theta_y, xs, ys, n2_m.
// The operation order of every sum follows the Pallas kernel (and the
// plain PyTorch version, kernels/cuda_scale_space.py), and the build uses
// --fmad=false, so no a*b+c is fused into one rounding: the threshold tests
// then see the same floats on the card as on the CPU.
//
// Bound. Per pixel the kernel must read the frame once (4 B) and write the
// six maps once (1 + 5*4 = 21 B): 25 B/px, 9.0 MB for one 480x752 frame,
// against about 116 float operations per pixel (counted in chip_smoke.py),
// so bytes bound it (about 2.7 us on an H100 SXM at 3.35 TB/s). What held
// the first version back was the instruction schedule around the
// arithmetic, and the design answers it (tile_pipeline.cuh): a 30x48
// output tile per 384-thread block, the box chains in 3 phases where a
// thread walks one column with the vertical sums in registers, each pass
// over only the band later passes read, reciprocal tables instead of
// per-cell divisions, 16-byte loads and stores; 5 barriers in all.
//
// Detector part, after the chains: phase P writes img0 over a band of
// max(w, 1) pixels around the tile (the gradient reads 1), the DoG and its
// sign over a band of w pixels (the plane-fit window's reach); the output
// phase gives a thread 4 adjacent pixels of one row. It walks the 2w+1
// window rows in the reference's order (0, +1, -1, +2, -2, ...), each row
// float4 loads of the DoG and the sign, and keeps in registers the
// vertical sums of the sign, of the DoG and of the j-weighted DoG for the
// 4 + 2w columns its horizontal sums read, and the vertical sum of the
// horizontally j-weighted DoG for its 4 pixels.

#include <stdint.h>

#include "tile_pipeline.cuh"

namespace {

using namespace tp;

struct DetectParams {
  int H, W;
  Plan plan;
  int vec_in, vec_out;   // 16-byte loads of the frame, stores of the maps
  float pn_limit;        // win_area * per_hist
  float max_img_value;
  float dog_thresh;
  float sum_j2;          // (2w+1) * sum_j j^2
  float win_area;        // (2w+1)^2
};

// The default plan: Sigma0 = 1.7818, KSigma = 1.2599, box_n = 3 give
// sizes0 = [3, 3, 5], sizes1 = [3, 5, 5]; w = DetectorPlaneFitSize = 2.
__host__ __device__ constexpr Plan k1_default_plan() {
  return Plan{7, {3, 3}, {{1, 1, 2, 0}, {1, 2, 2, 0}}, {2, 2}, 2};
}

// __fdiv_rn(a, b), except that a zero `a` over a positive `b` returns `a`
// (the IEEE quotient, its sign included) without dividing: a zero dividend,
// which every flat region of a frame gives, sends the division down its
// slow path.
__device__ __forceinline__ float div_pos(float a, float b) {
  if (a == 0.f && b > 0.f) return a;
  return __fdiv_rn(a, b);
}

template <bool FIXED, int HALO, int MAXR, int WMAX>
__global__ void __launch_bounds__(NTHREADS, 2)
detect_kernel(const float* __restrict__ img, const float* __restrict__ thresh,
              uint8_t* __restrict__ mask, float* __restrict__ otx,
              float* __restrict__ oty, float* __restrict__ oxs,
              float* __restrict__ oys, float* __restrict__ on2,
              const DetectParams p) {
  const Smem s = carve(dynamic_smem());
  const Plan pl = FIXED ? k1_default_plan() : p.plan;
  constexpr int SEG = (OH + 2 * HALO + NS - 1) / NS;
  const int H = p.H, W = p.W;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * OH;
  const int ox0 = blockIdx.x * OW;
  const size_t plane = (size_t)H * W;

  load_tile(s, pl, img + b * plane, p.vec_in, oy0, ox0, H, W);
  chain_phases<SEG, MAXR, FIXED ? MAX_BOXES : 1>(s, pl, oy0, ox0, H, W);

  // phase P: img0 (outb) over [-E0, OH + E0), E0 = max(w, 1); the DoG
  // (outa) and its sign (+-1 inside the image, 0 outside, into a
  // vertical-sum buffer no chain reads now) over [-E1, OH + E1), E1 = w
  float* const sgn = tbuf(s, 0, plan_phases(pl) & 1);
  {
    const int kap = (int)threadIdx.x - HP;
    const int E0 = pl.E[0], E1 = pl.E[1];
    if (kap >= -E0 && kap < OW + E0) {
      int rho0;
      const int sl = segment(E0, &rho0);
      const float ic0 = col_recip(s, 0, pl.n[0], kap);
      const float ic1 = col_recip(s, 1, pl.n[1], kap);
      const bool col1 = kap >= -E1 && kap < OW + E1;
#pragma unroll
      for (int t = 0; t < SEG; ++t) {
        if (t < sl) {
          const int rho = rho0 + t;
          const float a0 = chain_value<MAXR>(s, pl, 0, pl.n[0], rho, kap, ic0,
                                             oy0, ox0, H, W);
          const int i = (rho + HP) * NX + threadIdx.x;
          s.outb[i] = a0;
          // the launcher checks E1 <= E0; equal under the default plan
          if (E1 >= E0 || (col1 && rho >= -E1 && rho < OH + E1)) {
            const float a1 = chain_value<MAXR>(s, pl, 1, pl.n[1], rho, kap,
                                               ic1, oy0, ox0, H, W);
            const float dog = __fsub_rn(a1, a0);
            s.outa[i] = dog;
            sgn[i] = inside(oy0 + rho, ox0 + kap, H, W)
                         ? (dog > 0.f ? 1.f : -1.f) : 0.f;
          }
        }
      }
    }
  }
  __syncthreads();

  // output phase: 4 pixels of one row a thread
  const int tid = threadIdx.y * NX + threadIdx.x;
  if (tid >= GROUPS * OH) return;
  const int rho = tid / GROUPS;
  const int kap0 = 4 * (tid - rho * GROUPS);
  const int gy = oy0 + rho;
  const int gx0 = ox0 + kap0;
  if (gy >= H || gx0 >= W) return;
  const int w = pl.w;
  constexpr int WQ = (WMAX + 3) / 4;
  constexpr int C0 = 4 * WQ;            // loaded column m is kap0 - C0 + m
  constexpr int NC = 4 + 2 * C0;
  float vd[NC], vs[NC], vw[NC], sx[4];
  const int i0 = (rho + HP) * NX + kap0 + HP - C0;
  const float* dog0 = s.outa + i0;
  const float* sgn0 = sgn + i0;
#pragma unroll(FIXED ? 2 * WMAX + 1 : 1)
  for (int step = 0; step <= 2 * WMAX; ++step) {
    const int k = (step + 1) / 2;       // rows 0, +1, -1, +2, -2, ...
    const int dl = (step & 1) ? k : -k;
    if (k > w) break;
    float row[NC], sg[NC];
    load4<NC / 4>(row, dog0 + dl * NX);
    load4<NC / 4>(sg, sgn0 + dl * NX);
    const float kf = (float)k;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      if (m < C0 - w || m >= C0 + 4 + w) continue;
      if (step == 0) {
        vd[m] = row[m];
        vs[m] = sg[m];
        vw[m] = 0.f;
      } else {
        vd[m] = __fadd_rn(vd[m], row[m]);
        vs[m] = __fadd_rn(vs[m], sg[m]);
        vw[m] = dl > 0 ? __fadd_rn(vw[m], __fmul_rn(kf, row[m]))
                       : __fsub_rn(vw[m], __fmul_rn(kf, row[m]));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float hw = 0.f;
#pragma unroll
      for (int j = 1; j <= WMAX; ++j) {
        if (j <= w) {
          const float jf = (float)j;
          hw = __fadd_rn(hw, __fmul_rn(jf, row[C0 + u + j]));
          hw = __fsub_rn(hw, __fmul_rn(jf, row[C0 + u - j]));
        }
      }
      sx[u] = step == 0 ? hw : __fadd_rn(sx[u], hw);
    }
  }

  const float g = __fmul_rn(thresh[b], p.max_img_value);
  const float g2 = __fmul_rn(g, g);
  const float gd = __fmul_rn(g, p.dog_thresh);
  const float gd2 = __fmul_rn(gd, gd);
  const float* a0row = s.outb + (rho + HP) * NX + kap0 + HP;
  float a0c[12], a0d[4], a0u[4];
  load4<3>(a0c, a0row - 4);
  load4<1>(a0d, a0row + NX);
  load4<1>(a0u, a0row - NX);
  float ftx[4], fty[4], fxs[4], fys[4], fn2[4];
  uint8_t fm[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int gx = gx0 + u;
    const int c = C0 + u;
    float pn = vs[c], sy = vw[c], sc = vd[c];
#pragma unroll
    for (int j = 1; j <= WMAX; ++j) {
      if (j <= w) {
        pn = __fadd_rn(pn, vs[c + j]);
        pn = __fadd_rn(pn, vs[c - j]);
        sy = __fadd_rn(sy, vw[c + j]);
        sy = __fadd_rn(sy, vw[c - j]);
        sc = __fadd_rn(sc, vd[c + j]);
        sc = __fadd_rn(sc, vd[c - j]);
      }
    }
    float dx = 0.f, dy = 0.f;
    if (gy > 0 && gy < H - 1 && gx > 0 && gx < W - 1) {
      dx = __fsub_rn(a0c[4 + u + 1], a0c[4 + u - 1]);
      dy = __fsub_rn(a0d[u], a0u[u]);
    }
    const bool t1 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) >= g2;
    const bool t2 = fabsf(pn) <= p.pn_limit;
    const float tx = div_pos(sx[u], p.sum_j2);
    const float ty = div_pos(sy, p.sum_j2);
    const float tc = div_pos(sc, p.win_area);
    const float n2 = __fadd_rn(__fmul_rn(tx, tx), __fmul_rn(ty, ty));
    const float denom = n2 > 0.f ? n2 : 1.f;
    const float xs = div_pos(__fmul_rn(-tx, tc), denom);
    const float ys = div_pos(__fmul_rn(-ty, tc), denom);
    const bool t3 = fabsf(xs) <= 0.5f && fabsf(ys) <= 0.5f;
    const bool t4 = n2 >= gd2;
    const bool interior = gy >= w && gy < H - w && gx >= w && gx < W - w;
    fm[u] = (t1 && t2 && t3 && t4 && interior) ? 1 : 0;
    ftx[u] = tx;
    fty[u] = ty;
    fxs[u] = xs;
    fys[u] = ys;
    fn2[u] = n2;
  }
  const size_t o = b * plane + (size_t)gy * W + gx0;
  const int n = min(4, W - gx0);
  const bool vec = p.vec_out && n == 4;
  store4(otx, o, ftx, vec, n);
  store4(oty, o, fty, vec, n);
  store4(oxs, o, fxs, vec, n);
  store4(oys, o, fys, vec, n);
  store4(on2, o, fn2, vec, n);
  if (vec) {
    *reinterpret_cast<uchar4*>(mask + o) = make_uchar4(fm[0], fm[1], fm[2],
                                                       fm[3]);
  } else {
    for (int u = 0; u < n; ++u) mask[o + u] = fm[u];
  }
}

// the two instantiations: the default plan, and any plan read at run time
#define K1_FIXED detect_kernel<true, 7, 2, 2>
#define K1_RUNTIME detect_kernel<false, MAX_HALO, MAX_HALO, MAX_HALO>

}  // namespace

#ifndef TP_HOST_EMU
// Allows both instantiations their dynamic shared memory (over 48 KB);
// called once when the library is loaded, before any launch or capture.
extern "C" int detect_candidates_init() {
  cudaError_t e = cudaFuncSetAttribute(
      K1_FIXED, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        K1_RUNTIME, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  return (int)e;
}

// Resident blocks per SM of one instantiation (fixed != 0: the default
// plan's) at the launcher's block and shared memory, from the occupancy
// calculator.
extern "C" int detect_candidates_occupancy(int fixed, int* blocks) {
  const dim3 b = launch_block();
  const int threads = b.x * b.y * b.z;
  return (int)(fixed ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, K1_FIXED, threads, SMEM_BYTES)
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, K1_RUNTIME, threads, SMEM_BYTES));
}
#endif

// The dynamic shared bytes and threads per block the launcher passes.
extern "C" void detect_candidates_launch_config(int* smem_bytes,
                                                int* threads) {
  const dim3 b = launch_block();
  *smem_bytes = SMEM_BYTES;
  *threads = b.x * b.y * b.z;
}

// Launches K1 on a [B, H, W] frame batch with the plan and the gx x gy
// tile grid of kernels/cuda_scale_space.launch_plan: halo, half window
// win_s, margins e0 (img0) and e1 (the DoG), chain c's n_c radii r_c, and
// fixed != 0 for the default plan's instantiation. The plan and the grid
// are checked, not recomputed: cudaErrorInvalidValue if the kernel cannot
// run them.
extern "C" int detect_candidates_launch(
    const float* img, const float* thresh, uint8_t* mask, float* tx,
    float* ty, float* xs, float* ys, float* n2, int B, int H, int W, int gx,
    int gy, int halo, int win_s, int e0, int e1, const int* r0, int n0,
    const int* r1, int n1, int fixed, float pn_limit, float max_img_value,
    float dog_thresh, float sum_j2, float win_area, void* stream) {
  DetectParams p;
  if (!plan_from_args(&p.plan, halo, win_s, e0, e1, r0, n0, r1, n1) ||
      e0 < (win_s > 1 ? win_s : 1) || e1 < win_s || e1 > e0 ||
      !grid_covers(gx, gy, H, W) ||
      (fixed && !same_plan(p.plan, k1_default_plan())))
    return (int)cudaErrorInvalidValue;
  p.H = H;
  p.W = W;
  p.vec_out = W % 4 == 0;
  p.vec_in = p.vec_out && (uintptr_t)img % 16 == 0;
  p.pn_limit = pn_limit;
  p.max_img_value = max_img_value;
  p.dog_thresh = dog_thresh;
  p.sum_j2 = sum_j2;
  p.win_area = win_area;
  const dim3 grid(gx, gy, B);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)launch_kernel(fixed ? K1_FIXED : K1_RUNTIME, grid,
                            launch_block(), SMEM_BYTES, st, img, thresh,
                            mask, tx, ty, xs, ys, n2, p);
}
