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
// six maps once (1 + 5*4 = 21 B): 25 B/px, 9.0 MB for one 480x752 frame, and
// about 116 float operations per pixel (counted in chip_smoke.py), far
// below the card's compute rate, so bytes bound it (a 480x752 frame is ~2.7 us at 3.35 TB/s on an H100
// SXM). Design: one 256-thread block per 32x32 output tile (plus a grid
// dimension for the batch). The tile and its halo (box-chain radius + w,
// 7 px at the defaults, passed in by the wrapper from scale_space_plan) are
// loaded into shared memory once; every pass then runs in shared memory and
// each output map is written exactly once, so device memory sees the
// bound's bytes plus the halo re-reads (46^2/32^2 = 2.1x on the input,
// mostly served by L2). This first version favours a simple, exact schedule
// (a __syncthreads() between passes, one pass at a time) over speed.

#include <cuda_runtime.h>
#include <stdint.h>

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

struct DetectParams {
  int H, W;
  int halo;
  int n0, n1;
  int sizes0[MAX_BOXES];
  int sizes1[MAX_BOXES];
  int win_s;
  float pn_limit;       // win_area * per_hist
  float max_img_value;
  float dog_thresh;
  float sum_j2;         // (2w+1) * sum_j j^2
  float win_area;       // (2w+1)^2
};

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
detect_kernel(const float* __restrict__ img, const float* __restrict__ thresh,
              uint8_t* __restrict__ mask, float* __restrict__ otx,
              float* __restrict__ oty, float* __restrict__ oxs,
              float* __restrict__ oys, float* __restrict__ on2,
              DetectParams p) {
  __shared__ float sh[4][SMAX * SMAX];
  float* A1 = sh[0];   // sizes1 chain, then the DoG
  float* A0 = sh[1];   // sizes0 chain, then sign, then wsum_x(dog)
  float* TMP = sh[2];  // vertical sums
  float* AUX = sh[3];  // wsum_y(dog)

  const int T = TILE + 2 * p.halo;
  const int NT = T * T;
  const int b = blockIdx.z;
  const int gy0 = blockIdx.y * TILE - p.halo;
  const int gx0 = blockIdx.x * TILE - p.halo;
  const size_t plane = (size_t)p.H * p.W;
  const float* src = img + b * plane;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const int w = p.win_s;

  for (int i = tid; i < NT; i += nthr) {
    const int r = i / T;
    const int c = i - r * T;
    const int gy = gy0 + r;
    const int gx = gx0 + c;
    const float v = inside(gy, gx, p.H, p.W) ? src[(size_t)gy * p.W + gx] : 0.f;
    A1[i] = v;
    A0[i] = v;
    TMP[i] = 0.f;
    AUX[i] = 0.f;
  }
  __syncthreads();

  for (int k = 0; k < p.n1; ++k)
    if (p.sizes1[k] > 1) box_pass(A1, TMP, p.sizes1[k], T, gy0, gx0, p.H, p.W);
  for (int k = 0; k < p.n0; ++k)
    if (p.sizes0[k] > 1) box_pass(A0, TMP, p.sizes0[k], T, gy0, gx0, p.H, p.W);

  const float g = __fmul_rn(thresh[b], p.max_img_value);
  const float g2 = __fmul_rn(g, g);
  const float gd = __fmul_rn(g, p.dog_thresh);
  const float gd2 = __fmul_rn(gd, gd);

  const int ox = threadIdx.x;
  bool t1[ROWS_PER_THREAD];
  bool t2[ROWS_PER_THREAD];

  // t1: squared gradient norm of img0 (zero on the 1-px image border)
  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    const int oy = threadIdx.y + BLOCK_Y * j;
    const int i = (p.halo + oy) * T + p.halo + ox;
    const int gy = blockIdx.y * TILE + oy;
    const int gx = blockIdx.x * TILE + ox;
    float dx = 0.f, dy = 0.f;
    if (gy > 0 && gy < p.H - 1 && gx > 0 && gx < p.W - 1) {
      dx = __fsub_rn(A0[i + 1], A0[i - 1]);
      dy = __fsub_rn(A0[i + T], A0[i - T]);
    }
    t1[j] = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) >= g2;
  }
  __syncthreads();

  // DoG into A1; outside the image both chains are 0, so the DoG is too
  for (int i = tid; i < NT; i += nthr) A1[i] = __fsub_rn(A1[i], A0[i]);
  __syncthreads();
  // sign map: +-1 inside the image, 0 outside (the window sums pad with 0)
  for (int i = tid; i < NT; i += nthr) {
    const int r = i / T;
    const int c = i - r * T;
    A0[i] = inside(gy0 + r, gx0 + c, p.H, p.W) ? (A1[i] > 0.f ? 1.f : -1.f) : 0.f;
  }
  __syncthreads();
  // t2: window sum of the sign, vertical then horizontal
  for (int i = tid; i < NT; i += nthr) {
    const int r = i / T;
    if (r < w || r >= T - w) continue;
    float s = A0[i];
    for (int k = 1; k <= w; ++k) {
      s = __fadd_rn(s, A0[i + k * T]);
      s = __fadd_rn(s, A0[i - k * T]);
    }
    TMP[i] = s;
  }
  __syncthreads();
  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    const int oy = threadIdx.y + BLOCK_Y * j;
    const int i = (p.halo + oy) * T + p.halo + ox;
    float s = TMP[i];
    for (int k = 1; k <= w; ++k) {
      s = __fadd_rn(s, TMP[i + k]);
      s = __fadd_rn(s, TMP[i - k]);
    }
    t2[j] = fabsf(s) <= p.pn_limit;
  }
  __syncthreads();

  // plane-fit window sums of the DoG:
  //   TMP = vertical sum, AUX = vertical j-weighted sum,
  //   A0  = horizontal j-weighted sum
  for (int i = tid; i < NT; i += nthr) {
    const int r = i / T;
    const int c = i - r * T;
    if (r >= w && r < T - w) {
      float s = A1[i];
      float sw = 0.f;
      for (int k = 1; k <= w; ++k) {
        const float kf = (float)k;
        s = __fadd_rn(s, A1[i + k * T]);
        s = __fadd_rn(s, A1[i - k * T]);
        sw = __fadd_rn(sw, __fmul_rn(kf, A1[i + k * T]));
        sw = __fsub_rn(sw, __fmul_rn(kf, A1[i - k * T]));
      }
      TMP[i] = s;
      AUX[i] = sw;
    }
    if (c >= w && c < T - w) {
      float sw = 0.f;
      for (int k = 1; k <= w; ++k) {
        const float kf = (float)k;
        sw = __fadd_rn(sw, __fmul_rn(kf, A1[i + k]));
        sw = __fsub_rn(sw, __fmul_rn(kf, A1[i - k]));
      }
      A0[i] = sw;
    }
  }
  __syncthreads();

  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    const int oy = threadIdx.y + BLOCK_Y * j;
    const int gy = blockIdx.y * TILE + oy;
    const int gx = blockIdx.x * TILE + ox;
    if (gy >= p.H || gx >= p.W) continue;
    const int i = (p.halo + oy) * T + p.halo + ox;
    float sx = A0[i];
    float sy = AUX[i];
    float sc = TMP[i];
    for (int k = 1; k <= w; ++k) {
      sx = __fadd_rn(sx, A0[i + k * T]);
      sx = __fadd_rn(sx, A0[i - k * T]);
      sy = __fadd_rn(sy, AUX[i + k]);
      sy = __fadd_rn(sy, AUX[i - k]);
      sc = __fadd_rn(sc, TMP[i + k]);
      sc = __fadd_rn(sc, TMP[i - k]);
    }
    const float tx = __fdiv_rn(sx, p.sum_j2);
    const float ty = __fdiv_rn(sy, p.sum_j2);
    const float tc = __fdiv_rn(sc, p.win_area);
    const float n2 = __fadd_rn(__fmul_rn(tx, tx), __fmul_rn(ty, ty));
    const float denom = n2 > 0.f ? n2 : 1.f;
    const float xs = __fdiv_rn(__fmul_rn(-tx, tc), denom);
    const float ys = __fdiv_rn(__fmul_rn(-ty, tc), denom);
    const bool t3 = fabsf(xs) <= 0.5f && fabsf(ys) <= 0.5f;
    const bool t4 = n2 >= gd2;
    const bool interior = gy >= w && gy < p.H - w && gx >= w && gx < p.W - w;
    const size_t o = b * plane + (size_t)gy * p.W + gx;
    mask[o] = (t1[j] && t2[j] && t3 && t4 && interior) ? 1 : 0;
    otx[o] = tx;
    oty[o] = ty;
    oxs[o] = xs;
    oys[o] = ys;
    on2[o] = n2;
  }
}

}  // namespace

extern "C" int detect_candidates_launch(
    const float* img, const float* thresh, uint8_t* mask, float* tx,
    float* ty, float* xs, float* ys, float* n2, int B, int H, int W,
    const int* sizes0, int n0, const int* sizes1, int n1, int halo,
    int win_s, float pn_limit, float max_img_value, float dog_thresh,
    float sum_j2, float win_area, void* stream) {
  if (halo > MAX_HALO || n0 > MAX_BOXES || n1 > MAX_BOXES || win_s > halo)
    return (int)cudaErrorInvalidValue;
  DetectParams p;
  p.H = H;
  p.W = W;
  p.halo = halo;
  p.n0 = n0;
  p.n1 = n1;
  for (int k = 0; k < MAX_BOXES; ++k) {
    p.sizes0[k] = k < n0 ? sizes0[k] : 1;
    p.sizes1[k] = k < n1 ? sizes1[k] : 1;
  }
  p.win_s = win_s;
  p.pn_limit = pn_limit;
  p.max_img_value = max_img_value;
  p.dog_thresh = dog_thresh;
  p.sum_j2 = sum_j2;
  p.win_area = win_area;
  dim3 block(BLOCK_X, BLOCK_Y);
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  detect_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, thresh, mask, tx, ty, xs, ys, n2, p);
  return (int)cudaGetLastError();
}
