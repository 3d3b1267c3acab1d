// Shared-memory tile pass of the scale-space kernels (detect_candidates.cu,
// K1, and build_scale_space.cu, K2).
//
// A block holds one output tile plus a halo in shared memory, T x T floats
// row-major, whose cell (r, c) is the image pixel (gy0 + r, gx0 + c). Cells
// outside the image hold 0 before and after every pass, which is the
// clipping of the reference's zero padding.

#pragma once

#include <cuda_runtime.h>

namespace sstile {

__device__ __forceinline__ bool inside(int gy, int gx, int H, int W) {
  return gy >= 0 && gy < H && gx >= 0 && gx < W;
}

// One clipped, normalised box pass of odd width d over the tile in `a`,
// using `tmp` for the vertical sums, in the Pallas kernel's order: the
// vertical shift-and-add (+x[i+k] then +x[i-k]), then the horizontal one,
// then a multiply by the row reciprocal and by the column reciprocal of
// the clipped window size, rebuilt from global coordinates. The valid part
// of the tile shrinks by d/2 on every side; the band outside it is left
// stale and must not be read by the caller.
__device__ void box_pass(float* a, float* tmp, int d, int T, int gy0, int gx0,
                         int H, int W) {
  const int d2 = d / 2;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const int NT = T * T;
  for (int i = tid; i < NT; i += nthr) {
    const int r = i / T;
    if (r < d2 || r >= T - d2) continue;
    float s = a[i];
    for (int k = 1; k <= d2; ++k) {
      s = __fadd_rn(s, a[i + k * T]);
      s = __fadd_rn(s, a[i - k * T]);
    }
    tmp[i] = s;
  }
  __syncthreads();
  for (int i = tid; i < NT; i += nthr) {
    const int r = i / T;
    const int c = i - r * T;
    if (c < d2 || c >= T - d2) continue;
    const int gy = gy0 + r;
    const int gx = gx0 + c;
    float s = 0.f;
    if (inside(gy, gx, H, W)) {
      s = tmp[i];
      for (int k = 1; k <= d2; ++k) {
        s = __fadd_rn(s, tmp[i + k]);
        s = __fadd_rn(s, tmp[i - k]);
      }
      const int hr = min(gy + d2 + 1, H) - max(gy - d2, 0);
      const int hc = min(gx + d2 + 1, W) - max(gx - d2, 0);
      s = __fmul_rn(s, __fdiv_rn(1.f, (float)hr));
      s = __fmul_rn(s, __fdiv_rn(1.f, (float)hc));
    }
    a[i] = s;
  }
  __syncthreads();
}

}  // namespace sstile
