// Tile pipeline shared by the scale-space kernels (detect_candidates.cu,
// K1, and build_scale_space.cu, K2), written for Hopper (sm_90a).
//
// A block of NS x NX = 6 x 64 threads owns an OH x OW = 30 x 48 output
// tile. Every buffer in shared memory is BR x NX = 46 x 64 floats: cell
// (rho + HP, kap + HP) holds image pixel (oy0 + rho, ox0 + kap), so rows
// and columns reach HP = 8 = MAX_HALO past the tile, and a cell outside the
// image holds 0, which is the clipping of the reference's zero padding.
//
// The two box chains (sizes0 -> img0 = chain 0, sizes1 -> img1 = chain 1;
// boxes of width 1 are skipped) run as one sequence of phases, one
// __syncthreads() after each:
//   load     the tile and its halo, 16-byte cp.async where W % 4 == 0,
//            and, while the copies fly, the reciprocal tables;
//   phase q  (q < P, P = the longer chain's pass count) for each chain: the
//            horizontal sum of the pass whose vertical sums the last phase
//            wrote, times the row then the column reciprocal, fed straight
//            in registers into the next pass's vertical sum, which is
//            written to shared memory. A thread owns one column and a
//            segment of rows, so a vertical sum never crosses a barrier;
//   phase P  the last horizontal sums: each kernel writes what its output
//            phase reads (K1: the DoG, its sign and img0; K2: img0, img1);
//   output   one thread per 4 output columns of one row, float4 loads from
//            shared memory, float4 / uchar4 stores.
// Each pass covers only the band the later passes read: a chain's margin
// shrinks by the pass's radius, down to the margin E its output needs. A
// shorter chain starts later, so both end in phase P.
//
// Exactness: every sum keeps the Pallas kernel's order (vertical, then
// horizontal; +x[i+k] before +x[i-k], k = 1..r), the row reciprocal is
// multiplied before the column one, and each reciprocal is one
// __fdiv_rn(1, n), in row and column tables built once per block. No
// running sums. The test for a cell outside the image is a select, not a
// branch. With --fmad=false
// the card gives the plain PyTorch versions' floats
// (kernels/cuda_scale_space.py).
//
// The plan (radii, margins) is either a compile-time constant (the default
// plans, so every loop unrolls and every branch folds) or read at run time
// (any plan with halo <= 8 and at most 4 boxes per chain); both are
// instances of the same templates. The launchers take the plan and the grid
// that kernels/cuda_scale_space.launch_plan computed and only check them.
//
// The CUDA-only pieces (the shared-memory base, cp.async, the launch) sit
// under #ifndef TP_HOST_EMU. tests/cuda_host_emu.h defines that macro and
// host versions of them, so that tests/test_torch_tile_host.py runs these
// kernels on the CPU, one std::thread per CUDA thread.

#pragma once

#include <stddef.h>
#include <stdint.h>
#ifndef TP_HOST_EMU
#include <cuda_runtime.h>
#endif

namespace tp {

constexpr int OH = 30;            // output rows per block
constexpr int OW = 48;            // output columns per block
constexpr int HP = 8;             // pad of every buffer: the largest halo
constexpr int MAX_HALO = HP;
constexpr int MAX_BOXES = 4;
constexpr int NX = OW + 2 * HP;   // 64: columns per buffer row = threads.x
constexpr int NS = 6;             // row segments = threads.y
constexpr int NTHREADS = NX * NS; // 384
constexpr int BR = OH + 2 * HP;   // 46 buffer rows
constexpr int BUF = BR * NX;      // floats per buffer
constexpr int GROUPS = OW / 4;    // float4 column groups of the output phase
constexpr int N_INV_ROWS = 2 * MAX_BOXES * BR;   // [chain][pass][row]
constexpr int N_INV = N_INV_ROWS + 2 * MAX_BOXES * NX;   // + [..][column]
// shared memory: the image, two ping-pong buffers per chain, two outputs
// of phase P, the row and column reciprocal tables
constexpr int SMEM_FLOATS = 7 * BUF + N_INV;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
static_assert(GROUPS * OH <= NTHREADS, "output phase needs a thread a group");
static_assert(OW % 4 == 0 && HP % 4 == 0, "float4 column groups");

// A launch plan: chain c's n[c] passes of radius r[c][0..n[c]), whose
// results are needed E[c] pixels past the tile; w is K1's plane-fit half
// window (0 for K2).
struct Plan {
  int halo;
  int n[2];
  int r[2][MAX_BOXES];
  int E[2];
  int w;
};

__host__ __device__ constexpr int plan_phases(const Plan& pl) {
  return pl.n[0] > pl.n[1] ? pl.n[0] : pl.n[1];
}

// margin past the tile of chain c's result after pass j (j = 0: the input)
__host__ __device__ constexpr int plan_margin(const Plan& pl, int c, int j) {
  int e = pl.E[c];
  for (int i = j; i < MAX_BOXES; ++i)
    if (i < pl.n[c]) e += pl.r[c][i];
  return e;
}

// Fills a plan from the launch plan's numbers (chain c's radii r_c[0..n_c),
// margins E0, E1, half window w, halo); returns false if the kernels cannot
// run it: more than MAX_BOXES passes, a radius or margin out of range, or a
// chain reaching past the halo.
inline bool plan_from_args(Plan* pl, int halo, int w, int E0, int E1,
                           const int* r0, int n0, const int* r1, int n1) {
  if (n0 < 0 || n0 > MAX_BOXES || n1 < 0 || n1 > MAX_BOXES || halo < 0 ||
      halo > MAX_HALO || w < 0 || w > MAX_HALO || E0 < 0 || E1 < 0)
    return false;
  const int* rr[2] = {r0, r1};
  const int nn[2] = {n0, n1};
  for (int c = 0; c < 2; ++c) {
    pl->n[c] = nn[c];
    for (int k = 0; k < MAX_BOXES; ++k) {
      pl->r[c][k] = k < nn[c] ? rr[c][k] : 0;
      if (k < nn[c] && (pl->r[c][k] < 1 || pl->r[c][k] > MAX_HALO))
        return false;
    }
  }
  pl->E[0] = E0;
  pl->E[1] = E1;
  pl->w = w;
  pl->halo = halo;
  return plan_margin(*pl, 0, 0) <= halo && plan_margin(*pl, 1, 0) <= halo;
}

// True if a grid of gx x gy tiles covers an H x W frame, each tile once.
inline bool grid_covers(int gx, int gy, int H, int W) {
  return gx >= 1 && gy >= 1 && (gx - 1) * OW < W && W <= gx * OW &&
         (gy - 1) * OH < H && H <= gy * OH;
}

inline bool same_plan(const Plan& a, const Plan& b) {
  if (a.halo != b.halo || a.w != b.w) return false;
  for (int c = 0; c < 2; ++c) {
    if (a.n[c] != b.n[c] || a.E[c] != b.E[c]) return false;
    for (int k = 0; k < MAX_BOXES; ++k)
      if (a.r[c][k] != b.r[c][k]) return false;
  }
  return true;
}

// Shared-memory views of one block.
struct Smem {
  float* img;       // then [chain][phase parity] vertical sums: tbuf()
  float* outa;      // phase P's outputs (K1: DoG, K2: img0)
  float* outb;      // (K1: img0, K2: img1)
  float* inv;       // [chain][pass][BR] row reciprocals
  float* invc;      // [chain][pass][NX] column reciprocals
};

__device__ __forceinline__ Smem carve(float* base) {
  Smem s;
  s.img = base;
  s.outa = base + 5 * BUF;
  s.outb = base + 6 * BUF;
  s.inv = base + 7 * BUF;
  s.invc = s.inv + N_INV_ROWS;
  return s;
}

// chain c's vertical sums written in a phase of parity p
__device__ __forceinline__ float* tbuf(const Smem& s, int c, int p) {
  return s.img + (1 + 2 * c + p) * BUF;
}

__device__ __forceinline__ bool inside(int gy, int gx, int H, int W) {
  return (unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W;
}

__device__ __forceinline__ int clipped_count(int g, int r, int n) {
  const int c = min(g + r + 1, n) - max(g - r, 0);
  return c > 0 ? c : 1;   // only cells outside the image give c <= 0
}

// Entry i of the reciprocal tables of the block whose tile starts at
// (oy0, ox0): [chain][pass][buffer row], then [chain][pass][buffer column]
// (see Smem). False if pass j of chain c does not exist: no entry.
__device__ __forceinline__ bool recip_entry(const Plan& pl, int i, int oy0,
                                            int ox0, int H, int W, float* v) {
  const bool row = i < N_INV_ROWS;
  const int n = row ? BR : NX;
  const int k = row ? i : i - N_INV_ROWS;
  const int cj = k / n;
  const int c = cj / MAX_BOXES;
  const int j = cj % MAX_BOXES;
  if (j >= pl.n[c]) return false;
  const int g = (row ? oy0 : ox0) - HP + k % n;
  *v = __fdiv_rn(1.f, (float)clipped_count(g, pl.r[c][j], row ? H : W));
  return true;
}

#ifndef TP_HOST_EMU
// The block's dynamic shared memory.
__device__ __forceinline__ float* dynamic_smem() {
  extern __shared__ float4 smem4[];
  return reinterpret_cast<float*>(smem4);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Launches kernel k on `grid` with `block` threads and `smem_bytes` of
// dynamic shared memory (the launchers pass launch_block(), SMEM_BYTES).
template <typename... P, typename... A>
inline cudaError_t launch_kernel(void (*k)(P...), dim3 grid, dim3 block,
                                 size_t smem_bytes, cudaStream_t st,
                                 A... args) {
  k<<<grid, block, smem_bytes, st>>>(args...);
  return cudaGetLastError();
}
#endif

// The block every tile kernel is launched with.
inline dim3 launch_block() { return dim3(NX, NS); }

// Loads rows [-halo, OH + halo) of the tile (all NX columns) into s.img
// and, while the copies are in flight, builds the row and column
// reciprocal tables; ends with a barrier.
__device__ __forceinline__ void load_tile(const Smem& s, const Plan& pl,
                                          const float* __restrict__ src,
                                          bool vec_in, int oy0, int ox0,
                                          int H, int W) {
  const int tid = threadIdx.y * NX + threadIdx.x;
  const int r_lo = HP - pl.halo;
  const int nrows = OH + 2 * pl.halo;
  if (vec_in) {
    // W % 4 == 0 and ox0 - HP % 4 == 0: a 16-byte chunk is all in or out
    for (int i = tid; i < nrows * (NX / 4); i += NTHREADS) {
      const int rr = r_lo + i / (NX / 4);
      const int m = (i % (NX / 4)) * 4;
      const int gy = oy0 - HP + rr;
      const int gx = ox0 - HP + m;
      float* dst = s.img + rr * NX + m;
      if (inside(gy, gx, H, W))
        cp_async16(dst, src + (size_t)gy * W + gx);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = tid; i < nrows * NX; i += NTHREADS) {
      const int rr = r_lo + i / NX;
      const int m = i % NX;
      const int gy = oy0 - HP + rr;
      const int gx = ox0 - HP + m;
      s.img[rr * NX + m] =
          inside(gy, gx, H, W) ? src[(size_t)gy * W + gx] : 0.f;
    }
  }
  // 1 / (clipped window rows), then 1 / (clipped window columns), of
  // every pass of both chains
  for (int i = tid; i < N_INV; i += NTHREADS) {
    float v;
    if (recip_entry(pl, i, oy0, ox0, H, W, &v)) s.inv[i] = v;
  }
  if (vec_in) cp_async_wait_all();
  __syncthreads();
}

// Chain c's value after pass j (j = 0: the image) at row rho of the calling
// thread's column kap, for 0 < j: the horizontal sum of the vertical sums
// that phase start + j - 1 wrote, scaled by the row then the column
// reciprocal (inv_col, the caller's), 0 outside the image (a select, not a
// branch: the cells outside are computed from whatever the buffer holds).
template <int MAXR>
__device__ __forceinline__ float chain_value(const Smem& s, const Plan& pl,
                                             int c, int j, int rho, int kap,
                                             float inv_col, int oy0, int ox0,
                                             int H, int W) {
  if (j == 0) return s.img[(rho + HP) * NX + kap + HP];
  const int qv = plan_phases(pl) - pl.n[c] + j - 1;
  const int r = pl.r[c][j - 1];
  const float* row = tbuf(s, c, qv & 1) + (rho + HP) * NX + kap + HP;
  float v = row[0];
#pragma unroll
  for (int k = 1; k <= MAXR; ++k) {
    if (k <= r) {
      v = __fadd_rn(v, row[k]);
      v = __fadd_rn(v, row[-k]);
    }
  }
  v = __fmul_rn(v, s.inv[(c * MAX_BOXES + j - 1) * BR + rho + HP]);
  v = __fmul_rn(v, inv_col);
  return inside(oy0 + rho, ox0 + kap, H, W) ? v : 0.f;
}

// The column reciprocal of chain c's pass j (>= 1) at column kap.
__device__ __forceinline__ float col_recip(const Smem& s, int c, int j,
                                           int kap) {
  return j == 0 ? 1.f : s.invc[(c * MAX_BOXES + j - 1) * NX + kap + HP];
}

// The sl = ceil(L / NS) rows from *rho0 of band [-e, OH + e) (L rows)
// that segment threadIdx.y owns; returns sl. The last segment ends at the
// band's end and may overlap the one before it, whose rows it then
// computes again to the same bits: every segment has sl rows, a constant
// under a compile-time plan.
__device__ __forceinline__ int segment(int e, int* rho0) {
  const int L = OH + 2 * e;
  const int sl = (L + NS - 1) / NS;
  *rho0 = -e + min((int)threadIdx.y * sl, L - sl);
  return sl;
}

// Phase q of chain c: if a pass's vertical sum runs in this phase, compute
// its input (the previous pass's horizontal sum, or the image) down this
// thread's column in registers and write the vertical sums. SEG bounds a
// segment's length, MAXR a box radius.
template <int SEG, int MAXR>
__device__ __forceinline__ void chain_phase(const Smem& s, const Plan& pl,
                                            int c, int q, int oy0, int ox0,
                                            int H, int W) {
  const int jv = q - (plan_phases(pl) - pl.n[c]) + 1;
  if (jv < 1 || jv > pl.n[c]) return;
  const int kap = (int)threadIdx.x - HP;
  const int ecol = plan_margin(pl, c, jv - 1);
  if (kap < -ecol || kap >= OW + ecol) return;
  int rho0;
  const int sl = segment(plan_margin(pl, c, jv), &rho0);
  const int r = pl.r[c][jv - 1];
  const float inv_col = col_recip(s, c, jv - 1, kap);
  float src[SEG + 2 * MAXR];
#pragma unroll
  for (int i = 0; i < SEG + 2 * MAXR; ++i) {
    const int d = i - MAXR;
    if (d >= -r && d < sl + r)
      src[i] = chain_value<MAXR>(s, pl, c, jv - 1, rho0 + d, kap, inv_col,
                                 oy0, ox0, H, W);
  }
  float* out = tbuf(s, c, q & 1) + (rho0 + HP) * NX + threadIdx.x;
#pragma unroll
  for (int t = 0; t < SEG; ++t) {
    if (t < sl) {
      float v = src[MAXR + t];
#pragma unroll
      for (int k = 1; k <= MAXR; ++k) {
        if (k <= r) {
          v = __fadd_rn(v, src[MAXR + t + k]);
          v = __fadd_rn(v, src[MAXR + t - k]);
        }
      }
      out[t * NX] = v;
    }
  }
}

// Phases 0 .. P-1 of both chains, a barrier after each. QU unrolls the
// phase loop: fully under a compile-time plan (each phase then folds to its
// own constants), once under a run-time plan (one copy of the code).
template <int SEG, int MAXR, int QU>
__device__ __forceinline__ void chain_phases(const Smem& s, const Plan& pl,
                                             int oy0, int ox0, int H,
                                             int W) {
#pragma unroll(QU)
  for (int q = 0; q < MAX_BOXES; ++q) {
    if (q >= plan_phases(pl)) break;
    chain_phase<SEG, MAXR>(s, pl, 1, q, oy0, ox0, H, W);
    chain_phase<SEG, MAXR>(s, pl, 0, q, oy0, ox0, H, W);
    __syncthreads();
  }
}

// Phase P of chain c: its final value over band [-E, OH + E) of this
// thread's column, written to `dst` (no barrier).
template <int SEG, int MAXR>
__device__ __forceinline__ void chain_final(const Smem& s, const Plan& pl,
                                            int c, float* dst, int oy0,
                                            int ox0, int H, int W) {
  const int kap = (int)threadIdx.x - HP;
  const int E = pl.E[c];
  if (kap < -E || kap >= OW + E) return;
  int rho0;
  const int sl = segment(E, &rho0);
  const int j = pl.n[c];
  const float inv_col = col_recip(s, c, j, kap);
#pragma unroll
  for (int t = 0; t < SEG; ++t)
    if (t < sl)
      dst[(rho0 + t + HP) * NX + threadIdx.x] = chain_value<MAXR>(
          s, pl, c, j, rho0 + t, kap, inv_col, oy0, ox0, H, W);
}

// Loads floats [base, base + 4*N) of shared memory as N float4s.
template <int N>
__device__ __forceinline__ void load4(float* dst, const float* base) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 v = reinterpret_cast<const float4*>(base)[i];
    dst[4 * i] = v.x;
    dst[4 * i + 1] = v.y;
    dst[4 * i + 2] = v.z;
    dst[4 * i + 3] = v.w;
  }
}

// Stores 4 floats at out[o..o+4): one float4 if `vec` (o % 4 == 0 and all
// four inside), else the first `n` one by one.
__device__ __forceinline__ void store4(float* __restrict__ out, size_t o,
                                       const float* v, bool vec, int n) {
  if (vec) {
    *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int u = 0; u < n; ++u) out[o + u] = v[u];
  }
}

}  // namespace tp
