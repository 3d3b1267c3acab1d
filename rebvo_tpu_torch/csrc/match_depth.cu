// The match-and-depth stage for Hopper (sm_90a): vo.match_depth's K-wide
// body in two launches per frame and lane, md_match and md_depth.
//
// Replaces no TPU kernel: the JAX package leaves the stage
// (rebvo_tpu/kernels/matching.py: forward_match, directed_matching_field;
// rebvo_tpu/kernels/depth_filter.py: regularize_1_iter, depth_ekf,
// estimate_rescaling_opt) to XLA. Its PyTorch form (kernels/matching,
// kernels/depth_filter and the map rotation of frontend/step) launches
// ~760 small kernels a mono frame on the card, elementwise ops, gathers,
// a scatter-max and a top-k over the K keyline slots, and was the largest
// stage of the mono step. The two kernels run all of it:
//   * md_match: the forward transfer of forward_match when given the
//     pose solver's m_id_f (the scatter-max tournament: the larger rho
//     wins, ties to the larger source index); the forward rotation of the
//     old map (rotate_hom_points, rotate_gradients) by R0, so3_exp(W) of
//     the solver's W or the caller's R0; directed_matching_field: the
//     search line, the stride ladder on the old match field, the first 8
//     hits, the gradient, range and chi^2 tests, the first accepted hit
//     and _apply_matches; nmatch and est_ok;
//   * md_depth: regularize_1_iter (neighbours read from md_match's map,
//     written to another buffer), depth_ekf, then, without a stereo pair,
//     estimate_rescaling_opt's 5 rounds of two float64 sums, the apply_res
//     divide and the est_ok select; and Kp, Kp_gauge, P_Kp and V_out.
// The stereo step runs its own blocks between the two launches (they read
// the rotated old map and md_match's map, both written out), and md_depth
// then stops after the EKF, with Kp = 1 and the previous P_Kp carried
// (the stereo blocks and their est_ok select follow it).
//
// Bound. md_match reads the old map's 15 fields and m_id_f and the new
// map's 19 fields once (134 B a slot), writes 16 float and 3 int rows (76
// B), and gathers a winner's 12 fields, 26 field-image samples and at most
// 8 hits' 9 fields a valid slot; md_depth reads 19 fields (73 B) and
// writes 4 (16 B). At K = 16384 that is about 4.9 MB a lane, ~1.5 us at
// 3.35 TB/s. What bounds the kernels is latency: a slot's dependent
// gathers (the winner, the ladder's samples, the hits) and, in md_depth,
// 5 rounds of a cluster-wide float64 reduction. So the design:
//   * one cluster of CLUSTER CTAs per lane and launch, slot k owned by
//     CTA k / chunk, chunk = ceil(K / CLUSTER); a CTA's threads take its
//     slots in turn (coalesced);
//   * the tournament is two rounds of 32-bit atomicMax into the owner
//     CTA's shared memory, over distributed shared memory, behind cluster
//     barriers, as the plain version's two scatters: rho's order-keeping
//     bits (-0 taken as +0; a NaN poisons its target, which then has no
//     winner, as the plain scatter leaves it on the CPU), then the index
//     of each source that holds the best key (64-bit atomicMax on a
//     peer's shared memory lost updates on the card). The card's
//     scatter_reduce amax may let a NaN rho lose to the other sources of
//     its target, so there, and there alone, the kernel and the plain
//     stage part: the kernel keeps the CPU's rule. The step makes no NaN
//     rho in a valid slot (depth_ekf resets a non-finite estimate);
//     the card test of tests/test_torch_md_kernel.py pins the rule;
//   * the ladder's samples are loaded 8 at a time, the hits' fields 4 at
//     a time, from L2 (the old map's rotated fields are computed from its
//     own, never read back);
//   * md_depth's sums: each thread in float64 over its slots, the warp by
//     a shuffle tree, the CTA over its warps, then every CTA's sums in
//     rank order over distributed shared memory: a fixed order, so every
//     CTA holds the same Kp, run after run;
//   * nmatch: a shared atomicAdd per thread, then rank 0 adds the CTAs'
//     counts in rank order.
//
// Exactness. Every float32 value is the plain stage's bit for bit: each
// operation in the plain order (built with --fmad=false, IEEE division
// and square root), a Python float rounded to float32 where it meets a
// float32 tensor, torch's NaN propagation in clamp, round_int as
// core/numerics (floor(x + 0.5), NaN -> 0, saturating). The card's
// PyTorch and the CPU's differ in a few places, and `card` selects the
// card's: a division by a Python scalar is x * (1/c) (PyTorch's CUDA
// division by a CPU scalar), a division on the CPU; the float32 and
// float64 sums over a last axis of 3 add (x0 + x2) + x1, the CPU's
// (x0 + x1) + x2; numerics.matmul's float64 products are cuBLAS's
// (a gemm's dot products fma(a2, b2, fma(a1, b1, a0 b0)), as is the gemv
// of the mono step's BackRot @ Vel, BackRot a transposed view; the VI
// step's, of a row-major BackRot, fma(a2, b2, a0 b0) + a1 b1), the CPU's
// plain sums.
// so3_exp runs in float64 with sin and cos as torch calls them. The
// float64 sums of the rescaling may differ from torch's in their last
// float64 bits (another order); their float32 roundings are what the
// step reads.
//
// Host build: tests/cuda_host_emu.h (TP_HOST_EMU) provides the cluster,
// its barrier, each other's shared memory, the atomics and the warp
// reduction on std::threads.

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifndef TP_HOST_EMU
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#endif

namespace md {

constexpr int CLUSTER = 8;       // CTAs per lane and launch
constexpr int NT = 512;          // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int SHORT = 8;         // the shortlist's hits
constexpr int LBLK = 8;          // ladder samples loaded at once
constexpr int HBLK = 4;          // hits tested at once
constexpr size_t MAX_SMEM = 48 * 1024;   // no opt-in: capture-safe
constexpr float RHO_MIN = 1e-3f;
constexpr float RHO_MAX = 20.0f;
constexpr float RHO_INIT = 1.0f;
constexpr float BIG = 1e18f;
constexpr float FLT_MAX_ = 3.40282347e+38f;
constexpr unsigned POISON = ~0u;    // a NaN rho's tournament key

// md_match's inputs, in the order of the launcher's pointer array: the
// old (unrotated) map, the pose solver's m_id_f (null: no transfer), the
// new map, the old match field [H, W], Vel [3], P_V [3, 3], W [3] or R0
// and BackRot [3, 3] (one or the other), nan_fail [].
enum MatchIn {
  O_VALID, O_PX, O_PY, O_RHO, O_SRHO, O_GX, O_GY, O_NM, O_X, O_Y, O_AX,
  O_AY, O_ARHO, O_MNUM, O_MKF, M_ID_F, N_VALID, N_PX, N_PY, N_GX, N_GY,
  N_NM, N_RHO, N_SRHO, N_P0X, N_P0Y, N_G0X, N_G0Y, N_NM0, N_AX, N_AY,
  N_ARHO, N_MNUM, N_MID, N_MKF, FIELD, VEL, P_V, W_ROT, R0_ROT, BACK_ROT,
  NAN_FAIL, N_MATCH_IN
};
// md_match's float rows [N_OUT_F, L, K]: the matched map's changed
// fields, then the rotated old map's; its int rows [N_OUT_I, L, K]
// (field-major: each field of the L lanes is one contiguous block).
enum MatchOutF {
  F_RHO, F_SRHO, F_P0X, F_P0Y, F_G0X, F_G0Y, F_NM0, F_AX, F_AY, F_ARHO,
  F_OPX, F_OPY, F_ORHO, F_OSRHO, F_OGX, F_OGY, N_OUT_F
};
enum MatchOutI { I_MNUM, I_MID, I_MKF, N_OUT_I };
// md_depth's inputs: the map to filter (md_match's, a stereo step's after
// its median seed), Vel [3], nan_fail [], nmatch [], frame_count [], the
// previous frame's P_Kp [].
enum DepthIn {
  D_VALID, D_NID, D_PID, D_GX, D_GY, D_NM, D_PX, D_PY, D_RHO, D_SRHO,
  D_RHO0, D_SRHO0, D_MID, D_MNUM, D_P0X, D_P0Y, D_G0X, D_G0Y, D_NM0, D_VEL,
  D_NAN_FAIL, D_NMATCH, D_FRAME, D_PKP, N_DEPTH_IN
};
constexpr int N_OUT_D = 4;       // rho, s_rho, rho0, s_rho0 rows
constexpr int N_OUT_S = 6;       // Kp, Kp_gauge, P_Kp, V_out

#ifndef TP_HOST_EMU
namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned cluster_rank() {
  return cg::this_cluster().block_rank();
}
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }
template <typename T>
__device__ __forceinline__ T* cluster_map(T* p, unsigned rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}
__device__ __forceinline__ char* md_smem() {
  extern __shared__ double2 md_smem2[];
  return reinterpret_cast<char*>(md_smem2);
}
template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldg(p); }
__device__ __forceinline__ unsigned f2u(float x) { return __float_as_uint(x); }
// a and b summed over the warp by a shuffle tree; lane 0 holds the sums
__device__ __forceinline__ void warp_sum2(double* v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v[0] += __shfl_down_sync(0xffffffffu, v[0], o);
    v[1] += __shfl_down_sync(0xffffffffu, v[1], o);
  }
}
#else
inline char* md_smem() { return reinterpret_cast<char*>(dynamic_smem()); }
template <typename T>
inline T ld(const T* p) { return *p; }
inline unsigned f2u(float x) {
  unsigned u;
  memcpy(&u, &x, 4);
  return u;
}
inline void warp_sum2(double* v) { warp_sum_emu(v, 2); }
#endif

__device__ __forceinline__ bool nan_f(float x) { return x != x; }
__device__ __forceinline__ bool fin_f(float x) { return fabsf(x) <= FLT_MAX_; }
// torch.clamp: a NaN stays NaN
__device__ __forceinline__ float clamp_f(float x, float lo, float hi) {
  if (nan_f(x)) return x;
  const float y = x < lo ? lo : x;
  return y > hi ? hi : y;
}
__device__ __forceinline__ float clamp_min_f(float x, float lo) {
  return nan_f(x) || !(x < lo) ? x : lo;
}
__device__ __forceinline__ float clamp_max_f(float x, float hi) {
  return nan_f(x) || !(x > hi) ? x : hi;
}
// floor(x + 0.5) converted as XLA converts: NaN -> 0, saturating
__device__ __forceinline__ int round_i32(float x) {
  const float t = floorf(x + 0.5f);
  if (nan_f(t)) return 0;
  if (t >= 2147483648.0f) return 2147483647;
  if (t <= -2147483648.0f) return -2147483647 - 1;
  return (int)t;
}
// `card` (the launcher's flag) picks PyTorch's rounding on the card, the
// one the step runs; card = 0 (the CPU's) serves only the host build's
// tests, which hold the kernels against the plain versions on the CPU.
//
// x / c by a Python scalar c: x * (1/c) on the card, a division on the CPU
__device__ __forceinline__ float div_s(bool card, float x, float c,
                                      float inv_c) {
  return card ? x * inv_c : x / c;
}
__device__ __forceinline__ double div_sd(bool card, double x, double c) {
  return card ? x * (1.0 / c) : x / c;
}
// a sum over a last axis of 3 (float32 or float64)
template <typename T>
__device__ __forceinline__ T sum3(bool card, T x0, T x1, T x2) {
  return card ? (x0 + x2) + x1 : (x0 + x1) + x2;
}
// one entry of a float64 product (core/numerics.matmul): a gemm's dot
// product, and a gemv's of a row-major matrix (a transposed view's is
// the gemm's). Which one the plain step runs follows the layout of its
// tensors, which these two hold:
//   * dot_mm: so3_exp's K @ K, BackRot @ P_V and (BackRot P_V) @
//     BackRot^T in directed_matching_field, and BackRot @ Vel where
//     BackRot is so3_exp(W)'s transposed view `r0.T` (the mono step:
//     match_plain, VOFrontend._match);
//   * dot_mv: BackRot @ Vel where BackRot is a contiguous [3, 3] (the VI
//     step's R @ R0.T; the launcher refuses a non-contiguous BackRot).
// A .contiguous() on `r0.T` in match_plain, or a transposed view passed
// as the VI step's BackRot, changes the cuBLAS routine and its rounding:
// the card's tests (tests/test_torch_md_kernel.py -m card, chip_smoke's
// K5 phase) are what see it, not the host build's.
__device__ __forceinline__ double dot_mm(bool card, const double* a,
                                         const double* b) {
  if (card) return fma(a[2], b[2], fma(a[1], b[1], a[0] * b[0]));
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}
__device__ __forceinline__ double dot_mv(bool card, const double* a,
                                         const double* b) {
  if (card) return fma(a[2], b[2], a[0] * b[0]) + a[1] * b[1];
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// core/geometry.so3_exp in float64, rounded once to float32
__device__ void so3_exp(bool card, const float* wf, float* R) {
  const double w0 = wf[0], w1 = wf[1], w2 = wf[2];
  const double theta2 = sum3(card, w0 * w0, w1 * w1, w2 * w2);
  const bool small = theta2 < 1e-12;
  const double t2s = small ? 1.0 : theta2;
  const double theta = sqrt(t2s);
  const double A = small ? 1.0 - div_sd(card, theta2, 6.0)
                         : sin(theta) / theta;
  const double B = small ? 0.5 - div_sd(card, theta2, 24.0)
                         : (1.0 - cos(theta)) / t2s;
  const double K[9] = {0.0, -w2, w1, w2, 0.0, -w0, -w1, w0, 0.0};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const double col[3] = {K[j], K[3 + j], K[6 + j]};
      const double kk = dot_mm(card, K + 3 * i, col);
      const double e = i == j ? 1.0 : 0.0;
      R[i * 3 + j] = (float)((e + A * K[i * 3 + j]) + B * kk);
    }
}

struct MatchArgs {
  const void* in[N_MATCH_IN];
  float* out_f;       // [N_OUT_F, L, K]
  int* out_i;         // [N_OUT_I, L, K]
  float* out_r;       // [L, 9]: R0
  int* nmatch;        // [L]
  uint8_t* est_ok;    // [L]
  int L, K, H, W, max_steps, stride, gmt, card;
  float zfm, inv_zfm, cx, cy, thr_mod, cang_min, max_radius, loc, full, l2,
      half;
};

// A lane's per-frame constants (thread 0 of each CTA, in shared memory).
struct LaneC {
  float R0[9];        // the old map's rotation
  float Rb[9];        // BackRot
  float Vb[3];        // BackRot @ Vel
  float RV[9];        // BackRot P_V BackRot^T
  float R2z[3];       // BackRot[:, 2] * zfm
  float Vz[2];        // Vb[0] * zfm, Vb[1] * zfm
};

template <typename T>
__device__ __forceinline__ const T* in_of(const MatchArgs& a, int i,
                                          size_t off) {
  return static_cast<const T*>(a.in[i]) + off;
}

__device__ void lane_setup(const MatchArgs& a, int lane, LaneC* c) {
  const bool card = a.card != 0;
  const float* w = static_cast<const float*>(a.in[W_ROT]);
  if (w) {
    so3_exp(card, w + (size_t)lane * 3, c->R0);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) c->Rb[i * 3 + j] = c->R0[j * 3 + i];
  } else {
    const float* r0 = in_of<float>(a, R0_ROT, (size_t)lane * 9);
    const float* br = in_of<float>(a, BACK_ROT, (size_t)lane * 9);
    for (int i = 0; i < 9; ++i) {
      c->R0[i] = r0[i];
      c->Rb[i] = br[i];
    }
  }
  const float* v = in_of<float>(a, VEL, (size_t)lane * 3);
  const float* pv = in_of<float>(a, P_V, (size_t)lane * 9);
  double rb[9], vd[3], t[9];
  for (int i = 0; i < 9; ++i) rb[i] = c->Rb[i];
  for (int i = 0; i < 3; ++i) vd[i] = v[i];
  // BackRot is so3_exp(W)'s transposed view in the mono step, a matrix of
  // its own in the VI step
  for (int i = 0; i < 3; ++i)
    c->Vb[i] = (float)(w ? dot_mm(card, rb + 3 * i, vd)
                         : dot_mv(card, rb + 3 * i, vd));
  // T = BackRot @ P_V (rounded), then T @ BackRot^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const double col[3] = {pv[j], pv[3 + j], pv[6 + j]};
      t[i * 3 + j] = (float)dot_mm(card, rb + 3 * i, col);
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c->RV[i * 3 + j] = (float)dot_mm(card, t + 3 * i, rb + 3 * j);
  for (int i = 0; i < 3; ++i) c->R2z[i] = c->Rb[i * 3 + 2] * a.zfm;
  c->Vz[0] = c->Vb[0] * a.zfm;
  c->Vz[1] = c->Vb[1] * a.zfm;
}

// Old slot s rotated by R0 (rotate_hom_points, rotate_gradients).
struct Rot {
  float px, py, rho, srho, gx, gy;
};

__device__ __forceinline__ Rot rotate(const MatchArgs& a, const float* R,
                                      float px, float py, float rho,
                                      float srho, float gx, float gy) {
  const bool card = a.card != 0;
  const float z = a.zfm, iz = a.inv_zfm;
  const float qx = (div_s(card, R[0] * px, z, iz) +
                    div_s(card, R[1] * py, z, iz)) + R[2];
  const float qy = (div_s(card, R[3] * px, z, iz) +
                    div_s(card, R[4] * py, z, iz)) + R[5];
  const float qz = (div_s(card, R[6] * px, z, iz) +
                    div_s(card, R[7] * py, z, iz)) + R[8];
  const bool ok = fabsf(qz) > 0.0f;
  const float sq = ok ? qz : 1.0f;
  Rot r;
  r.px = ok ? (qx / sq) * z : px;
  r.py = ok ? (qy / sq) * z : py;
  r.rho = ok ? rho / sq : rho;
  r.srho = ok ? srho / sq : srho;
  r.gx = R[0] * gx + R[1] * gy;
  r.gy = R[3] * gx + R[4] * gy;
  return r;
}

// The tournament key of a source's rho: its order-keeping bits (-0 as
// +0; above 0, which stands for no source), POISON for a NaN.
__device__ __forceinline__ unsigned key_of(float rho) {
  if (nan_f(rho)) return POISON;
  const unsigned u = f2u(rho == 0.0f ? 0.0f : rho);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

constexpr size_t LANEC_BYTES = (sizeof(LaneC) + 15) / 16 * 16;

// LaneC, the CTA's count, then the best key and the winner of each of its
// chunk targets
__host__ __device__ constexpr size_t match_smem(int K) {
  return LANEC_BYTES + 16 + 8 * (size_t)((K + CLUSTER - 1) / CLUSTER);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT)
    md_match_kernel(const MatchArgs a) {
  const int K = a.K;
  const int chunk = (K + CLUSTER - 1) / CLUSTER;
  char* sm = md_smem();
  LaneC* lc = reinterpret_cast<LaneC*>(sm);
  int* cnt = reinterpret_cast<int*>(sm + LANEC_BYTES);
  unsigned* best = reinterpret_cast<unsigned*>(sm + LANEC_BYTES + 16);
  int* win = reinterpret_cast<int*>(best + chunk);
  const unsigned rank = cluster_rank();
  const int tid = threadIdx.x;
  const int lane = blockIdx.x / CLUSTER;
  const size_t lk = (size_t)lane * K;
  const int lo = (int)rank * chunk;
  const int hi = min(K, lo + chunk);
  const bool card = a.card != 0;
  const bool fwd = a.in[M_ID_F] != nullptr;

  if (tid == 0) {
    *cnt = 0;
    lane_setup(a, lane, lc);
  }
  if (fwd)
    for (int s = lo + tid; s < hi; s += NT) {
      best[s - lo] = 0;
      win[s - lo] = -1;
    }
  __syncthreads();

  const uint8_t* o_valid = in_of<uint8_t>(a, O_VALID, lk);
  const float* o_px = in_of<float>(a, O_PX, lk);
  const float* o_py = in_of<float>(a, O_PY, lk);
  const float* o_rho = in_of<float>(a, O_RHO, lk);
  const float* o_srho = in_of<float>(a, O_SRHO, lk);
  const float* o_gx = in_of<float>(a, O_GX, lk);
  const float* o_gy = in_of<float>(a, O_GY, lk);
  const float* o_nm = in_of<float>(a, O_NM, lk);
  const float* o_x = in_of<float>(a, O_X, lk);
  const float* o_y = in_of<float>(a, O_Y, lk);
  const float* o_ax = in_of<float>(a, O_AX, lk);
  const float* o_ay = in_of<float>(a, O_AY, lk);
  const float* o_arho = in_of<float>(a, O_ARHO, lk);
  const int* o_mnum = in_of<int>(a, O_MNUM, lk);
  const int* o_mkf = in_of<int>(a, O_MKF, lk);
  // the output rows are field-major, [rows, L, K]
  const size_t LK = (size_t)a.L * K;
  float* of = a.out_f + lk;
  int* oi = a.out_i + lk;
  const float* R0 = lc->R0;

  // the rotated old map, this CTA's slots
  for (int s = lo + tid; s < hi; s += NT) {
    const Rot r = rotate(a, R0, ld(o_px + s), ld(o_py + s), ld(o_rho + s),
                         ld(o_srho + s), ld(o_gx + s), ld(o_gy + s));
    of[(size_t)F_OPX * LK + s] = r.px;
    of[(size_t)F_OPY * LK + s] = r.py;
    of[(size_t)F_ORHO * LK + s] = r.rho;
    of[(size_t)F_OSRHO * LK + s] = r.srho;
    of[(size_t)F_OGX * LK + s] = r.gx;
    of[(size_t)F_OGY * LK + s] = r.gy;
  }
  // the forward transfer's tournament, in the targets' owners, in two
  // rounds as the plain scatters: the largest rho, then the largest source
  // index among those holding it
  if (fwd) {
    const int* mf = in_of<int>(a, M_ID_F, lk);
    cluster_sync();
    for (int s = lo + tid; s < hi; s += NT) {
      const int t = ld(mf + s);
      if (t >= 0 && t < K && ld(o_valid + s))
        atomicMax(cluster_map(best + t % chunk, (unsigned)(t / chunk)),
                  key_of(ld(o_rho + s)));
    }
    cluster_sync();
    for (int s = lo + tid; s < hi; s += NT) {
      const int t = ld(mf + s);
      if (t >= 0 && t < K && ld(o_valid + s)) {
        const unsigned k = key_of(ld(o_rho + s));
        if (k != POISON &&
            k == *cluster_map(best + t % chunk, (unsigned)(t / chunk)))
          atomicMax(cluster_map(win + t % chunk, (unsigned)(t / chunk)), s);
      }
    }
    cluster_sync();
  }

  const uint8_t* n_valid = in_of<uint8_t>(a, N_VALID, lk);
  const float* n_px = in_of<float>(a, N_PX, lk);
  const float* n_py = in_of<float>(a, N_PY, lk);
  const float* n_gx = in_of<float>(a, N_GX, lk);
  const float* n_gy = in_of<float>(a, N_GY, lk);
  const float* n_nm = in_of<float>(a, N_NM, lk);
  const int* field = in_of<int>(a, FIELD, (size_t)lane * a.H * a.W);
  const float z = a.zfm;
  const float* Rb = lc->Rb;
  const float Vb2 = lc->Vb[2];
  const int nc = 2 * a.max_steps;
  int n = 0;
  for (int i = lo + tid; i < hi; i += NT) {
    // the new map's slot after the forward transfer
    float rho = ld(in_of<float>(a, N_RHO, lk) + i);
    float srho = ld(in_of<float>(a, N_SRHO, lk) + i);
    float p0x = ld(in_of<float>(a, N_P0X, lk) + i);
    float p0y = ld(in_of<float>(a, N_P0Y, lk) + i);
    float g0x = ld(in_of<float>(a, N_G0X, lk) + i);
    float g0y = ld(in_of<float>(a, N_G0Y, lk) + i);
    float nm0 = ld(in_of<float>(a, N_NM0, lk) + i);
    float ax = ld(in_of<float>(a, N_AX, lk) + i);
    float ay = ld(in_of<float>(a, N_AY, lk) + i);
    float arho = ld(in_of<float>(a, N_ARHO, lk) + i);
    int mnum = ld(in_of<int>(a, N_MNUM, lk) + i);
    int mid = ld(in_of<int>(a, N_MID, lk) + i);
    int mkf = ld(in_of<int>(a, N_MKF, lk) + i);
    if (fwd && best[i - lo] != POISON && win[i - lo] >= 0) {
      {
        const int w = win[i - lo];
        rho = ld(o_rho + w);
        srho = ld(o_srho + w);
        mnum = ld(o_mnum + w) + 1;
        mid = w;
        p0x = ld(o_px + w);
        p0y = ld(o_py + w);
        g0x = ld(o_gx + w);
        g0y = ld(o_gy + w);
        nm0 = ld(o_nm + w);
        mkf = ld(o_mkf + w);
        ax = ld(o_ax + w);
        ay = ld(o_ay + w);
        arho = ld(o_arho + w);
      }
    }

    bool matched = false;
    if (ld(n_valid + i)) {
      const float px = ld(n_px + i), py = ld(n_py + i);
      const float gx = ld(n_gx + i), gy = ld(n_gy + i);
      const float nm = ld(n_nm + i);
      // _search_line
      const float p3x = (Rb[0] * px + Rb[1] * py) + lc->R2z[0];
      const float p3y = (Rb[3] * px + Rb[4] * py) + lc->R2z[1];
      const float p3z = (Rb[6] * px + Rb[7] * py) + lc->R2z[2];
      const float pmx = (p3x * z) / p3z;
      const float pmy = (p3y * z) / p3z;
      const float k_rho = (rho * z) / p3z;
      const float pi0x = pmx + a.cx;
      const float pi0y = pmy + a.cy;
      const float t_x = -(lc->Vz[0] - Vb2 * pmx);
      const float t_y = -(lc->Vz[1] - Vb2 * pmy);
      const float norm_t0 = sqrtf(t_x * t_x + t_y * t_y);
      const double dr[3] = {(double)z, (double)z, (double)(-pmx - pmy)};
      float m[3];
      for (int j = 0; j < 3; ++j) {
        const double col[3] = {lc->RV[j], lc->RV[3 + j], lc->RV[6 + j]};
        m[j] = (float)dot_mm(card, dr, col);
      }
      const float sigma2_t = sum3(card, m[0] * z, m[1] * z,
                                  m[2] * (-pmx - pmy));
      const bool moving = norm_t0 > 1e-6f;
      const float norm_t = moving ? norm_t0 : 1.0f;
      const float inv_n = 1.0f / (moving ? norm_t0 : 1.0f);
      const float ux = moving ? t_x * inv_n : gx / nm;
      const float uy = moving ? t_y * inv_n : gy / nm;
      float dq_rho = norm_t0 * k_rho;
      const float dq_min_m =
          clamp_min_f(norm_t0 * (k_rho - srho), 0.0f) - a.loc;
      const float dq_max_m =
          clamp_max_f(norm_t0 * (k_rho + srho), a.max_radius) + a.loc;
      if (dq_rho > dq_max_m) dq_rho = (dq_max_m + dq_min_m) * 0.5f;
      const float dq_min = moving ? dq_min_m : -a.full;
      const float dq_max = moving ? dq_max_m : a.full;
      if (!moving) dq_rho = 0.0f;
      const float lo_t = dq_min - a.half;
      const float hi_t = dq_max + a.half;

      // the ladder's first SHORT hits, in ladder order
      int hits[SHORT];
      int nh = 0;
      for (int c0 = 0; c0 < nc && nh < SHORT; c0 += LBLK) {
        int j[LBLK];
#pragma unroll
        for (int u = 0; u < LBLK; ++u) {
          const int c = c0 + u;
          j[u] = -1;
          if (c < nc) {
            const float step = (float)(c >> 1) * (float)a.stride;
            const float cand = (c & 1) ? (dq_rho + step) + a.half
                                       : dq_rho - step;
            const int qx = round_i32(ux * cand + pi0x);
            const int qy = round_i32(uy * cand + pi0y);
            if (cand >= lo_t && cand <= hi_t && qx >= 0 && qx < a.W &&
                qy >= 0 && qy < a.H)
              j[u] = ld(field + (size_t)qy * a.W + qx);
          }
        }
#pragma unroll
        for (int u = 0; u < LBLK; ++u) {
          if (j[u] >= 0 && nh < SHORT) {
#pragma unroll
            for (int q = 0; q < SHORT; ++q)
              if (q == nh) hits[q] = j[u];
            ++nh;
          }
        }
      }

      // the first accepted hit
      const float l2n = norm_t * norm_t;
#pragma unroll
      for (int g0 = 0; g0 < SHORT; g0 += HBLK) {
        if (g0 >= nh || matched) break;
        Rot r[HBLK];
        float onm[HBLK], ox[HBLK], oy[HBLK];
        int js[HBLK];
#pragma unroll
        for (int v = 0; v < HBLK; ++v) {
          js[v] = -1;
          if (g0 + v < nh) {
            int jj = hits[g0 + v];
            js[v] = jj < K ? jj : K - 1;
            const int s = js[v];
            r[v] = rotate(a, R0, ld(o_px + s), ld(o_py + s), ld(o_rho + s),
                          ld(o_srho + s), ld(o_gx + s), ld(o_gy + s));
            onm[v] = ld(o_nm + s);
            ox[v] = ld(o_x + s);
            oy[v] = ld(o_y + s);
          }
        }
#pragma unroll
        for (int v = 0; v < HBLK; ++v) {
          if (matched || js[v] < 0) continue;
          const float cang = (r[v].gx * gx + r[v].gy * gy) / (onm[v] * nm);
          const bool grad_ok = cang >= a.cang_min &&
                               fabsf(onm[v] / nm - 1.0f) <= a.thr_mod;
          const float t_ex = (ox[v] - pi0x) * ux + (oy[v] - pi0y) * uy;
          const bool range_ok = t_ex >= dq_min && t_ex <= dq_max;
          const float v_rho_dr =
              (a.l2 + (r[v].srho * r[v].srho) * l2n) +
              (sigma2_t * r[v].rho) * r[v].rho;
          const float d = t_ex - norm_t * r[v].rho;
          if (grad_ok && range_ok && d * d <= v_rho_dr) {
            const int s = js[v];
            matched = true;
            rho = r[v].rho;
            srho = r[v].srho;
            mid = hits[g0 + v];
            mnum = ld(o_mnum + s) + 1;
            p0x = r[v].px;
            p0y = r[v].py;
            g0x = r[v].gx;
            g0y = r[v].gy;
            nm0 = onm[v];
            mkf = ld(o_mkf + s);
            ax = ld(o_ax + s);
            ay = ld(o_ay + s);
            arho = ld(o_arho + s);
          }
        }
      }
    }
    n += matched;
    of[(size_t)F_RHO * LK + i] = rho;
    of[(size_t)F_SRHO * LK + i] = srho;
    of[(size_t)F_P0X * LK + i] = p0x;
    of[(size_t)F_P0Y * LK + i] = p0y;
    of[(size_t)F_G0X * LK + i] = g0x;
    of[(size_t)F_G0Y * LK + i] = g0y;
    of[(size_t)F_NM0 * LK + i] = nm0;
    of[(size_t)F_AX * LK + i] = ax;
    of[(size_t)F_AY * LK + i] = ay;
    of[(size_t)F_ARHO * LK + i] = arho;
    oi[(size_t)I_MNUM * LK + i] = mnum;
    oi[(size_t)I_MID * LK + i] = mid;
    oi[(size_t)I_MKF * LK + i] = mkf;
  }

  // nmatch: the CTA's, then the cluster's in rank order
  if (n) atomicAdd(cnt, n);
  cluster_sync();
  if (rank == 0 && tid == 0) {
    int t = 0;
    for (unsigned r = 0; r < CLUSTER; ++r) t += *cluster_map(cnt, r);
    a.nmatch[lane] = t;
    const bool nan_fail = ld(in_of<uint8_t>(a, NAN_FAIL, lane)) != 0;
    a.est_ok[lane] = (!nan_fail && !(t < a.gmt)) ? 1 : 0;
    for (int i = 0; i < 9; ++i) a.out_r[(size_t)lane * 9 + i] = lc->R0[i];
  }
  // a CTA's shared memory stays until every CTA is done reading it
  cluster_sync();
}

struct DepthArgs {
  const void* in[N_DEPTH_IN];
  float* out_f;       // [N_OUT_D, L, K]
  float* out_s;       // [L, N_OUT_S]
  int L, K, rescale, do_res, imu_boot, brf, gmt, iters, card;
  float thresh, one_m_thresh, inv_one_m_thresh, zfm, rq2, l2;
};

template <typename T>
__device__ __forceinline__ const T* in_of(const DepthArgs& a, int i,
                                          size_t off) {
  return static_cast<const T*>(a.in[i]) + off;
}

// shared memory of md_depth: the warps' sums, the CTA's sums of two
// rounds, Kp and RKp
struct DepthSmem {
  double warp_part[NWARP][2];
  double part[2][2];
  float kp[2];
};

__host__ __device__ constexpr size_t depth_smem() {
  return (sizeof(DepthSmem) + 15) / 16 * 16;
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT)
    md_depth_kernel(const DepthArgs a) {
  const int K = a.K;
  const int chunk = (K + CLUSTER - 1) / CLUSTER;
  DepthSmem* sm = reinterpret_cast<DepthSmem*>(md_smem());
  const unsigned rank = cluster_rank();
  const int tid = threadIdx.x;
  const int lane = blockIdx.x / CLUSTER;
  const size_t lk = (size_t)lane * K;
  const int lo = (int)rank * chunk;
  const int hi = min(K, lo + chunk);
  const bool card = a.card != 0;

  const uint8_t* valid = in_of<uint8_t>(a, D_VALID, lk);
  const int* n_id = in_of<int>(a, D_NID, lk);
  const int* p_id = in_of<int>(a, D_PID, lk);
  const float* gx = in_of<float>(a, D_GX, lk);
  const float* gy = in_of<float>(a, D_GY, lk);
  const float* n_m = in_of<float>(a, D_NM, lk);
  const float* rho = in_of<float>(a, D_RHO, lk);
  const float* srho = in_of<float>(a, D_SRHO, lk);
  const float* rho0 = in_of<float>(a, D_RHO0, lk);
  const float* srho0 = in_of<float>(a, D_SRHO0, lk);
  const int* m_num = in_of<int>(a, D_MNUM, lk);
  const float* vel = in_of<float>(a, D_VEL, (size_t)lane * 3);
  const float V0 = ld(vel), V1 = ld(vel + 1), V2 = ld(vel + 2);
  const float Vz0 = V0 * a.zfm, Vz1 = V1 * a.zfm;
  // the output rows are field-major, [N_OUT_D, L, K]
  const size_t LK = (size_t)a.L * K;
  float* of = a.out_f + lk;

  for (int i = lo + tid; i < hi; i += NT) {
    // regularize_1_iter
    const float r = ld(rho + i), s = ld(srho + i);
    const int nid = ld(n_id + i), pid = ld(p_id + i);
    const bool has_nb = ld(valid + i) && nid >= 0 && pid >= 0;
    const int ni = nid < 0 ? 0 : (nid < K ? nid : K - 1);
    const int pi = pid < 0 ? 0 : (pid < K ? pid : K - 1);
    const float rho_n = ld(rho + ni), rho_p = ld(rho + pi);
    const float s_n = ld(srho + ni), s_p = ld(srho + pi);
    const float dr = rho_n - rho_p;
    const bool sigma_ok = dr * dr <= (s_n * s_n + s_p * s_p);
    const float alpha0 = (ld(gx + ni) * ld(gx + pi) + ld(gy + ni) * ld(gy + pi)) /
                         (ld(n_m + ni) * ld(n_m + pi));
    const float am = alpha0 - a.thresh;
    const bool angle_ok = am >= 0.0f;
    float alpha = div_s(card, am, a.one_m_thresh, a.inv_one_m_thresh);
    alpha = alpha / (fabsf(dr) / (s_n + s_p) + 1.0f);
    const float wr = 1.0f / (s * s);
    const float wrn = alpha / (s_n * s_n);
    const float wrp = alpha / (s_p * s_p);
    const float wsum = (wr + wrn) + wrp;
    const bool apply = has_nb && sigma_ok && angle_ok;
    const float r1 = apply ? ((r * wr + rho_n * wrn) + rho_p * wrp) / wsum : r;
    const float s1 = apply ? ((s * wr + s_n * wrn) + s_p * wrp) / wsum : s;
    // depth_ekf
    const bool active = ld(valid + i) && ld(in_of<int>(a, D_MID, lk) + i) >= 0;
    float r2 = r1, s2 = s1, r0 = ld(rho0 + i), s0 = ld(srho0 + i);
    if (active) {
      const float nm0 = ld(in_of<float>(a, D_NM0, lk) + i);
      const float p0x = ld(in_of<float>(a, D_P0X, lk) + i);
      const float p0y = ld(in_of<float>(a, D_P0Y, lk) + i);
      const float u_x = ld(in_of<float>(a, D_G0X, lk) + i) / nm0;
      const float u_y = ld(in_of<float>(a, D_G0Y, lk) + i) / nm0;
      const float Y = u_x * (ld(in_of<float>(a, D_PX, lk) + i) - p0x) +
                      u_y * (ld(in_of<float>(a, D_PY, lk) + i) - p0y);
      const float H = u_x * (Vz0 - V2 * p0x) + u_y * (Vz1 - V2 * p0y);
      const float rho_p1 = 1.0f / (1.0f / r1 + V2);
      const float F = 1.0f / (r1 * V2 + 1.0f);
      const float F2 = F * F;
      const float p_p = (F2 * (s1 * s1)) * F2 + a.rq2;
      const float e = Y - H * rho_p1;
      const float S = (H * p_p) * H + a.l2;
      const float Kk = (p_p * H) / S;
      float rho_new = rho_p1 + Kk * e;
      float s_new = sqrtf((1.0f - Kk * H) * p_p);
      if (rho_new < RHO_MIN) s_new = s_new + (RHO_MIN - rho_new);
      rho_new = clamp_f(rho_new, RHO_MIN, RHO_MAX);
      const bool bad = !fin_f(rho_new) || !fin_f(s_new) || s_new < 0.0f;
      r2 = bad ? RHO_INIT : rho_new;
      s2 = bad ? RHO_MAX : s_new;
      r0 = rho_p1;
      s0 = s1;
    }
    of[i] = r2;
    of[LK + i] = s2;
    of[2 * LK + i] = r0;
    of[3 * LK + i] = s0;
  }
  float* os = a.out_s + (size_t)lane * N_OUT_S;
  const bool nan_fail = ld(in_of<uint8_t>(a, D_NAN_FAIL, lane)) != 0;
  const bool match_fail = ld(in_of<int>(a, D_NMATCH, lane)) < a.gmt;
  const bool est_ok = !nan_fail && !match_fail;
  if (!a.rescale) {
    // the stereo tail: the pair holds the scale (Kp = 1), P_Kp carries
    if (rank == 0 && tid == 0) {
      const float pkp = ld(in_of<float>(a, D_PKP, lane));
      os[0] = 1.0f;
      os[1] = 1.0f;
      os[2] = nan_fail ? BIG : (match_fail ? 10.0f : pkp);
      os[3] = est_ok ? V0 : 0.0f;
      os[4] = est_ok ? V1 : 0.0f;
      os[5] = est_ok ? V2 : 0.0f;
    }
    return;
  }

  // estimate_rescaling_opt: rounds of two float64 sums over the lane
  float Kp = 1.0f, RKp = 1.0f;
  for (int it = 0; it < a.iters; ++it) {
    double v[2] = {0.0, 0.0};
    const float kk = Kp * Kp;
    for (int i = lo + tid; i < hi; i += NT) {
      const float r2 = of[i], s2 = of[LK + i];
      const float r0 = of[2 * LK + i], s0 = of[3 * LK + i];
      const bool use = ld(valid + i) && ld(m_num + i) >= 1 && s0 > 0.0f &&
                       s2 <= RHO_MAX;
      if (use) {
        const float w = 1.0f / (s2 * s2 + kk * (s0 * s0));
        v[0] += (double)((r2 * r2) * w);
        v[1] += (double)((r0 * r0) * w);
      }
    }
    warp_sum2(v);
    if ((tid & 31) == 0) {
      sm->warp_part[tid >> 5][0] = v[0];
      sm->warp_part[tid >> 5][1] = v[1];
    }
    __syncthreads();
    if (tid == 0) {
      double t0 = 0.0, t1 = 0.0;
      for (int w = 0; w < NWARP; ++w) {
        t0 += sm->warp_part[w][0];
        t1 += sm->warp_part[w][1];
      }
      sm->part[it & 1][0] = t0;
      sm->part[it & 1][1] = t1;
    }
    cluster_sync();
    if (tid == 0) {
      double t0 = 0.0, t1 = 0.0;
      for (unsigned q = 0; q < CLUSTER; ++q) {
        const double* p = cluster_map(&sm->part[it & 1][0], q);
        t0 += p[0];
        t1 += p[1];
      }
      const float rTr = (float)t0, rTr0 = (float)t1;
      const bool pos = rTr0 > 0.0f;
      const float safe = pos ? rTr0 : 1.0f;
      sm->kp[0] = pos ? sqrtf(rTr / safe) : 1.0f;
      sm->kp[1] = 1.0f / safe;
    }
    __syncthreads();
    Kp = sm->kp[0];
    RKp = sm->kp[1];
  }

  const bool boot = ld(in_of<int>(a, D_FRAME, lane)) <= a.brf;
  const bool moving = fabsf(Kp - 1.0f) > 0.05f;
  const bool apply_res =
      a.do_res != 0 || (a.imu_boot != 0 && boot && moving && est_ok);
  const float div = apply_res ? Kp : 1.0f;
  for (int i = lo + tid; i < hi; i += NT) {
    if (est_ok) {
      of[i] = of[i] / div;
      of[LK + i] = of[LK + i] / div;
    } else {
      of[i] = ld(rho + i);
      of[LK + i] = ld(srho + i);
      of[2 * LK + i] = ld(rho0 + i);
      of[3 * LK + i] = ld(srho0 + i);
    }
  }
  if (rank == 0 && tid == 0) {
    const float kp = est_ok ? Kp : 1.0f;
    os[0] = kp;
    os[1] = apply_res ? 1.0f : kp;
    os[2] = nan_fail ? BIG : (match_fail ? 10.0f : RKp);
    os[3] = est_ok ? V0 : 0.0f;
    os[4] = est_ok ? V1 : 0.0f;
    os[5] = est_ok ? V2 : 0.0f;
  }
  // a CTA's shared memory stays until every CTA is done reading it
  cluster_sync();
}

#ifndef TP_HOST_EMU
inline int max_clusters(bool depth, int K, int* n) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = depth ? depth_smem() : match_smem(K);
  return (int)cudaOccupancyMaxActiveClusters(
      n, depth ? (void*)md_depth_kernel : (void*)md_match_kernel, &cfg);
}
#endif

template <typename Args>
inline int launch(void (*kernel)(const Args), const Args& a, int L,
                  size_t smem, void* stream) {
  if (L < 1 || (long long)L * CLUSTER > 2147483647LL || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(L * CLUSTER);
  const dim3 block(NT);
  cudaStream_t st = (cudaStream_t)stream;
#ifdef TP_HOST_EMU
  return (int)launch_cluster_kernel(kernel, grid, block, CLUSTER, smem, st,
                                    a);
#else
  kernel<<<grid, block, smem, st>>>(a);
  return (int)cudaGetLastError();
#endif
}
}  // namespace md

// Shared bytes of md_match's and md_depth's CTAs at K slots a lane,
// threads a CTA and CTAs a cluster (one cluster a lane and launch).
extern "C" void md_launch_config(int K, int* smem_match, int* smem_depth,
                                 int* threads, int* cluster) {
  *smem_match = (int)md::match_smem(K);
  *smem_depth = (int)md::depth_smem();
  *threads = md::NT;
  *cluster = md::CLUSTER;
}

#ifndef TP_HOST_EMU
// Clusters of md_match (depth = 0) or md_depth (1) resident at once.
extern "C" int md_max_clusters(int depth, int K, int* n) {
  return md::max_clusters(depth != 0, K, n);
}
#endif

// md_match over L lanes. `in`: N_MATCH_IN pointers (MatchIn's order),
// inputs contiguous and lane-major; m_id_f may be null; W, or R0 and
// BackRot. cudaErrorInvalidValue for inputs or sizes it does not take.
extern "C" int md_match_launch(
    const void* const* in, int n_in, float* out_f, int* out_i, float* out_r,
    int* nmatch, uint8_t* est_ok, int L, int K, int H, int W, int max_steps,
    int stride, int gmt, int card, float zfm, float inv_zfm, float cx, float cy,
    float thr_mod, float cang_min, float max_radius, float loc, float full,
    float l2, float half, void* stream) {
  using namespace md;
  if (n_in != N_MATCH_IN || K < 1 || H < 1 || W < 1 || max_steps < 0 ||
      !out_f || !out_i || !out_r || !nmatch || !est_ok)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < N_MATCH_IN; ++i) {
    const bool optional =
        i == M_ID_F || i == W_ROT || i == R0_ROT || i == BACK_ROT;
    if (!optional && !in[i]) return (int)cudaErrorInvalidValue;
  }
  const bool w = in[W_ROT] != nullptr;
  if (w == (in[R0_ROT] != nullptr) || w == (in[BACK_ROT] != nullptr))
    return (int)cudaErrorInvalidValue;
  MatchArgs a;
  for (int i = 0; i < N_MATCH_IN; ++i) a.in[i] = in[i];
  a.out_f = out_f;
  a.out_i = out_i;
  a.out_r = out_r;
  a.nmatch = nmatch;
  a.est_ok = est_ok;
  a.L = L;
  a.K = K;
  a.H = H;
  a.W = W;
  a.max_steps = max_steps;
  a.stride = stride;
  a.gmt = gmt;
  a.card = card;
  a.zfm = zfm;
  a.inv_zfm = inv_zfm;
  a.cx = cx;
  a.cy = cy;
  a.thr_mod = thr_mod;
  a.cang_min = cang_min;
  a.max_radius = max_radius;
  a.loc = loc;
  a.full = full;
  a.l2 = l2;
  a.half = half;
  return launch(md_match_kernel, a, L, match_smem(K), stream);
}

// md_depth over L lanes. `in`: N_DEPTH_IN pointers (DepthIn's order).
extern "C" int md_depth_launch(
    const void* const* in, int n_in, float* out_f, float* out_s, int L,
    int K, int rescale, int do_res, int imu_boot, int brf, int gmt,
    int iters, int card, float thresh, float one_m_thresh,
    float inv_one_m_thresh, float zfm, float rq2, float l2, void* stream) {
  using namespace md;
  if (n_in != N_DEPTH_IN || K < 1 || iters < 0 || !out_f || !out_s)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < N_DEPTH_IN; ++i)
    if (!in[i]) return (int)cudaErrorInvalidValue;
  DepthArgs a;
  for (int i = 0; i < N_DEPTH_IN; ++i) a.in[i] = in[i];
  a.out_f = out_f;
  a.out_s = out_s;
  a.L = L;
  a.K = K;
  a.rescale = rescale;
  a.do_res = do_res;
  a.imu_boot = imu_boot;
  a.brf = brf;
  a.gmt = gmt;
  a.iters = iters;
  a.card = card;
  a.thresh = thresh;
  a.one_m_thresh = one_m_thresh;
  a.inv_one_m_thresh = inv_one_m_thresh;
  a.zfm = zfm;
  a.rq2 = rq2;
  a.l2 = l2;
  return launch(md_depth_kernel, a, L, depth_smem(), stream);
}
