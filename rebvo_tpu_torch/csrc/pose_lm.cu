// The pose solver for Hopper (sm_90a): minimizer_rv's whole
// Levenberg-Marquardt run in one launch per frame and lane.
//
// Replaces no TPU kernel: the JAX package leaves the solver
// (rebvo_tpu/kernels/pose_solver.py: try_vel_rot, minimizer_rv) to XLA.
// Its PyTorch form (kernels/pose_solver.minimizer_rv_plain) dispatches
// about 4,400 small ops a frame, each over the K keyline slots: 22
// evaluations of the robust cost, 9 batched LM iterations with their 6x6
// solves, the warm-start ladder's selections. This kernel runs all of it:
//   * the evaluation at the prior that freezes the noise shaping q;
//   * the warm start of init_type 2: two LM runs (zero and prior starts)
//     of init_iter iterations, the better start, three runs from its
//     velocity scaled 2x/4x/8x, the best rung if it beats the start by 2%
//     (init_type 0 starts at zero, 1 at the prior);
//   * the main run of iter_max iterations and the final 6x6 inverse;
// and writes every field of MinimizerRVResult.
//
// Bound. The map's 9 fields are read once (33 B a slot, 0.54 MB at
// K = 16384); an evaluation then gathers, per valid slot, the field
// image's entry and 6 floats of the matched keyline's row (28 B): at most
// 0.46 MB, and 22 evaluations at most ~10.6 MB, about 3 us at 3.35 TB/s.
// What held the plain version back was its launches; what bounds this
// kernel is the chain of 13 dependent rounds (each an evaluation, a
// reduction over the slots and a 6x6 solve on one thread) and, in a
// round, the latency of each slot's two dependent gathers. So the design keeps a round short:
//   * one cluster of CLUSTER CTAs per lane, the slots split across the
//     cluster (slot k to thread k mod CLUSTER*NT); the states of a round
//     (1, or the 2 starts / 3 rungs of the ladder) evaluated in turn;
//   * a thread reads its slots' map fields once: the live ones (not gated
//     by the map, at any state) go into a table in shared memory with
//     what does not depend on the state (the back-projection, n_m^2, q),
//     and an evaluation walks the table in pairs whose gathers (the field
//     image, then the matched keyline's row) are in flight together;
//   * per state a thread accumulates J^T J (21 entries), J^T F and the
//     score in float64 (each product double(a) * double(b), as
//     core/numerics.matmul), the warp reduces by shuffles, the CTA over
//     its warps in shared memory, and every CTA adds the CTAs' partials
//     in rank order over distributed shared memory: a fixed order, so the
//     result does not change from run to run, and every CTA holds it;
//   * one thread per state does the LM bookkeeping, the LU solve (partial
//     pivoting, float64) and the next state's rotation (so3_exp in
//     float64) in every CTA alike: one cluster barrier a round, and no
//     state to publish.
//
// Exactness. Every float32 value is the plain version's bit for bit: each
// operation in its order (built with --fmad=false, IEEE division and
// square root), so3_exp and the in-plane rotation's sin and cos in
// float64, floor(x + 0.5) with XLA's float -> int32 conversion, NaNs and
// ties taken as PyTorch takes them. A division by the Python scalar zfm is
// x * (1/zfm) on the card (PyTorch's CUDA division by a CPU scalar) and a
// division on the CPU (recip_div selects). The float64 sums, 6x6 solves
// and the inverse may differ from cuBLAS's and cuSOLVER's in their last
// float64 bits; their float32 roundings are what the step reads.
//
// Host build: tests/cuda_host_emu.h (TP_HOST_EMU) provides the cluster,
// the barriers and the warp reduction on std::threads.

#include <math.h>
#include <stdint.h>

#ifndef TP_HOST_EMU
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#endif

namespace pl {

constexpr int CLUSTER = 8;         // CTAs per lane
constexpr int NT = 256;            // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int NACC = 28;           // J^T J upper triangle, J^T F, score
constexpr int IF = 21;             // first J^T F entry
constexpr int ISC = 27;            // the score
constexpr int MAXS = 3;            // states of one round
constexpr int NOUT = 63;           // packed float outputs of a lane
constexpr float TAU = 1e-3f;

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
__device__ __forceinline__ void* pose_smem() {
  extern __shared__ double2 pose_smem2[];
  return pose_smem2;
}
// v[0..NACC) summed over the warp by a shuffle tree; lane 0 holds the
// sums.
__device__ __forceinline__ void warp_sum(double* v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < NACC; ++i)
      v[i] += __shfl_down_sync(0xffffffffu, v[i], o);
}
__device__ __forceinline__ void sincos_d(double x, double* s, double* c) {
  sincos(x, s, c);
}
#else
inline void* pose_smem() { return dynamic_smem(); }
inline void warp_sum(double* v) { warp_sum_emu(v, NACC); }
inline void sincos_d(double x, double* s, double* c) {
  *s = sin(x);
  *c = cos(x);
}
#endif

struct Args {
  // inputs, lane-major: [L, 3], [L, K], [L, H, W], [L, K, 8], [L]
  const float* vel;
  const float* w0;
  const uint8_t* valid;
  const float* px;
  const float* py;
  const float* rho;
  const float* s_rho;
  const int* m_num;
  const float* gx;
  const float* gy;
  const float* n_m;
  const int* ikl;
  const float* attrs;
  const float* max_s_rho;
  const int* match_num_min;
  const uint8_t* vote;     // null: every valid slot votes
  int* mid;                // scratch [L, K]: the other m_id_f buffer
  float* out;              // [L, NOUT]
  int* m_id_f;             // [L, K]
  int K, H, W, iter_max, init_iter, init_type, recip_div;
  float zfm, inv_zfm, cx, cy, match_thresh, k, kk;
};

// A state to evaluate: R0 = so3_exp(W), V, and cos, sin of W[2].
struct Pose {
  float R[9];
  float V[3];
  float c, s;
};

struct Smem {
  double warp_part[NWARP][NACC];
  double part[2][MAXS][NACC];  // this CTA's sums, per state (2 rounds)
  double tot[MAXS][NACC];      // the cluster's sums
  Pose desc[MAXS];             // the round's states
  int desc_mid;                // m_id_f buffer the round writes, or -1
  // the LM state, per state (the same in every CTA)
  float X[MAXS][6], Xn[MAXS][6], h[MAXS][6], hn[MAXS][6];
  float JtJ[MAXS][36], JtF[MAXS][6];
  float F[MAXS], F0[MAXS], u[MAXS], v[MAXS];
  int eff[MAXS];
  int mid_cur;               // the buffer holding the accepted matches
  float base_X[6], base_F;
};

__device__ __forceinline__ bool isnan_f(float x) { return x != x; }

__device__ __forceinline__ float divz(const Args& a, float x) {
  return a.recip_div ? x * a.inv_zfm : x / a.zfm;
}

__device__ __forceinline__ double div_d(const Args& a, double x, double c) {
  return a.recip_div ? x * (1.0 / c) : x / c;
}

// floor(x + 0.5) converted as XLA converts: NaN -> 0, saturating.
__device__ __forceinline__ int round_i32(float x) {
  const float t = floorf(x + 0.5f);
  if (isnan_f(t)) return 0;
  if (t >= 2147483648.0f) return 2147483647;
  if (t <= -2147483648.0f) return -2147483647 - 1;
  return (int)t;
}

// core/geometry.so3_exp in float64, rounded once to float32. (The
// single-thread code below unrolls every loop over a small array, so the
// arrays stay in registers.)
__device__ __forceinline__ void so3_exp(const Args& a, const float* wf,
                                        float* R) {
  const double w0 = wf[0], w1 = wf[1], w2 = wf[2];
  const double theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = theta2 < 1e-12;
  const double t2s = small ? 1.0 : theta2;
  const double theta = sqrt(t2s);
  double sn, cs;
  sincos_d(theta, &sn, &cs);
  const double A = small ? 1.0 - div_d(a, theta2, 6.0) : sn / theta;
  const double B = small ? 0.5 - div_d(a, theta2, 24.0) : (1.0 - cs) / t2s;
  const double K[9] = {0.0, -w2, w1, w2, 0.0, -w0, -w1, w0, 0.0};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const double kk = K[i * 3] * K[j] + K[i * 3 + 1] * K[3 + j] +
                        K[i * 3 + 2] * K[6 + j];
      const double e = i == j ? 1.0 : 0.0;
      R[i * 3 + j] = (float)(e + A * K[i * 3 + j] + B * kk);
    }
}

__device__ void make_pose(const Args& a, const float* X, Pose* P) {
  so3_exp(a, X + 3, P->R);
  for (int i = 0; i < 3; ++i) P->V[i] = X[i];
  double sn, cs;
  sincos_d((double)X[5], &sn, &cs);
  P->c = (float)cs;
  P->s = (float)sn;
}

// LU with partial pivoting of a 6x6 float64 matrix, LAPACK's getf2 (the
// first largest pivot; a zero pivot left as it is, so a singular system
// solves to non-finite values), and the solve of A x = b in place.
// Row swaps by comparison with the pivot's index, never by indexing with
// it, so that the arrays stay in registers.
__device__ __forceinline__ void lu6(double* A, int* piv) {
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    int p = j;
    double best = fabs(A[j * 6 + j]);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      const double m = fabs(A[i * 6 + j]);
      if (m > best) {
        best = m;
        p = i;
      }
    }
    piv[j] = p;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      if (i == p) {
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const double t = A[j * 6 + c];
          A[j * 6 + c] = A[i * 6 + c];
          A[i * 6 + c] = t;
        }
      }
    }
    const double d = A[j * 6 + j];
    if (d != 0.0) {
#pragma unroll
      for (int i = j + 1; i < 6; ++i) A[i * 6 + j] /= d;
    }
#pragma unroll
    for (int i = j + 1; i < 6; ++i)
#pragma unroll
      for (int c = j + 1; c < 6; ++c)
        A[i * 6 + c] -= A[i * 6 + j] * A[j * 6 + c];
  }
}

__device__ __forceinline__ void lu6_solve(const double* A, const int* piv,
                                          double* b) {
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      if (piv[j] == i) {
        const double t = b[j];
        b[j] = b[i];
        b[i] = t;
      }
    }
  }
#pragma unroll
  for (int i = 1; i < 6; ++i)
#pragma unroll
    for (int m = 0; m < i; ++m) b[i] -= A[i * 6 + m] * b[m];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
#pragma unroll
    for (int m = i + 1; m < 6; ++m) b[i] -= A[i * 6 + m] * b[m];
    b[i] /= A[i * 6 + i];
  }
}

// Per-lane views of the inputs.
struct Lane {
  const uint8_t* valid;
  const float *px, *py, *rho, *s_rho, *gx, *gy, *n_m, *attrs;
  const int *m_num, *ikl;
  const uint8_t* vote;
  int* mid[2];
  float max_s_rho;
  int mnm;
};

// A thread's live slots, in shared memory after the Smem struct: entry
// m of thread t at [m * NT + t] of each array, up to `cap` a thread. A
// slot is live unless the map gates it (depth spread, match count,
// invalid), which no state changes; its entry keeps the terms that do not
// depend on the state: the slot (bitwise negated if it does not vote),
// the back-projection X0, Y0, Z0, the gradient, n_m^2 and q.
struct Slots {
  int* k;
  float *X0, *Y0, *Z0, *gx, *gy, *n2, *q;
};

__host__ __device__ constexpr size_t smem_head() {
  return (sizeof(Smem) + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t smem_bytes(int cap) {
  return smem_head() + (size_t)8 * 4 * NT * cap;
}

__device__ __forceinline__ Slots slots(Smem& s, int cap) {
  float* b = reinterpret_cast<float*>(reinterpret_cast<char*>(&s) +
                                      smem_head());
  const int n = NT * cap;
  return Slots{reinterpret_cast<int*>(b), b + n,     b + 2 * n, b + 3 * n,
               b + 4 * n,                 b + 5 * n, b + 6 * n, b + 7 * n};
}

// This thread's slots (k = g, g + G, ...) into its entries; a gated
// slot's match is -1 in both m_id_f buffers. Returns the live count.
__device__ int build_slots(const Args& a, const Lane& ln, const Slots& e,
                           int g, int G) {
  const int tid = threadIdx.x;
  int n = 0;
  for (int k = g; k < a.K; k += G) {
    if (ln.s_rho[k] > ln.max_s_rho || ln.m_num[k] < ln.mnm ||
        ln.valid[k] == 0) {
      ln.mid[0][k] = -1;
      ln.mid[1][k] = -1;
      continue;
    }
    const int i = n * NT + tid;
    const float Z0 = 1.0f / ln.rho[k];
    e.k[i] = (!ln.vote || ln.vote[k] != 0) ? k : ~k;
    e.X0[i] = divz(a, ln.px[k] * Z0);
    e.Y0[i] = divz(a, ln.py[k] * Z0);
    e.Z0[i] = Z0;
    e.gx[i] = ln.gx[k];
    e.gy[i] = ln.gy[k];
    e.n2[i] = ln.n_m[k] * ln.n_m[k];
    ++n;
  }
  return n;
}

// One evaluation of try_vel_rot at P over this thread's `n` live slots.
// `q_round`: the evaluation at the prior, which sets q and accumulates
// nothing; else J^T J, J^T F and the score are added to acc, and the
// forward matches written to `mid` unless it is null (a gated slot adds
// exact zeros, and its match is -1 at every state). The slots go in
// pairs, each stage's loads of a pair issued before either is used (the
// field image, then the matched keyline's row).
constexpr int NB = 2;

__device__ __forceinline__ void eval_state(const Args& a, const Lane& ln,
                                           const Slots& e, int n,
                                           const Pose P, bool q_round,
                                           int* mid, double* acc) {
  const int tid = threadIdx.x;
  for (int m0 = 0; m0 < n; m0 += NB) {
    bool on[NB], oob[NB];
    int j[NB];
    float ptx[NB], pty[NB], ptz[NB], rho_p[NB], qx[NB], qy[NB], pix[NB],
        piy[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      on[b] = m0 + b < n;
      if (!on[b]) continue;
      const int i = (m0 + b) * NT + tid;
      const float X0 = e.X0[i], Y0 = e.Y0[i], Z0 = e.Z0[i];
      ptx[b] = P.R[0] * X0 + P.R[1] * Y0 + P.R[2] * Z0 + P.V[0];
      pty[b] = P.R[3] * X0 + P.R[4] * Y0 + P.R[5] * Z0 + P.V[1];
      ptz[b] = P.R[6] * X0 + P.R[7] * Y0 + P.R[8] * Z0 + P.V[2];
      rho_p[b] = 1.0f / ptz[b];
      qx[b] = ptx[b] * a.zfm * rho_p[b];
      qy[b] = pty[b] * a.zfm * rho_p[b];
      pix[b] = qx[b] + a.cx;
      piy[b] = qy[b] + a.cy;
      const int xr = round_i32(pix[b]);
      const int yr = round_i32(piy[b]);
      oob[b] = xr < 1 || yr < 1 || xr >= a.W - 1 || yr >= a.H - 1;
      j[b] = ln.ikl[min(max(yr, 0), a.H - 1) * a.W +
                    min(max(xr, 0), a.W - 1)];
    }
    float fa[NB][6];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (!on[b]) continue;
      const float* row = ln.attrs + 8 * (size_t)max(j[b], 0);
#pragma unroll
      for (int c = 0; c < 6; ++c) fa[b][c] = row[c];
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (!on[b]) continue;
      const int i = (m0 + b) * NT + tid;
      const float gx = e.gx[i], gy = e.gy[i], p_n2 = e.n2[i];
      const float gmx = P.c * gx - P.s * gy;
      const float gmy = P.s * gx + P.c * gy;
      const float p_esc = gmx * fa[b][4] + gmy * fa[b][5];
      const bool grad_fail = fabsf(p_esc - p_n2) > a.match_thresh * p_n2;
      const float dx = pix[b] - fa[b][0];
      const float dy = piy[b] - fa[b][1];
      const float fux = fa[b][2], fuy = fa[b][3];
      const float fi = dx * fux + dy * fuy;
      const bool matched = !oob[b] && j[b] >= 0 && !grad_fail;
      const float dfx = matched ? fux : 0.0f;
      const float dfy = matched ? fuy : 0.0f;
      const float ctq = qx[b] * dfx + qy[b] * dfy;
      const int ke = e.k[i];
      const int k = ke >= 0 ? ke : ~ke;
      if (q_round) {
        const float sr = ln.s_rho[k];
        const float s_shape = isnan_f(sr) ? sr : fminf(sr, 1.0f);
        const float qvel = a.zfm * dfx * P.V[0] + a.zfm * dfy * P.V[1] +
                           ctq * P.V[2];
        const float t = s_shape * qvel;
        e.q[i] = sqrtf(t * t + 1.0f);
        continue;
      }
      const float inv_q = 1.0f / e.q[i];
      const float r = matched ? fi * inv_q : 0.0f;
      const float rr = r * r;
      const bool voter = ke >= 0;
      if (voter)
        acc[ISC] += (double)(matched ? (isnan_f(rr) ? rr : fminf(rr, a.kk))
                                     : a.kk);
      if (mid) mid[k] = matched ? j[b] : -1;
      if (!(voter && matched)) continue;
      const float w = fabsf(r) <= a.k ? 1.0f : 0.0f;
      const float aa = rho_p[b] * a.zfm * dfx;
      const float bb = rho_p[b] * a.zfm * dfy;
      const float ct = rho_p[b] * ctq;
      const float sw = sqrtf(w) * inv_q;
      const float J[6] = {aa * sw,
                          bb * sw,
                          -ct * sw,
                          (-bb * ptz[b] - ct * pty[b]) * sw,
                          (aa * ptz[b] + ct * ptx[b]) * sw,
                          (-aa * pty[b] + bb * ptx[b]) * sw};
      const double fw = (double)(r * sqrtf(w));
      int c = 0;
#pragma unroll
      for (int u = 0; u < 6; ++u) {
        const double ju = J[u];
#pragma unroll
        for (int v = u; v < 6; ++v) acc[c++] += ju * (double)J[v];
        acc[IF + u] += ju * fw;
      }
    }
  }
}

// The round's states (s.desc) evaluated over the cluster: each CTA sums
// its slots' terms (warps by shuffles, then the warps in order) into
// part[parity]; after the barrier every CTA adds the CTAs' sums in rank
// order into `tot`, so every CTA holds the same totals. The q round
// accumulates nothing and needs no barrier. `part` alternates between
// rounds: a CTA writes part[parity] again two rounds later, after a
// barrier that every CTA passes only once it has read it.
__device__ void eval_round(const Args& a, const Lane& ln, const Slots& e,
                           int n, Smem& s, int S, bool q_round, int parity) {
  const int tid = threadIdx.x;
  const int m = s.desc_mid;
  for (int st = 0; st < S; ++st) {
    double acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0;
    eval_state(a, ln, e, n, s.desc[st], q_round,
               m < 0 ? nullptr : ln.mid[m], acc);
    if (q_round) continue;
    warp_sum(acc);
    if (tid % 32 == 0) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) s.warp_part[tid / 32][i] = acc[i];
    }
    __syncthreads();
    if (tid < NACC) {
      double t = 0.0;
      for (int w = 0; w < NWARP; ++w) t += s.warp_part[w][tid];
      s.part[parity][st][tid] = t;
    }
    __syncthreads();
  }
  if (q_round) {
    __syncthreads();   // before s.desc is written again
    return;
  }
  cluster_sync();
  for (int i = tid; i < S * NACC; i += NT) {
    double v[CLUSTER];
#pragma unroll
    for (unsigned r = 0; r < CLUSTER; ++r)
      v[r] = cluster_map(&s.part[parity][0][0], r)[i];
    double t = 0.0;
#pragma unroll
    for (unsigned r = 0; r < CLUSTER; ++r) t += v[r];
    s.tot[i / NACC][i % NACC] = t;
  }
  __syncthreads();
}

// The thread of state st: the system (J^T J + u I) h = -J^T F and the
// candidate Xn = X + h, the next state to evaluate.
__device__ void propose(const Args& a, Smem& s, int st) {
  double A[36], b[6];
  int piv[6];
  const float u = s.u[st];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j)
      A[i * 6 + j] = (double)(s.JtJ[st][i * 6 + j] + u * (i == j ? 1.0f : 0.0f));
    b[i] = (double)(-s.JtF[st][i]);
  }
  lu6(A, piv);
  lu6_solve(A, piv, b);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    s.hn[st][i] = (float)b[i];
    s.Xn[st][i] = s.X[st][i] + s.hn[st][i];
  }
  make_pose(a, s.Xn[st], &s.desc[st]);
}

__device__ void take_sums(Smem& s, int st) {
  int n = 0;
  for (int i = 0; i < 6; ++i) {
    for (int m = i; m < 6; ++m) {
      const float v = (float)s.tot[st][n++];
      s.JtJ[st][i * 6 + m] = v;
      s.JtJ[st][m * 6 + i] = v;
    }
    s.JtF[st][i] = (float)s.tot[st][IF + i];
  }
}

// One LM run over S states from s.X (minimizer's _lm_phase). Every CTA
// runs the bookkeeping on the same totals and so holds the same state;
// `main`: the run whose matches are the result, its evaluations writing
// m_id_f, the accepted state's buffer in s.mid_cur.
__device__ void lm_run(const Args& a, const Lane& ln, const Slots& e, int n,
                       Smem& s, int S, int n_iter, bool main, int* parity) {
  const int tid = threadIdx.x;
  if (tid < S) make_pose(a, s.X[tid], &s.desc[tid]);
  if (tid == 0) {
    s.mid_cur = 0;
    s.desc_mid = main ? 0 : -1;
  }
  __syncthreads();
  eval_round(a, ln, e, n, s, S, false, *parity);
  *parity ^= 1;
  if (tid < S) {
    const int st = tid;
    take_sums(s, st);
    s.F[st] = (float)s.tot[st][ISC];
    s.F0[st] = s.F[st];
    float m = s.JtJ[st][0];
    for (int i = 1; i < 36; ++i) {
      const float x = s.JtJ[st][i];
      m = isnan_f(m) ? m : (isnan_f(x) ? x : fmaxf(m, x));
    }
    s.u[st] = m * TAU;
    s.v[st] = 2.0f;
    s.eff[st] = 0;
    for (int i = 0; i < 6; ++i) s.h[st][i] = 0.0f;
    if (n_iter > 0) propose(a, s, st);
  }
  if (tid == 0) s.desc_mid = main ? 1 : -1;
  __syncthreads();
  for (int it = 0; it < n_iter; ++it) {
    eval_round(a, ln, e, n, s, S, false, *parity);
    *parity ^= 1;
    if (tid < S) {
      const int st = tid;
      const float Fn = (float)s.tot[st][ISC];
      double ps = 0.0;
      for (int i = 0; i < 6; ++i) {
        const float t = s.u[st] * s.hn[st][i] - s.JtF[st][i];
        ps += (double)(s.hn[st][i] * t);
      }
      const float pred = (float)ps * 0.5f;
      const float gain = (s.F[st] - Fn) / pred;
      const bool acc = gain > 0.0f;
      if (acc) {
        for (int i = 0; i < 6; ++i) {
          s.X[st][i] = s.Xn[st][i];
          s.h[st][i] = s.hn[st][i];
        }
        s.F[st] = Fn;
        take_sums(s, st);
        const float g2 = gain * 2.0f - 1.0f;
        const float fac = 1.0f - g2 * g2 * g2;
        s.u[st] = s.u[st] * (isnan_f(fac) ? fac : fmaxf(fac, 0.33f));
        s.v[st] = 2.0f;
        s.eff[st] += 1;
        if (main) s.mid_cur = 1 - s.mid_cur;
      } else {
        s.u[st] = s.u[st] * s.v[st];
        s.v[st] = s.v[st] * 2.0f;
      }
      if (it + 1 < n_iter) propose(a, s, st);
    }
    __syncthreads();
    if (tid == 0) s.desc_mid = main ? 1 - s.mid_cur : -1;
    __syncthreads();
  }
}

// torch.argmin's order: the first NaN, else the first least.
__device__ int argmin_nan(const float* F, int n) {
  int b = 0;
  for (int i = 1; i < n; ++i)
    if (!isnan_f(F[b]) && (isnan_f(F[i]) || F[i] < F[b])) b = i;
  return b;
}

__device__ float norm6(const float* x) {
  double t = 0.0;
  for (int i = 0; i < 6; ++i) t += (double)x[i] * (double)x[i];
  return (float)sqrt(t);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT)
    pose_lm_kernel(const Args a) {
  Smem& s = *reinterpret_cast<Smem*>(pose_smem());
  const unsigned rank = cluster_rank();
  const int tid = threadIdx.x;
  const int lane = blockIdx.x / CLUSTER;
  const size_t lk = (size_t)lane * a.K;
  Lane ln;
  ln.valid = a.valid + lk;
  ln.px = a.px + lk;
  ln.py = a.py + lk;
  ln.rho = a.rho + lk;
  ln.s_rho = a.s_rho + lk;
  ln.gx = a.gx + lk;
  ln.gy = a.gy + lk;
  ln.n_m = a.n_m + lk;
  ln.m_num = a.m_num + lk;
  ln.attrs = a.attrs + 8 * lk;
  ln.ikl = a.ikl + (size_t)lane * a.H * a.W;
  ln.vote = a.vote ? a.vote + lk : nullptr;
  ln.mid[0] = a.m_id_f + lk;
  ln.mid[1] = a.mid + lk;
  ln.max_s_rho = a.max_s_rho[lane];
  ln.mnm = a.match_num_min[lane];
  float prior[6];
  for (int i = 0; i < 3; ++i) {
    prior[i] = a.vel[lane * 3 + i];
    prior[3 + i] = a.w0[lane * 3 + i];
  }

  const int g = rank * NT + tid;
  const int G = CLUSTER * NT;
  const Slots e = slots(s, (a.K + G - 1) / G);
  const int n = build_slots(a, ln, e, g, G);

  // the noise shaping, frozen at the prior
  if (tid == 0) {
    make_pose(a, prior, &s.desc[0]);
    s.desc_mid = -1;
  }
  __syncthreads();
  eval_round(a, ln, e, n, s, 1, true, 0);

  int parity = 0;
  if (a.init_type != 0 && a.init_type != 1) {
    // warm start: the zero and prior starts, then the velocity ladder
    if (tid < 2)
      for (int i = 0; i < 6; ++i) s.X[tid][i] = tid == 0 ? 0.0f : prior[i];
    lm_run(a, ln, e, n, s, 2, a.init_iter, false, &parity);
    if (tid == 0) {
      const int b = s.F[1] <= s.F[0] ? 1 : 0;
      for (int i = 0; i < 6; ++i) s.base_X[i] = s.X[b][i];
      s.base_F = s.F[b];
    }
    __syncthreads();
    if (tid < 3) {
      const float sc = tid == 0 ? 2.0f : (tid == 1 ? 4.0f : 8.0f);
      for (int i = 0; i < 6; ++i)
        s.X[tid][i] = i < 3 ? s.base_X[i] * sc : s.base_X[i];
    }
    lm_run(a, ln, e, n, s, 3, a.init_iter, false, &parity);
    if (tid == 0) {
      const int b = argmin_nan(s.F, 3);
      const bool take = s.F[b] < 0.98f * s.base_F;
      for (int i = 0; i < 6; ++i) s.X[0][i] = take ? s.X[b][i] : s.base_X[i];
    }
    __syncthreads();
  } else if (tid == 0) {
    for (int i = 0; i < 6; ++i)
      s.X[0][i] = a.init_type == 0 ? 0.0f : prior[i];
  }
  lm_run(a, ln, e, n, s, 1, a.iter_max, true, &parity);

  if (rank == 0 && tid == 0) {
    double A[36];
    int piv[6];
#pragma unroll
    for (int i = 0; i < 36; ++i) A[i] = (double)s.JtJ[0][i];
    lu6(A, piv);
    float inv[36];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      double e[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      e[c] = 1.0;
      lu6_solve(A, piv, e);
#pragma unroll
      for (int i = 0; i < 6; ++i) inv[i * 6 + c] = (float)e[i];
    }
    float* o = a.out + (size_t)lane * NOUT;
    for (int i = 0; i < 6; ++i) o[i] = s.X[0][i];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        o[6 + i * 3 + j] = inv[i * 6 + j];
        o[15 + i * 3 + j] = inv[(3 + i) * 6 + 3 + j];
      }
    for (int i = 0; i < 36; ++i) o[24 + i] = s.JtJ[0][i];
    const bool any_eff = s.eff[0] > 0;
    const float F = s.F[0], F0 = s.F0[0];
    o[60] = F;
    o[61] = any_eff ? norm6(s.h[0]) / (norm6(s.X[0]) + 1e-30f) : 1e20f;
    o[62] = any_eff ? F / (F0 > 0.0f ? F0 : 1.0f) : 1e20f;
  }
  // the accepted matches into the output, if the scratch holds them
  if (s.mid_cur == 1)
    for (int k = g; k < a.K; k += G) ln.mid[0][k] = ln.mid[1][k];
  // a CTA's shared memory stays until every CTA has read its sums
  cluster_sync();
}

}  // namespace pl

namespace pl {
constexpr size_t MAX_SMEM = 232448;   // a block's shared memory on sm_90

// Slots a thread holds at K slots a lane.
constexpr int cap_of(int K) { return (K + CLUSTER * NT - 1) / (CLUSTER * NT); }

#ifndef TP_HOST_EMU
// Grants the kernel its dynamic shared memory at K slots a lane, on the
// current device, once for the largest K seen: the first launch (eager,
// before any CUDA graph captures one) sets it, and no launch under
// capture calls into the runtime for it.
inline cudaError_t grant_smem(int K) {
  static int granted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  const int bytes = (int)smem_bytes(cap_of(K));
  if (bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(pose_lm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) granted[dev] = bytes;
  return err;
}
#endif
}  // namespace pl

// Shared bytes and threads of a CTA at K slots a lane, CTAs of a lane's
// cluster, and the packed outputs of a lane.
extern "C" void pose_lm_launch_config(int K, int* smem_bytes, int* threads,
                                      int* cluster, int* n_out) {
  *smem_bytes = (int)pl::smem_bytes(pl::cap_of(K));
  *threads = pl::NT;
  *cluster = pl::CLUSTER;
  *n_out = pl::NOUT;
}

#ifndef TP_HOST_EMU
// Clusters of the kernel that can be resident at once on the card at K
// slots a lane.
extern "C" int pose_lm_max_clusters(int K, int* n) {
  const cudaError_t err = pl::grant_smem(K);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl::CLUSTER);
  cfg.blockDim = dim3(pl::NT);
  cfg.dynamicSmemBytes = pl::smem_bytes(pl::cap_of(K));
  return (int)cudaOccupancyMaxActiveClusters(n, (void*)pl::pose_lm_kernel,
                                             &cfg);
}
#endif

// Launches the solver over L lanes (one cluster each). Inputs are
// contiguous and lane-major; `vote` may be null. cudaErrorInvalidValue
// for sizes the kernel does not take (K up to MAX_SMEM's worth of slots,
// 55,296 at NT = 256).
extern "C" int pose_lm_launch(
    const float* vel, const float* w0, const uint8_t* valid, const float* px,
    const float* py, const float* rho, const float* s_rho, const int* m_num,
    const float* gx, const float* gy, const float* n_m, const int* ikl,
    const float* attrs, const float* max_s_rho, const int* match_num_min,
    const uint8_t* vote, int* mid, float* out, int* m_id_f, int L, int K,
    int H, int W, int iter_max, int init_iter, int init_type, int recip_div,
    float zfm, float inv_zfm, float cx, float cy, float match_thresh,
    float k, float kk, void* stream) {
  if (L < 1 || K < 1 || H < 3 || W < 3 || iter_max < 0 || init_iter < 0 ||
      (long long)L * pl::CLUSTER > 2147483647LL ||
      pl::smem_bytes(pl::cap_of(K)) > pl::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const pl::Args a{vel, w0, valid, px, py, rho, s_rho, m_num, gx, gy, n_m,
                   ikl, attrs, max_s_rho, match_num_min, vote, mid, out,
                   m_id_f, K, H, W, iter_max, init_iter, init_type,
                   recip_div, zfm, inv_zfm, cx, cy, match_thresh, k, kk};
  const dim3 grid(L * pl::CLUSTER);
  const dim3 block(pl::NT);
  const size_t smem = pl::smem_bytes(pl::cap_of(K));
  cudaStream_t st = (cudaStream_t)stream;
#ifdef TP_HOST_EMU
  return (int)launch_cluster_kernel(pl::pose_lm_kernel, grid, block,
                                    pl::CLUSTER, smem, st, a);
#else
  const cudaError_t err = pl::grant_smem(K);
  if (err != cudaSuccess) return (int)err;
  pl::pose_lm_kernel<<<grid, block, smem, st>>>(a);
  return (int)cudaGetLastError();
#endif
}
