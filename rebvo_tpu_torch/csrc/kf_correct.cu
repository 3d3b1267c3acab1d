// The keyframe tracker's per-frame maintenance for Hopper (sm_90a):
// correct_and_augment's K-wide body in one launch per frame and lane.
//
// Replaces no TPU kernel: the JAX package leaves the block
// (rebvo_tpu/frontend/kf_tracking.py: chain_correct, augment_matches,
// invert_matches, build_forward_match) to XLA. Its PyTorch form
// (frontend/kf_tracking._body_plain) launches ~1,870 small kernels a
// frame on the card, each over the K keyline slots. This kernel runs all
// of it, both directions at once, given the per-frame scalars the wrapper
// computes (the two essential matrices and the two baseline tests):
//   * backward (frame keylines -> keyframe map): from the frame map's
//     unmasked m_id_kf, chain_correct (chain_steps steps along the
//     keyframe map's chains), augment_matches (aug_iters rounds of the p
//     then the n link of the frame map), chain_correct again, the distance
//     and validity prune; the baseline test picks that or the masked
//     m_id_kf; back_m counts the matches;
//   * forward (keyframe keylines -> frame map): invert_matches of the
//     frame map's m_id (the highest new index wins), build_forward_match
//     through the keyframe's m_id_f, then the same walk, augment, walk and
//     prune against the frame map; fow_m counts.
//
// Bound. The two maps are read once and the two id arrays written once:
// the frame map's px, py, p_id, n_id, m_id_kf, m_id (4 B each) and valid
// (1 B), the keyframe map's px, py, p_id, n_id, m_id_f and valid, and
// m_f, m_kf: 54 B a slot, 884,736 B a lane at K = 16384, 0.264 us at
// 3.35 TB/s. What bounds the kernel is latency: a walk is 1 + chain_steps
// dependent rounds of gathers from the target map (13 at the defaults),
// two walks a direction, and the augmentation is 2 aug_iters passes that
// each read the whole id array from before the pass (8), each behind a
// cluster barrier. So the design keeps a round short:
//   * one cluster of CLUSTER CTAs per lane and direction (2 L clusters),
//     slot k owned by CTA k / chunk, chunk = ceil(K / CLUSTER); a CTA's
//     threads hold its slots in turn (coalesced), and walk up to G slots
//     at once: a step's 8 gathers of every slot (px, py, p_id, n_id of the
//     next and the previous keyline) are in flight together, and the
//     moved-to keyline's links come with its coordinates, so a step is
//     one round;
//   * the direction's id array lives in the CTAs' shared memory, two
//     buffers of chunk ints: an augment pass reads the array from before
//     the pass (any CTA's, over distributed shared memory) and writes the
//     other, with one cluster barrier between passes;
//   * the inversion is an atomicMax into the owner CTA's shared memory;
//   * the counts: a shared atomicAdd per thread, then rank 0 adds the
//     CTAs' counts in rank order.
// A direction whose baseline test fails returns its unwalked ids, and
// skips the walks and the augmentation (their result is not selected).
// The layout (CLUSTER 8, NT 512, G 2, two CTAs an SM) was the fastest of
// six measured on an H100 at K = 16384, at one lane and at 16: 30 of its
// clusters are resident at once, so 16 lanes (32 clusters) leave two for
// a second round, and still beat 4-CTA clusters, of which all 32 fit.
//
// Exactness. The ids and counts are the plain body's: the epipolar
// distance is computed operation by operation as _epipolar_dist does,
// each product, sum, the square root and the divisions rounded to float32
// on their own (built with --fmad=false, IEEE division and square root),
// a Python float (zfm, dist_thresh, 1e-12) rounded to float32 where it
// meets a float32 tensor, BIG_D for j < 0 or n < 1e-12, and the walk's
// tests as written (go_n = dn < d0 && dn <= dp, go_p = dp < d0 && dp <
// dn; NaN compares false). A walked keyline's distance is carried, not
// recomputed: dist(j) depends on j alone. Ids outside [-1, K) are not
// taken (the plain body raises on them); the kernel reads slot K - 1.
//
// Host build: tests/cuda_host_emu.h (TP_HOST_EMU) provides the cluster,
// its barrier, each other's shared memory and the atomics on
// std::threads.

#include <math.h>
#include <stdint.h>

#ifndef TP_HOST_EMU
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#endif

namespace kc {

constexpr int CLUSTER = 8;        // CTAs per lane and direction
constexpr int NT = 512;           // threads per CTA
constexpr int G = 2;              // slots a thread walks at once
constexpr float BIG_D = 1e9f;
constexpr float TINY = 1e-12f;    // n below it: no epipolar line
constexpr size_t MAX_SMEM = 48 * 1024;   // no opt-in: capture-safe

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
__device__ __forceinline__ int* kc_smem() {
  extern __shared__ int4 kc_smem4[];
  return reinterpret_cast<int*>(kc_smem4);
}
template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldg(p); }
#else
inline int* kc_smem() { return reinterpret_cast<int*>(dynamic_smem()); }
template <typename T>
inline T ld(const T* p) { return *p; }
#endif

struct Args {
  // per lane: E_b, E_f [L, 9]; strong_b, strong_f [L]
  const float* E_b;
  const float* E_f;
  const uint8_t* strong_b;
  const uint8_t* strong_f;
  // the frame map [L, K]
  const float* px;
  const float* py;
  const int* p_id;
  const int* n_id;
  const uint8_t* valid;
  const int* m_id_kf;
  const int* m_id;
  // the keyframe map [L, K]
  const float* kf_px;
  const float* kf_py;
  const int* kf_p_id;
  const int* kf_n_id;
  const uint8_t* kf_valid;
  const int* kf_m_id_f;
  // outputs: m_f, m_kf [L, K]; counts [L, 2] (fow_m, back_m)
  int* m_f;
  int* m_kf;
  int* counts;
  int K, chain_steps, aug_iters;
  float zfm, dist_thresh;
};

// One direction of one lane: the query map (whose slots are walked and
// augmented), the target map (whose chains the walk follows), E.
struct Dir {
  const float* qx;
  const float* qy;
  const int* q_pid;
  const int* q_nid;
  const uint8_t* q_valid;
  const float* tx;
  const float* ty;
  const int* t_pid;
  const int* t_nid;
  float E[9];
};

// A query slot's epipolar line (r0, r1, r2), or none (bad).
struct Line {
  float r0, r1, r2;
  bool bad;
};

__device__ __forceinline__ Line line_of(const Dir& d, float qx, float qy,
                                        float zfm) {
  const float* E = d.E;
  const float ex = (E[0] * qx + E[1] * qy) + E[2] * zfm;
  const float ey = (E[3] * qx + E[4] * qy) + E[5] * zfm;
  const float ez = (E[6] * qx + E[7] * qy) + E[8] * zfm;
  float n = sqrtf(ex * ex + ey * ey);
  Line l;
  l.bad = n < TINY;
  if (l.bad) n = 1.0f;
  l.r0 = ex / n;
  l.r1 = ey / n;
  l.r2 = ez * zfm / n;
  return l;
}

__device__ __forceinline__ float dist_of(const Line& l, int j, float x,
                                         float y) {
  if (j < 0 || l.bad) return BIG_D;
  return fabsf((x * l.r0 + y * l.r1) + l.r2);
}

// A target keyline's coordinates and links (j < 0: none).
struct Entry {
  float x, y;
  int p, n;
};

__device__ __forceinline__ Entry entry(const Dir& d, int j, int K) {
  Entry e{0.0f, 0.0f, -1, -1};
  if (j >= 0) {
    const int s = j < K ? j : K - 1;
    e.x = ld(d.tx + s);
    e.y = ld(d.ty + s);
    e.p = ld(d.t_pid + s);
    e.n = ld(d.t_nid + s);
  }
  return e;
}

// chain_correct of up to G slots (idx[u] < 0: none) from ids m[u]: the
// ids after `steps` steps and their distances.
__device__ __forceinline__ void walk(const Dir& d, const int* idx, int* m,
                                     float* dist, int steps, int K,
                                     float zfm) {
  Line l[G];
  Entry cur[G];
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int i = idx[u] < 0 ? 0 : idx[u];
    l[u] = line_of(d, ld(d.qx + i), ld(d.qy + i), zfm);
    cur[u] = entry(d, idx[u] < 0 ? -1 : m[u], K);
  }
#pragma unroll
  for (int u = 0; u < G; ++u) dist[u] = dist_of(l[u], m[u], cur[u].x,
                                                cur[u].y);
  for (int s = 0; s < steps; ++s) {
    Entry en[G], ep[G];
    int nn[G], pp[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const bool on = idx[u] >= 0 && m[u] >= 0;
      nn[u] = on ? cur[u].n : -1;
      pp[u] = on ? cur[u].p : -1;
      en[u] = entry(d, nn[u], K);
      ep[u] = entry(d, pp[u], K);
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const float d0 = dist[u];
      const float dn = dist_of(l[u], nn[u], en[u].x, en[u].y);
      const float dp = dist_of(l[u], pp[u], ep[u].x, ep[u].y);
      const bool go_n = (dn < d0) && (dn <= dp);
      const bool go_p = (dp < d0) && (dp < dn);
      if (go_n) {
        m[u] = nn[u];
        dist[u] = dn;
        cur[u] = en[u];
      } else if (go_p) {
        m[u] = pp[u];
        dist[u] = dp;
        cur[u] = ep[u];
      }
    }
  }
}

// The id held for slot s of the direction, in the CTA of its owner.
__device__ __forceinline__ int* owner(int* buf, int s, int chunk) {
  return cluster_map(buf + s % chunk, (unsigned)(s / chunk));
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT, 2)
    kf_correct_kernel(const Args a) {
  const int K = a.K;
  const int chunk = (K + CLUSTER - 1) / CLUSTER;
  int* smem = kc_smem();
  int* cnt = smem;                 // this CTA's count
  int* buf0 = smem + 4;            // the two id buffers, chunk ints each
  int* buf1 = buf0 + chunk;
  const unsigned rank = cluster_rank();
  const int tid = threadIdx.x;
  const int c = blockIdx.x / CLUSTER;
  const int lane = c >> 1;
  const bool fwd = (c & 1) == 0;
  const size_t lk = (size_t)lane * K;
  const int lo = (int)rank * chunk;
  const int hi = min(K, lo + chunk);

  Dir d;
  const float* E = (fwd ? a.E_f : a.E_b) + (size_t)lane * 9;
  for (int i = 0; i < 9; ++i) d.E[i] = E[i];
  if (fwd) {
    d.qx = a.kf_px + lk;
    d.qy = a.kf_py + lk;
    d.q_pid = a.kf_p_id + lk;
    d.q_nid = a.kf_n_id + lk;
    d.q_valid = a.kf_valid + lk;
    d.tx = a.px + lk;
    d.ty = a.py + lk;
    d.t_pid = a.p_id + lk;
    d.t_nid = a.n_id + lk;
  } else {
    d.qx = a.px + lk;
    d.qy = a.py + lk;
    d.q_pid = a.p_id + lk;
    d.q_nid = a.n_id + lk;
    d.q_valid = a.valid + lk;
    d.tx = a.kf_px + lk;
    d.ty = a.kf_py + lk;
    d.t_pid = a.kf_p_id + lk;
    d.t_nid = a.kf_n_id + lk;
  }
  const bool strong = (fwd ? a.strong_f : a.strong_b)[lane] != 0;
  int* out = (fwd ? a.m_f : a.m_kf) + lk;
  if (tid == 0) *cnt = 0;

  // the start ids, into buf0: backward the unmasked m_id_kf; forward
  // build_forward_match through the inverted m_id (in buf1)
  if (fwd) {
    for (int s = lo + tid; s < hi; s += NT) buf1[s - lo] = -1;
    cluster_sync();
    const int* mid = a.m_id + lk;
    const uint8_t* valid = a.valid + lk;
    for (int j = lo + tid; j < hi; j += NT) {
      const int o = ld(mid + j);
      if (o >= 0 && o < K && ld(valid + j)) atomicMax(owner(buf1, o, chunk), j);
    }
    cluster_sync();
    const int* mf = a.kf_m_id_f + lk;
    for (int s = lo + tid; s < hi; s += NT) {
      const int o = ld(mf + s);
      buf0[s - lo] = o >= 0 && ld(d.q_valid + s)
                         ? *owner(buf1, o < K ? o : K - 1, chunk)
                         : -1;
    }
  } else {
    const int* mkf = a.m_id_kf + lk;
    for (int s = lo + tid; s < hi; s += NT) buf0[s - lo] = ld(mkf + s);
  }

  int n = 0;
  if (!strong) {
    // the unwalked ids: forward the built matches, backward the masked
    // m_id_kf
    for (int s = lo + tid; s < hi; s += NT) {
      int m = buf0[s - lo];
      if (!fwd && !ld(d.q_valid + s)) m = -1;
      out[s] = m;
      n += m >= 0;
    }
  } else {
    // first walk, buf0 -> buf0
    for (int s0 = lo + tid; s0 < hi; s0 += G * NT) {
      int idx[G], m[G];
      float dist[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int s = s0 + u * NT;
        idx[u] = s < hi ? s : -1;
        m[u] = s < hi ? buf0[s - lo] : -1;
      }
      walk(d, idx, m, dist, a.chain_steps, K, a.zfm);
#pragma unroll
      for (int u = 0; u < G; ++u)
        if (idx[u] >= 0) buf0[idx[u] - lo] = m[u];
    }
    // augmentation: each pass reads the array from before it
    int* src = buf0;
    int* dst = buf1;
    for (int it = 0; it < 2 * a.aug_iters; ++it) {
      cluster_sync();
      const int* link = (it & 1) ? d.q_nid : d.q_pid;
      for (int s = lo + tid; s < hi; s += NT) {
        int m = src[s - lo];
        if (m < 0) {
          const int l = ld(link + s);
          if (l >= 0) {
            const int cand = *owner(src, l < K ? l : K - 1, chunk);
            if (cand >= 0) m = cand;
          }
        }
        dst[s - lo] = m;
      }
      int* t = src;
      src = dst;
      dst = t;
    }
    // second walk, the prune
    const float thresh = a.dist_thresh;
    for (int s0 = lo + tid; s0 < hi; s0 += G * NT) {
      int idx[G], m[G];
      float dist[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int s = s0 + u * NT;
        idx[u] = s < hi ? s : -1;
        m[u] = s < hi ? src[s - lo] : -1;
      }
      walk(d, idx, m, dist, a.chain_steps, K, a.zfm);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (idx[u] < 0) continue;
        const int mm = (dist[u] > thresh || !ld(d.q_valid + idx[u])) ? -1
                                                                     : m[u];
        out[idx[u]] = mm;
        n += mm >= 0;
      }
    }
  }

  // the count: the CTA's, then the cluster's in rank order
  __syncthreads();
  if (n) atomicAdd(cnt, n);
  cluster_sync();
  if (rank == 0 && tid == 0) {
    int t = 0;
    for (unsigned r = 0; r < CLUSTER; ++r) t += *cluster_map(cnt, r);
    a.counts[(size_t)lane * 2 + (fwd ? 0 : 1)] = t;
  }
  // a CTA's shared memory stays until every CTA is done reading it
  cluster_sync();
}

__host__ __device__ constexpr size_t smem_bytes(int K) {
  return (size_t)4 * (4 + 2 * ((K + CLUSTER - 1) / CLUSTER));
}

#ifndef TP_HOST_EMU
inline int max_clusters(int K, int* n) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes(K);
  return (int)cudaOccupancyMaxActiveClusters(n, (void*)kf_correct_kernel,
                                             &cfg);
}
#endif

// The launch over L lanes (two clusters each: forward, backward). Inputs
// are contiguous and lane-major. cudaErrorInvalidValue for sizes the
// kernel does not take (K up to 48 KB of shared memory's worth, 49,136).
inline int launch(const Args& a, int L, void* stream) {
  if (L < 1 || a.K < 1 || a.chain_steps < 0 || a.aug_iters < 0 ||
      (long long)L * 2 * CLUSTER > 2147483647LL ||
      smem_bytes(a.K) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(L * 2 * CLUSTER);
  const dim3 block(NT);
  const size_t smem = smem_bytes(a.K);
  cudaStream_t st = (cudaStream_t)stream;
#ifdef TP_HOST_EMU
  return (int)launch_cluster_kernel(kf_correct_kernel, grid, block, CLUSTER,
                                    smem, st, a);
#else
  kf_correct_kernel<<<grid, block, smem, st>>>(a);
  return (int)cudaGetLastError();
#endif
}
}  // namespace kc

// Shared bytes and threads of a CTA at K slots a lane, and CTAs of a
// cluster (one cluster a lane and direction).
extern "C" void kf_correct_launch_config(int K, int* smem_bytes,
                                         int* threads, int* cluster) {
  *smem_bytes = (int)kc::smem_bytes(K);
  *threads = kc::NT;
  *cluster = kc::CLUSTER;
}

#ifndef TP_HOST_EMU
// Clusters of the kernel that can be resident at once on the card.
extern "C" int kf_correct_max_clusters(int K, int* n) {
  return kc::max_clusters(K, n);
}
#endif

// Launches K4 over L lanes (kc::launch).
extern "C" int kf_correct_launch(
    const float* E_b, const float* E_f, const uint8_t* strong_b,
    const uint8_t* strong_f, const float* px, const float* py,
    const int* p_id, const int* n_id, const uint8_t* valid,
    const int* m_id_kf, const int* m_id, const float* kf_px,
    const float* kf_py, const int* kf_p_id, const int* kf_n_id,
    const uint8_t* kf_valid, const int* kf_m_id_f, int* m_f, int* m_kf,
    int* counts, int L, int K, int chain_steps, int aug_iters, float zfm,
    float dist_thresh, void* stream) {
  const kc::Args a{E_b,    E_f,    strong_b, strong_f,    px,         py,
                   p_id,   n_id,   valid,    m_id_kf,     m_id,       kf_px,
                   kf_py,  kf_p_id, kf_n_id, kf_valid,    kf_m_id_f,  m_f,
                   m_kf,   counts, K,        chain_steps, aug_iters,  zfm,
                   dist_thresh};
  return kc::launch(a, L, stream);
}
