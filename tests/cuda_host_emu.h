// Host emulation of the CUDA subset the kernels use
// (rebvo_tpu_torch/csrc/tile_pipeline.cuh, csrc/pose_lm.cu,
// csrc/kf_correct.cu, csrc/match_depth.cu), so that g++ compiles and runs the kernels' own
// source on the CPU: a block's CUDA threads are std::threads,
// __syncthreads is a std::barrier, the block's shared memory is a buffer
// filled with NaNs (a read of a cell no phase wrote shows in the output).
// A thread-block cluster's blocks run at once, with a barrier over all
// their threads, each other's shared memory and integer atomics on it; a
// warp's shuffle-tree sum is a per-warp buffer summed in the tree's
// order. Float operations are IEEE single precision, built with
// -ffp-contract=off so no multiply and add fuse, as the card's --fmad=false.
//
// Used by tests/tile_host.cpp with `g++ -include cuda_host_emu.h`.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <barrier>
#include <limits>
#include <memory>
#include <thread>
#include <vector>

#define TP_HOST_EMU 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __cluster_dims__(...)

struct dim3 {
  unsigned x, y, z;
  constexpr dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1)
      : x(a), y(b), z(c) {}
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(4) uchar4 {
  unsigned char x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline uchar4 make_uchar4(unsigned char a, unsigned char b, unsigned char c,
                          unsigned char d) {
  return {a, b, c, d};
}

using cudaError_t = int;
using cudaStream_t = void*;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }

namespace tp_emu {
inline thread_local std::barrier<>* bar = nullptr;
inline thread_local float* smem = nullptr;
// launch_cluster_kernel: the cluster's barrier, this block's rank, every
// block's shared memory by rank, this thread's warp barrier and buffer
inline thread_local std::barrier<>* cluster_bar = nullptr;
inline thread_local unsigned cluster_rank = 0;
inline thread_local float* const* cluster_smem = nullptr;
inline thread_local std::barrier<>* warp_bar = nullptr;
inline thread_local double* warp_buf = nullptr;
inline thread_local unsigned lane = 0;
constexpr int WARP_BUF = 32 * 32;    // doubles: 32 lanes x 32 values
}  // namespace tp_emu

inline thread_local dim3 threadIdx, blockIdx;

inline void __syncthreads() { tp_emu::bar->arrive_and_wait(); }
inline float* dynamic_smem() { return tp_emu::smem; }
inline void cp_async16(float* dst, const float* src) {
  memcpy(dst, src, 16);
}
inline void cp_async_wait_all() {}

// Runs the grid one block after another, each block's threads at once.
template <typename... P, typename... A>
inline cudaError_t launch_kernel(void (*k)(P...), dim3 grid, dim3 block,
                                 size_t smem_bytes, cudaStream_t, A... args) {
  std::vector<float4> buf((smem_bytes + 15) / 16);
  const unsigned nthreads = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        const float nan = std::numeric_limits<float>::quiet_NaN();
        for (float4& v : buf) v = make_float4(nan, nan, nan, nan);
        std::barrier<> bar(nthreads);
        std::vector<std::thread> threads;
        threads.reserve(nthreads);
        for (unsigned tz = 0; tz < block.z; ++tz)
          for (unsigned ty = 0; ty < block.y; ++ty)
            for (unsigned tx = 0; tx < block.x; ++tx)
              threads.emplace_back([&, tx, ty, tz, bx, by, bz] {
                threadIdx = dim3(tx, ty, tz);
                blockIdx = dim3(bx, by, bz);
                tp_emu::bar = &bar;
                tp_emu::smem = reinterpret_cast<float*>(buf.data());
                k(args...);
              });
        for (std::thread& t : threads) t.join();
      }
  return cudaSuccess;
}

// Integer atomics on shared memory, this block's or another's of the
// cluster (the card's atomicAdd and atomicMax on a shared address).
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p);
  unsigned old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}

// Thread-block clusters (launch_cluster_kernel).
inline unsigned cluster_rank() { return tp_emu::cluster_rank; }
inline void cluster_sync() { tp_emu::cluster_bar->arrive_and_wait(); }
// `p`, a pointer into this block's shared memory, in the block of `rank`.
template <typename T>
inline T* cluster_map(T* p, unsigned rank) {
  const char* base = reinterpret_cast<const char*>(tp_emu::smem);
  const size_t off = reinterpret_cast<const char*>(p) - base;
  return reinterpret_cast<T*>(
      reinterpret_cast<char*>(tp_emu::cluster_smem[rank]) + off);
}

// v[0..n) summed over the warp as the shuffle tree (offsets 16, 8, 4, 2,
// 1) sums it: lane 0 gets the tree's sums; n <= 32.
inline void warp_sum_emu(double* v, int n) {
  double* buf = tp_emu::warp_buf;
  const unsigned l = tp_emu::lane;
  for (int i = 0; i < n; ++i) buf[l * 32 + i] = v[i];
  tp_emu::warp_bar->arrive_and_wait();
  if (l == 0) {
    for (unsigned o = 16; o > 0; o >>= 1)
      for (unsigned m = 0; m < o; ++m)
        for (int i = 0; i < n; ++i)
          buf[m * 32 + i] = buf[m * 32 + i] + buf[(m + o) * 32 + i];
    for (int i = 0; i < n; ++i) v[i] = buf[i];
  }
  tp_emu::warp_bar->arrive_and_wait();
}

// Runs a 1-D grid of clusters of `cluster` blocks one cluster after
// another, each cluster's threads at once.
template <typename... P, typename... A>
inline cudaError_t launch_cluster_kernel(void (*k)(P...), dim3 grid,
                                         dim3 block, unsigned cluster,
                                         size_t smem_bytes, cudaStream_t,
                                         A... args) {
  const unsigned nt = block.x;
  if (grid.y != 1 || grid.z != 1 || block.y != 1 || block.z != 1 ||
      cluster == 0 || grid.x % cluster != 0 || nt % 32 != 0)
    return cudaErrorInvalidValue;
  const unsigned nwarp = nt / 32;
  const float nan = std::numeric_limits<float>::quiet_NaN();
  for (unsigned c0 = 0; c0 < grid.x; c0 += cluster) {
    std::vector<std::vector<float4>> bufs(
        cluster, std::vector<float4>((smem_bytes + 15) / 16,
                                     make_float4(nan, nan, nan, nan)));
    std::vector<float*> smem;
    std::vector<std::unique_ptr<std::barrier<>>> bars, wbars;
    for (unsigned r = 0; r < cluster; ++r) {
      smem.push_back(reinterpret_cast<float*>(bufs[r].data()));
      bars.push_back(std::make_unique<std::barrier<>>(nt));
      for (unsigned w = 0; w < nwarp; ++w)
        wbars.push_back(std::make_unique<std::barrier<>>(32));
    }
    std::vector<double> wbuf((size_t)cluster * nwarp * tp_emu::WARP_BUF);
    std::barrier<> cbar(cluster * nt);
    std::vector<std::thread> threads;
    threads.reserve(cluster * nt);
    for (unsigned r = 0; r < cluster; ++r)
      for (unsigned t = 0; t < nt; ++t)
        threads.emplace_back([&, r, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(c0 + r);
          tp_emu::bar = bars[r].get();
          tp_emu::smem = smem[r];
          tp_emu::cluster_bar = &cbar;
          tp_emu::cluster_rank = r;
          tp_emu::cluster_smem = smem.data();
          const unsigned w = r * nwarp + t / 32;
          tp_emu::warp_bar = wbars[w].get();
          tp_emu::warp_buf = wbuf.data() + (size_t)w * tp_emu::WARP_BUF;
          tp_emu::lane = t % 32;
          k(args...);
        });
    for (std::thread& t : threads) t.join();
  }
  return cudaSuccess;
}
