// Host emulation of the CUDA subset the tile kernels use
// (rebvo_tpu_torch/csrc/tile_pipeline.cuh), so that g++ compiles and runs
// the kernels' own source on the CPU: a block's CUDA threads are
// std::threads, __syncthreads is a std::barrier, the block's shared memory
// is a buffer filled with NaNs (a read of a cell no phase wrote shows in
// the output). Float operations are IEEE single precision, built with
// -ffp-contract=off so no multiply and add fuse, as the card's --fmad=false.
//
// Used by tests/tile_host.cpp with `g++ -include cuda_host_emu.h`.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <barrier>
#include <limits>
#include <thread>
#include <vector>

#define TP_HOST_EMU 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

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
