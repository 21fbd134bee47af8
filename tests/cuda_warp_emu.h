// CPU emulation of the CUDA subset that the kernel sources of
// hhmm_tpu_torch/kernels/csrc (with their headers) use, so the kernels'
// own sources run on a host without a card (tests/test_torch_traj_emu.py,
// tests/test_torch_backward_emu.py, tests/test_torch_forward_emu.py): one
// std::thread per CUDA thread, a block at a time; __syncwarp and the
// shuffles are a std::barrier per warp (the unsigned xor shuffle copies
// the bits through the warp's float buffer unchanged), __syncthreads a
// std::barrier across the block's threads, dynamic shared memory a
// per-block buffer (the tests rewrite `extern __shared__ T name[];` into
// a pointer to it), and the <<<...>>> launch is rewritten into a call of
// Launcher.
// Static __shared__ arrays become per-thread arrays, which is what they
// are to a kernel whose threads each use only their own column (the
// cp.async rings); a kernel that shares data across its threads does so
// in dynamic shared memory. The tests rewrite a cp.async copy into a
// plain copy and commit_group / wait_group into nothing: the copy has
// landed by the time the thread reads it, which is what wait_group
// guarantees (and a __syncthreads() after it makes it visible to the
// block, as on the card). Host float arithmetic stands in for the card's
// (no fused multiply-add), so results agree with the card's within
// rounding, not bitwise.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <memory>
#include <thread>
#include <vector>
using std::min; using std::max;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(x)
#define __restrict__
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct dim3 { unsigned x = 0, y = 0, z = 0; };
thread_local dim3 threadIdx, blockIdx;
thread_local uint8_t* g_smem;
dim3 blockDim;
struct WarpCtx { std::barrier<>* bar; float* xbuf; };
thread_local WarpCtx g_warp;
thread_local std::barrier<>* g_block;
inline void __syncwarp() { g_warp.bar->arrive_and_wait(); }
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  int lane = threadIdx.x & 31;
  g_warp.xbuf[lane] = v;
  g_warp.bar->arrive_and_wait();
  float r = g_warp.xbuf[lane ^ o];
  g_warp.bar->arrive_and_wait();
  return r;
}
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int o) {
  int lane = threadIdx.x & 31;
  std::memcpy(&g_warp.xbuf[lane], &v, 4);
  g_warp.bar->arrive_and_wait();
  unsigned r;
  std::memcpy(&r, &g_warp.xbuf[lane ^ o], 4);
  g_warp.bar->arrive_and_wait();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) {
  int lane = threadIdx.x & 31;
  g_warp.xbuf[lane] = v;
  g_warp.bar->arrive_and_wait();
  float r = g_warp.xbuf[src & 31];
  g_warp.bar->arrive_and_wait();
  return r;
}
inline size_t __cvta_generic_to_shared(const void* p) { return reinterpret_cast<size_t>(p); }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
// four SMs: the backtrack, which takes up to 32 lanes a block while that
// leaves a block an SM, then takes 2 lanes at N = 9, 4 at 17, 8 at 40, 16
// at 70 and 32 at 128, so small N reach each of its block shapes
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 4; return 0; }
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
// the stream-ordered scratch of the kernels above K = 128: the emulated
// launch runs to its end before the call returns, so a plain heap block
inline int cudaMallocAsync(void** p, size_t bytes, cudaStream_t) {
  *p = std::malloc(bytes);
  return *p ? 0 : 2;
}
inline int cudaFreeAsync(void* p, cudaStream_t) { std::free(p); return 0; }
typedef void* cudaMemPool_t;
enum { cudaMemPoolAttrReleaseThreshold = 4 };
inline int cudaDeviceGetDefaultMemPool(cudaMemPool_t* p, int) { *p = nullptr; return 0; }
inline int cudaMemPoolSetAttribute(cudaMemPool_t, int, void*) { return 0; }
struct Launcher {
  int grid, block; size_t bytes;
  template <class F, class... A> void operator()(F f, A... a) {
    blockDim.x = block;
    for (int bx = 0; bx < grid; ++bx) {
      std::vector<uint8_t> sm(bytes + 16);
      int warps = block / 32;
      std::vector<std::unique_ptr<std::barrier<>>> bars;
      std::barrier<> block_bar(block);
      std::vector<float> xb(32 * warps);
      for (int w = 0; w < warps; ++w) bars.emplace_back(new std::barrier<>(32));
      std::vector<std::thread> th;
      for (int t = 0; t < block; ++t)
        th.emplace_back([&, t] {
          threadIdx.x = t; blockIdx.x = bx; g_smem = sm.data();
          g_warp = {bars[t / 32].get(), xb.data() + 32 * (t / 32)};
          g_block = &block_bar;
          f(a...);
        });
      for (auto& x : th) x.join();
    }
  }
};
