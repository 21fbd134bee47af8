// CPU emulation of the CUDA subset that csrc/tayal_traj.cu uses, so the
// kernel's own source runs on a host without a card
// (tests/test_torch_traj_emu.py): one std::thread per CUDA thread, a
// block at a time; __syncwarp and the xor shuffle are a std::barrier per
// warp, shared memory a per-block buffer, and the <<<...>>> launch is
// rewritten into a call of Launcher. Host float arithmetic stands in for
// the card's (no fused multiply-add), so results agree with the card's
// within rounding, not bitwise.
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstddef>
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
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 { unsigned x = 0, y = 0, z = 0; };
thread_local dim3 threadIdx, blockIdx;
thread_local uint8_t* g_smem;
dim3 blockDim;
struct WarpCtx { std::barrier<>* bar; float* xbuf; };
thread_local WarpCtx g_warp;
inline void __syncwarp() { g_warp.bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  int lane = threadIdx.x & 31;
  g_warp.xbuf[lane] = v;
  g_warp.bar->arrive_and_wait();
  float r = g_warp.xbuf[lane ^ o];
  g_warp.bar->arrive_and_wait();
  return r;
}
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetLastError() { return 0; }
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
struct Launcher {
  int grid, block; size_t bytes;
  template <class F, class... A> void operator()(F f, A... a) {
    blockDim.x = block;
    for (int bx = 0; bx < grid; ++bx) {
      std::vector<uint8_t> sm(bytes + 16);
      int warps = block / 32;
      std::vector<std::unique_ptr<std::barrier<>>> bars;
      std::vector<float> xb(32 * warps);
      for (int w = 0; w < warps; ++w) bars.emplace_back(new std::barrier<>(32));
      std::vector<std::thread> th;
      for (int t = 0; t < block; ++t)
        th.emplace_back([&, t] {
          threadIdx.x = t; blockIdx.x = bx; g_smem = sm.data();
          g_warp = {bars[t / 32].get(), xb.data() + 32 * (t / 32)};
          f(a...);
        });
      for (auto& x : th) x.join();
    }
  }
};
