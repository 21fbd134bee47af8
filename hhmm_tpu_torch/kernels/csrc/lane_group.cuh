// What the semiring kernels share (fwd_core.cuh for ffbs_fwd.cu,
// semiring_filter.cu and semiring_viterbi.cu, beta_core.cuh for
// semiring_beta.cu and vg_bwd.cu, wide_core.cuh for all five in K =
// 33..128, big_core.cuh above, and ffbs_bwd_sample.cu): the K range, the forward modes, the
// group's shape, the order-fixed log-sum-exps, the warp gather, the
// cp.async ring's three instructions and the dispatch of a runtime K to
// its template.
//
// A group of G threads (the next power of two >= K, at least 2, at most
// a warp) owns one lane; thread j of the group owns state j (threads K ..
// G-1 idle, as the fourth does at K = 3 and the second at K = 1). A warp holds 32 / G lanes,
// lane index fastest, so at one step the warp's accesses to a [.., K, N]
// array are, per state, 32 / G consecutive floats.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace hhmm {

constexpr float kClamp = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMinK = 1;
constexpr int kMaxK = 128;      // the wide layout: a lane's A (and d_A) in shared memory; big_core.cuh above
constexpr int kMaxGroupK = 32;  // a group of threads a lane, a warp at most; a block above
constexpr int kMaxNibbleK = 16; // packed maps of four bits a state; bytes above

// the modes of the forward recursion (fwd_core.cuh, wide_core.cuh)
constexpr int kClamped = 0;  // FWD
constexpr int kGuarded = 1;  // FILTER
constexpr int kMaxPlus = 2;  // VITERBI

template <int K>
struct Group {
  static_assert(kMinK <= K && K <= kMaxGroupK, "K in 1..32");
  // threads a lane
  static constexpr int G = K <= 2 ? 2 : (K <= 4 ? 4 : (K <= 8 ? 8 : (K <= 16 ? 16 : 32)));
  static constexpr int kLanesPerWarp = 32 / G;
};

// the largest power of two below n (n >= 2; max_range never splits a
// range of one)
__host__ __device__ constexpr int split_point(int n) {
  int h = 1;
  while (2 * h < n) h *= 2;
  return h;
}

// max of x[LO .. LO+LEN-1] as a tree: the first split_point(LEN) entries
// against the rest, so K = 3 is max(max(x0, x1), x2) and K = 4, 8, 16
// balanced. max is exact, so the shape never changes the value.
template <int LO, int LEN, int K>
__device__ __forceinline__ float max_range(const float (&x)[K]) {
  if constexpr (LEN == 1) {
    return x[LO];
  } else {
    constexpr int H = split_point(LEN);
    return fmaxf(max_range<LO, H>(x), max_range<LO + H, LEN - H>(x));
  }
}

template <int K>
__device__ __forceinline__ float max_tree(const float (&x)[K]) {
  return max_range<0, K>(x);
}

// clamped logsumexp (pallas_semiring.py:127-131): the max is clamped at
// -1e30, the exponentials are summed in index order
template <int K>
__device__ __forceinline__ float lse0(const float (&x)[K]) {
  const float m = fmaxf(max_tree<K>(x), kClamp);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) s += expf(x[i] - m);
  return m + logf(s);
}

// guarded logsumexp (pallas_semiring.py:115-119, core.lmath.safe_logsumexp):
// an all -inf row gives -inf, never NaN; otherwise m + log(sum exp(x - m))
// summed in index order. A select, not a branch: the all -inf row runs
// the sum against a max of 0 (every term 0) and is then replaced.
template <int K>
__device__ __forceinline__ float safe_lse(const float (&x)[K]) {
  const float m = max_tree<K>(x);
  const bool dead = m == -INFINITY;
  const float ms = dead ? 0.0f : m;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) s += expf(x[i] - ms);
  return dead ? -INFINITY : ms + logf(s);
}

// v[0..K-1] of this thread's lane from the group's threads (lane l of
// the warp's 32 / G): state i's value lives in warp lane i * LPW + l
template <int K>
__device__ __forceinline__ void gather(float (&v)[K], float mine, int l) {
  constexpr int LPW = Group<K>::kLanesPerWarp;
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = __shfl_sync(kFull, mine, i * LPW + l);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `n` of this thread's copy groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// 16 bytes (global and shared addresses 16-byte aligned), past L1
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

// the 4-byte copy of a 32-bit word (BACKTRACK's maps)
__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
  cp_async4(reinterpret_cast<float*>(smem), reinterpret_cast<const float*>(gmem));
}

// f(std::integral_constant<int, K>{}) for the runtime k in 1..KMAX, -1
// for any other k
template <int KMAX, int K = kMinK, class F>
int for_k(int k, F&& f) {
  if constexpr (K > KMAX) {
    return -1;
  } else {
    if (k == K) return f(std::integral_constant<int, K>{});
    return for_k<KMAX, K + 1>(k, f);
  }
}

}  // namespace hhmm
