// Viterbi decode in two kernels: the max-plus forward pass that writes a
// backpointer map per step, and the backtrack that walks the maps.
//
// Replaces:
// - hhmm_tpu/kernels/pallas_semiring.py::_semiring_fwd_kernel in mode
//   "viterbi" (line 361), launched by its pallas_call at line 732 in
//   semiring_viterbi (hhmm_viterbi_fwd below);
// - hhmm_tpu/kernels/pallas_semiring.py::_backtrack_kernel (line 552),
//   launched by its pallas_call at line 745 (hhmm_viterbi_backtrack).
// kernels/dispatch.py::viterbi_dispatch reaches both for a homogeneous
// f32 log_A. The TPU kernels walk (128-lane batch tile, time block) grids
// and carry delta (forward) and the current state (backtrack) across
// time blocks in VMEM scratch. Here the forward pass is fwd_core.cuh's
// forward_kernel in its max-plus mode (a group of threads a lane, delta
// and a column of A a thread in registers, obs and mask in a
// shared-memory ring; that header has the design), and the backtrack
// one thread a lane walking all T steps.
//
// Math, per lane (f32; max-plus has no summation order, so the outputs
// are identical to the plain version's, not merely close):
//   delta_0    = pi + obs_0            (no mask case at t = 0, as in the
//                                       reference Viterbi)
//   s[i][j]    = delta_{t-1}[i] + A[i][j]
//   delta_t[j] = max_i s[i][j] + obs_t[j]
//   back_t[j]  = first argmax_i s[i][j]: the lowest index wins a tie and
//                an all -inf column gives 0
//   a masked step (mask_t <= 0) copies delta and writes the identity map;
//   back_0 is the identity map (never read);
//   score = max_j delta_{T-1}; the backtrack starts from
//   z_{T-1} = first argmax_j delta_{T-1} and steps z_{t-1} = back_t[z_t].
//   A padded tail is a run of identity maps, so the path repeats the
//   last valid state there.
//
// Backpointer maps are packed B bits a destination, B = 4 up to K = 16
// and 8 above, into W = ceil(K / P) 32-bit words per (step, lane), P =
// 32 / B states a word: field j % P of word j / P holds back_t[j].
// Layout: batch-minor, lane n fastest — pi/dlast [K,N], A [K,K,N], obs
// [T,K,N], mask/path [T,N], back [T,W,N], score [N] — coalesced across a
// warp; a map costs 4 W bytes, and the backtrack reads W words a step
// (from W = 2 on it selects the word of z_t, then shifts).
//
// What bounds the backtrack: it walks T dependent steps per lane, each a
// select, a shift and a mask on the words of its step, z_{t-1} =
// (back_t[z_t / P] >> B (z_t % P)) & (2^B - 1), so the loads of the words
// do not depend on z: they are issued kPrefetch steps ahead into a
// register ring (fewer steps for more words, so the ring stays in
// registers), and the dependent chain is register arithmetic, not a
// chain of device-memory round trips. K in 2..32.

#include "fwd_core.cuh"

namespace {

using hhmm::for_k;
using hhmm::kMapBits;
using hhmm::kMapPerWord;
using hhmm::kMapWords;

constexpr int kBlock = 128;
// steps of maps loaded ahead: 32 up to two words a step, then about 64
// words a ring
template <int W>
constexpr int kPrefetchOf = W <= 2 ? 32 : 64 / W;

template <int K>
__global__ void __launch_bounds__(kBlock)
viterbi_backtrack_kernel(const uint32_t* __restrict__ back,
                         const float* __restrict__ dlast,
                         int* __restrict__ path, int T, int N) {
  constexpr int W = kMapWords<K>;
  constexpr int kPrefetch = kPrefetchOf<W>;
  const int n = blockIdx.x * kBlock + threadIdx.x;
  if (n >= N) return;
  const size_t sN = static_cast<size_t>(N);

  float best = dlast[n];
  uint32_t z = 0;
#pragma unroll
  for (int k = 1; k < K; ++k) {
    const float d = dlast[k * sN + n];
    if (d > best) {
      best = d;
      z = static_cast<uint32_t>(k);
    }
  }
  path[static_cast<size_t>(T - 1) * sN + n] = static_cast<int>(z);

  // maps of steps s0, s0-1, .. s0-kPrefetch+1 in cur (word q of step
  // s0 - k at cur[q][k]); the next chunk's loads are issued before this
  // chunk's dependent selects run
  uint32_t cur[W][kPrefetch], nxt[W][kPrefetch];
  int s0 = T - 1;
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const int s = s0 - k;
#pragma unroll
    for (int q = 0; q < W; ++q)
      cur[q][k] = s >= 1 ? back[(static_cast<size_t>(s) * W + q) * sN + n] : 0u;
  }
  while (s0 >= 1) {
    const int s1 = s0 - kPrefetch;
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int s = s1 - k;
#pragma unroll
      for (int q = 0; q < W; ++q)
        nxt[q][k] = s >= 1 ? back[(static_cast<size_t>(s) * W + q) * sN + n] : 0u;
    }
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int s = s0 - k;
      if (s >= 1) {
        if constexpr (W == 1) {
          z = (cur[0][k] >> (4u * z)) & 15u;
        } else if constexpr (K <= 16) {
          z = (((z & 8u) ? cur[1][k] : cur[0][k]) >> (4u * (z & 7u))) & 15u;
        } else {
          constexpr uint32_t P = kMapPerWord<K>, B = kMapBits<K>;
          const uint32_t q = z / P;
          uint32_t word = cur[0][k];
#pragma unroll
          for (int w = 1; w < W; ++w) word = q == static_cast<uint32_t>(w) ? cur[w][k] : word;
          z = (word >> (B * (z % P))) & ((1u << B) - 1u);
        }
        path[static_cast<size_t>(s - 1) * sN + n] = static_cast<int>(z);
      }
    }
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k)
#pragma unroll
      for (int q = 0; q < W; ++q) cur[q][k] = nxt[q][k];
    s0 = s1;
  }
}

template <int K>
int launch_backtrack(const uint32_t* back, const float* dlast, int* path,
                     int T, int N, cudaStream_t stream) {
  const int grid = (N + kBlock - 1) / kBlock;
  viterbi_backtrack_kernel<K><<<grid, kBlock, 0, stream>>>(back, dlast, path,
                                                           T, N);
  return 0;
}

}  // namespace

// Both entry points return 0 on a good launch, the cudaError_t of a
// refused one, or -1 for a K outside 2..32 or an empty shape. They launch
// on `stream`, do not synchronise and allocate nothing: the caller owns
// every buffer (`back` is int32 [T, W, N], one packed map of W words per
// step).
extern "C" int hhmm_viterbi_fwd(int K, const float* pi, const float* A,
                                const float* obs, const float* mask,
                                float* score, float* dlast, int* back, int T,
                                int N, void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* b = reinterpret_cast<uint32_t*>(back);
  const int rc = for_k<hhmm::kMaxDecodeK>(K, [&](auto k) {
    return hhmm::launch_forward<decltype(k)::value, hhmm::kMaxPlus, false>(
        pi, A, obs, mask, nullptr, nullptr, score, nullptr, dlast, b, T, N, s);
  });
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}

extern "C" int hhmm_viterbi_backtrack(int K, const int* back,
                                      const float* dlast, int* path, int T,
                                      int N, void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(back);
  const int rc = for_k<hhmm::kMaxDecodeK>(K, [&](auto k) {
    return launch_backtrack<decltype(k)::value>(b, dlast, path, T, N, s);
  });
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
