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
// time blocks in VMEM scratch. Here one thread owns one lane and walks
// all T steps itself, with delta[K] and A[K][K] in registers.
//
// Math, per lane (f32; max-plus has no summation order, so the outputs
// are identical to the plain version's, not merely close):
//   delta_0    = pi + obs_0            (no mask case at t = 0, as in the
//                                       reference Viterbi)
//   s[i][j]    = delta_{t-1}[i] + A[i][j]
//   delta_t[j] = max_i s[i][j] + obs_t[j]
//   back_t[j]  = first argmax_i s[i][j]: strict > over ascending i, so
//                the lowest index wins a tie and an all -inf column gives 0
//   a masked step (mask_t <= 0) copies delta and writes the identity map;
//   back_0 is the identity map (never read);
//   score = max_j delta_{T-1}; the backtrack starts from
//   z_{T-1} = first argmax_j delta_{T-1} and steps z_{t-1} = back_t[z_t].
//   A padded tail is a run of identity maps, so the path repeats the
//   last valid state there.
//
// Backpointer maps are packed four bits a destination into W = ceil(K /
// 8) 32-bit words per (step, lane): nibble j % 8 of word j / 8 holds
// back_t[j]. Layout: batch-minor, lane n fastest — pi/dlast [K,N], A
// [K,K,N], obs [T,K,N], mask/path [T,N], back [T,W,N], score [N] —
// coalesced across a warp; a map costs 4 W bytes, and the backtrack
// reads W words a step (at W = 2 it selects the word of z_t, then
// shifts). K in 2..16; at K > 8 the forward pass keeps A[K][K] in
// registers and spills (correct, not tuned: PERF.md has the counts).
//
// What bounds them: both walk T dependent steps per lane. The forward
// pass is the filter's chain with max in place of logsumexp (no exp or
// log); its next obs/mask rows are loaded one step ahead. In the
// backtrack each step is a shift and a mask on the word of its step,
// z_{t-1} = (back_t >> 4 z_t) & 15, so the loads of the words do not
// depend on z: they are issued kPrefetch steps ahead into a register
// ring, and the dependent chain is register arithmetic, not a chain of
// device-memory round trips.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lane_group.cuh"

namespace {

using hhmm::for_k;

constexpr int kBlock = 128;
constexpr int kPrefetch = 32;

// map words a step: eight states a word
template <int K>
constexpr int kWords = (K + 7) / 8;

// word w of the packed identity map: nibble j % 8 holds j
template <int K>
__device__ __forceinline__ uint32_t identity_map(int w) {
  uint32_t m = 0;
#pragma unroll
  for (int j = 8 * w; j < K && j < 8 * w + 8; ++j) m |= static_cast<uint32_t>(j) << (4 * (j % 8));
  return m;
}

template <int K>
__global__ void __launch_bounds__(kBlock)
viterbi_fwd_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                   const float* __restrict__ obs,
                   const float* __restrict__ mask, float* __restrict__ score,
                   float* __restrict__ dlast, uint32_t* __restrict__ back,
                   int T, int N) {
  constexpr int W = kWords<K>;
  const int n = blockIdx.x * kBlock + threadIdx.x;
  if (n >= N) return;
  const size_t sN = static_cast<size_t>(N);

  float a[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) a[i][j] = A[(i * K + j) * sN + n];

  float delta[K];
#pragma unroll
  for (int k = 0; k < K; ++k) delta[k] = pi[k * sN + n] + obs[k * sN + n];
  uint32_t ident[W];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    ident[q] = identity_map<K>(q);
    back[q * sN + n] = ident[q];
  }

  // step t+1's inputs, loaded one step ahead
  float o_nx[K];
  float m_nx = 0.0f;
  if (T > 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) o_nx[k] = obs[(K + k) * sN + n];
    m_nx = mask[sN + n];
  }

  for (int t = 1; t < T; ++t) {
    float o[K];
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] = o_nx[k];
    const float m = m_nx;
    if (t + 1 < T) {
      const size_t row = static_cast<size_t>(t + 1);
#pragma unroll
      for (int k = 0; k < K; ++k) o_nx[k] = obs[(row * K + k) * sN + n];
      m_nx = mask[row * sN + n];
    }
    uint32_t w[W];
#pragma unroll
    for (int q = 0; q < W; ++q) w[q] = ident[q];
    if (m > 0.0f) {
      float nw[K];
#pragma unroll
      for (int q = 0; q < W; ++q) w[q] = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float best = delta[0] + a[0][j];
        uint32_t arg = 0;
#pragma unroll
        for (int i = 1; i < K; ++i) {
          const float s = delta[i] + a[i][j];
          if (s > best) {
            best = s;
            arg = static_cast<uint32_t>(i);
          }
        }
        nw[j] = best + o[j];
        w[j / 8] |= arg << (4 * (j % 8));
      }
#pragma unroll
      for (int k = 0; k < K; ++k) delta[k] = nw[k];
    }
#pragma unroll
    for (int q = 0; q < W; ++q) back[(static_cast<size_t>(t) * W + q) * sN + n] = w[q];
  }

  float best = delta[0];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (delta[k] > best) best = delta[k];
    dlast[k * sN + n] = delta[k];
  }
  score[n] = best;
}

template <int K>
__global__ void __launch_bounds__(kBlock)
viterbi_backtrack_kernel(const uint32_t* __restrict__ back,
                         const float* __restrict__ dlast,
                         int* __restrict__ path, int T, int N) {
  constexpr int W = kWords<K>;
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
        } else {
          z = (((z & 8u) ? cur[1][k] : cur[0][k]) >> (4u * (z & 7u))) & 15u;
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
int launch_fwd(const float* pi, const float* A, const float* obs,
               const float* mask, float* score, float* dlast, uint32_t* back,
               int T, int N, cudaStream_t stream) {
  const int grid = (N + kBlock - 1) / kBlock;
  viterbi_fwd_kernel<K><<<grid, kBlock, 0, stream>>>(pi, A, obs, mask, score,
                                                     dlast, back, T, N);
  return 0;
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
// refused one, or -1 for a K outside 2..16 or an empty shape. They launch
// on `stream`, do not synchronise and allocate nothing: the caller owns
// every buffer (`back` is int32 [T, W, N], one packed map of W = ceil(K /
// 8) words per step).
extern "C" int hhmm_viterbi_fwd(int K, const float* pi, const float* A,
                                const float* obs, const float* mask,
                                float* score, float* dlast, int* back, int T,
                                int N, void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* b = reinterpret_cast<uint32_t*>(back);
  const int rc = for_k(K, [&](auto k) {
    return launch_fwd<decltype(k)::value>(pi, A, obs, mask, score, dlast, b, T, N, s);
  });
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}

extern "C" int hhmm_viterbi_backtrack(int K, const int* back,
                                      const float* dlast, int* path, int T,
                                      int N, void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(back);
  const int rc = for_k(K, [&](auto k) {
    return launch_backtrack<decltype(k)::value>(b, dlast, path, T, N, s);
  });
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
