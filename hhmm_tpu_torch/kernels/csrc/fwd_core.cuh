// The forward recursion shared by FWD (ffbs_fwd.cu, the clamped forward
// filter of FFBS and of the value-and-grad pass, optionally sign-gated),
// FILTER (semiring_filter.cu, the guarded forward filter of the decode)
// and VITERBI (semiring_viterbi.cu, the max-plus pass): one kernel
// template, forward_kernel<K, MODE, GATED>, of which each source
// instantiates its own mode, as the TPU kernels' forward passes are one
// recursion (pallas_semiring.py::_fwd_kernel, and _semiring_fwd_kernel,
// one body for "filter" and "viterbi").
//
// Per lane, t = 1 .. T-1, with c the carry (alpha or delta):
//   clamped (FWD):
//     c_0      = mask_0 > 0 ? pi + obs_0 : pi
//     c_t[j]   = lse0_i(c_{t-1}[i] + g_t[j] * A[i][j]) + obs_t[j]
//                (ungated: g_t[j] = 1; gated: g_t[j] = gate_t == sk[j],
//                compared as f32 equality)
//     every c_t goes to the [T, K, N] residual; ll = lse0(c_{T-1})
//   guarded (FILTER):
//     c_0      = mask_0 > 0 ? pi + obs_0 : pi
//     c_t[j]   = safe_lse_i(c_{t-1}[i] + A[i][j]) + obs_t[j]
//     every c_t goes to the residual; ll = safe_lse(c_{T-1})
//   max-plus (VITERBI):
//     c_0      = pi + obs_0                  (no mask case at t = 0)
//     c_t[j]   = max_i(c_{t-1}[i] + A[i][j]) + obs_t[j]
//     back_t[j] = first argmax_i of the same: the lowest index wins a
//                tie and an all -inf column gives 0
//     back_0 and a masked step's map are the identity; dlast = c_{T-1},
//     score = max_j dlast
//   a masked step (mask_t <= 0) keeps the carry, as a select.
// lse0 is lane_group.cuh's clamped logsumexp (pallas_semiring.py:127-131:
// the max clamped at -1e30), safe_lse its guarded one (an all -inf row
// gives -inf, never NaN); both sum the exponentials in index order, as
// the plain versions (cuda_semiring.py::fwd_plain, filter_plain) sum
// them, so FWD and FILTER are bitwise equal to them, and to each other
// on finite inputs, where the clamp never binds. The max and first
// argmax are a tree (argmax_tree): max is exact, and the lower half wins
// a tie, so value and index are those of the plain version's ascending
// strict-> chain (viterbi_plain) on every input without NaN.
//
// Maps: a field of B bits a state, B = 4 up to K = 16 and 8 above (a
// pointer to state 16 or more does not fit in four bits), so P = 32 / B
// = 8 or 4 states a word and W = ceil(K / P) int32 words a (step, lane);
// field j % P of word j / P holds back_t[j] (the unused fields 0); layout
// [T, W, N], the layout BACKTRACK (semiring_viterbi.cu), backtrack_plain
// and unpack_back read. Thread j puts its field arg << B (j % P) in a
// word and the group ORs the words of its P threads with __shfl_xor_sync
// (exact: the fields do not overlap); thread P w stores word w. The OR
// and the store read the step's argmax and feed nothing on the carry's
// chain.
//
// Layout: batch-minor, lane n fastest — pi/dlast/sk [K,N], A [K,K,N],
// obs/alpha [T,K,N], mask/gate [T,N], ll/score [N], back [T,W,N].
//
// Thread mapping (lane_group.cuh), K <= 32 (above, wide_core.cuh's
// block a lane): a group of G threads (G = 2, 4, 4, 8,
// 16, 32 for K = 2, 3, 4, 5..8, 9..16, 17..32) owns a lane; thread j owns
// c[j] and the column A[:, j] in registers (threads K .. G-1 idle), so a
// thread holds K floats of A, not K^2. Each step thread j gathers
// c_{t-1}[0..K-1] from its group with __shfl_sync and computes its own
// c_t[j]: K exponentials and one logarithm (clamped, guarded), or K adds
// and a log2(K)-deep compare tree (max-plus), where one thread a lane did
// all K of them. 64-thread blocks: N = 256 lanes at K = 4 spread over 16
// SMs, N = 8192 make 512 blocks, four or more an SM.
//
// What bounds it: the T-step chain within a lane (a gather and the
// step's arithmetic; at K = 4 in the clamped mode about 81 instructions,
// which one warp issues in order in about 290 cycles, 145 ns a step on an
// H100) and, for the max-plus pass, the bytes (obs in, maps out). The
// per-step inputs go through a shared-memory ring of kFwdStages stages of
// kFwdChunk steps, filled with cp.async by each thread for its own
// column kFwdStages - 1 chunks ahead of the step that reads it
// (cp.async.wait_group). A register ring one step ahead does not do
// this: every load in flight shares one of the six scoreboards, so a
// step that reads the oldest register waits for the youngest load too, a
// device-memory round trip a step (253 ns a step on an H100 for FWD,
// against 145 with this ring; 24- and 32-step rings measured no faster).
// Full chunks run without per-step bound checks; the partial last chunk
// is the one checked. The residual and map stores are fire-and-forget.

#pragma once

#include <stdint.h>

#include "lane_group.cuh"

namespace hhmm {

constexpr int kFwdBlock = 64;   // threads a block
constexpr int kFwdChunk = 8;    // steps a ring stage
constexpr int kFwdStages = 3;   // ring stages; chunks in flight: kFwdStages - 1

// map fields: bits a state, states a word, words a step
template <int K>
constexpr int kMapBits = K <= kMaxNibbleK ? 4 : 8;
template <int K>
constexpr int kMapPerWord = 32 / kMapBits<K>;
template <int K>
constexpr int kMapWords = (K + kMapPerWord<K> - 1) / kMapPerWord<K>;

// word w of the packed identity map of K states: field j % P holds j
template <int K>
__host__ __device__ constexpr uint32_t identity_word(int w) {
  constexpr int P = kMapPerWord<K>;
  uint32_t m = 0;
  for (int j = P * w; j < K && j < P * w + P; ++j)
    m |= static_cast<uint32_t>(j) << (kMapBits<K> * (j % P));
  return m;
}

// first (max, argmax) of x[LO .. LO+LEN-1] as a tree split like
// max_range: the upper half wins only if strictly greater
template <int LO, int LEN, int K>
__device__ __forceinline__ void argmax_range(const float (&x)[K], float& best, int& arg) {
  if constexpr (LEN == 1) {
    best = x[LO];
    arg = LO;
  } else {
    constexpr int H = split_point(LEN);
    float lo, hi;
    int alo, ahi;
    argmax_range<LO, H>(x, lo, alo);
    argmax_range<LO + H, LEN - H>(x, hi, ahi);
    const bool up = hi > lo;
    best = up ? hi : lo;
    arg = up ? ahi : alo;
  }
}

template <int K>
__device__ __forceinline__ void argmax_tree(const float (&x)[K], float& best, int& arg) {
  argmax_range<0, K>(x, best, arg);
}

// MODE: kClamped (FWD: ll and the alpha residual out, gated when GATED),
// kGuarded (FILTER: ll and the alpha residual out) or kMaxPlus (VITERBI:
// score, dlast and the maps out). Pointers of the other modes are unused;
// GATED only with kClamped.
template <int K, int MODE, bool GATED>
__global__ void __launch_bounds__(kFwdBlock)
forward_kernel(const float* __restrict__ pi, const float* __restrict__ A,
               const float* __restrict__ obs, const float* __restrict__ mask,
               const float* __restrict__ gate, const float* __restrict__ sk,
               float* __restrict__ lane_out, float* __restrict__ alpha_out,
               float* __restrict__ dlast, uint32_t* __restrict__ back, int T, int N) {
  static_assert(MODE == kClamped || !GATED, "only the clamped mode is gated");
  constexpr bool MAXPLUS = MODE == kMaxPlus;
  constexpr int G = Group<K>::G;
  constexpr int LPW = Group<K>::kLanesPerWarp;
  constexpr int B = kMapBits<K>, P = kMapPerWord<K>, W = kMapWords<K>;
  constexpr int kStages = kFwdStages, kChunk = kFwdChunk, kBlock = kFwdBlock;
  const int wl = threadIdx.x & 31;
  const int l = wl % LPW;  // lane within the warp
  const int j = wl / LPW;  // state owned by this thread
  const int n = (blockIdx.x * (kBlock / 32) + threadIdx.x / 32) * LPW + l;
  // every thread of a warp takes part in the shuffles; only these own a
  // value to load and store
  const bool live = n < N && j < K;
  const bool stores_word = live && j % P == 0;  // thread P w stores map word w
  const size_t sN = static_cast<size_t>(N);
  const size_t step = static_cast<size_t>(K) * sN;  // obs/alpha row stride
  const size_t wstep = static_cast<size_t>(W) * sN;  // map row stride
  const int shift = B * (j % P);

  float acol[K];
  float skj = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) acol[i] = live ? A[(i * K + j) * sN + n] : 0.0f;
  if (GATED && live) skj = sk[j * sN + n];

  float c = 0.0f;
  if (live) {
    const float p = pi[j * sN + n];
    if constexpr (MAXPLUS) {
      c = p + obs[j * sN + n];
    } else {
      c = mask[n] > 0.0f ? p + obs[j * sN + n] : p;
      alpha_out[j * sN + n] = c;
    }
  }
  if constexpr (MAXPLUS) {
    if (stores_word) back[(j / P) * sN + n] = identity_word<K>(j / P);
  }

  // the ring: stage st holds chunk q (steps 1 + q * kChunk ..) for every
  // q = st mod kStages; each thread copies and reads only its own column
  __shared__ float s_obs[kStages][kChunk][kBlock];
  __shared__ float s_mask[kStages][kChunk][kBlock];
  __shared__ float s_gate[GATED ? kStages : 1][kChunk][kBlock];
  const int tid = threadIdx.x;
  const int full = (T - 1) / kChunk;                  // chunks of kChunk steps
  const int chunks = (T - 1 + kChunk - 1) / kChunk;  // and a partial one
  // copy chunk q into its stage: one group, empty past the last chunk
  auto issue = [&](int q) {
    const int st = q % kStages;
    const int t0 = 1 + q * kChunk;
    if (live && q < chunks) {
      const float* o = obs + (static_cast<size_t>(t0) * K + j) * sN + n;
      const float* m = mask + static_cast<size_t>(t0) * sN + n;
      const float* g = GATED ? gate + static_cast<size_t>(t0) * sN + n : nullptr;
      const int valid = q < full ? kChunk : T - t0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < valid) {
          cp_async4(&s_obs[st][k][tid], o);
          cp_async4(&s_mask[st][k][tid], m);
          if (GATED) cp_async4(&s_gate[GATED ? st : 0][k][tid], g);
        }
        o += step;
        m += sN;
        if (GATED) g += sN;
      }
    }
    cp_async_commit();
  };
  // step 1's alpha row (clamped, guarded) or map word (max-plus)
  float* dst = MAXPLUS ? nullptr : alpha_out + j * sN + n + step;
  uint32_t* wdst = MAXPLUS ? back + (j / P) * sN + n + wstep : nullptr;
  // one step from stage st, slot k
  auto run = [&](int st, int k) {
    float x[K];
    gather<K>(x, c, l);
    if constexpr (GATED) {
      const float c_t = (s_gate[GATED ? st : 0][k][tid] == skj) ? 1.0f : 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) x[i] = x[i] + acol[i] * c_t;
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) x[i] = x[i] + acol[i];
    }
    const bool valid = s_mask[st][k][tid] > 0.0f;
    if constexpr (MAXPLUS) {
      float best;
      int arg;
      argmax_tree<K>(x, best, arg);
      const float nw = best + s_obs[st][k][tid];
      c = valid ? nw : c;
      uint32_t word = j < K ? static_cast<uint32_t>(valid ? arg : j) << shift : 0u;
#pragma unroll
      for (int d = 1; d < (G < P ? G : P); d *= 2) word |= __shfl_xor_sync(kFull, word, d * LPW);
      if (stores_word) *wdst = word;
      wdst += wstep;
    } else {
      const float s = MODE == kClamped ? lse0<K>(x) : safe_lse<K>(x);
      const float nw = s + s_obs[st][k][tid];
      if constexpr (MODE == kClamped) {
        // the clamped mode reads its mask after the step's arithmetic,
        // the other two before it: each the faster order for its mode on
        // an H100 (FWD 14 % slower with the early read; PERF.md)
        const bool late = s_mask[st][k][tid] > 0.0f;
        c = late ? nw : c;
      } else {
        c = valid ? nw : c;
      }
      if (live) *dst = c;
      dst += step;
    }
  };

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int q = 0; q < full; ++q) {
    issue(q + kStages - 1);        // into the stage of chunk q - 1, already run
    cp_async_wait<kStages - 1>();  // chunk q has landed
    const int st = q % kStages;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) run(st, k);
  }
  if (full < chunks) {  // the partial chunk, uniform across the block
    cp_async_wait<0>();
    const int st = full % kStages;
    const int valid = T - 1 - full * kChunk;
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (k < valid) run(st, k);
  }

  float fin[K];
  gather<K>(fin, c, l);
  if constexpr (MAXPLUS) {
    if (live) dlast[j * sN + n] = c;
    float best;
    int arg;
    argmax_tree<K>(fin, best, arg);
    if (live && j == 0) lane_out[n] = best;
  } else if constexpr (MODE == kClamped) {
    if (live && j == 0) lane_out[n] = lse0<K>(fin);
  } else {
    if (live && j == 0) lane_out[n] = safe_lse<K>(fin);
  }
}

template <int K, int MODE, bool GATED>
int launch_forward(const float* pi, const float* A, const float* obs, const float* mask,
                   const float* gate, const float* sk, float* lane_out, float* alpha,
                   float* dlast, uint32_t* back, int T, int N, cudaStream_t stream) {
  constexpr int lanes = kFwdBlock / Group<K>::G;
  const int grid = (N + lanes - 1) / lanes;
  forward_kernel<K, MODE, GATED><<<grid, kFwdBlock, 0, stream>>>(
      pi, A, obs, mask, gate, sk, lane_out, alpha, dlast, back, T, N);
  return 0;
}

}  // namespace hhmm
