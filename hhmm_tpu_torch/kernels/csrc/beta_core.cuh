// The backward (beta) recursion shared by BETA (semiring_beta.cu, the
// guarded beta of the decode) and VG_BWD (vg_bwd.cu, the clamped beta of
// the value-and-grad pass with its Baum-Welch sums): one kernel template,
// beta_kernel<K, VG, GATED>, of which each source instantiates its own
// mode.
//
// Both walk the same recursion backward in time, per lane:
//   beta_{T-1} = 0
//   e[j]       = obs_r[j] + beta_r[j]
//   beta_{r-1}[i] = mask_r > 0 ? lse_j(c_r[j] * A[i][j] + e[j]) : beta_r[i]
// for r = T-1 .. 1 (the walk's step s = T-1-r). BETA: lse is the
// guarded safe_lse, ungated (c = 1), every beta_t goes out. VG_BWD: lse
// is the clamped lse0, c_r[j] = (gate_r == sk[j]) when gated (f32
// equality), and beside the chain, with m = mask_r > 0:
//   d_obs[r]   = exp(alpha_r + beta_r - ll) * m
//   d_A[i][j] += exp(alpha_{r-1}[i] + c_r[j] A[i][j] + e[j] - ll)
//                [* c_r[j] when gated] * m          (in r = T-1 .. 1 order)
//   d_pi = gamma_0 = exp(alpha_0 + beta_0 - ll), d_obs[0] = gamma_0 *
//   (mask_0 > 0).
// Every operation is the plain version's (cuda_semiring.py::beta_plain,
// vg_bwd_plain) in its order: the exponentials summed in index order,
// the d_A terms added in the walk's order, no atomics, so the kernel is
// bitwise equal to its plain version. (nvcc contracts c * A + e and
// xi * m into fused multiply-adds; c and m are 0 or 1, so each product
// is exact and the fused result is the plain version's.)
//
// Layout: batch-minor, lane n fastest — A [K,K,N], obs/alpha/beta/d_obs
// [T,K,N], mask/gate [T,N], sk/d_pi [K,N], ll [N], d_A [K,K,N].
//
// Thread mapping (lane_group.cuh), K <= 32 (above, wide_core.cuh's
// block a lane): a group of G threads owns a lane;
// thread i owns beta[i], the row A[i, :], and in VG_BWD the row d_A[i, :]
// of the sums, in registers. Each step thread i computes its e[i] and
// gathers e[0..K-1] from the group with __shfl_sync, then its own
// beta[i]; a masked step is a select. 64-thread blocks: N = 512 lanes at
// K = 4 spread over 32 SMs, N = 8192 put four blocks on an SM.
//
// What bounds it: the T-step chain within a lane (a gather, K adds, the
// max, K exponentials, the ordered sum and a logarithm a step), as in
// ffbs_fwd.cu: the bytes (obs, mask, gate and alpha in, beta or d_obs out)
// are few. The design takes from ffbs_fwd.cu what was found there: the
// per-step inputs go through a shared-memory ring of kStages stages of
// kChunk steps, filled backward in time with cp.async by each thread for
// its own column, kStages - 1 chunks ahead of the step that reads it
// (cp.async.wait_group), so no step waits on a device-memory round trip
// (a register ring does: every load in flight shares one scoreboard).
// The Baum-Welch sums stay in the recursion's threads: thread i adds
// d_A[i][:] in the walk's order, and its K exponentials a step depend on
// e but feed nothing on the chain, so they fill the chain's latency
// (PERF.md has the timing of the kernel with and without them).

#pragma once

#include "lane_group.cuh"

namespace hhmm {

constexpr int kBetaBlock = 64;   // threads a block
constexpr int kBetaChunk = 8;    // steps a ring stage
constexpr int kBetaStages = 3;   // ring stages; chunks in flight: kBetaStages - 1

// VG: VG_BWD's mode (clamped lse0, d_pi / d_A / d_obs out); else BETA's
// (guarded safe_lse, ungated, beta out). GATED only with VG.
template <int K, bool VG, bool GATED>
__global__ void __launch_bounds__(kBetaBlock)
beta_kernel(const float* __restrict__ A, const float* __restrict__ obs,
            const float* __restrict__ mask, const float* __restrict__ gate,
            const float* __restrict__ sk, const float* __restrict__ alpha,
            const float* __restrict__ ll_in, float* __restrict__ beta_out,
            float* __restrict__ d_pi, float* __restrict__ d_A,
            float* __restrict__ d_obs, int T, int N) {
  static_assert(VG || !GATED, "the guarded beta is ungated");
  constexpr int LPW = Group<K>::kLanesPerWarp;
  constexpr int kStages = kBetaStages, kChunk = kBetaChunk, kBlock = kBetaBlock;
  const int wl = threadIdx.x & 31;
  const int l = wl % LPW;  // lane within the warp
  const int i = wl / LPW;  // state owned by this thread
  const int n = (blockIdx.x * (kBlock / 32) + threadIdx.x / 32) * LPW + l;
  // every thread of a warp takes part in the shuffles; only these own a
  // value to load and store
  const bool live = n < N && i < K;
  const size_t sN = static_cast<size_t>(N);
  const size_t step = static_cast<size_t>(K) * sN;  // row stride of [T, K, N]

  float arow[K], skr[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    arow[j] = live ? A[(i * K + j) * sN + n] : 0.0f;
    skr[j] = (GATED && live) ? sk[j * sN + n] : 0.0f;
  }
  const float ll = (VG && live) ? ll_in[n] : 0.0f;
  const size_t last = static_cast<size_t>(T - 1) * step + i * sN + n;

  float beta = 0.0f;
  float dA[K];
#pragma unroll
  for (int j = 0; j < K; ++j) dA[j] = 0.0f;
  float a_cur = 0.0f;  // VG: alpha_r[i] of the coming step
  if (live) {
    if (VG) a_cur = alpha[last];
    else beta_out[last] = 0.0f;
  }

  // the ring: stage st holds chunk c (steps c * kChunk .., rows T-1 -
  // c * kChunk ..) for every c = st mod kStages; each thread copies and
  // reads only its own column
  __shared__ float s_obs[kStages][kChunk][kBlock];
  __shared__ float s_mask[kStages][kChunk][kBlock];
  __shared__ float s_gate[GATED ? kStages : 1][kChunk][kBlock];
  __shared__ float s_alpha[VG ? kStages : 1][kChunk][kBlock];
  const int tid = threadIdx.x;
  const int S = T - 1;                         // steps of the walk
  const int full = S / kChunk;                 // chunks of kChunk steps
  const int chunks = (S + kChunk - 1) / kChunk;  // and a partial one
  // copy chunk c into its stage: one group, empty past the last chunk
  auto issue = [&](int c) {
    const int st = c % kStages;
    const int r0 = T - 1 - c * kChunk;
    if (live && c < chunks) {
      const float* o = obs + (static_cast<size_t>(r0) * K + i) * sN + n;
      const float* m = mask + static_cast<size_t>(r0) * sN + n;
      const float* g = GATED ? gate + static_cast<size_t>(r0) * sN + n : nullptr;
      const float* a = VG ? alpha + (static_cast<size_t>(r0 - 1) * K + i) * sN + n : nullptr;
      const int valid = c < full ? kChunk : S - c * kChunk;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < valid) {
          cp_async4(&s_obs[st][k][tid], o);
          cp_async4(&s_mask[st][k][tid], m);
          if (GATED) cp_async4(&s_gate[GATED ? st : 0][k][tid], g);
          if (VG) cp_async4(&s_alpha[VG ? st : 0][k][tid], a);
        }
        o -= step;
        m -= sN;
        if (GATED) g -= sN;
        if (VG) a -= step;
      }
    }
    cp_async_commit();
  };
  // d_obs row r (VG) or beta row r - 1 (BETA) of the walk's first step
  float* dst = (VG ? d_obs + last : beta_out + last - step);
  // one step from stage st, slot k
  auto run = [&](int st, int k) {
    const float m = s_mask[st][k][tid];
    float e[K];
    gather<K>(e, s_obs[st][k][tid] + beta, l);
    float nb;
    if constexpr (VG) {
      const float m01 = (m > 0.0f) ? 1.0f : 0.0f;
      if (live) *dst = expf(a_cur + beta - ll) * m01;
      const float a_prev = s_alpha[VG ? st : 0][k][tid];
      float c[K], x[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        c[j] = GATED ? ((s_gate[GATED ? st : 0][k][tid] == skr[j]) ? 1.0f : 0.0f) : 1.0f;
        const float ag = GATED ? arow[j] * c[j] : arow[j];
        x[j] = ag + e[j];
        float xi = expf(a_prev + ag + e[j] - ll);
        if (GATED) xi = xi * c[j];
        dA[j] += xi * m01;
      }
      nb = lse0<K>(x);
      a_cur = a_prev;
    } else {
      float x[K];
#pragma unroll
      for (int j = 0; j < K; ++j) x[j] = arow[j] + e[j];
      nb = safe_lse<K>(x);
    }
    beta = (m > 0.0f) ? nb : beta;
    if (!VG && live) *dst = beta;
    dst -= step;
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  for (int c = 0; c < full; ++c) {
    issue(c + kStages - 1);        // into the stage of chunk c - 1, already run
    cp_async_wait<kStages - 1>();  // chunk c has landed
    const int st = c % kStages;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) run(st, k);
  }
  if (full < chunks) {  // the partial chunk, uniform across the block
    cp_async_wait<0>();
    const int st = full % kStages;
    const int valid = S - full * kChunk;
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (k < valid) run(st, k);
  }

  if (VG && live) {
    const float g0 = expf(a_cur + beta - ll);  // a_cur is alpha_0[i] here
    d_pi[i * sN + n] = g0;
    d_obs[i * sN + n] = g0 * ((mask[n] > 0.0f) ? 1.0f : 0.0f);
#pragma unroll
    for (int j = 0; j < K; ++j) d_A[(i * K + j) * sN + n] = dA[j];
  }
}

template <int K, bool VG, bool GATED>
int launch_beta(const float* A, const float* obs, const float* mask,
                const float* gate, const float* sk, const float* alpha,
                const float* ll, float* beta, float* d_pi, float* d_A,
                float* d_obs, int T, int N, cudaStream_t stream) {
  constexpr int lanes = kBetaBlock / Group<K>::G;
  const int grid = (N + lanes - 1) / lanes;
  beta_kernel<K, VG, GATED><<<grid, kBetaBlock, 0, stream>>>(
      A, obs, mask, gate, sk, alpha, ll, beta, d_pi, d_A, d_obs, T, N);
  return 0;
}

}  // namespace hhmm
