// The semiring recursions above K = 32, where a warp no longer holds a
// lane: one layout for every mode of the forward core (fwd_core.cuh:
// FWD clamped and gated or not, FILTER guarded, VITERBI max-plus) and of
// the beta core (beta_core.cuh: BETA guarded, VG_BWD clamped with the
// Baum-Welch sums), with the same arithmetic in the same order, so that
// each is bitwise equal to its plain version (cuda_semiring.py::*_plain)
// at every K in 33..128, as the group kernels are at K <= 32. Those
// headers have the recursions; this one has the layout.
//
// A block a lane: ceil(K / 32) warps, thread j owns state j (threads K
// .. 32 ceil(K / 32) - 1 idle in the arithmetic, present at every barrier
// and shuffle). K is a runtime argument: the reductions over K are loops
// over shared memory, not register arrays, so one instantiation a mode
// serves every K (no per-K template: the build stays as short as the
// group kernels').
//
// Shared memory, dynamic (wide_launch_setup opts in past 48 KB of static
// and dynamic together), per block:
// - the lane's A, K^2 floats (64 KB at K = 128). The forward modes read
//   column j (A[i][j] at sA[i K + j]: a warp reads 32 consecutive words a
//   step of i); the beta modes read row i, so A is stored transposed
//   (A[i][j] at sA[j K + i]), again 32 consecutive words;
// - VG_BWD: d_A, K^2 floats in the same transposed layout, thread i
//   adding its own entries d_A[i][:] in the walk's order (no atomics);
// - VG_BWD gated: sk[0..K-1];
// - the step's vector (alpha, delta, or e = obs + beta) in two buffers of
//   K floats. Step t reads buffer (t - 1) & 1 and writes t & 1, so one
//   __syncthreads() a step suffices: the next step's writes go to the
//   buffer every thread finished reading before that barrier.
// The per-step inputs (obs of the thread's state, mask, gate, and for
// VG_BWD alpha) go through the cores' cp.async ring of kWideStages
// stages of kWideChunk steps, each thread copying and reading only its
// own column, kWideStages - 1 chunks ahead of the step that reads it.
//
// Per step and thread: K shared loads of the vector (a broadcast), K of
// A, and K exponentials (clamped, guarded; two passes over i: the max,
// then the ordered sum) or K compares (max-plus; a strict > over
// ascending i, the first argmax, as _argmax0). Max-plus maps: byte
// fields (P = 4 states a word, W = ceil(K / 4) words a step), thread j's
// byte ORed with its three neighbours' by __shfl_xor_sync (the four
// fields of a word are four consecutive threads of one warp), thread 4w
// storing word w.
//
// What bounds it: the T-step chain of a lane, now a barrier, K shared
// loads and K exponentials a step; the bytes (obs in, alpha or maps out,
// T K N floats) read and written with a lane's states N floats apart.

#pragma once

#include <stdint.h>

#include "lane_group.cuh"

namespace hhmm {

constexpr int kWideMaxThreads = kMaxK;  // four warps at K = 128
constexpr int kWideChunk = 8;           // steps a ring stage
constexpr int kWideStages = 3;          // ring stages; chunks in flight: kWideStages - 1

// threads a block: whole warps, a thread a state
__host__ __device__ constexpr int wide_threads(int K) { return (K + 31) / 32 * 32; }

// bytes of dynamic shared memory: A, the vector's two buffers and, for
// VG_BWD, d_A and sk
__host__ __device__ constexpr size_t wide_smem_bytes(int K, bool vg) {
  return sizeof(float) * (static_cast<size_t>(K) * K + 2 * K +
                          (vg ? static_cast<size_t>(K) * K + K : 0));
}

// clamped (lse0) or guarded (safe_lse) logsumexp of x(i) over i < K, in
// the group kernels' order: the max, then the exponentials summed in
// index order (x(i) is evaluated twice and gives the same value twice)
template <bool GUARDED, class X>
__device__ __forceinline__ float wide_lse(X x, int K) {
  float m = x(0);
  for (int i = 1; i < K; ++i) m = fmaxf(m, x(i));
  const bool dead = GUARDED && m == -INFINITY;
  const float ms = GUARDED ? (dead ? 0.0f : m) : fmaxf(m, kClamp);
  float sum = 0.0f;
  for (int i = 0; i < K; ++i) sum += expf(x(i) - ms);
  return dead ? -INFINITY : ms + logf(sum);
}

// the OR of a 32-bit word's four byte fields, one a thread of four
// consecutive threads: every thread of the warp takes part
__device__ __forceinline__ uint32_t or_quad(uint32_t word) {
  word |= __shfl_xor_sync(kFull, word, 1);
  word |= __shfl_xor_sync(kFull, word, 2);
  return word;
}

// MODE: kClamped (FWD: ll and the alpha residual out, gated when GATED),
// kGuarded (FILTER) or kMaxPlus (VITERBI: score, dlast and the maps out),
// as forward_kernel (fwd_core.cuh) at K <= 32.
template <int MODE, bool GATED>
__global__ void __launch_bounds__(kWideMaxThreads)
wide_forward_kernel(int K, const float* __restrict__ pi, const float* __restrict__ A,
                    const float* __restrict__ obs, const float* __restrict__ mask,
                    const float* __restrict__ gate, const float* __restrict__ sk,
                    float* __restrict__ lane_out, float* __restrict__ alpha_out,
                    float* __restrict__ dlast, uint32_t* __restrict__ back, int T, int N) {
  static_assert(MODE == kClamped || !GATED, "only the clamped mode is gated");
  constexpr bool MAXPLUS = MODE == kMaxPlus;
  constexpr int kStages = kWideStages, kChunk = kWideChunk;
  extern __shared__ __align__(16) float wide_smem[];
  float* sA = wide_smem;   // A[i][j] at sA[i K + j]
  float* sv = sA + K * K;  // the vector's two buffers
  const int j = threadIdx.x;
  const int n = blockIdx.x;
  const bool live = j < K;
  const size_t sN = static_cast<size_t>(N);
  const size_t step = static_cast<size_t>(K) * sN;  // obs/alpha row stride
  const int W = (K + 3) / 4;                         // map words a step
  const size_t wstep = static_cast<size_t>(W) * sN;  // map row stride
  const int shift = 8 * (j & 3);

  for (int e = j; e < K * K; e += blockDim.x) sA[e] = A[e * sN + n];
  const float skj = (GATED && live) ? sk[j * sN + n] : 0.0f;
  float c = 0.0f;
  if (live) {
    const float p = pi[j * sN + n];
    if constexpr (MAXPLUS) {
      c = p + obs[j * sN + n];
    } else {
      c = mask[n] > 0.0f ? p + obs[j * sN + n] : p;
      alpha_out[j * sN + n] = c;
    }
    sv[j] = c;
  }
  if constexpr (MAXPLUS) {  // back_0: the identity map
    const uint32_t word = or_quad(live ? static_cast<uint32_t>(j) << shift : 0u);
    if (live && (j & 3) == 0) back[(j >> 2) * sN + n] = word;
  }

  // the ring, as forward_kernel's: stage st holds chunk q (steps 1 + q
  // kChunk ..) for every q = st mod kStages, a column a thread
  __shared__ float s_obs[kStages][kChunk][kWideMaxThreads];
  __shared__ float s_mask[kStages][kChunk][kWideMaxThreads];
  __shared__ float s_gate[GATED ? kStages : 1][kChunk][kWideMaxThreads];
  const int full = (T - 1) / kChunk;
  const int chunks = (T - 1 + kChunk - 1) / kChunk;
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
          cp_async4(&s_obs[st][k][j], o);
          cp_async4(&s_mask[st][k][j], m);
          if (GATED) cp_async4(&s_gate[GATED ? st : 0][k][j], g);
        }
        o += step;
        m += sN;
        if (GATED) g += sN;
      }
    }
    cp_async_commit();
  };
  float* dst = MAXPLUS ? nullptr : alpha_out + j * sN + n + step;
  uint32_t* wdst = MAXPLUS ? back + (j >> 2) * sN + n + wstep : nullptr;
  int t = 1;
  // step t from stage st, slot k: reads buffer (t - 1) & 1, writes t & 1
  auto run = [&](int st, int k) {
    const float* v = sv + ((t - 1) & 1) * K;
    const bool valid = s_mask[st][k][j] > 0.0f;
    if constexpr (MAXPLUS) {
      float best = 0.0f;
      int arg = 0;
      if (live) {
        best = v[0] + sA[j];
        for (int i = 1; i < K; ++i) {
          const float x = v[i] + sA[i * K + j];
          if (x > best) {
            best = x;
            arg = i;
          }
        }
        const float nw = best + s_obs[st][k][j];
        c = valid ? nw : c;
      }
      const uint32_t word =
          or_quad(live ? static_cast<uint32_t>(valid ? arg : j) << shift : 0u);
      if (live && (j & 3) == 0) *wdst = word;
      wdst += wstep;
    } else if (live) {
      const float g = GATED ? ((s_gate[GATED ? st : 0][k][j] == skj) ? 1.0f : 0.0f) : 1.0f;
      const float s = wide_lse<MODE == kGuarded>(
          [&](int i) { return v[i] + sA[i * K + j] * g; }, K);
      const float nw = s + s_obs[st][k][j];
      c = valid ? nw : c;
      *dst = c;
    }
    if (!MAXPLUS) dst += step;
    if (live) sv[(t & 1) * K + j] = c;
    ++t;
    __syncthreads();
  };

  __syncthreads();  // A and the first vector
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int q = 0; q < full; ++q) {
    issue(q + kStages - 1);
    cp_async_wait<kStages - 1>();
    const int st = q % kStages;
#pragma unroll 1
    for (int k = 0; k < kChunk; ++k) run(st, k);
  }
  if (full < chunks) {
    cp_async_wait<0>();
    const int st = full % kStages;
    const int valid = T - 1 - full * kChunk;
#pragma unroll 1
    for (int k = 0; k < valid; ++k) run(st, k);
  }

  // the last vector, c_{T-1}, is in buffer (T - 1) & 1
  const float* fin = sv + ((T - 1) & 1) * K;
  if constexpr (MAXPLUS) {
    if (live) dlast[j * sN + n] = c;
    if (j == 0) {
      float best = fin[0];
      for (int i = 1; i < K; ++i) best = fmaxf(best, fin[i]);
      lane_out[n] = best;
    }
  } else if (j == 0) {
    lane_out[n] = wide_lse<MODE == kGuarded>([&](int i) { return fin[i]; }, K);
  }
}

// VG: VG_BWD's mode (clamped lse0, d_pi / d_A / d_obs out), else BETA's
// (guarded, ungated, beta out), as beta_kernel (beta_core.cuh) at K <= 32.
template <bool VG, bool GATED>
__global__ void __launch_bounds__(kWideMaxThreads)
wide_beta_kernel(int K, const float* __restrict__ A, const float* __restrict__ obs,
                 const float* __restrict__ mask, const float* __restrict__ gate,
                 const float* __restrict__ sk, const float* __restrict__ alpha,
                 const float* __restrict__ ll_in, float* __restrict__ beta_out,
                 float* __restrict__ d_pi, float* __restrict__ d_A,
                 float* __restrict__ d_obs, int T, int N) {
  static_assert(VG || !GATED, "the guarded beta is ungated");
  constexpr int kStages = kWideStages, kChunk = kWideChunk;
  extern __shared__ __align__(16) float wide_smem[];
  float* sA = wide_smem;     // A[i][j] at sA[j K + i]
  float* se = sA + K * K;    // e's two buffers
  float* sdA = se + 2 * K;   // VG: d_A[i][j] at sdA[j K + i]
  float* ssk = sdA + K * K;  // VG gated: sk[j]
  const int i = threadIdx.x;
  const int n = blockIdx.x;
  const bool live = i < K;
  const size_t sN = static_cast<size_t>(N);
  const size_t step = static_cast<size_t>(K) * sN;

  for (int e = i; e < K * K; e += blockDim.x) {
    sA[(e % K) * K + e / K] = A[e * sN + n];
    if (VG) sdA[e] = 0.0f;
  }
  if (GATED)
    for (int j = i; j < K; j += blockDim.x) ssk[j] = sk[j * sN + n];
  const float ll = (VG && live) ? ll_in[n] : 0.0f;
  const size_t last = static_cast<size_t>(T - 1) * step + i * sN + n;
  float beta = 0.0f;
  float a_cur = 0.0f;  // VG: alpha_r[i] of the coming step
  if (live) {
    if (VG) a_cur = alpha[last];
    else beta_out[last] = 0.0f;
  }

  // the ring, as beta_kernel's: filled backward in time, a column a thread
  __shared__ float s_obs[kStages][kChunk][kWideMaxThreads];
  __shared__ float s_mask[kStages][kChunk][kWideMaxThreads];
  __shared__ float s_gate[GATED ? kStages : 1][kChunk][kWideMaxThreads];
  __shared__ float s_alpha[VG ? kStages : 1][kChunk][kWideMaxThreads];
  const int S = T - 1;
  const int full = S / kChunk;
  const int chunks = (S + kChunk - 1) / kChunk;
  auto issue = [&](int q) {
    const int st = q % kStages;
    const int r0 = T - 1 - q * kChunk;
    if (live && q < chunks) {
      const float* o = obs + (static_cast<size_t>(r0) * K + i) * sN + n;
      const float* m = mask + static_cast<size_t>(r0) * sN + n;
      const float* g = GATED ? gate + static_cast<size_t>(r0) * sN + n : nullptr;
      const float* a = VG ? alpha + (static_cast<size_t>(r0 - 1) * K + i) * sN + n : nullptr;
      const int valid = q < full ? kChunk : S - q * kChunk;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < valid) {
          cp_async4(&s_obs[st][k][i], o);
          cp_async4(&s_mask[st][k][i], m);
          if (GATED) cp_async4(&s_gate[GATED ? st : 0][k][i], g);
          if (VG) cp_async4(&s_alpha[VG ? st : 0][k][i], a);
        }
        o -= step;
        m -= sN;
        if (GATED) g -= sN;
        if (VG) a -= step;
      }
    }
    cp_async_commit();
  };
  float* dst = VG ? d_obs + last : beta_out + last - step;
  int s = 0;  // the walk's step: row r = T - 1 - s
  // one step from stage st, slot k: writes e into buffer s & 1, reads it
  // after the barrier
  auto run = [&](int st, int k) {
    const float m = s_mask[st][k][i];
    float* e = se + (s & 1) * K;
    if (live) e[i] = s_obs[st][k][i] + beta;
    __syncthreads();
    if (live) {
      float nb;
      if constexpr (VG) {
        const float m01 = (m > 0.0f) ? 1.0f : 0.0f;
        *dst = expf(a_cur + beta - ll) * m01;
        const float a_prev = s_alpha[VG ? st : 0][k][i];
        const float gt = GATED ? s_gate[GATED ? st : 0][k][i] : 0.0f;
        float mx = -INFINITY;
        for (int j = 0; j < K; ++j) {
          const float cj = GATED ? ((gt == ssk[j]) ? 1.0f : 0.0f) : 1.0f;
          const float ag = GATED ? sA[j * K + i] * cj : sA[j * K + i];
          mx = j == 0 ? ag + e[j] : fmaxf(mx, ag + e[j]);
          float xi = expf(a_prev + ag + e[j] - ll);
          if (GATED) xi = xi * cj;
          sdA[j * K + i] += xi * m01;
        }
        mx = fmaxf(mx, kClamp);
        float sum = 0.0f;
        for (int j = 0; j < K; ++j) {
          const float cj = GATED ? ((gt == ssk[j]) ? 1.0f : 0.0f) : 1.0f;
          const float ag = GATED ? sA[j * K + i] * cj : sA[j * K + i];
          sum += expf(ag + e[j] - mx);
        }
        nb = mx + logf(sum);
        a_cur = a_prev;
      } else {
        nb = wide_lse<true>([&](int j) { return sA[j * K + i] + e[j]; }, K);
      }
      beta = (m > 0.0f) ? nb : beta;
      if (!VG) *dst = beta;
    }
    dst -= step;
    ++s;
  };

  __syncthreads();  // A (and sk, the zeroed d_A)
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int q = 0; q < full; ++q) {
    issue(q + kStages - 1);
    cp_async_wait<kStages - 1>();
    const int st = q % kStages;
#pragma unroll 1
    for (int k = 0; k < kChunk; ++k) run(st, k);
  }
  if (full < chunks) {
    cp_async_wait<0>();
    const int st = full % kStages;
    const int valid = S - full * kChunk;
#pragma unroll 1
    for (int k = 0; k < valid; ++k) run(st, k);
  }

  if (VG && live) {
    const float g0 = expf(a_cur + beta - ll);  // a_cur is alpha_0[i] here
    d_pi[i * sN + n] = g0;
    d_obs[i * sN + n] = g0 * ((mask[n] > 0.0f) ? 1.0f : 0.0f);
    for (int j = 0; j < K; ++j) d_A[(static_cast<size_t>(i) * K + j) * sN + n] = sdA[j * K + i];
  }
}

// lets kKernel take `smem` bytes of dynamic shared memory: past 48 KB of
// static and dynamic together a kernel must opt in, so its limit is
// raised to the largest size asked for so far (one call per new size)
template <auto kKernel>
int wide_launch_setup(size_t smem) {
  static size_t allowed = 0;
  if (smem <= allowed) return 0;
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (rc == 0) allowed = smem;
  return rc;
}

template <int MODE, bool GATED>
int launch_wide_forward(int K, const float* pi, const float* A, const float* obs,
                        const float* mask, const float* gate, const float* sk, float* lane_out,
                        float* alpha, float* dlast, uint32_t* back, int T, int N,
                        cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(K, false);
  const int rc = wide_launch_setup<wide_forward_kernel<MODE, GATED>>(smem);
  if (rc != 0) return rc;
  wide_forward_kernel<MODE, GATED><<<N, wide_threads(K), smem, stream>>>(
      K, pi, A, obs, mask, gate, sk, lane_out, alpha, dlast, back, T, N);
  return 0;
}

template <bool VG, bool GATED>
int launch_wide_beta(int K, const float* A, const float* obs, const float* mask,
                     const float* gate, const float* sk, const float* alpha, const float* ll,
                     float* beta, float* d_pi, float* d_A, float* d_obs, int T, int N,
                     cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(K, VG);
  const int rc = wide_launch_setup<wide_beta_kernel<VG, GATED>>(smem);
  if (rc != 0) return rc;
  wide_beta_kernel<VG, GATED><<<N, wide_threads(K), smem, stream>>>(
      K, A, obs, mask, gate, sk, alpha, ll, beta, d_pi, d_A, d_obs, T, N);
  return 0;
}

}  // namespace hhmm
