// The semiring recursions above K = 128, where a lane's A (K^2 floats,
// 128 KB at K = 180) no longer sits in shared memory beside the rest:
// the forward modes (FWD clamped and gated or not, FILTER guarded,
// VITERBI max-plus) and the beta modes (BETA guarded, VG_BWD clamped
// with the Baum-Welch sums), each with wide_core.cuh's arithmetic in the
// same order, so that each is bitwise equal to its plain version
// (cuda_semiring.py::*_plain) at every K above 128, as the wide kernels
// are at K in 33..128. Those kernels stay as they are for K <= 128.
//
// A block a lane, as wide_core.cuh: min(32 ceil(K / 32), 1024) threads,
// thread j owning states j, j + blockDim, ... (one state each up to K =
// 1024; a loop of ceil(K / blockDim) rounds above, every thread taking
// part in every round, so the shuffles see whole warps). What changes:
// - A lives in global memory: the launcher takes a stream-ordered
//   scratch of N K^2 floats (VG_BWD: twice that, for d_A) with
//   cudaMallocAsync from the device's default pool (kept mapped, see
//   big_keep_pool) and frees it after the launch; the kernel first
//   copies its lane's A out of the [K, K, N] lane layout into its slice,
//   laid out as wide_core.cuh lays out shared memory (the forward modes
//   column-readable, A[i][j] at [i K + j]; the beta modes transposed,
//   A[i][j] at [j K + i]), so a warp's 32 reads of a step of i are 128
//   consecutive bytes, served from L1 or L2 at these sizes;
// - VG_BWD's d_A lives in the second scratch half, in the beta layout:
//   thread i adds its own row d_A[i][:] in the walk's order, as in
//   shared memory at K <= 128 (no atomics), and copies it out at the end;
// - the per-step inputs (obs of the thread's state, mask, gate, alpha)
//   are plain loads, no cp.async ring: a step reads K of them against
//   K^2 reads of A;
// - shared memory keeps the step's vector (alpha, delta or e = obs +
//   beta) in two buffers of K floats, so one __syncthreads() a step
//   suffices, as in wide_core.cuh; the beta modes keep each state's beta
//   carry (and, gated, sk) there too, a slot a state.
// Max-plus maps: byte fields up to K = 256 (P = 4 states a word, as
// above 16), 16-bit fields above (a pointer to state 256 or more needs a
// ninth bit: P = 2, W = ceil(K / 2)); thread j's field ORed with its
// neighbours' by __shfl_xor_sync (the P fields of a word are P
// consecutive threads of one warp in every round), the thread of the
// word's first state storing it.
//
// What bounds it: per step and lane K^2 reads of A (each a 128-byte row
// of 32 states) and K^2 exponentials, against the same chain of T steps
// as wide_core.cuh. A simple design: whether A should return to shared
// memory while it fits is not measured.

#pragma once

#include <stdint.h>

#include "lane_group.cuh"
#include "wide_core.cuh"

namespace hhmm {

constexpr int kBigMaxThreads = 1024;  // threads a block: a state each up to K = 1024
constexpr int kMaxByteK = 256;        // byte map fields up to here, 16-bit fields above

// threads a block: whole warps, a thread a state, 1024 at most
__host__ __device__ constexpr int big_threads(int K) {
  return wide_threads(K) < kBigMaxThreads ? wide_threads(K) : kBigMaxThreads;
}

// bits a field of a packed map above K = 16
__host__ __device__ constexpr int map_field_bits(int K) { return K <= kMaxByteK ? 8 : 16; }

// MODE: kClamped (FWD: ll and the alpha residual out, gated when GATED),
// kGuarded (FILTER) or kMaxPlus (VITERBI: score, dlast and the maps out),
// as wide_forward_kernel (wide_core.cuh) at K <= 128. gA: this block's
// lane at gA + n K^2.
template <int MODE, bool GATED>
__global__ void __launch_bounds__(kBigMaxThreads)
big_forward_kernel(int K, const float* __restrict__ pi, const float* __restrict__ A,
                   const float* __restrict__ obs, const float* __restrict__ mask,
                   const float* __restrict__ gate, const float* __restrict__ sk,
                   float* __restrict__ lane_out, float* __restrict__ alpha_out,
                   float* __restrict__ dlast, uint32_t* __restrict__ back,
                   float* __restrict__ scratch, int T, int N) {
  static_assert(MODE == kClamped || !GATED, "only the clamped mode is gated");
  constexpr bool MAXPLUS = MODE == kMaxPlus;
  extern __shared__ __align__(16) float big_smem[];
  float* sv = big_smem;  // the vector's two buffers
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int n = blockIdx.x;
  const size_t sN = static_cast<size_t>(N);
  const size_t KK = static_cast<size_t>(K) * K;
  float* gA = scratch + static_cast<size_t>(n) * KK;  // A[i][j] at gA[i K + j]
  const size_t step = static_cast<size_t>(K) * sN;    // obs/alpha row stride
  const int B = map_field_bits(K);
  const int P = 32 / B;                               // states a word
  const int W = (K + P - 1) / P;                      // map words a step
  const size_t wstep = static_cast<size_t>(W) * sN;   // map row stride
  const int rounds = (K + bd - 1) / bd;

  for (size_t e = tid; e < KK; e += bd) gA[e] = A[e * sN + n];
  for (int j = tid; j < K; j += bd) {
    const float p = pi[j * sN + n];
    float c;
    if constexpr (MAXPLUS) {
      c = p + obs[j * sN + n];
    } else {
      c = mask[n] > 0.0f ? p + obs[j * sN + n] : p;
      alpha_out[j * sN + n] = c;
    }
    sv[j] = c;
  }
  if constexpr (MAXPLUS) {  // back_0: the identity map
    for (int q = tid; q < W; q += bd) {
      uint32_t word = 0;
      for (int p = 0; p < P && q * P + p < K; ++p)
        word |= static_cast<uint32_t>(q * P + p) << (B * p);
      back[q * sN + n] = word;
    }
  }
  __syncthreads();  // A and the first vector

  for (int t = 1; t < T; ++t) {
    const float* v = sv + ((t - 1) & 1) * K;
    float* w = sv + (t & 1) * K;
    const bool valid = mask[t * sN + n] > 0.0f;
    const float gt = GATED ? gate[t * sN + n] : 0.0f;
    for (int r = 0; r < rounds; ++r) {
      const int j = r * bd + tid;
      const bool live = j < K;
      if constexpr (MAXPLUS) {
        int arg = 0;
        if (live) {
          float best = v[0] + gA[j];
          for (int i = 1; i < K; ++i) {
            const float x = v[i] + gA[static_cast<size_t>(i) * K + j];
            if (x > best) {
              best = x;
              arg = i;
            }
          }
          const float nw = best + obs[t * step + j * sN + n];
          w[j] = valid ? nw : v[j];
        }
        // j % P == tid % P: every round starts at a multiple of 32
        uint32_t word = live ? static_cast<uint32_t>(valid ? arg : j) << (B * (j % P)) : 0u;
        word |= __shfl_xor_sync(kFull, word, 1);
        if (P == 4) word |= __shfl_xor_sync(kFull, word, 2);
        if (live && j % P == 0) back[t * wstep + (j / P) * sN + n] = word;
      } else if (live) {
        const float g = GATED ? ((gt == sk[j * sN + n]) ? 1.0f : 0.0f) : 1.0f;
        const float s = wide_lse<MODE == kGuarded>(
            [&](int i) { return v[i] + gA[static_cast<size_t>(i) * K + j] * g; }, K);
        const float nw = s + obs[t * step + j * sN + n];
        const float c = valid ? nw : v[j];
        alpha_out[t * step + j * sN + n] = c;
        w[j] = c;
      }
    }
    __syncthreads();
  }

  // the last vector, c_{T-1}, is in buffer (T - 1) & 1
  const float* fin = sv + ((T - 1) & 1) * K;
  if constexpr (MAXPLUS) {
    for (int j = tid; j < K; j += bd) dlast[j * sN + n] = fin[j];
    if (tid == 0) {
      float best = fin[0];
      for (int i = 1; i < K; ++i) best = fmaxf(best, fin[i]);
      lane_out[n] = best;
    }
  } else if (tid == 0) {
    lane_out[n] = wide_lse<MODE == kGuarded>([&](int i) { return fin[i]; }, K);
  }
}

// VG: VG_BWD's mode (clamped lse0, d_pi / d_A / d_obs out), else BETA's
// (guarded, ungated, beta out), as wide_beta_kernel (wide_core.cuh) at K
// <= 128. scratch: this block's A at scratch + n K^2 and, for VG, its d_A
// at scratch + (N + n) K^2.
template <bool VG, bool GATED>
__global__ void __launch_bounds__(kBigMaxThreads)
big_beta_kernel(int K, const float* __restrict__ A, const float* __restrict__ obs,
                const float* __restrict__ mask, const float* __restrict__ gate,
                const float* __restrict__ sk, const float* __restrict__ alpha,
                const float* __restrict__ ll_in, float* __restrict__ beta_out,
                float* __restrict__ d_pi, float* __restrict__ d_A,
                float* __restrict__ d_obs, float* __restrict__ scratch, int T, int N) {
  static_assert(VG || !GATED, "the guarded beta is ungated");
  extern __shared__ __align__(16) float big_smem[];
  float* se = big_smem;  // e's two buffers
  float* sb = se + 2 * K;  // beta, a slot a state
  float* ssk = sb + K;   // VG gated: sk[j]
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int n = blockIdx.x;
  const size_t sN = static_cast<size_t>(N);
  const size_t KK = static_cast<size_t>(K) * K;
  const size_t step = static_cast<size_t>(K) * sN;
  float* gA = scratch + static_cast<size_t>(n) * KK;                 // A[i][j] at gA[j K + i]
  float* gdA = VG ? scratch + (sN + n) * KK : nullptr;               // d_A[i][j] at gdA[j K + i]
  const int rounds = (K + bd - 1) / bd;

  for (size_t e = tid; e < KK; e += bd) {
    gA[(e % K) * K + e / K] = A[e * sN + n];
    if (VG) gdA[e] = 0.0f;
  }
  for (int i = tid; i < K; i += bd) {
    sb[i] = 0.0f;
    if (GATED) ssk[i] = sk[i * sN + n];
    if (!VG) beta_out[(T - 1) * step + i * sN + n] = 0.0f;
  }
  const float ll = VG ? ll_in[n] : 0.0f;
  __syncthreads();  // A, sk, the zeroed d_A

  // step s: row r = T - 1 - s; writes e into buffer s & 1, reads it
  // after the barrier
  for (int s = 0; s < T - 1; ++s) {
    const int r = T - 1 - s;
    const float m = mask[r * sN + n];
    float* e = se + (s & 1) * K;
    for (int i = tid; i < K; i += bd) e[i] = obs[r * step + i * sN + n] + sb[i];
    __syncthreads();
    for (int q = 0; q < rounds; ++q) {
      const int i = q * bd + tid;
      if (i >= K) continue;
      float beta = sb[i];
      float nb;
      if constexpr (VG) {
        const float m01 = (m > 0.0f) ? 1.0f : 0.0f;
        d_obs[r * step + i * sN + n] = expf(alpha[r * step + i * sN + n] + beta - ll) * m01;
        const float a_prev = alpha[(r - 1) * step + i * sN + n];
        const float gt = GATED ? gate[r * sN + n] : 0.0f;
        float mx = -INFINITY;
        for (int j = 0; j < K; ++j) {
          const float cj = GATED ? ((gt == ssk[j]) ? 1.0f : 0.0f) : 1.0f;
          const float a = gA[static_cast<size_t>(j) * K + i];
          const float ag = GATED ? a * cj : a;
          mx = j == 0 ? ag + e[j] : fmaxf(mx, ag + e[j]);
          float xi = expf(a_prev + ag + e[j] - ll);
          if (GATED) xi = xi * cj;
          gdA[static_cast<size_t>(j) * K + i] += xi * m01;
        }
        mx = fmaxf(mx, kClamp);
        float sum = 0.0f;
        for (int j = 0; j < K; ++j) {
          const float cj = GATED ? ((gt == ssk[j]) ? 1.0f : 0.0f) : 1.0f;
          const float a = gA[static_cast<size_t>(j) * K + i];
          const float ag = GATED ? a * cj : a;
          sum += expf(ag + e[j] - mx);
        }
        nb = mx + logf(sum);
      } else {
        nb = wide_lse<true>(
            [&](int j) { return gA[static_cast<size_t>(j) * K + i] + e[j]; }, K);
      }
      beta = (m > 0.0f) ? nb : beta;
      sb[i] = beta;
      if (!VG) beta_out[(r - 1) * step + i * sN + n] = beta;
    }
  }

  if (VG) {
    for (int i = tid; i < K; i += bd) {
      const float g0 = expf(alpha[i * sN + n] + sb[i] - ll);
      d_pi[i * sN + n] = g0;
      d_obs[i * sN + n] = g0 * ((mask[n] > 0.0f) ? 1.0f : 0.0f);
      for (int j = 0; j < K; ++j)
        d_A[(static_cast<size_t>(i) * K + j) * sN + n] = gdA[static_cast<size_t>(j) * K + i];
    }
  }
}

// the device's default stream-ordered pool keeps what it has mapped
// across synchronizations (its release threshold raised once a process):
// otherwise every synchronization hands the scratch back, and the next
// launch maps it anew on the host before it can be queued
inline int big_keep_pool() {
  static const int rc = [] {
    int dev = 0;
    cudaMemPool_t pool;
    int r = static_cast<int>(cudaGetDevice(&dev));
    if (r == 0) r = static_cast<int>(cudaDeviceGetDefaultMemPool(&pool, dev));
    unsigned long long keep = ~0ull;
    if (r == 0)
      r = static_cast<int>(
          cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep));
    return r;
  }();
  return rc;
}

// a stream-ordered scratch of `floats` floats for one launch; freed by
// big_free after the launch, on the same stream
inline int big_scratch(float** p, size_t floats, cudaStream_t stream) {
  const int rc = big_keep_pool();
  if (rc != 0) return rc;
  return static_cast<int>(
      cudaMallocAsync(reinterpret_cast<void**>(p), sizeof(float) * floats, stream));
}

inline int big_free(float* p, int rc, cudaStream_t stream) {
  const int rf = static_cast<int>(cudaFreeAsync(p, stream));
  return rc != 0 ? rc : rf;
}

template <int MODE, bool GATED>
int launch_big_forward(int K, const float* pi, const float* A, const float* obs,
                       const float* mask, const float* gate, const float* sk, float* lane_out,
                       float* alpha, float* dlast, uint32_t* back, int T, int N,
                       cudaStream_t stream) {
  float* scratch = nullptr;
  int rc = big_scratch(&scratch, static_cast<size_t>(N) * K * K, stream);
  if (rc != 0) return rc;
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(K);
  rc = wide_launch_setup<big_forward_kernel<MODE, GATED>>(smem);
  if (rc == 0)
    big_forward_kernel<MODE, GATED><<<N, big_threads(K), smem, stream>>>(
        K, pi, A, obs, mask, gate, sk, lane_out, alpha, dlast, back, scratch, T, N);
  return big_free(scratch, rc, stream);
}

template <bool VG, bool GATED>
int launch_big_beta(int K, const float* A, const float* obs, const float* mask,
                    const float* gate, const float* sk, const float* alpha, const float* ll,
                    float* beta, float* d_pi, float* d_A, float* d_obs, int T, int N,
                    cudaStream_t stream) {
  float* scratch = nullptr;
  int rc = big_scratch(&scratch, (VG ? 2 : 1) * static_cast<size_t>(N) * K * K, stream);
  if (rc != 0) return rc;
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(K);
  rc = wide_launch_setup<big_beta_kernel<VG, GATED>>(smem);
  if (rc == 0)
    big_beta_kernel<VG, GATED><<<N, big_threads(K), smem, stream>>>(
        K, A, obs, mask, gate, sk, alpha, ll, beta, d_pi, d_A, d_obs, scratch, T, N);
  return big_free(scratch, rc, stream);
}

}  // namespace hhmm
