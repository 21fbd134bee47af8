// FFBS pass 2: backward sampling by inverse CDF against pre-drawn
// uniforms, reading the forward pass's alpha residual.
//
// Replaces: hhmm_tpu/kernels/pallas_semiring.py::_bwd_sample_kernel
// (line 584), launched by its pallas_call at line 801 in semiring_ffbs.
// The TPU kernel walks reversed (batch tile, time block) grid steps and
// carries z and the successor's mask/gate rows across blocks in VMEM
// scratch (the zc/mc/gc carries).
//
// Math, per lane (f32, exactly as the TPU kernel has it):
//   z_{T-1} = invcdf(alpha_{T-1}, u_{T-1})
//   g       = (mask_{t+1} > 0) [* (gate_{t+1} == sk[z_{t+1}]) when gated]
//   z_t     = invcdf(alpha_t + g * A[:, z_{t+1}], u_t)
//   invcdf(l, u): p = exp(l - lse0(l)), a running f32 sum cum over the
//   first K-1 entries, z = #{k : u >= cum_k}  (_sample_invcdf, :169-181).
// A arrives clamped at -1e30 by the wrapper (semiring_ffbs, :783), so
// g * A stays finite; the wrapper also repeats the last valid state over
// the padded tail (:815-819).
//
// The chain is serial only in form: the draw of z_t given z_{t+1} = s
// reads alpha_t, u_t, mask_{t+1}, gate_{t+1}, sk[s] and A[:, s], none of
// which depends on the chain. So the kernel runs in three phases. Up to K
// = 16 (ffbs_bwd_sample_kernel, below), a block owns kLanes lanes and all
// T steps; above (ffbs_bwd_sample_wide_kernel, further below: K up to
// 128, and ffbs_bwd_sample_big_kernel above that), a block owns one lane
// and walks it a chunk at a time.
// - Phase A, parallel over (step, lane) and the block's threads: every
//   candidate map_t[s] = invcdf(alpha_t + g_s * A[:, s], u_t), with
//   g_s = (mask_{t+1} > 0) [* (gate_{t+1} == sk[s])], the arithmetic of
//   the draw above for successor s, so each candidate is bitwise the
//   draw the serial walk would make. The K candidates of a step are
//   packed four bits a state into W = ceil(K / 8) 32-bit words (nibble
//   s % 8 of word s / 8 holds map_t[s]), as semiring_viterbi.cu packs
//   its backpointers; a step's W words are adjacent. The last step's
//   words repeat z_{T-1} in every nibble; the words past it, up to a
//   multiple of kChase steps, are the identity map.
// - Phase B, a thread per lane: z = 0, then for t = T-1 .. 0,
//   z_t = (map_t[z / 8] >> 4 (z % 8)) & 15 (at W = 1 the shift alone).
//   A lane's words are contiguous in t, so the thread reads a chunk of
//   kChase steps with W * kChase / 4 16-byte loads, walks it (a shift
//   and a mask a step, and at W = 2 a select of the word, no branch, no
//   address arithmetic) and writes the chunk's z back over the first
//   word of each step.
// - Phase C: the block copies z out to z [T, N], coalesced.
// __syncthreads() separates the phases. The maps live in shared memory
// (kLanes rows of smem_stride(T) words, 4 W bytes a step and lane, the
// rows padded so that phase A's and phase C's accesses fall in distinct
// banks at W = 1, two ways at W = 2) when a lane's W * map_words(T)
// words fit kSmemMaxWords (T <= 2048 at K <= 8, T <= 1024 above), else
// in an int32 [N, W * map_words(T)] scratch in device memory that the
// wrapper allocates.
//
// Layout: batch-minor as in ffbs_fwd.cu — A [K,K,N], mask/gate/u [T,N],
// alpha [T,K,N], sk [K,N], z [T,N] int32.
//
// What bounds it: at small N the chase, T steps of three dependent
// integer operations (about 12 cycles a step on an H100), after phase
// A's latency; at large N phase A's arithmetic, K inverse-CDF draws a
// step and lane (2K - 1 exponentials and a logarithm each), K times the
// serial walk's but spread over T x N. The bytes (alpha, u, mask: K+2
// floats a step, one int32 out) are few. At K > 8 phase A keeps A[K][K]
// in registers and spills (correct, not tuned: PERF.md has the counts).

#include <cuda_runtime.h>
#include <stdint.h>

#include "big_core.cuh"
#include "lane_group.cuh"
#include "wide_core.cuh"

namespace {

using hhmm::for_k;
using hhmm::kClamp;
// lanes a block: on an H100, 2 is 21 % faster at N = 256 (phase A on
// twice the SMs) and 46 % slower from N = 2048 on (more of every resident
// block idles while its few threads chase); 8 is faster only at N = 8192
constexpr int kLanes = 4;
constexpr int kThreads = 256;  // threads a block
constexpr int kRows = kThreads / kLanes;  // steps a block covers per pass
constexpr int kChase = 32;     // phase B: steps a chunk
constexpr int kSmemMaxWords = 2048;  // a lane's maps in shared memory up to this (33 KB a block)

// steps of a lane's maps: T rounded up to a chunk
__host__ __device__ constexpr int map_words(int T) {
  return (T + kChase - 1) / kChase * kChase;
}

// a lane's row in shared memory: its W words a step, plus a pad that
// puts the kLanes rows of a warp's accesses in distinct banks
__host__ __device__ constexpr int smem_stride(int T, int W) {
  return W * map_words(T) + 32 / kLanes;
}

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
__device__ __forceinline__ int invcdf(const float (&l)[K], float u) {
  float m = l[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = fmaxf(m, l[k]);
  m = fmaxf(m, kClamp);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) s += expf(l[k] - m);
  const float lse = m + logf(s);
  float cum = 0.0f;
  int z = 0;
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    cum += expf(l[k] - lse);
    z += (u >= cum) ? 1 : 0;
  }
  return z;
}

// the inputs of one (step, lane) word of phase A
template <int K>
struct Row {
  float al[K];
  float u, m_next, g_next;
};

template <int K, bool GATED>
__device__ __forceinline__ void load_row(Row<K>& r, const float* __restrict__ alpha,
                                         const float* __restrict__ u,
                                         const float* __restrict__ mask,
                                         const float* __restrict__ gate, int t,
                                         int T, size_t sN, int n) {
  const size_t row = static_cast<size_t>(t);
#pragma unroll
  for (int k = 0; k < K; ++k) r.al[k] = alpha[(row * K + k) * sN + n];
  r.u = u[row * sN + n];
  r.m_next = 0.0f;
  r.g_next = 0.0f;
  if (t + 1 < T) {
    r.m_next = mask[(row + 1) * sN + n];
    if (GATED) r.g_next = gate[(row + 1) * sN + n];
  }
}

template <int K, bool GATED>
__global__ void __launch_bounds__(kThreads)
ffbs_bwd_sample_kernel(const float* __restrict__ A,
                       const float* __restrict__ mask,
                       const float* __restrict__ alpha,
                       const float* __restrict__ u,
                       const float* __restrict__ gate,
                       const float* __restrict__ sk, int* __restrict__ z_out,
                       uint32_t* scratch, int T, int N) {
  extern __shared__ uint32_t smem_maps[];
  constexpr int W = kWords<K>;
  const int l = threadIdx.x % kLanes;
  const int n = blockIdx.x * kLanes + l;
  const bool live = n < N;
  const size_t sN = static_cast<size_t>(N);
  const int chunks = map_words(T) / kChase;
  // this lane's row of map words: step t's W words at W t .. W t + W - 1,
  // t = 0 .. chunks * kChase - 1
  uint32_t* row = scratch ? scratch + static_cast<size_t>(n) * W * map_words(T)
                          : smem_maps + l * smem_stride(T, W);

  // ---- phase A: every candidate draw, packed a step into one word
  if (live) {
    float a[K][K];
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) a[i][j] = A[(i * K + j) * sN + n];
    float skr[K];
#pragma unroll
    for (int j = 0; j < K; ++j) skr[j] = GATED ? sk[j * sN + n] : 0.0f;

    int t = threadIdx.x / kLanes;
    Row<K> cur{}, nxt{};
    if (t < T) load_row<K, GATED>(cur, alpha, u, mask, gate, t, T, sN, n);
    for (; t < chunks * kChase; t += kRows) {
      // the next row's loads are in flight while this row computes
      if (t + kRows < T) load_row<K, GATED>(nxt, alpha, u, mask, gate, t + kRows, T, sN, n);
      uint32_t w[W];
      if (t >= T) {
#pragma unroll
        for (int q = 0; q < W; ++q) w[q] = identity_map<K>(q);
      } else if (t == T - 1) {
        const uint32_t z = static_cast<uint32_t>(invcdf<K>(cur.al, cur.u)) * 0x11111111u;
#pragma unroll
        for (int q = 0; q < W; ++q) w[q] = z;
      } else {
        const float g0 = (cur.m_next > 0.0f) ? 1.0f : 0.0f;
#pragma unroll
        for (int q = 0; q < W; ++q) w[q] = 0;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          float g = g0;
          if (GATED && !(cur.g_next == skr[s])) g = 0.0f;
          float lg[K];
#pragma unroll
          for (int k = 0; k < K; ++k) lg[k] = cur.al[k] + g * a[k][s];
          w[s / 8] |= static_cast<uint32_t>(invcdf<K>(lg, cur.u)) << (4 * (s % 8));
        }
      }
#pragma unroll
      for (int q = 0; q < W; ++q) row[W * t + q] = w[q];
      cur = nxt;
    }
  }
  __syncthreads();

  // ---- phase B: the pointer chase, a thread per lane, a chunk at a time
  if (threadIdx.x < kLanes && live) {
    uint32_t z = 0;
    for (int c = chunks - 1; c >= 0; --c) {
      uint4* words = reinterpret_cast<uint4*>(row + W * c * kChase);
      uint32_t w[W * kChase];  // step k's words at W k .. W k + W - 1
#pragma unroll
      for (int q = 0; q < W * kChase / 4; ++q) {
        const uint4 v = words[q];
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int k = kChase - 1; k >= 0; --k) {
        if constexpr (W == 1) {
          z = (w[k] >> (4u * z)) & 15u;
        } else {
          z = (((z & 8u) ? w[W * k + 1] : w[W * k]) >> (4u * (z & 7u))) & 15u;
        }
        w[W * k] = z;
      }
#pragma unroll
      for (int q = 0; q < W * kChase / 4; ++q)
        words[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    }
  }
  __syncthreads();

  // ---- phase C: z out, the block's kLanes lanes side by side
  if (live) {
    for (int t = threadIdx.x / kLanes; t < T; t += kRows)
      z_out[static_cast<size_t>(t) * sN + n] = static_cast<int>(row[W * t]);
  }
}

// ---- above K = 16: byte-field candidate maps, a block a lane
//
// The same function by the same three phases, in a layout that takes any
// K in 17..128 at runtime: a block owns one lane, thread s (of ceil(K /
// 32) warps) owns successor state s, and the lane's A (K^2 floats) lives
// in shared memory. The block walks the lane backward in chunks of
// kWideChunkSteps steps:
// - it stages the chunk's alpha rows, u, mask_{t+1} and gate_{t+1} in
//   shared memory (plain loads, the whole block);
// - phase A: thread s draws every step's candidate map_t[s] =
//   invcdf(alpha_t + g_s A[:, s], u_t), the arithmetic of the serial
//   draw in the serial order (the max, the exponentials summed in index
//   order, the running cum), K exponentials twice over, and stores it as
//   byte s of the step's map (the maps' byte fields: P = 4 states a word,
//   as VITERBI's above 16, stored here byte by byte); the last step's
//   candidates all equal the draw from alpha_{T-1} (g = 0);
// - phase B: thread 0 chases the chunk's maps, z_t = map_t[z_{t+1}], one
//   shared byte load a step, and writes z_t out;
// while the others stage the next chunk. Maps never leave the chip (a
// chunk's K bytes a step), so there is no device scratch. Shared memory:
// A, kWideChunkSteps (K + 3) floats and kWideChunkSteps K bytes, 84 KB at
// K = 128 (wide_core.cuh's wide_launch_setup: the opt-in past 48 KB).
constexpr int kWideChunkSteps = 32;

__host__ __device__ constexpr size_t wide_bwd_smem_bytes(int K) {
  return sizeof(float) * (static_cast<size_t>(K) * K + kWideChunkSteps * (K + 3)) +
         static_cast<size_t>(kWideChunkSteps) * K;
}

template <bool GATED>
__global__ void __launch_bounds__(hhmm::kMaxK)
ffbs_bwd_sample_wide_kernel(int K, const float* __restrict__ A,
                            const float* __restrict__ mask,
                            const float* __restrict__ alpha,
                            const float* __restrict__ u,
                            const float* __restrict__ gate,
                            const float* __restrict__ sk, int* __restrict__ z_out,
                            int T, int N) {
  extern __shared__ __align__(16) float wide_smem[];
  constexpr int C = kWideChunkSteps;
  float* sA = wide_smem;         // A[k][s] at sA[k K + s]
  float* sal = sA + K * K;       // alpha_t of the chunk's step k at sal[k K ..]
  float* su = sal + C * K;       // u_t
  float* sm = su + C;            // mask_{t+1} (0 at t = T - 1)
  float* sg = sm + C;            // gate_{t+1}
  uint8_t* maps = reinterpret_cast<uint8_t*>(sg + C);  // map_t[s] at maps[k K + s]
  const int s = threadIdx.x;
  const int n = blockIdx.x;
  const bool live = s < K;
  const size_t sN = static_cast<size_t>(N);

  for (int e = s; e < K * K; e += blockDim.x) sA[e] = A[e * sN + n];
  const float sks = (GATED && live) ? sk[s * sN + n] : 0.0f;
  int z = 0;  // thread 0: the chase; the last step's candidates all agree
  const int chunks = (T + C - 1) / C;
  for (int c = 0; c < chunks; ++c) {
    const int top = T - 1 - c * C;                // step of slot 0
    const int valid = top + 1 < C ? top + 1 : C;  // slots k: steps top - k >= 0
    for (int e = s; e < valid * K; e += blockDim.x) {
      const int k = e / K;
      sal[e] = alpha[(static_cast<size_t>(top - k) * K + (e - k * K)) * sN + n];
    }
    for (int k = s; k < valid; k += blockDim.x) {
      const int t = top - k;
      su[k] = u[static_cast<size_t>(t) * sN + n];
      sm[k] = t + 1 < T ? mask[static_cast<size_t>(t + 1) * sN + n] : 0.0f;
      sg[k] = (GATED && t + 1 < T) ? gate[static_cast<size_t>(t + 1) * sN + n] : 0.0f;
    }
    __syncthreads();  // the chunk's inputs; the last chase is done
    if (live) {
      for (int k = 0; k < valid; ++k) {
        float g = sm[k] > 0.0f ? 1.0f : 0.0f;
        if (GATED && !(sg[k] == sks)) g = 0.0f;
        const float* al = sal + k * K;
        float m = al[0] + g * sA[s];
        for (int i = 1; i < K; ++i) m = fmaxf(m, al[i] + g * sA[i * K + s]);
        m = fmaxf(m, kClamp);
        float sum = 0.0f;
        for (int i = 0; i < K; ++i) sum += expf(al[i] + g * sA[i * K + s] - m);
        const float lse = m + logf(sum);
        float cum = 0.0f;
        int draw = 0;
        for (int i = 0; i < K - 1; ++i) {
          cum += expf(al[i] + g * sA[i * K + s] - lse);
          draw += (su[k] >= cum) ? 1 : 0;
        }
        maps[k * K + s] = static_cast<uint8_t>(draw);
      }
    }
    __syncthreads();  // the chunk's maps
    if (s == 0) {
      for (int k = 0; k < valid; ++k) {
        z = maps[k * K + z];
        z_out[static_cast<size_t>(top - k) * sN + n] = z;
      }
    }
  }
}

// ---- above K = 128: the wide kernel's three phases with A in device memory
//
// A lane's A (K^2 floats) goes to a stream-ordered scratch, copied there
// by the block first (A[k][s] at [k K + s], so a warp's reads of a step
// of k are 128 consecutive bytes), as big_core.cuh does for the other
// kernels. A chunk's candidate maps stay in shared memory with the
// chunk's alpha rows, as above, in byte fields up to K = 256 and 16-bit
// fields above (M), and the chunk shrinks with K: C steps such that C (K
// + 3) floats and C K fields fit kBigBwdSmem (32 steps up to K = 510,
// 15 at K = 1024). Thread s owns successor states
// s, s + blockDim, ...; the draw is the same arithmetic in the same
// order, so each candidate, and the chase, are bitwise the plain
// version's.
constexpr size_t kBigBwdSmem = 96 * 1024;

template <class M>
int big_bwd_chunk(int K) {
  const size_t per = sizeof(float) * (static_cast<size_t>(K) + 3) + sizeof(M) * K;
  const size_t c = kBigBwdSmem / per;
  return c < 1 ? 1 : (c > kWideChunkSteps ? kWideChunkSteps : static_cast<int>(c));
}

template <class M>
size_t big_bwd_smem_bytes(int K, int C) {
  return sizeof(float) * static_cast<size_t>(C) * (K + 3) + sizeof(M) * static_cast<size_t>(C) * K;
}

template <bool GATED, class M>
__global__ void __launch_bounds__(hhmm::kBigMaxThreads)
ffbs_bwd_sample_big_kernel(int K, int C, const float* __restrict__ A,
                           const float* __restrict__ mask,
                           const float* __restrict__ alpha,
                           const float* __restrict__ u,
                           const float* __restrict__ gate,
                           const float* __restrict__ sk, int* __restrict__ z_out,
                           float* __restrict__ scratch, int T, int N) {
  extern __shared__ __align__(16) float big_smem[];
  float* sal = big_smem;   // alpha_t of the chunk's step k at sal[k K ..]
  float* su = sal + C * K;  // u_t
  float* sm = su + C;       // mask_{t+1} (0 at t = T - 1)
  float* sg = sm + C;       // gate_{t+1}
  M* maps = reinterpret_cast<M*>(sg + C);  // map_t[s] at maps[k K + s]
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int n = blockIdx.x;
  const size_t sN = static_cast<size_t>(N);
  const size_t KK = static_cast<size_t>(K) * K;
  float* gA = scratch + static_cast<size_t>(n) * KK;  // A[k][s] at gA[k K + s]

  for (size_t e = tid; e < KK; e += bd) gA[e] = A[e * sN + n];
  int z = 0;  // thread 0: the chase; the last step's candidates all agree
  const int chunks = (T + C - 1) / C;
  for (int c = 0; c < chunks; ++c) {
    const int top = T - 1 - c * C;                // step of slot 0
    const int valid = top + 1 < C ? top + 1 : C;  // slots k: steps top - k >= 0
    for (int e = tid; e < valid * K; e += bd) {
      const int k = e / K;
      sal[e] = alpha[(static_cast<size_t>(top - k) * K + (e - k * K)) * sN + n];
    }
    for (int k = tid; k < valid; k += bd) {
      const int t = top - k;
      su[k] = u[static_cast<size_t>(t) * sN + n];
      sm[k] = t + 1 < T ? mask[static_cast<size_t>(t + 1) * sN + n] : 0.0f;
      sg[k] = (GATED && t + 1 < T) ? gate[static_cast<size_t>(t + 1) * sN + n] : 0.0f;
    }
    __syncthreads();  // the chunk's inputs (and A); the last chase is done
    for (int s = tid; s < K; s += bd) {
      const float sks = GATED ? sk[s * sN + n] : 0.0f;
      for (int k = 0; k < valid; ++k) {
        float g = sm[k] > 0.0f ? 1.0f : 0.0f;
        if (GATED && !(sg[k] == sks)) g = 0.0f;
        const float* al = sal + k * K;
        float m = al[0] + g * gA[s];
        for (int i = 1; i < K; ++i) m = fmaxf(m, al[i] + g * gA[static_cast<size_t>(i) * K + s]);
        m = fmaxf(m, kClamp);
        float sum = 0.0f;
        for (int i = 0; i < K; ++i) sum += expf(al[i] + g * gA[static_cast<size_t>(i) * K + s] - m);
        const float lse = m + logf(sum);
        float cum = 0.0f;
        int draw = 0;
        for (int i = 0; i < K - 1; ++i) {
          cum += expf(al[i] + g * gA[static_cast<size_t>(i) * K + s] - lse);
          draw += (su[k] >= cum) ? 1 : 0;
        }
        maps[k * K + s] = static_cast<M>(draw);
      }
    }
    __syncthreads();  // the chunk's maps
    if (tid == 0) {
      for (int k = 0; k < valid; ++k) {
        z = maps[k * K + z];
        z_out[static_cast<size_t>(top - k) * sN + n] = z;
      }
    }
  }
}

template <int K, bool GATED>
int launch(const float* A, const float* mask, const float* alpha,
           const float* u, const float* gate, const float* sk, int* z,
           uint32_t* scratch, int T, int N, cudaStream_t stream) {
  constexpr int W = kWords<K>;
  if (!scratch && W * map_words(T) > kSmemMaxWords) return -1;  // the maps need the scratch
  const int grid = (N + kLanes - 1) / kLanes;
  const size_t smem =
      scratch ? 0 : static_cast<size_t>(smem_stride(T, W)) * kLanes * sizeof(uint32_t);
  ffbs_bwd_sample_kernel<K, GATED><<<grid, kThreads, smem, stream>>>(
      A, mask, alpha, u, gate, sk, z, scratch, T, N);
  return 0;
}

template <int K>
int launch_k(int gated, const float* A, const float* mask, const float* alpha,
             const float* u, const float* gate, const float* sk, int* z,
             uint32_t* scratch, int T, int N, cudaStream_t stream) {
  if (gated)
    return launch<K, true>(A, mask, alpha, u, gate, sk, z, scratch, T, N, stream);
  return launch<K, false>(A, mask, alpha, u, gate, sk, z, scratch, T, N, stream);
}

template <bool GATED>
int launch_wide(int K, const float* A, const float* mask, const float* alpha,
                const float* u, const float* gate, const float* sk, int* z, int T, int N,
                cudaStream_t stream) {
  const size_t smem = wide_bwd_smem_bytes(K);
  const int rc = hhmm::wide_launch_setup<ffbs_bwd_sample_wide_kernel<GATED>>(smem);
  if (rc != 0) return rc;
  ffbs_bwd_sample_wide_kernel<GATED><<<N, (K + 31) / 32 * 32, smem, stream>>>(
      K, A, mask, alpha, u, gate, sk, z, T, N);
  return 0;
}

template <bool GATED, class M>
int launch_big_typed(int K, const float* A, const float* mask, const float* alpha,
                     const float* u, const float* gate, const float* sk, int* z, int T, int N,
                     cudaStream_t stream) {
  float* scratch = nullptr;
  int rc = hhmm::big_scratch(&scratch, static_cast<size_t>(N) * K * K, stream);
  if (rc != 0) return rc;
  const int C = big_bwd_chunk<M>(K);
  const size_t smem = big_bwd_smem_bytes<M>(K, C);
  rc = hhmm::wide_launch_setup<ffbs_bwd_sample_big_kernel<GATED, M>>(smem);
  if (rc == 0)
    ffbs_bwd_sample_big_kernel<GATED, M><<<N, hhmm::big_threads(K), smem, stream>>>(
        K, C, A, mask, alpha, u, gate, sk, z, scratch, T, N);
  return hhmm::big_free(scratch, rc, stream);
}

template <bool GATED>
int launch_big(int K, const float* A, const float* mask, const float* alpha, const float* u,
               const float* gate, const float* sk, int* z, int T, int N, cudaStream_t stream) {
  if (K <= hhmm::kMaxByteK)
    return launch_big_typed<GATED, uint8_t>(K, A, mask, alpha, u, gate, sk, z, T, N, stream);
  return launch_big_typed<GATED, uint16_t>(K, A, mask, alpha, u, gate, sk, z, T, N, stream);
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused one, or -1 for
// a K below 1, an empty shape, or (K <= 16) maps over 2048 words a lane
// without a scratch. `scratch` is null (the maps live in shared
// memory) or, at K <= 16, an int32 [N, W * map_words(T)] buffer the
// caller owns, required when W * map_words(T) > 2048 (T > 2048 at K <=
// 8, T > 1024 at K in 9..16), with W = ceil(K / 8) and map_words(T) = T
// rounded up to a multiple of 32; above K = 16 it is not read. Launches
// on `stream` and does not synchronise; above K = 128 the launch takes
// and frees a stream-ordered scratch of its own for the lanes' A.
extern "C" int hhmm_ffbs_bwd_sample(int K, int gated, const float* A,
                                    const float* mask, const float* alpha,
                                    const float* u, const float* gate,
                                    const float* sk, int* z, int* scratch,
                                    int T, int N, void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* m = reinterpret_cast<uint32_t*>(scratch);
  int rc;
  if (K > hhmm::kMaxK) {
    rc = gated ? launch_big<true>(K, A, mask, alpha, u, gate, sk, z, T, N, s)
               : launch_big<false>(K, A, mask, alpha, u, gate, sk, z, T, N, s);
  } else if (K > hhmm::kMaxNibbleK) {
    rc = gated ? launch_wide<true>(K, A, mask, alpha, u, gate, sk, z, T, N, s)
               : launch_wide<false>(K, A, mask, alpha, u, gate, sk, z, T, N, s);
  } else {
    rc = for_k<hhmm::kMaxNibbleK>(K, [&](auto k) {
      return launch_k<decltype(k)::value>(gated, A, mask, alpha, u, gate, sk, z, m, T, N, s);
    });
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
