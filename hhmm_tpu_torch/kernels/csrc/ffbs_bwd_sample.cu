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
// which depends on the chain. So the kernel runs in three phases, a
// block owning kLanes lanes and all T steps:
// - Phase A, parallel over (step, lane) and the block's threads: every
//   candidate map_t[s] = invcdf(alpha_t + g_s * A[:, s], u_t), with
//   g_s = (mask_{t+1} > 0) [* (gate_{t+1} == sk[s])], the arithmetic of
//   the draw above for successor s, so each candidate is bitwise the
//   draw the serial walk would make. The K candidates of a step are
//   packed four bits a state into one 32-bit word (nibble s holds
//   map_t[s]; K <= 8), as semiring_viterbi.cu packs its backpointers.
//   The last step's word repeats z_{T-1} in every nibble; the words past
//   it, up to a multiple of kChase steps, are the identity map.
// - Phase B, a thread per lane: z = 0, then for t = T-1 .. 0,
//   z_t = (map_t >> 4 z) & 15. A lane's words are contiguous in t, so
//   the thread reads a chunk of kChase steps with kChase / 4 16-byte
//   loads, walks it (a shift and a mask a step, no branch, no address
//   arithmetic) and writes the chunk's z back over its words.
// - Phase C: the block copies z out to z [T, N], coalesced.
// __syncthreads() separates the phases. The maps live in shared memory
// (kLanes rows of smem_stride(T) words, 4 bytes a step and lane, the
// rows padded so that phase A's and phase C's accesses fall in distinct
// banks) when T <= kSmemMaxT, else in an int32 [N, map_words(T)] scratch
// in device memory that the wrapper allocates.
//
// Layout: batch-minor as in ffbs_fwd.cu — A [K,K,N], mask/gate/u [T,N],
// alpha [T,K,N], sk [K,N], z [T,N] int32.
//
// What bounds it: at small N the chase, T steps of three dependent
// integer operations (about 12 cycles a step on an H100), after phase
// A's latency; at large N phase A's arithmetic, K inverse-CDF draws a
// step and lane (2K - 1 exponentials and a logarithm each), K times the
// serial walk's but spread over T x N. The bytes (alpha, u, mask: K+2
// floats a step, one int32 out) are few.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kClamp = -1.0e30f;
// lanes a block: on an H100, 2 is 21 % faster at N = 256 (phase A on
// twice the SMs) and 46 % slower from N = 2048 on (more of every resident
// block idles while its few threads chase); 8 is faster only at N = 8192
constexpr int kLanes = 4;
constexpr int kThreads = 256;  // threads a block
constexpr int kRows = kThreads / kLanes;  // steps a block covers per pass
constexpr int kChase = 32;     // phase B: steps a chunk
constexpr int kSmemMaxT = 2048;  // maps in shared memory up to this T (33 KB)

// words of a lane's maps: T rounded up to a chunk
__host__ __device__ constexpr int map_words(int T) {
  return (T + kChase - 1) / kChase * kChase;
}

// a lane's row in shared memory: its maps, plus a pad that puts the
// kLanes rows of a warp's accesses in distinct banks
__host__ __device__ constexpr int smem_stride(int T) { return map_words(T) + 32 / kLanes; }

template <int K>
__device__ __forceinline__ uint32_t identity_map() {
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) w |= static_cast<uint32_t>(j) << (4 * j);
  return w;
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
  const int l = threadIdx.x % kLanes;
  const int n = blockIdx.x * kLanes + l;
  const bool live = n < N;
  const size_t sN = static_cast<size_t>(N);
  const int chunks = map_words(T) / kChase;
  // this lane's row of map words, t = 0 .. chunks * kChase - 1
  uint32_t* row = scratch ? scratch + static_cast<size_t>(n) * map_words(T)
                          : smem_maps + l * smem_stride(T);

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
      uint32_t w;
      if (t >= T) {
        w = identity_map<K>();
      } else if (t == T - 1) {
        w = static_cast<uint32_t>(invcdf<K>(cur.al, cur.u)) * 0x11111111u;
      } else {
        const float g0 = (cur.m_next > 0.0f) ? 1.0f : 0.0f;
        w = 0;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          float g = g0;
          if (GATED && !(cur.g_next == skr[s])) g = 0.0f;
          float lg[K];
#pragma unroll
          for (int k = 0; k < K; ++k) lg[k] = cur.al[k] + g * a[k][s];
          w |= static_cast<uint32_t>(invcdf<K>(lg, cur.u)) << (4 * s);
        }
      }
      row[t] = w;
      cur = nxt;
    }
  }
  __syncthreads();

  // ---- phase B: the pointer chase, a thread per lane, a chunk at a time
  if (threadIdx.x < kLanes && live) {
    uint32_t z = 0;
    for (int c = chunks - 1; c >= 0; --c) {
      uint4* words = reinterpret_cast<uint4*>(row + c * kChase);
      uint32_t w[kChase];
#pragma unroll
      for (int q = 0; q < kChase / 4; ++q) {
        const uint4 v = words[q];
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int k = kChase - 1; k >= 0; --k) {
        z = (w[k] >> (4u * z)) & 15u;
        w[k] = z;
      }
#pragma unroll
      for (int q = 0; q < kChase / 4; ++q)
        words[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    }
  }
  __syncthreads();

  // ---- phase C: z out, the block's kLanes lanes side by side
  if (live) {
    for (int t = threadIdx.x / kLanes; t < T; t += kRows)
      z_out[static_cast<size_t>(t) * sN + n] = static_cast<int>(row[t]);
  }
}

template <int K, bool GATED>
int launch(const float* A, const float* mask, const float* alpha,
           const float* u, const float* gate, const float* sk, int* z,
           uint32_t* scratch, int T, int N, cudaStream_t stream) {
  if (!scratch && T > kSmemMaxT) return -1;  // the maps need the scratch
  const int grid = (N + kLanes - 1) / kLanes;
  const size_t smem =
      scratch ? 0 : static_cast<size_t>(smem_stride(T)) * kLanes * sizeof(uint32_t);
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

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused one, or -1 for
// an unsupported K, an empty shape, or T > 2048 without a scratch.
// `scratch` is null (the maps live in shared memory) or an int32
// [N, map_words(T)] buffer the caller owns, required when T > 2048, with
// map_words(T) = T rounded up to a multiple of 32. Launches on `stream`,
// does not synchronise and allocates nothing.
extern "C" int hhmm_ffbs_bwd_sample(int K, int gated, const float* A,
                                    const float* mask, const float* alpha,
                                    const float* u, const float* gate,
                                    const float* sk, int* z, int* scratch,
                                    int T, int N, void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* m = reinterpret_cast<uint32_t*>(scratch);
  int rc;
  switch (K) {
    case 2: rc = launch_k<2>(gated, A, mask, alpha, u, gate, sk, z, m, T, N, s); break;
    case 3: rc = launch_k<3>(gated, A, mask, alpha, u, gate, sk, z, m, T, N, s); break;
    case 4: rc = launch_k<4>(gated, A, mask, alpha, u, gate, sk, z, m, T, N, s); break;
    case 8: rc = launch_k<8>(gated, A, mask, alpha, u, gate, sk, z, m, T, N, s); break;
    default: return -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
