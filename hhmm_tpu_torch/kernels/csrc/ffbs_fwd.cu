// Clamped forward filter with the per-step alpha residual — the FFBS
// pass 1, the value-and-grad pass 1 and the decode's filtered
// probabilities.
//
// Replaces: hhmm_tpu/kernels/pallas_semiring.py::_fwd_kernel (line 287),
// launched by its pallas_call at line 347 in _run_chunked_forward, which
// semiring_ffbs (FFBS pass 1), semiring_vg (pass 1) and
// kernels/alpha_fused.py::forward_alpha reach. Same function, not the
// same schedule: the TPU kernel walks a (128-lane batch tile, time block)
// grid and carries alpha between time blocks in VMEM scratch.
//
// Math, per lane (all f32, kept exactly as the TPU kernel has it):
//   alpha_0    = mask_0 > 0 ? pi + obs_0 : pi
//   alpha_t[j] = lse0_i(alpha_{t-1}[i] + c_t[j] * A[i][j]) + obs_t[j]
//                (ungated: c_t[j] = 1; gated: c_t[j] = gate_t == sk[j],
//                compared as f32 equality)
//   a masked step (mask_t <= 0) copies the carry; every alpha_t goes to
//   the residual; ll = lse0(alpha_{T-1}).
//   lse0 is the clamped logsumexp of pallas_semiring.py:127-131: the max
//   is clamped at -1e30 (it is not a guarded logsumexp), and the sum of
//   exponentials runs in index order. The max is taken as a tree, which
//   gives the same value as a chain (max is exact).
//
// Layout: batch-minor, lane n fastest — pi [K,N], A [K,K,N], obs
// [T,K,N], mask/gate [T,N], sk [K,N], alpha [T,K,N], ll [N].
//
// Thread mapping: a group of G threads (G = 2, 4, 4, 8 for K = 2, 3, 4,
// 8) owns one lane; thread j of the group owns alpha[j] and the column
// A[:, j] in registers (at K = 3 the fourth thread idles). A warp holds
// 32 / G lanes, lane index fastest, so its obs and alpha accesses at one
// step are, per state, 32 / G consecutive floats of the [T, K, N] layout
// (whole 32-byte sectors from K = 4 down). Each step thread j gathers
// alpha_{t-1}[0..K-1] from its group with __shfl_sync and computes its
// own alpha_t[j] with exactly the arithmetic of the per-lane loop.
//
// What bounds it: the T-step recurrence is serial within a lane, and a
// lane's bytes (obs and alpha, 2K floats a step) are few, so the time is
// the dependent chain of one step times T: a gather (K shuffles), the
// clamped max, K exponentials, the ordered sum and one logarithm; at
// K = 4 about 81 instructions, which one warp issues in order in about
// 290 cycles (145 ns a step on an H100). The design does three things
// about it:
// - a group of threads per lane: a thread's step is one destination's
//   K exponentials and one logarithm, not K^2 and K, and the K
//   destinations run in parallel;
// - small blocks (kBlock = 64 threads), so N = 256 lanes at K = 4 spread
//   over 16 SMs instead of two;
// - a shared-memory ring of kStages stages of kChunk steps, filled with
//   cp.async: each thread copies its own obs_t[j], mask_t and gate_t for
//   the chunk kStages - 1 chunks ahead, then waits (cp.async.wait_group)
//   for the chunk it is about to run, so a step reads its inputs from
//   shared memory, copied (kStages - 1) * kChunk = 16 steps or more
//   before it. A register ring does not do this: every load in flight
//   shares one of the six scoreboards, so a step that reads the oldest
//   register waits for the youngest load too, a device-memory round trip
//   a step (253 ns a step on an H100, against 145 with this ring; 24- and
//   32-step rings measured no faster).
// The alpha store is fire-and-forget.

#include <cuda_runtime.h>

namespace {

constexpr float kClamp = -1.0e30f;
constexpr int kBlock = 64;
constexpr int kChunk = 8;   // steps a ring stage
constexpr int kStages = 3;  // ring stages; chunks in flight: kStages - 1
constexpr unsigned kFull = 0xffffffffu;

template <int K>
struct Group {
  static constexpr int G = K <= 2 ? 2 : (K <= 4 ? 4 : 8);  // threads a lane
  static constexpr int kLanesPerWarp = 32 / G;
  static constexpr int kLanesPerBlock = kBlock / G;
};

template <int K>
__device__ __forceinline__ float max_tree(const float (&x)[K]) {
  if constexpr (K == 2) {
    return fmaxf(x[0], x[1]);
  } else if constexpr (K == 3) {
    return fmaxf(fmaxf(x[0], x[1]), x[2]);
  } else if constexpr (K == 4) {
    return fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
  } else {
    static_assert(K == 8, "K in {2, 3, 4, 8}");
    return fmaxf(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])),
                 fmaxf(fmaxf(x[4], x[5]), fmaxf(x[6], x[7])));
  }
}

template <int K>
__device__ __forceinline__ float lse0(const float (&x)[K]) {
  const float m = fmaxf(max_tree<K>(x), kClamp);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) s += expf(x[i] - m);
  return m + logf(s);
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

// alpha_{t-1}[0..K-1] of this thread's lane, from the group's threads
template <int K>
__device__ __forceinline__ void gather(float (&prev)[K], float mine, int l) {
  constexpr int LPW = Group<K>::kLanesPerWarp;
#pragma unroll
  for (int i = 0; i < K; ++i) prev[i] = __shfl_sync(kFull, mine, i * LPW + l);
}

template <int K, bool GATED>
__global__ void __launch_bounds__(kBlock)
ffbs_fwd_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                const float* __restrict__ obs, const float* __restrict__ mask,
                const float* __restrict__ gate, const float* __restrict__ sk,
                float* __restrict__ ll, float* __restrict__ alpha_out, int T,
                int N) {
  constexpr int LPW = Group<K>::kLanesPerWarp;
  const int wl = threadIdx.x & 31;
  const int l = wl % LPW;  // lane within the warp
  const int j = wl / LPW;  // state owned by this thread
  const int n = (blockIdx.x * (kBlock / 32) + threadIdx.x / 32) * LPW + l;
  // every thread of a warp takes part in the shuffles; only these own a
  // value to load and store
  const bool live = n < N && j < K;
  const size_t sN = static_cast<size_t>(N);
  const size_t step = static_cast<size_t>(K) * sN;  // obs/alpha row stride

  float acol[K];
  float skj = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) acol[i] = live ? A[(i * K + j) * sN + n] : 0.0f;
  if (GATED && live) skj = sk[j * sN + n];

  float alpha = 0.0f;
  if (live) {
    const float p = pi[j * sN + n];
    alpha = mask[n] > 0.0f ? p + obs[j * sN + n] : p;
    alpha_out[j * sN + n] = alpha;
  }

  // the ring: stage s holds chunk c (steps 1 + c * kChunk ..) for every
  // c = s mod kStages; each thread copies and reads only its own column
  __shared__ float s_obs[kStages][kChunk][kBlock];
  __shared__ float s_mask[kStages][kChunk][kBlock];
  __shared__ float s_gate[GATED ? kStages : 1][kChunk][kBlock];
  const int tid = threadIdx.x;
  const int full = (T - 1) / kChunk;                  // chunks of kChunk steps
  const int chunks = (T - 1 + kChunk - 1) / kChunk;  // and a partial one
  // copy chunk c into its stage: one group, empty past the last chunk
  auto issue = [&](int c) {
    const int st = c % kStages;
    const int t0 = 1 + c * kChunk;
    if (live && c < chunks) {
      const float* o = obs + (static_cast<size_t>(t0) * K + j) * sN + n;
      const float* m = mask + static_cast<size_t>(t0) * sN + n;
      const float* g = gate + static_cast<size_t>(t0) * sN + n;
      const int valid = c < full ? kChunk : T - t0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < valid) {
          cp_async4(&s_obs[st][k][tid], o);
          cp_async4(&s_mask[st][k][tid], m);
          if (GATED) cp_async4(&s_gate[GATED ? st : 0][k][tid], g);
        }
        o += step;
        m += sN;
        g += sN;
      }
    }
    cp_async_commit();
  };
  float* dst = alpha_out + j * sN + n + step;  // step 1
  // one step from stage st, slot k
  auto run = [&](int st, int k) {
    float prev[K];
    gather<K>(prev, alpha, l);
    float x[K];
    if (GATED) {
      const float c_t = (s_gate[GATED ? st : 0][k][tid] == skj) ? 1.0f : 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) x[i] = prev[i] + acol[i] * c_t;
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) x[i] = prev[i] + acol[i];
    }
    const float nw = lse0<K>(x) + s_obs[st][k][tid];
    if (s_mask[st][k][tid] > 0.0f) alpha = nw;
    if (live) *dst = alpha;
    dst += step;
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
    const int valid = T - 1 - full * kChunk;
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (k < valid) run(st, k);
  }

  float fin[K];
  gather<K>(fin, alpha, l);
  if (live && j == 0) ll[n] = lse0<K>(fin);
}

template <int K, bool GATED>
void launch(const float* pi, const float* A, const float* obs,
            const float* mask, const float* gate, const float* sk, float* ll,
            float* alpha, int T, int N, cudaStream_t stream) {
  constexpr int lanes = Group<K>::kLanesPerBlock;
  const int grid = (N + lanes - 1) / lanes;
  ffbs_fwd_kernel<K, GATED><<<grid, kBlock, 0, stream>>>(
      pi, A, obs, mask, gate, sk, ll, alpha, T, N);
}

template <int K>
void launch_k(int gated, const float* pi, const float* A, const float* obs,
              const float* mask, const float* gate, const float* sk,
              float* ll, float* alpha, int T, int N, cudaStream_t stream) {
  if (gated)
    launch<K, true>(pi, A, obs, mask, gate, sk, ll, alpha, T, N, stream);
  else
    launch<K, false>(pi, A, obs, mask, gate, sk, ll, alpha, T, N, stream);
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused one, or -1 for
// an unsupported K. Launches on `stream`, does not synchronise and
// allocates nothing: the caller owns every buffer.
extern "C" int hhmm_ffbs_fwd(int K, int gated, const float* pi,
                             const float* A, const float* obs,
                             const float* mask, const float* gate,
                             const float* sk, float* ll, float* alpha, int T,
                             int N, void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: launch_k<2>(gated, pi, A, obs, mask, gate, sk, ll, alpha, T, N, s); break;
    case 3: launch_k<3>(gated, pi, A, obs, mask, gate, sk, ll, alpha, T, N, s); break;
    case 4: launch_k<4>(gated, pi, A, obs, mask, gate, sk, ll, alpha, T, N, s); break;
    case 8: launch_k<8>(gated, pi, A, obs, mask, gate, sk, ll, alpha, T, N, s); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
