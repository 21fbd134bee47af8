// Clamped forward filter with the per-step alpha residual — the FFBS
// pass 1 and the decode's filtered probabilities.
//
// Replaces: hhmm_tpu/kernels/pallas_semiring.py::_fwd_kernel (line 287),
// launched by its pallas_call at line 347 in _run_chunked_forward, which
// semiring_ffbs (FFBS pass 1) and kernels/alpha_fused.py::forward_alpha
// reach. Same function, not the same schedule: the TPU kernel walks a
// (128-lane batch tile, time block) grid and carries alpha between time
// blocks in VMEM scratch. Here one thread owns one lane (series x chain)
// and walks all T steps itself, with alpha[K] and A[K][K] in registers.
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
//   exponentials runs in index order.
//
// Layout: batch-minor, lane n fastest — pi [K,N], A [K,K,N], obs
// [T,K,N], mask/gate [T,N], sk [K,N], alpha [T,K,N], ll [N] — so the
// 32 threads of a warp touch 32 consecutive floats on every load and
// store (coalesced).
//
// What bounds it: the T-step recurrence is serial within a lane, and a
// lane's bytes (obs and alpha, 4K floats a step) are few. At the main
// path's N = 256 lanes the card holds two blocks of 128 threads, so the
// time is the serial chain of T dependent steps, far above the
// bytes-over-bandwidth bound. The design keeps each step's dependent
// chain short: the next step's obs/mask/gate are loaded one step ahead
// (register double-buffering), so a step waits on arithmetic and not on
// device-memory latency; the alpha store is fire-and-forget.
// Filling the card at small N (splitting T or K across threads) is left
// for a later change.

#include <cuda_runtime.h>

namespace {

constexpr float kClamp = -1.0e30f;
constexpr int kBlock = 128;

template <int K>
__device__ __forceinline__ float lse0(const float (&x)[K]) {
  float m = x[0];
#pragma unroll
  for (int i = 1; i < K; ++i) m = fmaxf(m, x[i]);
  m = fmaxf(m, kClamp);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) s += expf(x[i] - m);
  return m + logf(s);
}

template <int K, bool GATED>
__global__ void __launch_bounds__(kBlock)
ffbs_fwd_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                const float* __restrict__ obs, const float* __restrict__ mask,
                const float* __restrict__ gate, const float* __restrict__ sk,
                float* __restrict__ ll, float* __restrict__ alpha_out, int T,
                int N) {
  const int n = blockIdx.x * kBlock + threadIdx.x;
  if (n >= N) return;
  const size_t sN = static_cast<size_t>(N);

  float a[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) a[i][j] = A[(i * K + j) * sN + n];
  float skr[K];
#pragma unroll
  for (int j = 0; j < K; ++j) skr[j] = GATED ? sk[j * sN + n] : 0.0f;

  float alpha[K];
  const bool valid0 = mask[n] > 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float p = pi[k * sN + n];
    alpha[k] = valid0 ? p + obs[k * sN + n] : p;
    alpha_out[k * sN + n] = alpha[k];
  }

  // step t+1's inputs, loaded one step ahead
  float o_nx[K];
  float m_nx = 0.0f, g_nx = 0.0f;
  if (T > 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) o_nx[k] = obs[(K + k) * sN + n];
    m_nx = mask[sN + n];
    if (GATED) g_nx = gate[sN + n];
  }

  for (int t = 1; t < T; ++t) {
    float o[K];
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] = o_nx[k];
    const float m = m_nx, g = g_nx;
    if (t + 1 < T) {
      const size_t row = static_cast<size_t>(t + 1);
#pragma unroll
      for (int k = 0; k < K; ++k) o_nx[k] = obs[(row * K + k) * sN + n];
      m_nx = mask[row * sN + n];
      if (GATED) g_nx = gate[row * sN + n];
    }
    if (m > 0.0f) {
      float nw[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float x[K];
        if (GATED) {
          const float c = (g == skr[j]) ? 1.0f : 0.0f;
#pragma unroll
          for (int i = 0; i < K; ++i) x[i] = alpha[i] + a[i][j] * c;
        } else {
#pragma unroll
          for (int i = 0; i < K; ++i) x[i] = alpha[i] + a[i][j];
        }
        nw[j] = lse0<K>(x) + o[j];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) alpha[k] = nw[k];
    }
    float* dst = alpha_out + static_cast<size_t>(t) * K * sN + n;
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k * sN] = alpha[k];
  }
  ll[n] = lse0<K>(alpha);
}

template <int K, bool GATED>
void launch(const float* pi, const float* A, const float* obs,
            const float* mask, const float* gate, const float* sk, float* ll,
            float* alpha, int T, int N, cudaStream_t stream) {
  const int grid = (N + kBlock - 1) / kBlock;
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
