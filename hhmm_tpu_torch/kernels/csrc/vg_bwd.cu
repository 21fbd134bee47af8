// Value-and-grad pass 2: the clamped backward recursion with the
// Baum-Welch gradients of the forward log-likelihood, reading the
// forward pass's alpha residual (ffbs_fwd.cu).
//
// Replaces: hhmm_tpu/kernels/pallas_semiring.py::_bwd_kernel (line 435),
// launched by its pallas_call at line 866 in semiring_vg, which
// kernels/vg.py::forward_value_and_grad reaches on every leapfrog of the
// unfused HMC/ChEES path. The TPU kernel walks reversed (batch tile,
// time block) grid steps, carries beta across blocks in VMEM scratch and
// reads the previous block's last alpha row through a second, shifted
// view of the residual (aprev_ref). Here one thread owns one lane and
// walks t = T-1 .. 0 itself, so beta, the K x K gradient accumulator and
// the alpha row entering each step stay in registers; the block-boundary
// lookback disappears.
//
// Math, per lane (f32, in the TPU kernel's order of operations):
//   beta_{T-1} = 0; for t = T-1 .. 1, with m = mask_t > 0:
//     d_obs[t]    = exp(alpha_t + beta - ll) * m
//     e[j]        = obs_t[j] + beta[j]
//     Ag[i][j]    = c_t[j] * A[i][j]     (ungated: c_t[j] = 1; gated:
//                   c_t[j] = gate_t == sk[j], compared as f32 equality)
//     d_A[i][j]  += exp(alpha_{t-1}[i] + Ag[i][j] + e[j] - ll)
//                   [* c_t[j] when gated] * m
//     beta[i]     = m ? lse0_j(Ag[i][j] + e[j]) : beta[i]
//   gamma_0 = exp(alpha_0 + beta - ll); d_pi = gamma_0 (unmasked);
//   d_obs[0] = gamma_0 * (mask_0 > 0).
//   lse0 is the clamped logsumexp (max clamped at -1e30, exponentials
//   summed in index order), as in ffbs_fwd.cu. A is used as given: the
//   vg path does not clamp it (semiring_vg, unlike semiring_ffbs).
//
// Layout: batch-minor, lane n fastest — A [K,K,N], obs/alpha/d_obs
// [T,K,N], mask/gate [T,N], sk/d_pi [K,N], ll [N], d_A [K,K,N] —
// coalesced across a warp.
//
// What bounds it: the serial T-step beta recursion within a lane; per
// step a lane moves 3K+2 floats (alpha, obs, d_obs, mask, gate) and does
// K*K exponentials for the gradient, so at the vg path's N = 512 lanes
// (4 blocks of 128 threads) the time is the dependent chain of T steps,
// far above the bytes-over-bandwidth bound. The design keeps that chain
// short: the next step's alpha, obs, mask and gate rows are loaded one
// step ahead (register double-buffering), and the K*K gradient
// exponentials hang off the chain (they feed only the accumulator), so
// a step waits on the K lse0s of beta. Filling the card at small N is
// left for a later change, as for ffbs_fwd.cu.

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
vg_bwd_kernel(const float* __restrict__ A, const float* __restrict__ obs,
              const float* __restrict__ mask, const float* __restrict__ alpha,
              const float* __restrict__ ll_in, const float* __restrict__ gate,
              const float* __restrict__ sk, float* __restrict__ d_pi,
              float* __restrict__ d_A, float* __restrict__ d_obs, int T,
              int N) {
  const int n = blockIdx.x * kBlock + threadIdx.x;
  if (n >= N) return;
  const size_t sN = static_cast<size_t>(N);
  const size_t sKN = static_cast<size_t>(K) * sN;

  float a[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) a[i][j] = A[(i * K + j) * sN + n];
  float skr[K];
#pragma unroll
  for (int j = 0; j < K; ++j) skr[j] = GATED ? sk[j * sN + n] : 0.0f;
  const float ll = ll_in[n];

  float beta[K], dA[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    beta[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) dA[i][j] = 0.0f;
  }

  // alpha_t for the current step; step t's alpha_{t-1}, obs_t, mask_t
  // and gate_t are loaded one step ahead into the *_nx registers
  float a_cur[K], a_nx[K], o_nx[K];
  float m_nx = 0.0f, g_nx = 0.0f;
  const size_t last = static_cast<size_t>(T - 1);
#pragma unroll
  for (int k = 0; k < K; ++k) a_cur[k] = alpha[last * sKN + k * sN + n];
  if (T > 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a_nx[k] = alpha[(last - 1) * sKN + k * sN + n];
      o_nx[k] = obs[last * sKN + k * sN + n];
    }
    m_nx = mask[last * sN + n];
    if (GATED) g_nx = gate[last * sN + n];
  }

  for (int t = T - 1; t >= 1; --t) {
    float a_prev[K], o[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a_prev[k] = a_nx[k];
      o[k] = o_nx[k];
    }
    const float m = m_nx, g = g_nx;
    if (t >= 2) {
      const size_t row = static_cast<size_t>(t - 1);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        a_nx[k] = alpha[(row - 1) * sKN + k * sN + n];
        o_nx[k] = obs[row * sKN + k * sN + n];
      }
      m_nx = mask[row * sN + n];
      if (GATED) g_nx = gate[row * sN + n];
    }
    const float m01 = (m > 0.0f) ? 1.0f : 0.0f;

    float* dst = d_obs + static_cast<size_t>(t) * sKN + n;
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k * sN] = expf(a_cur[k] + beta[k] - ll) * m01;

    float e[K], c[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      e[j] = o[j] + beta[j];
      c[j] = GATED ? ((g == skr[j]) ? 1.0f : 0.0f) : 1.0f;
    }
    float nb[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float x[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float ag = GATED ? a[i][j] * c[j] : a[i][j];
        float xi = expf(a_prev[i] + ag + e[j] - ll);
        if (GATED) xi = xi * c[j];
        dA[i][j] += xi * m01;
        x[j] = ag + e[j];
      }
      nb[i] = lse0<K>(x);
    }
    if (m > 0.0f) {
#pragma unroll
      for (int i = 0; i < K; ++i) beta[i] = nb[i];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) a_cur[k] = a_prev[k];
  }

  const float m01_0 = (mask[n] > 0.0f) ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float g0 = expf(a_cur[k] + beta[k] - ll);
    d_pi[k * sN + n] = g0;
    d_obs[k * sN + n] = g0 * m01_0;
  }
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) d_A[(i * K + j) * sN + n] = dA[i][j];
}

template <int K>
void launch_k(int gated, const float* A, const float* obs, const float* mask,
              const float* alpha, const float* ll, const float* gate,
              const float* sk, float* d_pi, float* d_A, float* d_obs, int T,
              int N, cudaStream_t stream) {
  const int grid = (N + kBlock - 1) / kBlock;
  if (gated)
    vg_bwd_kernel<K, true><<<grid, kBlock, 0, stream>>>(
        A, obs, mask, alpha, ll, gate, sk, d_pi, d_A, d_obs, T, N);
  else
    vg_bwd_kernel<K, false><<<grid, kBlock, 0, stream>>>(
        A, obs, mask, alpha, ll, gate, sk, d_pi, d_A, d_obs, T, N);
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused one, or -1 for
// an unsupported K or an empty shape. Launches on `stream`, does not
// synchronise and allocates nothing: the caller owns every buffer.
extern "C" int hhmm_vg_bwd(int K, int gated, const float* A, const float* obs,
                           const float* mask, const float* alpha,
                           const float* ll, const float* gate, const float* sk,
                           float* d_pi, float* d_A, float* d_obs, int T, int N,
                           void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: launch_k<2>(gated, A, obs, mask, alpha, ll, gate, sk, d_pi, d_A, d_obs, T, N, s); break;
    case 4: launch_k<4>(gated, A, obs, mask, alpha, ll, gate, sk, d_pi, d_A, d_obs, T, N, s); break;
    case 8: launch_k<8>(gated, A, obs, mask, alpha, ll, gate, sk, d_pi, d_A, d_obs, T, N, s); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
