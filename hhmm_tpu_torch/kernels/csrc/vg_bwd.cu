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
// view of the residual (aprev_ref). Here a group of threads owns a lane
// and walks t = T-1 .. 0 itself: beta, A and the gradient sums in
// registers, the per-step obs, mask, gate and alpha rows in a
// shared-memory ring, so the block-boundary lookback disappears.
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
// The kernel is beta_core.cuh's beta_kernel in its value-and-grad mode at
// K <= 32, wide_core.cuh's wide_beta_kernel (a block a lane, A and d_A
// in shared memory) up to 128, and big_core.cuh's big_beta_kernel (A and
// d_A in a global scratch) above: those headers have the layout, the
// thread mapping, what bounds it and what the design does about it.

#include "beta_core.cuh"
#include "big_core.cuh"
#include "wide_core.cuh"

namespace {

template <int K>
int launch_k(int gated, const float* A, const float* obs, const float* mask,
             const float* alpha, const float* ll, const float* gate,
             const float* sk, float* d_pi, float* d_A, float* d_obs, int T,
             int N, cudaStream_t stream) {
  if (gated)
    return hhmm::launch_beta<K, true, true>(A, obs, mask, gate, sk, alpha, ll, nullptr,
                                            d_pi, d_A, d_obs, T, N, stream);
  return hhmm::launch_beta<K, true, false>(A, obs, mask, gate, sk, alpha, ll, nullptr,
                                           d_pi, d_A, d_obs, T, N, stream);
}

int launch_wide(int K, int gated, const float* A, const float* obs, const float* mask,
                const float* alpha, const float* ll, const float* gate, const float* sk,
                float* d_pi, float* d_A, float* d_obs, int T, int N, cudaStream_t stream) {
  if (gated)
    return hhmm::launch_wide_beta<true, true>(K, A, obs, mask, gate, sk, alpha, ll, nullptr,
                                              d_pi, d_A, d_obs, T, N, stream);
  return hhmm::launch_wide_beta<true, false>(K, A, obs, mask, gate, sk, alpha, ll, nullptr,
                                             d_pi, d_A, d_obs, T, N, stream);
}

int launch_big(int K, int gated, const float* A, const float* obs, const float* mask,
               const float* alpha, const float* ll, const float* gate, const float* sk,
               float* d_pi, float* d_A, float* d_obs, int T, int N, cudaStream_t stream) {
  if (gated)
    return hhmm::launch_big_beta<true, true>(K, A, obs, mask, gate, sk, alpha, ll, nullptr,
                                             d_pi, d_A, d_obs, T, N, stream);
  return hhmm::launch_big_beta<true, false>(K, A, obs, mask, gate, sk, alpha, ll, nullptr,
                                            d_pi, d_A, d_obs, T, N, stream);
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused one, or -1 for
// a K below 1 or an empty shape. Launches on `stream` and does not
// synchronise; the caller owns every buffer (above K = 128 the launch
// takes and frees a stream-ordered scratch for the lanes' A and d_A).
extern "C" int hhmm_vg_bwd(int K, int gated, const float* A, const float* obs,
                           const float* mask, const float* alpha,
                           const float* ll, const float* gate, const float* sk,
                           float* d_pi, float* d_A, float* d_obs, int T, int N,
                           void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      K > hhmm::kMaxK
          ? launch_big(K, gated, A, obs, mask, alpha, ll, gate, sk, d_pi, d_A, d_obs, T, N, s)
      : K > hhmm::kMaxGroupK
          ? launch_wide(K, gated, A, obs, mask, alpha, ll, gate, sk, d_pi, d_A, d_obs, T, N, s)
          : hhmm::for_k<hhmm::kMaxGroupK>(K, [&](auto k) {
              return launch_k<decltype(k)::value>(gated, A, obs, mask, alpha, ll, gate, sk,
                                                  d_pi, d_A, d_obs, T, N, s);
            });
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
