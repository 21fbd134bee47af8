// Clamped forward filter with the per-step alpha residual — the FFBS
// pass 1, the value-and-grad pass 1 and the decode's filtered
// probabilities.
//
// Replaces: hhmm_tpu/kernels/pallas_semiring.py::_fwd_kernel (line 287),
// launched by its pallas_call at line 347 in _run_chunked_forward, which
// semiring_ffbs (FFBS pass 1), semiring_vg (pass 1) and
// kernels/alpha_fused.py::forward_alpha reach. Same function, not the
// same schedule: the TPU kernel walks a (128-lane batch tile, time block)
// grid and carries alpha between time blocks in VMEM scratch. Here a
// group of threads owns a lane and walks all T steps itself, alpha and a
// column of A a thread in registers, the step's obs, mask and gate in a
// shared-memory ring.
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
// The kernel is fwd_core.cuh's forward_kernel in its clamped mode at K
// <= 32, wide_core.cuh's wide_forward_kernel (a block a lane) up to 128,
// and big_core.cuh's big_forward_kernel (a block a lane, A in a global
// scratch) above: those headers have the layout, the thread mapping,
// what bounds it and what the design does about it.

#include "big_core.cuh"
#include "fwd_core.cuh"
#include "wide_core.cuh"

namespace {

template <int K>
int launch_k(int gated, const float* pi, const float* A, const float* obs,
             const float* mask, const float* gate, const float* sk,
             float* ll, float* alpha, int T, int N, cudaStream_t stream) {
  using hhmm::kClamped;
  if (gated)
    return hhmm::launch_forward<K, kClamped, true>(pi, A, obs, mask, gate, sk, ll, alpha,
                                                   nullptr, nullptr, T, N, stream);
  return hhmm::launch_forward<K, kClamped, false>(pi, A, obs, mask, gate, sk, ll, alpha,
                                                  nullptr, nullptr, T, N, stream);
}

int launch_wide(int K, int gated, const float* pi, const float* A, const float* obs,
                const float* mask, const float* gate, const float* sk, float* ll,
                float* alpha, int T, int N, cudaStream_t stream) {
  using hhmm::kClamped;
  if (gated)
    return hhmm::launch_wide_forward<kClamped, true>(K, pi, A, obs, mask, gate, sk, ll, alpha,
                                                     nullptr, nullptr, T, N, stream);
  return hhmm::launch_wide_forward<kClamped, false>(K, pi, A, obs, mask, gate, sk, ll, alpha,
                                                    nullptr, nullptr, T, N, stream);
}

int launch_big(int K, int gated, const float* pi, const float* A, const float* obs,
               const float* mask, const float* gate, const float* sk, float* ll, float* alpha,
               int T, int N, cudaStream_t stream) {
  using hhmm::kClamped;
  if (gated)
    return hhmm::launch_big_forward<kClamped, true>(K, pi, A, obs, mask, gate, sk, ll, alpha,
                                                    nullptr, nullptr, T, N, stream);
  return hhmm::launch_big_forward<kClamped, false>(K, pi, A, obs, mask, gate, sk, ll, alpha,
                                                   nullptr, nullptr, T, N, stream);
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused one, or -1 for
// a K below 1 or an empty shape. Launches on `stream` and does not
// synchronise; the caller owns every buffer (above K = 128 the launch
// takes and frees a stream-ordered scratch for the lanes' A).
extern "C" int hhmm_ffbs_fwd(int K, int gated, const float* pi,
                             const float* A, const float* obs,
                             const float* mask, const float* gate,
                             const float* sk, float* ll, float* alpha, int T,
                             int N, void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      K > hhmm::kMaxK ? launch_big(K, gated, pi, A, obs, mask, gate, sk, ll, alpha, T, N, s)
      : K > hhmm::kMaxGroupK
          ? launch_wide(K, gated, pi, A, obs, mask, gate, sk, ll, alpha, T, N, s)
          : hhmm::for_k<hhmm::kMaxGroupK>(K, [&](auto k) {
              return launch_k<decltype(k)::value>(gated, pi, A, obs, mask, gate, sk, ll, alpha,
                                                  T, N, s);
            });
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
