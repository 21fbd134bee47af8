// Guarded forward filter with the per-step alpha residual — the decode's
// filtered probabilities and the first half of its smoothing pass.
//
// Replaces: hhmm_tpu/kernels/pallas_semiring.py::_semiring_fwd_kernel in
// mode "filter" (line 361), launched by its pallas_call at line 664 in
// semiring_filter, which kernels/dispatch.py::forward_filter_dispatch and
// smooth_dispatch reach for a homogeneous f32 log_A. Same function, not
// the same schedule: the TPU kernel walks a (128-lane batch tile, time
// block) grid and carries alpha between time blocks in VMEM scratch.
// Here a group of threads owns a lane and walks all T steps itself,
// alpha and a column of A a thread in registers, the step's obs and mask
// in a shared-memory ring.
//
// Math, per lane (f32, in the plain version's order of operations):
//   alpha_0    = mask_0 > 0 ? pi + obs_0 : pi
//   alpha_t[j] = safe_lse_i(alpha_{t-1}[i] + A[i][j]) + obs_t[j]
//   a masked step (mask_t <= 0) copies the carry; every alpha_t goes to
//   the residual; ll = safe_lse(alpha_{T-1}).
//   safe_lse is the guarded logsumexp of pallas_semiring.py:115-119
//   (core.lmath.safe_logsumexp): an all -inf row gives -inf, never NaN;
//   otherwise m + log(sum exp(x - m)), the exponentials summed in index
//   order. On finite inputs this is the arithmetic of ffbs_fwd.cu (whose
//   clamp at -1e30 never binds there), so the two kernels' alphas are
//   bitwise equal. Any K >= 1.
//
// The kernel is fwd_core.cuh's forward_kernel in its guarded mode at K
// <= 32, wide_core.cuh's wide_forward_kernel (a block a lane) up to 128,
// and big_core.cuh's big_forward_kernel above: those headers have the
// layout, the thread mapping, what bounds it and what the design does
// about it.

#include "big_core.cuh"
#include "fwd_core.cuh"
#include "wide_core.cuh"

// Returns 0 on a good launch, the cudaError_t of a refused one, or -1 for
// a K below 1 or an empty shape. Launches on `stream` and does not
// synchronise; the caller owns every buffer (above K = 128 the launch
// takes and frees a stream-ordered scratch for the lanes' A).
extern "C" int hhmm_semiring_filter(int K, const float* pi, const float* A,
                                    const float* obs, const float* mask,
                                    float* ll, float* alpha, int T, int N,
                                    void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      K > hhmm::kMaxK
          ? hhmm::launch_big_forward<hhmm::kGuarded, false>(
                K, pi, A, obs, mask, nullptr, nullptr, ll, alpha, nullptr, nullptr, T, N, s)
      : K > hhmm::kMaxGroupK
          ? hhmm::launch_wide_forward<hhmm::kGuarded, false>(
                K, pi, A, obs, mask, nullptr, nullptr, ll, alpha, nullptr, nullptr, T, N, s)
          : hhmm::for_k<hhmm::kMaxGroupK>(K, [&](auto k) {
              return hhmm::launch_forward<decltype(k)::value, hhmm::kGuarded, false>(
                  pi, A, obs, mask, nullptr, nullptr, ll, alpha, nullptr, nullptr, T, N, s);
            });
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
