// Guarded backward (beta) recursion — the second half of the decode's
// smoothing pass.
//
// Replaces: hhmm_tpu/kernels/pallas_semiring.py::_beta_kernel (line 510),
// launched by its pallas_call at line 696 in semiring_beta, which
// kernels/dispatch.py::backward_dispatch and smooth_dispatch reach for a
// homogeneous f32 log_A. The TPU kernel walks reversed (batch tile, time
// block) grid steps and carries beta, and the obs and mask rows crossing
// a block boundary, in VMEM scratch (carry, oc, mc). Here a group of
// threads owns a lane and walks t = T-2 .. 0 itself, beta and A in
// registers, the successor's obs and mask rows in a shared-memory ring.
//
// Math, per lane (f32, in the TPU kernel's order of operations):
//   beta_{T-1} = 0
//   e[j]       = obs_{t+1}[j] + beta_{t+1}[j]
//   beta_t[i]  = mask_{t+1} > 0 ? safe_lse_j(A[i][j] + e[j]) : beta_{t+1}[i]
//   safe_lse is the guarded logsumexp (lane_group.cuh): an all -inf row
//   gives -inf, never NaN; otherwise m + log(sum exp(x - m)), the
//   exponentials summed in index order as the plain version sums them.
//
// The kernel is beta_core.cuh's beta_kernel in its guarded mode at K <=
// 32, wide_core.cuh's wide_beta_kernel (a block a lane) up to 128, and
// big_core.cuh's big_beta_kernel above: those headers have the layout,
// the thread mapping, what bounds it and what the design does about it.

#include "beta_core.cuh"
#include "big_core.cuh"
#include "wide_core.cuh"

// Returns 0 on a good launch, the cudaError_t of a refused one, or -1 for
// a K below 1 or an empty shape. Launches on `stream` and does not
// synchronise; the caller owns every buffer (above K = 128 the launch
// takes and frees a stream-ordered scratch for the lanes' A).
extern "C" int hhmm_semiring_beta(int K, const float* A, const float* obs,
                                  const float* mask, float* beta, int T, int N,
                                  void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      K > hhmm::kMaxK
          ? hhmm::launch_big_beta<false, false>(K, A, obs, mask, nullptr, nullptr, nullptr,
                                                nullptr, beta, nullptr, nullptr, nullptr, T, N,
                                                s)
      : K > hhmm::kMaxGroupK
          ? hhmm::launch_wide_beta<false, false>(K, A, obs, mask, nullptr, nullptr, nullptr,
                                                 nullptr, beta, nullptr, nullptr, nullptr, T, N,
                                                 s)
          : hhmm::for_k<hhmm::kMaxGroupK>(K, [&](auto k) {
              return hhmm::launch_beta<decltype(k)::value, false, false>(
                  A, obs, mask, nullptr, nullptr, nullptr, nullptr, beta, nullptr, nullptr,
                  nullptr, T, N, s);
            });
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
