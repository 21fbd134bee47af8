// Guarded forward filter with the per-step alpha residual — the decode's
// filtered probabilities and the first half of its smoothing pass.
//
// Replaces: hhmm_tpu/kernels/pallas_semiring.py::_semiring_fwd_kernel in
// mode "filter" (line 361), launched by its pallas_call at line 664 in
// semiring_filter, which kernels/dispatch.py::forward_filter_dispatch and
// smooth_dispatch reach for a homogeneous f32 log_A. Same function, not
// the same schedule: the TPU kernel walks a (128-lane batch tile, time
// block) grid and carries alpha between time blocks in VMEM scratch. Here
// one thread owns one lane and walks all T steps itself, with alpha[K]
// and A[K][K] in registers.
//
// Math, per lane (f32):
//   alpha_0    = mask_0 > 0 ? pi + obs_0 : pi
//   alpha_t[j] = safe_lse_i(alpha_{t-1}[i] + A[i][j]) + obs_t[j]
//   a masked step (mask_t <= 0) copies the carry; every alpha_t goes to
//   the residual; ll = safe_lse(alpha_{T-1}).
//   safe_lse is the guarded logsumexp of pallas_semiring.py:115-119
//   (core.lmath.safe_logsumexp): m = max; an all -inf row gives -inf
//   (branching before x - m, which would be -inf - -inf = NaN);
//   otherwise m + log(sum exp(x - m)) with the exponentials summed in
//   index order, as the plain version sums them. On finite inputs this
//   is the arithmetic of ffbs_fwd.cu (whose clamp at -1e30 never binds
//   there), so the two kernels' alphas are bitwise equal.
//
// Layout: batch-minor, lane n fastest — pi [K,N], A [K,K,N], obs/alpha
// [T,K,N], mask [T,N], ll [N] — so the 32 threads of a warp touch 32
// consecutive floats on every load and store (coalesced).
//
// What bounds it: the T-step recurrence is serial within a lane (K
// guarded logsumexps a step, each waiting on the last step's alpha), and
// a lane's bytes (obs and alpha, 2K floats a step) are few, so the time
// is the serial chain, far above the bytes-over-bandwidth bound. The
// next step's obs and mask are loaded one step ahead (register double-
// buffering), so a step waits on arithmetic and not on device-memory
// latency; the alpha store is fire-and-forget.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;

template <int K>
__device__ __forceinline__ float safe_lse(const float (&x)[K]) {
  float m = x[0];
#pragma unroll
  for (int i = 1; i < K; ++i) m = fmaxf(m, x[i]);
  if (m == -INFINITY) return -INFINITY;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) s += expf(x[i] - m);
  return m + logf(s);
}

template <int K>
__global__ void __launch_bounds__(kBlock)
semiring_filter_kernel(const float* __restrict__ pi,
                       const float* __restrict__ A,
                       const float* __restrict__ obs,
                       const float* __restrict__ mask, float* __restrict__ ll,
                       float* __restrict__ alpha_out, int T, int N) {
  const int n = blockIdx.x * kBlock + threadIdx.x;
  if (n >= N) return;
  const size_t sN = static_cast<size_t>(N);

  float a[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) a[i][j] = A[(i * K + j) * sN + n];

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
  float m_nx = 0.0f;
  if (T > 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) o_nx[k] = obs[(K + k) * sN + n];
    m_nx = mask[sN + n];
  }

  for (int t = 1; t < T; ++t) {
    float o[K];
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] = o_nx[k];
    const float m = m_nx;
    if (t + 1 < T) {
      const size_t row = static_cast<size_t>(t + 1);
#pragma unroll
      for (int k = 0; k < K; ++k) o_nx[k] = obs[(row * K + k) * sN + n];
      m_nx = mask[row * sN + n];
    }
    if (m > 0.0f) {
      float nw[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float x[K];
#pragma unroll
        for (int i = 0; i < K; ++i) x[i] = alpha[i] + a[i][j];
        nw[j] = safe_lse<K>(x) + o[j];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) alpha[k] = nw[k];
    }
    float* dst = alpha_out + static_cast<size_t>(t) * K * sN + n;
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k * sN] = alpha[k];
  }
  ll[n] = safe_lse<K>(alpha);
}

template <int K>
void launch(const float* pi, const float* A, const float* obs,
            const float* mask, float* ll, float* alpha, int T, int N,
            cudaStream_t stream) {
  const int grid = (N + kBlock - 1) / kBlock;
  semiring_filter_kernel<K><<<grid, kBlock, 0, stream>>>(pi, A, obs, mask, ll,
                                                         alpha, T, N);
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused one, or -1 for
// an unsupported K or an empty shape. Launches on `stream`, does not
// synchronise and allocates nothing: the caller owns every buffer.
extern "C" int hhmm_semiring_filter(int K, const float* pi, const float* A,
                                    const float* obs, const float* mask,
                                    float* ll, float* alpha, int T, int N,
                                    void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: launch<2>(pi, A, obs, mask, ll, alpha, T, N, s); break;
    case 3: launch<3>(pi, A, obs, mask, ll, alpha, T, N, s); break;
    case 4: launch<4>(pi, A, obs, mask, ll, alpha, T, N, s); break;
    case 8: launch<8>(pi, A, obs, mask, ll, alpha, T, N, s); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
