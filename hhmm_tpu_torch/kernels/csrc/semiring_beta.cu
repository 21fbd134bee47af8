// Guarded backward (beta) recursion — the second half of the decode's
// smoothing pass.
//
// Replaces: hhmm_tpu/kernels/pallas_semiring.py::_beta_kernel (line 510),
// launched by its pallas_call at line 696 in semiring_beta, which
// kernels/dispatch.py::backward_dispatch and smooth_dispatch reach for a
// homogeneous f32 log_A. The TPU kernel walks reversed (batch tile, time
// block) grid steps and carries beta, and the obs and mask rows crossing
// a block boundary, in VMEM scratch (carry, oc, mc). Here one thread owns
// one lane and walks t = T-2 .. 0 itself, so the only carried state is
// beta[K] and the successor's obs/mask rows, all in registers.
//
// Math, per lane (f32, in the TPU kernel's order of operations):
//   beta_{T-1} = 0
//   e[j]       = obs_{t+1}[j] + beta_{t+1}[j]
//   beta_t[i]  = mask_{t+1} > 0 ? safe_lse_j(A[i][j] + e[j]) : beta_{t+1}[i]
//   safe_lse is the guarded logsumexp (semiring_filter.cu): an all -inf
//   row gives -inf, never NaN; otherwise m + log(sum exp(x - m)), the
//   exponentials summed in index order as the plain version sums them.
//
// Layout: batch-minor, lane n fastest — A [K,K,N], obs/beta [T,K,N],
// mask [T,N] — coalesced across a warp.
//
// What bounds it: the serial T-step recursion within a lane (K guarded
// logsumexps of K terms a step); the bytes (obs in, beta out: 2K floats
// a step) are few. The next step's obs and mask rows do not depend on
// beta, so they are loaded one step ahead and a step waits only on its
// arithmetic; the beta store is fire-and-forget.

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
semiring_beta_kernel(const float* __restrict__ A, const float* __restrict__ obs,
                     const float* __restrict__ mask,
                     float* __restrict__ beta_out, int T, int N) {
  const int n = blockIdx.x * kBlock + threadIdx.x;
  if (n >= N) return;
  const size_t sN = static_cast<size_t>(N);

  float a[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) a[i][j] = A[(i * K + j) * sN + n];

  float beta[K];
  const size_t last = static_cast<size_t>(T - 1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    beta[k] = 0.0f;
    beta_out[(last * K + k) * sN + n] = 0.0f;
  }

  // the successor row t+1 of step t, loaded one step ahead
  float o_nx[K];
  float m_nx = 0.0f;
  if (T > 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) o_nx[k] = obs[(last * K + k) * sN + n];
    m_nx = mask[last * sN + n];
  }

  for (int t = T - 2; t >= 0; --t) {
    float o[K];
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] = o_nx[k];
    const float m = m_nx;
    if (t > 0) {
      const size_t row = static_cast<size_t>(t);
#pragma unroll
      for (int k = 0; k < K; ++k) o_nx[k] = obs[(row * K + k) * sN + n];
      m_nx = mask[row * sN + n];
    }
    if (m > 0.0f) {
      float e[K];
#pragma unroll
      for (int j = 0; j < K; ++j) e[j] = o[j] + beta[j];
      float nw[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float x[K];
#pragma unroll
        for (int j = 0; j < K; ++j) x[j] = a[i][j] + e[j];
        nw[i] = safe_lse<K>(x);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) beta[k] = nw[k];
    }
    float* dst = beta_out + static_cast<size_t>(t) * K * sN + n;
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k * sN] = beta[k];
  }
}

template <int K>
void launch(const float* A, const float* obs, const float* mask, float* beta,
            int T, int N, cudaStream_t stream) {
  const int grid = (N + kBlock - 1) / kBlock;
  semiring_beta_kernel<K><<<grid, kBlock, 0, stream>>>(A, obs, mask, beta, T, N);
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused one, or -1 for
// an unsupported K or an empty shape. Launches on `stream`, does not
// synchronise and allocates nothing: the caller owns every buffer.
extern "C" int hhmm_semiring_beta(int K, const float* A, const float* obs,
                                  const float* mask, float* beta, int T, int N,
                                  void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: launch<2>(A, obs, mask, beta, T, N, s); break;
    case 3: launch<3>(A, obs, mask, beta, T, N, s); break;
    case 4: launch<4>(A, obs, mask, beta, T, N, s); break;
    case 8: launch<8>(A, obs, mask, beta, T, N, s); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
