// FFBS pass 2: backward sampling by inverse CDF against pre-drawn
// uniforms, reading the forward pass's alpha residual.
//
// Replaces: hhmm_tpu/kernels/pallas_semiring.py::_bwd_sample_kernel
// (line 584), launched by its pallas_call at line 801 in semiring_ffbs.
// The TPU kernel walks reversed (batch tile, time block) grid steps and
// carries z and the successor's mask/gate rows across blocks in VMEM
// scratch (the zc/mc/gc carries). Here one thread owns one lane and walks
// t = T-1 .. 0 itself, so the only carried state is the drawn successor
// z_{t+1} and its mask/gate values, all in registers.
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
// Layout: batch-minor as in ffbs_fwd.cu — A [K,K,N], mask/gate/u [T,N],
// alpha [T,K,N], sk [K,N], z [T,N] int32 — coalesced across a warp.
//
// What bounds it: the serial chain z_{t+1} -> z_t over T steps; the
// bytes (alpha, u, mask: K+2 floats a step) are few. Everything a step
// reads except z_{t+1} is known in advance, so the next step's alpha, u,
// mask and gate are loaded one step ahead and a step waits only on the
// column select and the K-way inverse-CDF arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr float kClamp = -1.0e30f;
constexpr int kBlock = 128;

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

template <int K, bool GATED>
__global__ void __launch_bounds__(kBlock)
ffbs_bwd_sample_kernel(const float* __restrict__ A,
                       const float* __restrict__ mask,
                       const float* __restrict__ alpha,
                       const float* __restrict__ u,
                       const float* __restrict__ gate,
                       const float* __restrict__ sk, int* __restrict__ z_out,
                       int T, int N) {
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

  const size_t last = static_cast<size_t>(T - 1);
  float l[K];
#pragma unroll
  for (int k = 0; k < K; ++k) l[k] = alpha[(last * K + k) * sN + n];
  int zn = invcdf<K>(l, u[last * sN + n]);
  z_out[last * sN + n] = zn;
  float m_next = mask[last * sN + n];
  float g_next = GATED ? gate[last * sN + n] : 0.0f;

  // step t's inputs, loaded one step ahead
  float al_nx[K];
  float u_nx = 0.0f, m_nx = 0.0f, g_nx = 0.0f;
  if (T > 1) {
    const size_t row = last - 1;
#pragma unroll
    for (int k = 0; k < K; ++k) al_nx[k] = alpha[(row * K + k) * sN + n];
    u_nx = u[row * sN + n];
    m_nx = mask[row * sN + n];
    if (GATED) g_nx = gate[row * sN + n];
  }

  for (int t = T - 2; t >= 0; --t) {
    float al[K];
#pragma unroll
    for (int k = 0; k < K; ++k) al[k] = al_nx[k];
    const float ut = u_nx, mt = m_nx, gt = g_nx;
    if (t > 0) {
      const size_t row = static_cast<size_t>(t - 1);
#pragma unroll
      for (int k = 0; k < K; ++k) al_nx[k] = alpha[(row * K + k) * sN + n];
      u_nx = u[row * sN + n];
      m_nx = mask[row * sN + n];
      if (GATED) g_nx = gate[row * sN + n];
    }

    // A[:, z_{t+1}] and sk[z_{t+1}] by unrolled select: a dynamic
    // register index would spill the arrays to local memory
    float col[K];
    float sk_z = skr[0];
#pragma unroll
    for (int i = 0; i < K; ++i) col[i] = a[i][0];
#pragma unroll
    for (int j = 1; j < K; ++j) {
      if (zn == j) {
#pragma unroll
        for (int i = 0; i < K; ++i) col[i] = a[i][j];
        sk_z = skr[j];
      }
    }
    float g = (m_next > 0.0f) ? 1.0f : 0.0f;
    if (GATED && !(g_next == sk_z)) g = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) l[k] = al[k] + g * col[k];
    zn = invcdf<K>(l, ut);
    z_out[static_cast<size_t>(t) * sN + n] = zn;
    m_next = mt;
    g_next = gt;
  }
}

template <int K, bool GATED>
void launch(const float* A, const float* mask, const float* alpha,
            const float* u, const float* gate, const float* sk, int* z, int T,
            int N, cudaStream_t stream) {
  const int grid = (N + kBlock - 1) / kBlock;
  ffbs_bwd_sample_kernel<K, GATED><<<grid, kBlock, 0, stream>>>(
      A, mask, alpha, u, gate, sk, z, T, N);
}

template <int K>
void launch_k(int gated, const float* A, const float* mask,
              const float* alpha, const float* u, const float* gate,
              const float* sk, int* z, int T, int N, cudaStream_t stream) {
  if (gated)
    launch<K, true>(A, mask, alpha, u, gate, sk, z, T, N, stream);
  else
    launch<K, false>(A, mask, alpha, u, gate, sk, z, T, N, stream);
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused one, or -1 for
// an unsupported K. Launches on `stream`, does not synchronise and
// allocates nothing.
extern "C" int hhmm_ffbs_bwd_sample(int K, int gated, const float* A,
                                    const float* mask, const float* alpha,
                                    const float* u, const float* gate,
                                    const float* sk, int* z, int T, int N,
                                    void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: launch_k<2>(gated, A, mask, alpha, u, gate, sk, z, T, N, s); break;
    case 3: launch_k<3>(gated, A, mask, alpha, u, gate, sk, z, T, N, s); break;
    case 4: launch_k<4>(gated, A, mask, alpha, u, gate, sk, z, T, N, s); break;
    case 8: launch_k<8>(gated, A, mask, alpha, u, gate, sk, z, T, N, s); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
