// One whole HMC/ChEES trajectory of the stan-gate Tayal HHMM per launch:
// n = min(n_steps, cap) leapfrogs for every lane (series x chain).
//
// Replaces: hhmm_tpu/kernels/pallas_traj.py::_traj_kernel (line 122),
// launched by its pallas_call at line 389 in tayal_trajectory, which
// make_tayal_trajectory hands to infer/chees.py as its trajectory_fn.
// Same function, not the same schedule: the TPU kernel holds a 128-lane
// tile's positions, filter and accumulators in VMEM (two [T, 4, 128]
// scratches and one [T, 128]) and builds the [T, 4] emission matrix of
// every leapfrog with a 9-term one-hot contraction. Here one thread owns
// one lane and runs its whole trajectory alone:
//
// per leapfrog, per lane (f32, in the TPU kernel's order of operations):
//   p += (eps/2) g; q += (eps * inv_mass) p
//   unpack q (35 coordinates): p_11 = sigmoid(q0); A_row rows are
//     2-simplexes (z = sigmoid(q1), sigmoid(q2)); phi_k rows are Stan
//     stick-breaking 9-simplexes (offsets -log(8 - d)); log|J| summed as
//     core/bijectors.py has it (log-sigmoid = min(x, 0) - log1p(exp(-|x|)))
//   sparse linear A (structural zeros exact) and the entry-gated pi
//     (p_11 on state 0 for a down first leg, 1 - p_11 on state 2 for an
//     up one, unit factor elsewhere)
//   scaled forward filter: w_j = (sum_i alpha_i Ae_ij) phi_j[x_t],
//     c_t = sum_j w_j, alpha = w / c_t (a masked step keeps alpha, c_t = 1),
//     ll = sum_t log c_t; Ae_ij = A_ij on a sign-consistent destination j,
//     1 elsewhere (stan gate: c[t, j] = sign_t == state_sign_j)
//   backward: beta_{T-1} = 1; gamma_t = alpha_t beta_t m_t accumulated per
//     symbol into d_phi[k][x_t]; e_j = phi_j[x_t] beta_j / c_t;
//     xi_ij = alpha_{t-1,i} Ae_ij e_j [sign-consistent j] m_t into d_A;
//     beta_i = sum_j Ae_ij e_j on an unmasked step; d_pi = gamma_0
//   chain rule to the 35 coordinates (suffix-sum stick-breaking VJP plus
//     the log-Jacobian gradients), logp = ll + log|J|
//   p += (eps/2) g
//
// Layout: q, p, grad [35, N] and inv_mass [35, B]; x, sign [T, B] int32,
// mask [T, B] f32, with the series of lane n at b = n / C, so the data is
// never repeated per chain; alpha scratch [T, 4, N] and normaliser
// scratch [T, N] f32, allocated by the wrapper. All lane-fastest, so a
// warp's loads and stores coalesce (the C chains of one series read the
// same data word).
//
// What bounds it: the serial T-step forward and backward recursions of a
// lane, 2T dependent steps a leapfrog; the bytes (alpha and c, 5 floats
// a step written and read back, which sit in the 50 MB L2 at N = 512)
// and the operations are far below what the card could do in that time.
// The design keeps each step short and off device memory:
//   - per-step alpha and c go to the device scratch (no per-lane T x 4
//     array fits on chip at T = 1024), batch-minor, so the write and the
//     read back coalesce; the next step's x, sign, mask (and in the
//     backward pass alpha_{t-1}, c_t) are loaded one step ahead;
//   - emissions are read as phi[k][x_t] from a per-thread slab of shared
//     memory instead of being stored per step, and the per-symbol
//     accumulator d_phi[k][x_t] lives in a second slab: both are indexed
//     by the run-time symbol, which in registers would go to local
//     memory (slabs are [36][128] floats, thread-fastest: no bank
//     conflicts);
//   - q, p, grad and inv_mass (140 floats a lane) live in the output
//     buffers in device memory, touched 35 floats at a time before and
//     after the T loops, so the loops hold only alpha, beta, the four
//     free transition gradients and scalars in registers;
//   - eps and n_steps are read from device memory, so a transition needs
//     no host sync.
// At N = 512 lanes only 4 blocks of 128 threads run (an occupancy gap
// noted for a later change).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int K = 4;
constexpr int L = 9;
constexpr int DIM = 35;
// state sign groups: states {1, 2} emit up legs (0), {0, 3} down legs (1)
__device__ __forceinline__ int state_sign(int j) { return (j == 1 || j == 2) ? 0 : 1; }

__device__ __forceinline__ float logsig(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(kBlock)
tayal_traj_kernel(const float* __restrict__ q_in, const float* __restrict__ p_in,
                  const float* __restrict__ g_in, const float* __restrict__ im,
                  const int* __restrict__ xs, const int* __restrict__ signs,
                  const float* __restrict__ mask, const float* __restrict__ eps_p,
                  const int* __restrict__ n_p, float* __restrict__ q,
                  float* __restrict__ p, float* __restrict__ g,
                  float* __restrict__ lp, float* __restrict__ alpha_scr,
                  float* __restrict__ c_scr, int cap, int C, int T, int N,
                  int B) {
  __shared__ float phi_s[K * L][kBlock];
  __shared__ float dem_s[K * L][kBlock];
  const int tid = threadIdx.x;
  const int n = blockIdx.x * kBlock + tid;
  if (n >= N) return;  // no block-wide barrier below: each thread owns its slab column
  const int b = n / C;
  const size_t sN = static_cast<size_t>(N);
  const size_t sB = static_cast<size_t>(B);
  const size_t sKN = static_cast<size_t>(K) * sN;

  for (int d = 0; d < DIM; ++d) {
    q[d * sN + n] = q_in[d * sN + n];
    p[d * sN + n] = p_in[d * sN + n];
    g[d * sN + n] = g_in[d * sN + n];
  }
  const float eps = *eps_p;
  const int steps = min(*n_p, cap);
  const float hs = 0.5f * eps;
  const float ed = (signs[b] == 1) ? 1.0f : 0.0f;  // pi factor on state 0
  const float eu = 1.0f - ed;                      // pi factor on state 2
  float logp = 0.0f;

  for (int it = 0; it < steps; ++it) {
    // ---- first half-step of momentum, full step of position ----
    for (int d = 0; d < DIM; ++d) {
      const float pd = p[d * sN + n] + hs * g[d * sN + n];
      p[d * sN + n] = pd;
      q[d * sN + n] = q[d * sN + n] + (eps * im[d * sB + b]) * pd;
    }

    // ---- unpack ----
    const float q0 = q[n];
    const float p11 = sigmoid(q0);
    float ldj = logsig(q0) + logsig(-q0);
    float zA[2], ta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v = q[(1 + i) * sN + n];
      zA[i] = sigmoid(v);
      ta[i] = logsig(v) + logsig(-v);
    }
    ldj = ldj + (ta[0] + ta[1]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float acc = 0.0f, ldk = 0.0f;
#pragma unroll
      for (int d = 0; d < L - 1; ++d) {
        const float logit = q[(3 + 8 * k + d) * sN + n] - logf(8.0f - static_cast<float>(d));
        const float lz = logsig(logit), l1 = logsig(-logit);
        phi_s[k * L + d][tid] = expf(lz + acc);
        ldk += (lz + l1) + acc;
        acc += l1;
      }
      phi_s[k * L + L - 1][tid] = expf(acc);
      ldj += ldk;
    }
    const float A[K][K] = {{0.0f, zA[0], 1.0f - zA[0], 0.0f},
                           {1.0f, 0.0f, 0.0f, 0.0f},
                           {zA[1], 0.0f, 0.0f, 1.0f - zA[1]},
                           {0.0f, 0.0f, 1.0f, 0.0f}};
    const float pe[K] = {ed * p11 + (1.0f - ed), 1.0f, eu * (1.0f - p11) + (1.0f - eu), 1.0f};

    // ---- scaled forward filter ----
    float al[K];
    {
      const int x0 = xs[b];
      const bool v0 = mask[b] > 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) al[k] = v0 ? pe[k] * phi_s[k * L + x0][tid] : pe[k];
    }
    float c0 = al[0] + al[1] + al[2] + al[3];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      al[k] = al[k] / c0;
      alpha_scr[k * sN + n] = al[k];
    }
    c_scr[n] = c0;
    float ll = logf(c0);

    int x_nx = 0, s_nx = 0;
    float m_nx = 0.0f;
    if (T > 1) {
      x_nx = xs[sB + b];
      s_nx = signs[sB + b];
      m_nx = mask[sB + b];
    }
    for (int t = 1; t < T; ++t) {
      const int xt = x_nx, st = s_nx;
      const float mt = m_nx;
      if (t + 1 < T) {
        const size_t row = static_cast<size_t>(t + 1) * sB + b;
        x_nx = xs[row];
        s_nx = signs[row];
        m_nx = mask[row];
      }
      float w[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool on = st == state_sign(j);
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < K; ++i) s += al[i] * (on ? A[i][j] : 1.0f);
        w[j] = s * phi_s[j * L + xt][tid];
      }
      float c = w[0] + w[1] + w[2] + w[3];
      if (mt > 0.0f) {
#pragma unroll
        for (int k = 0; k < K; ++k) al[k] = w[k] / c;
      } else {
        c = 1.0f;
      }
      float* dst = alpha_scr + static_cast<size_t>(t) * sKN + n;
#pragma unroll
      for (int k = 0; k < K; ++k) dst[k * sN] = al[k];
      c_scr[static_cast<size_t>(t) * sN + n] = c;
      ll += logf(c);
    }

    // ---- backward pass with the Baum-Welch accumulators ----
#pragma unroll
    for (int r = 0; r < K * L; ++r) dem_s[r][tid] = 0.0f;
    float be[K] = {1.0f, 1.0f, 1.0f, 1.0f};
    float dA01 = 0.0f, dA02 = 0.0f, dA20 = 0.0f, dA23 = 0.0f;
    // al holds alpha_{T-1}; step t's x, sign, mask, c_t and alpha_{t-1}
    // are loaded one step ahead
    float a_nx[K], c_nx = 1.0f;
    if (T > 1) {
      const size_t last = static_cast<size_t>(T - 1);
      x_nx = xs[last * sB + b];
      s_nx = signs[last * sB + b];
      m_nx = mask[last * sB + b];
      c_nx = c_scr[last * sN + n];
#pragma unroll
      for (int k = 0; k < K; ++k) a_nx[k] = alpha_scr[(last - 1) * sKN + k * sN + n];
    }
    for (int t = T - 1; t >= 1; --t) {
      const int xt = x_nx, st = s_nx;
      const float mt = m_nx, ct = c_nx;
      float ap[K];
#pragma unroll
      for (int k = 0; k < K; ++k) ap[k] = a_nx[k];
      if (t >= 2) {
        const size_t row = static_cast<size_t>(t - 1);
        x_nx = xs[row * sB + b];
        s_nx = signs[row * sB + b];
        m_nx = mask[row * sB + b];
        c_nx = c_scr[row * sN + n];
#pragma unroll
        for (int k = 0; k < K; ++k) a_nx[k] = alpha_scr[(row - 1) * sKN + k * sN + n];
      }
      const bool valid = mt > 0.0f;
      if (valid) {
#pragma unroll
        for (int k = 0; k < K; ++k) dem_s[k * L + xt][tid] += al[k] * be[k];
      }
      float e[K], gt[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        gt[j] = (st == state_sign(j)) ? 1.0f : 0.0f;
        e[j] = phi_s[j * L + xt][tid] * be[j] / ct;
      }
      if (valid) {
        dA01 += ap[0] * A[0][1] * e[1] * gt[1];
        dA02 += ap[0] * A[0][2] * e[2] * gt[2];
        dA20 += ap[2] * A[2][0] * e[0] * gt[0];
        dA23 += ap[2] * A[2][3] * e[3] * gt[3];
      }
      float nb[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < K; ++j) s += (gt[j] > 0.0f ? A[i][j] : 1.0f) * e[j];
        nb[i] = s;
      }
      if (valid) {
#pragma unroll
        for (int k = 0; k < K; ++k) be[k] = nb[k];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) al[k] = ap[k];
    }
    float dpi[K];
    {
      const int x0 = xs[b];
      const bool v0 = mask[b] > 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        dpi[k] = al[k] * be[k];
        if (v0) dem_s[k * L + x0][tid] += dpi[k];
      }
    }

    // ---- chain rule to the 35 coordinates; second half-step ----
    float gr[3];
    gr[0] = dpi[0] * ed * (1.0f - p11) - dpi[2] * eu * p11 + (1.0f - 2.0f * p11);
    gr[1] = dA01 * (1.0f - zA[0]) - zA[0] * dA02 + (1.0f - 2.0f * zA[0]);
    gr[2] = dA20 * (1.0f - zA[1]) - zA[1] * dA23 + (1.0f - 2.0f * zA[1]);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      g[d * sN + n] = gr[d];
      p[d * sN + n] = p[d * sN + n] + hs * gr[d];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float acc_s = dem_s[k * L + L - 1][tid];
#pragma unroll
      for (int j = L - 2; j >= 0; --j) {
        const float gj = dem_s[k * L + j][tid];
        const size_t row = static_cast<size_t>(3 + 8 * k + j) * sN + n;
        const float logit = q[row] - logf(8.0f - static_cast<float>(j));
        const float z = expf(logsig(logit));
        const float dldj = (1.0f - 2.0f * z) - z * (static_cast<float>(L - 2) - static_cast<float>(j));
        const float gd = gj * (1.0f - z) - z * acc_s + dldj;
        g[row] = gd;
        p[row] = p[row] + hs * gd;
        acc_s = acc_s + gj;
      }
    }
    logp = ll + ldj;
  }
  lp[n] = logp;
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused one, or -1 for
// an empty or inconsistent shape. Launches on `stream`, does not
// synchronise and allocates nothing: the caller owns every buffer,
// including the alpha [T, 4, N] and normaliser [T, N] scratch.
extern "C" int hhmm_tayal_traj(const float* q_in, const float* p_in,
                               const float* g_in, const float* inv_mass,
                               const int* x, const int* sign, const float* mask,
                               const float* eps, const int* n_steps, float* q,
                               float* p, float* g, float* lp, float* alpha_scr,
                               float* c_scr, int cap, int C, int T, int N,
                               int B, void* stream) {
  if (T < 1 || N < 1 || C < 1 || B * C != N) return -1;
  const int grid = (N + kBlock - 1) / kBlock;
  tayal_traj_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      q_in, p_in, g_in, inv_mass, x, sign, mask, eps, n_steps, q, p, g, lp,
      alpha_scr, c_scr, cap, C, T, N, B);
  return static_cast<int>(cudaGetLastError());
}
