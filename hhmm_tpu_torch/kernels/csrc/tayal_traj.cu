// One whole HMC/ChEES trajectory of the stan-gate Tayal HHMM per launch:
// n = min(n_steps, cap) leapfrogs for every lane (series x chain).
//
// Replaces: hhmm_tpu/kernels/pallas_traj.py::_traj_kernel (line 122),
// launched by its pallas_call at line 389 in tayal_trajectory, which
// make_tayal_trajectory hands to infer/chees.py as its trajectory_fn.
// Same function, not the same schedule: the TPU kernel holds a 128-lane
// tile's positions, filter and accumulators in VMEM (two [T, 4, 128]
// scratches and one [T, 128]) and builds the [T, 4] emission matrix of
// every leapfrog with a 9-term one-hot contraction.
//
// Per leapfrog, per lane (f32):
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
//   backward: beta_{T-1} = 1; e_j = phi_j[x_t] beta_j / c_t;
//     beta_i = sum_j Ae_ij e_j on an unmasked step; then
//     gamma_t = alpha_t beta_t m_t summed per symbol into d_phi[k][x_t],
//     xi_ij = alpha_{t-1,i} Ae_ij e_j [sign-consistent j] m_t into d_A,
//     d_pi = alpha_0 beta_0
//   chain rule to the 35 coordinates (suffix-sum stick-breaking VJP plus
//     the log-Jacobian gradients), logp = ll + log|J|
//   p += (eps/2) g
//
// Layout: q, p, grad [35, N] and inv_mass [35, B]; x, sign [T, B] int32,
// mask [T, B] f32, with the series of lane n at b = n / C.
//
// What bounds it: the two serial T-step recursions of a lane (alpha
// forward, beta backward), 2T dependent steps a leapfrog; bytes and
// operations are far below what the card could do in that time. So the
// design keeps everything else off those two chains:
//   - a warp per lane, kWarps warps a block: N = 512 lanes fill 128 SMs
//     with one lane chain a scheduler (one thread a lane on 4 SMs before);
//   - the lane's series is staged once a launch into shared memory, one
//     byte a step (x in 4 bits, sign, valid), and read by the recursions
//     kChunk steps at a time: the next chunk's 16-byte loads are issued
//     while this one runs, so no step waits on a load;
//   - q, p, grad and inv_mass live in registers for the whole launch:
//     thread d owns coordinate d, threads 0-2 also 32-34; the leapfrog
//     updates, the unpack and the chain rule run over coordinates in
//     parallel, and each value is read once and written once a launch;
//   - only the two recursions are serial, on thread 0 of the warp, and
//     each step does only what feeds the next, branch-free. The forward
//     carries v_t, alpha_t up to a positive scale: w_j = u_j(v) o_t[j]
//     (the gate picks one of two closed sparse forms of the 4x4 product)
//     times sigma_t = 2^-E(sum v_{t-1}), an exact power of two that keeps
//     the carry near 1, so no division or reciprocal sits on the chain.
//     Pass A (the warp) then gives r_t = 1 / c_t = sigma_t sum v_{t-1} /
//     sum v_t (one division a step), ll = -sum_t log r_t and f_t = o_t r_t,
//     and normalises alpha_t = v_t / sum v_t in place; the backward is
//     e = f_t beta_t and the closed sparse form of beta_{t-1} =
//     sum_j Ae_ij e_j. Each recursion step reads one 16-byte slot (o_t,
//     then f_t, precomputed by the warp) and writes one (v_t, then
//     beta_t, over it);
//   - the whole warp then reduces the 36 per-symbol gamma sums, the four
//     d_A sums and d_pi from the stored alpha, beta and r (pass B), with
//     no division: in both passes thread l takes steps l, l + 32, ...
//     (conflict-free 16-byte loads), then a fixed xor-shuffle tree. No
//     atomics: every sum has a fixed order, so a launch repeats bit for
//     bit.
// Running the backward on a second warp at the same time as the forward
// (with its own power-of-two scale) was measured no faster at N = 512:
// two chains then share each scheduler, and issue, not latency, sets the
// pace. It was faster on one lane only.
// Shared memory a warp: kSmall floats of tables plus the two slots V
// (o_t, then v_t, then alpha_t) and W (f_t, then beta_t), 16 bytes a
// step each, r (4) and the series (1): 37 bytes a step, T
// rounded up to kTPad. At T = 1024 that is 38.9 KB a warp, 152 KB for a
// block of four. Up to T = 1536 a block holds kWarps lanes, up to 6240
// fewer; past that the wrapper passes a device scratch of 37 bytes a step
// a lane and the same code keeps V, W, r and the series there.
// The same function as the plain version in exact arithmetic, with other
// roundings (the scaled carry, r_t as a ratio, the reductions' order):
// held to it within tolerances, not bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;       // lanes a block, at most
constexpr int kChunk = 16;      // steps a register chunk of the recursions (16 or 32)
constexpr int kTPad = 32;       // T is rounded up to this (a multiple of kChunk)
constexpr int kSmall = 256;     // floats of small tables a warp
constexpr int kStepBytes = 37;  // V 16 + W 16 + r 4 + series 1
constexpr int kSmemMax = 232448;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunk % 16 == 0 && kTPad % kChunk == 0, "chunks of 16-byte loads");

// offsets of the small tables (floats)
constexpr int oPhi = 0;     // [36] phi[k * 9 + l]
constexpr int oDem = 40;    // [36] per-symbol gamma sums
constexpr int oQ = 80;      // [3] q0, q1, q2
constexpr int oLz = 96;     // [32] log z of each stick
constexpr int oL1 = 128;    // [32] log(1 - z)
constexpr int oTerm = 160;  // [32] log-Jacobian term of each stick

__host__ __device__ inline int pad_t(int T) { return (T + kTPad - 1) / kTPad * kTPad; }

__device__ __forceinline__ float logsig(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// kChunk series bytes from t0 (a multiple of kChunk), as words
__device__ __forceinline__ void load_series(uint32_t (&w)[kChunk / 4], const uint8_t* ser, int t0) {
  const uint4* p = reinterpret_cast<const uint4*>(ser + t0);
#pragma unroll
  for (int i = 0; i < kChunk / 16; ++i) {
    const uint4 v = p[i];
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ unsigned byte_of(const uint32_t (&w)[kChunk / 4], int k) {
  return (w[k >> 2] >> ((k & 3) * 8)) & 0xffu;
}

// 2^-E for a positive normal x = m 2^E (m in [1, 2)): x times it is m,
// exactly
__device__ __forceinline__ float pow2_inv(float x) {
  return __uint_as_float(0x7f000000u - (__float_as_uint(x) & 0x7f800000u));
}

__device__ __forceinline__ float sum4(float4 v) { return (v.x + v.y) + (v.z + v.w); }

__device__ __forceinline__ float4 emissions(const float* phi, unsigned x) {
  return make_float4(phi[x], phi[9 + x], phi[18 + x], phi[27 + x]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <bool SCRATCH>
__global__ void __launch_bounds__(kWarps * 32)
tayal_traj_kernel(const float* __restrict__ q_in, const float* __restrict__ p_in,
                  const float* __restrict__ g_in, const float* __restrict__ im,
                  const int* __restrict__ xs, const int* __restrict__ signs,
                  const float* __restrict__ mask, const float* __restrict__ eps_p,
                  const int* __restrict__ n_p, float* __restrict__ q_out,
                  float* __restrict__ p_out, float* __restrict__ g_out,
                  float* __restrict__ lp, uint8_t* __restrict__ scratch, int cap,
                  int C, int T, int N, int B) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int n = blockIdx.x * (blockDim.x >> 5) + w;
  if (n >= N) return;  // a whole warp; no block-wide barrier below
  const int b = n / C;
  const int Tp = pad_t(T);
  const size_t lane_bytes = static_cast<size_t>(kStepBytes) * Tp;
  float* sm;
  uint8_t* base;
  if (SCRATCH) {
    sm = reinterpret_cast<float*>(smem) + w * kSmall;
    base = scratch + static_cast<size_t>(n) * lane_bytes;
  } else {
    sm = reinterpret_cast<float*>(smem + w * (kSmall * 4 + lane_bytes));
    base = reinterpret_cast<uint8_t*>(sm + kSmall);
  }
  float4* V = reinterpret_cast<float4*>(base);  // o_t, then v_t
  float4* W = V + Tp;                            // f_t, then beta_t
  float* cbuf = reinterpret_cast<float*>(W + Tp);  // r_t = 1 / c_t
  uint8_t* ser = reinterpret_cast<uint8_t*>(cbuf + Tp);
  const size_t sN = static_cast<size_t>(N);
  const size_t sB = static_cast<size_t>(B);

  // the series, one byte a step: x | sign << 4 | valid << 5 (0 past T)
  for (int t = lane; t < Tp; t += 32) {
    uint32_t v = 0;
    if (t < T) {
      const size_t r = static_cast<size_t>(t) * sB + b;
      v = (static_cast<uint32_t>(xs[r]) & 15u) | ((static_cast<uint32_t>(signs[r]) & 1u) << 4) |
          (mask[r] > 0.0f ? 32u : 0u);
    }
    ser[t] = static_cast<uint8_t>(v);
  }

  // this thread's coordinates: d = lane, and 32 + lane for lanes 0-2
  const bool two = lane < 3;
  const int d1 = 32 + lane;
  float q0 = q_in[lane * sN + n], p0 = p_in[lane * sN + n], g0 = g_in[lane * sN + n];
  const float m0 = im[lane * sB + b];
  float q1 = 0.0f, p1 = 0.0f, g1 = 0.0f, m1 = 0.0f;
  if (two) {
    q1 = q_in[d1 * sN + n];
    p1 = p_in[d1 * sN + n];
    g1 = g_in[d1 * sN + n];
    m1 = im[d1 * sB + b];
  }
  // stick offsets log(8 - j) of a phi coordinate d >= 3 (j = (d - 3) % 8)
  const float off0 = lane >= 3 ? logf(8.0f - static_cast<float>((lane - 3) & 7)) : 0.0f;
  const float off1 = logf(8.0f - static_cast<float>((d1 - 3) & 7));
  const float eps = *eps_p;
  const int steps = min(*n_p, cap);
  const float hs = 0.5f * eps;
  const float ed = (signs[b] == 1) ? 1.0f : 0.0f;  // pi factor on state 0
  const float eu = 1.0f - ed;                      // pi factor on state 2
  const int last = (T - 1) / kChunk;               // chunk holding step T - 1
  const float* phi = sm + oPhi;
  float logp = 0.0f;
  __syncwarp();

  for (int it = 0; it < steps; ++it) {
    // ---- first half-step of momentum, full step of position ----
    p0 = p0 + hs * g0;
    q0 = q0 + (eps * m0) * p0;
    if (two) {
      p1 = p1 + hs * g1;
      q1 = q1 + (eps * m1) * p1;
    }

    // ---- unpack: each coordinate's sticks in parallel ----
    float lz0 = 0.0f, lz1 = 0.0f;
    if (lane < 3) {
      sm[oQ + lane] = q0;
    } else {
      const float logit = q0 - off0;
      lz0 = logsig(logit);
      sm[oLz + lane - 3] = lz0;
      sm[oL1 + lane - 3] = logsig(-logit);
    }
    if (two) {
      const float logit = q1 - off1;
      lz1 = logsig(logit);
      sm[oLz + d1 - 3] = lz1;
      sm[oL1 + d1 - 3] = logsig(-logit);
    }
    __syncwarp();
    // phi[k][m] = exp(log z_m + sum_{d < m} log(1 - z_d)), the running sum
    // in stick order; thread i takes entry i (and 32 + i for i < 4)
    auto phi_entry = [&](int i) {
      const int k = i / 9, m = i - 9 * k;
      float acc = 0.0f;
      for (int d = 0; d < m; ++d) acc += sm[oL1 + 8 * k + d];
      if (m < 8) {
        const float lz = sm[oLz + 8 * k + m];
        sm[oPhi + i] = expf(lz + acc);
        sm[oTerm + 8 * k + m] = (lz + sm[oL1 + 8 * k + m]) + acc;
      } else {
        sm[oPhi + i] = expf(acc);
      }
    };
    phi_entry(lane);
    if (lane < 4) phi_entry(32 + lane);
    const float qa = sm[oQ], qb = sm[oQ + 1], qc = sm[oQ + 2];
    const float p11 = sigmoid(qa), zA0 = sigmoid(qb), zA1 = sigmoid(qc);
    const float z0 = zA0, omz0 = 1.0f - zA0, z1 = zA1, omz1 = 1.0f - zA1;
    __syncwarp();

    // log|J| in the plain version's order (lane 0 keeps it)
    float ldj = 0.0f;
    if (lane == 0) {
      ldj = logsig(qa) + logsig(-qa);
      const float ta0 = logsig(qb) + logsig(-qb), ta1 = logsig(qc) + logsig(-qc);
      ldj = ldj + (ta0 + ta1);
      for (int k = 0; k < 4; ++k) {
        float ldk = 0.0f;
        for (int d = 0; d < 8; ++d) ldk += sm[oTerm + 8 * k + d];
        ldj += ldk;
      }
    }

    // ---- every step's emissions o_t[j] = phi_j[x_t], into slot t of V ----
#pragma unroll 4
    for (int t = lane; t < T; t += 32) V[t] = emissions(phi, ser[t] & 15);
    __syncwarp();

    // ---- forward recursion (lane 0): v_t = sigma_t * w_t into V[t] ----
    // v_{t-1} is alpha_{t-1} up to a positive scale; w_j = u_j(v) o_j is
    // the plain step's numerator at that scale, and sigma_t = 2^-E(S_t),
    // S_t = sum v_{t-1}, keeps the carry near 1 (an exact power of two).
    // The normaliser c_t and alpha_t = v_t / sum v_t follow in pass A and
    // B, off the chain; a masked step carries v.
    if (lane == 0) {
      const float pe0 = ed * p11 + (1.0f - ed);
      const float pe2 = eu * (1.0f - p11) + (1.0f - eu);
      float v0, v1, v2, v3;
      {
        const float4 o = V[0];
        const bool val = ser[0] & 32u;
        v0 = val ? pe0 * o.x : pe0;
        v1 = val ? o.y : 1.0f;
        v2 = val ? pe2 * o.z : pe2;
        v3 = val ? o.w : 1.0f;
        V[0] = make_float4(v0, v1, v2, v3);
      }
      auto fstep = [&](unsigned bt, int t) {
        const float4 o = V[t];
        const float S = (v0 + v1) + (v2 + v3);  // a gated-off destination
        const float sg = pow2_inv(S);
        const bool dn = bt & 16u;  // down leg: destinations 0 and 3 take A
        const float u0 = dn ? v1 + v2 * z1 : S;
        const float u1 = dn ? S : v0 * z0;
        const float u2 = dn ? S : v0 * omz0 + v3;
        const float u3 = dn ? v2 * omz1 : S;
        const float w0 = u0 * (o.x * sg), w1 = u1 * (o.y * sg);
        const float w2 = u2 * (o.z * sg), w3 = u3 * (o.w * sg);
        const bool val = bt & 32u;
        v0 = val ? w0 : v0;
        v1 = val ? w1 : v1;
        v2 = val ? w2 : v2;
        v3 = val ? w3 : v3;
        V[t] = make_float4(v0, v1, v2, v3);
      };
      uint32_t nx[kChunk / 4], cw[kChunk / 4];
      load_series(nx, ser, 0);
      for (int ch = 0; ch <= last; ++ch) {
#pragma unroll
        for (int i = 0; i < kChunk / 4; ++i) cw[i] = nx[i];
        if (ch < last) load_series(nx, ser, (ch + 1) * kChunk);
        const int t0 = ch * kChunk;
        if (ch == 0 || ch == last) {
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            const int t = t0 + k;
            if (t >= 1 && t < T) fstep(byte_of(cw, k), t);
          }
        } else {
#pragma unroll
          for (int k = 0; k < kChunk; ++k) fstep(byte_of(cw, k), t0 + k);
        }
      }
    }
    __syncwarp();

    // ---- pass A (warp): r_t = 1 / c_t, ll, and f_t = o_t r_t into W[t] ----
    // c_0 = sum v_0; c_t = sum v_t / (sigma_t S_t) on an unmasked step,
    // with S_t and sigma_t recomputed bit for bit as the recursion had
    // them; 1 on a masked one
    float ll = 0.0f;
#pragma unroll 2
    for (int t = lane; t < T; t += 32) {
      const unsigned bt = ser[t];
      const float sv = sum4(V[t]);
      float r = 1.0f / sv;
      if (t >= 1) {
        const float sp = sum4(V[t - 1]);
        r = (bt & 32u) ? (pow2_inv(sp) * sp) / sv : 1.0f;
      }
      ll -= logf(r);
      cbuf[t] = r;
      const float4 o = emissions(phi, bt & 15);
      W[t] = make_float4(o.x * r, o.y * r, o.z * r, o.w * r);
    }
    __syncwarp();
    // ---- alpha_t = v_t / sum v_t, in place ----
#pragma unroll 2
    for (int t = lane; t < T; t += 32) {
      const float4 v = V[t];
      const float r = 1.0f / sum4(v);
      V[t] = make_float4(v.x * r, v.y * r, v.z * r, v.w * r);
    }

    // ---- backward recursion (lane 0): beta_t into W[t] ----
    // e_j = f_t[j] beta_j, beta_{t-1} = sum_j Ae_ij e_j on an unmasked
    // step; f_t is read from slot t before beta_t overwrites it
    if (lane == 0) {
      float b0 = 1.0f, b1 = 1.0f, b2 = 1.0f, b3 = 1.0f;
      auto bstep = [&](unsigned bt, int t) {
        const float4 f = W[t];
        W[t] = make_float4(b0, b1, b2, b3);
        const float e0 = f.x * b0, e1 = f.y * b1, e2 = f.z * b2, e3 = f.w * b3;
        const bool dn = bt & 16u;
        const float n0 = dn ? e1 + e2 : ((e0 + z0 * e1) + omz0 * e2) + e3;
        const float n1 = dn ? (e0 + e1) + e2 : e0 + e3;
        const float n2 = dn ? ((z1 * e0 + e1) + e2) + omz1 * e3 : e0 + e3;
        const float n3 = dn ? e1 + e2 : (e0 + e2) + e3;
        const bool val = bt & 32u;
        b0 = val ? n0 : b0;
        b1 = val ? n1 : b1;
        b2 = val ? n2 : b2;
        b3 = val ? n3 : b3;
      };
      uint32_t nx[kChunk / 4], cw[kChunk / 4];
      load_series(nx, ser, last * kChunk);
      for (int ch = last; ch >= 0; --ch) {
#pragma unroll
        for (int i = 0; i < kChunk / 4; ++i) cw[i] = nx[i];
        if (ch > 0) load_series(nx, ser, (ch - 1) * kChunk);
        const int t0 = ch * kChunk;
        if (ch == 0 || ch == last) {
#pragma unroll
          for (int k = kChunk - 1; k >= 0; --k) {
            const int t = t0 + k;
            if (t >= 1 && t < T) bstep(byte_of(cw, k), t);
          }
        } else {
#pragma unroll
          for (int k = kChunk - 1; k >= 0; --k) bstep(byte_of(cw, k), t0 + k);
        }
      }
      W[0] = make_float4(b0, b1, b2, b3);
    }
    __syncwarp();

    // ---- pass B (warp): the reductions over t, in a fixed order ----
    // gamma_t = alpha_t beta_t m_t per symbol and the d_A terms
    // alpha_{t-1,i} A_ij (o_t[j] beta_t[j] r_t) m_t on sign-consistent j
    float acc[36];
#pragma unroll
    for (int i = 0; i < 36; ++i) acc[i] = 0.0f;
    float dA01 = 0.0f, dA02 = 0.0f, dA20 = 0.0f, dA23 = 0.0f;
#pragma unroll 2
    for (int t = lane; t < T; t += 32) {
      const unsigned bt = ser[t];
      if (bt & 32u) {
        const float4 a = V[t], be = W[t];
        const float ga = a.x * be.x, gb = a.y * be.y, gc = a.z * be.z, gd = a.w * be.w;
        const int x = bt & 15;
#pragma unroll
        for (int l = 0; l < 9; ++l) {
          if (x == l) {
            acc[l] += ga;
            acc[9 + l] += gb;
            acc[18 + l] += gc;
            acc[27 + l] += gd;
          }
        }
        if (t >= 1) {
          const float4 ap = V[t - 1];
          const float rt = cbuf[t];
          if (bt & 16u) {
            dA20 += ap.z * z1 * ((phi[x] * be.x) * rt);
            dA23 += ap.z * omz1 * ((phi[27 + x] * be.w) * rt);
          } else {
            dA01 += ap.x * z0 * ((phi[9 + x] * be.y) * rt);
            dA02 += ap.x * omz0 * ((phi[18 + x] * be.z) * rt);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 36; ++i) acc[i] = warp_sum(acc[i]);
    dA01 = warp_sum(dA01);
    dA02 = warp_sum(dA02);
    dA20 = warp_sum(dA20);
    dA23 = warp_sum(dA23);
    ll = warp_sum(ll);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 36; ++i) sm[oDem + i] = acc[i];
    }
    const float4 al0 = V[0], be0 = W[0];
    const float dpi0 = al0.x * be0.x, dpi2 = al0.z * be0.z;
    __syncwarp();

    // ---- chain rule to the coordinates; second half-step ----
    auto grad_of = [&](int d, float lz) -> float {
      if (d == 0) return dpi0 * ed * (1.0f - p11) - dpi2 * eu * p11 + (1.0f - 2.0f * p11);
      if (d == 1) return dA01 * (1.0f - zA0) - zA0 * dA02 + (1.0f - 2.0f * zA0);
      if (d == 2) return dA20 * (1.0f - zA1) - zA1 * dA23 + (1.0f - 2.0f * zA1);
      const int k = (d - 3) >> 3, j = (d - 3) & 7;
      const float* dem = sm + oDem + 9 * k;
      float acc_s = dem[8];
      for (int m = 7; m > j; --m) acc_s = acc_s + dem[m];
      const float z = expf(lz);
      const float dldj = (1.0f - 2.0f * z) - z * static_cast<float>(7 - j);
      return dem[j] * (1.0f - z) - z * acc_s + dldj;
    };
    g0 = grad_of(lane, lz0);
    p0 = p0 + hs * g0;
    if (two) {
      g1 = grad_of(d1, lz1);
      p1 = p1 + hs * g1;
    }
    logp = ll + ldj;
    __syncwarp();
  }

  q_out[lane * sN + n] = q0;
  p_out[lane * sN + n] = p0;
  g_out[lane * sN + n] = g0;
  if (two) {
    q_out[d1 * sN + n] = q1;
    p_out[d1 * sN + n] = p1;
    g_out[d1 * sN + n] = g1;
  }
  if (lane == 0) lp[n] = logp;
}

// bytes of shared memory one lane takes on the shared-memory path
int lane_smem_bytes(int T) { return kSmall * 4 + kStepBytes * pad_t(T); }

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused one, or -1 for
// an empty or inconsistent shape, or a T whose buffers do not fit shared
// memory without a scratch. Launches on `stream`, does not synchronise and
// allocates nothing: the caller owns every buffer. With `scratch` (at
// least N * kStepBytes * pad_t(T) bytes, 16-byte aligned) the per-step
// buffers live there instead of in shared memory.
extern "C" int hhmm_tayal_traj(const float* q_in, const float* p_in,
                               const float* g_in, const float* inv_mass,
                               const int* x, const int* sign, const float* mask,
                               const float* eps, const int* n_steps, float* q,
                               float* p, float* g, float* lp, void* scratch,
                               int cap, int C, int T, int N, int B, void* stream) {
  if (T < 1 || N < 1 || C < 1 || B * C != N) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* scr = static_cast<uint8_t*>(scratch);
  if (scr != nullptr) {
    const int grid = (N + kWarps - 1) / kWarps;
    tayal_traj_kernel<true><<<grid, kWarps * 32, kWarps * kSmall * 4, s>>>(
        q_in, p_in, g_in, inv_mass, x, sign, mask, eps, n_steps, q, p, g, lp, scr,
        cap, C, T, N, B);
    return static_cast<int>(cudaGetLastError());
  }
  const int per_warp = lane_smem_bytes(T);
  if (per_warp > kSmemMax) return -1;
  int warps = kWarps;
  while (warps > 1 && warps * per_warp > kSmemMax) warps >>= 1;
  const cudaError_t e = cudaFuncSetAttribute(
      tayal_traj_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, warps * per_warp);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (N + warps - 1) / warps;
  tayal_traj_kernel<false><<<grid, warps * 32, warps * per_warp, s>>>(
      q_in, p_in, g_in, inv_mass, x, sign, mask, eps, n_steps, q, p, g, lp, nullptr,
      cap, C, T, N, B);
  return static_cast<int>(cudaGetLastError());
}
