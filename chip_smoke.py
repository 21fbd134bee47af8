#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, and hold each of
its hand-written CUDA kernels against its plain PyTorch version there.

    python3 chip_smoke.py

Three main paths, each driven with the kernel counts set to 0 just
before it and read just after:

- the batched Tayal Gibbs fit that ``bench.py`` runs by default (256
  simulated zig-zag series, T=1024, K=4, L=9, hard gate, one chain)
  followed by the walk-forward decode (``TayalHHMMLite.generated``,
  stan gate) on thinned draws;
- the batched ChEES-HMC fit of ``bench.py --sampler chees`` (the stan-
  gate ``TayalHHMM`` on the same 256 x T=1024 batch, 2 chains, so 512
  lanes, at most 16 leapfrogs a transition, 150 warmup + 150 sampling
  transitions), every trajectory one launch of the fused trajectory
  kernel; and its unfused form, every leapfrog one value-and-grad call;
- the zoo's generated quantities (``BaseHMMModel.generated``: guarded
  smoothing and Viterbi): the hard-gate Tayal posterior of the Gibbs
  fit and of the ChEES fit, 32 draws x 256 series = 8192 lanes at
  T=1024, and the Gaussian HMM of ``hmm/main.R`` (K=3, T=500, 256
  series) fitted by Gibbs, decoded and path-sampled.

Phases, one JSON object per line:

1. device  — requires CUDA (exits non-zero without it); prints the
   card's ``nvidia-smi`` name and power limit on a line of its own.
2. build   — builds every kernel from ``hhmm_tpu_torch/kernels/csrc``
   with ``nvcc`` (all sources in parallel).
3. kernels — each kernel against its plain version on the card: the
   FFBS pair bitwise (alpha, ll and every draw) at K in {2, 3, 4, 8},
   ungated and gated, at N=256, T=1024 with a ragged tail and at
   (N, T) = (250, 1000), (1, 1024), (256, 1) and (5, 2100) with masked
   runs at both ends; the value-and-grad pair (``FWD`` + ``VG_BWD``) at N=512, K in
   {3, 4, 8}; the trajectory kernel at the ChEES shape with 2 leapfrogs,
   against its plain version in float64 with 8, against the unfused
   leapfrogs over ``make_lp_bc`` with 8, and at the odd shapes of
   ``TRAJ_ODD_CASES`` (masked runs at both ends, C in {1, 2, 3}, N=1,
   T in {1, 100, 1000, 6500}, the last on the scratch path, n_steps in
   {0, 1, 2, 16, CAP + 4}); then times each at its main-path shape (the
   FFBS pair also on one lane and at N in {1, 256, 512, 2048, 8192}, in
   ns a step; the trajectory at N in {1, 512, 2048}, in ms a leapfrog
   and ns a recursion step).
4. fit     — the Gibbs fit through the kernels; every chain healthy,
   every logp finite, each FFBS kernel launched exactly once per sweep.
5. decode  — ``generated`` on 8 thinned draws x 256 series (in-sample
   T=1024, out-of-sample T=256): the gated forward kernel over 2048
   lanes, compared with its plain version on the card.
6. chees   — the fused ChEES fit: every chain healthy, every logp
   finite, divergent sampling transitions reported with their count,
   the trajectory kernel launched once per transition, the
   value-and-grad kernel once per call of the log density,
   posterior-mean emission rows near the simulator's.
   chees_repeat — the fused fit again: bitwise the same draws; its
   first divergent sampling trajectories replayed on the CPU are
   unstable in float64 too.
   chees_seeds — the fused fit at three more sampler seeds: divergent
   sampling transitions at most ``DIV_SHARE_MAX`` of all over the four
   fits, emission rows near the simulator's in each.
7. chees_unfused — 10 + 10 transitions with no trajectory kernel: the
   value-and-grad kernel launched once per log-density call, which is
   once per leapfrog plus the initial and step-size-probe calls.
8. kernels_decode — ``FILTER``, ``BETA``, ``VITERBI`` and ``BACKTRACK``
   at N=8192, T=1024, K in {3, 4, 8}, ragged mask, ``MASK_NEG``-sparse
   A, tie lanes, with and without all -inf evidence rows: bitwise equal
   to their plain versions, ``FILTER`` bitwise equal to ``FWD`` on
   finite inputs; then times each at N=8192, T=1024, K=4.
   decode_smooth — ``TayalHHMM(gate_mode="hard").generated`` on 32
   Gibbs draws x 256 series: shapes, probability rows, each decode
   kernel launched once, every output against the plain versions on
   the same lanes, and (after the path's counts are read) loglik
   identical to ``FWD``'s.
   agreement — the ChEES draws through the same decode; the folded
   posterior-mean bull-pair probability against the Gibbs one and the
   Gibbs split-half floor (reported, not gated).
   gaussian — the Gaussian HMM Gibbs fit (FFBS kernels at K=3, once a
   sweep), posterior-mean mu within ``G_MU_TOL``, ``generated`` (each
   decode kernel once, Viterbi accuracy above ``G_ACC_MIN``) and
   ``state_draws`` (one ``FWD`` and one ``BWD_SAMPLE``).
9. the kernels line, then the last line ``{"ok": true, "device": ...}``.

Any failed check raises, so the script exits non-zero and prints no
result line. It imports nothing of JAX or of ``hhmm_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from hhmm_tpu_torch.batch import default_init
from hhmm_tpu_torch.infer import (
    ChEESConfig,
    GibbsConfig,
    ess_many,
    make_lp_bc,
    sample_chees_batched,
    sample_gibbs,
)
from hhmm_tpu_torch.core.lmath import MASK_NEG
from hhmm_tpu_torch.kernels import cuda_semiring as cs
from hhmm_tpu_torch.kernels import cuda_traj as ct
from hhmm_tpu_torch.kernels.cuda_build import build_and_load
from hhmm_tpu_torch.kernels.filtering import smooth
from hhmm_tpu_torch.models import GaussianHMM, NIGPrior, TayalHHMM, TayalHHMMLite
from hhmm_tpu_torch.models.base import broadcast_data
from hhmm_tpu_torch.sim import hmm_sim, obsmodel_gaussian
from hhmm_tpu_torch.sim.tayal import tayal_batch, tayal_phi

# main path: bench.py's default Gibbs workload
N_SERIES, T_FIT, K_TAYAL = 256, 1024, 4
WARMUP, SAMPLES = 100, 300
T_OOS, N_DRAWS = 256, 8
SEED_DATA, SEED_INIT, SEED_SAMPLER = 42, 100, 0
# second main path: bench.py --sampler chees (stan gate, 2 chains)
CHAINS, CAP = 2, 16
CHEES_WARMUP, CHEES_SAMPLES = 150, 150
UNFUSED_WARMUP, UNFUSED_SAMPLES = 10, 10
N_LANES = N_SERIES * CHAINS
T_SHORT = 64  # window of the fused-vs-unfused check (tests/test_pallas_traj.py's regime)
# third main path: the zoo's generated quantities, 32 draws a series
N_DECODE_DRAWS = 32
N_DEC = N_SERIES * N_DECODE_DRAWS  # 8192 lanes
# the Gaussian HMM of hmm/main.R at bench_zoo.py::bench_hmm's Gibbs arm
G_K, G_T = 3, 500
G_A = [[0.8, 0.1, 0.1], [0.1, 0.8, 0.1], [0.05, 0.15, 0.8]]
G_MU, G_SIGMA = [-2.0, 0.5, 3.0], [0.5, 0.8, 0.6]
G_PRIOR = dict(m0=0.0, kappa0=0.1, a0=2.0, b0=1.0)
G_WARMUP, G_SAMPLES = 100, 300
SEED_GAUSS = 7

# the FFBS checks (each bitwise against the plain versions): every K the
# kernels take, gated and not, at the main path's shape with a ragged
# tail, then (N, T) that are not a multiple of a lane group, a block or a
# ring stage, with masked runs at both ends of every lane; T=2100 puts
# BWD_SAMPLE's maps in its device scratch instead of shared memory
FFBS_KS = (2, 3, 4, 8)
FFBS_SHAPES = ((N_SERIES, T_FIT, False), (250, 1000, True), (1, T_FIT, True), (N_SERIES, 1, True),
               (5, 2100, True))
FFBS_TIMING_LANES = (1, 256, 512, 2048, 8192)  # FWD / BWD_SAMPLE timed at T=1024, K=4

# tolerances (kernel vs plain version on the card)
DECODE_ATOL = 1e-5  # filtered probabilities, absolute
PHI_MAE_MAX = 0.05  # posterior-mean emission rows vs the simulator's
# divergent share of the ChEES sampling transitions (lanes x transitions):
# one shared step size meets a few genuinely unstable trajectories on
# this batch (they diverge in float64 and through the unfused path too);
# a wrong gradient diverges on a large share. One fit's count is
# heavy-tailed: a chain that settles where the shared step size is
# unstable diverges on about every other transition from then on, so
# the count swings by tens between sampler seeds with either trajectory
# kernel design, and the share is taken over the fits of CHEES_SEEDS
DIV_SHARE_MAX = 1e-3
CHEES_SEEDS = (SEED_SAMPLER, SEED_SAMPLER + 1, SEED_SAMPLER + 2, SEED_SAMPLER + 3)
REPLAY_DH_MIN = 100.0  # a replayed divergence's float64 energy error
PROB_ATOL = 1e-5  # decode probabilities: alpha rows sum to 1, kernels vs plain
# gamma = exp(log_alpha + log_beta - lse(...)) at T=1024: the f32 sum and
# its normaliser are each rounded at |loglik| ~ 1.6e3 (ulp 1.2e-4), so a
# row sums to 1 only within a few of those ulps (in the JAX package too)
GAMMA_SUM_TOL = 1e-3
G_MU_TOL = 0.35  # Gaussian posterior-mean mu, mean over series (tests/test_gibbs.py)
G_ACC_MIN = 0.9  # Gaussian Viterbi accuracy (tests/test_models.py)
VG_LL_RTOL = 1e-5  # value-and-grad loglik, relative
VG_D_ATOL = 1e-5  # d_obs, d_pi, absolute
VG_DA_RTOL = 1e-4  # d_A, relative: a sum of T terms, one order per side
# trajectory (tests/test_pallas_traj.py's tolerances): (rtol, atol)
TRAJ_TOL = {"q": (2e-4, 2e-4), "p": (2e-3, 2e-3), "logp": (1e-4, 5e-3), "grad": (2e-3, 2e-3)}
# the trajectory kernel against traj_plain at odd shapes, every lane's
# series with masked runs at both ends: (B, T, C, n_steps). T = 1000 and
# 100 are off the kernel's 16-step chunks, T = 6500 puts its per-step
# buffers in the device scratch, n_steps = CAP + 4 is clamped to CAP
TRAJ_ODD_CASES = ((N_SERIES, T_FIT, CHAINS, 2), (5, 1000, 3, 1), (5, 1000, 1, 0),
                  (1, T_FIT, 1, 1), (5, 1, 2, CAP + 4), (5, 100, 2, 16), (5, 6500, 2, 1))
TRAJ_TIMING_LANES = (1, N_LANES, 2048)  # TRAJ timed at T=1024, 16 leapfrogs
# the largest errors of the one-thread-a-lane kernel this design replaced,
# on the two full-T checks below (its own run of this script)
TRAJ_EARLIER_ERR = {"logp_vs_plain": 1.5e-3, "logp_vs_f64_plain": 1.1e-2}

SPIN_CYCLES = 20_000_000  # about 10 ms at the H100's 1.98 GHz (time_ms)

# H100 SXM published peaks: HBM bandwidth and
# f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around ``reps`` calls. The calls
    are queued behind a spin kernel, so that a kernel shorter than its
    wrapper's host time is timed on the card and not at the host's
    launch rate (a plain version, whose host loop outlasts the spin,
    is timed as it runs)."""
    for _ in range(warmup):
        fn()
    sync()
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def make_case(seed: int, N: int, T: int, K: int, gated: bool, device, both_ends: bool = False):
    """Random normalized (pi, A), N(-1, 1) emissions, ragged mask of
    lengths in [T/2, T] (with ``both_ends``, each lane's first [0, T/8]
    steps masked too), sign gate on a Tayal-like state key; returned in
    the kernels' lane layout with uniforms ``u [T, N]``."""
    rng = np.random.default_rng(seed)

    def log_norm(a):
        return a - np.log(np.exp(a).sum(-1, keepdims=True))

    f32 = dict(dtype=torch.float32, device=device)
    log_pi = torch.as_tensor(log_norm(rng.normal(size=(N, K))), **f32)
    log_A = torch.as_tensor(log_norm(rng.normal(size=(N, K, K))), **f32)
    log_obs = torch.as_tensor(rng.normal(size=(N, T, K)) - 1.0, **f32)
    lengths = rng.integers(T // 2, T + 1, size=N)
    valid = np.arange(T)[None, :] < lengths[:, None]
    if both_ends:
        valid &= np.arange(T)[None, :] >= rng.integers(0, T // 8 + 1, size=N)[:, None]
    mask = torch.as_tensor(valid, **f32)
    gk = sk = None
    if gated:
        gk = torch.as_tensor(rng.integers(0, 2, size=(N, T)), **f32)
        sk = torch.as_tensor(np.tile([1.0, 0.0, 0.0, 1.0], K // 4 or 1)[:K], **f32)
    u = torch.as_tensor(rng.random((N, T)), **f32)
    lanes = cs.to_lanes(log_pi, log_A.clamp_min(-1e30), log_obs, mask, gk, sk)
    return lanes, u.t().contiguous()


def fwd_bytes_ops(lanes):
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    T, K, N = obs_t.shape
    gated = gate_t is not None
    floats = K * N + K * K * N + T * K * N + T * N + N + T * K * N
    if gated:
        floats += T * N + K * N
    steps = int((mask_t[1:] > 0).sum())  # masked steps copy the carry
    per_dest = 5 * K + 3 + (K if gated else 0)  # add(,mul), max, sub, exp, sum, log, 2 adds
    ops = steps * K * per_dest + N * (4 * K + 2)
    return 4 * floats, ops


def bwd_bytes_ops(lanes):
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    T, K, N = obs_t.shape
    floats = K * K * N + T * N + T * K * N + T * N + T * N  # A, mask, alpha, u, z
    if gate_t is not None:
        floats += T * N + K * N
    ops = T * N * (12 * K - 1)  # logits, lse0, p, running cum + count, every step
    return 4 * floats, ops


def bound(bytes_, ops):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def vg_bytes_ops(lanes):
    """Bytes and f32 operations of ``VG_BWD`` on these lanes: inputs
    (A, obs, mask, alpha, ll, gate keys) read once, outputs (d_pi, d_A,
    d_obs) written once; the arithmetic of the valid steps (a masked
    step only copies beta and writes a zero row)."""
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    T, K, N = obs_t.shape
    gated = gate_t is not None
    floats = K * K * N + 2 * T * K * N + T * N + N + (T * N + K * N if gated else 0)
    floats += K * N + K * K * N + T * K * N
    steps = int((mask_t[1:] > 0).sum())
    # d_obs 4K; e K; per (i, j): add, add, sub, exp, mul m, add acc, add x
    # (+ 2 muls by c gated); per i the clamped lse: K max, K sub, K exp,
    # K-1 adds, log, add
    per_step = 5 * K + K * K * (7 + (2 if gated else 0)) + K * (4 * K + 1)
    return 4 * floats, steps * per_step + N * 4 * K


def traj_bytes_ops(T: int, B: int, C: int, mask_t, n_steps: int):
    """Bytes and f32 operations of ``TRAJ`` for one trajectory of
    ``n_steps`` leapfrogs: inputs (q, p, grad per lane, inverse mass and
    data per series, eps, n) read once, outputs (q, p, grad, logp)
    written once; per leapfrog the unpack, the forward and backward
    passes over the valid steps, the chain rule and the updates."""
    N, D, K, L = B * C, ct.DIM, 4, 9
    floats = 3 * D * N + D * B + 3 * T * B + 2 + 3 * D * N + N
    valid = int((mask_t[1:] > 0).sum()) * C  # valid steps t >= 1, all lanes
    # forward: 16 mul-adds, 4 emission muls, 3 adds, 4 divides, log, add;
    # backward: 4 gamma muls + 4 slab adds, e 4 muls + 4 divides, 4 dA
    # terms of 4 ops, 16 mul-adds for beta
    per_step = (32 + 4 + 3 + 4 + 2) + (8 + 8 + 16 + 32)
    # unpack: 35 sigmoid / log-sigmoid chains (~12 ops) and 36 exps;
    # chain rule ~10 ops a coordinate; leapfrog updates 6 a coordinate
    per_lane = 12 * D + 36 + 10 * D + 6 * D
    ops = n_steps * (valid * per_step + N * per_lane)
    return 4 * floats, ops


def phase_kernels(device):
    """``FWD`` and ``BWD_SAMPLE`` bitwise equal to ``fwd_plain`` and
    ``bwd_sample_plain`` (alpha, ll and every draw) in every case of
    ``FFBS_KS`` x gated x ``FFBS_SHAPES``; then timed at the main path's
    shape, on one lane, and at each of ``FFBS_TIMING_LANES`` lanes."""
    cases = []
    fwd_err = z_err = 0.0
    for i, (K, gated, (N, T, both)) in enumerate(
        (K, g, shape) for K in FFBS_KS for g in (False, True) for shape in FFBS_SHAPES
    ):
        lanes, u_t = make_case(1000 + i, N, T, K, gated, device, both_ends=both)
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
        ll_k, a_k = cs.fwd_lanes(*lanes)
        z_k = cs.bwd_sample_lanes(A_t, mask_t, a_k, u_t, gate_t, sk_t)
        ll_p, a_p = cs.fwd_plain(*lanes)
        z_p = cs.bwd_sample_plain(A_t, mask_t, a_p, u_t, gate_t, sk_t)
        sync()
        fwd_err = max(fwd_err, float((a_k - a_p).abs().max()), float((ll_k - ll_p).abs().max()))
        z_err = max(z_err, float((z_k - z_p).abs().max()))
        same = {"alpha": torch.equal(a_k, a_p), "ll": torch.equal(ll_k, ll_p),
                "z": torch.equal(z_k, z_p)}
        if not all(same.values()):
            raise AssertionError(
                f"FFBS K={K} gated={gated} N={N} T={T}: not bitwise equal to the plain "
                f"versions {same}, alpha err {float((a_k - a_p).abs().max()):.3g}, "
                f"{int((z_k != z_p).sum())} draws differ"
            )
        cases.append(dict(K=K, gated=gated, N=N, T=T, masked_both_ends=both,
                          masked_steps=int((mask_t == 0).sum())))
        emit("kernels_vs_plain", bitwise_equal=True, **cases[-1])

    # timing at the main-path shape: N=256, T=1024, K=4, ungated
    lanes, u_t = make_case(2000, N_SERIES, T_FIT, K_TAYAL, False, device)
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    _, alpha = cs.fwd_lanes(*lanes)
    t = {}
    t["fwd_ms"] = time_ms(lambda: cs.fwd_lanes(*lanes), reps=50)
    t["bwd_ms"] = time_ms(lambda: cs.bwd_sample_lanes(A_t, mask_t, alpha, u_t), reps=50)
    t["fwd_plain_ms"] = time_ms(lambda: cs.fwd_plain(*lanes), reps=3, warmup=1)
    t["bwd_plain_ms"] = time_ms(
        lambda: cs.bwd_sample_plain(A_t, mask_t, alpha, u_t), reps=3, warmup=1
    )
    # one lane alone: the serial T-step chain, which no batch size shortens
    one = tuple(None if x is None else x[..., :1].contiguous() for x in lanes)
    _, alpha1 = cs.fwd_lanes(*one)
    u1 = u_t[:, :1].contiguous()
    t["fwd_one_lane_ms"] = time_ms(lambda: cs.fwd_lanes(*one), reps=50)
    t["bwd_one_lane_ms"] = time_ms(
        lambda: cs.bwd_sample_lanes(one[1], one[3], alpha1, u1), reps=50
    )
    # the whole FFBS wrapper as the Gibbs sweep calls it (layout included)
    log_pi = pi_t.t().contiguous()
    log_A = A_t.permute(2, 0, 1).contiguous()
    log_obs = obs_t.permute(2, 0, 1).contiguous()
    mask, u = mask_t.t().contiguous(), u_t.t().contiguous()
    t["ffbs_wrapper_ms"] = time_ms(
        lambda: cs.semiring_ffbs(log_pi, log_A, log_obs, mask, u), reps=50
    )
    # the decode's shape: gated, 2048 lanes
    dlanes, _ = make_case(2001, N_SERIES * N_DRAWS, T_FIT, K_TAYAL, True, device)
    t["fwd_decode_gated_2048_ms"] = time_ms(lambda: cs.fwd_lanes(*dlanes), reps=20)
    del dlanes
    # both kernels across batch sizes, and ns a step (T=1024, dense mask)
    by_lanes = {}
    for N in FFBS_TIMING_LANES:
        nl, nu = make_case(2002, N, T_FIT, K_TAYAL, False, device)
        _, na = cs.fwd_lanes(*nl)
        f = time_ms(lambda: cs.fwd_lanes(*nl), reps=20)
        b = time_ms(lambda: cs.bwd_sample_lanes(nl[1], nl[3], na, nu), reps=20)
        by_lanes[N] = dict(fwd_ms=f, fwd_ns_per_step=f * 1e6 / T_FIT,
                           bwd_ms=b, bwd_ns_per_step=b * 1e6 / T_FIT)
        del nl, nu, na
    t["by_lanes"] = by_lanes
    emit("kernel_timing", shape=dict(N=N_SERIES, T=T_FIT, K=K_TAYAL), **t)
    fb, fo = fwd_bytes_ops(lanes)
    bb, bo = bwd_bytes_ops(lanes)
    return dict(cases=cases, fwd_err=fwd_err, z_err=z_err, timing=t,
                fwd_bound=bound(fb, fo), bwd_bound=bound(bb, bo),
                fwd_bytes=fb, fwd_ops=fo, bwd_bytes=bb, bwd_ops=bo)


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------


ALL_KERNELS = cs.KERNELS + ct.KERNELS

# the bear/bull pair-swap relabeling of the Tayal posterior: p_11 <-> 1-p_11,
# A_row rows swap, phi rows permute [3, 2, 1, 0]
MIRROR = [3, 2, 1, 0]


def canonical_draws(p):
    """Constrained draws ``[B, C, S, 41]`` (p_11, A_row, phi_k) with the
    mirror label modes folded per draw toward each series' first draw
    (the fold ``bench.py`` applies before its worst-parameter ESS), and
    the share of draws folded."""
    p11 = p["p_11"].cpu().numpy()
    B, C, S = p11.shape
    p11 = p11.reshape(B, C * S)
    A_row = p["A_row"].cpu().numpy().reshape(B, C * S, 2, 2)
    phi = p["phi_k"].cpu().numpy().reshape(B, C * S, 4, 9)
    anchor = phi[:, :1]
    swap = ((phi[:, :, MIRROR] - anchor) ** 2).sum(axis=(2, 3)) < (
        (phi - anchor) ** 2
    ).sum(axis=(2, 3))
    p11 = np.where(swap, 1.0 - p11, p11)
    A_row[swap] = A_row[swap][:, ::-1]
    phi[swap] = phi[swap][:, MIRROR]
    mats = np.concatenate(
        [p11[..., None], A_row.reshape(B, C * S, 4), phi.reshape(B, C * S, 36)], axis=-1
    )
    return mats.reshape(B, C, S, -1), float(swap.mean())


def phase_fit(device, kernel_ms_per_sweep):
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM(gate_mode="hard")
    init = default_init(model, data, N_SERIES, 1, seed=SEED_INIT, device=device)
    cfg = GibbsConfig(num_warmup=WARMUP, num_samples=SAMPLES, num_chains=1)
    sync()
    ffbs = (cs.FWD, cs.BWD_SAMPLE)
    before = {k.name: k.launches for k in ffbs}
    t0 = time.perf_counter()
    qs, stats = sample_gibbs(model, data, init, cfg, seed=SEED_SAMPLER, device=device)
    sync()
    wall = time.perf_counter() - t0
    sweeps = WARMUP + SAMPLES
    rose = {k.name: k.launches - before[k.name] for k in ffbs}
    if any(v != sweeps for v in rose.values()):
        raise AssertionError(f"fit: kernel launches {rose}, expected {sweeps} each")
    if not bool(stats["chain_healthy"].all()):
        raise AssertionError("fit: a chain was quarantined")
    if not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError("fit: non-finite logp")
    if tuple(qs.shape) != (N_SERIES, 1, SAMPLES, model.n_free):
        raise AssertionError(f"fit: qs shape {tuple(qs.shape)}")

    worst, swap_share, phi_mean, mae = fold_and_score(model, qs)
    if not mae.mean() <= PHI_MAE_MAX:
        raise AssertionError(f"fit: posterior-mean phi MAE {mae.mean():.3g} > {PHI_MAE_MAX}")
    emit(
        "fit",
        series=N_SERIES, T=T_FIT, chains=1, warmup=WARMUP, samples=SAMPLES,
        seconds=wall, sweeps_per_s=sweeps / wall, series_per_s=N_SERIES / wall,
        sweep_ms=wall / sweeps * 1e3,
        # the two kernels' own time (phase 3, same shape) as a share of a sweep
        kernel_share=kernel_ms_per_sweep / (wall / sweeps * 1e3),
        launches=rose, logp_mean=float(stats["logp"].mean()),
        ess_worst_param_min=float(worst.min()), ess_worst_param_mean=float(worst.mean()),
        mirror_fold_share=swap_share,
        phi_mae_mean=float(mae.mean()), phi_mae_max=float(mae.max()),
    )
    return qs, phi_mean


def fold_and_score(model, qs):
    """Fold the mirror label modes, then per series: the worst-parameter
    ESS, the share of draws folded, the posterior-mean emission rows
    ``[B, 4, 9]`` and their mean absolute error against the simulator's
    rows, up to the mirror relabeling the fold leaves open (each
    series' anchor is its own first draw)."""
    mats, swap_share = canonical_draws(model.constrained_draws(qs))  # [B, C, S, P]
    B, C, S, P = mats.shape
    per_param = ess_many(np.moveaxis(mats, -1, 1).reshape(B * P, C, S)).reshape(B, P)
    phi_true = tayal_phi(SEED_DATA)
    phi_mean = mats[..., 5:].reshape(B, C * S, 4, 9).mean(axis=1)
    mae = np.minimum(
        np.abs(phi_mean - phi_true).mean(axis=(1, 2)),
        np.abs(phi_mean[:, MIRROR] - phi_true).mean(axis=(1, 2)),
    )
    return per_param.min(axis=1), swap_share, phi_mean, mae


def phase_decode(device, qs):
    xs, ss = tayal_batch(N_SERIES, T_FIT + T_OOS, seed=SEED_DATA, device=device)
    data = {
        "x": xs[:, :T_FIT], "sign": ss[:, :T_FIT],
        "x_oos": xs[:, T_FIT:], "sign_oos": ss[:, T_FIT:],
    }
    draws = qs[:, 0, :: SAMPLES // N_DRAWS][:, :N_DRAWS]  # [B, 8, D]
    lite = TayalHHMMLite(gate_mode="stan")
    fwd_before = cs.FWD.launches
    sync()
    t0 = time.perf_counter()
    out = lite.generated(draws, data, device=device)
    sync()
    wall = time.perf_counter() - t0
    shapes = {
        "alpha": (N_SERIES, N_DRAWS, T_FIT, 4),
        "alpha_oos": (N_SERIES, N_DRAWS, T_OOS, 4),
        "zstar_oos": (N_SERIES, N_DRAWS, T_OOS),
    }
    for k, shp in shapes.items():
        if tuple(out[k].shape) != shp:
            raise AssertionError(f"decode: {k} shape {tuple(out[k].shape)} != {shp}")
    for k in ("alpha", "alpha_oos"):
        a = out[k]
        if not bool(torch.isfinite(a).all()) or float((a.sum(-1) - 1).abs().max()) > 1e-5:
            raise AssertionError(f"decode: {k} is not a finite probability vector per step")
    z = out["zstar_oos"]
    if not bool(((z >= 0) & (z < 4)).all()):
        raise AssertionError("decode: zstar_oos out of range")

    # the gated forward kernel against its plain version on the same lanes
    n = N_SERIES * N_DRAWS
    params, _ = lite.unpack(draws.reshape(n, -1))
    errs = {}
    for key, xk, sk_ in (("alpha", "x", "sign"), ("alpha_oos", "x_oos", "sign_oos")):
        seg = {"x": data[xk].repeat_interleave(N_DRAWS, 0),
               "sign": data[sk_].repeat_interleave(N_DRAWS, 0)}
        log_pi, log_A, log_obs, _ = lite.build_vg(params, seg)
        gk, skey = lite.gate_keys(seg)
        mask = torch.ones(seg["x"].shape, dtype=torch.float32, device=device)
        _, a_plain = cs.fwd_plain(*cs.to_lanes(log_pi, log_A, log_obs, mask, gk, skey))
        ref = torch.softmax(a_plain.permute(2, 0, 1), dim=-1).reshape(out[key].shape)
        errs[key] = float((out[key] - ref).abs().max())
    if max(errs.values()) > DECODE_ATOL:
        raise AssertionError(f"decode: kernel vs plain filtered probabilities {errs}")
    emit(
        "decode", lanes=n, T=T_FIT, T_oos=T_OOS, seconds=wall,
        fwd_launches=cs.FWD.launches - fwd_before, max_abs_err_vs_plain=errs,
    )


# ---------------------------------------------------------------------------
# phase 3 (cont.): the value-and-grad and trajectory kernels
# ---------------------------------------------------------------------------


def phase_kernels_vg(device):
    """``FWD`` + ``VG_BWD`` against ``fwd_plain`` + ``vg_bwd_plain`` at
    N=512, T=1024, K in {4, 8}, gated and not, ragged mask."""
    errs = {"ll_rel": 0.0, "d_pi": 0.0, "d_obs": 0.0, "d_A_rel": 0.0, "d_A": 0.0}
    for i, (K, gated) in enumerate([(4, False), (4, True), (8, False), (8, True), (3, False)]):
        lanes, _ = make_case(3000 + i, N_LANES, T_FIT, K, gated, device)
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
        ll_k, a_k = cs.fwd_lanes(*lanes)
        got = cs.vg_bwd_lanes(A_t, obs_t, mask_t, a_k, ll_k, gate_t, sk_t)
        ll_p, a_p = cs.fwd_plain(*lanes)
        want = cs.vg_bwd_plain(A_t, obs_t, mask_t, a_p, ll_p, gate_t, sk_t)
        sync()
        e = {
            "ll_rel": float(((ll_k - ll_p).abs() / ll_p.abs()).max()),
            "d_pi": float((got[0] - want[0]).abs().max()),
            "d_obs": float((got[2] - want[2]).abs().max()),
            "d_A_rel": float(((got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-30)).max()),
            "d_A": float((got[1] - want[1]).abs().max()),
        }
        if not (e["ll_rel"] <= VG_LL_RTOL and e["d_pi"] <= VG_D_ATOL
                and e["d_obs"] <= VG_D_ATOL and e["d_A_rel"] <= VG_DA_RTOL):
            raise AssertionError(f"value-and-grad K={K} gated={gated}: {e}")
        errs = {k: max(errs[k], v) for k, v in e.items()}
        emit("vg_vs_plain", N=N_LANES, T=T_FIT, K=K, gated=gated, **e)

    # timing on the main path's own lanes: the stan-gate Tayal terms of
    # the ChEES fit's inits (K=4, gated, dense)
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM()
    init = default_init(model, data, N_SERIES, CHAINS, seed=SEED_INIT, device=device)
    lanes = tayal_lanes(model, data, init)
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    ll, alpha = cs.fwd_lanes(*lanes)
    t = {}
    t["ms"] = time_ms(lambda: cs.vg_bwd_lanes(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t), reps=50)
    t["plain_ms"] = time_ms(
        lambda: cs.vg_bwd_plain(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t), reps=2, warmup=1
    )
    one = tuple(None if v is None else v[..., :1].contiguous() for v in lanes)
    ll1, alpha1 = cs.fwd_lanes(*one)
    t["one_lane_ms"] = time_ms(
        lambda: cs.vg_bwd_lanes(one[1], one[2], one[3], alpha1, ll1, one[4], one[5]), reps=50
    )
    t["fwd_ms"] = time_ms(lambda: cs.fwd_lanes(*lanes), reps=50)
    lp_bc = make_lp_bc(model, data, device=device)
    t["lp_bc_ms"] = time_ms(lambda: lp_bc(init), reps=20)
    emit("vg_timing", shape=dict(N=N_LANES, T=T_FIT, K=4, gated=True), **t)
    b, o = vg_bytes_ops(lanes)
    return dict(err=errs, timing=t, bound=bound(b, o), bytes=b, ops=o)


def tayal_lanes(model, data, q):
    """The stan-gate Tayal value-and-grad lanes at ``q [B, C, 35]``, as
    ``make_vg`` builds them (dense mask)."""
    B, C, _ = q.shape
    n = B * C
    params, _ = model.unpack(q)
    lanes = {k: broadcast_data(v, (B, C)) for k, v in data.items()}
    log_pi, log_A, log_obs, _ = model.build_vg(params, lanes)
    gk, sk = model.gate_keys(lanes)
    T = log_obs.shape[-2]
    mask = torch.ones((n, T), dtype=torch.float32, device=q.device)
    return cs.to_lanes(
        log_pi.reshape(n, 4), log_A.reshape(n, 4, 4), log_obs.reshape(n, T, 4), mask,
        gk.reshape(n, T), sk.reshape(n, 4),
    )


def state_errors(got, want):
    """Per quantity (q, p, logp, grad): max abs error and the largest
    excess over ``atol + rtol * |want|`` (positive = out of tolerance)."""
    out = {}
    for name, a, b in zip(("q", "p", "logp", "grad"), got, want):
        rtol, atol = TRAJ_TOL[name]
        d = (a - b).abs()
        out[name] = (float(d.max()), float((d - atol - rtol * b.abs()).max()))
    return out


def phase_kernels_traj(device):
    """``TRAJ`` against ``traj_plain`` (2 leapfrogs) and against the
    unfused leapfrogs over ``make_lp_bc`` (8) at the ChEES shape; then
    its time per leapfrog at 16, on one lane, and its plain version."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM()
    q = default_init(model, data, N_SERIES, CHAINS, seed=SEED_INIT, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    f32 = dict(dtype=torch.float32, device=device)
    p = torch.randn(q.shape, generator=gen, **f32)
    inv_mass = torch.exp(0.3 * torch.randn((N_SERIES, ct.DIM), generator=gen, **f32))
    eps = 0.02
    lp_bc = make_lp_bc(model, data, device=device)
    _, g0 = lp_bc(q)
    x_t, s_t, m_t = ct._data_lanes(x, sign, None, device)

    def lanes(a):
        return a.reshape(N_LANES, ct.DIM).t().contiguous()

    args = (lanes(q), lanes(p), lanes(g0), inv_mass.t().contiguous(), x_t, s_t, m_t)
    eps_t = torch.tensor([eps], **f32)

    def n_t(n):
        return torch.tensor([n], dtype=torch.int32, device=device)

    got = ct.traj_lanes(*args, eps_t, n_t(2), CAP, CHAINS)
    want = ct.traj_plain(*args, eps_t, n_t(2), CAP, CHAINS)
    sync()
    vs_plain = state_errors(got, want)
    # the fused trajectory in f32 against its plain version in f64, 8
    # leapfrogs: the f32 kernel is accurate at the full T
    got8 = ct.traj_lanes(*args, eps_t, n_t(8), CAP, CHAINS)
    f64 = [a.double() for a in args]
    f64[4], f64[5] = args[4], args[5]  # symbols and signs stay int32
    want8 = ct.traj_plain(*f64, eps_t.double(), n_t(8), CAP, CHAINS)
    sync()
    vs_f64 = state_errors([a.double() for a in got8], want8)

    def unfused(lp_fn, g, n):
        qu, pu, gu, lpu = q, p, g, None
        for _ in range(n):
            ph = pu + 0.5 * eps * gu
            qu = qu + eps * inv_mass[:, None, :] * ph
            lpu, gu = lp_fn(qu)
            pu = ph + 0.5 * eps * gu
        return qu, pu, lpu, gu

    # fused vs unfused (FWD + VG_BWD kernels), 8 leapfrogs, same inputs,
    # on the first T_SHORT legs of every series: the regime the
    # tolerances were set for. At T=1024 the unfused log-space path
    # itself carries an f32 gradient error of order T * ulp(|loglik|)
    # (every gamma is exp(alpha + beta - ll) with |ll| ~ 1.6e3), so
    # there the gap is reported, not gated.
    short = {"x": x[:, :T_SHORT], "sign": sign[:, :T_SHORT]}
    lp_short = make_lp_bc(model, short, device=device)
    _, g_short = lp_short(q)
    fused = ct.make_tayal_trajectory(short, cap=CAP, device=device)(
        inv_mass, eps, 8, q, p, None, g_short
    )
    vs_unfused = state_errors(fused, unfused(lp_short, g_short, 8))
    traj = ct.make_tayal_trajectory(data, cap=CAP, device=device)
    fused_full = traj(inv_mass, eps, 8, q, p, None, g0)
    gap_full = state_errors(fused_full, unfused(lp_bc, g0, 8))
    sync()
    for what, e in (("plain", vs_plain), ("f64 plain", vs_f64), ("unfused", vs_unfused)):
        bad = {k: v for k, v in e.items() if v[1] > 0}
        if bad:
            raise AssertionError(f"trajectory vs {what}: out of tolerance {bad}")
    emit("traj_vs_plain", B=N_SERIES, C=CHAINS, T=T_FIT, n_steps=2,
         max_abs_err={k: v[0] for k, v in vs_plain.items()},
         earlier_design_logp_err=TRAJ_EARLIER_ERR["logp_vs_plain"])
    emit("traj_vs_plain_f64", B=N_SERIES, C=CHAINS, T=T_FIT, n_steps=8,
         max_abs_err={k: v[0] for k, v in vs_f64.items()},
         earlier_design_logp_err=TRAJ_EARLIER_ERR["logp_vs_f64_plain"])
    odd = [traj_odd_case(device, 4000 + i, *c) for i, c in enumerate(TRAJ_ODD_CASES)]
    emit("traj_vs_unfused", B=N_SERIES, C=CHAINS, T=T_SHORT, n_steps=8,
         max_abs_err={k: v[0] for k, v in vs_unfused.items()})
    emit("traj_vs_unfused_full_T_reported", B=N_SERIES, C=CHAINS, T=T_FIT, n_steps=8,
         max_abs_err={k: v[0] for k, v in gap_full.items()})

    t = {}
    n16 = n_t(16)
    t["launch_ms_16"] = time_ms(lambda: ct.traj_lanes(*args, eps_t, n16, CAP, CHAINS), reps=10)
    t["ms"] = t["launch_ms_16"] / 16
    one = tuple(a[:, :1].contiguous() for a in args)  # lane 0, series 0
    t["one_lane_ms"] = time_ms(lambda: ct.traj_lanes(*one, eps_t, n16, CAP, 1), reps=10) / 16
    t["plain_ms"] = time_ms(
        lambda: ct.traj_plain(*args, eps_t, n_t(2), CAP, CHAINS), reps=1, warmup=0
    ) / 2
    t["closure_ms_16"] = time_ms(lambda: traj(inv_mass, eps, 16, q, p, None, g0), reps=10)
    # a leapfrog across batch sizes, and ns a recursion step (2T steps a
    # leapfrog: the forward and the backward recursion)
    by_lanes = {}
    for n_lanes in TRAJ_TIMING_LANES:
        bx, bs = tayal_batch(max(n_lanes // CHAINS, 1), T_FIT, seed=SEED_DATA, device=device)
        cb = CHAINS if n_lanes >= CHAINS else 1
        lx, ls, lm = ct._data_lanes(bx, bs, None, device)
        la = tuple(torch.randn((ct.DIM, n_lanes), generator=gen, **f32) * s_
                   for s_ in (0.5, 0.7, 1.0))
        lim = torch.ones((ct.DIM, bx.shape[0]), **f32)
        ms = time_ms(lambda: ct.traj_lanes(*la, lim, lx, ls, lm, eps_t, n16, CAP, cb), reps=10) / 16
        by_lanes[n_lanes] = dict(ms=ms, ns_per_step=ms * 1e6 / (2 * T_FIT))
    t["by_lanes"] = by_lanes
    t["ns_per_step"] = t["ms"] * 1e6 / (2 * T_FIT)
    emit("traj_timing", shape=dict(B=N_SERIES, C=CHAINS, T=T_FIT), per="leapfrog", **t)
    b, o = traj_bytes_ops(T_FIT, N_SERIES, CHAINS, m_t, 16)
    bms, by = bound(b, o)
    err = max([v[0] for v in vs_plain.values()] + [max(c["max_abs_err"].values()) for c in odd])
    return dict(err=err, vs_unfused={k: v[0] for k, v in vs_unfused.items()},
                vs_f64={k: v[0] for k, v in vs_f64.items()},
                gap_full={k: v[0] for k, v in gap_full.items()}, timing=t,
                bound=(bms / 16, by), bytes=b, ops=o, odd_cases=len(odd))


def traj_odd_case(device, seed: int, B: int, T: int, C: int, n_steps: int):
    """``TRAJ`` against ``traj_plain`` in f32 within ``TRAJ_TOL`` on a
    simulated batch of ``B`` series x ``C`` chains, each series with a
    ragged tail and a masked head (lengths in [T/2, T], first [0, T/8]
    steps masked), random start states."""
    rng = np.random.default_rng(seed)
    x, sign = tayal_batch(B, T, seed=seed, device=device)
    valid = np.arange(T)[None] < rng.integers(max(T // 2, 1), T + 1, size=B)[:, None]
    valid &= np.arange(T)[None] >= rng.integers(0, T // 8 + 1, size=B)[:, None]
    f32 = dict(dtype=torch.float32, device=device)
    x_t, s_t, m_t = ct._data_lanes(x, sign, torch.as_tensor(valid, **f32), device)
    N = B * C
    lanes = [torch.as_tensor(sc * rng.normal(size=(ct.DIM, N)), **f32) for sc in (0.5, 0.7, 1.0)]
    im = torch.as_tensor(np.exp(0.3 * rng.normal(size=(ct.DIM, B))), **f32)
    eps = torch.tensor([0.02], **f32)
    n = torch.tensor([n_steps], dtype=torch.int32, device=device)
    got = ct.traj_lanes(*lanes, im, x_t, s_t, m_t, eps, n, CAP, C)
    want = ct.traj_plain(*lanes, im, x_t, s_t, m_t, eps, n, CAP, C)
    sync()
    e = state_errors(got, want)
    bad = {k: v for k, v in e.items() if v[1] > 0}
    if bad:
        raise AssertionError(f"trajectory B={B} T={T} C={C} n={n_steps} vs plain: {bad}")
    row = dict(B=B, T=T, C=C, n_steps=n_steps, masked_steps=int((m_t == 0).sum()),
               scratch_path=ct.traj_scratch_bytes(T, N) > 0,
               max_abs_err={k: v[0] for k, v in e.items()})
    emit("traj_vs_plain_odd", **row)
    return row


# ---------------------------------------------------------------------------
# phases 6-7: the ChEES main path, fused and unfused
# ---------------------------------------------------------------------------


class Counted:
    """A log density that counts its calls (``lp_bc`` / ``probe_vg``)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, q):
        self.calls += 1
        return self.fn(q)


class DivergenceRecorder:
    """A ``trajectory_fn`` wrapper that keeps the inputs of the first few
    lanes whose sampling-phase trajectory diverges (energy error above
    1000, or NaN, as the sampler judges it). Its outputs are the wrapped
    trajectory's, untouched."""

    def __init__(self, traj, warmup: int, keep: int = 3):
        self.traj, self.cap, self.warmup, self.keep = traj, traj.cap, warmup, keep
        self.calls, self.cases = 0, []

    def __call__(self, inv_mass, eps, n_steps, q, p, logp, grad):
        out = self.traj(inv_mass, eps, n_steps, q, p, logp, grad)
        if self.calls >= self.warmup and len(self.cases) < self.keep:
            k0 = 0.5 * (inv_mass[:, None, :] * p * p).sum(-1)
            k1 = 0.5 * (inv_mass[:, None, :] * out[1] * out[1]).sum(-1)
            d = (-out[2] + k1) - (-logp + k0)
            for b, c in ((d > 1000.0) | torch.isnan(d)).nonzero().tolist()[: self.keep - len(self.cases)]:
                self.cases.append(dict(
                    t=self.calls, b=b, c=c, eps=float(eps), n=int(n_steps), dH=float(d[b, c]),
                    q=q[b, c].cpu(), p=p[b, c].cpu(), grad=grad[b, c].cpu(),
                    inv_mass=inv_mass[b].cpu(), logp=float(logp[b, c]),
                ))
        self.calls += 1
        return out


def replay_divergence(case, x, sign):
    """Energy error of one recorded divergent trajectory on the CPU: the
    plain trajectory in float64, and the unfused log-space leapfrogs in
    float32 (the start energy uses the sampler's f32 logp)."""
    b, eps, n = case["b"], case["eps"], case["n"]
    data = {"x": x[b : b + 1].cpu(), "sign": sign[b : b + 1].cpu()}
    im, p0 = case["inv_mass"].double(), case["p"].double()
    h0 = -case["logp"] + float(0.5 * (im * p0 * p0).sum())
    x_t, s_t, m_t = ct._data_lanes(data["x"], data["sign"], None, torch.device("cpu"))
    lane = [case[k].double()[:, None] for k in ("q", "p", "grad")]
    _, p1, lp1, _ = ct.traj_plain(
        *lane, im[:, None], x_t, s_t, m_t.double(), torch.tensor([eps], dtype=torch.float64),
        torch.tensor([n]), CAP, 1,
    )
    dh64 = -float(lp1[0]) + float(0.5 * (im * p1[:, 0] ** 2).sum()) - h0
    lp_bc = make_lp_bc(TayalHHMM(), data, device="cpu")
    q, p, g = (case[k][None, None] for k in ("q", "p", "grad"))
    im32 = case["inv_mass"][None]
    for _ in range(n):
        ph = p + 0.5 * eps * g
        q = q + eps * im32[:, None, :] * ph
        lp, g = lp_bc(q)
        p = ph + 0.5 * eps * g
    dh_unfused = -float(lp) + float(0.5 * (case["inv_mass"] * p[0, 0] ** 2).sum()) - h0
    return dict(t=case["t"], series=b, chain=case["c"], eps=eps, n_steps=n,
                dH_fused_f32=case["dH"], dH_plain_f64=dh64, dH_unfused_f32=dh_unfused)


def run_chees(device, warmup, samples, fused, recorder=False, seed=SEED_SAMPLER):
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM()  # stan gate, as bench.py --sampler chees
    init = default_init(model, data, N_SERIES, CHAINS, seed=SEED_INIT, device=device)
    cfg = ChEESConfig(num_warmup=warmup, num_samples=samples, num_chains=CHAINS,
                      max_leapfrogs=CAP)
    lp_bc = Counted(make_lp_bc(model, data, device=device))
    probe = Counted(model.make_vg({"x": x[0], "sign": sign[0]}))
    traj = ct.make_tayal_trajectory(data, cap=CAP, device=device) if fused else None
    if recorder:
        traj = DivergenceRecorder(traj, warmup)
    sync()
    before = {k.name: k.launches for k in ALL_KERNELS}
    t0 = time.perf_counter()
    qs, stats = sample_chees_batched(lp_bc, init, cfg, seed=seed, device=device,
                                     probe_vg=probe, trajectory_fn=traj)
    sync()
    wall = time.perf_counter() - t0
    rose = {k.name: k.launches - before[k.name] for k in ALL_KERNELS}
    if not bool(stats["chain_healthy"].all()):
        raise AssertionError("chees: a chain was quarantined")
    if not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError("chees: non-finite logp")
    vg_calls = lp_bc.calls + probe.calls
    if rose[cs.VG_BWD.name] != vg_calls or rose[cs.FWD.name] != vg_calls:
        raise AssertionError(f"chees: launches {rose} vs {vg_calls} value-and-grad calls")
    return model, qs, stats, wall, rose, lp_bc.calls, probe.calls, traj


def phase_chees(device, gibbs_phi):
    model, qs, stats, wall, rose, lp_calls, probe_calls, _ = run_chees(
        device, CHEES_WARMUP, CHEES_SAMPLES, fused=True
    )
    transitions = CHEES_WARMUP + CHEES_SAMPLES
    if rose[ct.TRAJ.name] != transitions:
        raise AssertionError(f"chees: {rose[ct.TRAJ.name]} trajectory launches, expected {transitions}")
    if tuple(qs.shape) != (N_SERIES, CHAINS, CHEES_SAMPLES, model.n_free):
        raise AssertionError(f"chees: qs shape {tuple(qs.shape)}")
    n_div = int(stats["diverging"].sum())
    div_share = n_div / stats["diverging"].numel()
    worst, swap_share, phi_mean, mae = fold_and_score(model, qs)
    if not mae.mean() <= PHI_MAE_MAX:
        raise AssertionError(f"chees: posterior-mean phi MAE {mae.mean():.3g} > {PHI_MAE_MAX}")
    gap = np.minimum(
        np.abs(phi_mean - gibbs_phi).mean(axis=(1, 2)),
        np.abs(phi_mean[:, MIRROR] - gibbs_phi).mean(axis=(1, 2)),
    )
    leaves = torch.cat([stats["warmup_num_leaves"][0], stats["num_leaves"][0, 0]]).float()
    emit(
        "chees",
        series=N_SERIES, T=T_FIT, chains=CHAINS, warmup=CHEES_WARMUP, samples=CHEES_SAMPLES,
        cap=CAP, seconds=wall, transitions_per_s=transitions / wall,
        series_per_s=N_SERIES / wall, transition_ms=wall / transitions * 1e3,
        step_size=float(stats["step_size"][0, 0]), traj_length=float(stats["traj_length"][0, 0]),
        leapfrogs_mean=float(leaves.mean()), leapfrogs_total=int(leaves.sum()),
        leapfrogs_sampling=float(stats["num_leaves"][0, 0].float().mean()),
        accept_mean_sampling=float(stats["accept_prob"].mean()),
        divergent_sampling=n_div, divergent_share=div_share,
        divergent_chains=int(stats["diverging"].any(-1).sum()),
        divergent_warmup=int(stats["warmup_diverging"].sum()),
        launches=rose, lp_bc_calls=lp_calls, probe_calls=probe_calls,
        logp_mean=float(stats["logp"].mean()),
        ess_worst_param_min=float(worst.min()), ess_worst_param_mean=float(worst.mean()),
        mirror_fold_share=swap_share,
        phi_mae_mean=float(mae.mean()), phi_mae_max=float(mae.max()),
        phi_gap_vs_gibbs_mean=float(gap.mean()),
    )
    return qs, stats


def phase_chees_seeds(device, stats):
    """The fused fit at the other sampler seeds of ``CHEES_SEEDS`` (the
    main path's fit is the first): every chain healthy, the emission rows
    near the simulator's in each, and divergent sampling transitions at
    most ``DIV_SHARE_MAX`` of all, over the fits of every seed."""
    counts = {CHEES_SEEDS[0]: int(stats["diverging"].sum())}
    total = stats["diverging"].numel()
    maes = {}
    for seed in CHEES_SEEDS[1:]:
        model, qs, st, _, _, _, _, _ = run_chees(device, CHEES_WARMUP, CHEES_SAMPLES, fused=True,
                                                 seed=seed)
        counts[seed] = int(st["diverging"].sum())
        total += st["diverging"].numel()
        maes[seed] = float(fold_and_score(model, qs)[3].mean())
        if not maes[seed] <= PHI_MAE_MAX:
            raise AssertionError(f"chees seed {seed}: posterior-mean phi MAE {maes[seed]:.3g}")
    share = sum(counts.values()) / total
    emit("chees_seeds", seeds=list(CHEES_SEEDS), divergent_sampling=counts, divergent_share=share,
         phi_mae_mean=maes)
    if not share <= DIV_SHARE_MAX:
        raise AssertionError(f"chees: {counts} divergent transitions over seeds, share {share:.3g}")


def phase_chees_repeat(device, qs, stats):
    """The fused fit again: the draws must be bitwise the same (the
    sampler's randomness is one seeded generator and no step sums with
    atomics), and the first divergent trajectories of the sampling phase
    are replayed on the CPU, where each must be unstable in float64 too
    (energy error above ``REPLAY_DH_MIN``): a kernel fault would diverge
    in f32 alone."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    _, qs2, stats2, _, _, _, _, rec = run_chees(
        device, CHEES_WARMUP, CHEES_SAMPLES, fused=True, recorder=True
    )
    if not (torch.equal(qs, qs2) and torch.equal(stats["diverging"], stats2["diverging"])):
        raise AssertionError("chees: a repeated fit gave other draws")
    replays = [replay_divergence(c, x, sign) for c in rec.cases]
    for r in replays:
        if not r["dH_plain_f64"] > REPLAY_DH_MIN:
            raise AssertionError(f"chees: a divergence not unstable in float64: {r}")
    emit("chees_repeat", bitwise_equal=True, divergences_replayed=replays)


def phase_chees_unfused(device):
    _, _, stats, wall, rose, lp_calls, probe_calls, _ = run_chees(
        device, UNFUSED_WARMUP, UNFUSED_SAMPLES, fused=False
    )
    leapfrogs = int(stats["warmup_num_leaves"][0].sum()) + int(stats["num_leaves"][0, 0].sum())
    if lp_calls != 1 + leapfrogs:
        raise AssertionError(f"chees_unfused: {lp_calls} lp_bc calls for {leapfrogs} leapfrogs")
    if rose[ct.TRAJ.name] != 0:
        raise AssertionError("chees_unfused: the trajectory kernel ran")
    transitions = UNFUSED_WARMUP + UNFUSED_SAMPLES
    emit(
        "chees_unfused", series=N_SERIES, T=T_FIT, chains=CHAINS, warmup=UNFUSED_WARMUP,
        samples=UNFUSED_SAMPLES, seconds=wall, transitions_per_s=transitions / wall,
        leapfrogs=leapfrogs, leapfrog_ms=wall / max(leapfrogs, 1) * 1e3,
        divergent_sampling=int(stats["diverging"].sum()),
        launches=rose, lp_bc_calls=lp_calls, probe_calls=probe_calls,
    )
    return rose


# ---------------------------------------------------------------------------
# phase 3 (cont.): the decode kernels
# ---------------------------------------------------------------------------


DECODE_KERNELS = (cs.FILTER, cs.BETA, cs.VITERBI, cs.BACKTRACK)


def make_decode_case(seed: int, N: int, T: int, K: int, device, finite: bool):
    """Lane-layout ``(pi, A, obs, mask)`` for the decode kernels:
    normalized (pi, A) with about a fifth of the A entries at
    ``MASK_NEG``, N(-1, 1) emissions, ragged mask (lengths in [T/2,
    T]). Every seventh lane is a tie lane (uniform pi and A, emissions
    rounded to integers) where the max-plus scores tie exactly. Unless
    ``finite``, a few lanes get an all -inf evidence row at a valid
    step."""
    rng = np.random.default_rng(seed)

    def log_norm(a):
        return a - np.log(np.exp(a).sum(-1, keepdims=True))

    log_pi = log_norm(rng.normal(size=(N, K)))
    log_A = log_norm(rng.normal(size=(N, K, K)))
    log_A[rng.random((N, K, K)) < 0.2] = MASK_NEG
    log_obs = rng.normal(size=(N, T, K)) - 1.0
    ties = np.arange(N) % 7 == 0
    log_pi[ties] = -np.log(K)
    log_A[ties] = -np.log(K)
    log_obs[ties] = np.round(log_obs[ties])
    lengths = rng.integers(T // 2, T + 1, size=N)
    if not finite:
        for n in rng.choice(N, size=8, replace=False):
            log_obs[n, rng.integers(0, lengths[n])] = -np.inf
    f32 = dict(dtype=torch.float32, device=device)
    mask = np.arange(T)[None, :] < lengths[:, None]
    lanes = cs.to_lanes(*(torch.as_tensor(a, **f32) for a in (log_pi, log_A, log_obs, mask)))
    return lanes[:4]


def decode_bytes_ops(kernel, lanes):
    """Bytes (inputs read once, outputs written once) and f32 operations
    (of the valid steps) of one decode kernel on these lanes; the maps
    and the path are int32."""
    pi_t, A_t, obs_t, mask_t = lanes
    T, K, N = obs_t.shape
    steps = int((mask_t[1:] > 0).sum())
    if kernel is cs.FILTER:
        # per destination: K adds, K-1 max, the -inf test, K subtracts,
        # K exps, K adds, log, 2 adds
        floats = K * N + K * K * N + T * K * N + T * N + T * K * N + N
        return 4 * floats, steps * K * (4 * K + 3) + N * (4 * K + 2)
    if kernel is cs.BETA:
        floats = K * K * N + T * K * N + T * N + T * K * N
        return 4 * floats, steps * (K + K * (4 * K + 2))
    if kernel is cs.VITERBI:
        # per destination: K adds, K-1 compares and selects, 1 add
        floats = K * N + K * K * N + T * K * N + T * N + N + K * N + T * N
        return 4 * floats, steps * K * (3 * K - 1) + N * K
    # BACKTRACK: per step a shift and a mask on the map word
    floats = T * N + K * N + T * N
    return 4 * floats, 2 * (T - 1) * N + N * K


def phase_kernels_decode(device):
    """``FILTER``, ``BETA``, ``VITERBI`` and ``BACKTRACK`` against their
    plain versions at N=8192, T=1024, K in {3, 4, 8}: bitwise equal
    (log-values, -inf at the same places, no NaN; maps, paths and
    scores identical), and ``FILTER`` bitwise equal to ``FWD`` on finite
    inputs; then each timed at the main shape (K=4, dense mask)."""
    cases = []
    for i, K in enumerate((3, 4, 8)):
        for finite in (True, False):
            lanes = make_decode_case(5000 + 2 * i + finite, N_DEC, T_FIT, K, device, finite)
            pi_t, A_t, obs_t, mask_t = lanes
            ll_k, a_k = cs.filter_lanes(*lanes)
            b_k = cs.beta_lanes(A_t, obs_t, mask_t)
            sc_k, dl_k, bk_k = cs.viterbi_lanes(*lanes)
            path_k = cs.backtrack_lanes(bk_k, dl_k)
            ll_p, a_p = cs.filter_plain(*lanes)
            b_p = cs.beta_plain(A_t, obs_t, mask_t)
            sc_p, dl_p, bk_p = cs.viterbi_plain(*lanes)
            path_p = cs.backtrack_plain(bk_p, dl_p)
            path_kp = cs.backtrack_plain(bk_k, dl_k)  # the backtrack alone, same maps
            sync()
            got = {"filter": (a_k, ll_k), "beta": (b_k,), "viterbi": (sc_k, dl_k, bk_k),
                   "backtrack": (path_k,)}
            want = {"filter": (a_p, ll_p), "beta": (b_p,), "viterbi": (sc_p, dl_p, bk_p),
                    "backtrack": (path_kp,)}
            bad = [k for k in got if not all(torch.equal(a, b) for a, b in zip(got[k], want[k]))]
            nan = [k for k in ("filter", "beta") if bool(torch.isnan(got[k][0]).any())]
            if bad or nan or not torch.equal(path_k, path_p):
                raise AssertionError(
                    f"decode kernels K={K} finite={finite}: not identical to the plain "
                    f"versions {bad}, NaN in {nan}"
                )
            row = dict(K=K, finite=finite, neg_inf_alpha=int(torch.isinf(a_k).sum()),
                       neg_inf_beta=int(torch.isinf(b_k).sum()),
                       masked_steps=int((mask_t == 0).sum()))
            if finite:
                ll_f, a_f = cs.fwd_lanes(*lanes)
                sync()
                if not (torch.equal(a_f, a_k) and torch.equal(ll_f, ll_k)):
                    raise AssertionError(f"FILTER K={K}: alpha differs from FWD on finite inputs")
                row["filter_equals_fwd"] = True
            cases.append(row)
            emit("decode_kernels_vs_plain", N=N_DEC, T=T_FIT, bitwise_equal=True, **row)
            del lanes, pi_t, A_t, obs_t, mask_t, a_k, a_p, b_k, b_p, got, want

    # timing at the main shape: N=8192 lanes, T=1024, K=4, dense mask
    rng = np.random.default_rng(6000)
    f32 = dict(dtype=torch.float32, device=device)
    log_A = rng.normal(size=(N_DEC, K_TAYAL, K_TAYAL))
    log_A -= np.log(np.exp(log_A).sum(-1, keepdims=True))
    lanes = cs.to_lanes(
        torch.as_tensor(np.full((N_DEC, K_TAYAL), -np.log(K_TAYAL)), **f32),
        torch.as_tensor(log_A, **f32),
        torch.as_tensor(rng.normal(size=(N_DEC, T_FIT, K_TAYAL)) - 1.0, **f32),
        torch.ones((N_DEC, T_FIT), **f32),
    )[:4]
    pi_t, A_t, obs_t, mask_t = lanes
    _, dl, bk = cs.viterbi_lanes(*lanes)
    one = tuple(v[..., :1].contiguous() for v in lanes)
    _, dl1, bk1 = cs.viterbi_lanes(*one)
    calls = {
        cs.FILTER: (lambda L: cs.filter_lanes(*L), cs.filter_plain),
        cs.BETA: (lambda L: cs.beta_lanes(*L[1:]), lambda *L: cs.beta_plain(*L[1:])),
        cs.VITERBI: (lambda L: cs.viterbi_lanes(*L), cs.viterbi_plain),
    }
    timing = {}
    for k, (run, plain) in calls.items():
        timing[k.name] = dict(
            ms=time_ms(lambda: run(lanes), reps=20),
            one_lane_ms=time_ms(lambda: run(one), reps=20),
            plain_ms=time_ms(lambda: plain(*lanes), reps=2, warmup=1),
        )
    timing[cs.BACKTRACK.name] = dict(
        ms=time_ms(lambda: cs.backtrack_lanes(bk, dl), reps=20),
        one_lane_ms=time_ms(lambda: cs.backtrack_lanes(bk1, dl1), reps=20),
        plain_ms=time_ms(lambda: cs.backtrack_plain(bk, dl), reps=2, warmup=1),
    )
    for k in DECODE_KERNELS:
        b, o = decode_bytes_ops(k, lanes)
        timing[k.name].update(bytes=b, ops=o, bound=bound(b, o))
    emit("decode_kernel_timing", shape=dict(N=N_DEC, T=T_FIT, K=K_TAYAL),
         **{k: {f: v for f, v in t.items() if f != "bound"} for k, t in timing.items()})
    return dict(cases=cases, timing=timing)


# ---------------------------------------------------------------------------
# main path 3: the zoo's generated quantities
# ---------------------------------------------------------------------------


def launch_counts():
    return {k.name: k.launches for k in ALL_KERNELS}


def rose_since(before):
    return {n: v - before[n] for n, v in launch_counts().items() if v != before[n]}


def thin(q, n):
    """``[B, S, D]`` draws → ``n`` evenly spaced draws per series."""
    idx = torch.as_tensor(np.linspace(0, q.shape[1] - 1, n).astype(np.int64), device=q.device)
    return q[:, idx]


def check_probabilities(name, out, key):
    """Finite rows summing to 1: ``alpha`` (a softmax) within
    ``PROB_ATOL``, ``gamma`` within ``GAMMA_SUM_TOL``. Returns the
    largest deviation."""
    p = out[key]
    dev = float((p.sum(-1) - 1).abs().max())
    tol = GAMMA_SUM_TOL if key == "gamma" else PROB_ATOL
    if not bool(torch.isfinite(p).all()) or dev > tol:
        raise AssertionError(
            f"{name}: {key} rows are not probability vectors (off by {dev:.3g}, tol {tol})"
        )
    return dev


def check_decode_once(name, rose):
    """Each decode kernel launched exactly once by one ``generated``."""
    if any(rose.get(k.name, 0) != 1 for k in DECODE_KERNELS):
        raise AssertionError(f"{name}: generated launched {rose}, expected each decode kernel once")


def phase_decode_smooth(device, qs):
    """``TayalHHMM(gate_mode="hard").generated`` on 32 thinned Gibbs
    draws x 256 series (8192 lanes, T=1024): shapes, probability rows,
    states in range, each decode kernel launched once, and every output
    against the plain versions on the same lanes."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    hard = TayalHHMM(gate_mode="hard")
    draws = thin(qs[:, 0], N_DECODE_DRAWS)  # [B, 32, D]
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    out = hard.generated(draws, data, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    check_decode_once("decode_smooth", rose)
    B, D, T = N_SERIES, N_DECODE_DRAWS, T_FIT
    shapes = {"alpha": (B, D, T, 4), "gamma": (B, D, T, 4), "zstar": (B, D, T),
              "logp_zstar": (B, D), "loglik": (B, D)}
    for k, shp in shapes.items():
        if tuple(out[k].shape) != shp:
            raise AssertionError(f"decode_smooth: {k} shape {tuple(out[k].shape)} != {shp}")
    row_dev = {k: check_probabilities("decode_smooth", out, k) for k in ("alpha", "gamma")}
    if not bool(((out["zstar"] >= 0) & (out["zstar"] < 4)).all()):
        raise AssertionError("decode_smooth: zstar out of range")

    # the plain versions on the same lanes
    params, _ = hard.unpack(draws.reshape(N_DEC, -1))
    lanes = {k: v.repeat_interleave(D, 0) for k, v in data.items()}
    log_pi, log_A, log_obs, _ = hard.build(params, lanes)
    ones = torch.ones((N_DEC, T), dtype=torch.float32, device=device)
    pi_t, A_t, obs_t, mask_t, _, _ = cs.to_lanes(log_pi, log_A, log_obs, ones)
    ll_p, a_p = cs.filter_plain(pi_t, A_t, obs_t, mask_t)
    b_p = cs.beta_plain(A_t, obs_t, mask_t)
    sc_p, dl_p, bk_p = cs.viterbi_plain(pi_t, A_t, obs_t, mask_t)
    path_p = cs.backtrack_plain(bk_p, dl_p)
    la_p, lb_p = a_p.permute(2, 0, 1), b_p.permute(2, 0, 1)
    ref = {
        "alpha": torch.softmax(la_p, dim=-1),
        "gamma": torch.exp(smooth(la_p, lb_p)),
    }
    errs = {k: float((out[k].reshape(ref[k].shape) - v).abs().max()) for k, v in ref.items()}
    same = {
        "zstar": torch.equal(out["zstar"].reshape(N_DEC, T), path_p.t().long()),
        "logp_zstar": torch.equal(out["logp_zstar"].reshape(-1), sc_p),
        "loglik": torch.equal(out["loglik"].reshape(-1), ll_p),
    }
    if max(errs.values()) > PROB_ATOL or not all(same.values()):
        raise AssertionError(f"decode_smooth: kernels vs plain {errs}, identical {same}")
    emit("decode_smooth", lanes=N_DEC, T=T, K=4, seconds=wall, launches=rose,
         max_abs_err_vs_plain=errs, identical_vs_plain=same, row_sum_max_dev=row_dev,
         loglik_mean=float(out["loglik"].mean()))
    return dict(out=out, data=data, lanes=(log_pi, log_A, log_obs, ones))


def check_loglik_vs_fwd(dec):
    """The decode's loglik against the ``FWD`` kernel's on the same
    (finite) lanes: the guarded and the clamped filter agree bit for bit
    there. Run after the main path's counts are read."""
    _, ll_f = cs.forward_chunked(*dec["lanes"])
    sync()
    if not torch.equal(dec["out"]["loglik"].reshape(-1), ll_f):
        raise AssertionError("decode_smooth: loglik differs from FWD's")
    emit("decode_loglik_vs_fwd", lanes=N_DEC, identical=True)


def fold_pairs(p_bull, anchor):
    """Fold the pair swap (p -> 1 - p) per draw toward a per-series
    anchor path, as ``bench.py``'s ``top_state_mean`` does:
    ``p_bull [B, D, T]``, ``anchor [B, T]``."""
    d_id = ((p_bull - anchor[:, None]) ** 2).sum(-1)
    d_sw = ((1.0 - p_bull - anchor[:, None]) ** 2).sum(-1)
    return torch.where((d_sw < d_id)[..., None], 1.0 - p_bull, p_bull)


def phase_agreement(device, dec, chees_qs):
    """The ChEES draws through the same hard-gate ``generated`` (32 a
    series from the pooled chains): posterior-mean smoothed bull-pair
    probability per series, folded against the Gibbs decode's first
    draw, compared with the Gibbs one; and the Gibbs split-half floor.
    Reported, not gated: 300 draws cannot meet ``bench.py``'s absolute
    gate."""
    B = N_SERIES
    draws = thin(chees_qs.reshape(B, -1, chees_qs.shape[-1]), N_DECODE_DRAWS)
    hard = TayalHHMM(gate_mode="hard")
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    out = hard.generated(draws, dec["data"], device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    check_decode_once("agreement", rose)
    row_dev = check_probabilities("agreement", out, "gamma")
    g_gibbs, g_chees = dec["out"]["gamma"], out["gamma"]
    p_gibbs = g_gibbs[..., 2] + g_gibbs[..., 3]  # [B, D, T]
    p_chees = g_chees[..., 2] + g_chees[..., 3]
    anchor = p_gibbs[:, 0]
    f_gibbs, f_chees = fold_pairs(p_gibbs, anchor), fold_pairs(p_chees, anchor)
    gap = (f_gibbs.mean(1) - f_chees.mean(1)).abs().mean(-1)  # [B]
    floor = (f_gibbs[:, 0::2].mean(1) - f_gibbs[:, 1::2].mean(1)).abs().mean(-1)
    emit("agreement", series=B, draws_per_series=N_DECODE_DRAWS, T=T_FIT, seconds=wall,
         launches=rose, gamma_row_sum_max_dev=row_dev,
         gap_mean=float(gap.mean()), gap_worst_series=float(gap.max()),
         gibbs_split_half_floor_mean=float(floor.mean()),
         gibbs_split_half_floor_worst=float(floor.max()),
         chees_fold_share=float((f_chees != p_chees).any(-1).float().mean()))


def phase_gaussian(device):
    """The Gaussian HMM of ``hmm/main.R`` at ``bench_zoo.py::bench_hmm``'s
    Gibbs configuration, batched to 256 series: the fit (FFBS kernels
    at K=3, once a sweep), posterior-mean mu near the truth, then
    ``generated`` (each decode kernel once; Viterbi accuracy > 0.9) and
    ``state_draws`` (FWD and BWD_SAMPLE once each)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED_GAUSS)
    z_true, x = hmm_sim(gen, G_T, G_A, np.ones(G_K) / G_K, obsmodel_gaussian(G_MU, G_SIGMA),
                        batch=(N_SERIES,))
    data = {"x": x}
    model = GaussianHMM(K=G_K, nig_prior=NIGPrior(**G_PRIOR))
    init = default_init(model, data, N_SERIES, 1, seed=SEED_INIT, device=device)
    cfg = GibbsConfig(num_warmup=G_WARMUP, num_samples=G_SAMPLES, num_chains=1)
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    qs, stats = sample_gibbs(model, data, init, cfg, seed=SEED_SAMPLER, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    sweeps = G_WARMUP + G_SAMPLES
    if rose != {cs.FWD.name: sweeps, cs.BWD_SAMPLE.name: sweeps}:
        raise AssertionError(f"gaussian: fit launches {rose}, expected {sweeps} FWD and BWD_SAMPLE")
    if not bool(stats["chain_healthy"].all()) or not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError("gaussian: an unhealthy chain or a non-finite logp")
    mu_hat = model.constrained_draws(qs)["mu_k"].mean(2)[:, 0]  # [B, K]
    mu_err = (mu_hat - torch.tensor(G_MU, device=device)).abs().max(-1).values
    if not float(mu_err.mean()) <= G_MU_TOL:
        raise AssertionError(f"gaussian: posterior-mean mu off by {float(mu_err.mean()):.3g}")

    draws = thin(qs[:, 0], N_DECODE_DRAWS)
    before = launch_counts()
    sync()
    t1 = time.perf_counter()
    out = model.generated(draws, data, device=device)
    sync()
    gen_wall = time.perf_counter() - t1
    rose_gen = rose_since(before)
    check_decode_once("gaussian", rose_gen)
    row_dev = check_probabilities("gaussian", out, "gamma")
    acc = (out["zstar"] == z_true[:, None]).float().mean(-1)  # [B, D]
    if not float(acc.mean()) > G_ACC_MIN:
        raise AssertionError(f"gaussian: Viterbi accuracy {float(acc.mean()):.4g}")

    before = launch_counts()
    gen_z = torch.Generator(device=device)
    gen_z.manual_seed(SEED_GAUSS + 1)
    sync()
    t2 = time.perf_counter()
    z_draws = model.state_draws(gen_z, draws, data, device=device)
    sync()
    sd_wall = time.perf_counter() - t2
    rose_sd = rose_since(before)
    if rose_sd != {cs.FWD.name: 1, cs.BWD_SAMPLE.name: 1}:
        raise AssertionError(f"gaussian: state_draws launched {rose_sd}")
    sd_acc = (z_draws == z_true[:, None]).float().mean()
    emit("gaussian", series=N_SERIES, T=G_T, K=G_K, warmup=G_WARMUP, samples=G_SAMPLES,
         fit_seconds=wall, sweeps_per_s=sweeps / wall, fit_launches=rose,
         mu_abs_err_mean=float(mu_err.mean()), mu_abs_err_worst=float(mu_err.max()),
         mu_hat_mean=mu_hat.mean(0).tolist(), logp_mean=float(stats["logp"].mean()),
         generated_seconds=gen_wall, generated_launches=rose_gen, gamma_row_sum_max_dev=row_dev,
         viterbi_accuracy_mean=float(acc.mean()),
         viterbi_accuracy_worst_series=float(acc.mean(-1).min()),
         state_draws_seconds=sd_wall, state_draws_launches=rose_sd,
         state_draws_accuracy_mean=float(sd_acc))


def reset_all() -> None:
    for k in ALL_KERNELS:
        k.launches = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    report = build_and_load(ALL_KERNELS)
    ptxas = {
        src: [ln.strip() for ln in r["log"].splitlines() if "registers" in ln or "spill" in ln]
        for src, r in report.items()
    }
    per_source = {s: {"seconds": r["seconds"], "cached": r["cached"]} for s, r in report.items()}
    emit("build", seconds=time.perf_counter() - t0, per_source=per_source, ptxas=ptxas)

    kern = phase_kernels(device)
    vgk = phase_kernels_vg(device)
    trk = phase_kernels_traj(device)

    # main path 1, the Gibbs fit and its decode: counts from zero, read
    # after the decode
    reset_all()
    qs, gibbs_phi = phase_fit(device, kern["timing"]["fwd_ms"] + kern["timing"]["bwd_ms"])
    phase_decode(device, qs)
    gibbs = {k.name: k.launches for k in ALL_KERNELS}
    # main path 2, the fused ChEES fit
    reset_all()
    chees_qs, chees_stats = phase_chees(device, gibbs_phi)
    chees = {k.name: k.launches for k in ALL_KERNELS}
    phase_chees_repeat(device, chees_qs, chees_stats)
    phase_chees_seeds(device, chees_stats)
    # its unfused form
    reset_all()
    phase_chees_unfused(device)
    unfused = {k.name: k.launches for k in ALL_KERNELS}
    deck = phase_kernels_decode(device)
    # main path 3, the zoo's generated quantities: the hard-gate Tayal
    # decode of the Gibbs draws, the same decode of the ChEES draws, and
    # the Gaussian HMM's fit, decode and state draws
    reset_all()
    dec = phase_decode_smooth(device, qs)
    phase_agreement(device, dec, chees_qs)
    phase_gaussian(device)
    zoo = {k.name: k.launches for k in ALL_KERNELS}
    check_loglik_vs_fwd(dec)
    del dec
    missing = [n for n in (cs.FWD.name, cs.BWD_SAMPLE.name) if gibbs[n] == 0]
    missing += [n for n in (cs.FWD.name, cs.VG_BWD.name, ct.TRAJ.name) if chees[n] == 0]
    missing += [n for n in (cs.FWD.name, cs.VG_BWD.name) if unfused[n] == 0]
    missing += [k.name for k in (cs.FWD, cs.BWD_SAMPLE) + DECODE_KERNELS if zoo[k.name] == 0]
    if missing:
        raise AssertionError(f"a main path never launched {missing}")

    t = kern["timing"]
    vt, tt, dt = vgk["timing"], trk["timing"], deck["timing"]
    rows = []
    for k, launches, ms, plain, (bms, by), err, extra in (
        (cs.FWD, gibbs[cs.FWD.name], t["fwd_ms"], t["fwd_plain_ms"], kern["fwd_bound"],
         kern["fwd_err"],
         dict(ns_per_step=t["fwd_ms"] * 1e6 / T_FIT, one_lane_ms=t["fwd_one_lane_ms"],
              one_lane_ns_per_step=t["fwd_one_lane_ms"] * 1e6 / T_FIT,
              decode_gated_2048_ms=t["fwd_decode_gated_2048_ms"],
              by_lanes={n: {k: v for k, v in r.items() if k.startswith("fwd")}
                        for n, r in t["by_lanes"].items()},
              launches_chees=chees[cs.FWD.name], launches_chees_unfused=unfused[cs.FWD.name],
              bitwise_equal_cases=len(kern["cases"]),
              bytes=kern["fwd_bytes"], ops=kern["fwd_ops"])),
        (cs.BWD_SAMPLE, gibbs[cs.BWD_SAMPLE.name], t["bwd_ms"], t["bwd_plain_ms"],
         kern["bwd_bound"], kern["z_err"],
         dict(ns_per_step=t["bwd_ms"] * 1e6 / T_FIT, one_lane_ms=t["bwd_one_lane_ms"],
              one_lane_ns_per_step=t["bwd_one_lane_ms"] * 1e6 / T_FIT,
              by_lanes={n: {k: v for k, v in r.items() if k.startswith("bwd")}
                        for n, r in t["by_lanes"].items()},
              ffbs_wrapper_ms=t["ffbs_wrapper_ms"], bitwise_equal_cases=len(kern["cases"]),
              bytes=kern["bwd_bytes"], ops=kern["bwd_ops"])),
        (cs.VG_BWD, chees[cs.VG_BWD.name], vt["ms"], vt["plain_ms"], vgk["bound"],
         max(vgk["err"]["d_pi"], vgk["err"]["d_obs"], vgk["err"]["d_A"]),
         dict(one_lane_ms=vt["one_lane_ms"], launches_chees_unfused=unfused[cs.VG_BWD.name],
              max_errs=vgk["err"], fwd_ms_same_lanes=vt["fwd_ms"], lp_bc_ms=vt["lp_bc_ms"],
              bytes=vgk["bytes"], ops=vgk["ops"])),
        (ct.TRAJ, chees[ct.TRAJ.name], tt["ms"], tt["plain_ms"], trk["bound"], trk["err"],
         dict(per="leapfrog", one_lane_ms=tt["one_lane_ms"], launch_ms_16=tt["launch_ms_16"],
              ns_per_step=tt["ns_per_step"], by_lanes=tt["by_lanes"],
              odd_cases_vs_plain=trk["odd_cases"],
              closure_ms_16=tt["closure_ms_16"], max_abs_err_vs_f64_plain_8=trk["vs_f64"],
              max_abs_err_vs_unfused_T64=trk["vs_unfused"],
              max_abs_err_vs_unfused_T1024=trk["gap_full"],
              bytes_16=trk["bytes"], ops_16=trk["ops"])),
        *(
            (k, zoo[k.name], dt[k.name]["ms"], dt[k.name]["plain_ms"], dt[k.name]["bound"], 0.0,
             dict(one_lane_ms=dt[k.name]["one_lane_ms"], bytes=dt[k.name]["bytes"],
                  ops=dt[k.name]["ops"], bitwise_equal_cases=len(deck["cases"]),
                  shape=dict(N=N_DEC, T=T_FIT, K=K_TAYAL)))
            for k in DECODE_KERNELS
        ),
    ):
        rows.append({
            "name": k.name,
            "route": "cuda",
            "source": str(k.source.relative_to(k.source.parents[3])),
            "replaces": k.replaces,
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": None,
            **extra,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
