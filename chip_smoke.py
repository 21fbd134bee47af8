#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, and hold each of
its hand-written CUDA kernels against its plain PyTorch version there.

    python3 chip_smoke.py

Two main paths, each driven with the kernel counts set to 0 just before
it and read just after:

- the batched Tayal Gibbs fit that ``bench.py`` runs by default (256
  simulated zig-zag series, T=1024, K=4, L=9, hard gate, one chain)
  followed by the walk-forward decode (``TayalHHMMLite.generated``,
  stan gate) on thinned draws;
- the batched ChEES-HMC fit of ``bench.py --sampler chees`` (the stan-
  gate ``TayalHHMM`` on the same 256 x T=1024 batch, 2 chains, so 512
  lanes, at most 16 leapfrogs a transition, 150 warmup + 150 sampling
  transitions), every trajectory one launch of the fused trajectory
  kernel; and its unfused form, every leapfrog one value-and-grad call.

Phases, one JSON object per line:

1. device  — requires CUDA (exits non-zero without it); prints the
   card's ``nvidia-smi`` name and power limit on a line of its own.
2. build   — builds every kernel from ``hhmm_tpu_torch/kernels/csrc``
   with ``nvcc`` (all sources in parallel).
3. kernels — each kernel against its plain version on the card: the
   FFBS pair at N=256, T=1024, K in {4, 8}, ungated and gated, ragged
   mask; the value-and-grad pair (``FWD`` + ``VG_BWD``) at N=512 the
   same way; the trajectory kernel at the ChEES shape with 2 leapfrogs,
   and against the unfused leapfrogs over ``make_lp_bc`` with 8; then
   times each at its main-path shape.
4. fit     — the Gibbs fit through the kernels; every chain healthy,
   every logp finite, each FFBS kernel launched exactly once per sweep.
5. decode  — ``generated`` on 8 thinned draws x 256 series (in-sample
   T=1024, out-of-sample T=256): the gated forward kernel over 2048
   lanes, compared with its plain version on the card.
6. chees   — the fused ChEES fit: every chain healthy, every logp
   finite, divergent sampling transitions at most ``DIV_SHARE_MAX`` of
   all (reported with their count), the trajectory kernel launched
   once per transition, the value-and-grad kernel once per call of the
   log density, posterior-mean emission rows near the simulator's.
   chees_repeat — the fused fit again: bitwise the same draws; its
   first divergent sampling trajectories replayed on the CPU are
   unstable in float64 too.
7. chees_unfused — 10 + 10 transitions with no trajectory kernel: the
   value-and-grad kernel launched once per log-density call, which is
   once per leapfrog plus the initial and step-size-probe calls.
8. the kernels line, then the last line ``{"ok": true, "device": ...}``.

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
from hhmm_tpu_torch.kernels import cuda_semiring as cs
from hhmm_tpu_torch.kernels import cuda_traj as ct
from hhmm_tpu_torch.kernels.cuda_build import build_and_load
from hhmm_tpu_torch.models import TayalHHMM, TayalHHMMLite
from hhmm_tpu_torch.models.base import broadcast_data
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

# tolerances (kernel vs plain version on the card)
FWD_ATOL = 1e-4  # log-alpha, absolute
LL_RTOL = 1e-5  # loglik, relative
EDGE_TOL = 1e-4  # a differing FFBS draw must have u this close to a CDF edge
MAX_FLIP_SHARE = 0.01  # share of series whose FFBS path may differ
DECODE_ATOL = 1e-5  # filtered probabilities, absolute
PHI_MAE_MAX = 0.05  # posterior-mean emission rows vs the simulator's
# divergent share of the ChEES sampling transitions (lanes x transitions):
# one shared step size meets a few genuinely unstable trajectories on
# this batch (they diverge in float64 and through the unfused path too);
# a wrong gradient diverges on a large share
DIV_SHARE_MAX = 1e-3
REPLAY_DH_MIN = 100.0  # a replayed divergence's float64 energy error
VG_LL_RTOL = 1e-5  # value-and-grad loglik, relative
VG_D_ATOL = 1e-5  # d_obs, d_pi, absolute
VG_DA_RTOL = 1e-4  # d_A, relative: a sum of T terms, one order per side
# trajectory (tests/test_pallas_traj.py's tolerances): (rtol, atol)
TRAJ_TOL = {"q": (2e-4, 2e-4), "p": (2e-3, 2e-3), "logp": (1e-4, 5e-3), "grad": (2e-3, 2e-3)}

# H100 SXM published peaks: HBM bandwidth and
# f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    sync()
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


def make_case(seed: int, N: int, T: int, K: int, gated: bool, device):
    """Random normalized (pi, A), N(-1, 1) emissions, ragged mask of
    lengths in [T/2, T], sign gate on a Tayal-like state key; returned in
    the kernels' lane layout with uniforms ``u [T, N]``."""
    rng = np.random.default_rng(seed)

    def log_norm(a):
        return a - np.log(np.exp(a).sum(-1, keepdims=True))

    f32 = dict(dtype=torch.float32, device=device)
    log_pi = torch.as_tensor(log_norm(rng.normal(size=(N, K))), **f32)
    log_A = torch.as_tensor(log_norm(rng.normal(size=(N, K, K))), **f32)
    log_obs = torch.as_tensor(rng.normal(size=(N, T, K)) - 1.0, **f32)
    lengths = rng.integers(T // 2, T + 1, size=N)
    mask = torch.as_tensor(np.arange(T)[None, :] < lengths[:, None], **f32)
    gk = sk = None
    if gated:
        gk = torch.as_tensor(rng.integers(0, 2, size=(N, T)), **f32)
        sk = torch.as_tensor(np.tile([1.0, 0.0, 0.0, 1.0], K // 4 or 1)[:K], **f32)
    u = torch.as_tensor(rng.random((N, T)), **f32)
    lanes = cs.to_lanes(log_pi, log_A.clamp_min(-1e30), log_obs, mask, gk, sk)
    return lanes, u.t().contiguous()


def edge_distance(logits: torch.Tensor, u: float) -> float:
    """Distance from ``u`` to the nearest CDF edge of ``logits [K]``."""
    p = torch.exp(logits - torch.logsumexp(logits, 0))
    cum = torch.cumsum(p[:-1], 0)
    return float((cum - u).abs().min())


def check_ffbs(z_k, z_p, alpha_p, A_t, mask_t, u_t, gate_t, sk_t):
    """FFBS kernel vs plain: at most ``MAX_FLIP_SHARE`` of lanes may
    differ on valid steps, and in each such lane the latest differing
    step must have its uniform within ``EDGE_TOL`` of a CDF edge of the
    plain version (one near-edge flip changes the successor of every
    earlier draw, so the rest of the lane may differ)."""
    T, N = z_k.shape
    t_last = mask_t.sum(0).long() - 1
    valid = torch.arange(T, device=z_k.device)[:, None] <= t_last[None, :]
    diff = (z_k != z_p) & valid
    lanes = diff.any(0).nonzero().flatten().tolist()
    if len(lanes) > MAX_FLIP_SHARE * N:
        raise AssertionError(f"FFBS: {len(lanes)} of {N} series differ from the plain version")
    dists = []
    for n in lanes:
        t = int(diff[:, n].nonzero().max())
        logits = alpha_p[t, :, n]
        if t < T - 1 and mask_t[t + 1, n] > 0:
            zn = int(z_p[t + 1, n])
            g = gate_t is None or bool(gate_t[t + 1, n] == sk_t[zn, n])
            if g:
                logits = logits + A_t[:, zn, n]
        d = edge_distance(logits.double(), float(u_t[t, n]))
        dists.append(d)
        if d > EDGE_TOL:
            raise AssertionError(
                f"FFBS: series {n} differs at t={t} with u {d:.3g} from a CDF edge"
            )
    zerr = float((z_k - z_p).abs().masked_fill(~valid, 0).max())
    return len(lanes), dists, zerr


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
    fwd_err = ll_err = z_err = 0.0
    cases = []
    for i, (K, gated) in enumerate([(4, False), (4, True), (8, False), (8, True)]):
        lanes, u_t = make_case(1000 + i, N_SERIES, T_FIT, K, gated, device)
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
        ll_k, a_k = cs.fwd_lanes(*lanes)
        z_k = cs.bwd_sample_lanes(A_t, mask_t, a_k, u_t, gate_t, sk_t)
        ll_p, a_p = cs.fwd_plain(*lanes)
        z_p = cs.bwd_sample_plain(A_t, mask_t, a_p, u_t, gate_t, sk_t)
        sync()
        err = float((a_k - a_p).abs().max())
        lerr = float(((ll_k - ll_p).abs() / ll_p.abs()).max())
        if not (err <= FWD_ATOL and lerr <= LL_RTOL):
            raise AssertionError(
                f"forward K={K} gated={gated}: log-alpha err {err:.3g} (tol {FWD_ATOL}), "
                f"ll rel err {lerr:.3g} (tol {LL_RTOL})"
            )
        n_diff, dists, zerr = check_ffbs(z_k, z_p, a_p, A_t, mask_t, u_t, gate_t, sk_t)
        fwd_err, ll_err, z_err = max(fwd_err, err), max(ll_err, lerr), max(z_err, zerr)
        cases.append(
            dict(K=K, gated=gated, alpha_max_abs_err=err, ll_max_rel_err=lerr,
                 ffbs_series_differing=n_diff, ffbs_edge_dist=dists)
        )
        emit("kernels_vs_plain", N=N_SERIES, T=T_FIT, **cases[-1])

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
    emit("kernel_timing", shape=dict(N=N_SERIES, T=T_FIT, K=K_TAYAL), **t)
    fb, fo = fwd_bytes_ops(lanes)
    bb, bo = bwd_bytes_ops(lanes)
    return dict(fwd_err=fwd_err, ll_err=ll_err, z_err=z_err, timing=t,
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
    for i, (K, gated) in enumerate([(4, False), (4, True), (8, False), (8, True)]):
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
         max_abs_err={k: v[0] for k, v in vs_plain.items()})
    emit("traj_vs_plain_f64", B=N_SERIES, C=CHAINS, T=T_FIT, n_steps=8,
         max_abs_err={k: v[0] for k, v in vs_f64.items()})
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
    emit("traj_timing", shape=dict(B=N_SERIES, C=CHAINS, T=T_FIT), per="leapfrog", **t)
    b, o = traj_bytes_ops(T_FIT, N_SERIES, CHAINS, m_t, 16)
    bms, by = bound(b, o)
    err = max(v[0] for v in vs_plain.values())
    return dict(err=err, vs_unfused={k: v[0] for k, v in vs_unfused.items()},
                vs_f64={k: v[0] for k, v in vs_f64.items()},
                gap_full={k: v[0] for k, v in gap_full.items()}, timing=t,
                bound=(bms / 16, by), bytes=b, ops=o)


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


def run_chees(device, warmup, samples, fused, recorder=False):
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
    qs, stats = sample_chees_batched(lp_bc, init, cfg, seed=SEED_SAMPLER, device=device,
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
    if not div_share <= DIV_SHARE_MAX:
        raise AssertionError(f"chees: {n_div} divergent transitions, share {div_share:.3g}")
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
    # its unfused form
    reset_all()
    phase_chees_unfused(device)
    unfused = {k.name: k.launches for k in ALL_KERNELS}
    missing = [n for n in (cs.FWD.name, cs.BWD_SAMPLE.name) if gibbs[n] == 0]
    missing += [n for n in (cs.FWD.name, cs.VG_BWD.name, ct.TRAJ.name) if chees[n] == 0]
    missing += [n for n in (cs.FWD.name, cs.VG_BWD.name) if unfused[n] == 0]
    if missing:
        raise AssertionError(f"a main path never launched {missing}")

    t = kern["timing"]
    vt, tt = vgk["timing"], trk["timing"]
    rows = []
    for k, launches, ms, plain, (bms, by), err, extra in (
        (cs.FWD, gibbs[cs.FWD.name], t["fwd_ms"], t["fwd_plain_ms"], kern["fwd_bound"],
         kern["fwd_err"],
         dict(one_lane_ms=t["fwd_one_lane_ms"], decode_gated_2048_ms=t["fwd_decode_gated_2048_ms"],
              launches_chees=chees[cs.FWD.name], launches_chees_unfused=unfused[cs.FWD.name],
              bytes=kern["fwd_bytes"], ops=kern["fwd_ops"])),
        (cs.BWD_SAMPLE, gibbs[cs.BWD_SAMPLE.name], t["bwd_ms"], t["bwd_plain_ms"],
         kern["bwd_bound"], kern["z_err"],
         dict(one_lane_ms=t["bwd_one_lane_ms"], ffbs_wrapper_ms=t["ffbs_wrapper_ms"],
              bytes=kern["bwd_bytes"], ops=kern["bwd_ops"])),
        (cs.VG_BWD, chees[cs.VG_BWD.name], vt["ms"], vt["plain_ms"], vgk["bound"],
         max(vgk["err"]["d_pi"], vgk["err"]["d_obs"], vgk["err"]["d_A"]),
         dict(one_lane_ms=vt["one_lane_ms"], launches_chees_unfused=unfused[cs.VG_BWD.name],
              max_errs=vgk["err"], fwd_ms_same_lanes=vt["fwd_ms"], lp_bc_ms=vt["lp_bc_ms"],
              bytes=vgk["bytes"], ops=vgk["ops"])),
        (ct.TRAJ, chees[ct.TRAJ.name], tt["ms"], tt["plain_ms"], trk["bound"], trk["err"],
         dict(per="leapfrog", one_lane_ms=tt["one_lane_ms"], launch_ms_16=tt["launch_ms_16"],
              closure_ms_16=tt["closure_ms_16"], max_abs_err_vs_f64_plain_8=trk["vs_f64"],
              max_abs_err_vs_unfused_T64=trk["vs_unfused"],
              max_abs_err_vs_unfused_T1024=trk["gap_full"],
              bytes_16=trk["bytes"], ops_16=trk["ops"])),
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
