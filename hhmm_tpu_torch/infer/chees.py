"""ChEES-HMC: cross-chain adaptive HMC over a series x chains batch
(counterpart of ``hhmm_tpu/infer/chees.py``).

NUTS adapts trajectory length per transition by doubling a tree; in a
batch every series would pay the deepest tree any member grows. ChEES-
HMC (Hoffman, Radul & Sountsov, AISTATS 2021) uses fixed, jittered
trajectory lengths shared by all chains and adapts them in warmup by
gradient ascent on the ChEES criterion from cross-chain expectations,
so every chain takes the same number of leapfrogs per transition.

:func:`sample_chees_batched` is the core: one (step size, trajectory
length) pair pooled over every chain of a ``[B, C]`` batch, per-series
centering of the criterion and per-series diagonal mass matrices. With
``ChEESConfig(shared_adaptation=False)`` every series owns its step
size, trajectory length and their adaptation state instead (the JAX
``fit_batched`` vmaps ``sample_chees`` over series for this): the series
still run as one batch of lanes, one ``lp_bc`` call a leapfrog, each
transition as long as its longest series, a series that has run its own
count frozen for the rest of it (the vmapped ``while_loop``'s
semantics). :func:`sample_chees` is the single-posterior form (``B =
1``). Details follow the JAX module and the paper:

- trajectory jitter ``t_i = u_i * t`` with ``u_i`` the van der Corput
  base-2 sequence (:func:`halton_base2`), shared by all chains;
- per-chain Metropolis accept;
- dual-averaging step size toward the 0.651 acceptance, from the
  arithmetic mean of the healthy chains' accept probabilities;
- Adam ascent of ``log t`` on the pooled per-chain gradient
  ``accept_prob * (||q'-m'||^2 - ||q-m||^2) * ((q'-m') . v') * u_i``;
- per-series mass matrices from cross-chain Welford estimates over
  Stan's expanding windows (``infer/run.py::warmup_schedule``);
- per-series adaptation: the accept statistic and the ChEES gradient are
  reduced over each series' own chains, and the initial step size comes
  from one lockstep search over the series
  (``find_reasonable_step_size_batched``). At ``B = 1`` both arms run
  the same operations and give the same draws bit for bit.

What changes from the JAX module: ``lax.scan`` is a Python loop over
transitions whose state stays on the device (a transition needs no
host sync when it runs through a ``trajectory_fn``; the unfused
leapfrog loop reads its step count on the host); ``jax.random`` is one
``torch.Generator`` seeded with ``seed``. An active in-scan fault plan
(``robust/faults.py``) corrupts its chain after the transition, as in
the JAX loop. The sampler is one host-boundary span (``obs/trace.py``)
and reports its health (``obs/metrics.py::record_sampler_health``), as
the JAX one does; the ``jit`` argument is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.infer.nuts import (
    _kinetic,
    find_reasonable_step_size,
    find_reasonable_step_size_batched,
)
from hhmm_tpu_torch.infer.run import (
    _da_init,
    _da_update,
    _Welford,
    _welford_update,
    _welford_variance,
    vg_from_logp,
    warmup_schedule,
)
from hhmm_tpu_torch.obs.metrics import record_sampler_health
from hhmm_tpu_torch.obs.trace import span
from hhmm_tpu_torch.robust import faults
from hhmm_tpu_torch.robust.guards import finite_mask, guard_update, guard_where

__all__ = ["ChEESConfig", "halton_base2", "make_lp_bc", "sample_chees", "sample_chees_batched"]


@dataclass(frozen=True)
class ChEESConfig:
    """Budget and adaptation knobs (Hoffman et al. 2021 defaults, Stan's
    warmup structure). ``max_leapfrogs`` bounds the leapfrogs per
    transition; the trajectory-length ascent is clipped to ``eps *
    max_leapfrogs``.

    ``shared_adaptation``: adapt ONE (step size, trajectory length) pair
    from statistics pooled over every series x chain of the batch
    (:func:`sample_chees_batched`, and the chunks of
    ``batch/fit.py::fit_batched``). With it off, each series adapts its
    own pair from its own chains, and a transition lasts as long as its
    longest series."""

    num_warmup: int = 250
    num_samples: int = 250
    num_chains: int = 4
    target_accept: float = 0.651
    init_step_size: float = 0.1
    init_traj_length: float = 1.0
    max_leapfrogs: int = 256
    adam_lr: float = 0.025
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    shared_adaptation: bool = True


def halton_base2(n: int) -> np.ndarray:
    """First ``n`` points of the van der Corput base-2 sequence in (0, 1):
    bit-reversed integers. Quasi-random trajectory jitter (paper §4)."""
    out = np.zeros(n)
    for i in range(n):
        x, f, k = 0.0, 0.5, i + 1
        while k:
            x += f * (k & 1)
            k >>= 1
            f *= 0.5
        out[i] = x
    return out


def make_lp_bc(model, data: Dict[str, torch.Tensor], device: DeviceLike = None) -> Callable:
    """The chain-batched log density ``q [B, C, dim] -> (logp [B, C],
    grad [B, C, dim])`` for :func:`sample_chees_batched`, from a model
    and series-leading data arrays ``[B, ...]`` (moved to ``device``).
    Each call is ONE ``model.make_vg`` evaluation over the flat ``N =
    B * C`` lanes (one ``FWD`` + ``VG_BWD`` pair on the card), as the
    JAX package's ``custom_vmap`` collapse of its nested vmaps gives."""
    device = resolve_device(device)
    data = {k: torch.as_tensor(v, device=device) for k, v in data.items() if v is not None}
    return model.make_vg(data)


def _welford_init_bc(B: int, dim: int, dtype, device) -> _Welford:
    # per-SERIES sample counts [B, 1]: quarantined chains are left out of
    # the mass update per series, so series can count differently
    z = dict(dtype=dtype, device=device)
    return _Welford(torch.zeros((B, 1), **z), torch.zeros((B, dim), **z), torch.zeros((B, dim), **z))


def sample_chees_batched(
    lp_bc: Callable,
    init_q: torch.Tensor,
    config: ChEESConfig = ChEESConfig(),
    seed: int = 0,
    device: DeviceLike = None,
    series_weight: Optional[torch.Tensor] = None,
    probe_vg: Optional[Callable] = None,
    trajectory_fn: Optional[Callable] = None,
):
    """ChEES-HMC over a series x chains batch, with the step size and
    trajectory length shared by the batch or, with
    ``config.shared_adaptation=False``, adapted per series (see the
    module docstring).

    ``lp_bc``: ``q [B, C, dim] -> (logp [B, C], grad [B, C, dim])``
    (:func:`make_lp_bc`). ``init_q``: ``[B, C, dim]`` with ``C ==
    config.num_chains >= 2``. ``series_weight``: optional ``[B]``
    weights of the adaptation statistics (0 for padding series: left
    out of the pooled statistics, and, per series, run one leapfrog a
    transition so they never lengthen it). ``probe_vg``: optional
    value-and-grad for the initial step-size search: shared, one point
    ``q [dim] -> (logp, grad)`` (chain 0 of series 0); per series, the
    series' chain 0 ``q [B, dim] -> (logp [B], grad [B, dim])``; else
    ``lp_bc`` on a broadcast batch. ``trajectory_fn``: optional fused
    trajectory ``(inv_mass, eps, n_steps, q, p, logp, grad) -> (q, p,
    logp, grad)``, e.g. ``kernels/cuda_traj.py::make_tayal_trajectory``
    — one kernel launch per transition instead of one ``lp_bc`` call per
    leapfrog; shared adaptation only (it takes one scalar ε).

    Returns ``(samples [B, C, num_samples, dim], stats)``; every stats
    entry has a leading series axis. Per series, the stats add
    ``lockstep_leapfrogs [B, W + S]`` (the leapfrogs the batch ran a
    transition: its longest series') and ``lockstep_efficiency [B]``
    (the mean leapfrogs a series needed over those the batch ran)."""
    with span("infer.chees.sample") as sp:
        sp.annotate(warmup=config.num_warmup, samples=config.num_samples)
        qs, stats = sp.sync(_sample_chees_batched(lp_bc, init_q, config, seed, device,
                                                  series_weight, probe_vg, trajectory_fn))
    # metrics plane (obs/metrics.py): divergence and quarantine counters;
    # returns before touching a tensor while the plane is off
    record_sampler_health("chees", stats)
    return qs, stats


def _sample_chees_batched(
    lp_bc: Callable,
    init_q: torch.Tensor,
    config: ChEESConfig,
    seed: int,
    device: DeviceLike,
    series_weight: Optional[torch.Tensor],
    probe_vg: Optional[Callable],
    trajectory_fn: Optional[Callable],
):
    """The body of :func:`sample_chees_batched`."""
    device = resolve_device(device)
    init_q = torch.as_tensor(init_q, dtype=torch.float32, device=device)
    B, C, dim = init_q.shape
    if C < 2:
        raise ValueError(
            "ChEES adaptation needs >=2 chains per series (cross-chain "
            "expectations); use sample_nuts for single-chain runs"
        )
    if C != config.num_chains:
        raise ValueError(
            f"init_q has {C} chains per series, config.num_chains={config.num_chains}"
        )
    shared = config.shared_adaptation
    if trajectory_fn is not None and not shared:
        raise ValueError(
            "trajectory_fn takes one step size for the batch; per-series "
            "adaptation (shared_adaptation=False) runs the unfused leapfrogs"
        )
    traj_cap = getattr(trajectory_fn, "cap", None)
    if traj_cap is not None and traj_cap < config.max_leapfrogs:
        # the fused kernel clamps its step count to `cap`; a smaller cap
        # would silently shorten trajectories and skew the adaptation
        raise ValueError(
            f"trajectory_fn caps leapfrogs at {traj_cap} < "
            f"config.max_leapfrogs={config.max_leapfrogs}"
        )
    dtype = init_q.dtype
    f = dict(dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if series_weight is None:
        series_weight = torch.ones((B,), **f)
    series_weight = torch.as_tensor(series_weight, **f)
    w_bc = series_weight[:, None].expand(B, C)
    real = series_weight > 0
    W, S = config.num_warmup, config.num_samples
    halton = torch.as_tensor(halton_base2(W + S), **f)
    update_mass, window_end = warmup_schedule(W)
    # an active in-scan fault plan (robust/faults.py)
    fault = faults.batch_fault_arrays(B, C)

    def per_lane(v):  # an adaptation scalar ([] shared, [B] per series) over [B, C, dim]
        return v if shared else v[:, None, None]

    def reduce_chains(x):  # [B, C] -> [] pooled, or [B] per series
        return x.sum() if shared else x.sum(1)

    def kinetic(inv_mass, p):  # [B, dim], [B, C, dim] -> [B, C]
        return _kinetic(inv_mass[:, None, :], p)

    lockstep = []  # per transition: the leapfrogs the batch ran

    def leapfrogs(inv_mass, eps, n_steps, q, p, logp, grad):
        if trajectory_fn is not None:
            return trajectory_fn(inv_mass, eps, n_steps, q, p, logp, grad)
        e = per_lane(eps)
        if shared:
            n_min = n_max = int(n_steps)
        else:
            counts = n_steps.tolist()
            n_min, n_max = min(counts), max(counts)
        lockstep.append(n_max)
        for i in range(n_max):
            p_half = p + 0.5 * e * grad
            q1 = q + e * inv_mass[:, None, :] * p_half
            logp1, grad1 = lp_bc(q1)
            p1 = p_half + 0.5 * e * grad1
            if i < n_min:
                q, p, logp, grad = q1, p1, logp1, grad1
            else:  # series that have run their count keep their state
                q, p, logp, grad = guard_where(i < n_steps, (q1, p1, logp1, grad1),
                                               (q, p, logp, grad))
        return q, p, logp, grad

    def transition(qs, logps, grads, eps, inv_mass, traj, u, healthy):
        p0 = torch.randn((B, C, dim), generator=gen, **f) / torch.sqrt(inv_mass)[:, None, :]
        energy0 = -logps + kinetic(inv_mass, p0)
        # ONE step count for every chain of the batch (of a series)
        n_steps = torch.clamp(torch.ceil(u * traj / eps).to(torch.int32), 1, config.max_leapfrogs)
        if not shared:
            n_steps = torch.where(real, n_steps, torch.ones_like(n_steps))
        q1, p1, logp1, grad1 = leapfrogs(inv_mass, eps, n_steps, qs, p0, logps, grads)
        delta = -logp1 + kinetic(inv_mass, p1) - energy0
        diverging = (delta > 1000.0) | torch.isnan(delta)
        accept_prob = torch.where(
            diverging, torch.zeros_like(delta), torch.clamp_max(torch.exp(-delta), 1.0)
        )
        accept = torch.rand((B, C), generator=gen, **f) < accept_prob
        q_new = torch.where(accept[..., None], q1, qs)
        logp_new = torch.where(accept, logp1, logps)
        grad_new = torch.where(accept[..., None], grad1, grads)

        # ChEES gradient centred per series, pooled over the batch or not
        m0 = qs.mean(dim=1, keepdim=True)
        m1 = q1.mean(dim=1, keepdim=True)
        dsq = ((q1 - m1) ** 2).sum(-1) - ((qs - m0) ** 2).sum(-1)  # [B, C]
        proj = ((q1 - m1) * (inv_mass[:, None, :] * p1)).sum(-1)
        per_chain = accept_prob * dsq * proj * u
        finite = torch.isfinite(per_chain)
        # quarantined chains are left out of the adaptation statistics
        w_h = w_bc * healthy.to(dtype)
        zero = torch.zeros_like(per_chain)
        w = torch.where(finite, accept_prob, zero) * w_h
        g = torch.where(finite, per_chain, zero) * w_h
        chees_grad = reduce_chains(g) / torch.clamp_min(reduce_chains(w), 1e-6)
        mean_accept = reduce_chains(accept_prob * w_h) / torch.clamp_min(reduce_chains(w_h), 1e-6)
        return q_new, logp_new, grad_new, accept_prob, mean_accept, chees_grad, diverging, n_steps

    logps, grads = lp_bc(init_q)
    qs = init_q
    inv_mass = torch.ones((B, dim), **f)
    healthy = finite_mask((qs, logps, grads), batch_ndim=2)
    q_step = torch.where(
        healthy, torch.full((B, C), -1, device=device), torch.zeros((B, C), dtype=torch.long, device=device)
    )

    if shared:
        # shared eps_0 from one representative chain (DA converges within
        # the first warmup window regardless)
        if probe_vg is not None:
            single = probe_vg
        else:

            def single(q):
                lps, gs = lp_bc(q.expand(B, C, dim).to(dtype))
                return lps[0, 0], gs[0, 0]

        eps0 = find_reasonable_step_size(
            single, torch.ones((dim,), **f), qs[0, 0], logps[0, 0], grads[0, 0], gen,
            config.init_step_size,
        )
    else:
        # one search per series, from its chain 0, in lockstep
        if probe_vg is not None:
            probe = probe_vg
        else:

            def probe(q):
                lps, gs = lp_bc(q[:, None, :].expand(B, C, dim))
                return lps[:, 0], gs[:, 0]

        z = torch.randn((B, dim), generator=gen, **f)
        eps0 = find_reasonable_step_size_batched(
            probe, torch.ones((B, dim), **f), qs[:, 0], logps[:, 0], grads[:, 0], z,
            config.init_step_size,
        )

    def guarded_step(t, qs, logps, grads, healthy, q_step, out):
        q1, logp1, grad1 = out[:3]
        if fault is not None:
            logp1, grad1, q1 = faults.corrupt(t, *fault, logp1, grad1, q1)
        (qs, logps, grads), ok = guard_update(
            healthy, (q1, logp1, grad1), (qs, logps, grads), batch_ndim=2
        )
        q_step = torch.where(healthy & ~ok, torch.full_like(q_step, t), q_step)
        return qs, logps, grads, ok, q_step

    da = _da_init(eps0)
    log_traj = torch.log(torch.full_like(eps0, config.init_traj_length))
    adam_m = torch.zeros_like(eps0)
    adam_v = torch.zeros_like(eps0)
    adam_t = 0
    wf = _welford_init_bc(B, dim, dtype, device)
    warm_div = torch.empty((W, B, C), dtype=torch.bool, device=device)
    warm_steps = torch.empty((W,) + eps0.shape, dtype=torch.int32, device=device)
    b1, b2 = config.adam_b1, config.adam_b2
    for t in range(W):
        eps = torch.exp(da.log_eps)
        traj = torch.exp(log_traj)
        out = transition(qs, logps, grads, eps, inv_mass, traj, halton[t], healthy)
        _, _, _, _, mean_accept, chees_grad, diverging, n_steps = out
        qs, logps, grads, healthy, q_step = guarded_step(t, qs, logps, grads, healthy, q_step, out)
        warm_div[t], warm_steps[t] = diverging, n_steps
        da = _da_update(da, mean_accept, config.target_accept)

        g = chees_grad * traj  # d/d(log t): scale-free ascent
        adam_t += 1
        adam_m = b1 * adam_m + (1.0 - b1) * g
        adam_v = b2 * adam_v + (1.0 - b2) * g * g
        mhat = adam_m / (1.0 - b1**adam_t)
        vhat = adam_v / (1.0 - b2**adam_t)
        log_traj = log_traj + config.adam_lr * mhat / (torch.sqrt(vhat) + 1e-8)
        log_traj = torch.minimum(
            torch.maximum(log_traj, torch.log(eps)), torch.log(eps * config.max_leapfrogs)
        )

        if update_mass[t]:
            # per-series mass: one Welford update per healthy chain
            for c in range(C):
                new = _welford_update(wf, qs[:, c, :])
                h = healthy[:, c][:, None]  # [B, 1]
                wf = _Welford(*(torch.where(h, nn, oo) for nn, oo in zip(new, wf)))
        if window_end[t]:
            inv_mass = _welford_variance(wf)
            da = _da_init(torch.exp(da.log_eps))
            wf = _welford_init_bc(B, dim, dtype, device)

    eps_final = torch.exp(da.log_eps_bar)
    traj_final = torch.exp(log_traj)

    rec_q = torch.empty((S, B, C, dim), **f)
    rec_lp = torch.empty((S, B, C), **f)
    rec_acc = torch.empty((S, B, C), **f)
    rec_div = torch.empty((S, B, C), dtype=torch.bool, device=device)
    rec_steps = torch.empty((S,) + eps0.shape, dtype=torch.int32, device=device)
    for s in range(S):
        t = W + s
        out = transition(qs, logps, grads, eps_final, inv_mass, traj_final, halton[t], healthy)
        accept_prob, diverging, n_steps = out[3], out[6], out[7]
        qs, logps, grads, healthy, q_step = guarded_step(t, qs, logps, grads, healthy, q_step, out)
        rec_q[s], rec_lp[s], rec_acc[s] = qs, logps, accept_prob
        rec_div[s], rec_steps[s] = diverging, n_steps

    def scd(x):  # [S, B, C, ...] -> [B, C, S, ...]
        return torch.movedim(x, 0, 2)

    def by_series(x):  # [] -> [B, C] shared, [B] -> [B, C] per series
        return x.expand(B, C) if shared else x[:, None].expand(B, C)

    def steps_bc(x):  # [T] shared, [T, B] per series -> [B, C, T]
        return (x[None, None, :] if shared else x.t()[:, None, :]).expand(B, C, x.shape[0])

    stats = {
        "accept_prob": scd(rec_acc),
        "num_leaves": steps_bc(rec_steps),
        "diverging": scd(rec_div),
        "logp": scd(rec_lp),
        "step_size": by_series(eps_final),
        "inv_mass": inv_mass,
        "traj_length": by_series(traj_final),
        "warmup_diverging": scd(warm_div),
        "warmup_num_leaves": steps_bc(warm_steps)[:, 0],
        "chain_healthy": healthy,
        "quarantine_step": q_step,
    }
    if not shared:
        ran = torch.tensor(lockstep, dtype=torch.int32, device=device)
        needed = torch.cat([warm_steps, rec_steps]).float()[:, real].mean(1)
        stats["lockstep_leapfrogs"] = ran.expand(B, W + S)
        stats["lockstep_efficiency"] = (needed.sum() / ran.sum().float()).expand(B)
    return scd(rec_q), stats


def sample_chees(
    logp_fn: Optional[Callable],
    init_q: torch.Tensor,
    config: ChEESConfig = ChEESConfig(),
    seed: int = 0,
    device: DeviceLike = None,
    vg_fn: Optional[Callable] = None,
):
    """ChEES-HMC on a single posterior: ``init_q`` is ``[chains, dim]``
    (or ``[dim]``, repeated; chains should start dispersed).

    ``vg_fn`` is the fused ``q [..., dim] -> (logp [...], grad [...,
    dim])`` hot loop and takes precedence over ``logp_fn`` (``q [...,
    dim] -> logp [...]``, differentiated by autograd); both are batch-
    native over leading axes. Returns ``(samples [chains, num_samples,
    dim], stats)``: :func:`sample_chees_batched` with one series."""
    if logp_fn is None and vg_fn is None:
        raise ValueError("need logp_fn or vg_fn")
    device = resolve_device(device)
    C = config.num_chains
    init_q = torch.atleast_2d(torch.as_tensor(init_q, dtype=torch.float32, device=device))
    if init_q.shape[0] == 1 and C > 1:
        init_q = init_q.repeat(C, 1)
    if init_q.shape[0] != C:
        raise ValueError(f"init_q has {init_q.shape[0]} rows, num_chains={C}")
    if C < 2:
        raise ValueError(
            "ChEES adaptation needs >=2 chains per posterior (cross-chain "
            "expectations); use sample_nuts for single-chain runs"
        )

    single = vg_fn if vg_fn is not None else vg_from_logp(logp_fn)

    def lp_bc(q):  # [1, C, dim]
        lps, gs = single(q[0])
        return lps[None], gs[None]

    qs, stats = sample_chees_batched(
        lp_bc, init_q[None], config, seed=seed, device=device, probe_vg=single
    )
    squeeze = {k: v[0] for k, v in stats.items()}
    # shared scalars come back as broadcasts; undo for the single-posterior API
    squeeze["step_size"] = squeeze["step_size"][0]
    squeeze["traj_length"] = squeeze["traj_length"][0]
    return qs[0], squeeze
