"""NUTS with Stan's warmup, over a series x chains batch (counterpart of
``hhmm_tpu/infer/run.py``). The adaptation machinery is shared with the
ChEES sampler (``infer/chees.py``):

- dual averaging (Hoffman & Gelman 2014, Stan's defaults γ=0.05, t0=10,
  κ=0.75);
- diagonal mass-matrix windows (init buffer 75, base window 25
  doubling, term buffer 50, rescaled for short warmups as Stan does);
- Welford online variance with Stan's shrinkage toward unit,
  ``(n / (n+5)) var + 1e-3 (5 / (n+5))``.

State is tensors (on the sampler's device), so an adaptation step does
not synchronise with the host; the schedule itself is numpy booleans
read by the host loop.

:func:`sample_nuts_batched` is the core: every chain of a ``[B, C]``
batch is one lane of :func:`~hhmm_tpu_torch.infer.nuts.nuts_step`, with
its own dual-averaging state, diagonal inverse mass and Welford state,
adapted independently as each vmapped JAX chain is, and one ``lp(q [B,
C, dim])`` call over every lane a leapfrog. :func:`sample_nuts` is the
single-posterior form (``B = 1``). What changes from the JAX module:
``lax.scan`` is a Python loop over transitions whose state stays on the
device (the tree reads one flag a leaf on the host); ``jax.random`` is
one ``torch.Generator`` seeded with ``seed``. An active in-scan fault
plan (``robust/faults.py``) corrupts its chain after the transition, as
in the JAX loop. The sampler is one host-boundary span (``obs/trace.py``)
and reports its health (``obs/metrics.py::record_sampler_health``), as
the JAX one does; the ``jit`` argument is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.infer.nuts import GeneratorDraws, find_reasonable_step_size_batched, nuts_step
from hhmm_tpu_torch.obs.metrics import record_sampler_health
from hhmm_tpu_torch.obs.trace import span
from hhmm_tpu_torch.robust import faults
from hhmm_tpu_torch.robust.guards import finite_mask, guard_update, guard_where

__all__ = ["SamplerConfig", "sample_nuts", "sample_nuts_batched", "vg_from_logp", "warmup_schedule"]


@dataclass(frozen=True)
class SamplerConfig:
    """NUTS budget: the reference drivers' "Set up" blocks
    (`hmm/main.R:13-18`: iter/warmup/chains/seed) and Stan's defaults."""

    num_warmup: int = 500
    num_samples: int = 500
    num_chains: int = 1
    max_treedepth: int = 10
    target_accept: float = 0.8
    init_step_size: float = 0.1


def warmup_schedule(num_warmup: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stan's three-phase warmup: ``(update_mass[t], window_end[t])``
    numpy bool arrays."""
    init_buffer, term_buffer, base_window = 75, 50, 25
    if num_warmup < init_buffer + term_buffer + base_window:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.10 * num_warmup)
        base_window = num_warmup - init_buffer - term_buffer
    update_mass = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    update_mass[init_buffer : num_warmup - term_buffer] = True
    # expanding windows: 25, 50, 100, ... within the mass phase
    t = init_buffer
    w = base_window
    while t < num_warmup - term_buffer:
        end = t + w
        if end + 2 * w > num_warmup - term_buffer:
            end = num_warmup - term_buffer
        window_end[min(end, num_warmup) - 1] = True
        t = end
        w *= 2
    return update_mass, window_end


class _DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def _da_init(eps: torch.Tensor) -> _DAState:
    # log_eps_bar starts at log(eps): the first update overwrites it
    # entirely (x_eta = 1 at count 1), so the init only matters when a
    # window closes with no further update, where eps_bar must be the
    # adapted eps and not exp(0)
    return _DAState(
        log_eps=torch.log(eps),
        log_eps_bar=torch.log(eps),
        h_bar=torch.zeros_like(eps),
        mu=torch.log(10.0 * eps),
        count=torch.zeros_like(eps),
    )


def _da_update(s: _DAState, accept_prob: torch.Tensor, target: float) -> _DAState:
    gamma, t0, kappa = 0.05, 10.0, 0.75
    count = s.count + 1.0
    eta = 1.0 / (count + t0)
    h_bar = (1.0 - eta) * s.h_bar + eta * (target - accept_prob)
    log_eps = s.mu - torch.sqrt(count) / gamma * h_bar
    x_eta = count ** (-kappa)
    log_eps_bar = x_eta * log_eps + (1.0 - x_eta) * s.log_eps_bar
    return _DAState(log_eps, log_eps_bar, h_bar, s.mu, count)


class _Welford(NamedTuple):
    n: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def _welford_update(s: _Welford, x: torch.Tensor) -> _Welford:
    n = s.n + 1.0
    d = x - s.mean
    mean = s.mean + d / n
    m2 = s.m2 + d * (x - mean)
    return _Welford(n, mean, m2)


def _welford_variance(s: _Welford) -> torch.Tensor:
    var = s.m2 / torch.clamp_min(s.n - 1.0, 1.0)
    # Stan's regularization toward the unit metric
    return (s.n / (s.n + 5.0)) * var + 1e-3 * (5.0 / (s.n + 5.0))


def _welford_init(N: int, dim: int, dtype, device) -> _Welford:
    z = dict(dtype=dtype, device=device)
    return _Welford(torch.zeros((N, 1), **z), torch.zeros((N, dim), **z), torch.zeros((N, dim), **z))


def vg_from_logp(logp_fn: Callable) -> Callable:
    """``q [..., dim] -> (logp [...], grad [..., dim])`` from a batch-native
    ``logp_fn(q) -> logp [...]``, differentiated by autograd."""

    def vg(q):
        with torch.enable_grad():
            th = q.detach().requires_grad_(True)
            lp = logp_fn(th)
            (g,) = torch.autograd.grad(lp.sum(), th)
        return lp.detach(), g

    return vg


def sample_nuts_batched(
    lp_bc: Callable,
    init_q: torch.Tensor,
    config: SamplerConfig = SamplerConfig(),
    seed: int = 0,
    device: DeviceLike = None,
    draws=None,
):
    """NUTS over a series x chains batch, every chain adapted on its own
    (see the module docstring).

    ``lp_bc``: ``q [B, C, dim] -> (logp [B, C], grad [B, C, dim])``, e.g.
    ``model.make_vg(data)`` with series-leading data ``[B, ...]`` (one
    ``FWD`` + ``VG_BWD`` pair over the ``B * C`` lanes on the card).
    ``init_q``: ``[B, C, dim]`` with ``C == config.num_chains``.
    ``draws`` is the randomness source of
    :func:`~hhmm_tpu_torch.infer.nuts.nuts_step` (by default
    ``GeneratorDraws`` on a generator seeded with ``seed``): its first
    ``momentum`` call is the step-size probe's, each later one starts a
    transition.

    Returns ``(samples [B, C, num_samples, dim], stats)``; the stats are
    the JAX keys (``accept_prob``, ``num_leaves``, ``diverging``,
    ``energy``, ``depth``, ``logp`` ``[B, C, S]``; ``step_size``
    ``[B, C]``; ``inv_mass`` ``[B, C, dim]``; ``warmup_diverging``
    ``[B, C, W]``; ``chain_healthy``, ``quarantine_step`` ``[B, C]``)
    and the lockstep's own: ``warmup_num_leaves`` ``[B, C, W]``, and
    per transition (warmup, then sampling) ``lockstep_leapfrogs`` (the
    log-density calls the batch made) and ``host_syncs`` ``[B, W + S]``."""
    with span("infer.nuts.sample") as sp:
        sp.annotate(chains=config.num_chains, warmup=config.num_warmup, samples=config.num_samples)
        qs, stats = sp.sync(_sample_nuts_batched(lp_bc, init_q, config, seed, device, draws))
    # metrics plane (obs/metrics.py): divergence and quarantine counters;
    # returns before touching a tensor while the plane is off
    record_sampler_health("nuts", stats)
    return qs, stats


def _sample_nuts_batched(
    lp_bc: Callable,
    init_q: torch.Tensor,
    config: SamplerConfig,
    seed: int,
    device: DeviceLike,
    draws,
):
    """The body of :func:`sample_nuts_batched`."""
    device = resolve_device(device)
    init_q = torch.as_tensor(init_q, dtype=torch.float32, device=device)
    B, C, dim = init_q.shape
    if C != config.num_chains:
        raise ValueError(f"init_q has {C} chains per series, config.num_chains={config.num_chains}")
    N = B * C
    dtype = init_q.dtype
    f = dict(dtype=dtype, device=device)
    if draws is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        draws = GeneratorDraws(gen)
    W, S, depth_max = config.num_warmup, config.num_samples, config.max_treedepth
    update_mass, window_end = warmup_schedule(W)

    def lp(q):  # [N, dim] lanes through the [B, C] batch
        logp, grad = lp_bc(q.reshape(B, C, dim))
        return logp.reshape(N), grad.reshape(N, dim)

    q = init_q.reshape(N, dim)
    logp, grad = lp(q)
    inv_mass = torch.ones((N, dim), **f)
    eps0 = find_reasonable_step_size_batched(lp, inv_mass, q, logp, grad, draws.momentum(q),
                                             config.init_step_size)
    # chain-health guard (robust/guards.py): a lane whose state goes
    # non-finite is frozen at its last finite state, adaptation state
    # included, with the quarantine transition recorded; a lane whose
    # init is already non-finite starts quarantined at step 0
    healthy = finite_mask((q, logp, grad))
    q_step = torch.where(healthy, torch.full((N,), -1, device=device),
                         torch.zeros((N,), dtype=torch.long, device=device))

    # an active in-scan fault plan (robust/faults.py), per lane
    fault = faults.batch_fault_arrays(B, C)
    if fault is not None:
        fault = tuple(a.reshape(N) for a in fault)

    def step(t, eps, q, logp, grad, inv_mass, healthy, q_step):
        q1, logp1, grad1, info = nuts_step(lp, draws, q, logp, grad, eps, inv_mass, depth_max)
        if fault is not None:
            logp1, grad1, q1 = faults.corrupt(t, *fault, logp1, grad1, q1)
        (q1, logp1, grad1), ok = guard_update(healthy, (q1, logp1, grad1), (q, logp, grad))
        q_step = torch.where(healthy & ~ok, torch.full_like(q_step, t), q_step)
        lockstep.append((info.lockstep_leapfrogs, info.host_syncs))
        return q1, logp1, grad1, ok, q_step, info

    lockstep = []
    da = _da_init(eps0)
    wf = _welford_init(N, dim, dtype, device)
    warm_div = torch.empty((W, N), dtype=torch.bool, device=device)
    warm_leaves = torch.empty((W, N), dtype=torch.int32, device=device)
    for t in range(W):
        q, logp, grad, ok, q_step, info = step(t, torch.exp(da.log_eps), q, logp, grad, inv_mass,
                                               healthy, q_step)
        warm_div[t], warm_leaves[t] = info.diverging, info.num_leaves
        da1 = _da_update(da, info.accept_prob, config.target_accept)
        wf1 = _welford_update(wf, q) if update_mass[t] else wf
        inv_mass1 = inv_mass
        if window_end[t]:  # adopt the window's mass matrix, restart DA and Welford
            inv_mass1 = _welford_variance(wf1)
            da1 = _da_init(torch.exp(da1.log_eps))
            wf1 = _welford_init(N, dim, dtype, device)
        # quarantined lanes freeze their adaptation state too (the
        # poisoned transition's accept statistic must not reach DA)
        da, inv_mass, wf = guard_where(ok, (da1, inv_mass1, wf1), (da, inv_mass, wf))
        healthy = ok

    eps_final = torch.exp(da.log_eps_bar)
    rec_q = torch.empty((S, N, dim), **f)
    rec = {k: torch.empty((S, N), **f) for k in ("logp", "accept_prob", "energy")}
    rec.update({k: torch.empty((S, N), dtype=torch.int32, device=device)
                for k in ("num_leaves", "depth")})
    rec["diverging"] = torch.empty((S, N), dtype=torch.bool, device=device)
    for s in range(S):
        q, logp, grad, healthy, q_step, info = step(W + s, eps_final, q, logp, grad, inv_mass,
                                                    healthy, q_step)
        rec_q[s], rec["logp"][s] = q, logp
        for k in ("accept_prob", "energy", "num_leaves", "depth", "diverging"):
            rec[k][s] = getattr(info, k)

    def lanes(x):  # [N, ...] -> [B, C, ...]
        return x.reshape((B, C) + x.shape[1:])

    def scd(x):  # [T, N, ...] -> [B, C, T, ...]
        return lanes(torch.movedim(x, 0, 1))

    host = torch.tensor(lockstep, dtype=torch.int32, device=device).reshape(W + S, 2)
    stats = {k: scd(v) for k, v in rec.items()}
    stats.update({
        "step_size": lanes(eps_final),
        "inv_mass": lanes(inv_mass),
        "warmup_diverging": scd(warm_div),
        "chain_healthy": lanes(healthy),
        "quarantine_step": lanes(q_step),
        "warmup_num_leaves": scd(warm_leaves),
        "lockstep_leapfrogs": host[:, 0].expand(B, W + S),
        "host_syncs": host[:, 1].expand(B, W + S),
    })
    return scd(rec_q), stats


def sample_nuts(
    logp_fn: Optional[Callable],
    init_q: torch.Tensor,
    config: SamplerConfig = SamplerConfig(),
    seed: int = 0,
    device: DeviceLike = None,
    vg_fn: Optional[Callable] = None,
):
    """NUTS on a single posterior: ``init_q`` is ``[dim]`` (repeated over
    the chains) or ``[chains, dim]``.

    ``vg_fn`` is the fused ``q [..., dim] -> (logp [...], grad [...,
    dim])`` hot loop (``model.make_vg(data)``) and takes precedence over
    ``logp_fn`` (``q [..., dim] -> logp [...]``, e.g.
    ``model.make_logp(data)``, differentiated by autograd); both are
    batch-native over leading axes, so every chain is one lane of one
    call. Returns ``(samples [chains, num_samples, dim], stats)``:
    :func:`sample_nuts_batched` with one series, its stats without the
    series axis."""
    if logp_fn is None and vg_fn is None:
        raise ValueError("need logp_fn or vg_fn")
    device = resolve_device(device)
    C = config.num_chains
    init_q = torch.atleast_2d(torch.as_tensor(init_q, dtype=torch.float32, device=device))
    if init_q.shape[0] == 1 and C > 1:
        init_q = init_q.repeat(C, 1)
    if init_q.shape[0] != C:
        raise ValueError(f"init_q has {init_q.shape[0]} rows, config.num_chains={C}")
    single = vg_fn if vg_fn is not None else vg_from_logp(logp_fn)

    def lp_bc(q):  # [1, C, dim]
        lps, gs = single(q[0])
        return lps[None], gs[None]

    qs, stats = sample_nuts_batched(lp_bc, init_q[None], config, seed=seed, device=device)
    return qs[0], {k: v[0] for k, v in stats.items()}
