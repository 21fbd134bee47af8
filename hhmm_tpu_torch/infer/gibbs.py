"""Batch-native blocked Gibbs sampling for conjugate HMMs (counterpart
of ``hhmm_tpu/infer/gibbs.py``): an FFBS state draw plus closed-form
Dirichlet/Beta parameter draws per sweep.

The JAX package vmaps a per-chain scan over series and lets
``custom_vmap`` fold the batch into one flat kernel launch. Here the
batch is written out: ``B`` series × ``C`` chains are ``N = B·C`` lanes
(lane ``b·C + c``), and each sweep runs the FFBS of all lanes in one
launch of each CUDA kernel (``kernels/cuda_semiring.py``), then the
conjugate draws for all lanes at once. Randomness comes from one
``torch.Generator`` on the sampling device: uniforms ``u [N, T]`` for
the FFBS, and ``torch._standard_gamma`` for the Beta/Dirichlet draws.
A model whose ``build`` gives a time-varying ``log_A`` and no gate keys
takes the scan filter and the Gumbel-max backward draw instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.kernels.dispatch import ffbs_dispatch
from hhmm_tpu_torch.kernels.ffbs import backward_sample
from hhmm_tpu_torch.kernels.filtering import forward_filter, time_varying
from hhmm_tpu_torch.obs.metrics import record_sampler_health
from hhmm_tpu_torch.obs.trace import span
from hhmm_tpu_torch.robust import faults
from hhmm_tpu_torch.robust.guards import all_finite, guard_where

__all__ = [
    "GibbsConfig",
    "sample_gibbs",
    "transition_counts",
    "emission_counts",
    "dirichlet",
    "beta",
]


@dataclass(frozen=True)
class GibbsConfig:
    """Budget for :func:`sample_gibbs`; blocked Gibbs has nothing to
    adapt.

    ``time_parallel`` routes the z-update's FFBS through
    ``kernels/dispatch.py``: ``"auto"`` (the default; the kernels unless
    a plan scope or a measured row says otherwise), ``True`` /
    ``"assoc"`` (the time-parallel scans), ``False`` / ``"seq"`` (the
    sequential scan), ``"cuda"``. Every route draws from the same
    pre-drawn uniforms by the same inverse-CDF rule, so the choice is a
    scheduling decision, not a statistical one."""

    num_warmup: int = 100
    num_samples: int = 250
    num_chains: int = 1
    time_parallel: object = "auto"


def transition_counts(
    z: torch.Tensor, K: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``[..., K, K]`` counts ``n_ij = #{t : z_t = i, z_{t+1} = j}``
    weighted by ``mask[..., t+1]`` (exact: weights are summed, not
    multiplied through a matmul)."""
    w = (
        torch.ones(z[..., 1:].shape, dtype=torch.float32, device=z.device)
        if mask is None
        else mask[..., 1:].to(torch.float32)
    )
    idx = z[..., :-1] * K + z[..., 1:]
    out = torch.zeros(z.shape[:-1] + (K * K,), dtype=torch.float32, device=z.device)
    return out.scatter_add_(-1, idx, w).reshape(z.shape[:-1] + (K, K))


def emission_counts(
    z: torch.Tensor, x: torch.Tensor, K: int, L: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``[..., K, L]`` counts ``c_kl = #{t : z_t = k, x_t = l}`` over
    valid steps."""
    w = (
        torch.ones(z.shape, dtype=torch.float32, device=z.device)
        if mask is None
        else mask.to(torch.float32)
    )
    idx = z * L + x.long()
    out = torch.zeros(z.shape[:-1] + (K * L,), dtype=torch.float32, device=z.device)
    return out.scatter_add_(-1, idx, w).reshape(z.shape[:-1] + (K, L))


def dirichlet(generator: torch.Generator, alpha: torch.Tensor) -> torch.Tensor:
    """Dirichlet draws over the last axis of ``alpha`` (normalized
    Gamma draws)."""
    g = torch._standard_gamma(alpha, generator=generator)
    return g / g.sum(-1, keepdim=True)


def beta(generator: torch.Generator, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Beta(a, b) draws, elementwise."""
    ga = torch._standard_gamma(a, generator=generator)
    gb = torch._standard_gamma(b, generator=generator)
    return ga / (ga + gb)


def sample_gibbs(
    model,
    data: Dict[str, torch.Tensor],
    init_q: torch.Tensor,
    config: GibbsConfig = GibbsConfig(),
    seed: int = 0,
    device: DeviceLike = None,
):
    """Run blocked Gibbs on ``model`` (which implements
    ``gibbs_update``) for a batch of series.

    ``data``: arrays ``[B, T]`` (``x``, ``sign``, optional ``mask``).
    ``init_q``: ``[B, C, D]`` unconstrained chain inits, ``C =
    config.num_chains`` (see ``hhmm_tpu_torch.batch.default_init``).

    Returns ``(qs [B, C, S, D], stats)`` with ``stats["logp"] [B, C,
    S]`` (the marginal log-likelihood of each recorded draw's
    parameters), ``"diverging"`` (all False, for parity),
    ``"chain_healthy"`` and ``"quarantine_step"`` ``[B, C]``. A chain
    whose draw or loglik turns non-finite is frozen at its last finite
    parameters for the rest of the run (``-1`` = never). The recorded
    pair of each sweep is its pre-update state, so the first record (the
    init) falls in warmup; ``num_warmup`` must be >= 1."""
    if config.num_warmup < 1:
        raise ValueError("GibbsConfig.num_warmup must be >= 1")
    if not hasattr(model, "gibbs_update"):
        raise ValueError(f"{type(model).__name__} does not implement gibbs_update")
    gate = getattr(model, "gate_mode", "hard")
    modes = getattr(model, "gibbs_gate_modes", ("hard",))
    if gate not in modes:
        raise ValueError(
            f"{type(model).__name__}.gibbs_update does not support gate_mode={gate!r} "
            f"(supported: {modes})"
        )
    device = resolve_device(device)
    data = {k: torch.as_tensor(v, device=device) for k, v in data.items() if v is not None}
    B, T = data["x"].shape
    C, D = config.num_chains, model.n_free
    init_q = torch.as_tensor(init_q, dtype=torch.float32, device=device)
    if tuple(init_q.shape) != (B, C, D):
        raise ValueError(f"init_q must be [B, C, D] = {(B, C, D)}, got {tuple(init_q.shape)}")
    N, S = B * C, config.num_samples
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    lanes = {k: v.repeat_interleave(C, dim=0) for k, v in data.items()}  # [N, T]
    # gate keys depend on data only: built once. A model that expresses
    # its gate by keys keeps log_A homogeneous (build_vg), so the soft
    # sign gate runs the FFBS kernels too.
    gk = model.gate_keys(lanes)
    build = model.build_vg if gk is not None else model.build
    gate_args = gk if gk is not None else (None, None)

    params, _ = model.unpack(init_q.reshape(N, D))
    healthy = all_finite(params)
    q_step = torch.where(
        healthy,
        torch.full((N,), -1, dtype=torch.long, device=device),
        torch.zeros((N,), dtype=torch.long, device=device),
    )
    ll_prev = torch.full((N,), float("nan"), device=device)
    rec = {k: torch.empty((S,) + v.shape, dtype=v.dtype, device=device) for k, v in params.items()}
    lls = torch.empty((S, N), device=device)
    # an active in-scan fault plan (robust/faults.py), per lane
    fault = faults.batch_fault_arrays(B, C)
    if fault is not None:
        fault = tuple(a.reshape(N) for a in fault)

    # host-boundary span (obs/trace.py): the sweeps and the card's work
    # they queued, attributed to the Gibbs sampler while tracing is on
    with span("infer.gibbs.sample") as sp:
        sp.annotate(chains=C, warmup=config.num_warmup, samples=S)
        # a sweep's stages are spans of their own (host time: the card
        # runs behind the host, so they split where a sweep's host time
        # goes); the FFBS is kernels/dispatch.py's span
        for t in range(config.num_warmup + S):
            with span("infer.gibbs.build"):
                log_pi, log_A, log_obs, mask = build(params, lanes)
            if gk is None and time_varying(log_A, log_obs):
                # a time-varying log_A without gate keys: the scan filter and
                # the Gumbel-max backward draw, as the JAX sweep runs it
                log_alpha, ll = forward_filter(log_pi, log_A, log_obs, mask)
                z = backward_sample(gen, log_alpha, log_A, mask)
            else:
                z, ll = ffbs_dispatch(gen, log_pi, log_A, log_obs, mask, *gate_args,
                                      time_parallel=config.time_parallel)
            with span("infer.gibbs.update"):
                new = model.gibbs_update(gen, z, lanes, params)
            with span("infer.gibbs.guard"):
                if fault is not None:
                    ll, _, _ = faults.corrupt(t, *fault, logp=ll)
                    new = faults.corrupt_tree(t, *fault, new)
                ok = healthy & all_finite(new, ll)
                new = guard_where(ok, new, params)
                q_step = torch.where(healthy & ~ok, torch.full_like(q_step, t), q_step)
                ll_rec = torch.where(torch.isfinite(ll), ll, ll_prev)
                s = t - config.num_warmup
                if s >= 0:
                    for k, v in params.items():
                        rec[k][s] = v
                    lls[s] = ll_rec
            params, healthy, ll_prev = new, ok, ll_rec

        qs = model.pack(rec)  # [S, N, D]
        sp.sync(qs)
    qs = qs.permute(1, 0, 2).reshape(B, C, S, D)
    logp = lls.t().reshape(B, C, S)
    stats = {
        "logp": logp,
        "diverging": torch.zeros_like(logp, dtype=torch.bool),
        "chain_healthy": healthy.reshape(B, C),
        "quarantine_step": q_step.reshape(B, C),
    }
    # metrics plane (obs/metrics.py): quarantine counters (Gibbs never
    # diverges; its all-False array keeps the rate honest); returns
    # before touching a tensor while the plane is off
    record_sampler_health("gibbs", stats)
    return qs, stats
