"""Forward-filtering backward-sampling (counterpart of
``hhmm_tpu/kernels/ffbs.py``): state-path draws from the smoothing
posterior, by Gumbel-max or by inverse CDF.

- :func:`backward_sample` / :func:`ffbs_sample` — the Gumbel-max
  backward scan, ``z_t = argmax(log_alpha_t + log_A_t[:, z_{t+1}] +
  g_t)``, for any ``log_A``, time-varying ``[..., T-1, K, K]``
  included (the JAX package's ``lax.scan``, here PyTorch ops a step; a
  scan, not a Pallas kernel, in the JAX package too). The noise ``g [...,
  T, K]`` is an optional input, so a test can replay the JAX package's
  ``jax.random.categorical`` draws exactly; else it is drawn from a
  ``torch.Generator``.
- :func:`ffbs_invcdf_reference` — the plain scan form: the guarded
  forward filter with the gate materialized, then the exact draw rule
  of the JAX package's ``_invcdf``. Any leading batch axes.
- :func:`ffbs_fused` — the flat-batch entry ``[N, ...]`` the Gibbs sweep
  uses: draws ``u [N, T]`` from a ``torch.Generator`` and runs
  ``cuda_semiring.semiring_ffbs`` (two CUDA kernel launches on the card,
  their plain versions on the CPU). Given the same ``u`` both forms give
  the same draws away from CDF bucket edges.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hhmm_tpu_torch.kernels.cuda_semiring import semiring_ffbs
from hhmm_tpu_torch.kernels.filtering import forward_filter

__all__ = ["backward_sample", "ffbs_sample", "gumbel", "ffbs_invcdf_reference", "ffbs_fused"]


def gumbel(generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` of ``shape`` from
    ``generator``, ``u`` uniform on ``[tiny, 1)`` (the JAX ``gumbel``'s
    range), on the generator's device."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    u = torch.clamp_min(u, torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def backward_sample(
    generator: Optional[torch.Generator],
    log_alpha: torch.Tensor,  # [..., T, K]
    log_A: torch.Tensor,  # [..., K, K] or [..., T-1, K, K]
    mask: Optional[torch.Tensor] = None,  # [..., T]
    noise: Optional[torch.Tensor] = None,  # [..., T, K]
) -> torch.Tensor:
    """State paths ``z [..., T]`` (int64) given a forward filter
    ``log_alpha``: ``z_{T-1} = argmax(log_alpha_{T-1} + g_{T-1})``, then
    backwards ``z_t = argmax(log_alpha_t + log_A_t[:, z_{t+1}] + g_t)``.
    A step whose successor is padding (``mask[t+1] == 0``) draws from
    the filter alone with the same noise, and the padded tail repeats
    the last valid state, as in the JAX function. ``noise`` is the
    Gumbel noise (else drawn from ``generator``); the JAX draw at step
    ``t`` is ``jax.random.gumbel`` of its key there."""
    T, K = log_alpha.shape[-2:]
    lead = log_alpha.shape[:-2]
    tv = log_A.ndim == log_alpha.ndim + 1
    if tv and log_A.shape[-3] != T - 1:
        raise ValueError(f"time-varying log_A must have T-1={T - 1} slices, got {log_A.shape[-3]}")
    log_A = log_A.expand(lead + log_A.shape[log_A.ndim - (3 if tv else 2):])
    if noise is None:
        if generator is None:
            raise ValueError("backward_sample needs a generator or the noise")
        noise = gumbel(generator, log_alpha.shape, log_alpha.dtype)
    z = torch.empty(log_alpha.shape[:-1], dtype=torch.long, device=log_alpha.device)
    zn = torch.argmax(log_alpha[..., T - 1, :] + noise[..., T - 1, :], dim=-1)
    z[..., T - 1] = zn
    for t in range(T - 2, -1, -1):
        lA = log_A[..., t, :, :] if tv else log_A
        col = lA.gather(-1, zn[..., None, None].expand(lead + (K, 1)))[..., 0]  # log_A_t[:, z_{t+1}]
        alpha_t, g = log_alpha[..., t, :], noise[..., t, :]
        zn = torch.argmax(alpha_t + col + g, dim=-1)
        if mask is not None:
            zn = torch.where(mask[..., t + 1] > 0, zn, torch.argmax(alpha_t + g, dim=-1))
        z[..., t] = zn
    if mask is not None:
        t_last = mask.sum(-1).long() - 1
        last = z.gather(-1, t_last[..., None])
        z = torch.where(torch.arange(T, dtype=torch.long, device=z.device) <= t_last[..., None], z, last)
    return z


def ffbs_sample(
    generator: Optional[torch.Generator],
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One state path ``z [..., T]`` (int64) per series from the
    smoothing posterior: the scan forward filter, then
    :func:`backward_sample`."""
    log_alpha, _ = forward_filter(log_pi, log_A, log_obs, mask)
    return backward_sample(generator, log_alpha, log_A, mask, noise)


def _invcdf(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """z = #{k : cum_k <= u} over softmax(logits) [..., K]
    (``hhmm_tpu/kernels/ffbs.py::_invcdf``)."""
    p = torch.softmax(logits, dim=-1)
    cum = torch.cumsum(p[..., :-1], dim=-1)
    return (u[..., None] >= cum).sum(-1)


def ffbs_invcdf_reference(
    log_pi: torch.Tensor,  # [..., K]
    log_A: torch.Tensor,  # [..., K, K]
    log_obs: torch.Tensor,  # [..., T, K]
    mask: torch.Tensor,  # [..., T]
    u: torch.Tensor,  # [..., T]
    gate_key: Optional[torch.Tensor] = None,  # [..., T]
    state_key: Optional[torch.Tensor] = None,  # [..., K]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FFBS with inverse-CDF draws from ``u``: ``(z [..., T] int64,
    loglik [...])``. Homogeneous ``log_A``; ``gate_key``/``state_key``
    select the gated semantics (a gate-inconsistent successor gives a
    unit pairwise factor, so the draw uses the filter alone)."""
    if (gate_key is None) != (state_key is None):
        raise ValueError("gate_key and state_key must be given together")
    T = log_obs.shape[-2]
    if gate_key is None:
        log_alpha, ll = forward_filter(log_pi, log_A, log_obs, mask)
    else:
        c = gate_key[..., :, None] == state_key[..., None, :]  # [..., T, K]
        log_A_t = torch.where(c[..., 1:, None, :], log_A[..., None, :, :], 0.0)
        log_alpha, ll = forward_filter(log_pi, log_A_t, log_obs, mask)
    z = torch.empty(log_obs.shape[:-1], dtype=torch.long, device=log_obs.device)
    zn = _invcdf(log_alpha[..., T - 1, :], u[..., T - 1])
    z[..., T - 1] = zn
    for t in range(T - 2, -1, -1):
        g = mask[..., t + 1] > 0
        if gate_key is not None:
            sk_z = state_key.gather(-1, zn[..., None])[..., 0]
            g = g & (gate_key[..., t + 1] == sk_z)
        col = log_A.gather(-1, zn[..., None, None].expand(log_A.shape[:-1] + (1,)))[..., 0]
        alpha_t = log_alpha[..., t, :]
        logits = torch.where(g[..., None], alpha_t + col, alpha_t)
        zn = _invcdf(logits, u[..., t])
        z[..., t] = zn
    t_last = mask.sum(-1).long() - 1
    last = z.gather(-1, torch.remainder(t_last, T)[..., None])
    steps = torch.arange(T, dtype=torch.long, device=z.device)
    return torch.where(steps <= t_last[..., None], z, last), ll


def ffbs_fused(
    generator: torch.Generator,
    log_pi: torch.Tensor,  # [N, K]
    log_A: torch.Tensor,  # [N, K, K]
    log_obs: torch.Tensor,  # [N, T, K]
    mask: Optional[torch.Tensor] = None,  # [N, T]
    gate_key: Optional[torch.Tensor] = None,  # [N, T]
    state_key: Optional[torch.Tensor] = None,  # [N, K] or [K]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FFBS draw + marginal loglik for a flat batch, ``(z [N, T] int64,
    loglik [N])``, from ``T`` uniforms per lane drawn from
    ``generator`` (which must live on the operands' device)."""
    N, T, _ = log_obs.shape
    if mask is None:
        mask = torch.ones((N, T), dtype=log_obs.dtype, device=log_obs.device)
    u = torch.rand(
        (N, T), generator=generator, dtype=log_obs.dtype, device=log_obs.device
    )
    return semiring_ffbs(log_pi, log_A, log_obs, mask, u, gate_key, state_key)
