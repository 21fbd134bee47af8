"""Forward filtering, backward pass and smoothing as plain guarded scans
(counterpart of ``hhmm_tpu/kernels/filtering.py``).

Generic step interface, batch-native (any leading batch axes ``...``):

- ``log_pi``  [..., K]                       initial log-probabilities
- ``log_A``   [..., K, K] or [..., T-1, K, K] transition log-probs
  (``log_A[i, j] = log P(z_t = j | z_{t-1} = i)``; the time-varying
  form's row t drives the t → t+1 step)
- ``log_obs`` [..., T, K]                     per-step emission log-liks
- ``mask``    [..., T] optional               1 valid, 0 padding; a
  masked step copies the carry.

These are the recursions the decode runs on the CPU and for a
time-varying ``log_A`` on any device; a homogeneous ``log_A`` on the
card goes to the ``FILTER`` / ``BETA`` kernels
(``kernels/dispatch.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hhmm_tpu_torch.core.lmath import (
    log_matvec,
    log_vecmat,
    safe_log_normalize,
    safe_logsumexp,
)

__all__ = [
    "filter_step",
    "forward_filter",
    "backward_pass",
    "smooth",
    "forward_backward",
    "time_varying",
]


def time_varying(log_A: torch.Tensor, log_obs: torch.Tensor) -> bool:
    """Whether ``log_A`` is the per-step ``[..., T-1, K, K]`` form (and
    check its step count)."""
    if log_A.ndim != log_obs.ndim + 1:
        return False
    T = log_obs.shape[-2]
    if log_A.shape[-3] != T - 1:
        raise ValueError(
            f"time-varying log_A must have T-1={T - 1} slices, got {log_A.shape[-3]}"
        )
    return True


def filter_step(
    log_alpha: torch.Tensor,
    log_A: torch.Tensor,
    log_obs_t: torch.Tensor,
    mask_t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One forward step ``α'_j = lse_i(α_i + A_ij) + obs_j``; a masked
    step (``mask_t == 0``) returns the carry unchanged."""
    new = log_vecmat(log_alpha, log_A) + log_obs_t
    if mask_t is not None:
        new = torch.where(mask_t[..., None] > 0, new, log_alpha)
    return new


def forward_filter(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward recursion: ``(log_alpha [..., T, K], loglik [...])``.

    ``log_alpha`` is unnormalized; ``loglik`` is the guarded logsumexp
    of the last carry (an all-(−inf) filter gives −inf, not NaN)."""
    T = log_obs.shape[-2]
    tv = time_varying(log_A, log_obs)
    alpha = log_pi + log_obs[..., 0, :]
    if mask is not None:
        alpha = torch.where(mask[..., 0, None] > 0, alpha, log_pi)
    out = [alpha]
    for t in range(1, T):
        lA = log_A[..., t - 1, :, :] if tv else log_A
        alpha = filter_step(alpha, lA, log_obs[..., t, :], None if mask is None else mask[..., t])
        out.append(alpha)
    return torch.stack(out, dim=-2), safe_logsumexp(alpha, dim=-1)


def backward_pass(
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Backward recursion: ``log_beta [..., T, K]`` with ``beta[T-1] =
    0`` and ``beta[t][i] = lse_j(A[i, j] + obs[t+1, j] + beta[t+1, j])``;
    a step whose successor is masked copies the carry, so on a
    tail-padded series ``beta`` at the valid steps is the unpadded
    recursion."""
    T = log_obs.shape[-2]
    tv = time_varying(log_A, log_obs)
    beta = torch.zeros_like(log_obs[..., 0, :])
    out = [beta]
    for t in range(T - 2, -1, -1):
        lA = log_A[..., t, :, :] if tv else log_A
        new = log_matvec(lA, log_obs[..., t + 1, :] + beta)
        if mask is not None:
            new = torch.where(mask[..., t + 1, None] > 0, new, beta)
        beta = new
        out.append(beta)
    out.reverse()
    return torch.stack(out, dim=-2)


def smooth(log_alpha: torch.Tensor, log_beta: torch.Tensor) -> torch.Tensor:
    """Smoothed state log-probabilities ``log_gamma [..., T, K]``,
    normalized per step; an all-(−inf) step stays −inf instead of NaN."""
    return safe_log_normalize(log_alpha + log_beta, dim=-1)


def forward_backward(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
):
    """``(log_alpha, log_beta, log_gamma, loglik)`` by the scans."""
    log_alpha, loglik = forward_filter(log_pi, log_A, log_obs, mask)
    log_beta = backward_pass(log_A, log_obs, mask)
    return log_alpha, log_beta, smooth(log_alpha, log_beta), loglik
