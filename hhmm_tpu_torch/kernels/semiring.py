"""Semiring algebra of the time-parallel HMM scans (counterpart of
``hhmm_tpu/kernels/semiring.py``): the three algebras the associative
forms of the filter, beta, Viterbi and backward draws are products in.

========================  =====================  ==========================
recursion                 semiring               element
========================  =====================  ==========================
forward filter / beta     (logsumexp, +)         [K, K] log-potential matrix
Viterbi delta             (max, +)               [K, K] log-potential matrix
backtrack / FFBS draws    (∘) map composition    [K] int K→K index map
========================  =====================  ==========================

The (logsumexp, +) and (max, +) products share the operand layout
``M_t[i, j] = log_A_t[i, j] + log_obs[t, j]`` (:func:`step_operators`);
a masked step is the semiring identity (0 diagonal, −inf elsewhere), so
a product copies the carry over padding as the sequential scans do.
Every (logsumexp, +) combine goes through the guarded
:func:`~hhmm_tpu_torch.core.lmath.safe_logsumexp`: an all-(−inf) fiber
gives −inf with a zero gradient, not NaN. Plain tensor functions over
any leading batch axes.
"""

from __future__ import annotations

from typing import Optional

import torch

from hhmm_tpu_torch.core.lmath import safe_logsumexp

__all__ = [
    "logsumexp_matmul",
    "maxplus_matmul",
    "semiring_eye",
    "compose_maps",
    "identity_map",
    "step_operators",
]


def logsumexp_matmul(Pm: torch.Tensor, Qm: torch.Tensor) -> torch.Tensor:
    """(logsumexp, +) matrix product ``(P ⊗ Q)[..., i, j] =
    logsumexp_k(P[..., i, k] + Q[..., k, j])``: its prefix products are
    the forward filter, its suffix products the backward recursion."""
    return safe_logsumexp(Pm[..., :, :, None] + Qm[..., None, :, :], dim=-2)


def maxplus_matmul(Pm: torch.Tensor, Qm: torch.Tensor) -> torch.Tensor:
    """(max, +) matrix product ``(P ⊗ Q)[..., i, j] = max_k(P[..., i, k]
    + Q[..., k, j])``, the Viterbi delta recursion's combine."""
    return torch.amax(Pm[..., :, :, None] + Qm[..., None, :, :], dim=-2)


def semiring_eye(K: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Multiplicative identity of both log-space semirings: 0 on the
    diagonal, −inf elsewhere (⊗ by it copies: the masked step)."""
    eye = torch.eye(K, dtype=torch.bool, device=device)
    return torch.where(eye, 0.0, float("-inf")).to(dtype)


def compose_maps(Fm: torch.Tensor, Gm: torch.Tensor) -> torch.Tensor:
    """K-ary index-map composition ``(F ∘ G)[..., j] = F[..., G[...,
    j]]`` (associative: the parallel backtrack and backward draw)."""
    return torch.gather(Fm, -1, Gm)


def identity_map(K: int, device=None) -> torch.Tensor:
    """Identity of map composition, ``arange(K)`` (int64; the masked
    step's backpointer)."""
    return torch.arange(K, dtype=torch.long, device=device)


def step_operators(
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-step operands ``M[..., t-1, i, j] = log_A_t[i, j] + log_obs[t,
    j]`` for t = 1..T−1, ``[..., T−1, K, K]`` (``log_A`` homogeneous
    ``[..., K, K]`` or time-varying ``[..., T−1, K, K]``); a masked step
    is :func:`semiring_eye`."""
    T, K = log_obs.shape[-2:]
    lA = log_A if log_A.ndim == log_obs.ndim + 1 else log_A[..., None, :, :]
    M = lA + log_obs[..., 1:, None, :]
    if mask is not None:
        eye = semiring_eye(K, log_obs.dtype, log_obs.device)
        M = torch.where(mask[..., 1:, None, None] > 0, M, eye)
    return M
