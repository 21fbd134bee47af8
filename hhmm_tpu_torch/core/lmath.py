"""Log-space math primitives (counterpart of ``hhmm_tpu/core/lmath.py``)."""

from __future__ import annotations

import torch

__all__ = [
    "MASK_NEG",
    "safe_log",
    "safe_logsumexp",
    "log_normalize",
    "safe_log_normalize",
    "log_vecmat",
    "log_matvec",
]

# Finite stand-in for -inf in masked/gated log-probabilities: any masked
# path sits at least e^-10000 below real paths (exactly 0 in f32) while
# every downstream arithmetic stays finite.
MASK_NEG = -1.0e4

_TINY = 1.1754944e-38  # smallest f32 normal


def safe_log(x: torch.Tensor) -> torch.Tensor:
    """log with a floor: zeros (structural or underflowed) map to
    log(f32-tiny) ≈ -87.3 instead of -inf."""
    tiny = torch.as_tensor(_TINY, dtype=x.dtype, device=x.device)
    return torch.log(torch.where(x > tiny, x, tiny))


def safe_logsumexp(
    log_x: torch.Tensor,
    dim: int = -1,
    keepdim: bool = False,
    floor: float = float("-inf"),
) -> torch.Tensor:
    """``logsumexp`` guarded against the all-(−inf) row: such a row
    returns ``floor`` (default −inf) instead of NaN arithmetic; every
    other row is plain ``logsumexp``."""
    all_masked = torch.all(log_x == float("-inf"), dim=dim, keepdim=True)
    out = torch.logsumexp(log_x.masked_fill(all_masked, 0.0), dim=dim, keepdim=keepdim)
    am = all_masked if keepdim else all_masked.squeeze(dim)
    return torch.where(am, torch.full_like(out, floor), out)


def log_normalize(log_x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Normalize a log-space vector so that ``exp`` of it sums to one."""
    return log_x - torch.logsumexp(log_x, dim=dim, keepdim=True)


def safe_log_normalize(log_x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """:func:`log_normalize` with a guarded denominator: an all-(−inf)
    row normalizes to ``log_x - MASK_NEG`` (the entries stay −inf, no
    NaN) instead of ``-inf - -inf``."""
    return log_x - safe_logsumexp(log_x, dim=dim, keepdim=True, floor=MASK_NEG)


def log_vecmat(log_x: torch.Tensor, log_A: torch.Tensor) -> torch.Tensor:
    """Log-space row vector times matrix, ``out[..., j] = logsumexp_i(x[...,
    i] + A[..., i, j])`` — the forward step with ``A[i, j] = log P(z_t =
    j | z_{t-1} = i)``."""
    return torch.logsumexp(log_x[..., :, None] + log_A, dim=-2)


def log_matvec(log_A: torch.Tensor, log_x: torch.Tensor) -> torch.Tensor:
    """Log-space matrix times column vector, ``out[..., i] =
    logsumexp_j(A[..., i, j] + x[..., j])`` — the backward step."""
    return torch.logsumexp(log_A + log_x[..., None, :], dim=-1)
