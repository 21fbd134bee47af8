"""Per-series draw reweighting: the adaptation plane's state
(counterpart of ``hhmm_tpu/adapt/weights.py``).

The serving snapshot's D thinned draws are a discrete posterior
approximation; between refits they are frozen while the market drifts.
This module treats them as a particle cloud (Liu & West 2001, Storvik
2002): a per-series ``[D]`` log-weight vector, updated every tick from
the per-draw one-step predictive increments the tick already produces
(``TickResponse.per_draw_loglik``), so the served mixture tilts toward
the draws that explain the recent data.

Conventions (shared with the serving path):

- every normalisation goes through :func:`~hhmm_tpu_torch.core.lmath.
  safe_logsumexp` / :func:`~hhmm_tpu_torch.core.lmath.
  safe_log_normalize`: an all-dead cloud degrades (uniform restart,
  ``-inf`` mixture), it never gives NaN;
- a dead draw (``ok=False`` from the chain-health guard, or a
  non-finite increment) carries ``-inf`` log-weight until a
  rejuvenation or a snapshot swap resets the cloud;
- ``forget ∈ (0, 1]`` discounts old evidence geometrically,
  ``log w' ∝ forget · log w + inc`` (an evidence window of about
  ``1 / (1 - forget)`` ticks below 1);
- ESS is ``1 / Σ ŵ_d²`` on the normalised weights: D when uniform, 1
  for a point mass, 0 for an all-dead cloud.

Every function but :func:`uniform_log_weights` (numpy, as in the JAX
package) takes ``[..., D]`` tensors (or arrays, which land on the CPU)
and returns tensors on the device of its input, so a batch of series
reweights in one call.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from hhmm_tpu_torch.core.lmath import safe_log_normalize, safe_logsumexp

__all__ = [
    "uniform_log_weights",
    "update_log_weights",
    "ess",
    "weighted_mixture_loglik",
    "uniform_mixture_loglik",
    "normalized_weights",
    "weighted_state_probs",
]


def uniform_log_weights(n_draws: int, dtype=np.float32) -> np.ndarray:
    """The normalised uniform log-weight vector ``[-log D] * D``: the
    state of a freshly attached (or just rejuvenated) series."""
    return np.full((int(n_draws),), -np.log(float(n_draws)), dtype=dtype)


def _alive(inc: torch.Tensor, ok) -> torch.Tensor:
    alive = torch.isfinite(inc)
    if ok is not None:
        alive = alive & torch.as_tensor(ok, device=inc.device).to(torch.bool)
    return alive


def _uniform_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, -math.log(float(x.shape[-1])))


def check_forget(forget: float) -> float:
    if not (0.0 < float(forget) <= 1.0):
        raise ValueError(f"forget must be in (0, 1], got {forget}")
    return float(forget)


def reweight(
    log_w: torch.Tensor,
    inc: torch.Tensor,
    ok: Optional[torch.Tensor],
    forget: float,
    fresh: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`update_log_weights` over rows ``[n, D]``; ``fresh [n]``
    marks rows with no stored state (their ``log_w`` is ignored and the
    unnormalised uniform row used, as ``log_w=None`` does)."""
    lw = safe_log_normalize(log_w)
    if fresh is not None:
        lw = torch.where(fresh[..., None], _uniform_like(inc), lw)
    # forget * (-inf) = -inf for forget > 0: a dead draw stays dead
    lw = lw * forget
    alive = _alive(inc, ok)
    lw = torch.where(alive, lw + torch.where(alive, inc, 0.0), float("-inf"))
    any_alive = torch.isfinite(lw).any(-1, keepdim=True)
    lw = torch.where(any_alive, lw, _uniform_like(lw))
    return safe_log_normalize(lw)


def update_log_weights(log_w, inc, ok=None, *, forget: float = 1.0) -> torch.Tensor:
    """One reweighting step, ``log w' ∝ forget · log w + inc``.

    ``log_w [..., D]`` log-weights (``None``: uniform), ``inc [..., D]``
    the per-draw one-step predictive increments, ``ok`` an optional
    ``[..., D]`` health mask. Unhealthy draws and non-finite increments
    go to ``-inf``; a tick that kills every draw resets that series to
    uniform instead of an all-``-inf`` state. Returns normalised
    log-weights on ``inc``'s device."""
    forget = check_forget(forget)
    inc = torch.as_tensor(inc)
    if log_w is None:
        lw = _uniform_like(inc)
        fresh = torch.ones(inc.shape[:-1], dtype=torch.bool, device=inc.device)
    else:
        lw = torch.as_tensor(log_w, dtype=inc.dtype, device=inc.device)
        fresh = None
    return reweight(lw, inc, ok, forget, fresh)


def ess(log_w) -> torch.Tensor:
    """Streaming effective sample size ``1 / Σ ŵ_d²``: D when uniform,
    1 when one draw carries all the mass, 0 for an all-dead cloud."""
    lw = safe_log_normalize(torch.as_tensor(log_w))
    s2 = safe_logsumexp(2.0 * lw)
    return torch.where(torch.isfinite(s2), torch.exp(-s2), 0.0)


def weighted_mixture_loglik(log_w, inc, ok=None) -> torch.Tensor:
    """The weighted one-step predictive ``log Σ_d ŵ_d exp(inc_d)``: what
    the adapted mixture assigned to this tick's observation. Dead draws
    are excluded; an all-dead cloud gives ``-inf``."""
    inc = torch.as_tensor(inc)
    lw = safe_log_normalize(torch.as_tensor(log_w, dtype=inc.dtype, device=inc.device))
    alive = _alive(inc, ok)
    contrib = torch.where(alive, lw + torch.where(alive, inc, 0.0), float("-inf"))
    return safe_logsumexp(contrib)


def uniform_mixture_loglik(inc, ok=None) -> torch.Tensor:
    """The uniform-mixture one-step predictive over the alive draws,
    ``logsumexp(inc) - log(n_alive)``: the stale baseline (the
    convention of ``maint/shadow.py::predictive_logliks``)."""
    inc = torch.as_tensor(inc)
    alive = _alive(inc, ok)
    contrib = torch.where(alive, inc, float("-inf"))
    n_alive = alive.sum(-1)
    lse = safe_logsumexp(contrib)
    return torch.where(
        n_alive > 0, lse - torch.log(n_alive.clamp(min=1).to(inc.dtype)), float("-inf")
    )


def normalized_weights(log_w) -> torch.Tensor:
    """``exp`` of the normalised log-weights: the nonnegative measure
    ``serve/online.py::posterior_predictive_mean`` takes as
    ``weights=``. Dead draws come out exactly 0."""
    return torch.exp(safe_log_normalize(torch.as_tensor(log_w)))


def weighted_state_probs(log_w, log_alpha) -> torch.Tensor:
    """Weighted-mixture filtered state probabilities ``[..., K]`` from
    per-draw normalised filters ``log_alpha [..., D, K]``: the adapted
    counterpart of the tick response's uniform ``probs``."""
    log_alpha = torch.as_tensor(log_alpha)
    w = torch.exp(safe_log_normalize(
        torch.as_tensor(log_w, dtype=log_alpha.dtype, device=log_alpha.device)))
    return (w[..., None] * torch.exp(log_alpha)).sum(-2)
