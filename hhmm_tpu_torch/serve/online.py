"""Online forward-filter core (counterpart of
``hhmm_tpu/serve/online.py``): O(K²) per-tick state updates, one-step
posterior-predictive forecasts and regime-flip detection.

Serving inverts the fit's access pattern: a tick arrives and the
filtered state must advance in O(K²) with constant memory and no
re-scan of history. The recurrence is the batch filter's
(``kernels/filtering.py::filter_step``), wrapped in a
:class:`StreamState` that carries the *normalised* filtered
log-probabilities and the running log-likelihood — the scaled forward
algorithm, which stays O(1) however long the stream runs.

Every function is batch-native: ``log_alpha [..., K]``, ``loglik
[...]``, ``log_A [..., K, K]``; the scheduler passes a bucket of N
series x D draws as one flat batch of lanes.

Numerics contract (``tests/test_torch_serve_online.py``):

- folding T :func:`stream_step` updates one tick at a time reproduces
  :func:`filter_scan` **bitwise**: the scan is a loop over t of the same
  :func:`stream_step` (not the ``FILTER`` kernel, which would break the
  fold = scan contract the scheduler's warm replay builds on);
- both agree with the batch filter up to the normalisation identity
  (``log_alpha_norm[t] = log_alpha[t] - lse(log_alpha[t])``,
  ``loglik[t] = lse(log_alpha[t])``);
- every normalisation is the guarded ``safe_log_normalize`` /
  ``safe_logsumexp`` (``core/lmath.py``): impossible evidence degrades
  the state to an all-(−inf) floor and the running log-likelihood to
  −inf, never NaN, which the scheduler's health mask then quarantines.

Per-tick model terms come from ``BaseHMMModel.tick_init`` /
``tick_terms`` (``models/base.py``), which derive them from each
model's own ``build``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hhmm_tpu_torch.core.lmath import log_vecmat, safe_log_normalize, safe_logsumexp
from hhmm_tpu_torch.kernels.duration import collapse_probs
from hhmm_tpu_torch.kernels.filtering import _split_A, filter_step

__all__ = [
    "StreamState",
    "stream_init",
    "stream_step",
    "filter_scan",
    "predictive_state_logprobs",
    "posterior_predictive_mean",
    "RegimeDetector",
    "LoglikCUSUM",
]


class StreamState(NamedTuple):
    """Constant-memory filter state of a batch of streams (a stream is
    one series x draw): ``log_alpha [..., K]`` the normalised filtered
    log-probabilities ``log p(z_t = k | x_{1:t})``, ``loglik [...]`` the
    running marginal log-likelihood ``log p(x_{1:t})``."""

    log_alpha: torch.Tensor
    loglik: torch.Tensor


def stream_init(
    log_pi: torch.Tensor,
    log_obs0: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
) -> StreamState:
    """Filter state after the first observation, ``alpha0 = log_pi +
    log_obs[0]`` as the batch filter has it (a masked t=0 keeps the
    prior)."""
    unnorm = log_pi + log_obs0
    if mask0 is not None:
        unnorm = torch.where(mask0[..., None] > 0, unnorm, log_pi)
    return StreamState(safe_log_normalize(unnorm), safe_logsumexp(unnorm))


def stream_step(
    state: StreamState,
    log_A: torch.Tensor,
    log_obs_t: torch.Tensor,
    mask_t: Optional[torch.Tensor] = None,
) -> StreamState:
    """Advance the filter by one tick: O(K²), no re-scan.

    ``log_A [..., K, K]`` is the transition slice of the (t−1)→t step.
    The normalisation increment ``lse(α')`` is the tick's conditional
    evidence ``log p(x_t | x_{1:t-1})``, added to ``loglik``. A masked
    tick (``mask_t == 0``) leaves the state as it was — the padding
    convention of :func:`filter_scan` for warm-start histories."""
    unnorm = filter_step(state.log_alpha, log_A, log_obs_t)
    new = StreamState(safe_log_normalize(unnorm), state.loglik + safe_logsumexp(unnorm))
    if mask_t is None:
        return new
    keep = mask_t > 0
    return StreamState(
        torch.where(keep[..., None], new.log_alpha, state.log_alpha),
        torch.where(keep, new.loglik, state.loglik),
    )


def _fold(log_pi, log_A, log_obs, mask, keep_all: bool):
    """The loop of :func:`stream_step` behind :func:`filter_scan` (every
    step's state) and the scheduler's warm replay (the last state)."""
    T = log_obs.shape[-2]
    A_t = _split_A(log_A, T, batch_ndim=log_obs.ndim - 2)
    st = stream_init(log_pi, log_obs[..., 0, :], None if mask is None else mask[..., 0])
    out = [st] if keep_all else None
    for t in range(1, T):
        lA = log_A if A_t is None else A_t[..., t - 1, :, :]
        st = stream_step(st, lA, log_obs[..., t, :], None if mask is None else mask[..., t])
        if keep_all:
            out.append(st)
    return out if keep_all else st


def filter_scan(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence scan of :func:`stream_step` — the batch counterpart
    of the tick fold (the scheduler's warm start from recorded history)
    and the bitwise reference of the fold.

    Returns ``(log_alpha_norm [..., T, K], loglik [..., T])`` after every
    step. Takes a homogeneous ``[..., K, K]`` or time-varying ``[...,
    T-1, K, K]`` ``log_A``, as the batch filter does."""
    states = _fold(log_pi, log_A, log_obs, mask, keep_all=True)
    return (
        torch.stack([s.log_alpha for s in states], dim=-2),
        torch.stack([s.loglik for s in states], dim=-1),
    )


# ---- one-step-ahead forecasting ----


def predictive_state_logprobs(log_alpha: torch.Tensor, log_A: torch.Tensor) -> torch.Tensor:
    """One-step-ahead state distribution ``log p(z_{t+1} | x_{1:t})
    [..., K]``: the filter pushed through the transition (guarded
    normalisation — a dead filter stays an all-(−inf) floor)."""
    return safe_log_normalize(log_vecmat(log_alpha, log_A))


def posterior_predictive_mean(
    log_alpha: torch.Tensor,
    log_A: torch.Tensor,
    state_means: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    dmax: int = 1,
) -> torch.Tensor:
    """Posterior-predictive mean of the next observation, averaged over
    thinned posterior draws (the Hassan next-close point forecast served
    online, ``apps/hassan/forecast.py::online_forecast_mean``).

    ``log_alpha [D, K]`` per-draw normalised filters, ``log_A [D, K,
    K]`` per-draw transitions, ``state_means [D, K]`` per-draw emission
    means. Per draw ``E[x_{t+1} | x_{1:t}, θ_d] = Σ_j p(z_{t+1}=j)
    μ_{d,j}``; the result is the (``weights``-)average over draws.
    ``weights`` is a nonnegative measure over draws (the scheduler's
    health mask, or normalised particle weights — fractional values are
    honoured). Zero-weight and non-finite draws are zeroed, not only
    down-weighted (``NaN * 0`` would survive); with no surviving mass the
    average falls back to the draws whose forecast is finite, and only a
    series with no finite draw gives NaN.

    ``dmax > 1``: an explicit-duration model's filter lives on the
    ``K * dmax`` count-down chain while ``state_means`` stays per regime
    ``[D, K]``; the predictive is collapsed to regimes
    (``kernels/duration.py::collapse_probs``) before the dot, and
    mismatched widths raise."""
    pred = torch.exp(predictive_state_logprobs(log_alpha, log_A))
    if dmax > 1:
        pred = collapse_probs(pred, dmax)
    state_means = torch.as_tensor(state_means, device=pred.device)
    if pred.shape[-1] != state_means.shape[-1]:
        raise ValueError(
            f"predictive width {pred.shape[-1]} != state_means width "
            f"{state_means.shape[-1]} — expanded-state filter needs "
            f"the matching dmax (models/hsmm.py: dmax = Dmax)"
        )
    per_draw = torch.sum(pred * state_means, dim=-1)  # [D]
    if weights is None:
        return torch.mean(per_draw)
    w = torch.as_tensor(weights, device=per_draw.device).to(per_draw.dtype)
    w = torch.where(torch.isfinite(w) & (w > 0), w, torch.zeros_like(w))
    finite = torch.isfinite(per_draw).to(per_draw.dtype)
    w = w * finite
    w = torch.where(torch.sum(w) > 0, w, finite)
    vals = torch.where(w > 0, per_draw, torch.zeros_like(per_draw))
    return torch.sum(vals * w) / torch.sum(w)


# ---- regime-flip detection ----


@dataclass
class RegimeDetector:
    """Filtered-argmax regime tracking with hysteresis (Tayal-style
    online bull/bear flip detection).

    A tick votes for regime ``g`` when ``g`` is the argmax of the
    (draw-averaged) regime probabilities and leads the runner-up by at
    least ``margin``. The committed regime flips only after ``hold``
    consecutive decisive votes for the same challenger. Host-side and
    O(1) a tick; feed it ``apps/tayal/analytics.py::topstate_probs`` of
    the scheduler's per-tick response."""

    hold: int = 3
    margin: float = 0.0
    regime: int = -1  # committed regime (-1 = not yet committed)
    _cand: int = field(default=-1, repr=False)
    _streak: int = field(default=0, repr=False)

    def update(self, probs) -> Tuple[int, bool]:
        """Absorb one tick of regime probabilities; returns
        ``(committed_regime, flipped_this_tick)``."""
        probs = np.asarray(probs, dtype=np.float64)
        if probs.ndim != 1 or probs.shape[0] < 2:
            raise ValueError(f"need a 1-D probs vector of >=2 regimes, got {probs.shape}")
        order = np.argsort(probs)
        top = int(order[-1])
        decisive = bool(probs[top] - probs[int(order[-2])] >= self.margin)
        if self.regime < 0:
            # the first commitment is not a flip
            if decisive:
                self.regime = top
            return self.regime, False
        if not decisive or top == self.regime:
            self._cand, self._streak = -1, 0
            return self.regime, False
        if top == self._cand:
            self._streak += 1
        else:
            self._cand, self._streak = top, 1
        if self._streak >= self.hold:
            self.regime, self._cand, self._streak = top, -1, 0
            return self.regime, True
        return self.regime, False


@dataclass
class LoglikCUSUM:
    """One-sided CUSUM drift detector on the per-tick predictive
    log-likelihood increment: a posterior going stale shows as a
    sustained drop in ``log p(x_t | x_{1:t-1})``.

    Feed it per-tick increments (consecutive differences of the
    :class:`StreamState` running ``loglik``, i.e. of the scheduler's
    ``TickResponse.loglik`` stream). Page's test, standardised online:
    the first ``calibrate`` ticks estimate the increment's mean and
    variance (Welford over the finite ones); then each tick folds the
    standardised drop ``z_t = (μ̂ − x_t)/σ̂`` into ``S_t = max(0,
    S_{t−1} + z_t − k)`` and alarms when ``S_t > h`` (defaults h=8,
    k=0.5). After an alarm the detector :meth:`reset`\\ s — the
    statistic zeroes and the baseline re-calibrates on the post-shift
    distribution — so one sustained shift fires once. Each alarm also
    increments ``serve.drift_alarms`` on the metrics plane, labelled
    ``series=`` when :attr:`series` is set (through the shared
    ``obs/request.py`` label bound)."""

    threshold: float = 8.0  # h, in σ units of cumulated drop
    drift: float = 0.5  # k, per-tick allowance in σ units
    calibrate: int = 32  # ticks of baseline estimation before arming
    min_sigma: float = 1e-6
    series: Optional[str] = None  # metrics label (None = unlabelled only)
    stat: float = field(default=0.0, repr=False)  # S_t
    alarms: int = field(default=0, repr=False)
    _n: int = field(default=0, repr=False)
    _finite: int = field(default=0, repr=False)
    _mean: float = field(default=0.0, repr=False)
    _m2: float = field(default=0.0, repr=False)

    def reset(self) -> None:
        """Re-arm from scratch: zero the statistic and re-enter baseline
        calibration (the cumulative ``alarms`` count survives)."""
        self.stat = 0.0
        self._n = 0
        self._finite = 0
        self._mean = 0.0
        self._m2 = 0.0

    def update(self, loglik_increment: float) -> Tuple[float, bool]:
        """Absorb one tick's increment; returns ``(cusum_stat,
        drifted_this_tick)``. A −inf or NaN increment (a quarantined
        stream's floor) counts as a maximal drop without touching the
        baseline; +inf (recovery from a dead tick) counts as no drop."""
        x = float(loglik_increment)
        self._n += 1
        if np.isfinite(x) and self._n <= self.calibrate:
            self._finite += 1
            d = x - self._mean
            self._mean += d / self._finite
            self._m2 += d * (x - self._mean)
        if self._n <= self.calibrate:
            return self.stat, False
        sigma = max(np.sqrt(self._m2 / max(self._finite - 1, 1)), self.min_sigma)
        if np.isfinite(x):
            z = (self._mean - x) / sigma
        elif x == float("inf"):
            z = 0.0  # recovery from a dead tick: no drop
        else:  # -inf or NaN: maximal drop
            z = self.threshold + 1.0
        self.stat = max(0.0, self.stat + z - self.drift)
        if self.stat > self.threshold:
            self.alarms += 1
            from hhmm_tpu_torch.obs import metrics as _obs_metrics

            _obs_metrics.counter("serve.drift_alarms").inc()
            if self.series is not None and _obs_metrics.enabled():
                from hhmm_tpu_torch.obs import request as _obs_request

                # the label fold mutates the shared seen-set: two
                # threads at the cardinality cap must not both pass
                with _DRIFT_LABELS_LOCK:
                    label = _obs_request.bounded_tenant_label(self.series, _DRIFT_SERIES_LABELS)
                _obs_metrics.counter("serve.drift_alarms", series=label).inc()
            self.reset()
            return 0.0, True
        return self.stat, False


# series-label values already created on the metrics plane by drift
# alarms (every detector shares one bound); the fold's check-then-add
# is atomic under the lock
_DRIFT_SERIES_LABELS: set = set()
_DRIFT_LABELS_LOCK = threading.Lock()
