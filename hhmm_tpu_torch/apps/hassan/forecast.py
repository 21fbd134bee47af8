"""Likelihood-neighbor forecaster — `hassan2005/R/forecast.R:1-31`
(the port's copy of the two NumPy functions of
``hhmm_tpu/apps/hassan/forecast.py``) and the served one-step forecast
:func:`online_forecast_mean`.

Hassan's method: for each posterior draw, find past time steps whose
observation log-likelihood is within a relative ``threshold`` of the
final step's (falling back to the single closest when none qualify),
and forecast x_T plus the likelihood-weighted mean of those neighbors'
h-step-ahead changes.

Weight quirk: the reference weights neighbors by ``w = exp(d)`` with
d = |oblik_target − oblik_neighbor| — *larger* distance, *larger*
weight (`forecast.R:24-25`). We reproduce that verbatim as
``weights="reference"`` and offer the presumably-intended
``weights="inverse"`` (w = exp(−d)); the two differ little in practice
because qualifying neighbors are within a tight band.
"""

from __future__ import annotations

import numpy as np

__all__ = ["neighbouring_forecast", "forecast_errors", "online_forecast_mean"]


def neighbouring_forecast(
    x: np.ndarray,
    oblik_t: np.ndarray,
    h: int = 1,
    threshold: float = 0.05,
    weights: str = "reference",
) -> np.ndarray:
    """``x`` [T] unscaled observations, ``oblik_t`` [draws, T] per-draw
    per-step observation log-likelihoods. Returns one forecast of
    ``x[T-1+h]`` per posterior draw."""
    x = np.asarray(x, dtype=np.float64)
    oblik_t = np.atleast_2d(np.asarray(oblik_t, dtype=np.float64))
    if x.shape[0] != oblik_t.shape[1]:
        raise ValueError(
            f"x length {x.shape[0]} != oblik width {oblik_t.shape[1]}"
        )
    if weights not in ("reference", "inverse"):
        raise ValueError("weights must be 'reference' or 'inverse'")
    n_draws, T = oblik_t.shape
    out = np.empty(n_draws)
    for n in range(n_draws):
        target = oblik_t[n, -1]
        cand = oblik_t[n, : T - h]
        dist = np.abs(target - cand)
        ind = np.flatnonzero(dist < abs(target) * threshold)
        if ind.size == 0:
            ind = np.flatnonzero(dist == dist.min())
        d = dist[ind]
        w = np.exp(d) if weights == "reference" else np.exp(-d)
        out[n] = x[-1] + np.sum((x[ind + h] - x[ind]) * w) / np.sum(w)
    return out


def online_forecast_mean(scheduler, series_id: str) -> float:
    """Hassan-style next-observation point forecast, served online.

    Reads ``series_id``'s streaming state off a
    :class:`hhmm_tpu_torch.serve.MicroBatchScheduler` serving a
    Gaussian-emission model and returns the one-step posterior-predictive
    mean ``E[x_{t+1} | x_{1:t}]``: per thinned draw, the filtered state
    pushed through the transition and dotted with the state means
    ``mu_k``, averaged over draws (``serve/online.py::
    posterior_predictive_mean``) with the scheduler's quarantined draws
    left out. An explicit-duration posterior (``dur_kd``) serves its
    filter on the ``K * Dmax`` expansion: the transition is expanded
    (``kernels/duration.py::expand_transition``) and the predictive
    collapsed to regimes before the dot."""
    from hhmm_tpu_torch.core.lmath import safe_log
    from hhmm_tpu_torch.kernels.duration import expand_transition
    from hhmm_tpu_torch.serve.online import posterior_predictive_mean

    log_alpha, _, ok, params = scheduler.state(series_id)
    if "mu_k" not in params or "A_ij" not in params:
        raise ValueError(
            "online_forecast_mean needs a Gaussian-emission HMM posterior "
            f"(mu_k, A_ij); got parameters {sorted(params)}"
        )
    if "dur_kd" in params:
        dur = params["dur_kd"]
        log_A = expand_transition(safe_log(params["A_ij"]), safe_log(dur))
        out = posterior_predictive_mean(log_alpha, log_A, params["mu_k"], weights=ok,
                                        dmax=int(dur.shape[-1]))
    else:
        out = posterior_predictive_mean(log_alpha, safe_log(params["A_ij"]), params["mu_k"],
                                        weights=ok)
    return float(out)


def forecast_errors(actual: np.ndarray, predicted: np.ndarray) -> dict:
    """MSE / MAPE / R² — the out-of-sample error table of
    `hassan2005/main.Rmd:920-933`."""
    actual = np.asarray(actual, dtype=np.float64)
    predicted = np.asarray(predicted, dtype=np.float64)
    err = actual - predicted
    ss_res = float(np.sum(err**2))
    ss_tot = float(np.sum((actual - actual.mean()) ** 2))
    return {
        "mse": float(np.mean(err**2)),
        "mape": float(np.mean(np.abs(err / actual))) * 100.0,
        "r2": 1.0 - ss_res / ss_tot,
    }
