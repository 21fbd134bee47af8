"""Likelihood-neighbor forecaster — `hassan2005/R/forecast.R:1-31`
(the port's copy of the two NumPy functions of
``hhmm_tpu/apps/hassan/forecast.py``).

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

Not ported yet: ``online_forecast_mean``, the served one-step forecast;
it reads the serving scheduler (``ROADMAP.md`` A10).
"""

from __future__ import annotations

import numpy as np

__all__ = ["neighbouring_forecast", "forecast_errors"]


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
