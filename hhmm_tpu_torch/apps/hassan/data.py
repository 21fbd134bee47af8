"""Hassan (2005) dataset construction — `hassan2005/R/data.R:26-56`
(the port's copy of ``hhmm_tpu/apps/hassan/data.py``, NumPy only).

Output x = close[1:], inputs u = previous day's OHLC (4 columns), with
optional z-scaling whose center/scale are kept for inverting forecasts
back to price space. Network acquisition (quantmod in the reference,
`data.R:6-24`) is out of scope in this offline environment; OHLC
matrices come from the caller (CSV, array, or the synthetic generator
below, which stands in for the LUV/RYA.L downloads in tests).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Dataset", "make_dataset", "simulate_ohlc"]


@dataclass(frozen=True)
class Dataset:
    x: np.ndarray  # [T-1] scaled close
    u: np.ndarray  # [T-1, 4] scaled previous-day OHLC
    x_unscaled: np.ndarray
    u_unscaled: np.ndarray
    x_center: float
    x_scale: float
    u_center: np.ndarray  # [4]
    u_scale: np.ndarray  # [4]

    def unscale_x(self, x: np.ndarray) -> np.ndarray:
        return x * self.x_scale + self.x_center


def make_dataset(ohlc: np.ndarray, scale: bool = True) -> Dataset:
    """``ohlc`` is [T, 4] (open, high, low, close)."""
    ohlc = np.asarray(ohlc, dtype=np.float64)
    if ohlc.ndim != 2 or ohlc.shape[1] < 4:
        raise ValueError(f"ohlc must be [T, 4], got {ohlc.shape}")
    x = ohlc[1:, 3]
    u = ohlc[:-1, :4]
    if scale:
        x_center, x_scale = x.mean(), x.std(ddof=1)
        u_center, u_scale = u.mean(axis=0), u.std(axis=0, ddof=1)
        return Dataset(
            x=(x - x_center) / x_scale,
            u=(u - u_center) / u_scale,
            x_unscaled=x,
            u_unscaled=u,
            x_center=float(x_center),
            x_scale=float(x_scale),
            u_center=u_center,
            u_scale=u_scale,
        )
    return Dataset(
        x=x,
        u=u,
        x_unscaled=x,
        u_unscaled=u,
        x_center=0.0,
        x_scale=1.0,
        u_center=np.zeros(4),
        u_scale=np.ones(4),
    )


def simulate_ohlc(
    rng: np.random.Generator,
    T: int = 300,
    price0: float = 15.0,
    regimes: int = 2,
    vol: float = 0.015,
    drift_spread: float = 0.004,
    p_stay: float = 0.97,
) -> np.ndarray:
    """Regime-switching daily OHLC path (stands in for the reference's
    quantmod downloads in this offline environment)."""
    drifts = np.linspace(-drift_spread, drift_spread, regimes)
    state = int(rng.integers(regimes))
    close = price0
    out = np.empty((T, 4))
    for t in range(T):
        if rng.random() > p_stay:
            state = int(rng.integers(regimes))
        o = close * (1 + vol / 3 * rng.normal())
        c = o * (1 + drifts[state] + vol * rng.normal())
        hi = max(o, c) * (1 + abs(vol / 2 * rng.normal()))
        lo = min(o, c) * (1 - abs(vol / 2 * rng.normal()))
        out[t] = (o, hi, lo, c)
        close = c
    return out
