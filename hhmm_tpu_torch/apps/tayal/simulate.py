"""Synthetic tick-data generator for the Tayal pipeline.

The reference ships 47 MB of licensed TSX tick data
(`tayal2009/data/`, CC-BY-NC) which has no Python-readable form here;
tests and benchmarks instead exercise the pipeline on synthetic ticks
drawn from the model's own generative story (the reference's
calibration-by-simulation discipline, `tayal2009/main-sim.R:7-28`,
lifted from the expanded HMM to tick level):

- a 2-regime (bear/bull) chain over zig-zag legs with the sparse Tayal
  dynamics: regimes alternate down/up legs, switch at entry legs;
- each leg realizes as a monotone run of ticks (geometric length) with
  the leg's direction, plus regime-dependent drift in leg amplitude;
- per-tick sizes are lognormal with per-leg volume intensity, so the
  volume-strength feature f2 carries signal;
- timestamps advance by exponential gaps.

A copy of the NumPy-only ``hhmm_tpu/apps/tayal/simulate.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["simulate_ticks"]


def simulate_ticks(
    rng: np.random.Generator,
    n_legs: int = 400,
    p_stay_bear: float = 0.85,
    p_stay_bull: float = 0.85,
    mean_leg_ticks: float = 12.0,
    tick_size: float = 0.01,
    price0: float = 20.0,
    bull_drift: float = 0.3,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns ``(price, size, t_seconds, leg_regime)`` where
    ``leg_regime`` is the true per-leg regime (0=bear, 1=bull) for
    state-recovery checks."""
    prices, sizes, times = [price0], [float(rng.lognormal(4.0, 1.0))], [0.0]
    regime = int(rng.integers(2))
    # entry leg direction: bear regimes lead with down legs, bull with up
    direction = -1 if regime == 0 else 1
    leg_regime = np.empty(n_legs, dtype=np.int64)
    t = 0.0
    price = price0
    for leg in range(n_legs):
        leg_regime[leg] = regime
        # leg length in ticks; amplitude drift favors the regime direction
        drift = bull_drift if (regime == 1) == (direction == 1) else -bull_drift
        n_ticks = max(2, int(rng.geometric(1.0 / (mean_leg_ticks * (1.0 + max(0.0, drift))))))
        # volume intensity: higher on regime-aligned legs
        intensity = 4.0 + (0.8 if drift > 0 else 0.0) + 0.3 * rng.normal()
        for _ in range(n_ticks):
            price = max(tick_size, price + direction * tick_size)
            t += float(rng.exponential(2.0))
            prices.append(price)
            sizes.append(float(rng.lognormal(intensity, 0.8)))
            times.append(t)
        # next leg: alternate direction; regime switches at entry legs
        direction = -direction
        entering = (regime == 0 and direction == -1) or (regime == 1 and direction == 1)
        if entering:
            p_stay = p_stay_bear if regime == 0 else p_stay_bull
            if rng.random() > p_stay:
                regime = 1 - regime
                direction = -1 if regime == 0 else 1
    return (
        np.asarray(prices),
        np.asarray(sizes),
        np.asarray(times),
        leg_regime,
    )
