"""Trading rules — equivalents of `tayal2009/R/trading-rules.R`.

Signal on top-state switch; enter ``lag`` ticks after the signal, exit
at the next entry (last trade exits at the final tick); action −1 in
bear regimes / +1 in bull; per-trade percent return; buy-and-hold
benchmark returns per tick. A copy of the NumPy-only
``hhmm_tpu/apps/tayal/trading.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hhmm_tpu_torch.apps.tayal.constants import STATE_BEAR

__all__ = ["Trades", "topstate_trading", "buyandhold", "equity_curve"]


@dataclass(frozen=True)
class Trades:
    """Per-trade arrays (`trading-rules.R:10-18`)."""

    action: np.ndarray  # −1 short / +1 long
    signal: np.ndarray  # tick index of the top-state switch
    start: np.ndarray  # entry tick (signal + lag, clipped)
    end: np.ndarray  # exit tick
    entry_price: np.ndarray
    exit_price: np.ndarray
    perchg: np.ndarray
    ret: np.ndarray  # action * perchg
    lag: int

    def __len__(self) -> int:
        return self.action.shape[0]


def topstate_trading(price: np.ndarray, topstate: np.ndarray, lag: int = 1) -> Trades:
    """``price``/``topstate`` are per-tick; ``topstate`` uses the
    STATE_BEAR/STATE_BULL codes (`trading-rules.R:1-19`)."""
    price = np.asarray(price, dtype=np.float64)
    topstate = np.asarray(topstate)
    T = price.shape[0]
    signal = np.flatnonzero(topstate[1:] != topstate[:-1]) + 1
    start = np.minimum(signal + lag, T - 1)
    end = np.concatenate([start[1:], [T - 1]])
    action = np.where(topstate[signal] == STATE_BEAR, -1, 1)
    entry_price = price[start]
    exit_price = price[end]
    perchg = (exit_price - entry_price) / entry_price
    return Trades(
        action=action,
        signal=signal,
        start=start,
        end=end,
        entry_price=entry_price,
        exit_price=exit_price,
        perchg=perchg,
        ret=action * perchg,
        lag=lag,
    )


def buyandhold(price: np.ndarray) -> np.ndarray:
    """Per-tick simple returns (`trading-rules.R:21-25`)."""
    price = np.asarray(price, dtype=np.float64)
    return np.diff(price) / price[:-1]


def equity_curve(returns: np.ndarray) -> np.ndarray:
    """Cumulative product of (1 + r) — the equity-line of the trading
    plots (`tayal2009/R/state-plots.R:389`)."""
    return np.cumprod(1.0 + np.asarray(returns, dtype=np.float64))
