"""Single-window Tayal pipeline pieces (counterpart of
``hhmm_tpu/apps/tayal/pipeline.py``): posterior draws → hard bottom
states by median filtered probability (on the card) → top-state mapping
→ ex-post bear/bull labeling → trading.

``run_window``, which fits one window with NUTS, waits for the port's
NUTS sampler (``ROADMAP.md`` A5); the walk-forward harness
(``apps/tayal/wf.py``) fits with Gibbs or ChEES through ``fit_batched``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike
from hhmm_tpu_torch.apps.tayal.analytics import (
    TopRuns,
    map_to_topstate,
    relabel_by_return,
    topstate_runs,
    topstate_summary,
)
from hhmm_tpu_torch.apps.tayal.features import ZigZag, expand_to_ticks, expand_to_ticks_xts
from hhmm_tpu_torch.apps.tayal.trading import Trades, buyandhold, topstate_trading

__all__ = [
    "TayalWindowResult",
    "classify_hard",
    "decode_states",
    "label_and_trade",
    "LabeledWindow",
]


def classify_hard(alpha_draws: np.ndarray) -> np.ndarray:
    """Hard states from the median filtered probability across draws
    (`tayal2009/main.R:130-135`). ``alpha_draws`` is [..., T, K] with
    leading draw axes."""
    a = np.asarray(alpha_draws)
    med = np.median(a.reshape(-1, *a.shape[-2:]), axis=0)  # [T, K]
    return np.argmax(med, axis=-1)


def decode_states(
    model, samples, data: Dict, n_thin: int = 100, device: DeviceLike = None
) -> np.ndarray:
    """Posterior draws → hard bottom states over in-sample + OOS legs:
    thin the flattened draws to at most ``n_thin`` (evenly spaced), run
    ``model.generated`` on them as one batch of lanes (on the card unless
    ``device="cpu"``), classify by median filtered probability
    (`tayal2009/main.R:113-135`)."""
    flat = np.asarray(samples).reshape(-1, np.asarray(samples).shape[-1])
    sel = np.linspace(0, len(flat) - 1, min(n_thin, len(flat))).astype(int)
    gen = model.generated(torch.as_tensor(flat[sel]), data, device=device)
    return np.concatenate(
        [
            classify_hard(gen["alpha"].cpu().numpy()),
            classify_hard(gen["alpha_oos"].cpu().numpy()),
        ]
    )


@dataclass
class LabeledWindow:
    """Output of the shared labeling/trading chain."""

    leg_topstate: np.ndarray
    runs: TopRuns
    summary: Dict[str, Dict[str, float]]
    trades: Dict[int, Trades]
    bnh: np.ndarray
    swapped: bool


def label_and_trade(
    price: np.ndarray,
    zig: ZigZag,
    leg_state: np.ndarray,
    ins_end_tick: int,
    lags: Sequence[int],
    t_seconds: Optional[np.ndarray] = None,
    expansion: Optional[str] = None,
) -> LabeledWindow:
    """Bottom states → top states → ex-post bear/bull relabel → tick
    expansion → per-lag OOS trades + buy-and-hold
    (`tayal2009/main.R:157-235`); shared by the walk-forward harness and
    single-window callers.

    ``expansion`` selects the leg→tick broadcast: ``"xts"`` (requires
    ``t_seconds``) reproduces the reference's timestamp-join semantics —
    including its duplicate-timestamp look-ahead advance, which the
    published backtest tables depend on at lags 0-2 — while
    ``"positional"`` is the artifact-free containing-leg expansion (see
    :func:`hhmm_tpu_torch.apps.tayal.features.expand_to_ticks_xts`).
    Default: "xts" when ``t_seconds`` is given, else "positional"."""
    if expansion is None:
        expansion = "xts" if t_seconds is not None else "positional"
    price = np.asarray(price)
    leg_top = map_to_topstate(leg_state)
    runs = topstate_runs(leg_top, zig.start, zig.end, price)
    run_top, leg_top, swapped = relabel_by_return(runs, leg_top)
    runs = TopRuns(
        topstate=run_top, start=runs.start, end=runs.end, length=runs.length, ret=runs.ret
    )
    if expansion == "xts":
        if t_seconds is None:
            raise ValueError("expansion='xts' requires t_seconds")
        tick_top = expand_to_ticks_xts(leg_top, zig, t_seconds)
    elif expansion == "positional":
        tick_top = expand_to_ticks(leg_top, zig, len(price))
    else:
        raise ValueError("expansion must be 'xts' or 'positional'")
    oos = slice(ins_end_tick + 1, len(price))
    return LabeledWindow(
        leg_topstate=leg_top,
        runs=runs,
        summary=topstate_summary(runs),
        trades={
            lag: topstate_trading(price[oos], tick_top[oos], lag=lag) for lag in lags
        },
        bnh=buyandhold(price[oos]),
        swapped=swapped,
    )


@dataclass
class TayalWindowResult:
    zig: ZigZag
    n_ins_legs: int
    samples: np.ndarray  # [chains, draws, dim]
    stats: Dict[str, np.ndarray]
    leg_state: np.ndarray  # hard bottom states, all legs
    leg_topstate: np.ndarray  # bear/bull per leg (after ex-post relabel)
    runs: TopRuns
    summary: Dict[str, Dict[str, float]]
    trades: Dict[int, Trades]  # per lag
    bnh: np.ndarray  # buy-and-hold per-tick returns over the OOS span
    swapped: bool
