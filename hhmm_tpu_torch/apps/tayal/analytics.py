"""Top-state analytics — `tayal2009/R/state-plots.R:1-21` and the
top-state run construction of `tayal2009/main.R:157-184` (a copy of the
NumPy-only ``hhmm_tpu/apps/tayal/analytics.py``; its
``online_flip_detector`` needs the serving plane's ``RegimeDetector``,
which the port does not have yet)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np

from hhmm_tpu_torch.apps.tayal.constants import STATE_BEAR, STATE_BULL

__all__ = [
    "TopRuns",
    "topstate_runs",
    "relabel_by_return",
    "topstate_summary",
    "map_to_topstate",
    "topstate_probs",
]


def map_to_topstate(state: np.ndarray, pairs=((0, 1), (2, 3))) -> np.ndarray:
    """Bottom states → top states (`tayal2009/main.R:157-163`): default
    pairing {0,1}→bear, {2,3}→bull (the reference's 1-indexed {1,2} /
    {3,4})."""
    state = np.asarray(state)
    out = np.full(state.shape, np.iinfo(np.int64).min, dtype=np.int64)
    codes = (STATE_BEAR, STATE_BULL)
    if len(pairs) != len(codes):
        raise ValueError(f"need exactly {len(codes)} state pairs, got {len(pairs)}")
    for code, pair in zip(codes, pairs):
        out[np.isin(state, pair)] = code
    unmapped = ~np.isin(state, np.concatenate([np.asarray(p) for p in pairs]))
    if np.any(unmapped):
        raise ValueError(
            f"states {sorted(set(state[unmapped].tolist()))} not covered by pairs {pairs}"
        )
    return out


def topstate_probs(
    probs: np.ndarray, pairs=((0, 1), (2, 3)), dmax: int = 1
) -> np.ndarray:
    """Filtered bottom-state probabilities [..., K] → top-state
    (bear, bull) probabilities [..., 2].

    The probability-space counterpart of :func:`map_to_topstate` (same
    default pairing {0,1}→bear, {2,3}→bull): each top state owns the
    summed mass of its production-state pair. Output order is (bear,
    bull), matching the ``(STATE_BEAR, STATE_BULL)`` code order. Feed
    the per-tick draw-averaged ``TickResponse.probs`` of the serving
    scheduler into this, then into an online flip detector.

    ``dmax``: duration-expansion factor for explicit-duration serving
    (`models/hsmm.py`): ``TickResponse.probs`` is then ``[..., K*dmax]``
    on the count-down expansion and is collapsed to regime space
    (a reshape and a sum over the duration axis) before pairing — pairing
    expanded lanes directly would sum the WRONG mass silently. The
    pair indices are validated against the collapsed width, so an
    un-collapsed expanded vector fails loud, not quiet."""
    p = np.asarray(probs)
    if dmax > 1:
        p = p.reshape(p.shape[:-1] + (p.shape[-1] // dmax, dmax)).sum(axis=-1)
    width = p.shape[-1]
    flat = [i for pair in pairs for i in pair]
    if flat and max(flat) >= width:
        raise ValueError(
            f"pairs {pairs} index past the regime width {width} — "
            "expanded-state probs need the matching dmax "
            "(models/hsmm.py: dmax = Dmax)"
        )
    return np.stack([p[..., list(pair)].sum(axis=-1) for pair in pairs], axis=-1)


@dataclass(frozen=True)
class TopRuns:
    """Consecutive same-top-state runs over the zig-zag sequence, with
    tick-level spans and per-run price returns
    (`tayal2009/main.R:165-174`)."""

    topstate: np.ndarray  # per run
    start: np.ndarray  # tick index
    end: np.ndarray  # tick index
    length: np.ndarray  # end - start (ticks)
    ret: np.ndarray  # (p[end] - p[start]) / p[start]

    def __len__(self) -> int:
        return self.topstate.shape[0]


def topstate_runs(
    leg_topstate: np.ndarray,
    leg_start: np.ndarray,
    leg_end: np.ndarray,
    price: np.ndarray,
) -> TopRuns:
    leg_topstate = np.asarray(leg_topstate)
    chg = np.concatenate([[True], leg_topstate[1:] != leg_topstate[:-1]])
    idx = np.flatnonzero(chg)
    start = np.asarray(leg_start)[idx]
    end = np.concatenate([np.asarray(leg_start)[idx[1:]] - 1, [np.asarray(leg_end)[-1]]])
    ret = (price[end] - price[start]) / price[start]
    return TopRuns(
        topstate=leg_topstate[idx],
        start=start,
        end=end,
        length=end - start,
        ret=ret,
    )


def relabel_by_return(runs: TopRuns, leg_topstate: np.ndarray):
    """Ex-post bear/bull identification (`tayal2009/main.R:176-184`): if
    mean bear-run return exceeds mean bull-run return, swap the labels.
    Returns (possibly swapped) (runs_topstate, leg_topstate, swapped)."""
    r = np.asarray(runs.topstate)
    lt = np.asarray(leg_topstate)
    bear_mean = runs.ret[r == STATE_BEAR].mean() if np.any(r == STATE_BEAR) else -np.inf
    bull_mean = runs.ret[r == STATE_BULL].mean() if np.any(r == STATE_BULL) else np.inf
    if bear_mean > bull_mean:
        swap = {STATE_BEAR: STATE_BULL, STATE_BULL: STATE_BEAR}
        r = np.vectorize(swap.get)(r)
        lt = np.vectorize(swap.get)(lt)
        return r, lt, True
    return r, lt, False


def _stats(ret_pct: np.ndarray, length: np.ndarray) -> Dict[str, float]:
    x = np.asarray(ret_pct, dtype=np.float64)
    m = x.mean()
    s = x.std(ddof=1) if x.size > 1 else np.nan
    cz = (x - m) / s if x.size > 1 and s > 0 else np.zeros_like(x)
    return {
        "ret_mean": m,
        "ret_stdev": s,
        "ret_skewness": float((cz**3).mean()),
        "ret_kurtosis": float((cz**4).mean()),
        "ret_q25": float(np.quantile(x, 0.25)),
        "ret_q50": float(np.quantile(x, 0.50)),
        "ret_q75": float(np.quantile(x, 0.75)),
        "len_mean": float(np.mean(length)),
        "len_median": float(np.median(length)),
    }


def topstate_summary(runs: TopRuns, labels=("Bear", "Bull")) -> Dict[str, Dict[str, float]]:
    """Per-regime + unconditional run statistics in percent
    (`state-plots.R:1-21`; skew/kurt as in the R ``moments`` package:
    biased central-moment ratios, kurtosis NOT excess)."""
    out: Dict[str, Dict[str, float]] = {}
    codes = (STATE_BEAR, STATE_BULL)
    for label, code in zip(labels, codes):
        ind = runs.topstate == code
        if np.any(ind):
            out[label] = _stats(100 * runs.ret[ind], runs.length[ind])
    out["Unconditional"] = _stats(100 * runs.ret, runs.length)
    return out
