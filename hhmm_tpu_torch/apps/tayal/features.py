"""Zig-zag feature extraction — vectorized equivalent of
`tayal2009/R/feature-extraction.R:8-133`.

From tick (price, size, t_seconds) series: (1) tick directions and
change points → zig-zag legs with [start, end] tick ranges; (2) per-leg
volume-per-second ``size_av``; (3) f0 = extremum type; (4) f1 = trend
direction from the 5-extrema monotonicity pattern; (5) f2 = volume
strength from three discretized lag-ratios with threshold ``alpha``;
(6) (f0, f1, f2) → the 18-symbol alphabet (9 up-legs U1..U9, 9
down-legs D1..D9) via the lookup table of `feature-extraction.R:92-110`;
(7) coarse per-leg trend label.

Everything is NumPy-vectorized, including the (f0, f1, f2) → symbol map
the reference flags as its bottleneck (`feature-extraction.R:112` —
a linear scan per leg there; a single index computation here). This is
host-side by design: zig-zag construction is data-dependent compression
with variable output length (SURVEY.md §7.3); only the padded symbol
sequences go to device. A copy of the NumPy-only
``hhmm_tpu/apps/tayal/features.py`` whose fast path loads the port's own
native extractor (``hhmm_tpu_torch/native``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from hhmm_tpu_torch.apps.tayal.constants import (
    EXTREMA_MAX,
    EXTREMA_MIN,
    TREND_DN,
    TREND_LT,
    TREND_UP,
    VOLUME_DN,
    VOLUME_LT,
    VOLUME_UP,
)

__all__ = [
    "ZigZag",
    "extract_features",
    "to_model_inputs",
    "expand_to_ticks",
    "expand_to_ticks_xts",
]

# (f0, f1, f2) → 1..18 symbol table (`feature-extraction.R:92-110`)
_LEG_TABLE = {
    (1, 1, 1): 1, (1, -1, 1): 2, (1, 1, 0): 3,
    (1, 0, 1): 4, (1, 0, 0): 5, (1, 0, -1): 6,
    (1, -1, 0): 7, (1, 1, -1): 8, (1, -1, -1): 9,
    (-1, 1, -1): 10, (-1, -1, -1): 11, (-1, 1, 0): 12,
    (-1, 0, -1): 13, (-1, 0, 0): 14, (-1, 0, 1): 15,
    (-1, -1, 0): 16, (-1, 1, 1): 17, (-1, -1, 1): 18,
}
# dense lookup cube indexed by (f0+1, f1+1, f2+1); 0 = invalid
_LEG_CUBE = np.zeros((3, 3, 3), dtype=np.int32)
for (f0, f1, f2), sym in _LEG_TABLE.items():
    _LEG_CUBE[f0 + 1, f1 + 1, f2 + 1] = sym

# features → coarse trend label (`feature-extraction.R:127-131`)
_TREND_DN_SYMBOLS = frozenset([6, 7, 8, 9, 15, 16, 17, 18])
_TREND_LT_SYMBOLS = frozenset([5, 14])


@dataclass(frozen=True)
class ZigZag:
    """Per-leg arrays, all length n_legs. ``start``/``end`` are inclusive
    tick-index ranges; ``price`` is the leg's ending extremum price;
    ``feature`` ∈ 1..18 matches the reference's symbol encoding."""

    price: np.ndarray
    start: np.ndarray
    end: np.ndarray
    size_av: np.ndarray
    f0: np.ndarray
    f1: np.ndarray
    f2: np.ndarray
    feature: np.ndarray
    trend: np.ndarray

    def __len__(self) -> int:
        return self.price.shape[0]


def extract_features(
    price: np.ndarray,
    size: np.ndarray,
    t_seconds: np.ndarray,
    alpha: float = 0.25,
    engine: str = "auto",
) -> ZigZag:
    """``price``/``size``/``t_seconds`` are per-tick arrays (timestamps
    in seconds, any origin). ``alpha`` is the volume-ratio threshold
    (`tayal2009/main.R:24` uses 0.25).

    ``engine``: "auto" uses the native C++ extractor
    (:mod:`hhmm_tpu_torch.native.zigzag`) when its library is available and
    falls back to NumPy; "native" requires it; "numpy" forces the
    reference implementation (the oracle the native path is pinned to).
    """
    if engine not in ("auto", "native", "numpy"):
        raise ValueError("engine must be 'auto', 'native', or 'numpy'")
    if engine != "numpy":
        from hhmm_tpu_torch.native import zigzag as _nz

        if _nz.available():
            return _nz.extract_features_native(price, size, t_seconds, alpha)
        if engine == "native":
            raise RuntimeError("native zigzag library unavailable")
    price = np.asarray(price, dtype=np.float64)
    size = np.asarray(size, dtype=np.float64)
    t_seconds = np.asarray(t_seconds, dtype=np.float64)
    T = price.shape[0]
    if T < 3:
        raise ValueError("need at least 3 ticks")

    # --- zig-zag legs (`feature-extraction.R:19-36`) ---
    direction = np.zeros(T, dtype=np.int64)
    direction[1:] = np.sign(np.diff(price)).astype(np.int64)
    prev_dir = np.concatenate([[0], direction[:-1]])
    chg = (direction != 0) & (direction != prev_dir)
    chg[0] = False
    cp = np.flatnonzero(chg)  # change ticks, 0-indexed
    if cp.size < 6:
        raise ValueError("too few direction changes for zig-zag features")

    leg_price = price[cp - 1]  # ending extremum of each leg
    start = np.concatenate([[0], cp[:-1]])
    end = np.concatenate([cp[:-1] - 1, [T - 1]])

    # --- per-leg volume per second (`feature-extraction.R:38-47`) ---
    csize = np.concatenate([[0.0], np.cumsum(size)])
    leg_volume = csize[end + 1] - csize[start]
    leg_secs = t_seconds[end] - t_seconds[start] + 1.0
    size_av = leg_volume / leg_secs

    n = cp.size
    # --- f0: extremum type (`feature-extraction.R:49-51`) ---
    f0 = np.empty(n, dtype=np.int64)
    f0[1:] = np.where(leg_price[:-1] < leg_price[1:], EXTREMA_MAX, EXTREMA_MIN)
    f0[0] = EXTREMA_MIN if f0[1] == EXTREMA_MAX else EXTREMA_MAX

    # --- f1: 5-extrema trend pattern (`feature-extraction.R:53-70`) ---
    f1 = np.full(n, TREND_LT, dtype=np.int64)
    if n >= 5:
        e1, e2, e3, e4, e5 = (leg_price[i : n - 4 + i] for i in range(5))
        up = (e1 < e3) & (e3 < e5) & (e2 < e4)
        dn = (e1 > e3) & (e3 > e5) & (e2 > e4)
        f1[4:] = np.where(up, TREND_UP, np.where(dn, TREND_DN, TREND_LT))

    # --- f2: volume strength (`feature-extraction.R:72-89`) ---
    def disc(ratio):
        return np.where(ratio - 1 > alpha, 1, np.where(1 - ratio > alpha, -1, 0))

    f2 = np.full(n, VOLUME_LT, dtype=np.int64)
    if n >= 3:
        with np.errstate(divide="ignore", invalid="ignore"):
            s1 = disc(size_av[2:] / size_av[1:-1])
            s2 = disc(size_av[2:] / size_av[:-2])
            s3 = disc(size_av[1:-1] / size_av[:-2])
        f2[2:] = np.where(
            (s1 == 1) & (s2 > -1) & (s3 < 1),
            VOLUME_UP,
            np.where((s1 == -1) & (s2 < 1) & (s3 > -1), VOLUME_DN, VOLUME_LT),
        )

    # --- symbol lookup, vectorized (`feature-extraction.R:91-125`) ---
    feature = _LEG_CUBE[f0 + 1, f1 + 1, f2 + 1]
    if np.any(feature == 0):
        bad = np.flatnonzero(feature == 0)[0]
        raise ValueError(
            f"invalid leg triple (f0,f1,f2)=({f0[bad]},{f1[bad]},{f2[bad]})"
        )

    # --- coarse trend label (`feature-extraction.R:127-131`) ---
    trend = np.full(n, TREND_UP, dtype=np.int64)
    trend[np.isin(feature, list(_TREND_DN_SYMBOLS))] = TREND_DN
    trend[np.isin(feature, list(_TREND_LT_SYMBOLS))] = TREND_LT

    return ZigZag(
        price=leg_price,
        start=start,
        end=end,
        size_av=size_av,
        f0=f0,
        f1=f1,
        f2=f2,
        feature=feature.astype(np.int64),
        trend=trend,
    )


def to_model_inputs(feature: np.ndarray, L: int = 9) -> Tuple[np.ndarray, np.ndarray]:
    """Encode 1..18 symbols as model inputs ``(x ∈ 0..L-1, sign)`` with
    sign 0=up / 1=down — the reference's encoding shifted to 0-based
    (`tayal2009/main.R:83-89`: sign = 1/2, x = feature or feature−L)."""
    feature = np.asarray(feature)
    sign = np.where(feature <= L, 0, 1).astype(np.int32)
    x = np.where(feature <= L, feature - 1, feature - L - 1).astype(np.int32)
    return x, sign


def expand_to_ticks(values: np.ndarray, zig: ZigZag, T: int) -> np.ndarray:
    """Broadcast per-leg values back to tick resolution by the legs'
    positional [start, end] ranges — the *clean* reading of the
    reference's ``xts_expand`` (`feature-extraction.R:1-5`): every tick
    carries the value of the leg that contains it."""
    values = np.asarray(values)
    out = np.empty((T,) + values.shape[1:], dtype=values.dtype)
    for i in range(len(zig)):
        out[zig.start[i] : zig.end[i] + 1] = values[i]
    return out


def expand_to_ticks_xts(
    values: np.ndarray, zig: ZigZag, t_seconds: np.ndarray
) -> np.ndarray:
    """Leg→tick expansion with the reference's *actual* xts semantics
    (`feature-extraction.R:1-5`): the zig series is stamped at each
    leg's ending-extremum timestamp, left-joined onto the tick index,
    then NA-filled backward (``na.locf fromLast``) and forward.

    Two timestamp artifacts distinguish this from :func:`expand_to_ticks`
    on real tick data (~43% duplicated timestamps on the TSX series):

    - zoo's merge matches duplicate index values PAIRWISE — the k-th
      tick at timestamp T matches the k-th zig stamp at T. With unique
      stamps, only the FIRST tick of a same-timestamp burst receives the
      stamped leg's value; the rest of the burst backward-fills from the
      NEXT stamp. Regime switches are therefore ADVANCED to just after
      the first tick of the burst containing the extremum — often
      before the extremum itself. This is an unintended look-ahead leak
      in the reference, and it is what makes its published lag-0/1
      walk-forward returns (`main.pdf` Tables 5-6, 9-20) reachable:
      with the positional expansion the same decodes lose the bid-ask
      bounce on every switch (measured ~−7%/day at lag 0 on G.TO
      2007-05-08 vs published +3.99; this expansion reproduces the
      published row; see docs/results.md).
    - ticks of a new leg that still share the previous extremum's
      timestamp keep the OLD leg's value (switch delay), the mirror
      image of the same join rule.

    Use this expansion for parity with the reference's backtest tables;
    use :func:`expand_to_ticks` for artifact-free evaluation.
    """
    values = np.asarray(values)
    t = np.asarray(t_seconds)
    T = t.shape[0]
    stamps = t[np.asarray(zig.end)]
    sidx = np.searchsorted(stamps, t, side="left")
    sidx2 = np.searchsorted(stamps, t, side="right") - 1
    # occurrence rank of each tick within its same-timestamp burst
    first_of_burst = np.concatenate([[True], t[1:] != t[:-1]])
    burst_id = np.cumsum(first_of_burst) - 1
    burst_start = np.flatnonzero(first_of_burst)
    occ = np.arange(T) - burst_start[burst_id]
    match = sidx + occ  # k-th occurrence pairs with k-th stamp at t[u]
    exact = (sidx <= sidx2) & (match <= sidx2)
    # backward fill = value of the next stamped tick at-or-after u
    out_idx = np.full(T, len(values), dtype=np.int64)
    out_idx[exact] = match[exact]
    out_idx = np.minimum.accumulate(out_idx[::-1])[::-1]
    # forward-fill the tail (ticks after the last stamp keep the last leg)
    out_idx = np.minimum(out_idx, len(values) - 1)
    return values[out_idx]
