"""Tayal (2009) regime/trading plots (parity with
``tayal2009/R/state-plots.R``; counterpart of
``hhmm_tpu/viz/state_plots.py``): features over price, per-regime
feature histograms, regime-colored price sequences, and equity lines.

Inputs are the port's own data structures
(:class:`~hhmm_tpu_torch.apps.tayal.features.ZigZag`,
:class:`~hhmm_tpu_torch.apps.tayal.trading.Trades`) plus per-tick
arrays or tensors (brought to the host by ``plots._host``); every
function returns the matplotlib Figure.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

import matplotlib.collections
import matplotlib.pyplot as plt

from hhmm_tpu_torch.apps.tayal.constants import STATE_BEAR, STATE_BULL
from hhmm_tpu_torch.apps.tayal.trading import Trades, buyandhold, equity_curve
from hhmm_tpu_torch.viz.plots import _host

_BEAR_COLOR = "#c0392b"
_BULL_COLOR = "#27ae60"


def _topstate_color(topstate: np.ndarray):
    return np.where(_host(topstate) == STATE_BEAR, _BEAR_COLOR, _BULL_COLOR)


def _leg_segments(ax, price: np.ndarray, zig, leg_color, lw=1.0):
    """Draw the zig-zag polyline in per-leg colors as ONE artist — a
    Tayal day has thousands of legs, so per-leg ``ax.plot`` calls would
    dominate render time."""
    s, e = _host(zig.start), _host(zig.end)
    segments = np.stack(
        [np.stack([s, price[s]], axis=1), np.stack([e, price[e]], axis=1)], axis=1
    )
    ax.add_collection(
        matplotlib.collections.LineCollection(segments, colors=list(leg_color), lw=lw)
    )
    ax.autoscale_view()


def plot_features(
    price: np.ndarray,
    zig,
    which: str = "all",
):
    """Price with zig-zag extrema/trend/volume features plus per-leg
    volume-per-second bars (`state-plots.R:23-193`). ``which`` ∈
    {'actual', 'extrema', 'trend', 'all'}."""
    price = _host(price, dtype=float)
    t = np.arange(price.size)
    fig, axes = plt.subplots(
        2, 1, figsize=(9, 5.5), height_ratios=[3, 1], sharex=True
    )
    ax, axv = axes
    ax.plot(t, price, color="lightgray", lw=0.7, label="tick price")

    if which in ("extrema", "all"):
        ax.scatter(
            zig.end,
            price[zig.end],
            c=np.where(zig.f0 > 0, _BULL_COLOR, _BEAR_COLOR),
            s=14,
            zorder=3,
            label="extrema (max/min)",
        )
    if which in ("trend", "all"):
        trend_color = np.where(
            zig.f1 > 0, _BULL_COLOR, np.where(zig.f1 < 0, _BEAR_COLOR, "#7f8c8d")
        )
        _leg_segments(ax, price, zig, trend_color)
    if which == "actual":
        _leg_segments(ax, price, zig, ["C0"] * len(zig))
    ax.set_ylabel("price")
    ax.legend(fontsize=8, loc="best")

    vol_color = np.where(
        zig.f2 > 0, _BULL_COLOR, np.where(zig.f2 < 0, _BEAR_COLOR, "#7f8c8d")
    )
    axv.bar(
        (_host(zig.start) + _host(zig.end)) / 2,
        zig.size_av,
        width=np.maximum(_host(zig.end) - _host(zig.start), 1),
        color=vol_color,
        align="center",
    )
    axv.set_ylabel("vol/sec")
    axv.set_xlabel("tick")
    fig.tight_layout()
    return fig


def plot_topstate_hist(
    x: np.ndarray,
    topstate: np.ndarray,
    labels: Sequence[str] = ("Bear", "Bull"),
    bins: int = 30,
    x_label: str = "return (%)",
):
    """Side-by-side histograms of ``x`` conditioned on top state, on
    common axes (`state-plots.R:195-233`)."""
    x = _host(x, dtype=float)
    topstate = _host(topstate)
    codes = (STATE_BEAR, STATE_BULL)
    edges = np.histogram_bin_edges(x, bins=bins)
    counts = [np.histogram(x[topstate == c], bins=edges)[0] for c in codes]
    ymax = max(c.max() for c in counts) if counts else 1

    fig, axes = plt.subplots(1, 2, figsize=(8, 3), sharey=True)
    for axi, c, cnt, label, color in zip(
        axes, codes, counts, labels, (_BEAR_COLOR, _BULL_COLOR)
    ):
        axi.stairs(cnt, edges, fill=True, color=color, alpha=0.7)
        axi.set_title(label, fontsize=9)
        axi.set_xlabel(x_label)
        axi.set_ylim(0, ymax * 1.05)
    axes[0].set_ylabel("count")
    fig.tight_layout()
    return fig


def plot_topstate_seq(
    price: np.ndarray,
    topstate: np.ndarray,
    title: Optional[str] = None,
):
    """Tick price colored by per-tick top state
    (`state-plots.R:235-276`)."""
    price = _host(price, dtype=float)
    topstate = _host(topstate)
    t = np.arange(price.size)
    fig, ax = plt.subplots(figsize=(9, 3.5))
    for code, color, label in (
        (STATE_BEAR, _BEAR_COLOR, "bear"),
        (STATE_BULL, _BULL_COLOR, "bull"),
    ):
        m = topstate == code
        ax.scatter(t[m], price[m], color=color, s=2, label=label)
    ax.set_xlabel("tick")
    ax.set_ylabel("price")
    if title:
        ax.set_title(title)
    ax.legend(fontsize=8, markerscale=4)
    fig.tight_layout()
    return fig


def plot_topstate_seqv(
    price: np.ndarray,
    zig,
    leg_topstate: np.ndarray,
    title: Optional[str] = None,
):
    """Zig-zag legs colored by leg top state over the gray tick series,
    with the per-leg volume panel (`state-plots.R:278-354`)."""
    price = _host(price, dtype=float)
    t = np.arange(price.size)
    fig, axes = plt.subplots(
        2, 1, figsize=(9, 5.5), height_ratios=[3, 1], sharex=True
    )
    ax, axv = axes
    ax.plot(t, price, color="lightgray", lw=0.6)
    colors = _topstate_color(leg_topstate)
    _leg_segments(ax, price, zig, colors, lw=1.4)
    ax.set_ylabel("price")
    if title:
        ax.set_title(title)
    axv.bar(
        (_host(zig.start) + _host(zig.end)) / 2,
        zig.size_av,
        width=np.maximum(_host(zig.end) - _host(zig.start), 1),
        color=colors,
        align="center",
    )
    axv.set_ylabel("vol/sec")
    axv.set_xlabel("tick")
    fig.tight_layout()
    return fig


def plot_topstate_features(
    feature: np.ndarray,
    leg_topstate: np.ndarray,
    L: int = 18,
    labels: Sequence[str] = ("Bear", "Bull"),
):
    """Per-top-state frequency of the L-symbol feature alphabet
    (`state-plots.R:356-387`) — one grouped bar chart."""
    feature = _host(feature, dtype=int)
    leg_topstate = _host(leg_topstate)
    codes = (STATE_BEAR, STATE_BULL)
    tab = np.stack(
        [np.bincount(feature[leg_topstate == c] - 1, minlength=L) for c in codes]
    ).astype(float)
    tab /= np.maximum(tab.sum(axis=1, keepdims=True), 1)

    xpos = np.arange(L)
    fig, ax = plt.subplots(figsize=(9, 3))
    w = 0.4
    ax.bar(xpos - w / 2, tab[0], width=w, color=_BEAR_COLOR, label=labels[0])
    ax.bar(xpos + w / 2, tab[1], width=w, color=_BULL_COLOR, label=labels[1])
    ax.set_xticks(xpos)
    ax.set_xticklabels(
        [f"U{i + 1}" for i in range(L // 2)] + [f"D{i + 1}" for i in range(L - L // 2)],
        fontsize=7,
    )
    ax.set_xlabel("feature symbol")
    ax.set_ylabel("relative frequency")
    ax.legend(fontsize=8)
    fig.tight_layout()
    return fig


def plot_topstate_trading(
    price: np.ndarray,
    topstate: np.ndarray,
    trades: Dict[str, Trades],
    title: Optional[str] = None,
):
    """Regime-colored price on top; equity lines for each strategy vs
    buy-and-hold below (`state-plots.R:389-512`). ``trades`` maps
    strategy label → :class:`Trades`."""
    price = _host(price, dtype=float)
    t = np.arange(price.size)
    fig, axes = plt.subplots(
        2, 1, figsize=(9, 6), height_ratios=[1.2, 1], sharex=False
    )
    ax, axe = axes
    ax.scatter(t, price, c=_topstate_color(topstate), s=1.5)
    ax.set_ylabel("price")
    if title:
        ax.set_title(title)

    bh = equity_curve(buyandhold(price))
    axe.plot(np.arange(1, price.size), bh, color="gray", lw=1, label="buy & hold")
    for i, (label, tr) in enumerate(trades.items()):
        eq = equity_curve(tr.ret)
        axe.step(tr.end, eq, where="post", lw=1.1, color=f"C{i}", label=label)
    axe.set_xlabel("tick")
    axe.set_ylabel("equity (×)")
    axe.legend(fontsize=8)
    fig.tight_layout()
    return fig
