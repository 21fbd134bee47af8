"""General HMM/IOHMM diagnostic plots (parity with ``common/R/plots.R``;
counterpart of ``hhmm_tpu/viz/plots.py``, drawing the same figures).

Conventions shared by all functions:

- ``bands`` arguments are ``[3, T]`` arrays of (lower, middle, upper)
  interval values, matching the reference's 3-row matrices
  (``common/R/plots.R:16`` docs say upper/middle/lower; we accept either
  order and sort internally).
- ``z`` is an optional integer state sequence (0-based) used to color
  points by hidden state.
- Posterior-sample arguments (``alpha``, ``gamma``, ``xhat``, ``zstar``,
  ``stateprob``) are ``[N, T, K]`` (or ``[N, T]`` for paths): N posterior
  draws, T time steps, K states.

Every array argument may be a NumPy array or a tensor on any device:
:func:`_host` brings a tensor to the host (``.detach().cpu().numpy()``)
before anything is computed, so the figures are the NumPy inputs'
figures. Each function returns the matplotlib Figure.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import matplotlib.pyplot as plt

_STATE_CMAP = plt.get_cmap("tab10")


def _host(x, dtype=None) -> np.ndarray:
    """``x`` as a host array: a tensor (any device) through
    ``.detach().cpu().numpy()``, anything else through ``np.asarray``."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype=dtype)


def _state_colors(z: np.ndarray):
    return [_STATE_CMAP(int(k) % 10) for k in _host(z).astype(int)]


def _sorted_bands(bands: np.ndarray) -> np.ndarray:
    bands = _host(bands, dtype=float)
    if bands.ndim != 2 or bands.shape[0] != 3:
        raise ValueError("bands must be a [3, T] array of interval values")
    return np.sort(bands, axis=0)  # rows become (lower, middle, upper)


def _rolling_trend(x: np.ndarray, y: np.ndarray, frac: float = 0.3):
    """Cheap loess stand-in: moving average of y ordered by x
    (the reference overlays a loess fit, ``common/R/plots.R:16``)."""
    order = np.argsort(x)
    w = max(3, int(frac * x.size) | 1)
    kernel = np.ones(w) / w
    ys = np.convolve(np.pad(y[order], w // 2, mode="edge"), kernel, "valid")
    return x[order], ys[: x.size]


def plot_intervals(
    x: np.ndarray,
    bands: np.ndarray,
    z: Optional[np.ndarray] = None,
    trend: bool = True,
    ax=None,
    **scatter_kw,
):
    """Scatter of ``x`` vs interval midpoints with vertical interval bars,
    optionally colored by state and overlaid with a smooth trend
    (`common/R/plots.R:16-51`)."""
    x = _host(x, dtype=float)
    lo, mid, hi = _sorted_bands(bands)
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 4))
    else:
        fig = ax.figure
    colors = _state_colors(z) if z is not None else "C0"
    ax.vlines(x, lo, hi, color="lightgray", lw=1, zorder=1)
    ax.scatter(x, mid, c=colors, s=scatter_kw.pop("s", 14), zorder=2, **scatter_kw)
    if trend and x.size >= 5:
        xs, ys = _rolling_trend(x, mid)
        ax.plot(xs, ys, color="k", lw=1.2, alpha=0.7, zorder=3)
    ax.set_xlabel("x")
    ax.set_ylabel("interval")
    return fig


def plot_seqintervals(
    bands: np.ndarray,
    z: Optional[np.ndarray] = None,
    k: Optional[int] = None,
    ax=None,
):
    """Sequence of interval values over time; steps whose hidden state
    equals ``k`` are highlighted (`common/R/plots.R:71-99`)."""
    lo, mid, hi = _sorted_bands(bands)
    t = np.arange(mid.size)
    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 3.5))
    else:
        fig = ax.figure
    ax.fill_between(t, lo, hi, color="lightgray", alpha=0.8, label="interval")
    ax.plot(t, mid, color="C0", lw=1, label="middle")
    if z is not None:
        if k is None:
            raise ValueError("k is mandatory when z is given")
        mask = _host(z) == k
        ax.scatter(
            t[mask], mid[mask], color="C3", s=12, zorder=3, label=f"state {k}"
        )
    ax.set_xlabel("time t")
    ax.legend(loc="best", fontsize=8)
    return fig


def plot_inputoutput(
    x: np.ndarray,
    u: np.ndarray,
    z: Optional[np.ndarray] = None,
    x_label: str = "output x",
    u_labels: Optional[Sequence[str]] = None,
):
    """Output sequence, each input sequence, and the input↔output
    cross-sections colored by state (`common/R/plots.R:112-191`)."""
    x = _host(x, dtype=float)
    u = np.atleast_2d(_host(u, dtype=float))
    if u.shape[0] == x.size and u.shape[1] != x.size:
        u = u.T  # accept [T, M] or [M, T]
    M = u.shape[0]
    if u_labels is None:
        u_labels = [f"input u{m + 1}" for m in range(M)]
    t = np.arange(x.size)
    colors = _state_colors(z) if z is not None else "C0"

    fig, axes = plt.subplots(M + 1, 2, figsize=(9, 2.2 * (M + 1)), squeeze=False)
    axes[0, 0].plot(t, x, color="gray", lw=0.8)
    axes[0, 0].scatter(t, x, c=colors, s=8)
    axes[0, 0].set_ylabel(x_label)
    axes[0, 1].hist(x, bins=30, color="C0", alpha=0.8)
    axes[0, 1].set_xlabel(x_label)
    for m in range(M):
        axes[m + 1, 0].plot(t, u[m], color="gray", lw=0.8)
        axes[m + 1, 0].scatter(t, u[m], c=colors, s=8)
        axes[m + 1, 0].set_ylabel(u_labels[m])
        axes[m + 1, 1].scatter(u[m], x, c=colors, s=8)
        axes[m + 1, 1].set_xlabel(u_labels[m])
        axes[m + 1, 1].set_ylabel(x_label)
    axes[M, 0].set_xlabel("time t")
    fig.tight_layout()
    return fig


def plot_inputprob(
    u: np.ndarray,
    p_mat: np.ndarray,
    z: Optional[np.ndarray] = None,
    u_labels: Optional[Sequence[str]] = None,
):
    """Each input dimension vs each state's probability
    (`common/R/plots.R:203-238`)."""
    u = np.atleast_2d(_host(u, dtype=float))
    p_mat = _host(p_mat, dtype=float)  # [T, K]
    if u.shape[0] == p_mat.shape[0] and u.shape[1] != p_mat.shape[0]:
        u = u.T
    M, K = u.shape[0], p_mat.shape[1]
    if u_labels is None:
        u_labels = [f"u{m + 1}" for m in range(M)]
    colors = _state_colors(z) if z is not None else "C0"

    fig, axes = plt.subplots(M, K, figsize=(2.4 * K, 2.2 * M), squeeze=False)
    for m in range(M):
        for k in range(K):
            axes[m, k].scatter(u[m], p_mat[:, k], c=colors, s=7)
            axes[m, k].set_ylim(-0.05, 1.05)
            if m == M - 1:
                axes[m, k].set_xlabel(f"{u_labels[m]} → p(z={k})", fontsize=8)
            if k == 0:
                axes[m, k].set_ylabel(u_labels[m])
    fig.tight_layout()
    return fig


def _draw_quantile_seq(ax, samples: np.ndarray, interval: float, k: int):
    """samples: [N, T] of probabilities for one state."""
    lo_q = (1 - interval) / 2
    lo, mid, hi = np.quantile(samples, [lo_q, 0.5, 1 - lo_q], axis=0)
    t = np.arange(mid.size)
    color = _STATE_CMAP(k % 10)
    ax.fill_between(t, lo, hi, color=color, alpha=0.25)
    ax.plot(t, mid, color=color, lw=1, label=f"state {k}")


def plot_stateprobability(
    alpha: np.ndarray,
    gamma: np.ndarray,
    interval: float = 0.8,
    z: Optional[np.ndarray] = None,
):
    """Filtered (``alpha``) and smoothed (``gamma``) state-probability
    sequences with posterior quantile bands, plus the filtered-vs-smoothed
    cross-section (`common/R/plots.R:254-321`). ``alpha``/``gamma`` are
    ``[N, T, K]`` posterior draws of the probabilities."""
    alpha = _host(alpha, dtype=float)
    gamma = _host(gamma, dtype=float)
    K = alpha.shape[2]
    fig, axes = plt.subplots(3, 1, figsize=(8, 7), height_ratios=[1, 1, 1.2])
    for k in range(K):
        _draw_quantile_seq(axes[0], alpha[:, :, k], interval, k)
        _draw_quantile_seq(axes[1], gamma[:, :, k], interval, k)
        axes[2].scatter(
            np.median(alpha[:, :, k], axis=0),
            np.median(gamma[:, :, k], axis=0),
            color=_STATE_CMAP(k % 10),
            s=8,
            label=f"state {k}",
        )
    if z is not None:
        t = np.arange(alpha.shape[1])
        for axi in axes[:2]:
            # true-state rug along the top edge
            axi.scatter(t, np.full(t.size, 1.02), c=_state_colors(z), s=4,
                        marker="s", clip_on=False)
    axes[0].set_ylabel("filtered p(z_t | x_1:t)")
    axes[1].set_ylabel("smoothed p(z_t | x_1:T)")
    axes[1].set_xlabel("time t")
    axes[2].plot([0, 1], [0, 1], color="gray", lw=0.8, ls="--")
    axes[2].set_xlabel("filtered (median)")
    axes[2].set_ylabel("smoothed (median)")
    axes[2].legend(fontsize=8)
    fig.tight_layout()
    return fig


def plot_statepath(zstar: np.ndarray, z: Optional[np.ndarray] = None):
    """Posterior mode of the jointly-most-probable path with per-step
    agreement shading, vs the true path when given
    (`common/R/plots.R:323-381`). ``zstar`` is ``[N, T]`` sampled paths
    (one Viterbi path per posterior draw)."""
    zstar = np.atleast_2d(_host(zstar, dtype=int))
    N, T = zstar.shape
    K = int(zstar.max()) + 1
    counts = np.stack([(zstar == k).sum(0) for k in range(K)])  # [K, T]
    mode = counts.argmax(0)
    agree = counts.max(0) / N
    t = np.arange(T)

    fig, axes = plt.subplots(2, 1, figsize=(8, 4.5), height_ratios=[2, 1], sharex=True)
    axes[0].step(t, mode, where="mid", color="C0", lw=1.2, label="MAP path (mode)")
    if z is not None:
        axes[0].step(t, _host(z), where="mid", color="k", lw=0.8, ls="--", label="true z")
    axes[0].set_yticks(np.arange(K))
    axes[0].set_ylabel("state")
    axes[0].legend(fontsize=8)
    axes[1].fill_between(t, 0, agree, color="C2", alpha=0.6)
    axes[1].set_ylim(0, 1.02)
    axes[1].set_ylabel("path agreement")
    axes[1].set_xlabel("time t")
    fig.tight_layout()
    return fig


def plot_outputfit(
    x: np.ndarray,
    xhat: np.ndarray,
    interval: float = 0.8,
    z: Optional[np.ndarray] = None,
):
    """Observed series with posterior-predictive fitted outputs (median
    dots colored by state + quantile band) (`common/R/plots.R:383-431`).
    ``xhat`` is ``[N, T]`` posterior-predictive draws."""
    x = _host(x, dtype=float)
    xhat = np.atleast_2d(_host(xhat, dtype=float))
    lo_q = (1 - interval) / 2
    lo, mid, hi = np.quantile(xhat, [lo_q, 0.5, 1 - lo_q], axis=0)
    t = np.arange(x.size)
    colors = _state_colors(z) if z is not None else "C1"

    fig, ax = plt.subplots(figsize=(8, 3.5))
    ax.plot(t, x, color="lightgray", lw=1.2, label="observed")
    ax.fill_between(t, lo, hi, color="C1", alpha=0.2, label=f"{int(interval * 100)}% interval")
    ax.scatter(t, mid, c=colors, s=10, zorder=3, label="fit (median)")
    ax.set_xlabel("time t")
    ax.set_ylabel("output x")
    ax.legend(fontsize=8)
    fig.tight_layout()
    return fig


def plot_inputoutputprob(
    x: np.ndarray,
    u: np.ndarray,
    stateprob: np.ndarray,
    zstar: np.ndarray,
    x_label: str = "output x",
    u_labels: Optional[Sequence[str]] = None,
    stateprob_label: str = "p(z_t)",
):
    """Stacked panels: output, inputs, state-probability band per state,
    and the most probable path — the single-figure overview of observed
    variables vs estimated hidden states (`common/R/plots.R:433-541`).
    ``stateprob`` is ``[N, T, K]``; ``zstar`` is ``[N, T]``."""
    x = _host(x, dtype=float)
    u = np.atleast_2d(_host(u, dtype=float))
    stateprob = _host(stateprob, dtype=float)
    if stateprob.ndim != 3:
        raise ValueError("stateprob must be [N, T, K]")
    T = stateprob.shape[1]
    if x.size != T or (u.shape[1] != T and u.shape[0] == T):
        u = u.T
    if x.size != T or u.shape[1] != T:
        raise ValueError(
            "state probability must have the same length as the input and "
            "output series"
        )
    M, K = u.shape[0], stateprob.shape[2]
    if u_labels is None:
        u_labels = [f"u{m + 1}" for m in range(M)]
    t = np.arange(T)

    fig, axes = plt.subplots(
        M + 3, 1, figsize=(8, 1.6 * (M + 3)), sharex=True
    )
    axes[0].plot(t, x, color="C0", lw=0.9)
    axes[0].set_ylabel(x_label, fontsize=8)
    for m in range(M):
        axes[1 + m].plot(t, u[m], color="gray", lw=0.9)
        axes[1 + m].set_ylabel(u_labels[m], fontsize=8)
    for k in range(K):
        _draw_quantile_seq(axes[M + 1], stateprob[:, :, k], 0.8, k)
    axes[M + 1].set_ylabel(stateprob_label, fontsize=8)
    axes[M + 1].legend(fontsize=7, ncol=min(K, 4))
    zs = np.atleast_2d(_host(zstar, dtype=int))
    counts = np.stack([(zs == k).sum(0) for k in range(K)])
    axes[M + 2].step(t, counts.argmax(0), where="mid", color="C0", lw=1)
    axes[M + 2].set_yticks(np.arange(K))
    axes[M + 2].set_ylabel("ẑ*", fontsize=8)
    axes[M + 2].set_xlabel("time t")
    fig.tight_layout()
    return fig


def plot_seqforecast(
    y: np.ndarray,
    yhat_bands: np.ndarray,
    title: Optional[str] = None,
    ax=None,
):
    """Observed series continued by forecast intervals
    (`common/R/plots.R:543-566`). ``yhat_bands`` is ``[3, H]`` forecast
    (lower, point, upper) for the H steps after the end of ``y``."""
    y = _host(y, dtype=float)
    lo, mid, hi = _sorted_bands(yhat_bands)
    t = np.arange(y.size)
    th = y.size - 1 + np.arange(1, mid.size + 1)
    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 3.5))
    else:
        fig = ax.figure
    ax.plot(t, y, color="C0", lw=1, label="observed")
    ax.fill_between(th, lo, hi, color="C3", alpha=0.25, label="forecast interval")
    ax.plot(th, mid, color="C3", lw=1.2, marker="o", ms=3, label="forecast")
    ax.axvline(y.size - 1, color="gray", lw=0.8, ls=":")
    if title:
        ax.set_title(title)
    ax.set_xlabel("time t")
    ax.legend(fontsize=8)
    return fig
