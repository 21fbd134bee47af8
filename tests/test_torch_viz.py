"""The port's plot library (``hhmm_tpu_torch.viz``) against the JAX
package's (``hhmm_tpu.viz``): each of the 15 plot functions, given the
same NumPy inputs (made from a seed), draws the same figure — the same
number of axes, the same titles, labels, limits and legend texts, and
every line's, collection's, patch's and image's data equal exactly — and
tensor inputs draw the figure the NumPy inputs draw.
"""

from __future__ import annotations

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from hhmm_tpu import viz as jviz  # noqa: E402
from hhmm_tpu.apps.tayal import features as jfeatures  # noqa: E402
from hhmm_tpu.apps.tayal import trading as jtrading  # noqa: E402
from hhmm_tpu_torch import viz as tviz  # noqa: E402
from hhmm_tpu_torch.apps.tayal import features as tfeatures  # noqa: E402
from hhmm_tpu_torch.apps.tayal import trading as ttrading  # noqa: E402


def _arr(a):
    return np.asarray(a) if a is not None else None


def _collection(c):
    out = {"type": type(c).__name__, "offsets": _arr(c.get_offsets())}
    out["paths"] = [p.vertices.copy() for p in c.get_paths()]
    out["facecolors"] = _arr(c.get_facecolor())
    out["edgecolors"] = _arr(c.get_edgecolor())
    out["sizes"] = _arr(c.get_sizes()) if hasattr(c, "get_sizes") else None
    if hasattr(c, "get_segments"):
        out["segments"] = [np.asarray(s) for s in c.get_segments()]
    if hasattr(c, "get_array") and c.get_array() is not None:
        out["array"] = _arr(c.get_array())
    return out


def _patch(p):
    return {"type": type(p).__name__, "path": p.get_path().vertices.copy(),
            "transform": p.get_patch_transform().get_matrix().copy(),
            "facecolor": _arr(p.get_facecolor())}


def figure_data(fig):
    """Everything a plot function decides: per axes its texts and limits
    and the data of every artist."""
    axes = []
    for ax in fig.axes:
        leg = ax.get_legend()
        axes.append({
            "title": ax.get_title(),
            "xlabel": ax.get_xlabel(),
            "ylabel": ax.get_ylabel(),
            "xlim": ax.get_xlim(),
            "ylim": ax.get_ylim(),
            "xticks": _arr(ax.get_xticks()),
            "yticks": _arr(ax.get_yticks()),
            "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
            "legend": [t.get_text() for t in leg.get_texts()] if leg else None,
            "lines": [(_arr(ln.get_xdata()), _arr(ln.get_ydata()), ln.get_color(),
                       ln.get_linestyle(), ln.get_label()) for ln in ax.get_lines()],
            "collections": [_collection(c) for c in ax.collections],
            "patches": [_patch(p) for p in ax.patches],
            "texts": [t.get_text() for t in ax.texts],
        })
    return {"n_axes": len(fig.axes), "suptitle": fig._suptitle.get_text() if fig._suptitle else None,
            "axes": axes}


def assert_same(a, b, path="fig"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), f"{path}: {len(a)} vs {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, f"{path}: shape {a.shape} vs {b.shape}"
        if a.dtype.kind in "fc" or b.dtype.kind in "fc":
            assert np.array_equal(a, b, equal_nan=True), f"{path} differs"
        else:
            assert np.array_equal(a, b), f"{path} differs"
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


def _zig(mod, rng, n_legs, T):
    """A ZigZag of either package from the same arrays."""
    cuts = np.sort(rng.choice(np.arange(1, T - 1), size=n_legs - 1, replace=False))
    start = np.concatenate([[0], cuts])
    end = np.concatenate([cuts, [T - 1]])
    f0 = rng.choice([-1, 1], size=n_legs)
    f1 = rng.choice([-1, 0, 1], size=n_legs)
    f2 = rng.choice([-1, 0, 1], size=n_legs)
    return mod.ZigZag(
        price=rng.normal(size=n_legs), start=start, end=end,
        size_av=rng.gamma(2.0, size=n_legs), f0=f0, f1=f1, f2=f2,
        feature=rng.integers(1, 19, size=n_legs), trend=f1.copy(),
    )


def make_inputs(seed=0):
    rng = np.random.default_rng(seed)
    N, T, K, M = 6, 40, 3, 2
    z = rng.integers(0, K, size=T)
    p = rng.dirichlet(np.ones(K), size=(N, T))
    price = 100 + np.cumsum(rng.normal(size=120)) * 0.1
    topstate = rng.choice([-1, 1], size=120)
    return {
        "x": rng.normal(size=T),
        "bands": rng.normal(size=(3, T)),
        "z": z,
        "u": rng.normal(size=(T, M)),
        "p_mat": p[0],
        "alpha": p,
        "gamma": rng.dirichlet(np.ones(K), size=(N, T)),
        "zstar": rng.integers(0, K, size=(N, T)),
        "xhat": rng.normal(size=(N, T)),
        "y": rng.normal(size=30),
        "yhat_bands": rng.normal(size=(3, 8)),
        "price": price,
        "topstate": topstate,
        "ret": rng.normal(size=200),
        "ret_top": rng.choice([-1, 1], size=200),
        "n_legs": 15,
        "leg_topstate": rng.choice([-1, 1], size=15),
        "zig_seed": seed + 1,
    }


def calls(viz, features, trading, inp, conv=lambda a: a):
    """(name, thunk) for each of the 15 plot functions; ``conv`` maps the
    array inputs (identity for NumPy, ``torch.as_tensor`` for tensors)."""
    c = conv
    zig = _zig(features, np.random.default_rng(inp["zig_seed"]), inp["n_legs"], len(inp["price"]))
    trades = {"lag 1": trading.topstate_trading(inp["price"], inp["topstate"], lag=1),
              "lag 2": trading.topstate_trading(inp["price"], inp["topstate"], lag=2)}
    return {
        "plot_intervals": lambda: viz.plot_intervals(c(inp["x"]), c(inp["bands"]), z=c(inp["z"])),
        "plot_seqintervals": lambda: viz.plot_seqintervals(c(inp["bands"]), z=c(inp["z"]), k=1),
        "plot_inputoutput": lambda: viz.plot_inputoutput(c(inp["x"]), c(inp["u"]), z=c(inp["z"])),
        "plot_inputprob": lambda: viz.plot_inputprob(c(inp["u"]), c(inp["p_mat"]), z=c(inp["z"])),
        "plot_stateprobability": lambda: viz.plot_stateprobability(
            c(inp["alpha"]), c(inp["gamma"]), z=c(inp["z"])),
        "plot_statepath": lambda: viz.plot_statepath(c(inp["zstar"]), z=c(inp["z"])),
        "plot_outputfit": lambda: viz.plot_outputfit(c(inp["x"]), c(inp["xhat"]), z=c(inp["z"])),
        "plot_inputoutputprob": lambda: viz.plot_inputoutputprob(
            c(inp["x"]), c(inp["u"]), c(inp["alpha"]), c(inp["zstar"])),
        "plot_seqforecast": lambda: viz.plot_seqforecast(c(inp["y"]), c(inp["yhat_bands"]),
                                                         title="forecast"),
        "plot_features": lambda: viz.plot_features(c(inp["price"]), zig, which="all"),
        "plot_topstate_hist": lambda: viz.plot_topstate_hist(c(inp["ret"]), c(inp["ret_top"])),
        "plot_topstate_seq": lambda: viz.plot_topstate_seq(c(inp["price"]), c(inp["topstate"]),
                                                           title="seq"),
        "plot_topstate_seqv": lambda: viz.plot_topstate_seqv(
            c(inp["price"]), zig, c(inp["leg_topstate"]), title="seqv"),
        "plot_topstate_features": lambda: viz.plot_topstate_features(
            c(zig.feature), c(inp["leg_topstate"])),
        "plot_topstate_trading": lambda: viz.plot_topstate_trading(
            c(inp["price"]), c(inp["topstate"]), trades, title="trading"),
    }


NAMES = sorted(calls(tviz, tfeatures, ttrading, make_inputs()))


def test_all_fifteen_functions_exported():
    assert len(NAMES) == 15
    assert sorted(tviz.__all__) == sorted(jviz.__all__) == NAMES


def _draw(thunk):
    fig = thunk()
    try:
        return figure_data(fig)
    finally:
        plt.close(fig)


@pytest.mark.parametrize("name", NAMES)
def test_same_figure_as_the_jax_viz(name):
    inp = make_inputs(3)
    want = _draw(calls(jviz, jfeatures, jtrading, inp)[name])
    got = _draw(calls(tviz, tfeatures, ttrading, inp)[name])
    assert got["n_axes"] == want["n_axes"] >= 1
    assert_same(got, want, name)


@pytest.mark.parametrize("name", NAMES)
def test_tensor_inputs_draw_the_numpy_figure(name):
    inp = make_inputs(5)
    want = _draw(calls(tviz, tfeatures, ttrading, inp)[name])
    got = _draw(calls(tviz, tfeatures, ttrading, inp, conv=torch.as_tensor)[name])
    assert_same(got, want, name)


def test_host_adapter():
    from hhmm_tpu_torch.viz.plots import _host

    t = torch.arange(6, dtype=torch.float32, requires_grad=True).reshape(2, 3)
    out = _host(t, dtype=float)
    assert isinstance(out, np.ndarray) and out.dtype == np.float64
    assert np.array_equal(out, np.arange(6.0).reshape(2, 3))
    assert _host([1, 2]).tolist() == [1, 2]
