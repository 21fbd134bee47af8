"""Single-window Tayal pipeline (counterpart of
``hhmm_tpu/apps/tayal/pipeline.py``): features → a NUTS fit
(:func:`run_window`) → posterior draws → hard bottom states by median
filtered probability (on the card) → top-state mapping → ex-post
bear/bull labeling → trading. The walk-forward harness
(``apps/tayal/wf.py``) fits many windows at once through
``fit_batched`` and shares the labeling and trading chain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.apps.tayal.analytics import (
    TopRuns,
    map_to_topstate,
    relabel_by_return,
    topstate_runs,
    topstate_summary,
)
from hhmm_tpu_torch.apps.tayal.features import (
    ZigZag,
    expand_to_ticks,
    expand_to_ticks_xts,
    extract_features,
    to_model_inputs,
)
from hhmm_tpu_torch.apps.tayal.trading import Trades, buyandhold, topstate_trading
from hhmm_tpu_torch.batch.fit import derive_seed
from hhmm_tpu_torch.infer import SamplerConfig, init_chains, sample
from hhmm_tpu_torch.models import TayalHHMMLite

__all__ = [
    "TayalWindowResult",
    "classify_hard",
    "decode_states",
    "label_and_trade",
    "LabeledWindow",
    "run_window",
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


def run_window(
    price: np.ndarray,
    size: np.ndarray,
    t_seconds: np.ndarray,
    ins_end_tick: int,
    alpha: float = 0.25,
    config=SamplerConfig(num_warmup=250, num_samples=250, num_chains=1),
    seed: int = 0,
    gate_mode: str = "stan",
    lags: Sequence[int] = (0, 1, 2, 3, 4, 5),
    device: DeviceLike = None,
) -> TayalWindowResult:
    """Fit on the legs ending at or before ``ins_end_tick``, filter the
    rest out of sample, trade the out-of-sample span
    (`tayal2009/main.R:62-235`).

    The fit runs :func:`~hhmm_tpu_torch.infer.sample` (NUTS for a
    ``SamplerConfig``, ChEES for a ``ChEESConfig``) with
    ``model.make_vg`` as the hot loop (the ``FWD`` + ``VG_BWD`` pair on
    the card; it takes precedence over ``make_logp``, whose
    time-varying stan-gate ``log_A`` would run the plain scans), chains
    started by :func:`~hhmm_tpu_torch.infer.init_chains`. The JAX
    signature's ``key`` is ``seed`` here (the inits take
    ``derive_seed(seed, 1)``, as the JAX ``fold_in(key, 1)``);
    ``device=None`` is the CUDA card."""
    device = resolve_device(device)
    zig = extract_features(price, size, t_seconds, alpha=alpha)
    x, sign = to_model_inputs(zig.feature)
    ins = zig.end <= ins_end_tick
    n_ins = int(ins.sum())
    if n_ins < 10 or n_ins == len(zig):
        raise ValueError(f"degenerate in-sample split: {n_ins}/{len(zig)} legs")

    model = TayalHHMMLite(gate_mode=gate_mode)
    data = {
        k: torch.as_tensor(v, device=device)
        for k, v in (("x", x[:n_ins]), ("sign", sign[:n_ins]),
                     ("x_oos", x[n_ins:]), ("sign_oos", sign[n_ins:]))
    }
    init = init_chains(model, data, config.num_chains, seed=derive_seed(seed, 1), device=device)
    qs, stats = sample(model.make_logp(data), init, config, seed=seed, device=device,
                       vg_fn=model.make_vg(data))
    leg_state = decode_states(model, qs.cpu().numpy(), data, device=device)
    lw = label_and_trade(price, zig, leg_state, ins_end_tick, lags, t_seconds=t_seconds)
    return TayalWindowResult(
        zig=zig,
        n_ins_legs=n_ins,
        samples=qs.cpu().numpy(),
        stats={k: v.cpu().numpy() for k, v in stats.items()},
        leg_state=leg_state,
        leg_topstate=lw.leg_topstate,
        runs=lw.runs,
        summary=lw.summary,
        trades=lw.trades,
        bnh=lw.bnh,
        swapped=lw.swapped,
    )
