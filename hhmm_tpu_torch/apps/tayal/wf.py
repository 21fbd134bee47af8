"""Walk-forward trading harness on one CUDA card (counterpart of
``hhmm_tpu/apps/tayal/wf.py``; the batched equivalent of
`tayal2009/R/wf-trade.R` + `tayal2009/test-strategy.R`).

The reference builds ~204 (stock, 5-day-train + 1-day-trade) tasks and
farms full MCMC refits to a 4-worker socket cluster. Here every task is
one series of a batched fit (``batch/fit.py::fit_batched``): ragged leg
sequences are padded and masked, fitted in length-sorted groups, and
cached by digest, the reference's crash-recovery semantics
(`wf-trade.R:86-109`). The median-alpha decode runs batched on the card
(the gated ``FWD`` kernel, two launches a dispatch) and ships hard
states to the host; labeling, trading and analytics stay on the host
per task.

The JAX harness's ``mesh`` (placement, ``ROADMAP.md`` A9) and
``time_parallel`` (the associative scans, A7) are not ported; ``key``
becomes ``seed``, and ``device`` picks the card (the default) or the
CPU.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.apps.tayal.features import extract_features, to_model_inputs
from hhmm_tpu_torch.apps.tayal.pipeline import label_and_trade
from hhmm_tpu_torch.apps.tayal.trading import Trades
from hhmm_tpu_torch.batch import ResultCache, derive_seed, digest_key, fit_batched, pad_datasets
from hhmm_tpu_torch.infer import GibbsConfig
from hhmm_tpu_torch.models import TayalHHMMLite
from hhmm_tpu_torch.native import zigzag as _nz

__all__ = ["WFTask", "WFResult", "build_tasks", "wf_trade", "median_states"]

D_DEC = 100  # thinned draws per task for the median-alpha classifier
G_DEC = 8  # tasks per decode dispatch (bounds device memory)


@dataclass
class WFTask:
    """One (symbol, train-span, trade-span) window
    (`test-strategy.R:44-54`)."""

    symbol: str
    window: int
    price: np.ndarray
    size: np.ndarray
    t_seconds: np.ndarray
    ins_end_tick: int


@dataclass
class WFResult:
    symbol: str
    window: int
    trades: Dict[int, Trades]
    bnh: np.ndarray
    summary: Dict[str, Dict[str, float]]
    leg_topstate: np.ndarray
    n_ins_legs: int
    diverged: float
    swapped: bool
    n_oos_legs: int = 0
    oos_leg_switches: int = 0
    chains_pooled: int = 0
    run_len_mean: float = 0.0
    run_len_median: float = 0.0


def build_tasks(
    days: Dict[str, List[Dict[str, np.ndarray]]],
    train_days: int = 5,
    trade_days: int = 1,
) -> List[WFTask]:
    """Rolling windows per symbol from per-day tick dicts with keys
    ``price``/``size``/``t_seconds`` (`test-strategy.R:44-54`)."""
    tasks = []
    for symbol, day_list in days.items():
        n_windows = len(day_list) - train_days - trade_days + 1
        for w in range(max(0, n_windows)):
            span = day_list[w : w + train_days + trade_days]
            price = np.concatenate([d["price"] for d in span])
            size = np.concatenate([d["size"] for d in span])
            t = np.concatenate([d["t_seconds"] for d in span])
            ins_ticks = sum(len(d["price"]) for d in span[:train_days])
            tasks.append(
                WFTask(
                    symbol=symbol,
                    window=w,
                    price=price,
                    size=size,
                    t_seconds=t,
                    ins_end_tick=ins_ticks - 1,
                )
            )
    return tasks


class _PhaseClock:
    """Cumulative named phases on ``time.perf_counter``: :meth:`mark`
    adds the time since the last mark to ``name``; :meth:`phase` adds a
    region's own time without moving the marker."""

    def __init__(self, sink: Dict[str, float], round_digits: Optional[int] = None):
        self.sink, self._round = sink, round_digits
        self._last = time.perf_counter()

    def _acc(self, name: str, dt: float) -> None:
        total = self.sink.get(name, 0.0) + dt
        self.sink[name] = total if self._round is None else round(total, self._round)

    def restart(self) -> None:
        self._last = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._last

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self._acc(name, now - self._last)
        self._last = now

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc(name, time.perf_counter() - t0)


def median_states(probs: torch.Tensor) -> torch.Tensor:
    """Hard states ``[G, T]`` from probabilities ``[G, D, T, K]``: the
    median over the ``D`` draws as ``np.median`` takes it (the mean of
    the two middle values when ``D`` is even; ``torch.median`` would
    return the lower one), then the first maximum over ``K`` (as
    ``np.argmax``)."""
    D = probs.shape[1]
    srt = torch.sort(probs, dim=1).values
    med = srt[:, D // 2] if D % 2 else (srt[:, D // 2 - 1] + srt[:, D // 2]) / 2
    return torch.argmax(med, dim=-1)


def wf_trade(
    tasks: Sequence[WFTask],
    config=GibbsConfig(num_warmup=250, num_samples=250, num_chains=1),
    alpha: float = 0.25,
    gate_mode: str = "stan",
    lags: Sequence[int] = (0, 1, 2, 3, 4, 5),
    chunk_size: int = 64,
    cache_dir: Optional[str] = None,
    expansion: str = "xts",
    basin_nats: float = 10.0,
    warm_start: bool = False,
    phase_timings: Optional[Dict[str, float]] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> List[WFResult]:
    """Run all tasks as batched fits + per-task host post-processing
    (`wf-trade.R:30-179`, minus the socket cluster).

    ``config`` is a :class:`~hhmm_tpu_torch.infer.GibbsConfig` (the
    default, as NUTS is not ported: ``ROADMAP.md`` A5) or a
    :class:`~hhmm_tpu_torch.infer.ChEESConfig` (shared adaptation,
    ``num_chains >= 2``); ``fit_batched`` dispatches on the type.

    With multiple chains, the per-task decode pools only chains whose
    mean log-density is within ``basin_nats`` of the task's best chain
    (real-data posteriors split across non-symmetric basins, and a
    median over mixed-basin draws flattens into leg-level flicker).
    ``expansion`` follows :func:`~hhmm_tpu_torch.apps.tayal.pipeline.
    label_and_trade`.

    ``warm_start``: fit one pilot per symbol (its first window) at a
    quarter of the sampling budget (at least 50 draws) and start every
    window's chains from the pilot's terminal draws.

    ``phase_timings``: pass a dict to receive the wall-clock breakdown
    in seconds — ``features``, ``pilot_fit`` (with ``warm_start``),
    ``fit``, ``decode``, ``host_trading`` — and the decode's sub-phases
    ``decode.select``, ``decode.cache_read``, ``decode.prep``,
    ``decode.first_call`` (the first dispatch of each shape),
    ``decode.steady``, ``decode.host_reduce``, ``decode.cache_io``,
    with the counts ``decode.dispatches`` and ``decode.shapes_pending``.
    Cache hits show as near-zero phases.

    ``seed`` seeds the chain inits and the samplers (one derived seed a
    fit group); ``device=None`` is the CUDA card."""
    device = resolve_device(device)
    tm = phase_timings if phase_timings is not None else {}
    _mark = _PhaseClock(tm, round_digits=2).mark

    model = TayalHHMMLite(gate_mode=gate_mode)

    # the whole task list in one native threaded batch when the C++
    # extractor is available (the reference runs this per task inside
    # its socket workers, `wf-trade.R:44-61`)
    if _nz.available():
        zigs = _nz.extract_features_batch(
            [(t.price, t.size, t.t_seconds) for t in tasks], alpha=alpha
        )
        for z in zigs:
            if isinstance(z, Exception):
                raise z
    else:
        zigs = [
            extract_features(t.price, t.size, t.t_seconds, alpha=alpha, engine="numpy")
            for t in tasks
        ]

    _mark("features")
    feats, datasets = [], []
    for task, zig in zip(tasks, zigs):
        x, sign = to_model_inputs(zig.feature)
        n_ins = int((zig.end <= task.ins_end_tick).sum())
        feats.append((zig, x, sign, n_ins))
        datasets.append({"x": x[:n_ins], "sign": sign[:n_ins]})

    # Fit in LENGTH-SORTED groups, each padded to a 1024-multiple bucket,
    # instead of one global pad: window lengths vary ~10x across symbols,
    # and a global pad makes every group pay the longest window's
    # sequential recursions. Only in-sample arrays go to the fit; the
    # OOS suffix enters in the decode below.
    B = len(datasets)

    def _fit_grouped(indices, cfg_g, salt, init_by_idx=None):
        indices = np.asarray(indices)
        order = indices[np.argsort([len(datasets[j]["x"]) for j in indices], kind="stable")]
        out: Dict[int, tuple] = {}
        for gi in range(0, len(order), chunk_size):
            g = order[gi : gi + chunk_size]
            padded = pad_datasets([datasets[j] for j in g], time_keys=["x", "sign"])
            T_g = padded["x"].shape[1]
            bucket = max(1024, -(-T_g // 1024) * 1024)
            if bucket > T_g:
                padded = {k: np.pad(v, ((0, 0), (0, bucket - T_g))) for k, v in padded.items()}
            init_g = None if init_by_idx is None else np.stack([init_by_idx[j] for j in g])
            qs_g, stats_g = fit_batched(
                model,
                padded,
                cfg_g,
                init=init_g,
                chunk_size=len(g),
                cache_dir=cache_dir,
                seed=derive_seed(seed, salt, gi),
                device=device,
            )
            qs_g = qs_g.cpu().numpy()
            logp_g = stats_g["logp"].cpu().numpy()
            div_g = stats_g["diverging"].cpu().numpy()
            for li, j in enumerate(g):
                out[int(j)] = (qs_g[li], logp_g[li], div_g[li])
        return out

    init_full = None
    if warm_start:
        sym_first: Dict[str, int] = {}
        for i, t in enumerate(tasks):
            sym_first.setdefault(t.symbol, i)
        pilot_cfg = replace(config, num_samples=max(50, config.num_samples // 4))
        pilots = _fit_grouped(list(sym_first.values()), pilot_cfg, 777)
        term = {sym: pilots[j][0][:, -1] for sym, j in sym_first.items()}  # [chains, dim]
        init_full = {i: term[t.symbol] for i, t in enumerate(tasks)}
        _mark("pilot_fit")

    fits = _fit_grouped(np.arange(B), config, 0, init_by_idx=init_full)
    _mark("fit")

    def _bucket(n: int) -> int:
        """Next power of two >= max(n, 1024): decode shapes collapse to
        a handful of buckets."""
        return 1 << max(10, int(n - 1).bit_length())

    def _pad_to(a, n):
        return np.pad(np.asarray(a), (0, n - len(a)))

    # ---- decode: BATCHED by (b_ins, b_oos) bucket pair, G_DEC tasks of
    # D_DEC thinned draws a dispatch, hard states reduced on the card;
    # digest-cached per task ----
    dcache = ResultCache(cache_dir) if cache_dir is not None else None
    sub = defaultdict(float)  # raw floats, rounded once below
    clock = _PhaseClock(sub)
    leg_states: List[Optional[np.ndarray]] = [None] * B
    meta = []  # per task: (n_ins, n_oos, keep, draws_t, dk, n_uniq)
    pend: Dict[tuple, List[int]] = {}
    for i, (zig, x, sign, n_ins) in enumerate(feats):
        n_oos = len(x) - n_ins
        qs_i, logp_i, _ = fits[i]
        # basin selection: pool only chains within basin_nats of the best
        chain_lp = logp_i.mean(axis=-1)  # [chains]
        keep = chain_lp >= np.nanmax(chain_lp) - basin_nats
        if not keep.any():  # all-NaN logp: decode from everything
            keep[:] = True
        draws = qs_i[keep].reshape(-1, qs_i.shape[-1])
        sel = np.linspace(0, len(draws) - 1, min(D_DEC, len(draws))).astype(int)
        draws_t = draws[sel]
        n_uniq = len(draws_t)
        if n_uniq < D_DEC:  # repeat-pad to D_DEC; the median uses n_uniq rows
            draws_t = draws_t[np.arange(D_DEC) % n_uniq]
        dk = None
        if dcache is not None:
            dk = digest_key(
                {"stage": "wf-decode-torch-v1", "gate_mode": gate_mode, "device": device.type},
                {"x": x, "sign": sign},
                {"n_ins": n_ins, "n_uniq": n_uniq},
                draws_t,
            )
            with clock.phase("decode.cache_read"):
                hit = dcache.get(dk)
            if hit is not None:
                leg_states[i] = np.asarray(hit["leg_state"])
        meta.append((n_ins, n_oos, keep, draws_t, dk, n_uniq))
        if leg_states[i] is None:
            pend.setdefault((_bucket(n_ins), _bucket(n_oos)), []).append(i)
    sub["decode.select"] = clock.elapsed() - sub["decode.cache_read"]

    seen_shapes: set = set()
    tm["decode.dispatches"] = 0
    for (b_ins, b_oos), idxs in pend.items():
        for c0 in range(0, len(idxs), G_DEC):
            clock.restart()
            grp = idxs[c0 : c0 + G_DEC]
            grp_fit = grp + [grp[-1]] * (G_DEC - len(grp))  # repeat-pad: one shape
            rows = [feats[j][1:3] + (meta[j][0],) for j in grp_fit]  # (x, sign, n_ins)
            data_g = {
                "x": np.stack([_pad_to(x[:n], b_ins) for x, _, n in rows]),
                "sign": np.stack([_pad_to(s[:n], b_ins) for _, s, n in rows]),
                "mask": np.stack([(np.arange(b_ins) < n).astype(np.float32) for _, _, n in rows]),
                "x_oos": np.stack([_pad_to(x[n:], b_oos) for x, _, n in rows]),
                "sign_oos": np.stack([_pad_to(s[n:], b_oos) for _, s, n in rows]),
                "mask_oos": np.stack(
                    [(np.arange(b_oos) < len(x) - n).astype(np.float32) for x, _, n in rows]
                ),
            }
            data_dev = {k: torch.as_tensor(v, device=device) for k, v in data_g.items()}
            samples_g = torch.as_tensor(np.stack([meta[j][3] for j in grp_fit]), device=device)
            clock.mark("decode.prep")
            full = all(meta[j][5] == D_DEC for j in grp)
            shape_key = (b_ins, b_oos, full)
            first = shape_key not in seen_shapes
            seen_shapes.add(shape_key)
            tm["decode.dispatches"] += 1
            run = "decode.first_call" if first else "decode.steady"
            if full:
                out = model.filtered(samples_g, data_dev, device=device)
                ins_s = median_states(out["alpha"]).cpu().numpy()
                oos_s = median_states(out["alpha_oos"]).cpu().numpy()
                clock.mark(run)
                for li, j in enumerate(grp):
                    n_ins_j, n_oos_j = meta[j][0], meta[j][1]
                    leg_states[j] = np.concatenate([ins_s[li][:n_ins_j], oos_s[li][:n_oos_j]])
            else:
                # under-filled tasks (basin selection kept fewer than
                # D_DEC draws): the median over the n_uniq distinct rows,
                # on the host, as decode_states takes it
                out = model.generated(samples_g, data_dev, device=device)
                alpha_i = out["alpha"].cpu().numpy()  # [G, D, b_ins, K]
                alpha_o = out["alpha_oos"].cpu().numpy()
                clock.mark(run)
                for li, j in enumerate(grp):
                    n_ins_j, n_oos_j, n_uniq_j = meta[j][0], meta[j][1], meta[j][5]
                    ins_state = np.argmax(np.median(alpha_i[li][:n_uniq_j], axis=0), axis=-1)
                    oos_state = np.argmax(np.median(alpha_o[li][:n_uniq_j], axis=0), axis=-1)
                    leg_states[j] = np.concatenate([ins_state[:n_ins_j], oos_state[:n_oos_j]])
            clock.mark("decode.host_reduce")
            for j in grp:
                if meta[j][4] is not None:
                    dcache.put(meta[j][4], {"leg_state": leg_states[j]})
            clock.mark("decode.cache_io")
    tm["decode.shapes_pending"] = len(seen_shapes)
    for k, v in sub.items():
        tm[k] = round(v, 2)
    _mark("decode")

    results = []
    for i, (task, (zig, x, sign, n_ins)) in enumerate(zip(tasks, feats)):
        n_oos, keep = meta[i][1], meta[i][2]
        lw = label_and_trade(
            task.price,
            zig,
            leg_states[i],
            task.ins_end_tick,
            lags,
            t_seconds=task.t_seconds,
            expansion=expansion,
        )
        oos_top = lw.leg_topstate[n_ins:]
        results.append(
            WFResult(
                symbol=task.symbol,
                window=task.window,
                trades=lw.trades,
                bnh=lw.bnh,
                summary=lw.summary,
                leg_topstate=lw.leg_topstate,
                n_ins_legs=n_ins,
                diverged=float(np.asarray(fits[i][2]).mean()),
                swapped=lw.swapped,
                n_oos_legs=n_oos,
                oos_leg_switches=int((oos_top[1:] != oos_top[:-1]).sum()),
                chains_pooled=int(keep.sum()),
                run_len_mean=float(np.mean(lw.runs.length)),
                run_len_median=float(np.median(lw.runs.length)),
            )
        )
    _mark("host_trading")
    return results
