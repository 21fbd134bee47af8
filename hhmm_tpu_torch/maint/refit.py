"""Sliding-window warm refit: the scheduler's bounded history tail,
refitted through ``batch/fit.py``, warm-started from the serving
snapshot's own draws (counterpart of ``hhmm_tpu/maint/refit.py``).

- **The window** is the scheduler's per-series ring of folded
  observations (``serve/scheduler.py::history_tail_of``), split into a
  fit window and a held-out evaluation tail: the shadow gate
  (``maint/shadow.py``) judges the candidate on ticks the refit never
  saw.
- **The fit** is one :func:`~hhmm_tpu_torch.batch.fit_batched` call over
  every runnable request, as one chunk: ragged windows pad with
  ``batch/pad.py``, and the healing ladder and the plan come along.
- **The warm start** is :func:`~hhmm_tpu_torch.batch.init_from_snapshot`
  over the serving snapshot's (dequantized) draw bank.

Candidates inherit the champion's draw count and storage dtype, so a
promotion keeps the scheduler's fixed-``D`` contract and the pager's
byte arithmetic. The JAX package takes a PRNG key; the port takes the
fit's ``seed``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.batch.fit import fit_batched, init_from_snapshot
from hhmm_tpu_torch.batch.pad import pad_ragged
from hhmm_tpu_torch.maint.triggers import RefitRequest
from hhmm_tpu_torch.serve.registry import PosteriorSnapshot, snapshot_from_fit

__all__ = ["split_window", "warm_refit"]


def split_window(
    tail: Dict[str, np.ndarray], eval_ticks: int
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Split one history tail into ``(fit_window, eval_tail)``: the last
    ``eval_ticks`` observations are held out for the shadow gate."""
    if eval_ticks < 0:
        raise ValueError(f"eval_ticks must be >= 0, got {eval_ticks}")
    if eval_ticks == 0:
        return dict(tail), {}
    fit = {k: np.asarray(v)[:-eval_ticks] for k, v in tail.items()}
    ev = {k: np.asarray(v)[-eval_ticks:] for k, v in tail.items()}
    return fit, ev


def warm_refit(
    model,
    requests: Sequence[RefitRequest],
    tails: Dict[str, Optional[Dict[str, np.ndarray]]],
    champions: Dict[str, Optional[PosteriorSnapshot]],
    sampler_config,
    seed: int = 0,
    *,
    eval_ticks: int = 16,
    min_fit_ticks: int = 16,
    n_draws: Optional[int] = None,
    snapshot_dtype: Optional[str] = None,
    plan=None,
    retry=None,
    device: DeviceLike = None,
) -> Tuple[Dict[str, PosteriorSnapshot], List[Tuple[str, str]]]:
    """Batch every runnable request into one warm fit on ``device``
    (None: the card), seeded by ``seed``.

    ``tails`` / ``champions``: each series' history window and serving
    snapshot (``None`` entries are skipped with a reason, not raised).
    Returns ``(candidates, skipped)``: candidate snapshots fitted on the
    tail less the held-out ticks, and the skip reasons. A candidate
    inherits the champion's draw count (``n_draws=None``) and storage
    dtype (``snapshot_dtype=None``); its ``meta`` records the trigger
    and the window."""
    device = resolve_device(device)
    runnable: List[Tuple[RefitRequest, Dict[str, np.ndarray], Any]] = []
    skipped: List[Tuple[str, str]] = []
    keyset: Optional[Tuple[str, ...]] = None
    for req in requests:
        sid = req.series_id
        champ = champions.get(sid)
        if champ is None:
            skipped.append((sid, "no serving snapshot to warm-start from"))
            continue
        tail = tails.get(sid)
        if not tail:
            skipped.append((sid, "no history tail recorded"))
            continue
        ks = tuple(sorted(tail.keys()))
        if keyset is None:
            keyset = ks
        elif ks != keyset:
            skipped.append(
                (sid, f"history keys {list(ks)} do not match the "
                      f"batch's {list(keyset)}")
            )
            continue
        L = int(np.asarray(tail[ks[0]]).shape[0])
        if L < min_fit_ticks + eval_ticks:
            skipped.append(
                (sid, f"tail too short ({L} < {min_fit_ticks} fit + "
                      f"{eval_ticks} eval ticks)")
            )
            continue
        fit_win, _ = split_window(tail, eval_ticks)
        runnable.append((req, fit_win, champ))
    if not runnable:
        return {}, skipped

    C = int(sampler_config.num_chains)
    # ragged fit windows pad like any batch fit (masked steps add nothing
    # to the loglik); equal lengths get an all-ones mask
    data_b: Dict[str, np.ndarray] = {}
    mask = None
    for k in keyset:
        data_b[k], mask = pad_ragged([fw[k] for _, fw, _ in runnable])
    data_b["mask"] = np.asarray(mask, np.float32)
    init = torch.stack([init_from_snapshot(champ, C, device=device)
                        for _, _, champ in runnable])  # [B, C, dim]
    samples, stats = fit_batched(
        model,
        data_b,
        sampler_config,
        init=init,
        chunk_size=len(runnable),
        seed=seed,
        device=device,
        plan=plan,
        retry=retry,
    )
    ch = stats.get("chain_healthy")
    healthy = (
        np.ones((len(runnable), C), bool)
        if ch is None
        else ch.cpu().numpy().reshape(len(runnable), -1)
    )
    samples = samples.cpu().numpy()
    candidates: Dict[str, PosteriorSnapshot] = {}
    for i, (req, fit_win, champ) in enumerate(runnable):
        nd = int(n_draws) if n_draws else int(np.asarray(champ.draws).shape[0])
        dt = snapshot_dtype if snapshot_dtype else champ.draws_dtype
        candidates[req.series_id] = snapshot_from_fit(
            model,
            samples[i],
            chain_healthy=healthy[i],
            n_draws=nd,
            dtype=dt,
            meta={
                "maint": {
                    "reason": req.reason,
                    "trigger_tick": req.tick,
                    "fit_ticks": int(np.asarray(fit_win[keyset[0]]).shape[0]),
                    "eval_ticks": int(eval_ticks),
                    "warm_start": True,
                }
            },
        )
    return candidates, skipped
