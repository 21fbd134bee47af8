"""The escalation ladder: reweight → rejuvenate → refit (counterpart
of ``hhmm_tpu/adapt/ladder.py``).

The adaptation plane's control loop, between the scheduler (whose
responses carry the per-draw reweighting signal and whose tables store
the opaque weight state) and the maintenance plane (whose CUSUM alarms
and warm refits are the expensive last resort):

- **rung 1, reweight** (every tick): fold each non-shed response's
  ``per_draw_loglik`` into its series' log-weights (``adapt/
  weights.py``) and publish the streaming ESS;
- **rung 2, rejuvenate** (ESS collapse or a first CUSUM alarm): a
  batched Liu–West move (``adapt/rejuvenate.py``) restores the cloud's
  diversity and resets its weights to uniform. Due series are padded to
  the scheduler's bucket ladder, so the move runs on a few shapes, and
  a per-flush budget (``Plan.admission_caps()["max_rejuv_per_flush"]``)
  bounds the work one flush absorbs;
- **rung 3, escalate** (persistent alarms): an alarm that survives
  ``escalate_after`` adapted windows falls through to
  ``maint/loop.py``'s debounced warm refit. A promotion clears the
  strikes (the swap's committed attach already reset the weights).

The JAX ladder folds one response at a time in eager ``jnp`` ops and
reads each ESS back as a float. Here one flush's responses fold as one
``[n, D]`` batch on the ladder's device (a series that appears twice in
a flush folds its second response in a second batch, after the first),
and the new weights and ESS come back to the host once a flush. Each
series' state is stored as the JAX ladder stores it: a host
``np.ndarray [D]`` through ``scheduler.set_weight_state``.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.obs import manifest as obs_manifest
from hhmm_tpu_torch.serve.metrics import AdaptMetrics

from . import weights as W
from .rejuvenate import DrawSource, Rejuvenator

__all__ = ["AdaptationLadder"]

# the stanza's event window (cumulative truth lives in the counters)
_MAX_EVENTS = 64


class AdaptationLadder:
    """One ladder a scheduler. Drive it right after each flush,
    ``ladder.observe(responses)``, and wire it into the maintenance loop
    (``MaintenanceLoop(..., adapt=ladder)``) so alarms climb the rungs
    in order. ``seed`` / ``source`` feed the :class:`Rejuvenator`;
    ``device`` (None: the card) is where the weight math and the move
    run."""

    def __init__(
        self,
        scheduler,
        seed: int = 0,
        *,
        plan=None,
        ess_floor_frac: Optional[float] = None,
        max_rejuv_per_flush: Optional[int] = None,
        forget: float = 0.99,
        shrink: float = 0.98,
        escalate_after: int = 2,
        metrics: Optional[AdaptMetrics] = None,
        device: DeviceLike = None,
        source: Optional[DrawSource] = None,
    ):
        self.sched = scheduler
        caps: Dict[str, Any] = plan.admission_caps() if plan is not None else {}
        if ess_floor_frac is None:
            ess_floor_frac = float(caps.get("ess_floor_frac", 0.5))
        if max_rejuv_per_flush is None:
            mr = caps.get("max_rejuv_per_flush")
            max_rejuv_per_flush = int(mr) if mr is not None else None
        if not (0.0 < float(ess_floor_frac) <= 1.0):
            raise ValueError(f"ess_floor_frac must be in (0, 1], got {ess_floor_frac}")
        if int(escalate_after) < 1:
            raise ValueError(f"escalate_after must be >= 1, got {escalate_after}")
        self.ess_floor_frac = float(ess_floor_frac)
        self.max_rejuv_per_flush = max_rejuv_per_flush
        self.forget = W.check_forget(forget)
        self.escalate_after = int(escalate_after)
        self.metrics = metrics if metrics is not None else AdaptMetrics()
        self.device = resolve_device(device)
        self.rejuvenator = Rejuvenator(seed, shrink=shrink, device=self.device, source=source)
        self._ess: Dict[str, float] = {}
        self._strikes: Dict[str, int] = {}
        self._events: deque = deque(maxlen=_MAX_EVENTS)
        self._ess_min_seen = float("inf")
        self._tick = 0

    # ---- rung 1: reweight ----

    def ess_floor(self, n_draws: int) -> float:
        """The absolute rejuvenation trigger for a D-draw cloud."""
        return self.ess_floor_frac * float(n_draws)

    def fold(self, rows) -> List[tuple]:
        """Reweight ``rows`` — ``(series_id, per_draw_loglik [D],
        draw_ok [D])`` in response order — and store each series' new
        weights. Returns ``(series_id, ESS)`` a row, in order. A series'
        k-th row in ``rows`` folds in the k-th batch, so its rows apply
        in order; one host copy of weights and ESS at the end."""
        waves: List[List[int]] = []
        seen: Dict[str, int] = {}
        for i, (sid, _, _) in enumerate(rows):
            k = seen.get(sid, 0)
            seen[sid] = k + 1
            if k == len(waves):
                waves.append([])
            waves[k].append(i)
        dev = self.device
        current: Dict[str, torch.Tensor] = {}  # the flush's newest row a series
        out_lw: List[torch.Tensor] = []
        out_ess: List[torch.Tensor] = []
        order: List[int] = []
        for wave in waves:
            inc = torch.as_tensor(np.stack([np.asarray(rows[i][1]) for i in wave]), device=dev)
            ok = torch.as_tensor(np.stack([np.asarray(rows[i][2], bool) for i in wave]), device=dev)
            host, fresh = [], []
            for i in wave:
                lw = self.sched.weight_state_of(rows[i][0])
                fresh.append(lw is None)
                host.append(W.uniform_log_weights(inc.shape[-1], np.float32) if lw is None
                            else np.asarray(lw, np.float32))
            lw_b = torch.as_tensor(np.stack(host), device=dev).to(inc.dtype)
            carried = [j for j, i in enumerate(wave) if rows[i][0] in current]
            if carried:
                lw_b[carried] = torch.stack([current[rows[wave[j]][0]] for j in carried])
            fresh_b = torch.tensor(fresh, device=dev)
            if carried:
                fresh_b[carried] = False
            new = W.reweight(lw_b, inc, ok, self.forget, fresh_b)
            for j, i in enumerate(wave):
                current[rows[i][0]] = new[j]
            out_lw.append(new)
            out_ess.append(W.ess(new))
            order.extend(wave)
        if not order:
            return []
        lw_h = torch.cat(out_lw).cpu().numpy()
        ess_h = torch.cat(out_ess).cpu().numpy()
        by_row = [None] * len(rows)
        for j, i in enumerate(order):
            by_row[i] = j
        for i, (sid, _, _) in enumerate(rows):
            self.sched.set_weight_state(sid, lw_h[by_row[i]].copy())
        return [(sid, float(ess_h[by_row[i]])) for i, (sid, _, _) in enumerate(rows)]

    def observe(self, responses) -> int:
        """Fold one flush's responses into the weight plane; returns the
        number of responses folded. Shed responses never touch weights
        (nothing was folded into the filter); series whose ESS fell
        below the floor are rejuvenated in one batched move, under the
        per-flush budget."""
        self._tick += 1
        rows = [(r.series_id, r.per_draw_loglik, r.draw_ok) for r in responses
                if not r.shed and r.per_draw_loglik is not None]
        due: List[str] = []
        for (sid, inc, _), (_, e) in zip(rows, self.fold(rows)):
            self._ess[sid] = e
            if e < self.ess_floor(np.shape(inc)[-1]):
                due.append(sid)
        n = len(rows)
        if n:
            self.metrics.note_reweight(n)
            low = min(self._ess.values())
            if low < self._ess_min_seen:
                self._ess_min_seen = low
            self.metrics.set_ess_min(self._ess_min_seen)
        if due:
            if self.max_rejuv_per_flush is not None:
                due = due[: self.max_rejuv_per_flush]
            self.rejuvenate(due, reason="ess_floor")
        obs_manifest.note_stanza("adapt", self.stanza())
        return n

    # ---- rung 2: rejuvenate ----

    def _bucketed(self, n: int) -> int:
        buckets = getattr(self.sched, "buckets", None)
        if not buckets:
            return n
        for b in buckets:
            if n <= int(b):
                return int(b)
        return int(buckets[-1])

    def rejuvenate(self, series_ids, *, reason: str = "explicit") -> int:
        """Run the batched Liu–West move for these series, commit each
        result through ``replace_draw_bank`` and reset its weights to
        uniform. Unattached or unticked series, and refused commits, are
        skipped. Returns the number of series rejuvenated."""
        todo = []
        for sid in series_ids:
            bank = self.sched.draw_bank_of(sid)
            fs = self.sched.filter_state_of(sid)
            if bank is None or fs is None:
                continue
            lw = self.sched.weight_state_of(sid)
            if lw is None:
                lw = W.uniform_log_weights(int(bank.shape[0]))
            todo.append((sid, bank, np.asarray(lw), fs))
        done = 0
        max_b = self._bucketed(len(todo)) if todo else 0
        dev = self.device
        while todo:
            chunk, todo = todo[:max_b], todo[max_b:]
            # pad to the bucket by repeating the last entry (the
            # scheduler's lane padding); padded rows are never committed
            lanes = [chunk[min(i, len(chunk) - 1)] for i in range(self._bucketed(len(chunk)))]
            new_draws, new_alpha, new_ll, new_ok = self.rejuvenator.move(
                torch.stack([c[1].to(dev) for c in lanes]),
                torch.as_tensor(np.stack([c[2] for c in lanes]), device=dev),
                torch.stack([c[3][0].to(dev) for c in lanes]),
                torch.stack([c[3][1].to(dev) for c in lanes]),
                torch.stack([c[3][2].to(dev) for c in lanes]),
            )
            for i, (sid, bank, _, _) in enumerate(chunk):
                ess_before = self._ess.get(sid)
                err = self.sched.replace_draw_bank(sid, new_draws[i], new_alpha[i], new_ll[i],
                                                   new_ok[i])
                if err is not None:
                    continue
                n_draws = int(bank.shape[0])
                self.sched.set_weight_state(sid, W.uniform_log_weights(n_draws))
                self._ess[sid] = float(n_draws)
                self.metrics.note_rejuvenation()
                self._events.append({
                    "kind": "rejuvenate",
                    "series": sid,
                    "tick": self._tick,
                    "reason": reason,
                    "ess_before": None if ess_before is None else round(ess_before, 3),
                    "ess_after": float(n_draws),
                })
                done += 1
        return done

    # ---- rung 3: the alarm ladder (maint/loop.py) ----

    def on_alarm(self, series_id: str) -> str:
        """A CUSUM alarm climbed here. The first ``escalate_after`` alarms
        of a series are answered by a rejuvenation (``"rejuvenate"``: the
        loop treats the alarm as consumed); a persisting one returns
        ``"escalate"`` and falls through to the refit path. Strikes clear
        on promotion (:meth:`on_promoted`)."""
        strikes = self._strikes.get(series_id, 0) + 1
        self._strikes[series_id] = strikes
        if strikes > self.escalate_after:
            self.metrics.note_escalation()
            self._events.append({"kind": "escalate", "series": series_id, "tick": self._tick,
                                 "strikes": strikes})
            return "escalate"
        self.rejuvenate([series_id], reason="alarm")
        return "rejuvenate"

    def on_promoted(self, series_id: str) -> None:
        """A refit's snapshot was promoted and swapped in: strikes clear
        (the committed attach already reset the stored weights)."""
        self._strikes.pop(series_id, None)
        self._ess.pop(series_id, None)

    # ---- reporting ----

    def stanza(self) -> Dict[str, Any]:
        """The ``adapt`` manifest stanza, with the JAX ladder's keys:
        counters, the per-series ESS table and the recent events."""
        m = self.metrics
        floors = []
        for sid, e in self._ess.items():
            n = self._n_draws_of(sid)
            if n is not None:
                floors.append(e < self.ess_floor(n))
        return {
            "ess_floor_frac": self.ess_floor_frac,
            "forget": self.forget,
            "shrink": self.rejuvenator.shrink,
            "escalate_after": self.escalate_after,
            "reweight_ticks": m.reweight_ticks,
            "rejuvenations": m.rejuvenations,
            "escalations": m.escalations,
            "ess_min": None if not np.isfinite(self._ess_min_seen)
            else round(self._ess_min_seen, 3),
            "floor_breaches": int(sum(floors)),
            "ess": [{"series": sid, "ess": round(e, 3)} for sid, e in sorted(self._ess.items())],
            "events": list(self._events),
        }

    def _n_draws_of(self, series_id: str) -> Optional[int]:
        bank = self.sched.draw_bank_of(series_id)
        return None if bank is None else int(bank.shape[0])
