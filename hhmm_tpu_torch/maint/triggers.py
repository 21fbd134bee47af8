"""Maintenance triggers: drift alarms and staleness breaches, debounced
into :class:`RefitRequest`\\ s (a copy of ``hhmm_tpu/maint/triggers.py``:
pure Python).

The serving plane produces two cheap "this posterior is going stale"
signals — `serve/online.py`'s :class:`~hhmm_tpu_torch.serve.online.
LoglikCUSUM` drift alarms (a sustained drop in per-tick predictive
loglik) and the per-series staleness clock
(`serve/scheduler.py::staleness_of`, the per-series reading behind the
``serve.snapshot_staleness_seconds`` gauge). Nothing consumed either
until this plane existed. A refit is *expensive*
(a sampler run), so the policy between signal and refit is explicit:

- **per-series debounce**: a series refits at most once per
  ``min_interval_ticks`` — a CUSUM that re-alarms while its refit is
  still queued or freshly promoted must not pile duplicate work;
- **concurrency cap**: at most ``max_concurrent`` series refit per
  maintenance pass (they batch into ONE chunked ``fit_batched`` call,
  `maint/refit.py` — the cap bounds that chunk);
- **bounded queue**: the pending set is capped at ``max_pending``;
  beyond it new triggers drop (counted by the loop) — an alarm storm
  across a fleet must never grow an unbounded host-side queue.

The policy is a passive, host-side accumulator driven by the
:class:`~hhmm_tpu_torch.maint.loop.MaintenanceLoop` (tick-driven, no
threads);
``note_alarm``/``note_staleness`` record pressure, ``due()`` drains the
next batch of requests.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["RefitRequest", "MaintenancePolicy"]

# debounce-clock entries retained (LRU): one int per ever-refitted
# series. Evicting the coldest clock merely re-permits an early refit
# for a series that has not refitted in 65k other series' worth of
# maintenance — the bounded-host-state discipline, not a correctness
# surface.
LAST_STARTED_CAP = 65536


@dataclass(frozen=True)
class RefitRequest:
    """One debounced decision to re-estimate one series' posterior.

    ``reason`` is the trigger class (``"drift-alarm"`` or
    ``"staleness"``); ``tick`` the maintenance-loop tick it fired at —
    both travel into the candidate snapshot's ``meta`` and the
    ``maint`` manifest stanza so every promotion is attributable."""

    series_id: str
    reason: str
    tick: int


class MaintenancePolicy:
    """Debounce + admission for refit work. See the module docstring.

    ``max_staleness_s``: the staleness-SLO trigger — ``None`` disables
    it (drift alarms remain the only trigger); otherwise
    ``note_staleness`` enqueues any series whose posterior age exceeds
    it, under the same debounce as an alarm."""

    def __init__(
        self,
        min_interval_ticks: int = 512,
        max_concurrent: int = 4,
        max_staleness_s: Optional[float] = None,
        max_pending: int = 64,
    ):
        if int(min_interval_ticks) < 0:
            raise ValueError(
                f"min_interval_ticks must be >= 0, got {min_interval_ticks}"
            )
        if int(max_concurrent) <= 0:
            raise ValueError(
                f"max_concurrent must be positive, got {max_concurrent}"
            )
        if int(max_pending) <= 0:
            raise ValueError(f"max_pending must be positive, got {max_pending}")
        self.min_interval_ticks = int(min_interval_ticks)
        self.max_concurrent = int(max_concurrent)
        self.max_staleness_s = (
            None if max_staleness_s is None else float(max_staleness_s)
        )
        self.max_pending = int(max_pending)
        self._pending: "OrderedDict[str, RefitRequest]" = OrderedDict()
        self._inflight: set = set()
        # tick each series' last refit STARTED at — the debounce clock
        # (starting, not finishing: a slow refit must not re-trigger
        # the moment it lands); LRU-bounded at LAST_STARTED_CAP
        self._last_started: "OrderedDict[str, int]" = OrderedDict()
        self.dropped = 0  # triggers lost to the max_pending bound

    # ---- trigger intake ----

    def _enqueue(self, series_id: str, reason: str, tick: int) -> bool:
        if series_id in self._inflight or series_id in self._pending:
            return False  # already owed a refit
        last = self._last_started.get(series_id)
        if last is not None and tick - last < self.min_interval_ticks:
            return False  # debounced: refitted too recently
        if len(self._pending) >= self.max_pending:
            self.dropped += 1
            return False
        self._pending[series_id] = RefitRequest(series_id, reason, int(tick))
        return True

    def note_alarm(self, series_id: str, tick: int) -> bool:
        """A drift alarm fired for ``series_id``. Returns whether a
        refit was actually enqueued (False = debounced/capped)."""
        return self._enqueue(series_id, "drift-alarm", tick)

    def note_staleness(self, series_id: str, age_s: float, tick: int) -> bool:
        """``series_id``'s serving posterior is ``age_s`` old; enqueue
        when it breaches the staleness bound (no-op with the bound
        disabled or unbreached)."""
        if self.max_staleness_s is None:
            return False
        if not (float(age_s) > self.max_staleness_s):  # NaN never triggers
            return False
        return self._enqueue(series_id, "staleness", tick)

    # ---- drain ----

    def due(self, tick: int) -> List[RefitRequest]:
        """Drain up to ``max_concurrent - inflight`` pending requests
        (oldest first) and mark them in flight. The caller runs them
        (one batched refit) and calls :meth:`finish` per series."""
        out: List[RefitRequest] = []
        while (
            self._pending
            and len(self._inflight) + len(out) < self.max_concurrent
        ):
            _, req = self._pending.popitem(last=False)
            out.append(req)
        for req in out:
            self._inflight.add(req.series_id)
            self._last_started[req.series_id] = int(tick)
            self._last_started.move_to_end(req.series_id)
        while len(self._last_started) > LAST_STARTED_CAP:
            self._last_started.popitem(last=False)
        return out

    def finish(self, series_id: str) -> None:
        """The refit attempt for ``series_id`` concluded (promoted,
        rejected, or skipped) — release its concurrency slot. The
        debounce clock keeps running from when it STARTED."""
        self._inflight.discard(series_id)

    def reset_clock(self, series_id: str) -> None:
        """Forget the series' debounce clock. The loop calls this when
        a drained request was SKIPPED before any sampler ran (no
        serving snapshot, no usable history window yet): nothing was
        refitted, so the trigger must not have burned the series'
        refit budget — the next alarm/breach re-enqueues immediately."""
        self._last_started.pop(series_id, None)

    # ---- introspection ----

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    @property
    def inflight_count(self) -> int:
        return len(self._inflight)
