"""Subscribable regime-event feed (counterpart of
``hhmm_tpu/serve/events.py``): change-point detection as a serve
product, not a log line.

Hand a :class:`RegimeEventFeed` to
:class:`~hhmm_tpu_torch.serve.MicroBatchScheduler` (``events=``) and
every committed tick response is observed: :class:`RegimeDetector`
hysteresis flips and :class:`LoglikCUSUM` drift alarms become
:class:`RegimeEvent` records queued per tenant, drained with
:meth:`RegimeEventFeed.drain`.

Observation and drain shed, never raise: a failure inside the feed is
counted (``serve.events_errors``) and swallowed, because an analytics
subscription must never take down the tick path. Queues are bounded per
tenant (oldest dropped, ``serve.events_dropped``); per-series detector
state is LRU-bounded; tenant labels ride the shared cardinality bound
(``obs/request.py::bounded_tenant_label``).

Expanded-state models (``models/hsmm.py``): the scheduler collapses
``K * Dmax`` filter probabilities to ``[K]`` regime probabilities
(``kernels/duration.py::collapse_probs``) before observing, so flip
events are regime flips, never count-down lane flips.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from hhmm_tpu_torch.obs import metrics as _obs_metrics
from hhmm_tpu_torch.obs.request import bounded_tenant_label
from hhmm_tpu_torch.serve.online import LoglikCUSUM, RegimeDetector

__all__ = ["RegimeEvent", "RegimeEventFeed"]

# per-tenant queue bound: a subscriber that never drains loses the
# OLDEST events (newest state wins, like the admission queue's shed
# direction); dropped events are counted, not silent
DEFAULT_QUEUE_CAP = 256
# per-series detector-state bound (LRU, the tenant-bindings discipline)
DEFAULT_SERIES_CAP = 65536


@dataclass(frozen=True)
class RegimeEvent:
    """One detection: a hysteresis-committed regime flip
    (``kind="flip"``) or a CUSUM drift alarm (``kind="drift"``).

    ``regime``/``prev_regime`` are collapsed regime indices (``None``
    for drift alarms); ``stat`` is the detector statistic at the event
    (the flip's winning probability, the CUSUM statistic); ``tick`` is
    the per-series observation ordinal the feed has seen."""

    series_id: str
    tenant: str
    kind: str  # "flip" | "drift"
    tick: int
    regime: Optional[int] = None
    prev_regime: Optional[int] = None
    stat: float = float("nan")
    loglik: float = float("nan")


class _SeriesState:
    __slots__ = ("detector", "cusum", "tick", "last_ll", "generation", "regime")

    def __init__(self, detector: RegimeDetector, cusum: LoglikCUSUM):
        self.detector = detector
        self.cusum = cusum
        self.tick = 0
        self.last_ll: Optional[float] = None
        self.generation: Optional[int] = None
        self.regime: Optional[int] = None


class RegimeEventFeed:
    """Bounded, subscribable regime/drift event queues.

    ``hold``/``margin`` parameterize the per-series
    :class:`RegimeDetector`; ``drift_threshold``/``drift_rate``/
    ``drift_calibrate`` the per-series :class:`LoglikCUSUM` (drift
    detection disabled entirely with ``drift_threshold=None`` — flips
    only). All feed entry points are lock-guarded (the async pipeline
    harvests from the caller's thread today, but the feed must not
    care) and follow the serve degrade rule: failures are counted and
    swallowed, never raised."""

    def __init__(
        self,
        hold: int = 3,
        margin: float = 0.0,
        drift_threshold: Optional[float] = 8.0,
        drift_rate: float = 0.5,
        drift_calibrate: int = 32,
        queue_cap: int = DEFAULT_QUEUE_CAP,
        series_cap: int = DEFAULT_SERIES_CAP,
    ):
        self.hold = int(hold)
        self.margin = float(margin)
        self.drift_threshold = drift_threshold
        self.drift_rate = float(drift_rate)
        self.drift_calibrate = int(drift_calibrate)
        self.queue_cap = int(queue_cap)
        self.series_cap = int(series_cap)
        self._series: "OrderedDict[str, _SeriesState]" = OrderedDict()
        self._queues: Dict[str, Deque[RegimeEvent]] = {}
        self._lock = threading.Lock()
        self._tenant_labels: set = set()
        # lifetime accounting mirrored into stanza()
        self._published: Dict[str, int] = {}
        self._dropped: Dict[str, int] = {}
        self._drained: Dict[str, int] = {}
        self._errors = 0

    # ---- internals ----

    def _count(self, name: str, tenant: str, n: int = 1) -> None:
        label = bounded_tenant_label(tenant, self._tenant_labels)
        _obs_metrics.counter(name, tenant=label).inc(n)

    def _state_of(self, series_id: str) -> _SeriesState:
        st = self._series.get(series_id)
        if st is None:
            cusum = LoglikCUSUM(
                threshold=(
                    float("inf")
                    if self.drift_threshold is None
                    else float(self.drift_threshold)
                ),
                drift=self.drift_rate,
                calibrate=self.drift_calibrate,
            )
            st = self._series[series_id] = _SeriesState(
                RegimeDetector(hold=self.hold, margin=self.margin), cusum
            )
            while len(self._series) > self.series_cap:
                self._series.popitem(last=False)
        else:
            self._series.move_to_end(series_id)
        return st

    def _publish(self, ev: RegimeEvent) -> int:
        """Queue one event; returns how many old events were dropped to
        make room. Metric counters are NOT emitted here — the caller
        counts after releasing the feed lock (the repo's leaf-only lock
        discipline: the metrics registry takes its own lock)."""
        q = self._queues.get(ev.tenant)
        if q is None:
            q = self._queues[ev.tenant] = deque()
        q.append(ev)
        self._published[ev.tenant] = self._published.get(ev.tenant, 0) + 1
        dropped = 0
        while len(q) > self.queue_cap:
            q.popleft()
            self._dropped[ev.tenant] = self._dropped.get(ev.tenant, 0) + 1
            dropped += 1
        return dropped

    # ---- producer side (the scheduler's commit loops) ----

    def observe(
        self,
        series_id: str,
        tenant: str,
        probs,
        loglik: float,
        generation: int = 0,
    ) -> List[RegimeEvent]:
        """Observe one committed tick: ``probs`` is the (collapsed,
        regime-space) posterior vector, ``loglik`` the response's mean
        running loglik, ``generation`` the series' attach generation —
        loglik increments are only differencable WITHIN one generation
        (`serve/scheduler.py::attach_generation`), so a generation
        change restarts the CUSUM baseline instead of feeding it a
        cross-snapshot level jump. Returns the events published (also
        queued for :meth:`drain`). Sheds on any internal failure."""
        try:
            with self._lock:
                events, n_dropped = self._observe_locked(
                    series_id, tenant, probs, loglik, generation
                )
            # counters outside the feed lock: the metrics registry has
            # its own lock, and the lock graph stays leaf-only
            for ev in events:
                self._count("serve.events_published", ev.tenant)
            if n_dropped:
                self._count("serve.events_dropped", str(tenant), n_dropped)
            return events
        except Exception:
            self._errors += 1
            _obs_metrics.counter("serve.events_errors").inc()
            return []

    def _observe_locked(self, series_id, tenant, probs, loglik, generation):
        st = self._state_of(series_id)
        st.tick += 1
        events: List[RegimeEvent] = []
        p = np.asarray(probs, dtype=np.float64)
        if p.ndim == 1 and p.size and np.isfinite(p).all():
            prev = st.regime
            regime, flipped = st.detector.update(p)
            st.regime = regime
            if flipped:
                events.append(
                    RegimeEvent(
                        series_id=series_id,
                        tenant=str(tenant),
                        kind="flip",
                        tick=st.tick,
                        regime=int(regime),
                        prev_regime=None if prev is None else int(prev),
                        stat=float(p[regime]),
                        loglik=float(loglik),
                    )
                )
        if self.drift_threshold is not None:
            ll = float(loglik)
            if st.generation != generation:
                # new snapshot bank: the running-loglik level jumped;
                # restart differencing, keep the calibrated detector
                st.generation = generation
                st.last_ll = ll if np.isfinite(ll) else None
            elif st.last_ll is not None:
                stat, drifted = st.cusum.update(ll - st.last_ll)
                st.last_ll = ll if np.isfinite(ll) else st.last_ll
                if drifted:
                    events.append(
                        RegimeEvent(
                            series_id=series_id,
                            tenant=str(tenant),
                            kind="drift",
                            tick=st.tick,
                            stat=float(stat),
                            loglik=ll,
                        )
                    )
            elif np.isfinite(ll):
                st.last_ll = ll
        n_dropped = 0
        for ev in events:
            n_dropped += self._publish(ev)
        return events, n_dropped

    def forget(self, series_id: str) -> None:
        """Drop one series' detector state (the scheduler's detach
        hook). Queued events survive — they happened."""
        try:
            with self._lock:
                self._series.pop(series_id, None)
        except Exception:
            self._errors += 1

    # ---- subscriber side ----

    def drain(
        self, tenant: Optional[str] = None, max_events: Optional[int] = None
    ) -> List[RegimeEvent]:
        """Pop queued events — one tenant's (oldest first), or every
        tenant's when ``tenant is None`` (interleaved by tenant, oldest
        first within each). ``max_events`` bounds the batch. Sheds to
        an empty list on internal failure, never raises."""
        try:
            with self._lock:
                out: List[RegimeEvent] = []
                tenants = (
                    [str(tenant)] if tenant is not None else list(self._queues)
                )
                for t in tenants:
                    q = self._queues.get(t)
                    while q and (max_events is None or len(out) < max_events):
                        out.append(q.popleft())
                    if q is not None and not q:
                        del self._queues[t]
                for ev in out:
                    self._drained[ev.tenant] = (
                        self._drained.get(ev.tenant, 0) + 1
                    )
                by_tenant: Dict[str, int] = {}
                for ev in out:
                    by_tenant[ev.tenant] = by_tenant.get(ev.tenant, 0) + 1
            for t, n in by_tenant.items():
                self._count("serve.events_drained", t, n)
            return out
        except Exception:
            self._errors += 1
            _obs_metrics.counter("serve.events_errors").inc()
            return []

    def queued(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is not None:
                q = self._queues.get(str(tenant))
                return len(q) if q else 0
            return sum(len(q) for q in self._queues.values())

    def stanza(self, top: int = 16) -> Dict[str, Any]:
        """JSON-ready accounting block (manifest / bench records):
        per-tenant published/dropped/drained/queued, largest publishers
        first, capped at ``top`` rows (the request stanza's tenant-table
        discipline)."""
        with self._lock:
            tenants = sorted(
                set(self._published) | set(self._drained) | set(self._dropped),
                key=lambda t: -self._published.get(t, 0),
            )
            rows = {
                t: {
                    "published": self._published.get(t, 0),
                    "dropped": self._dropped.get(t, 0),
                    "drained": self._drained.get(t, 0),
                    "queued": len(self._queues.get(t, ())),
                }
                for t in tenants[: max(0, int(top))]
            }
            return {
                "tenants": rows,
                "tenants_omitted": max(0, len(tenants) - len(rows)),
                "series_tracked": len(self._series),
                "errors": self._errors,
            }
