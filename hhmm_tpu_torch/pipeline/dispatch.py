"""In-flight flush table (counterpart of ``hhmm_tpu/pipeline/dispatch.py``):
the double-buffered dispatch of the async serving pipeline.

CUDA launches are already asynchronous: a tick's torch ops return
tensors whose work proceeds on the card's stream. The synchronous
scheduler waits inside every dispatch; this module keeps a dispatched
group's outputs alive instead. Each flush group becomes a
:class:`Flight` — its output tensors, the response rows copied
non-blocking into pinned host memory, and a ``torch.cuda.Event``
recorded after that copy — parked in an :class:`InFlightTable` until a
harvest waits on the event and commits. Between dispatch and harvest the
host is free: the next flush's queue drain, lane padding and
observation staging overlap the card's work on this one.

Contracts the table enforces (the scheduler builds on them):

- **commit-at-harvest**: a flight carries no committed state; the
  scheduler changes filter state, history tails, staleness clocks and
  metrics only after the harvest-side wait succeeds, so a flight that
  fails sheds without torn state;
- **in-flight series guard**: a series with an unharvested flight does
  not dispatch again (its next tick would stack the state the in-flight
  tick is about to replace); :meth:`InFlightTable.series_in_flight` is
  the guard set and the scheduler defers guarded ticks;
- **FIFO harvest**: flights harvest in dispatch order
  (:meth:`InFlightTable.pop_oldest`), so a series' ticks fold in
  submission order across flushes;
- **leaf lock**: the table's lock guards only its own dicts — no I/O,
  no torch op, no callback runs under it; the wait happens in the
  scheduler, outside any lock.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Flight", "InFlightTable"]


class Flight:
    """One dispatched-but-unharvested flush group: the un-synced
    device outputs plus the host-side context its harvest-time commit
    needs. Opaque to the table — the scheduler (one layer up) builds
    and commits flights; the table only sequences them."""

    __slots__ = (
        "flush_id",
        "kernel",
        "bucket",
        "device_index",
        "group",
        "traces",
        "outputs",
        "dtype_locks",
        "fn",
        "fargs",
        "t_dispatch",
        "lane_key",
        "h2d_bytes",
        "event",
        "host",
    )

    def __init__(
        self,
        flush_id: int,
        kernel: str,
        bucket: int,
        device_index: int,
        group: List[Any],
        traces: List[Any],
        outputs: Any,
        dtype_locks: Dict[str, Any],
        fn: Any,
        fargs: tuple,
        t_dispatch: float,
        lane_key: Tuple[str, ...] = (),
        h2d_bytes: int = 0,
        event: Any = None,
        host: Any = None,
    ):
        self.flush_id = flush_id
        self.kernel = kernel
        self.bucket = bucket
        self.device_index = device_index
        self.group = group
        self.traces = traces
        self.outputs = outputs
        self.dtype_locks = dtype_locks
        self.fn = fn
        self.fargs = fargs
        self.t_dispatch = t_dispatch
        # padded lane membership this flight's outputs were computed
        # for (the resident carry bank's slot layout) + the staged
        # input bytes its formation materialized (transfer telemetry,
        # accounted at harvest so shed flights never count)
        self.lane_key = tuple(lane_key)
        self.h2d_bytes = int(h2d_bytes)
        # the CUDA event recorded after the update and after the
        # non-blocking copy of the response rows into pinned host
        # memory (``host``); None on the CPU, where the work is done
        # when the call returns
        self.event = event
        self.host = host

    @property
    def series(self) -> List[str]:
        return [p[0] for p in self.group]


class InFlightTable:
    """FIFO table of :class:`Flight`\\ s with the in-flight series
    guard and depth accounting. Thread-safe; the lock is a LEAF
    (nothing blocking, no foreign locks, no callbacks under it)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: "OrderedDict[int, Flight]" = OrderedDict()
        # series -> reference count of flights carrying it (a padded
        # lane repeats a series inside ONE flight; across flights the
        # guard defers re-dispatch, so counts are 1 in practice — the
        # refcount keeps the set correct even if that changes)
        self._series: Dict[str, int] = {}
        self._next_id = 0
        self._peak_depth = 0
        self._dispatched = 0
        self._harvested = 0

    def next_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def add(self, flight: Flight) -> None:
        with self._lock:
            self._flights[flight.flush_id] = flight
            for s in set(flight.series):
                self._series[s] = self._series.get(s, 0) + 1
            self._dispatched += 1
            if len(self._flights) > self._peak_depth:
                self._peak_depth = len(self._flights)

    def pop_oldest(self) -> Optional[Flight]:
        """Remove and return the oldest flight (dispatch order), or
        ``None`` when nothing is in flight. The caller waits on and
        commits it OUTSIDE this table's lock."""
        with self._lock:
            if not self._flights:
                return None
            _, flight = self._flights.popitem(last=False)
            for s in set(flight.series):
                n = self._series.get(s, 0) - 1
                if n <= 0:
                    self._series.pop(s, None)
                else:
                    self._series[s] = n
            self._harvested += 1
            return flight

    def guarded(self, series_id: str) -> bool:
        """True while ``series_id`` has an un-harvested flight — its
        next tick must wait (fold-order guard)."""
        with self._lock:
            return series_id in self._series

    def series_in_flight(self) -> set:
        with self._lock:
            return set(self._series)

    def depth(self) -> int:
        with self._lock:
            return len(self._flights)

    def stats(self) -> Dict[str, int]:
        """JSON-ready table counters for the pipeline stanza."""
        with self._lock:
            return {
                "depth": len(self._flights),
                "peak_depth": self._peak_depth,
                "dispatched": self._dispatched,
                "harvested": self._harvested,
            }
