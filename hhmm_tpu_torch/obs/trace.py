"""Lightweight span tracer: where does the wall-clock go? (counterpart
of ``hhmm_tpu/obs/trace.py``)

The port's fits are host-bound: a sweep or a leapfrog is a few
milliseconds of PyTorch ops around a fraction of a millisecond of
kernels. This layer attributes that time. CUDA launches are
asynchronous, so a naive ``t1 - t0`` around a call measures the host's
enqueue, not the card's work; a span that must cover device time says
so with ``sp.sync(out)``.

Design constraints, in order (the JAX module's):

1. **Near-zero overhead when disabled.** ``span()`` on a disabled
   tracer returns one shared no-op singleton — no allocation, no clock
   read, no lock. The hot paths (`infer/`, `batch/`, `kernels/`) call
   it unconditionally and pay one attribute read and one ``if`` per
   span site.
2. **Monotonic clock only.** Every duration comes from
   ``time.perf_counter()`` (re-exported here as :data:`perf_counter`).
3. **Honest device time.** A span measures host time. ``sp.sync(out)``
   synchronises every CUDA device that holds a tensor of ``out`` (only
   while tracing is enabled; the disabled span's ``sync`` never blocks),
   so the span then covers the card's work. Unlike the JAX module's,
   it does not swallow an error: a CUDA error that surfaces at the sync
   is a kernel fault and raises. A value with no CUDA tensor passes
   through untouched.
4. **Thread-safe, nestable.** The span stack is thread-local (each
   thread nests independently); the event log append is lock-guarded.
5. **Bounded memory while enabled.** The raw event log is a bounded
   window (``max_events``, oldest dropped first — :meth:`Tracer.dropped`
   counts them) and the aggregate table is kept streaming with exact
   count/total/max plus a deterministically stride-decimated duration
   sample (``sample_cap`` per name) for the percentiles.

Exports: a JSONL event stream (one dict per completed span, in
completion order; the bounded window) and an aggregated per-span table
(count/total/p50/p99) — the table lands in the run manifest
(`obs/manifest.py`).

Turn it on process-wide with ``HHMM_TPU_TRACE=1`` (the JAX package's
variable, so a run is configured alike in both packages) or
programmatically with :func:`enable`.
"""

from __future__ import annotations

import functools
import json
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "Tracer",
    "tracer",
    "perf_counter",
    "span",
    "event",
    "traced",
    "enabled",
    "enable",
    "disable",
    "reset",
    "events",
    "dropped",
    "aggregate",
    "export_jsonl",
    "atomic_write_text",
]

# the canonical monotonic timing read of the package: import THIS, not
# time.time (a wall-clock step corrupts throughput records)
perf_counter = time.perf_counter

_ENV_FLAG = "HHMM_TPU_TRACE"
# compared case-insensitively: HHMM_TPU_TRACE=off / FALSE / No must
# DISABLE tracing — misreading a disable as an enable would silently
# flip the samplers from async dispatch to blocking sync boundaries
_FALSY = frozenset(("", "0", "false", "no", "off"))


class _NullSpan:
    """Shared no-op span: the disabled-mode fast path. One module-level
    instance is returned from every ``span()`` call while tracing is
    off, so the hot paths allocate nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def annotate(self, **meta) -> None:
        pass

    def sync(self, value):
        """No-op passthrough: disabled tracing must never turn an async
        dispatch into a blocking one."""
        return value


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span. Created only while tracing is enabled."""

    __slots__ = ("_tracer", "name", "_t0", "_path", "_meta", "_synced")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self.name = name
        self._t0 = 0.0
        self._path = name
        self._meta: Optional[Dict[str, Any]] = None
        self._synced = False

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        if stack:
            self._path = stack[-1]._path + "/" + self.name
        stack.append(self)
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tracer._clock()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:  # unbalanced exit (generator abandoned mid-span): drop to
            # the nearest matching frame instead of corrupting the stack
            while stack and stack[-1] is not self:
                stack.pop()
            if stack:
                stack.pop()
        self._tracer._record(self, t1 - self._t0)
        return False

    def annotate(self, **meta) -> None:
        """Attach key/value metadata to this span's event record."""
        if self._meta is None:
            self._meta = {}
        self._meta.update(meta)

    def sync(self, value):
        """Synchronise every CUDA device holding a tensor of ``value``
        (tensors nested in tuples, lists and dicts), so the span's
        duration covers device time, then return ``value``. Only ever
        called on a live span — the disabled path returns
        :data:`_NULL_SPAN`, whose ``sync`` never blocks. A CUDA error
        raised by the synchronisation propagates: it is a device fault,
        not telemetry."""
        self._synced = True
        for dev in _cuda_devices(value):
            import torch  # lazy: a value with no CUDA tensor needs none

            torch.cuda.synchronize(dev)
        return value


def _cuda_devices(value) -> list:
    """The distinct CUDA devices of the tensors in ``value`` (nested in
    tuples, lists and dict values), in first-seen order."""
    out: list = []
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, (tuple, list)):
            stack.extend(reversed(v))
        elif isinstance(v, dict):
            stack.extend(reversed(list(v.values())))
        else:
            dev = getattr(v, "device", None)
            if getattr(dev, "type", None) == "cuda" and dev not in out:
                out.append(dev)
    return out


class _NameStats:
    """Streaming per-span-name aggregate: exact count/total/max plus a
    bounded duration sample for percentiles. When the sample outgrows
    its cap, every other element is dropped and the keep-stride doubles
    — a deterministic decimation, so :meth:`Tracer.aggregate` stays
    reproducible for a given duration sequence (and exact while
    ``count <= cap``)."""

    __slots__ = ("count", "total", "max", "sample", "stride", "cap")

    def __init__(self, cap: int):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.sample: List[float] = []
        self.stride = 1
        self.cap = cap

    def update(self, dur_s: float) -> None:
        if self.count % self.stride == 0:
            self.sample.append(dur_s)
            if len(self.sample) > self.cap:
                del self.sample[1::2]
                self.stride *= 2
        self.count += 1
        self.total += dur_s
        if dur_s > self.max:
            self.max = dur_s


class Tracer:
    """Span tracer instance. The module-level :data:`tracer` singleton
    is what the library uses; tests construct their own with an
    injectable clock for deterministic aggregation."""

    def __init__(
        self,
        clock: Callable[[], float] = perf_counter,
        max_events: int = 65536,
        sample_cap: int = 4096,
    ):
        self._clock = clock
        self._lock = threading.Lock()
        # bounded window of raw events (the JSONL stream); a traced
        # serving host runs indefinitely and must not accumulate one
        # dict per tick forever
        self._events: deque = deque(maxlen=max_events)
        self._dropped = 0
        self._stats: Dict[str, _NameStats] = {}
        self._sample_cap = sample_cap
        self._local = threading.local()
        # None -> defer to the environment flag; True/False -> explicit
        # override. The env read is resolved once and cached (the
        # disabled fast path must really be one attribute read + one
        # ``if`` per span site, not an os.environ lookup); use_env()
        # invalidates the cache.
        self._enabled: Optional[bool] = None
        self._env_cache: Optional[bool] = None

    # ---- enablement ----

    def enabled(self) -> bool:
        if self._enabled is not None:
            return self._enabled
        if self._env_cache is None:
            self._env_cache = (
                os.environ.get(_ENV_FLAG, "").strip().lower() not in _FALSY
            )
        return self._env_cache

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def use_env(self) -> None:
        """Drop any explicit override and (re-)read ``HHMM_TPU_TRACE``
        — also the invalidation point after the env var changes
        mid-process (tests do; production sets it before launch)."""
        self._enabled = None
        self._env_cache = None

    # ---- recording ----

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def _record(self, sp: _Span, dur_s: float) -> None:
        ev = {
            "name": sp.name,
            "path": sp._path,
            "dur_s": dur_s,
            "t0": sp._t0,
            "thread": threading.get_ident(),
            "synced": sp._synced,
        }
        if sp._meta:
            ev["meta"] = sp._meta
        with self._lock:
            self._append(ev)

    def _append(self, ev: Dict[str, Any]) -> None:
        """Lock held. Window the raw event and fold it into the
        streaming per-name aggregate."""
        if len(self._events) == self._events.maxlen:
            self._dropped += 1
        self._events.append(ev)
        stats = self._stats.get(ev["name"])
        if stats is None:
            stats = self._stats[ev["name"]] = _NameStats(self._sample_cap)
        stats.update(ev["dur_s"])

    def span(self, name: str):
        """Context manager timing one region. Returns the shared no-op
        singleton when tracing is disabled (the zero-allocation fast
        path — callers may rely on ``span(a) is span(b)`` there)."""
        if not self.enabled():
            return _NULL_SPAN
        return _Span(self, name)

    def event(self, name: str, **meta) -> None:
        """Zero-duration counted event (e.g. a dispatch-branch record):
        shows up in the aggregate table with its count and 0 time."""
        if not self.enabled():
            return
        ev: Dict[str, Any] = {
            "name": name,
            "path": name,
            "dur_s": 0.0,
            "t0": self._clock(),
            "thread": threading.get_ident(),
            "synced": False,
        }
        if meta:
            ev["meta"] = meta
        with self._lock:
            self._append(ev)

    def traced(self, name: Optional[str] = None):
        """Decorator form of :meth:`span`; the disabled path adds one
        attribute read + one ``if`` per call."""

        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                if not self.enabled():
                    return fn(*args, **kwargs)
                with _Span(self, label):
                    return fn(*args, **kwargs)

            return wrapper

        return deco

    # ---- reading ----

    def events(self) -> List[Dict[str, Any]]:
        """The retained raw-event window (oldest first). Long traced
        runs drop their oldest events — :meth:`dropped` counts them;
        :meth:`aggregate` still covers every span ever recorded."""
        with self._lock:
            return list(self._events)

    def dropped(self) -> int:
        """Raw events evicted from the bounded window so far."""
        with self._lock:
            return self._dropped

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._stats.clear()
            self._dropped = 0

    def aggregate(self) -> Dict[str, Dict[str, Any]]:
        """Per-span-name table: count, total seconds, p50/p99/max
        milliseconds. Count/total/max are exact over the whole run
        (streaming — unaffected by raw-event eviction); percentiles are
        the order statistic ``sorted[ceil(q*n) - 1]`` over the
        (possibly stride-decimated, see :class:`_NameStats`) duration
        sample — no interpolation, deterministic for a given duration
        sequence, exact while a name has ≤ ``sample_cap`` spans. Sorted
        by total time, descending, so the table reads hottest-first."""
        with self._lock:
            snap = [
                (name, st.count, st.total, st.max, list(st.sample))
                for name, st in self._stats.items()
            ]
        table = {}
        for name, count, total, mx, sample in snap:
            sample.sort()
            n = len(sample)

            def pct(q: float) -> float:
                return sample[max(0, math.ceil(q * n) - 1)]

            table[name] = {
                "count": count,
                "total_s": round(total, 6),
                "p50_ms": round(pct(0.50) * 1e3, 4),
                "p99_ms": round(pct(0.99) * 1e3, 4),
                "max_ms": round(mx * 1e3, 4),
            }
        return dict(
            sorted(table.items(), key=lambda kv: -kv[1]["total_s"])
        )

    def export_jsonl(self, path: str) -> int:
        """Write the event stream as JSON Lines (one completed span per
        line, completion order). Returns the number of lines written.
        The write is atomic (:func:`atomic_write_text`) — a crashed
        exporter must not leave a torn stream that poisons a later
        analysis pass."""
        evs = self.events()
        atomic_write_text(path, "".join(json.dumps(ev) + "\n" for ev in evs))
        return len(evs)


def atomic_write_text(path: str, text: str) -> None:
    """Atomic text write: temp in the same directory + fsync +
    ``os.replace``, the `batch/cache.py` discipline. The one shared
    implementation for the obs writers (:meth:`Tracer.export_jsonl`,
    `obs/manifest.py`'s ``write_manifest``) — obs cannot import
    ``batch/`` (import-graph order), but it must not fork the write
    protocol either."""
    tmp = path + f".tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


# the process-wide tracer every hhmm_tpu_torch module shares
tracer = Tracer()

# module-level conveniences bound to the singleton
span = tracer.span
event = tracer.event
traced = tracer.traced
enabled = tracer.enabled
enable = tracer.enable
disable = tracer.disable
reset = tracer.reset
events = tracer.events
dropped = tracer.dropped
aggregate = tracer.aggregate
export_jsonl = tracer.export_jsonl
