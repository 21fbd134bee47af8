"""Process-wide structured metrics registry: the statistical health
plane (counterpart of ``hhmm_tpu/obs/metrics.py``).

Spans (`obs/trace.py`) say where the time went; this module is the sink
for the statistics a run emits — a fit silently diverging or a chain
quarantine storm look like a healthy run until the final summary
otherwise:

- **Counters** — monotone totals (transitions, divergences, chains,
  quarantined chains). ``inc(n)``.
- **Gauges** — last-written values (interim split-R̂ per fit chunk).
  ``set(v)``.
- **Histograms** — fixed-bucket distributions. Fixed edges mean
  constant memory and mergeability across instruments and processes;
  quantiles read conservatively from the upper edge of the containing
  bucket.

Instruments are keyed by ``(name, sorted(labels))`` — the Prometheus
data model — and read back as one deterministic :func:`snapshot`
(sorted keys, JSON-ready), an atomic JSONL export, or Prometheus text
exposition; the formats are the JAX module's, byte for byte, so
``scripts/obs_report.py`` reads either package's exports.

Disciplines inherited from `obs/trace.py`:

1. **Near-zero overhead when disabled.** The accessor fast path
   (``counter(name)`` / ``gauge`` / ``histogram``) returns one shared
   no-op singleton while the plane is disabled — no allocation, no
   dict lookup, no lock. Enablement follows the tracer
   (``HHMM_TPU_TRACE=1`` / ``trace.enable()``) unless overridden with
   :func:`enable`/:func:`disable` — one flag lights up the whole
   observability stack.
2. **Atomic writes.** Exports go through
   :func:`hhmm_tpu_torch.obs.trace.atomic_write_text`.
3. **Weakref attachment for always-on product metrics.** A component
   that must record regardless of the trace flag owns its instruments
   and :func:`attach`-es them under a stable name; the registry holds
   weakrefs only, merging same-key instruments at snapshot time
   (counters sum, gauges max — watermark semantics — histograms merge
   counts when their edges match).
4. **No sync while disabled.** :func:`record_sampler_health` reads its
   tensors on the host only while the plane is enabled, once, at the
   sampler's host boundary.

NumPy only; torch is read only where a sampler hands tensors over.
"""

from __future__ import annotations

import json
import math
import threading
import weakref
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from hhmm_tpu_torch.obs.trace import atomic_write_text
from hhmm_tpu_torch.obs.trace import tracer as _tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
    "counter",
    "gauge",
    "histogram",
    "attach",
    "enabled",
    "enable",
    "disable",
    "use_env",
    "reset",
    "snapshot",
    "export_jsonl",
    "to_prometheus",
    "export_prometheus",
    "record_sampler_health",
    "default_latency_edges",
]

# one lock for all instrument mutation: contention is negligible at the
# emission rates here (host boundaries, not scan bodies) and it keeps
# increments correct under the scheduler's threaded consumers
_LOCK = threading.Lock()


class _NullInstrument:
    """Shared no-op instrument: the disabled-mode fast path. One
    module-level instance answers every accessor call while the plane
    is off, so hot paths allocate nothing (callers may rely on
    ``counter(a) is gauge(b)`` there — mirrors `obs/trace.py`'s
    ``_NULL_SPAN``)."""

    __slots__ = ()

    def inc(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v, n=1) -> None:
        pass

    def get(self):
        return 0


_NULL_INSTRUMENT = _NullInstrument()


class Counter:
    """Monotone total. ``inc`` accepts floats (e.g. busy seconds)."""

    __slots__ = ("value", "__weakref__")
    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        with _LOCK:
            self.value += n

    def get(self):
        return self.value

    def reset(self) -> None:
        with _LOCK:
            self.value = 0

    def state(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value (NaN until first ``set``)."""

    __slots__ = ("value", "__weakref__")
    kind = "gauge"

    def __init__(self):
        self.value = float("nan")

    def set(self, v) -> None:
        with _LOCK:
            self.value = float(v)

    def get(self) -> float:
        return self.value

    def reset(self) -> None:
        with _LOCK:
            self.value = float("nan")

    def state(self) -> Dict[str, Any]:
        v = self.value
        # JSON-safe: a bare NaN/Infinity token breaks strict consumers
        # of the exports
        return {
            "type": "gauge",
            "value": v if math.isfinite(v) else None if math.isnan(v) else str(v),
        }


def default_latency_edges() -> np.ndarray:
    """1 µs .. 60 s log-spaced — generous at both ends (CPU runs sit
    in the ms range, a kernel in the µs range). The JAX package's
    edges, shared so merged exports line up."""
    return np.geomspace(1e-6, 60.0, 48)


class Histogram:
    """Fixed-bucket histogram: constant memory, mergeable (same edges
    ⇒ counts add). ``counts`` has ``len(edges) + 1`` slots — the last
    is the unbounded overflow bucket beyond the final edge."""

    __slots__ = ("edges", "counts", "total", "sum", "__weakref__")
    kind = "histogram"

    def __init__(self, edges: Optional[Sequence[float]] = None):
        self.edges = np.asarray(
            edges if edges is not None else default_latency_edges(), dtype=float
        )
        if self.edges.ndim != 1 or len(self.edges) < 1:
            raise ValueError(f"edges must be a 1-D sequence, got {self.edges.shape}")
        if np.any(np.diff(self.edges) <= 0):
            raise ValueError("histogram edges must be strictly increasing")
        self.counts = np.zeros(len(self.edges) + 1, dtype=np.int64)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float, n: int = 1) -> None:
        with _LOCK:
            self.counts[int(np.searchsorted(self.edges, v))] += n
            self.total += n
            self.sum += float(v) * n

    def quantile(self, q: float) -> float:
        """Conservative quantile (upper edge of the containing bucket).

        Edge contract, pinned in ``tests/test_obs.py``: an empty
        histogram returns ``nan`` (no data is not zero latency); a
        quantile landing in the unbounded overflow bucket returns
        ``inf`` (a pathological tail must read as pathological, not as
        the largest edge); ``q=0`` reads the first non-empty bucket
        (the minimum observation's upper edge), ``q=1`` the last
        non-empty one."""
        if self.total == 0:
            return float("nan")
        cum = np.cumsum(self.counts)
        # target >= one observation so q=0 lands on the first NON-EMPTY
        # bucket instead of the histogram's smallest edge
        target = max(q * self.total, np.finfo(float).tiny)
        idx = int(np.searchsorted(cum, target, side="left"))
        if idx >= len(self.edges):
            return float("inf")
        return float(self.edges[idx])

    def reset(self) -> None:
        with _LOCK:
            self.counts[:] = 0
            self.total = 0
            self.sum = 0.0

    def merge_from(self, other: "Histogram") -> None:
        if not np.array_equal(self.edges, other.edges):
            raise ValueError("cannot merge histograms with different edges")
        with _LOCK:
            self.counts += other.counts
            self.total += other.total
            self.sum += other.sum

    def state(self) -> Dict[str, Any]:
        return {
            "type": "histogram",
            "edges": [float(e) for e in self.edges],
            "counts": [int(c) for c in self.counts],
            "count": int(self.total),
            "sum": float(self.sum),
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _labels_key(labels: Mapping[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_key(name: str, lkey: Tuple[Tuple[str, str], ...]) -> str:
    if not lkey:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in lkey) + "}"


class MetricsRegistry:
    """See module docstring. One process-wide instance
    (:data:`registry`); tests construct their own with an explicit
    ``enabled`` override."""

    def __init__(self, enabled: Optional[bool] = None):
        self._lock = threading.Lock()
        # (name, labels_key) -> owned instrument
        self._owned: Dict[Tuple[str, Tuple], Any] = {}
        # (name, labels_key) -> list of weakrefs to attached instruments
        self._attached: Dict[Tuple[str, Tuple], List[weakref.ref]] = {}
        # None -> follow the tracer's flag (HHMM_TPU_TRACE / enable());
        # True/False -> explicit override
        self._enabled = enabled

    # ---- enablement ----

    def enabled(self) -> bool:
        if self._enabled is not None:
            return self._enabled
        return _tracer.enabled()

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def use_env(self) -> None:
        """Drop any explicit override and follow the tracer's flag
        again (which itself reads ``HHMM_TPU_TRACE``)."""
        self._enabled = None

    # ---- gated accessors (the hot-path API) ----

    def _get(self, kind: str, name: str, labels: Mapping[str, Any], edges=None):
        if not self.enabled():
            return _NULL_INSTRUMENT
        key = (name, _labels_key(labels))
        with self._lock:
            inst = self._owned.get(key)
            if inst is None:
                inst = self._owned[key] = (
                    Histogram(edges) if kind == "histogram" else _KINDS[kind]()
                )
            elif inst.kind != kind:
                raise ValueError(
                    f"metric {_render_key(name, key[1])!r} already registered "
                    f"as a {inst.kind}, requested as a {kind}"
                )
            return inst

    def counter(self, name: str, **labels):
        """Get-or-create the labeled counter (the shared no-op
        singleton while disabled — one attribute read + one ``if``)."""
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels):
        return self._get("gauge", name, labels)

    def histogram(self, name: str, edges=None, **labels):
        return self._get("histogram", name, labels, edges=edges)

    # ---- always-on attachment (product metrics) ----

    def attach(self, name: str, instrument, **labels) -> None:
        """Register a component-owned instrument under ``name`` —
        weakref only (attachment never extends the component's
        lifetime), always visible in :meth:`snapshot` regardless of the
        enabled flag. Several instruments under one key merge
        (counters sum, gauges max, histograms add matching-edge
        counts) — the label identifies a component, not an instance,
        exactly like `telemetry.scope_counts`."""
        key = (name, _labels_key(labels))
        with self._lock:
            refs = self._attached.setdefault(key, [])
            refs[:] = [r for r in refs if r() is not None]
            refs.append(weakref.ref(instrument))

    # ---- reading ----

    def _entries(
        self,
    ) -> List[Tuple[str, Tuple[Tuple[str, str], ...], Dict[str, Any]]]:
        """Merged instrument view with structured labels, sorted by
        rendered key: ``[(name, labels_key, state), ...]``. Owned
        instruments first-class; attached instruments merged per key.
        Never raises — a mismatched-edge attached histogram is reported
        under a ``shard`` label rather than wedging telemetry. The
        exporters consume this directly so label values never make a
        lossy string round-trip through the rendered key."""
        with self._lock:
            owned = {k: inst for k, inst in self._owned.items()}
            attached = {
                k: [r() for r in refs if r() is not None]
                for k, refs in self._attached.items()
            }
        entries: Dict[Tuple[str, Tuple], Dict[str, Any]] = {}
        for (name, lkey), inst in owned.items():
            entries[(name, lkey)] = inst.state()
        for (name, lkey), insts in attached.items():
            insts = [i for i in insts if i is not None]
            if not insts:
                continue
            merged: Optional[Any] = None
            shard = 0
            for inst in insts:
                if merged is None:
                    merged = self._clone(inst)
                    continue
                try:
                    self._merge(merged, inst)
                except ValueError:  # mismatched histogram edges
                    shard += 1
                    entries[(name, lkey + (("shard", str(shard)),))] = inst.state()
            if merged is not None:
                key = (name, lkey)
                if key in entries:  # an owned instrument shares the key
                    key = (name, lkey + (("attached", "1"),))
                entries[key] = merged.state()
        return sorted(
            ((name, lkey, state) for (name, lkey), state in entries.items()),
            key=lambda e: _render_key(e[0], e[1]),
        )

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Deterministic JSON-ready state: ``{rendered_key: state}``
        sorted by key (see :meth:`_entries`)."""
        return {
            _render_key(name, lkey): state for name, lkey, state in self._entries()
        }

    @staticmethod
    def _clone(inst):
        if inst.kind == "histogram":
            c = Histogram(inst.edges)
            c.counts = inst.counts.copy()
            c.total, c.sum = inst.total, inst.sum
            return c
        c = _KINDS[inst.kind]()
        c.value = inst.value
        return c

    @staticmethod
    def _merge(acc, inst) -> None:
        if acc.kind != inst.kind:
            raise ValueError("mismatched instrument kinds under one key")
        if acc.kind == "counter":
            acc.value += inst.value
        elif acc.kind == "gauge":
            # watermark semantics: the worst (largest) live value wins
            v = inst.value
            if math.isnan(acc.value) or (not math.isnan(v) and v > acc.value):
                acc.value = v
        else:
            acc.merge_from(inst)

    def reset(self) -> None:
        """Test hook: drop owned instruments and attachment refs."""
        with self._lock:
            self._owned.clear()
            self._attached.clear()

    # ---- exports ----

    def export_jsonl(self, path: str) -> int:
        """One instrument per line (``{"key", "name", "labels", ...
        state}``), sorted by rendered key; atomic write. Returns the
        number of lines."""
        lines = [
            json.dumps(
                {
                    "key": _render_key(name, lkey),
                    "name": name,
                    "labels": dict(lkey),
                    **state,
                }
            )
            for name, lkey, state in self._entries()
        ]
        atomic_write_text(path, "".join(line + "\n" for line in lines))
        return len(lines)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4): ``# TYPE``
        lines, sanitized names, histograms as cumulative ``_bucket``
        series with ``le`` labels plus ``_sum``/``_count``."""

        def sanitize(name: str) -> str:
            return "".join(
                c if c.isalnum() or c == "_" else "_" for c in name
            )

        def fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
            parts = [f'{sanitize(k)}="{v}"' for k, v in labels.items()]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        out: List[str] = []
        typed: set = set()
        for name, lkey, state in self._entries():
            labels = dict(lkey)
            pname = sanitize(name)
            if pname not in typed:
                out.append(f"# TYPE {pname} {state['type']}")
                typed.add(pname)
            if state["type"] == "histogram":
                cum = 0
                for edge, c in zip(state["edges"], state["counts"]):
                    cum += c
                    le = 'le="%g"' % edge
                    out.append(f"{pname}_bucket{fmt_labels(labels, le)} {cum}")
                cum += state["counts"][-1]
                inf_le = 'le="+Inf"'
                out.append(f"{pname}_bucket{fmt_labels(labels, inf_le)} {cum}")
                out.append(f"{pname}_sum{fmt_labels(labels)} {state['sum']:g}")
                out.append(f"{pname}_count{fmt_labels(labels)} {state['count']}")
            else:
                v = state["value"]
                v = "NaN" if v is None else v
                out.append(f"{pname}{fmt_labels(labels)} {v}")
        return "\n".join(out) + ("\n" if out else "")

    def export_prometheus(self, path: str) -> None:
        atomic_write_text(path, self.to_prometheus())


# the process-wide registry every hhmm_tpu_torch module shares
registry = MetricsRegistry()

counter = registry.counter
gauge = registry.gauge
histogram = registry.histogram
attach = registry.attach
enabled = registry.enabled
enable = registry.enable
disable = registry.disable
use_env = registry.use_env
reset = registry.reset
snapshot = registry.snapshot
export_jsonl = registry.export_jsonl
to_prometheus = registry.to_prometheus
export_prometheus = registry.export_prometheus


def _host(value) -> np.ndarray:
    """``value`` as a host array: a tensor is detached and copied to the
    host (one synchronising copy for a CUDA tensor), anything else goes
    through ``np.asarray``."""
    if hasattr(value, "detach") and hasattr(value, "cpu"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def record_sampler_health(sampler: str, stats: Mapping[str, Any]) -> None:
    """Counter emission at a sampler's host boundary: transitions and
    divergences (``stats["diverging"]``: the NUTS ΔH > 1000 rule,
    ChEES's analog, all False for Gibbs) and chains and quarantined
    chains (``stats["chain_healthy"]``, the `robust/` health mask).

    A no-op unless the plane is enabled, and then it returns before it
    touches ``stats``: a disabled plane forces no host copy and no
    sync. Enabled, each of the two tensors is copied to the host once.
    Nothing is swallowed: the port's samplers hand over concrete
    tensors, and a device error surfacing at the copy is a fault."""
    if not registry.enabled():
        return
    div = stats.get("diverging")
    if div is not None:
        div = _host(div)
        counter("infer.transitions", sampler=sampler).inc(int(div.size))
        counter("infer.divergences", sampler=sampler).inc(int(div.sum()))
    healthy = stats.get("chain_healthy")
    if healthy is not None:
        healthy = _host(healthy).astype(bool)
        counter("infer.chains", sampler=sampler).inc(int(healthy.size))
        counter("infer.quarantined_chains", sampler=sampler).inc(int((~healthy).sum()))
