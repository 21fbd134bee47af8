"""Process-wide kernel-build and device-memory telemetry (counterpart
of ``hhmm_tpu/obs/telemetry.py``).

Two questions the span tracer (`obs/trace.py`) cannot answer on its
own:

1. **How many times were the kernels built, and how long did it take?**
   The JAX package counts XLA compilations with a ``jax.monitoring``
   listener. The port has no compiler of its own at run time: its cold
   start is ``nvcc`` building each CUDA source of ``kernels/csrc`` and
   ``ctypes`` loading the library (``kernels/cuda_build.py``), which
   reports both here, always (they happen once a source a process).
   :meth:`CompileRegistry.backend_compiles` counts the sources built
   (a library already in ``kernels/_build`` is loaded, not built);
   :meth:`CompileRegistry.compile_seconds` sums the seconds of each
   phase, ``nvcc_build`` and ``library_load``. The port makes no
   ``torch.compile`` call, so there are no such events to count.
   The named-callable registry (:func:`register_jit`: a registered
   callable's ``_cache_size()``, where it has one) is the JAX module's.
   :class:`CompileScope` is a named, externally set count (the serving
   scheduler publishes its signature count through one); the manifest's
   ``scopes`` sums the live scopes per label.

2. **How close did a run get to device memory limits?**
   :func:`sample_memory` reads ``torch.cuda.memory_stats`` on every
   CUDA device this process has initialised — allocated bytes in use
   and at peak, reserved bytes in use and at peak, and the device's
   total memory as ``bytes_limit`` — and folds them into a
   high-watermark that :func:`peak_memory` reports for the run
   manifest. Without a card (or before CUDA is initialised) both are
   ``{}``.

Importing this module touches no CUDA.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List

__all__ = [
    "CompileRegistry",
    "CompileScope",
    "new_scope",
    "scope_counts",
    "registry",
    "install_listeners",
    "note_build",
    "note_load",
    "register_jit",
    "backend_compiles",
    "compile_seconds",
    "jit_cache_sizes",
    "sample_memory",
    "peak_memory",
    "telemetry_snapshot",
    "reset",
]

_BUILD = "nvcc_build"
_LOAD = "library_load"


class CompileScope:
    """A named externally set compile counter, for a component that
    counts its own signatures (the serving scheduler). Scopes register
    with the :class:`CompileRegistry`, so run manifests see every
    component's count."""

    __slots__ = ("label", "_value", "__weakref__")

    def __init__(self, label: str):
        self.label = label
        self._value = 0

    def set(self, n: int) -> None:
        self._value = int(n)

    def get(self) -> int:
        return self._value


class CompileRegistry:
    """See module docstring. One process-wide instance
    (:data:`registry`); tests may construct their own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._event_counts: Dict[str, int] = {}
        self._event_secs: Dict[str, float] = {}
        self._sources: Dict[str, Dict[str, Any]] = {}
        self._jits: Dict[str, List[weakref.ref]] = {}
        self._scopes: List[weakref.ref] = []

    # ---- the kernel builds (kernels/cuda_build.py reports them) ----

    def _note(self, phase: str, name: str, seconds: float) -> None:
        with self._lock:
            self._event_counts[phase] = self._event_counts.get(phase, 0) + 1
            self._event_secs[phase] = self._event_secs.get(phase, 0.0) + float(seconds)
            rec = self._sources.setdefault(name, {})
            rec[phase] = round(rec.get(phase, 0.0) + float(seconds), 4)

    def note_build(self, source: str, seconds: float) -> None:
        """One ``nvcc`` build of ``source`` that took ``seconds``."""
        self._note(_BUILD, source, seconds)

    def note_load(self, source: str, seconds: float) -> None:
        """One ``ctypes`` load of ``source``'s library."""
        self._note(_LOAD, source, seconds)

    def install_listeners(self) -> bool:
        """The builds report themselves, so there is nothing to install;
        kept so a driver reads the same in both packages. Returns True."""
        return True

    def backend_compiles(self) -> int:
        """CUDA sources built by ``nvcc`` in this process."""
        with self._lock:
            return self._event_counts.get(_BUILD, 0)

    def compile_seconds(self) -> Dict[str, float]:
        """Total seconds per phase: ``nvcc_build`` and ``library_load``."""
        with self._lock:
            return {k: round(v, 4) for k, v in self._event_secs.items()}

    def builds(self) -> Dict[str, Dict[str, float]]:
        """Seconds of each phase per source, ``{source: {phase: s}}``."""
        with self._lock:
            return {k: dict(v) for k, v in sorted(self._sources.items())}

    # ---- named callables ----

    def register_jit(self, name: str, fn):
        """Register a callable under ``name`` and return it unchanged;
        its ``_cache_size()`` (where it has one) is read by
        :meth:`jit_cache_sizes`. Weakrefs only; dead refs are pruned on
        registration and on every read."""
        with self._lock:
            refs = self._jits.setdefault(name, [])
            refs[:] = [r for r in refs if r() is not None]
            refs.append(weakref.ref(fn))
        return fn

    def jit_cache_sizes(self) -> Dict[str, int]:
        """Per-name sum of live registered callables' ``_cache_size()``
        (0 for a callable without one). Names whose callables were all
        collected are pruned."""
        out: Dict[str, int] = {}
        with self._lock:
            for name in list(self._jits):
                refs = self._jits[name]
                refs[:] = [r for r in refs if r() is not None]
                if not refs:
                    del self._jits[name]
            items = [(name, list(refs)) for name, refs in self._jits.items()]
        for name, refs in items:
            n = 0
            for ref in refs:
                fn = ref()
                cache_size = getattr(fn, "_cache_size", None)
                if callable(cache_size):
                    n += int(cache_size())
            out[name] = n
        return out

    # ---- externally set scopes ----

    def new_scope(self, label: str) -> CompileScope:
        scope = CompileScope(label)
        with self._lock:
            self._scopes[:] = [r for r in self._scopes if r() is not None]
            self._scopes.append(weakref.ref(scope))
        return scope

    def scope_counts(self) -> Dict[str, int]:
        """Live scopes' counts, summed per label (two schedulers under
        one label add up); dead scopes are pruned on read."""
        out: Dict[str, int] = {}
        with self._lock:
            self._scopes[:] = [r for r in self._scopes if r() is not None]
            refs = list(self._scopes)
        for ref in refs:
            scope = ref()
            if scope is not None:
                out[scope.label] = out.get(scope.label, 0) + scope.get()
        return out

    # ---- lifecycle ----

    def reset(self) -> None:
        """Zero the build counts and drop registrations. For tests."""
        with self._lock:
            self._event_counts.clear()
            self._event_secs.clear()
            self._sources.clear()
            self._jits.clear()
            self._scopes.clear()

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready build-telemetry stanza for the run manifest (the
        JAX stanza's keys, plus ``builds`` per source)."""
        return {
            "backend_compiles": self.backend_compiles(),
            "compile_seconds": self.compile_seconds(),
            "jit_cache_sizes": self.jit_cache_sizes(),
            "scopes": self.scope_counts(),
            "listening": True,
            "builds": self.builds(),
        }


registry = CompileRegistry()

install_listeners = registry.install_listeners
note_build = registry.note_build
note_load = registry.note_load
register_jit = registry.register_jit
backend_compiles = registry.backend_compiles
compile_seconds = registry.compile_seconds
jit_cache_sizes = registry.jit_cache_sizes
new_scope = registry.new_scope
scope_counts = registry.scope_counts


# ---- device memory watermarks ----

_MEM_LOCK = threading.Lock()
_MEM_PEAK: Dict[str, Dict[str, int]] = {}

# torch.cuda.memory_stats keys -> the manifest's names (the JAX names for
# the allocated bytes, which scripts/obs_report.py renders)
_MEM_KEYS = (
    ("allocated_bytes.all.current", "bytes_in_use"),
    ("allocated_bytes.all.peak", "peak_bytes_in_use"),
    ("reserved_bytes.all.current", "reserved_bytes"),
    ("reserved_bytes.all.peak", "peak_reserved_bytes"),
)


def sample_memory() -> Dict[str, Dict[str, int]]:
    """Read ``torch.cuda.memory_stats`` on every CUDA device (``{}``
    without a card, or before this process initialised CUDA: sampling
    never initialises it) and fold the reads into the process
    high-watermark, per device index. Call at phase boundaries."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    out: Dict[str, Dict[str, int]] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        rec = {name: int(stats[key]) for key, name in _MEM_KEYS if key in stats}
        rec["bytes_limit"] = int(torch.cuda.get_device_properties(i).total_memory)
        key = str(i)
        out[key] = rec
        with _MEM_LOCK:
            peak = _MEM_PEAK.setdefault(key, {})
            for k, v in rec.items():
                peak[k] = v if k == "bytes_limit" else max(peak.get(k, 0), v)
    return out


def peak_memory() -> Dict[str, Dict[str, int]]:
    """High-watermark across every :func:`sample_memory` call so far,
    per device index. ``{}`` without a card."""
    with _MEM_LOCK:
        return {k: dict(v) for k, v in _MEM_PEAK.items()}


def telemetry_snapshot() -> Dict[str, Any]:
    """The full telemetry stanza (builds + memory) for manifests."""
    sample_memory()
    return {"compile": registry.snapshot(), "peak_memory": peak_memory()}


def reset() -> None:
    """Test hook: zero the global registry and memory watermarks."""
    registry.reset()
    with _MEM_LOCK:
        _MEM_PEAK.clear()
