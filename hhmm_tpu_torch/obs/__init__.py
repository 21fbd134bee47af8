"""Observability: span tracing, sampler health, run manifests, build and
memory telemetry, and device timing (counterpart of ``hhmm_tpu/obs``).

For any run of the port it answers *where did the time go and what
exactly ran*:

- `obs/trace.py` — ``span("infer.gibbs.sample")`` context manager /
  decorator over ``time.perf_counter()``, thread-safe and nestable, a
  shared no-op while disabled; JSONL event stream + aggregated per-span
  table. ``sp.sync(out)`` synchronises the CUDA devices ``out`` lives
  on, so a span can cover device time. Enabled process-wide by
  ``HHMM_TPU_TRACE=1``.
- `obs/metrics.py` — labeled counters, gauges and fixed-bucket
  histograms (sampler health: transitions, divergences, chains,
  quarantined chains; interim split-R̂ a fit chunk), deterministic
  snapshots, atomic JSONL export, Prometheus text.
- `obs/telemetry.py` — the kernels' ``nvcc`` builds and library loads
  (counts and seconds, reported by ``kernels/cuda_build.py``) and CUDA
  memory watermarks (``torch.cuda.memory_stats``).
- `obs/manifest.py` — run manifests (git revision, torch / CUDA /
  driver versions, the card's name and power limit, config and model
  digests, seed, span table, build counts, peak memory, metrics
  snapshot) written atomically; ``scripts/obs_report.py`` renders them.
- `obs/profile.py` — ``device_time`` (CUDA events on the card, the host
  clock on the CPU), ``PhaseClock``, counted kernel costs
  (``kernel_cost``) with ``roofline`` / ``bound_ms`` against
  :data:`~hhmm_tpu_torch.obs.profile.PEAKS`, and the kernel cost
  database (``KernelCostDB``).

The JAX package's request plane (``obs/request.py``) belongs to the
serving layer and is not part of this package yet.
"""

from hhmm_tpu_torch.obs import manifest, metrics, profile, telemetry, trace
from hhmm_tpu_torch.obs.manifest import (
    MANIFEST_VERSION,
    collect_manifest,
    load_manifest,
    manifest_stanza,
    write_manifest,
)
from hhmm_tpu_torch.obs.telemetry import (
    CompileRegistry,
    install_listeners,
    register_jit,
    telemetry_snapshot,
)
from hhmm_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
)
from hhmm_tpu_torch.obs.trace import Tracer, event, perf_counter, span, traced, tracer

__all__ = [
    "manifest",
    "metrics",
    "profile",
    "telemetry",
    "trace",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "counter",
    "gauge",
    "histogram",
    "MANIFEST_VERSION",
    "collect_manifest",
    "load_manifest",
    "manifest_stanza",
    "write_manifest",
    "CompileRegistry",
    "install_listeners",
    "register_jit",
    "telemetry_snapshot",
    "Tracer",
    "event",
    "perf_counter",
    "span",
    "traced",
    "tracer",
]
