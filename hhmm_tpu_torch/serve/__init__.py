"""Streaming inference service (counterpart of ``hhmm_tpu/serve``):
online forward-filter serving (``serve/online.py``), the posterior
snapshot registry (``serve/registry.py``), the micro-batching tick
scheduler (``serve/scheduler.py``), its lanes, pager, events and
metrics.

A fit (``batch/fit.py``) → ``snapshot_from_fit`` banks it as a servable
artifact (the JAX package's ``.npz`` format, so snapshots move between
the packages) → ``MicroBatchScheduler.attach`` loads it (optionally
warm-started from recorded history) → per-tick ``submit`` / ``flush``
advances every stream's filter in O(K²) in bucketed dispatches on the
card (``device=None``) or, when asked, on the CPU (``device="cpu"``).
"""

from hhmm_tpu_torch.serve.events import RegimeEvent, RegimeEventFeed
from hhmm_tpu_torch.serve.lanes import CarryBank, LaneTable
from hhmm_tpu_torch.serve.metrics import ServeMetrics, SLOSpec, evaluate_slo
from hhmm_tpu_torch.serve.pager import (
    SnapshotPager,
    resolve_budget_bytes,
    snapshot_nbytes,
)
from hhmm_tpu_torch.serve.online import (
    LoglikCUSUM,
    RegimeDetector,
    StreamState,
    filter_scan,
    posterior_predictive_mean,
    predictive_state_logprobs,
    stream_init,
    stream_step,
)
from hhmm_tpu_torch.serve.registry import (
    SNAPSHOT_VERSION,
    PosteriorSnapshot,
    SnapshotRegistry,
    build_model,
    model_spec,
    snapshot_from_fit,
)
from hhmm_tpu_torch.serve.scheduler import (
    AdmissionPolicy,
    MicroBatchScheduler,
    TickResponse,
)

__all__ = [
    "CarryBank",
    "LaneTable",
    "RegimeEvent",
    "RegimeEventFeed",
    "ServeMetrics",
    "SLOSpec",
    "evaluate_slo",
    "SnapshotPager",
    "resolve_budget_bytes",
    "snapshot_nbytes",
    "AdmissionPolicy",
    "LoglikCUSUM",
    "RegimeDetector",
    "StreamState",
    "filter_scan",
    "posterior_predictive_mean",
    "predictive_state_logprobs",
    "stream_init",
    "stream_step",
    "SNAPSHOT_VERSION",
    "PosteriorSnapshot",
    "SnapshotRegistry",
    "build_model",
    "model_spec",
    "snapshot_from_fit",
    "MicroBatchScheduler",
    "TickResponse",
]
