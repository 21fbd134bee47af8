"""Per-lane chain-health guards, fault injection and the self-healing
policy of ``fit_batched``."""

from hhmm_tpu_torch.robust import faults
from hhmm_tpu_torch.robust.faults import (
    FaultPlan,
    RegimeShiftPlan,
    SimulatedCrash,
    SimulatedDeviceLoss,
    TrafficFaultPlan,
    inject,
)
from hhmm_tpu_torch.robust.guards import all_finite, finite_mask, guard_update, guard_where
from hhmm_tpu_torch.robust.retry import BackoffPolicy, RetryPolicy, escalate, rejitter, retry_call

__all__ = [
    "BackoffPolicy",
    "FaultPlan",
    "RegimeShiftPlan",
    "SimulatedDeviceLoss",
    "TrafficFaultPlan",
    "retry_call",
    "RetryPolicy",
    "SimulatedCrash",
    "all_finite",
    "escalate",
    "faults",
    "finite_mask",
    "guard_update",
    "guard_where",
    "inject",
    "rejitter",
]
