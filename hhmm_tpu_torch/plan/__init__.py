"""Placement planner (counterpart of ``hhmm_tpu/plan/``): one decision
of series, chain and sequence splits over devices, chunk size, serving
bucket ladder and time-parallel branch, recorded in the run manifest.
``batch/fit.py`` places its shards through it."""

from hhmm_tpu_torch.plan.planner import (
    MIN_SP_CHUNK,
    Plan,
    WorkloadShape,
    make_plan,
    plan_for_mesh,
)

__all__ = [
    "MIN_SP_CHUNK",
    "Plan",
    "WorkloadShape",
    "make_plan",
    "plan_for_mesh",
]
