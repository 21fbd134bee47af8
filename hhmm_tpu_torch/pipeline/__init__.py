"""Async serving pipeline (counterpart of ``hhmm_tpu/pipeline``):
double-buffered dispatch and per-device fan-out between the planner and
the serving layer. The pipeline never imports ``serve``: flights carry
opaque groups and the scheduler owns every state commit.

- :mod:`hhmm_tpu_torch.pipeline.place` — consistent-hash series→device
  placement (:class:`DevicePlacement`), shared by the scheduler's
  per-device queues and the pager's residency partition.
- :mod:`hhmm_tpu_torch.pipeline.dispatch` — the in-flight flush table
  (:class:`InFlightTable` of :class:`Flight`\\ s): output tensors and a
  CUDA event parked between a non-blocking ``dispatch_async`` and a
  ``harvest`` that waits and commits.
"""

from hhmm_tpu_torch.pipeline.dispatch import Flight, InFlightTable
from hhmm_tpu_torch.pipeline.place import DevicePlacement, placement_for_plan

__all__ = [
    "DevicePlacement",
    "Flight",
    "InFlightTable",
    "placement_for_plan",
]
