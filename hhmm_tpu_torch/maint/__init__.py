"""Maintenance plane: drift-triggered warm refits, shadow evaluation and
atomic snapshot promotion, the subsystem that closes the train→serve
loop (counterpart of ``hhmm_tpu/maint``).

- ``maint/triggers.py``: :class:`MaintenancePolicy` debounces alarms and
  staleness breaches into :class:`RefitRequest`\\ s;
- ``maint/refit.py``: :func:`warm_refit`, one ``batch/fit.py`` fit over
  the scheduler's history tails, warm-started from the serving
  snapshots' draws;
- ``maint/shadow.py``: :func:`shadow_evaluate`, champion against
  challenger on held-out one-step predictive loglik;
- ``maint/promote.py``: :func:`promote_snapshot`, the versioned registry
  save and alias repoint, then the in-place scheduler swap;
- ``maint/loop.py``: :class:`MaintenanceLoop`, the tick-driven driver.

Layering: ``maint`` imports ``adapt``, ``serve``, ``batch`` and ``obs``;
neither ``serve`` nor ``adapt`` imports ``maint``.
``MaintenanceLoop(..., adapt=AdaptationLadder(...))`` routes CUSUM alarms
through reweight → rejuvenate first; only a persisting alarm escalates
into the refit queue.
"""

from hhmm_tpu_torch.maint.loop import MaintenanceLoop, MaintMetrics
from hhmm_tpu_torch.maint.promote import PromotionResult, promote_snapshot
from hhmm_tpu_torch.maint.refit import split_window, warm_refit
from hhmm_tpu_torch.maint.shadow import (
    ShadowVerdict,
    predictive_logliks,
    shadow_evaluate,
)
from hhmm_tpu_torch.maint.triggers import MaintenancePolicy, RefitRequest

__all__ = [
    "MaintenanceLoop",
    "MaintMetrics",
    "MaintenancePolicy",
    "RefitRequest",
    "PromotionResult",
    "promote_snapshot",
    "ShadowVerdict",
    "predictive_logliks",
    "shadow_evaluate",
    "split_window",
    "warm_refit",
]
