"""Tick-cadence online parameter adaptation (counterpart of
``hhmm_tpu/adapt``).

The serving snapshot's D thinned draws, treated as a per-series
particle cloud (Liu & West 2001, Storvik 2002): per-draw log-weights
updated every tick from the one-step predictive increments the tick
already produces, an ESS-triggered batched Liu–West rejuvenation, and
an escalation ladder that makes the warm refit the last resort —

    reweight (every tick)
      → rejuvenate (on ESS collapse or a first alarm)
        → refit (only when tracking persistently fails).

Layering: ``adapt`` imports ``serve``, ``plan``, ``obs`` and ``core``;
``serve`` never imports ``adapt`` (the scheduler stores the weight
state opaquely), and ``adapt`` never imports ``maint`` (whose loop
routes alarms through :class:`AdaptationLadder`).
"""

from .ladder import AdaptationLadder
from .rejuvenate import Rejuvenator, liu_west_move
from .weights import (
    ess,
    normalized_weights,
    uniform_log_weights,
    uniform_mixture_loglik,
    update_log_weights,
    weighted_mixture_loglik,
    weighted_state_probs,
)

__all__ = [
    "AdaptationLadder",
    "Rejuvenator",
    "liu_west_move",
    "ess",
    "normalized_weights",
    "uniform_log_weights",
    "uniform_mixture_loglik",
    "update_log_weights",
    "weighted_mixture_loglik",
    "weighted_state_probs",
]
