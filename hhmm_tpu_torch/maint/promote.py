"""Atomic promotion: bank the shadow winner, repoint the serving alias,
swap the live scheduler state, in that order (counterpart of
``hhmm_tpu/maint/promote.py``).

The write order is the correctness argument:

1. ``SnapshotRegistry.promote`` saves the candidate under a fresh
   versioned name (an atomic ``.npz``) and atomically repoints the
   ``serving/<series>`` alias: from then on every reader (pager page-ins
   included) resolves to the new posterior, and a crash between the
   steps leaves a consistent registry;
2. ``MicroBatchScheduler.swap_snapshot`` re-attaches the series in place
   through the warm replay of its history tail, resetting the staleness
   clock and keeping tenant bindings and queued ticks, on the shapes of
   any attach (no new dispatch signature on a warmed scheduler).

A rejected swap leaves the old state serving and is reported; the alias
already points at the winner, so the next page-in or swap serves it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from hhmm_tpu_torch.serve.registry import PosteriorSnapshot, SnapshotRegistry

__all__ = ["PromotionResult", "promote_snapshot"]


@dataclass(frozen=True)
class PromotionResult:
    """One promotion attempt. ``swapped``: whether the live scheduler
    state moved; ``versioned_name``: where the winner is banked either
    way."""

    series_id: str
    versioned_name: str
    swapped: bool
    reason: Optional[str] = None  # swap rejection reason, None on success

    def stanza(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "series": self.series_id,
            "version": self.versioned_name,
            "swapped": self.swapped,
        }
        if self.reason is not None:
            out["reason"] = self.reason
        return out


def promote_snapshot(
    scheduler,
    registry: SnapshotRegistry,
    series_id: str,
    snapshot: PosteriorSnapshot,
    history="auto",
) -> PromotionResult:
    """Promote ``snapshot`` to serve ``series_id``: registry first
    (durable, atomic), live swap second (warm replay of the scheduler's
    history tail by default)."""
    versioned = registry.promote(series_id, snapshot)
    # swap the candidate in hand rather than re-reading the archive just
    # written (the registry stays the source for every other reader)
    reason = scheduler.swap_snapshot(series_id, history=history, snapshot=snapshot)
    return PromotionResult(
        series_id=series_id,
        versioned_name=versioned,
        swapped=reason is None,
        reason=reason,
    )
