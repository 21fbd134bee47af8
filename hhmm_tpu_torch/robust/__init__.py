"""Per-lane chain-health guards."""

from hhmm_tpu_torch.robust.guards import all_finite, finite_mask, guard_update, guard_where

__all__ = ["all_finite", "finite_mask", "guard_update", "guard_where"]
