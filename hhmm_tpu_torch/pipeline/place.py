"""Consistent-hash series→device placement for the async flush pipeline
(counterpart of ``hhmm_tpu/pipeline/place.py``).

The planner (``hhmm_tpu_torch/plan``) decides the device list; this
module decides which device of it owns each serving series. Ownership
is **stable** (a series' filter state and paged snapshot stay on its
device), **uniform** (a hash split keeps every device's bucket ladder
evenly loaded without an assignment table) and **shared** (the
scheduler's per-device queues and the pager's per-device residency
partition key off the same :class:`DevicePlacement`).

The hash is ``blake2b`` (keyed by an optional salt) over the series id,
mod the device count — deterministic across processes and Python hash
randomisation. The placement is recorded into the plan stanza
(:meth:`DevicePlacement.record`).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, TypeVar

from hhmm_tpu_torch.obs import manifest as obs_manifest

__all__ = ["DevicePlacement", "placement_for_plan"]

T = TypeVar("T")


class DevicePlacement:
    """Stable consistent-hash series→device assignment over ``n``
    devices. Immutable after construction — every consumer (scheduler
    queues, pager partition, bench stanzas) reads the same mapping."""

    __slots__ = ("n_devices", "salt")

    def __init__(self, n_devices: int, salt: str = ""):
        n = int(n_devices)
        if n <= 0:
            raise ValueError(f"n_devices must be positive, got {n_devices}")
        self.n_devices = n
        self.salt = str(salt)

    def device_of(self, series_id: str) -> int:
        """The owning device index in ``[0, n_devices)`` — pure,
        deterministic, hash-randomization-proof."""
        if self.n_devices == 1:
            return 0
        h = hashlib.blake2b(
            str(series_id).encode("utf-8"),
            digest_size=8,
            key=self.salt.encode("utf-8") if self.salt else b"",
        ).digest()
        return int.from_bytes(h, "big") % self.n_devices

    def split(
        self, items: Sequence[T], key
    ) -> "Dict[int, List[Tuple[int, T]]]":
        """Partition ``items`` by owning device, preserving arrival
        order WITHIN each device and retaining each item's global
        index (``(global_index, item)``) so a caller can re-merge
        unconsumed items back into one arrival-ordered queue."""
        out: Dict[int, List[Tuple[int, T]]] = {}
        for i, it in enumerate(items):
            out.setdefault(self.device_of(key(it)), []).append((i, it))
        return out

    def stanza(self) -> Dict[str, Any]:
        """JSON-ready placement description for the plan stanza."""
        return {
            "algo": "blake2b8-mod",
            "n_devices": int(self.n_devices),
            "salt": self.salt,
        }

    def record(self, plan) -> "DevicePlacement":
        """Re-note the plan stanza with this placement embedded — the
        manifest read is ``manifest["plan"]["placement"]``. The
        pipeline annotates the planner's stanza from ABOVE (plan ranks
        below pipeline and must not know placements exist)."""
        obs_manifest.note_stanza(
            "plan", dict(plan.stanza(), placement=self.stanza())
        )
        return self

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DevicePlacement(n_devices={self.n_devices}, salt={self.salt!r})"


def placement_for_plan(
    plan, salt: str = "", n_devices: Optional[int] = None
) -> DevicePlacement:
    """A placement sized to the plan's device count, clamped to the
    devices there are: the plan's ``device_list()`` (which may repeat
    ``cpu`` as logical devices), or without a plan this host's CUDA
    devices (one on a host without a card). ``n_devices`` overrides the
    plan's count (``None`` = the plan's)."""
    if n_devices is None:
        n_devices = int(plan.n_devices) if plan is not None else 1
    if plan is not None:
        avail = len(plan.device_list())
    else:
        import torch

        avail = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return DevicePlacement(max(1, min(int(n_devices), max(1, avail))), salt=salt)
