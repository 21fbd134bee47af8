"""Device-resident lane-state plane (counterpart of
``hhmm_tpu/serve/lanes.py``): carry banks and the lane table.

The host-staged scheduler restacks every attached series' filter carry
``(log_alpha, loglik, ok)`` into fresh ``[B, D, K]`` dispatch tensors on
every flush. This module keeps the carry where the tick left it: each
successful dispatch's padded outputs become a :class:`CarryBank` (live
tensors on the card, one slot a lane) and the :class:`LaneTable` maps
``series_id -> (bank, slot)``. The next flush with the same lane
membership passes the bank's tensors straight back to the tick; churn
regroups with one ``index_select`` (a single source bank) or a stack of
bank rows (mixed sources). The scheduler slices bank rows back into its
records only where it needs record state (detach, ``swap_snapshot``,
``replace_draw_bank``, ``filter_state_of``, ``state()``).

Contracts:

- **banks are immutable**: no op writes into a bank tensor in place
  (there is no donation in the port); an update reads one bank and
  commits a NEW bank, and a regroup is an ``index_select`` into a fresh
  tensor. A live bank may be the only copy of its series' state, and a
  dispatch can still fail before it commits.
- **commit supersedes atomically**: committing a bank remaps its series
  under one lock acquisition; superseded banks are released when their
  last slot is remapped (refcounted).
- **leaf lock**: the table's lock guards only its own dicts — no torch
  op, no I/O, no callback runs under it. Bank-row slicing happens
  outside the lock on the ``(bank, slot)`` references a lookup
  returned.
- **incremental byte accounting**: ``resident_bytes`` / slots track the
  live banks without walking the table (the
  ``serve.carry_resident_bytes`` gauge and the planner's
  ``carry_slots_cap``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["CarryBank", "LaneTable"]


class CarryBank:
    """One dispatch's padded carry output, kept live on device:
    ``alpha [B, D, K]``, ``ll [B, D]``, ``ok [B, D]`` plus the lane
    membership it was computed for. Immutable — an update dispatch
    reads slots from one bank and commits a NEW bank; the table frees
    superseded banks by refcount."""

    __slots__ = ("alpha", "ll", "ok", "lane_key", "device_index",
                 "nbytes", "seq")

    def __init__(
        self,
        alpha: Any,
        ll: Any,
        ok: Any,
        lane_key: Tuple[str, ...],
        device_index: int = 0,
    ):
        self.alpha = alpha
        self.ll = ll
        self.ok = ok
        self.lane_key = tuple(lane_key)
        self.device_index = int(device_index)
        # shape metadata only — reading .nbytes never syncs the device
        self.nbytes = int(
            getattr(alpha, "nbytes", 0)
            + getattr(ll, "nbytes", 0)
            + getattr(ok, "nbytes", 0)
        )
        self.seq = 0  # assigned by LaneTable.commit (LRU order)

    @property
    def slots(self) -> int:
        return len(self.lane_key)


class LaneTable:
    """``series_id -> (CarryBank, slot)`` with refcounted bank
    lifetimes and incremental byte/slot accounting. Thread-safe; the
    lock is a LEAF in the lock-order DAG (no torch op, no I/O, no
    callbacks under it)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._map: Dict[str, Tuple[CarryBank, int]] = {}
        # live banks in commit order (the spill path's LRU axis):
        # seq -> (bank, refcount). A bank leaves when its last mapped
        # slot is remapped or dropped.
        self._banks: "OrderedDict[int, List[Any]]" = OrderedDict()
        self._next_seq = 0
        self._resident_bytes = 0
        self._slots = 0
        self._commits = 0
        self._spills = 0

    # ---- internal (lock held) ----

    def _ref(self, bank: CarryBank) -> None:
        ent = self._banks.get(bank.seq)
        if ent is None:
            self._banks[bank.seq] = [bank, 1]
            self._resident_bytes += bank.nbytes
            self._slots += bank.slots
        else:
            ent[1] += 1

    def _unref(self, bank: CarryBank) -> None:
        ent = self._banks.get(bank.seq)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] <= 0:
            del self._banks[bank.seq]
            self._resident_bytes -= bank.nbytes
            self._slots -= bank.slots

    # ---- writing ----

    def commit(self, bank: CarryBank, mapping: Dict[str, int]) -> None:
        """Map ``series_id -> (bank, slot)`` for every entry of
        ``mapping`` in one atomic step, superseding (and possibly
        freeing) whatever banks previously held those series. Padded
        duplicate lanes are the caller's concern — commit only real
        slots."""
        with self._lock:
            self._next_seq += 1
            bank.seq = self._next_seq
            self._commits += 1
            for sid, slot in mapping.items():
                old = self._map.get(sid)
                self._map[sid] = (bank, int(slot))
                self._ref(bank)
                if old is not None:
                    self._unref(old[0])

    def drop(self, series_id: str) -> bool:
        """Forget one series' resident carry (detach / re-attach /
        rejuvenation commit). Returns False when it had none."""
        with self._lock:
            ref = self._map.pop(series_id, None)
            if ref is None:
                return False
            self._unref(ref[0])
            return True

    def release(self, bank: CarryBank, series_ids) -> List[str]:
        """Spill support: drop each series *only if it still maps into
        ``bank``* (a commit may have remapped it since the caller
        picked its spill victims). Returns the series actually
        dropped — the caller has already materialized their rows
        OUTSIDE this lock."""
        dropped: List[str] = []
        with self._lock:
            for sid in series_ids:
                ref = self._map.get(sid)
                if ref is not None and ref[0] is bank:
                    del self._map[sid]
                    self._unref(bank)
                    dropped.append(sid)
            if dropped:
                self._spills += 1
        return dropped

    # ---- reading ----

    def lookup(self, series_id: str) -> Optional[Tuple[CarryBank, int]]:
        with self._lock:
            return self._map.get(series_id)

    def lookup_many(
        self, series_ids
    ) -> List[Optional[Tuple[CarryBank, int]]]:
        """One lock acquisition for a whole lane group (the per-flush
        hot path must not take the lock B times)."""
        with self._lock:
            return [self._map.get(s) for s in series_ids]

    def bank_for(self, lane_key: Tuple[str, ...]) -> Optional[CarryBank]:
        """The zero-staging fast path: the bank whose slot layout IS
        this padded lane membership — every distinct series maps to
        (bank, its first lane index) and the bank was built for
        exactly this ``lane_key`` (padded duplicates included, so
        duplicated tail slots hold bitwise the same carry). ``None``
        means the caller must regroup."""
        if not lane_key:
            return None
        with self._lock:
            ref = self._map.get(lane_key[0])
            if ref is None:
                return None
            bank = ref[0]
            if bank.lane_key != tuple(lane_key):
                return None
            seen: Dict[str, int] = {}
            for i, sid in enumerate(lane_key):
                if sid not in seen:
                    seen[sid] = i
            for sid, i in seen.items():
                r = self._map.get(sid)
                if r is None or r[0] is not bank or r[1] != i:
                    return None
            return bank

    def spill_candidates(
        self, slots_cap: int, protect: Optional[CarryBank] = None
    ) -> List[Tuple[CarryBank, List[Tuple[str, int]]]]:
        """Oldest-first banks to evict so total slots fit under
        ``slots_cap``, never including ``protect`` (the bank a commit
        just created). Returns ``(bank, [(series_id, slot), ...])``
        pairs; the caller materializes the rows outside the lock, then
        :meth:`release`\\ s the mappings."""
        out: List[Tuple[CarryBank, List[Tuple[str, int]]]] = []
        with self._lock:
            if self._slots <= slots_cap:
                return out
            over = self._slots - slots_cap
            by_bank: Dict[int, List[Tuple[str, int]]] = {}
            for sid, (bank, slot) in self._map.items():
                by_bank.setdefault(bank.seq, []).append((sid, slot))
            for seq, (bank, _refs) in self._banks.items():
                if over <= 0:
                    break
                if protect is not None and bank is protect:
                    continue
                out.append((bank, by_bank.get(seq, [])))
                over -= bank.slots
        return out

    def resident_bytes(self) -> int:
        with self._lock:
            return int(self._resident_bytes)

    def stats(self) -> Dict[str, int]:
        """JSON-ready table counters for the carry stanza."""
        with self._lock:
            return {
                "series": len(self._map),
                "banks": len(self._banks),
                "slots": int(self._slots),
                "resident_bytes": int(self._resident_bytes),
                "commits": int(self._commits),
                "spills": int(self._spills),
            }
