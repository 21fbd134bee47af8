"""Memory-budgeted snapshot paging (counterpart of
``hhmm_tpu/serve/pager.py``): an LRU pager over the ``serve/registry.py``
``.npz`` store, so thousands of registered snapshots need not be
resident.

- **load / touch**: a resident snapshot is a hit (moved to MRU); a cold
  one is loaded from the registry — through
  ``robust.faults.snapshot_load_fault``, where the slow-load and
  torn-file faults land — and admitted, evicting cold unpinned entries
  until the byte budget holds.
- **pinning**: series with queued ticks are pinned by the scheduler;
  the pager never evicts a snapshot a pending tick will fold against.
- **eviction** fires a listener (the scheduler's ``detach``), releasing
  the series' draw bank on the card, its stream state and its staleness
  entry. The next submit pages the snapshot back in and re-attaches —
  warm when the scheduler kept the series' history tail, cold
  otherwise.
- **load retry** (``robust.retry.BackoffPolicy`` through
  ``retry_call``): a transient storage fault gets bounded jittered
  retries before the miss degrades to a shed tick
  (``serve.pager_load_retries`` counts them).

Budget (:func:`resolve_budget_bytes`): an explicit ``budget_bytes``
wins; else a fraction of the smallest CUDA device's total memory, read
through ``obs/telemetry.sample_memory``; else a static fallback (the
CPU). ``SnapshotPager(..., device=None)`` means the card and raises
without one; ``device="cpu"`` takes the fallback budget.

Metrics (always-on, attached to the ``obs/metrics.py`` plane):
``serve.pager_loads`` / ``_reloads`` / ``_evictions`` / ``_hits`` /
``_misses`` / ``_budget_overruns`` / ``_load_retries`` /
``_load_coalesced`` and the ``serve.pager_resident_bytes`` gauge;
:meth:`SnapshotPager.stats` is the host-side read.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.obs import metrics as obs_metrics
from hhmm_tpu_torch.obs import telemetry
from hhmm_tpu_torch.robust import faults
from hhmm_tpu_torch.robust.retry import BackoffPolicy, retry_call
from hhmm_tpu_torch.serve.registry import PosteriorSnapshot, SnapshotRegistry

__all__ = ["SnapshotPager", "resolve_budget_bytes", "snapshot_nbytes"]

# static fallback budget where the backend hides memory stats (CPU):
# generous for tests, small enough that a storm scenario can shrink it
DEFAULT_FALLBACK_BUDGET = 256 << 20  # 256 MiB
DEFAULT_BUDGET_FRACTION = 0.25


def snapshot_nbytes(snap: PosteriorSnapshot) -> int:
    """Resident cost of one snapshot: its draw bank. The spec/meta
    dicts are O(100) bytes and deliberately ignored — the draw bank is
    what lands on the device per attached series."""
    return int(np.asarray(snap.draws).nbytes)


def resolve_budget_bytes(
    budget_bytes: Optional[int] = None,
    *,
    fraction: float = DEFAULT_BUDGET_FRACTION,
    fallback_bytes: int = DEFAULT_FALLBACK_BUDGET,
) -> Tuple[int, str]:
    """``(budget, source)``: explicit budget if given; else ``fraction``
    of the smallest device's ``bytes_limit`` from the telemetry memory
    watermarks (``obs/telemetry.sample_memory``, the CUDA devices this
    process has initialised); else the static fallback (the CPU)."""
    if budget_bytes is not None:
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be positive, got {budget_bytes}")
        return int(budget_bytes), "explicit"
    stats = telemetry.sample_memory()
    limits = [rec["bytes_limit"] for rec in stats.values() if "bytes_limit" in rec]
    if limits:
        return max(1, int(fraction * min(limits))), (
            f"{fraction:g} x device bytes_limit watermark"
        )
    return int(fallback_bytes), "static fallback (backend hides memory stats)"


class SnapshotPager:
    """See module docstring.

    **Thread safety**: all residency state — the LRU table, byte accounting,
    pins — is guarded by ``self._lock``, and the slow paths keep to
    these rules:

    - registry ``.npz`` loads and the traffic-fault surface (which
      injects *sleeps* and torn files) run OUTSIDE the lock
      (held-lock-escape): a cold page-in must never stall every other
      thread's hit path behind disk latency;
    - the eviction listener (the scheduler's ``detach``) fires AFTER
      the lock is released — it calls straight back into
      :meth:`discard`, which under a held non-reentrant lock is a
      guaranteed self-deadlock (exactly what ``lock-order`` flags);
    - metric publication happens outside the lock so the pager's node
      in the lock-order DAG stays a leaf.

    Consistency contract under concurrency: because the listener fires
    after residency is released, a racing ``touch`` may re-admit a
    just-evicted name before its ``detach`` lands; the scheduler's
    detach/attach paths are idempotent per series, so the race costs a
    redundant cold re-attach, never a torn table."""

    def __init__(
        self,
        registry: SnapshotRegistry,
        budget_bytes: Optional[int] = None,
        *,
        budget_fraction: float = DEFAULT_BUDGET_FRACTION,
        fallback_budget_bytes: int = DEFAULT_FALLBACK_BUDGET,
        load_retry: Optional[BackoffPolicy] = None,
        retry_sleep: Optional[Callable[[float], None]] = None,
        device: DeviceLike = None,
    ):
        """``load_retry``: backoff policy for transient load faults
        (``None`` = the :class:`BackoffPolicy` defaults, 3 attempts);
        ``retry_sleep``: injectable sleep for the backoff (tests drive
        the heal — e.g. a concurrent re-save — without wall-clock).
        ``device``: where the paged snapshots are served (None: the
        card, raising without one; ``"cpu"``: the fallback budget)."""
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the budget reads the card's memory watermarks, which exist
            # once this process has initialised CUDA
            torch.cuda.init()
        self.registry = registry
        self._budget_explicit = budget_bytes is not None
        self._budget_fraction = float(budget_fraction)
        self._fallback_budget_bytes = int(fallback_budget_bytes)
        self.budget_bytes, self.budget_source = resolve_budget_bytes(
            budget_bytes,
            fraction=budget_fraction,
            fallback_bytes=fallback_budget_bytes,
        )
        self.load_retry = (
            load_retry if load_retry is not None else BackoffPolicy()
        )
        self._retry_sleep = retry_sleep
        # guards every table below; see the class docstring for what
        # deliberately happens OUTSIDE it
        self._lock = threading.Lock()
        # name -> (snapshot, nbytes); insertion order IS the LRU order
        self._resident: "OrderedDict[str, Tuple[PosteriorSnapshot, int]]" = (
            OrderedDict()
        )
        self._pinned: set = set()
        self._ever_resident: set = set()
        self._resident_bytes = 0
        self._peak_resident_bytes = 0
        self._on_evict: Optional[Callable[[str], None]] = None
        # in-flight load table (the async pipeline's double-load fix):
        # name -> (Event, [result]) while a cold load is running. Two
        # per-device queues paging the same series in concurrently must
        # collapse to ONE registry .npz read — setdefault-first-writer-
        # wins claims the slot under the lock, the load itself runs
        # OUTSIDE it, racers wait on the event
        # and reuse the winner's result
        self._loading: Dict[str, Tuple[threading.Event, list]] = {}
        # per-device residency partition (async pipeline): the SAME
        # consistent-hash placement the scheduler fans out with
        # (hhmm_tpu_torch/pipeline/place.py), so a snapshot stays resident
        # adjacent to the device that serves it. None = single
        # partition (the historical behavior, bit-for-bit)
        self._placement = None
        self._dev_of: Dict[str, int] = {}
        self._dev_bytes: Dict[int, int] = {}
        # always-on product metrics (the ServeMetrics attach discipline)
        self._loads = obs_metrics.Counter()
        self._reloads = obs_metrics.Counter()
        self._evictions = obs_metrics.Counter()
        self._hits = obs_metrics.Counter()
        self._misses = obs_metrics.Counter()
        self._budget_overruns = obs_metrics.Counter()
        self._load_retries = obs_metrics.Counter()
        self._load_coalesced = obs_metrics.Counter()
        self._resident_gauge = obs_metrics.Gauge()
        for name, inst in (
            ("serve.pager_loads", self._loads),
            ("serve.pager_reloads", self._reloads),
            ("serve.pager_evictions", self._evictions),
            ("serve.pager_hits", self._hits),
            ("serve.pager_misses", self._misses),
            ("serve.pager_budget_overruns", self._budget_overruns),
            ("serve.pager_load_retries", self._load_retries),
            ("serve.pager_load_coalesced", self._load_coalesced),
            ("serve.pager_resident_bytes", self._resident_gauge),
        ):
            obs_metrics.attach(name, inst)

    # ---- wiring ----

    def set_placement(self, placement) -> None:
        """Adopt the async pipeline's series→device placement
        (:class:`hhmm_tpu_torch.pipeline.place.DevicePlacement`): residency
        splits into per-device partitions keyed by the SAME hash the
        scheduler fans flushes out with, each holding an even share of
        the byte budget (``budget_bytes // n_devices``, re-derived on
        :meth:`refresh_budget`). One device's hot tenants can then
        never evict another device's snapshots — eviction pressure is
        as partitioned as the flush fan-out. ``None`` restores the
        single global partition."""
        with self._lock:
            self._placement = placement
            self._dev_of = {}
            self._dev_bytes = {}
            if placement is not None:
                for name, (_, nbytes) in self._resident.items():
                    d = placement.device_of(name)
                    self._dev_of[name] = d
                    self._dev_bytes[d] = self._dev_bytes.get(d, 0) + nbytes

    def set_evict_listener(self, fn: Optional[Callable[[str], None]]) -> None:
        """Called with each evicted name AFTER it leaves the resident
        set (so a listener calling back into :meth:`discard` is a
        no-op, not a recursion). The scheduler installs its ``detach``
        here."""
        self._on_evict = fn

    def refresh_budget(self) -> Tuple[int, str]:
        """Re-resolve a NON-explicit budget from the live device
        ``bytes_limit`` watermarks (`obs/telemetry.sample_memory`) — a
        long-running server whose backend came up after the pager (or
        whose per-device limit changed across a device loss) re-derives
        the budget instead of serving forever on a stale read. An
        explicitly-sized budget is the operator's call and is never
        overridden. Shrinks residency immediately when the new budget
        is tighter. Returns ``(budget_bytes, source)``."""
        if not self._budget_explicit:
            self.budget_bytes, self.budget_source = resolve_budget_bytes(
                None,
                fraction=self._budget_fraction,
                fallback_bytes=self._fallback_budget_bytes,
            )
            self.shrink_to_budget()
        return self.budget_bytes, self.budget_source

    # ---- the load path ----

    def load(self, name: str) -> Optional[PosteriorSnapshot]:
        """Hit-or-load WITHOUT admitting: the resident snapshot (moved
        to MRU), else a registry load — faults injected, corrupt files
        a quarantined miss (``None``). The caller accounts residency
        with :meth:`admit` once it has actually accepted the snapshot —
        the scheduler's page-in path validates the attach first, so a
        rejected attach never leaks unattached residency or evicts an
        attached series on behalf of a snapshot that will not serve."""
        with self._lock:
            entry = self._resident.get(name)
            if entry is not None:
                self._resident.move_to_end(name)
        if entry is not None:
            self._hits.inc()
            return entry[0]
        self._misses.inc()

        def _load_once() -> Optional[PosteriorSnapshot]:
            # promoted series resolve through the serving alias
            # (`SnapshotRegistry.promote`): a paged-out series must
            # come back on its PROMOTED snapshot, not the stale
            # pre-promotion artifact — eviction would otherwise
            # silently undo a refit
            target = self.registry.serving_name(name) or name
            # the traffic-fault surface: slow-load latency (an injected
            # SLEEP) and torn-file corruption land here, exactly where
            # cold storage would bite — and exactly why this path must
            # not hold the lock: a 100 ms injected stall inside the
            # critical section would serialize every concurrent hit
            # behind it
            faults.snapshot_load_fault(self.registry.path(target))
            snap = self.registry.load(target)
            if snap is None and target != name:
                # stale alias (torn/corrupt versioned archive): the
                # plain-name snapshot is still a servable posterior
                snap = self.registry.load(name)
            return snap

        # in-flight load coalescing: two per-device flush queues (the
        # async pipeline) paging the SAME series in concurrently must
        # not both read the .npz — setdefault-first-writer-wins claims
        # the slot under the lock; the loser waits on the winner's
        # event OUTSIDE the lock and reuses its result
        slot = (threading.Event(), [None])
        with self._lock:
            claimed = self._loading.setdefault(name, slot)
        if claimed is not slot:
            # racer: the first writer owns the load
            self._load_coalesced.inc()
            claimed[0].wait()
            return claimed[1][0]

        # bounded second chances for TRANSIENT faults (robust/retry.py):
        # a torn read quarantines the file, so the retry only heals if a
        # concurrent writer re-saves during the backoff — exactly the
        # window the jittered sleep buys. A persistent fault exhausts
        # the budget and the miss degrades to shed;
        # default failed-predicate: result is None (the registry's
        # corrupt-file-is-a-miss convention).
        kw = {} if self._retry_sleep is None else {"sleep": self._retry_sleep}
        snap = None
        try:
            snap = retry_call(
                _load_once,
                self.load_retry,
                on_retry=lambda attempt, err: self._load_retries.inc(),
                salt=hash(name) & 0x7FFFFFFF,
                **kw,
            )
        finally:
            # release racers even on an exhausted/raising load (they
            # see the miss and degrade exactly like the owner)
            with self._lock:
                self._loading.pop(name, None)
            slot[1][0] = snap
            slot[0].set()
        return snap

    def touch(self, name: str) -> Optional[PosteriorSnapshot]:
        """Load-or-hit WITH admission (:meth:`load` + :meth:`admit`):
        budget enforced after insertion. ``None`` when nothing servable
        is registered under ``name``."""
        snap = self.load(name)
        if snap is not None:
            self.admit(name, snap)
        return snap

    def admit(self, name: str, snap: PosteriorSnapshot) -> None:
        """Account an externally-loaded snapshot as resident (the
        scheduler's direct ``attach_many`` path) — same LRU/budget
        discipline as a :meth:`touch` load. A re-admit (re-attach of a
        fresh fit) REPLACES the resident copy: serving a stale draw
        bank after a later eviction+touch would silently undo the
        refit."""
        nbytes = snapshot_nbytes(snap)  # np host read — outside the lock
        with self._lock:
            entry = self._resident.get(name)
            if entry is not None and entry[0] is snap:
                # the page-in path: touch() already loaded and
                # accounted this very object
                self._resident.move_to_end(name)
                return
            if entry is not None:
                self._resident.pop(name)
                self._account_del_locked(name, entry[1])
            reload = name in self._ever_resident
            self._ever_resident.add(name)
            self._resident[name] = (snap, nbytes)
            self._account_add_locked(name, nbytes)
            victims, overrun = self._collect_victims_locked(exempt=name)
            bytes_now = self._note_peak_locked()
        self._loads.inc()
        if reload:
            self._reloads.inc()
        self._publish(bytes_now, victims, overrun)

    # ---- pinning ----

    def pin(self, name: str) -> None:
        """Exempt ``name`` from eviction (a pending tick needs it)."""
        with self._lock:
            self._pinned.add(name)

    def unpin(self, name: str) -> None:
        with self._lock:
            self._pinned.discard(name)

    # ---- eviction ----

    def _account_add_locked(self, name: str, nbytes: int) -> None:
        """Lock held. Global + per-device-partition byte accounting."""
        self._resident_bytes += nbytes
        if self._placement is not None:
            d = self._placement.device_of(name)
            self._dev_of[name] = d
            self._dev_bytes[d] = self._dev_bytes.get(d, 0) + nbytes

    def _account_del_locked(self, name: str, nbytes: int) -> None:
        """Lock held. Reverse of :meth:`_account_add_locked`."""
        self._resident_bytes -= nbytes
        d = self._dev_of.pop(name, None)
        if d is not None:
            left = self._dev_bytes.get(d, 0) - nbytes
            if left <= 0:
                self._dev_bytes.pop(d, None)
            else:
                self._dev_bytes[d] = left

    def device_budget_bytes(self) -> Optional[int]:
        """Each device partition's even share of the byte budget
        (``None`` without a placement) — re-derived from whatever the
        current budget is, so :meth:`refresh_budget`'s live-watermark
        re-derivation splits through automatically."""
        if self._placement is None or self._placement.n_devices <= 1:
            return None
        return max(1, self.budget_bytes // self._placement.n_devices)

    def _collect_victims_locked(
        self, exempt: Optional[str] = None
    ) -> Tuple[List[str], bool]:
        """Lock held. Pop LRU-first unpinned entries until the budget
        holds; returns ``(victims, overrun)``. The just-admitted entry
        is exempt for this pass (it is needed right now); if only
        pinned/exempt entries remain while still over budget the
        overrun is reported and allowed — shedding a tick to save
        memory is the admission policy's call, not the pager's.
        Listener dispatch and counters happen in :meth:`_publish`,
        after the lock is released.

        With a placement attached (async pipeline) an inner pass runs
        first: each over-budget DEVICE partition evicts LRU-first
        among its own names until its even share of the budget holds
        — one device's hot set can never push another device's
        snapshots out. The global pass still runs after (partitions
        under their share can still sum over a shrunk budget)."""
        victims: List[str] = []
        dev_budget = self.device_budget_bytes()
        if dev_budget is not None:
            for d in [
                d for d, b in self._dev_bytes.items() if b > dev_budget
            ]:
                while self._dev_bytes.get(d, 0) > dev_budget:
                    victim = next(
                        (
                            n
                            for n in self._resident  # LRU-first order
                            if self._dev_of.get(n) == d
                            and n != exempt
                            and n not in self._pinned
                        ),
                        None,
                    )
                    if victim is None:
                        break  # only pinned/exempt left: allowed overrun
                    _, nbytes = self._resident.pop(victim)
                    self._account_del_locked(victim, nbytes)
                    victims.append(victim)
        while self._resident_bytes > self.budget_bytes:
            victim = next(
                (
                    n
                    for n in self._resident  # LRU-first iteration order
                    if n != exempt and n not in self._pinned
                ),
                None,
            )
            if victim is None:
                return victims, True
            _, nbytes = self._resident.pop(victim)
            self._account_del_locked(victim, nbytes)
            victims.append(victim)
        return victims, False

    def _note_peak_locked(self) -> int:
        """Lock held. Track the peak and return the current bytes for
        gauge publication outside the lock."""
        if self._resident_bytes > self._peak_resident_bytes:
            self._peak_resident_bytes = self._resident_bytes
        return self._resident_bytes

    def _publish(
        self, bytes_now: int, victims: List[str], overrun: bool = False
    ) -> None:
        """Outside the lock: metric publication and the eviction
        listener (the scheduler's ``detach`` — it re-enters
        :meth:`discard`, which under a held lock would self-deadlock)."""
        self._resident_gauge.set(bytes_now)
        if overrun:
            self._budget_overruns.inc()
        for victim in victims:
            self._evictions.inc()
            if self._on_evict is not None:
                self._on_evict(victim)

    def shrink_to_budget(self) -> None:
        """Evict unpinned LRU entries until the budget holds — the
        scheduler calls this at the end of every flush, when the
        just-drained ticks have unpinned their snapshots. An admission
        policy whose pending reach exceeds the budget can pin the pager
        past it transiently (counted in ``budget_overruns``); this is
        where residency comes back under."""
        with self._lock:
            victims, overrun = self._collect_victims_locked()
            bytes_now = self._note_peak_locked()
        self._publish(bytes_now, victims, overrun)

    def evict(self, name: str) -> bool:
        """Explicit eviction (fires the listener). False if not
        resident."""
        with self._lock:
            entry = self._resident.pop(name, None)
            if entry is None:
                return False
            self._account_del_locked(name, entry[1])
            bytes_now = self._note_peak_locked()
        self._publish(bytes_now, [name])
        return True

    def discard(self, name: str) -> None:
        """Drop residency WITHOUT firing the listener — for the
        listener itself (detach already in progress)."""
        with self._lock:
            entry = self._resident.pop(name, None)
            if entry is not None:
                self._account_del_locked(name, entry[1])
            self._pinned.discard(name)
            bytes_now = self._note_peak_locked()
        if entry is not None:
            self._resident_gauge.set(bytes_now)

    # ---- reading ----

    def resident_names(self) -> List[str]:
        """LRU→MRU order."""
        with self._lock:
            return list(self._resident)

    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes

    def peak_resident_bytes(self) -> int:
        """High-watermark of resident bytes — the storm bench's
        held-under-budget gate reads this."""
        with self._lock:
            return self._peak_resident_bytes

    def stats(self) -> Dict[str, int]:
        """JSON-ready paging counters for bench records."""
        with self._lock:
            resident = len(self._resident)
            resident_bytes = self._resident_bytes
            peak = self._peak_resident_bytes
            per_device = (
                None
                if self._placement is None
                else {
                    str(d): int(b)
                    for d, b in sorted(self._dev_bytes.items())
                }
            )
        out = {
            "budget_bytes": int(self.budget_bytes),
            "budget_source": self.budget_source,
            "resident": resident,
            "resident_bytes": int(resident_bytes),
            "peak_resident_bytes": int(peak),
            "loads": int(self._loads.get()),
            "reloads": int(self._reloads.get()),
            "evictions": int(self._evictions.get()),
            "hits": int(self._hits.get()),
            "misses": int(self._misses.get()),
            "budget_overruns": int(self._budget_overruns.get()),
            "load_retries": int(self._load_retries.get()),
            "load_coalesced": int(self._load_coalesced.get()),
        }
        if per_device is not None:
            out["per_device_bytes"] = per_device
            dev_budget = self.device_budget_bytes()
            if dev_budget is not None:
                out["device_budget_bytes"] = int(dev_budget)
        return out
