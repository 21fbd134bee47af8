"""Request plane: per-tick lifecycle tracing for the serving layer
(a copy of ``hhmm_tpu/obs/request.py``, which is pure Python).

- :class:`TickTrace` — one tick's lifecycle, monotonic stamps at
  ``enqueue → admit → bucket → dispatch → [harvest →] device →
  respond``, so end-to-end latency splits into queue wait (enqueue →
  admit), batch formation (admit → dispatch: wave split, bucket
  assignment, lane padding, state stacking), device (dispatch →
  device-complete: the synchronised tick) and post-processing (device →
  respond). The scheduler's sampled flush profile
  (``profile_every``) refines the device share with a warm re-timing
  (:meth:`RequestRecorder.note_device_time`).
- :class:`RequestRecorder` — per-scheduler aggregation keyed by
  **tenant** (default tenant = series): rolling-window p50 / p99
  (stride-decimated like ``obs/trace.py``'s ``_NameStats``), exact
  lifetime stage-share sums, shed counts and queue-depth watermarks.
- Fairness observables, published as ``serve.request.*`` gauges on the
  metrics plane (``obs/metrics.py``) and in
  :meth:`RequestRecorder.stanza`: the per-tenant p99 spread, the largest
  queue age at dispatch and the per-flush tenant interleaving.

Disciplines:

1. **Near-zero cost when disabled.** Every recorder method returns
   after one attribute read and one branch while disabled; enablement
   follows the tracer (``HHMM_TPU_TRACE=1``) unless overridden with
   :meth:`RequestRecorder.enable`.
2. **One clock.** :data:`now` re-exports the obs plane's
   ``perf_counter``; the serve layer (``hhmm_tpu_torch/serve``) reads
   the clock only through it.
3. **Bounded memory.** Per-tenant windows are capped (``sample_cap``
   with stride doubling) and the tenant table is bounded
   (``max_tenants`` tracked exactly; the rest fold into an
   ``...overflow`` bucket).

Importing this module touches no CUDA.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from hhmm_tpu_torch.obs import metrics as obs_metrics
from hhmm_tpu_torch.obs.trace import perf_counter
from hhmm_tpu_torch.obs.trace import tracer as _tracer

__all__ = [
    "TickTrace",
    "RequestRecorder",
    "now",
    "STAGES",
    "OVERFLOW_TENANT",
    "DEFAULT_MAX_TENANTS",
    "bounded_tenant_label",
]

# the serve layer's one clock read: hhmm_tpu_torch/serve imports THIS,
# never time.perf_counter directly
now = perf_counter

# lifecycle stage order; each maps to a ``t_<stage>`` stamp slot.
# ``harvest`` is async-pipeline-only (hhmm_tpu_torch/pipeline): stamped when
# the harvester turns to an in-flight flush, BEFORE its blocking sync —
# dispatch→harvest is device time HIDDEN behind host work (the overlap
# the pipeline exists to buy), harvest→device is the residual stall the
# harvester actually waited. Absent on the synchronous path.
STAGES = (
    "enqueue", "admit", "bucket", "dispatch", "harvest", "device", "respond"
)

# in-flight flush registrations are bounded: a harvester that died
# mid-air must not grow the flight table forever (the oldest flight's
# traces simply lose their harvest stamp — decompose degrades to the
# synchronous attribution)
FLIGHT_TABLE_CAP = 4096

# tenants beyond the exact-tracking cap fold here — the aggregate
# stays truthful even when tenant = series at fleet scale
OVERFLOW_TENANT = "...overflow"

# the ONE tenant-cardinality bound, shared by every per-tenant sink
# (the recorder's stats table, `serve/metrics.py`'s labeled shed
# counters): two independent caps would silently disagree about which
# tenants are "overflow" across the request plane's surfaces
DEFAULT_MAX_TENANTS = 64


def bounded_tenant_label(
    tenant, seen: set, cap: int = DEFAULT_MAX_TENANTS
) -> str:
    """The label value for ``tenant`` under the shared cardinality
    bound: exact for the first ``cap`` distinct tenants a sink sees
    (membership tracked in the caller-owned ``seen`` set, mutated
    here), the :data:`OVERFLOW_TENANT` fold beyond — nothing dropped,
    only folded."""
    t = str(tenant)
    if t in seen:
        return t
    if len(seen) >= cap:
        return OVERFLOW_TENANT
    seen.add(t)
    return t


class TickTrace:
    """One tick's lifecycle. Mutable slots — the scheduler stamps
    stages as the tick moves through the flush; a stamp left ``None``
    means the tick never reached that stage (e.g. shed at admission)."""

    __slots__ = (
        "series_id",
        "tenant",
        "bucket",
        "kernel",
        "shed",
        "error",
        "t_enqueue",
        "t_admit",
        "t_bucket",
        "t_dispatch",
        "t_harvest",
        "t_device",
        "t_respond",
    )

    def __init__(self, series_id: str, tenant: str, t_enqueue: float):
        self.series_id = series_id
        self.tenant = tenant
        self.bucket: Optional[int] = None
        self.kernel: Optional[str] = None
        self.shed = False
        self.error: Optional[str] = None
        self.t_enqueue = t_enqueue
        self.t_admit: Optional[float] = None
        self.t_bucket: Optional[float] = None
        self.t_dispatch: Optional[float] = None
        self.t_harvest: Optional[float] = None
        self.t_device: Optional[float] = None
        self.t_respond: Optional[float] = None

    def decompose(self) -> Optional[Dict[str, float]]:
        """Stage durations in seconds, or ``None`` for a tick that
        never completed the full lifecycle (shed, or enqueued while the
        recorder was off). ``queue_s + form_s + device_s + post_s ==
        total_s`` by construction; when the ``bucket`` stamp is present
        the formation share further splits as ``form_s = assign_s +
        stack_s`` (wave split/bucket assignment vs lane padding +
        dtype-locked obs/state staging) — the per-tick forensic read
        for 'where inside batch formation did this flush spend its
        host time'."""
        stamps = (
            self.t_enqueue,
            self.t_admit,
            self.t_dispatch,
            self.t_device,
            self.t_respond,
        )
        if any(s is None for s in stamps):
            return None
        t_enq, t_adm, t_dis, t_dev, t_rsp = stamps
        out = {
            "queue_s": t_adm - t_enq,
            "form_s": t_dis - t_adm,
            "device_s": t_dev - t_dis,
            "post_s": t_rsp - t_dev,
            "total_s": t_rsp - t_enq,
        }
        if self.t_bucket is not None:
            out["assign_s"] = self.t_bucket - t_adm
            out["stack_s"] = t_dis - self.t_bucket
        if self.t_harvest is not None:
            # async pipeline split of the device share: dispatch→harvest
            # is device time HIDDEN behind host work (overlap won);
            # harvest→device is the residual stall the harvester waited.
            # The harvest stamp comes from the HARVEST SITE per in-flight
            # flush (note_harvest) — under double-buffering the stamps no
            # longer happen in dispatch call order, and attributing the
            # sync by call order would charge flush N's device time to
            # flush N+1's ticks.
            out["hidden_s"] = max(0.0, self.t_harvest - t_dis)
            out["stall_s"] = max(0.0, t_dev - self.t_harvest)
        return out


class _TenantStats:
    """Per-tenant streaming aggregate: exact counts + stage-share sums,
    plus a time-pruned, stride-decimated latency sample for windowed
    percentiles (the `obs/trace.py` ``_NameStats`` decimation, with a
    wall-window prune on top)."""

    __slots__ = (
        "ticks",
        "sheds",
        "sum_total",
        "sum_queue",
        "sum_form",
        "sum_device",
        "sum_post",
        "sum_hidden",
        "sum_stall",
        "samples",
        "stride",
        "count",
        "cap",
        "queue_depth",
        "max_queue_depth",
    )

    def __init__(self, cap: int):
        self.ticks = 0
        self.sheds = 0
        self.sum_total = 0.0
        self.sum_queue = 0.0
        self.sum_form = 0.0
        self.sum_device = 0.0
        self.sum_post = 0.0
        self.sum_hidden = 0.0
        self.sum_stall = 0.0
        # (t_end, total_s) pairs, oldest first
        self.samples: deque = deque()
        self.stride = 1
        self.count = 0
        self.cap = cap
        self.queue_depth = 0
        self.max_queue_depth = 0

    def fold(self, t_end: float, d: Dict[str, float], window_s: float) -> None:
        self.ticks += 1
        self.sum_total += d["total_s"]
        self.sum_queue += d["queue_s"]
        self.sum_form += d["form_s"]
        self.sum_device += d["device_s"]
        self.sum_post += d["post_s"]
        self.sum_hidden += d.get("hidden_s", 0.0)
        self.sum_stall += d.get("stall_s", 0.0)
        if self.count % self.stride == 0:
            self.samples.append((t_end, d["total_s"]))
            # prune the stale end first — a window that already slid
            # past old samples should not trigger decimation
            horizon = t_end - window_s
            while self.samples and self.samples[0][0] < horizon:
                self.samples.popleft()
            if len(self.samples) > self.cap:
                self.samples = deque(list(self.samples)[1::2])
                self.stride *= 2
        self.count += 1

    def windowed_quantile(self, q: float, t_now: float, window_s: float) -> float:
        """Order-statistic quantile over samples inside the window
        (``nan`` when empty) — the `obs/trace.py` aggregate semantics."""
        horizon = t_now - window_s
        vals = sorted(v for t, v in self.samples if t >= horizon)
        if not vals:
            return float("nan")
        return vals[max(0, math.ceil(q * len(vals)) - 1)]


def _share(part: float, total: float) -> Optional[float]:
    return round(part / total, 4) if total > 0 else None


def _sums(stats) -> Dict[str, float]:
    """Seconds summed over tenants' stats: the whole tick (``total``),
    its stages (``queue``, ``device``, ``other`` = formation + response)
    and the async pipeline's ``hidden`` and ``stall``."""
    stats = list(stats)
    return {
        "total": sum(st.sum_total for st in stats),
        "queue": sum(st.sum_queue for st in stats),
        "device": sum(st.sum_device for st in stats),
        "other": sum(st.sum_form + st.sum_post for st in stats),
        "hidden": sum(st.sum_hidden for st in stats),
        "stall": sum(st.sum_stall for st in stats),
    }


class RequestRecorder:
    """See module docstring. One instance per scheduler; tests
    construct their own with an injectable clock."""

    def __init__(
        self,
        enabled: Optional[bool] = None,
        window_s: float = 60.0,
        sample_cap: int = 512,
        max_tenants: int = DEFAULT_MAX_TENANTS,
        spread_every: int = 8,
        clock=perf_counter,
    ):
        """``spread_every``: publish the cross-tenant p99-spread gauge
        on every Nth flush (first flush included). Computing the
        spread sorts every tenant's sample window — O(tenants x cap
        log cap), up to ~32k floats at the defaults — which is debug
        telemetry, not something the per-flush budget should pay
        every time; :meth:`p99_spread_ms` itself stays exact and
        on-demand (the bench fairness gates read it directly)."""
        # None -> follow the tracer flag; True/False -> explicit
        self._enabled = enabled
        self.window_s = float(window_s)
        self._sample_cap = int(sample_cap)
        self._max_tenants = int(max_tenants)
        self._spread_every = max(1, int(spread_every))
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantStats] = {}
        # per-flush accumulators, folded by flush_done()
        self._flush_tenants: set = set()
        self._flush_max_queue_age = 0.0
        # window-level fairness state
        self._flushes = 0
        self._flush_tenant_total = 0
        self._max_queue_age_peak = 0.0
        # warm re-timed pure device time per "kernel/bucket" — fed by
        # the scheduler's sampled flush profiling (obs/profile.py's
        # device_time; the re-timed call repeats an already-dispatched
        # signature, so it adds no signature and no kernel build)
        self._profiled_device_ms: Dict[str, float] = {}
        # flush-plan attribution (note_flush_plan): the scheduler's
        # per-flush order decision, so spread is attributable to
        # SCHEDULING (who waited by policy) vs device time. Cumulative
        # served/stranded per folded tenant + last-seen share/credit;
        # cardinality rides the same _fold bound as the stats table.
        self._sched_order: Optional[str] = None
        self._sched_credit_cap = 0.0
        self._sched_tenants: Dict[str, Dict[str, Any]] = {}
        self._sched_last_order: List[str] = []
        # regime-event attribution (note_event): per-folded-tenant
        # flip/drift counts published by the serve event feed
        # (serve/events.py) — change-point detection is a product, so
        # its volume belongs in the same windowed stanza the rest of
        # the request plane reports in
        self._event_tenants: Dict[str, Dict[str, int]] = {}
        # async-pipeline flight registrations (begin_flight /
        # note_harvest): flush_id -> the flight's traces, so the
        # harvest-site stamp lands on the RIGHT in-flight flush even
        # when two flushes interleave; bounded at FLIGHT_TABLE_CAP
        self._flights: "Dict[Any, List[Optional[TickTrace]]]" = {}
        self._flight_order: deque = deque()
        self._inflight_peak = 0
        self._harvested_flights = 0
        # transfer attribution (note_transfers): bytes staged up /
        # pulled down per dispatch, so the stanza can attribute the
        # form/post shares to actual host<->device traffic (the
        # device-resident carry duel reads the delta between arms)
        self._h2d_bytes = 0
        self._d2h_bytes = 0
        self._transfer_dispatches = 0

    # ---- enablement (the obs/trace.py discipline) ----

    def enabled(self) -> bool:
        if self._enabled is not None:
            return self._enabled
        return _tracer.enabled()

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def use_env(self) -> None:
        self._enabled = None

    # ---- recording (scheduler-facing) ----

    def _fold(self, tenant: str) -> str:
        """Lock held. The tracking label ``tenant`` folds to: itself
        while it is already tracked or there is room under
        ``max_tenants``, the overflow bucket beyond."""
        if tenant in self._tenants or len(self._tenants) < self._max_tenants:
            return tenant
        return OVERFLOW_TENANT

    def _stats(self, tenant: str) -> _TenantStats:
        """Lock held. Get-or-create the stats bucket for an
        already-folded label (callers pass ``TickTrace.tenant``, which
        :meth:`enqueue` resolved through :meth:`_fold` — resolving the
        fold ONCE per tick is what keeps every lifecycle step on the
        same bucket, so a shed can never skip a depth slot that lives
        on the overflow entry)."""
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[self._fold(tenant)] = _TenantStats(
                self._sample_cap
            )
        return st

    def enqueue(self, series_id: str, tenant: str) -> Optional[TickTrace]:
        """A tick entered the pending queue. Returns its trace (``None``
        while disabled — the scheduler threads it through untouched).
        The trace carries the FOLDED tracking label (cardinality
        bound): every later stage of this tick reads the same bucket
        its depth slot lives on."""
        if not self.enabled():
            return None
        with self._lock:
            label = self._fold(tenant)
            tr = TickTrace(series_id, label, self._clock())
            st = self._stats(label)
            st.queue_depth += 1
            if st.queue_depth > st.max_queue_depth:
                st.max_queue_depth = st.queue_depth
        return tr

    def admit(self, traces: Sequence[Optional[TickTrace]]) -> None:
        """A flush drained these ticks from the queue (one clock read
        for the batch — they are admitted at the same moment)."""
        if not self.enabled():
            return
        t = self._clock()
        with self._lock:
            for tr in traces:
                if tr is None:
                    continue
                tr.t_admit = t
                # tr.tenant is the folded label its depth slot lives on
                st = self._tenants.get(tr.tenant)
                if st is not None and st.queue_depth > 0:
                    st.queue_depth -= 1

    def stage(
        self,
        traces: Sequence[Optional[TickTrace]],
        stage: str,
        t: Optional[float] = None,
    ) -> None:
        """Stamp one lifecycle stage (``bucket``/``dispatch``/``device``)
        onto a dispatch group — one clock read unless the caller already
        holds one (the scheduler reuses its post-sync read)."""
        if not self.enabled():
            return
        if t is None:
            t = self._clock()
        attr = "t_" + stage
        for tr in traces:
            if tr is not None:
                setattr(tr, attr, t)

    def shed(self, trace: Optional[TickTrace], reason: str) -> None:
        """A tick left the lifecycle without dispatching (admission
        pressure, dispatch failure, detach). Counted per tenant; its
        latency is NOT folded into the service-latency window — a shed
        has no honest service time."""
        if trace is None or not self.enabled():
            return
        trace.shed = True
        trace.error = reason
        trace.t_respond = self._clock()
        with self._lock:
            st = self._stats(trace.tenant)
            st.sheds += 1
            if trace.t_admit is None and st.queue_depth > 0:
                # shed straight out of the queue: release its depth slot
                st.queue_depth -= 1

    def complete_group(
        self,
        traces: Sequence[Optional[TickTrace]],
        kernel: str,
        bucket: int,
    ) -> None:
        """A dispatch group produced its responses: stamp ``respond``
        (one clock read), fold each tick's decomposition into its
        tenant window, and accumulate the flush fairness state."""
        if not self.enabled():
            return
        t = self._clock()
        with self._lock:
            for tr in traces:
                if tr is None:
                    continue
                tr.t_respond = t
                tr.kernel = kernel
                tr.bucket = bucket
                d = tr.decompose()
                if d is None:
                    continue
                self._stats(tr.tenant).fold(t, d, self.window_s)
                self._flush_tenants.add(tr.tenant)
                if tr.t_dispatch is not None:
                    age = tr.t_dispatch - tr.t_enqueue
                    if age > self._flush_max_queue_age:
                        self._flush_max_queue_age = age

    def flush_done(self) -> None:
        """End of one flush: publish the fairness gauges (no-ops while
        the metrics plane is disabled) and fold the per-flush
        accumulators into the window-level fairness state."""
        if not self.enabled():
            return
        with self._lock:
            n_tenants = len(self._flush_tenants)
            age = self._flush_max_queue_age
            self._flush_tenants = set()
            self._flush_max_queue_age = 0.0
            if n_tenants:
                self._flushes += 1
                self._flush_tenant_total += n_tenants
            if age > self._max_queue_age_peak:
                self._max_queue_age_peak = age
        if n_tenants:
            obs_metrics.gauge("serve.request.flush_tenants").set(n_tenants)
            obs_metrics.gauge("serve.request.max_queue_age_ms").set(
                round(age * 1e3, 4)
            )
            # the spread sorts every tenant window — sampled cadence
            # (see __init__ spread_every); flushes was just incremented,
            # so the first tenant-bearing flush publishes immediately
            if self._flushes % self._spread_every == 1 or self._spread_every == 1:
                spread = self.p99_spread_ms()
                if spread is not None:
                    obs_metrics.gauge("serve.request.p99_spread_ms").set(spread)

    def begin_flight(
        self, flush_id: Any, traces: Sequence[Optional[TickTrace]]
    ) -> None:
        """An async dispatch went in-flight (`hhmm_tpu_torch/pipeline`):
        register its traces under ``flush_id`` so the harvest-site
        stamp (:meth:`note_harvest`) lands on THIS flush's ticks and
        not whatever dispatched most recently. Publishes the live
        in-flight depth gauge (``serve.request.in_flight_depth``)."""
        if not self.enabled():
            return
        with self._lock:
            self._flights[flush_id] = list(traces)
            self._flight_order.append(flush_id)
            while len(self._flight_order) > FLIGHT_TABLE_CAP:
                stale = self._flight_order.popleft()
                self._flights.pop(stale, None)
            depth = len(self._flights)
            if depth > self._inflight_peak:
                self._inflight_peak = depth
        obs_metrics.gauge("serve.request.in_flight_depth").set(depth)

    def note_harvest(self, flush_id: Any) -> None:
        """The harvester turned to in-flight flush ``flush_id`` (one
        clock read, BEFORE its blocking sync): stamp ``t_harvest`` on
        exactly that flush's traces. Under double-buffered dispatch
        the device-complete stamps no longer happen in dispatch call
        order — this per-flight stamp is what keeps device time
        attributed to the tick that actually spent it (the hidden/
        stall split in :meth:`TickTrace.decompose`)."""
        if not self.enabled():
            return
        t = self._clock()
        with self._lock:
            traces = self._flights.pop(flush_id, None)
            if flush_id in self._flight_order:
                self._flight_order.remove(flush_id)
            if traces is not None:
                self._harvested_flights += 1
            depth = len(self._flights)
        if traces is None:
            return
        for tr in traces:
            if tr is not None:
                tr.t_harvest = t
        obs_metrics.gauge("serve.request.in_flight_depth").set(depth)

    def in_flight_depth(self) -> int:
        """Currently registered un-harvested flights."""
        with self._lock:
            return len(self._flights)

    def note_transfers(self, h2d_bytes: int, d2h_bytes: int) -> None:
        """One dispatch's host<->device traffic: bytes newly staged
        into its input buffers and bytes pulled down as its batched
        response surface. The stanza's ``transfers`` block is what
        lets a reader attribute the form/post shares to traffic (the
        device-resident carry arm drops h2d while shares shrink)."""
        if not self.enabled():
            return
        with self._lock:
            self._h2d_bytes += int(h2d_bytes)
            self._d2h_bytes += int(d2h_bytes)
            self._transfer_dispatches += 1

    def note_device_time(self, kernel: str, bucket: int, p50_s: float) -> None:
        """The sampled warm re-timing landed: the pure device
        re-execution p50 for this (kernel, bucket) — the refinement of
        the synced-dispatch ``device_s`` share."""
        if not self.enabled():
            return
        with self._lock:
            self._profiled_device_ms[f"{kernel}/b{int(bucket)}"] = round(
                float(p50_s) * 1e3, 4
            )

    def note_flush_plan(
        self,
        order: str,
        entries: Sequence[Dict[str, Any]],
        credit_cap: float = 0.0,
    ) -> None:
        """The scheduler's per-flush order decision (tenant-fair DRR or
        the FIFO baseline): one entry per tenant touched by the flush,
        with its configured ``share``, ticks ``served``, ticks
        ``stranded`` (still queued), and post-flush carry-over
        ``credit``. Folding spread into *scheduling* (who waited by
        policy) is what separates a fairness regression from a slow
        device. Labels ride the same cardinality fold as the stats
        table; served/stranded accumulate over the window, share and
        credit keep the last-seen value (credit also tracks its peak,
        the credit-cap property test's observable)."""
        if not self.enabled():
            return
        with self._lock:
            self._sched_order = str(order)
            self._sched_credit_cap = float(credit_cap)
            self._sched_last_order = []
            for e in entries:
                label = self._fold(str(e.get("tenant")))
                self._sched_last_order.append(label)
                row = self._sched_tenants.get(label)
                if row is None:
                    if len(self._sched_tenants) >= self._max_tenants:
                        label = OVERFLOW_TENANT
                        row = self._sched_tenants.get(label)
                    if row is None:
                        row = self._sched_tenants[label] = {
                            "share": 1.0,
                            "served": 0,
                            "stranded": 0,
                            "credit": 0.0,
                            "credit_max": 0.0,
                        }
                row["share"] = float(e.get("share", 1.0))
                row["served"] += int(e.get("served", 0))
                row["stranded"] += int(e.get("stranded", 0))
                c = float(e.get("credit", 0.0))
                row["credit"] = c
                if c > row["credit_max"]:
                    row["credit_max"] = c

    def note_event(self, tenant, kind: str) -> None:
        """One published regime event (`serve/events.py`): a
        hysteresis-committed regime ``"flip"`` or a CUSUM ``"drift"``
        alarm, attributed to its (folded) tenant. The stanza's
        ``events`` block is the per-window product-volume view; the
        lifetime view lives on the feed itself (``serve.events_*``
        counters + ``RegimeEventFeed.stanza``)."""
        if not self.enabled():
            return
        key = "drifts" if kind == "drift" else "flips"
        with self._lock:
            label = self._fold(str(tenant))
            row = self._event_tenants.get(label)
            if row is None:
                if len(self._event_tenants) >= self._max_tenants:
                    label = OVERFLOW_TENANT
                    row = self._event_tenants.get(label)
                if row is None:
                    row = self._event_tenants[label] = {
                        "flips": 0,
                        "drifts": 0,
                    }
            row[key] += 1

    # ---- reading ----

    def p99_spread_ms(self) -> Optional[float]:
        """The starvation detector: max − min windowed p99 latency
        across tenants (ms). ``None`` until two tenants have windowed
        samples — a spread needs someone to be unfair *to*."""
        t_now = self._clock()
        with self._lock:
            p99s = []
            for st in self._tenants.values():
                v = st.windowed_quantile(0.99, t_now, self.window_s)
                if not math.isnan(v):
                    p99s.append(v)
        if len(p99s) < 2:
            return None
        return round((max(p99s) - min(p99s)) * 1e3, 4)

    def queue_depths(self) -> Dict[str, int]:
        """Current pending-queue occupancy per tenant."""
        with self._lock:
            return {t: st.queue_depth for t, st in self._tenants.items()}

    def reset_window(self) -> None:
        """Start a fresh measurement window (the bench's post-warmup
        'measure from here' reset — mirrors
        ``ServeMetrics.reset_throughput_window``): windowed samples and
        fairness state are zeroed; exact lifetime counters and stage
        sums are zeroed too, so the stanza's shares describe the same
        window as its percentiles. LIVE queue occupancy is carried
        over — ticks still pending at the reset will be admitted or
        shed in the new window, and dropping their depth slots would
        under-report a genuinely backlogged tenant (and desync the
        admit-side decrements)."""
        with self._lock:
            old = self._tenants
            self._tenants = {}
            for tenant, st in old.items():
                if st.queue_depth > 0:
                    ns = self._tenants[tenant] = _TenantStats(
                        self._sample_cap
                    )
                    ns.queue_depth = st.queue_depth
                    ns.max_queue_depth = st.queue_depth
            self._flush_tenants = set()
            self._flush_max_queue_age = 0.0
            self._flushes = 0
            self._flush_tenant_total = 0
            self._max_queue_age_peak = 0.0
            self._sched_order = None
            self._sched_credit_cap = 0.0
            self._sched_tenants = {}
            self._sched_last_order = []
            self._event_tenants = {}
            # LIVE in-flight flights carry over exactly like queue
            # occupancy (their harvest lands in the new window); the
            # peak restarts from the live depth
            self._inflight_peak = len(self._flights)
            self._harvested_flights = 0
            self._h2d_bytes = 0
            self._d2h_bytes = 0
            self._transfer_dispatches = 0

    def totals(self) -> Dict[str, float]:
        """The seconds behind the stanza's overall shares, summed over
        every tenant's ticks in the window (see :func:`_sums`; a flight's
        stamps count once for each series it carried)."""
        with self._lock:
            return _sums(self._tenants.values())

    def stanza(self, top: Optional[int] = 16) -> Dict[str, Any]:
        """JSON-ready request-plane stanza for the run manifest /
        bench record (rendered by `scripts/obs_report.py` as the
        ``== request timeline ==`` section, gated by
        `scripts/bench_diff.py`). Per-tenant rows are capped at ``top``
        (by tick count) with the omission counted — the stanza must
        not bloat a manifest when tenant = series at fleet scale."""
        t_now = self._clock()
        with self._lock:
            items = sorted(
                self._tenants.items(), key=lambda kv: -kv[1].ticks
            )
            flushes = self._flushes
            tenant_total = self._flush_tenant_total
            peak_age = self._max_queue_age_peak
            profiled = dict(self._profiled_device_ms)
            sched = None
            if self._sched_order is not None:
                sched = {
                    "order": self._sched_order,
                    "credit_cap": self._sched_credit_cap,
                    "tenants": {
                        t: dict(row)
                        for t, row in self._sched_tenants.items()
                    },
                    "last_flush_order": list(self._sched_last_order),
                }
            events = None
            if self._event_tenants:
                events = {
                    "tenants": {
                        t: dict(row)
                        for t, row in self._event_tenants.items()
                    },
                    "flips": sum(
                        r["flips"] for r in self._event_tenants.values()
                    ),
                    "drifts": sum(
                        r["drifts"] for r in self._event_tenants.values()
                    ),
                }
            tenants: Dict[str, Any] = {}
            shown = items if top is None else items[:top]
            for name, st in shown:
                p50 = st.windowed_quantile(0.50, t_now, self.window_s)
                p99 = st.windowed_quantile(0.99, t_now, self.window_s)
                tenants[name] = {
                    "ticks": st.ticks,
                    "sheds": st.sheds,
                    "p50_ms": None if math.isnan(p50) else round(p50 * 1e3, 4),
                    "p99_ms": None if math.isnan(p99) else round(p99 * 1e3, 4),
                    "queue_share": _share(st.sum_queue, st.sum_total),
                    "device_share": _share(st.sum_device, st.sum_total),
                    "other_share": _share(
                        st.sum_form + st.sum_post, st.sum_total
                    ),
                    "max_queue_depth": st.max_queue_depth,
                }
            sums = _sums(st for _, st in items)
            overall = {
                "ticks": sum(st.ticks for _, st in items),
                "sheds": sum(st.sheds for _, st in items),
                "queue_share": _share(sums["queue"], sums["total"]),
                "device_share": _share(sums["device"], sums["total"]),
                "other_share": _share(sums["other"], sums["total"]),
                # async pipeline: fraction of device time hidden behind
                # host work (0/None on the synchronous path — no
                # harvest stamps, nothing hidden)
                "overlap_share": _share(sums["hidden"], sums["device"]),
            }
            pipeline = {
                "in_flight_depth": len(self._flights),
                "in_flight_peak": self._inflight_peak,
                "harvested_flights": self._harvested_flights,
            }
            transfers = {
                "h2d_bytes": int(self._h2d_bytes),
                "d2h_bytes": int(self._d2h_bytes),
                "dispatches": int(self._transfer_dispatches),
            }
        spread = self.p99_spread_ms()
        return {
            "window_s": self.window_s,
            "tenants": tenants,
            "tenants_omitted": max(0, len(items) - len(tenants)),
            "overall": overall,
            "fairness": {
                "p99_spread_ms": spread,
                "max_queue_age_ms": round(peak_age * 1e3, 4),
                "mean_flush_tenants": (
                    round(tenant_total / flushes, 2) if flushes else None
                ),
                "flushes": flushes,
            },
            "profiled_device_ms": profiled,
            "scheduler": sched,
            "events": events,
            "pipeline": pipeline,
            "transfers": transfers,
        }
