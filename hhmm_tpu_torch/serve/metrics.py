"""Serving metrics (counterpart of ``hhmm_tpu/serve/metrics.py``): the
per-request latency histogram, throughput, staleness, the compile
counter whose flatness is the no-new-signature guarantee, and the serve
SLO spec those numbers are gated against.

The scheduler's contract (``serve/scheduler.py``) is that after warmup
every flush lands in one of a small fixed set of padded bucket shapes.
The port has no jit, so ``compile_count`` is the number of distinct
dispatch signatures the scheduler has run (kernel, bucket, observation
dtypes; the replay's padded length), kept under the JAX metric's name
so an SLO spec reads the same in both packages. On the card the nvcc
builds (``obs/telemetry.backend_compiles``) must also stay flat.

The latency histogram, counters and staleness gauge are the metrics
plane's own instruments (``obs/metrics.py``), attached to the
process-wide registry under ``serve.*`` names. Serving metrics record
regardless of ``HHMM_TPU_TRACE``. The compile counter lives in a named
``obs/telemetry`` :class:`~hhmm_tpu_torch.obs.telemetry.CompileScope`.
The ``summary()`` schema is the JAX one.

:class:`SLOSpec` makes the serving objectives explicit — p99 tick
latency, snapshot staleness bound, post-warmup recompile budget — and
:func:`evaluate_slo` turns one measurement window into an attainment
verdict.

:class:`AdaptMetrics` comes with the module; its user, the adaptation
plane, is not ported yet.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np

from hhmm_tpu_torch.obs import metrics as obs_metrics
from hhmm_tpu_torch.obs import request as obs_request
from hhmm_tpu_torch.obs import telemetry

__all__ = ["AdaptMetrics", "ServeMetrics", "SLOSpec", "evaluate_slo"]


class ServeMetrics:
    """Histogram + counters for one scheduler instance."""

    def __init__(self, edges: Optional[Sequence[float]] = None):
        # 1 µs .. 60 s: log-spaced, generous at both ends
        self.latency = obs_metrics.Histogram(
            edges if edges is not None else obs_metrics.default_latency_edges()
        )
        self._requests = obs_metrics.Counter()
        self._ticks = obs_metrics.Counter()
        self._flushes = obs_metrics.Counter()
        self._busy = obs_metrics.Counter()
        self._degraded_responses = obs_metrics.Counter()
        self._degraded_attaches = obs_metrics.Counter()
        self._superseded_responses = obs_metrics.Counter()
        # overload/failure ladder counters (docs/serving.md "Overload &
        # failure modes"): every shed tick and rejected attach is a
        # counted, degraded-not-raised outcome — the storm bench gates
        # on these actually engaging under synthetic overload
        self._shed_ticks = obs_metrics.Counter()
        self._rejected_attaches = obs_metrics.Counter()
        self._dispatch_errors = obs_metrics.Counter()
        self._device_loss_events = obs_metrics.Counter()
        # warm page-in plane (docs/serving.md "Warm page-ins"): tails
        # retained across pager eviction are host memory under an
        # explicit byte budget — count the pressure evictions, gauge
        # the resident bytes, and count re-attaches that replayed a
        # retained tail instead of cold filtering
        self._tail_evictions = obs_metrics.Counter()
        self._warm_page_ins = obs_metrics.Counter()
        self._tail_bytes = obs_metrics.Gauge()
        # transfer telemetry (docs/serving.md "Device-resident carry"):
        # bytes newly materialized into staged dispatch inputs (obs
        # staging + any carry restack — a resident bank hit stages 0)
        # and bytes pulled back as the batched response surface; the
        # gauge is the lane table's live device-byte footprint. Always
        # on: the staged-vs-resident duel PROVES its transfer win from
        # these counters, not from inference.
        self._h2d_bytes = obs_metrics.Counter()
        self._d2h_bytes = obs_metrics.Counter()
        self._carry_bytes = obs_metrics.Gauge()
        # sampled flush profiling (obs/profile.py device_time through
        # the scheduler's profile_every knob): how many flushes were
        # re-timed; the per-(kernel, bucket) device-time gauges go to
        # the shared plane directly in note_flush_profile
        self._profiled_flushes = obs_metrics.Counter()
        # async pipeline (hhmm_tpu_torch/pipeline): ticks a dispatch
        # generation deferred because their series still had an
        # un-harvested flight (the fold-order guard) — they stay
        # queued, not shed, and drain next generation
        self._inflight_deferred = obs_metrics.Counter()
        # snapshot staleness: seconds since the oldest
        # serving snapshot was attached, written by the scheduler per
        # flush; the peak is the SLO-facing watermark for the window
        self._staleness = obs_metrics.Gauge()
        self._staleness_peak = float("nan")
        # the compile counter is a registered telemetry scope (one per
        # metrics instance; the registry sums same-label scopes)
        self._compile_scope = telemetry.new_scope("serve.compile_count")
        # attach every instrument to the shared metrics plane: weakrefs
        # only, merged per name across instances (counters sum, gauges
        # max, histograms add) — obs_report and the exports read them
        for name, inst in (
            ("serve.tick_latency_seconds", self.latency),
            ("serve.requests", self._requests),
            ("serve.ticks", self._ticks),
            ("serve.flushes", self._flushes),
            ("serve.busy_seconds", self._busy),
            ("serve.degraded_responses", self._degraded_responses),
            ("serve.degraded_attaches", self._degraded_attaches),
            ("serve.superseded_responses", self._superseded_responses),
            ("serve.shed_ticks", self._shed_ticks),
            ("serve.rejected_attaches", self._rejected_attaches),
            ("serve.dispatch_errors", self._dispatch_errors),
            ("serve.device_loss_events", self._device_loss_events),
            ("serve.snapshot_staleness_seconds", self._staleness),
            ("serve.profiled_flushes", self._profiled_flushes),
            ("serve.tail_evictions", self._tail_evictions),
            ("serve.warm_page_ins", self._warm_page_ins),
            ("serve.tail_resident_bytes", self._tail_bytes),
            ("serve.pipeline_deferred_ticks", self._inflight_deferred),
            ("serve.h2d_bytes", self._h2d_bytes),
            ("serve.d2h_bytes", self._d2h_bytes),
            ("serve.carry_resident_bytes", self._carry_bytes),
        ):
            obs_metrics.attach(name, inst)
        # tenant label values this instance has already created on the
        # plane — the memory behind the SHARED cardinality bound
        # (`obs/request.py` ``bounded_tenant_label``): with the default
        # tenant = series at fleet scale, an unbounded label set would
        # grow the registry one instrument per shedding series forever
        self._tenant_labels: set = set()

    def _tenant_label(self, tenant) -> str:
        return obs_request.bounded_tenant_label(tenant, self._tenant_labels)

    # ---- frozen read API (pre-registry attribute names) ----

    @property
    def edges(self) -> np.ndarray:
        return self.latency.edges

    @property
    def counts(self) -> np.ndarray:
        return self.latency.counts

    @property
    def requests(self) -> int:
        return int(self._requests.get())

    @property
    def ticks(self) -> int:
        return int(self._ticks.get())

    @property
    def flushes(self) -> int:
        return int(self._flushes.get())

    @property
    def busy_seconds(self) -> float:
        return float(self._busy.get())

    @property
    def degraded_responses(self) -> int:
        return int(self._degraded_responses.get())

    @property
    def degraded_attaches(self) -> int:
        return int(self._degraded_attaches.get())

    @property
    def superseded_responses(self) -> int:
        return int(self._superseded_responses.get())

    @property
    def shed_ticks(self) -> int:
        return int(self._shed_ticks.get())

    @property
    def rejected_attaches(self) -> int:
        return int(self._rejected_attaches.get())

    @property
    def dispatch_errors(self) -> int:
        return int(self._dispatch_errors.get())

    @property
    def device_loss_events(self) -> int:
        return int(self._device_loss_events.get())

    # ---- recording ----

    def reset_throughput_window(self) -> None:
        """Zero the latency histogram and throughput counters — 'start
        measuring now'. Benches call this after warmup so the reported
        percentiles, ticks/sec, and staleness peak describe the steady
        state, not the compile flushes; the compile counter and
        degradation counters (cumulative health facts) are deliberately
        kept."""
        self.latency.reset()
        self._requests.reset()
        self._ticks.reset()
        self._flushes.reset()
        self._busy.reset()
        # per-window like the throughput counters: the duel compares
        # bytes-per-window across arms. The residency GAUGE survives —
        # it is a live footprint, not window activity.
        self._h2d_bytes.reset()
        self._d2h_bytes.reset()
        self._staleness_peak = float("nan")

    def observe_latency(self, latency_s: float, n: int = 1) -> None:
        """Record ``n`` requests that completed with ``latency_s``."""
        self.latency.observe(latency_s, n)
        self._requests.inc(n)

    def observe_flush(self, n_ticks: int, seconds: float) -> None:
        """Record one micro-batch flush: ``n_ticks`` state updates in
        ``seconds`` of wall-clock."""
        self._flushes.inc()
        self._ticks.inc(n_ticks)
        self._busy.inc(seconds)

    def observe_staleness(self, seconds: float) -> None:
        """Record the current serving-snapshot staleness (seconds since
        the oldest attached posterior was banked/attached). The gauge
        holds the latest read; the peak is the window watermark the SLO
        evaluation consumes."""
        s = float(seconds)
        self._staleness.set(s)
        if not (self._staleness_peak >= s):  # NaN-safe max
            self._staleness_peak = s

    def note_degraded_response(self, n: int = 1) -> None:
        self._degraded_responses.inc(n)

    def note_degraded_attach(self) -> None:
        self._degraded_attaches.inc()

    def note_superseded_response(self) -> None:
        """A tick() dict collapse dropped an older same-series response
        (latest-wins); the filter state still folded that tick."""
        self._superseded_responses.inc()

    def note_shed_tick(self, n: int = 1, tenant: Optional[str] = None) -> None:
        """``n`` ticks were shed — dropped under admission pressure or
        degraded by a dispatch failure — each surfaced as a
        ``shed=True`` :class:`~hhmm_tpu_torch.serve.scheduler.TickResponse`,
        never an exception. With a ``tenant`` (the request-plane key,
        `obs/request.py`; default tenant = series) the shed is ALSO
        counted under a ``serve.shed_ticks{tenant=...}`` label on the
        shared plane, so a hot tenant's pressure shedding a quiet one
        is attributable — the labeled route is the registry's gated
        accessor (no-op while the plane is disabled, and the bound's
        exact-label slots are only consumed while it is enabled); the
        unlabeled attached counter stays the always-on product total.
        Label cardinality is bounded (`obs/request.py`
        ``DEFAULT_MAX_TENANTS``, overflow fold) — tenant = series at
        fleet scale must not grow the registry one instrument per
        shedding series."""
        self._shed_ticks.inc(n)
        if tenant is not None and obs_metrics.enabled():
            obs_metrics.counter(
                "serve.shed_ticks", tenant=self._tenant_label(tenant)
            ).inc(n)

    def note_rejected_attach(self, n: int = 1) -> None:
        """``n`` attach items were rejected (admission capacity or
        per-item validation) without failing the rest of the batch."""
        self._rejected_attaches.inc(n)

    def note_dispatch_error(
        self, n_ticks: int = 1, tenants: Optional[Sequence[str]] = None
    ) -> None:
        """One dispatch group failed; its ``n_ticks`` ticks degraded
        into shed responses. ``tenants``: the failed ticks' tenant
        keys, for the per-tenant shed label (one count each)."""
        self._dispatch_errors.inc()
        self._shed_ticks.inc(n_ticks)
        if tenants and obs_metrics.enabled():
            for t in tenants:
                obs_metrics.counter(
                    "serve.shed_ticks", tenant=self._tenant_label(t)
                ).inc()

    def note_device_loss(self) -> None:
        """A dispatch failure classified as device loss (simulated or
        real UNAVAILABLE) was absorbed by the flush path."""
        self._device_loss_events.inc()

    def note_tail_eviction(self, n: int = 1) -> None:
        """``n`` retained history tails were dropped by host-byte
        pressure (``tail_budget_bytes``) — those series page back in
        COLD next time. NOT in ``summary()`` (schema frozen)."""
        self._tail_evictions.inc(n)

    def note_tail_bytes(self, nbytes: int) -> None:
        """Current host bytes held by retained history tails."""
        self._tail_bytes.set(float(nbytes))

    def note_warm_page_in(self) -> None:
        """A pager page-in replayed the series' retained history tail
        through the attach machinery instead of cold filtering."""
        self._warm_page_ins.inc()

    def note_h2d_bytes(self, nbytes: int) -> None:
        """``nbytes`` newly materialized into one dispatch's staged
        input buffers (folded observations + any carry restack; a
        resident bank hit contributes 0 for the carry)."""
        if nbytes:
            self._h2d_bytes.inc(int(nbytes))

    def note_d2h_bytes(self, nbytes: int) -> None:
        """``nbytes`` pulled back to host as one dispatch's batched
        response surface (probs / loglik / per-draw increments / ok)."""
        if nbytes:
            self._d2h_bytes.inc(int(nbytes))

    def note_carry_bytes(self, nbytes: int) -> None:
        """Current device bytes held by resident carry banks (the lane
        table's incremental accounting; 0 with residency off)."""
        self._carry_bytes.set(float(nbytes))

    @property
    def h2d_bytes(self) -> int:
        return int(self._h2d_bytes.get())

    @property
    def d2h_bytes(self) -> int:
        return int(self._d2h_bytes.get())

    @property
    def carry_resident_bytes(self) -> int:
        v = self._carry_bytes.get()
        return 0 if v != v else int(v)  # NaN-safe: gauge unset = 0

    def note_inflight_deferred(self, n: int = 1) -> None:
        """An async dispatch generation deferred ``n`` queued ticks
        whose series still had un-harvested flights (the pipeline's
        fold-order guard) — deferred, not shed: they stay queued and
        drain the next generation."""
        self._inflight_deferred.inc(n)

    @property
    def inflight_deferred_ticks(self) -> int:
        return int(self._inflight_deferred.get())

    @property
    def tail_evictions(self) -> int:
        return int(self._tail_evictions.get())

    @property
    def warm_page_ins(self) -> int:
        return int(self._warm_page_ins.get())

    @property
    def tail_resident_bytes(self) -> int:
        v = self._tail_bytes.get()
        return 0 if v != v else int(v)  # NaN-safe: gauge unset = 0

    @property
    def profiled_flushes(self) -> int:
        return int(self._profiled_flushes.get())

    def note_flush_profile(self, kernel: str, bucket: int, p50_s: float) -> None:
        """One sampled flush re-timed its dispatched kernel through the
        `obs/profile.py` harness. The per-(kernel, bucket) device time
        goes to the shared plane as a labeled gauge — profiling only
        runs with the tracer on (scheduler contract), which is exactly
        when the registry's instrument route is live; the counter is an
        attached product metric either way. NOT in ``summary()`` — its
        schema is frozen."""
        self._profiled_flushes.inc()
        obs_metrics.gauge(
            "serve.flush_device_time_ms", kernel=kernel, bucket=bucket
        ).set(round(float(p50_s) * 1e3, 4))

    @property
    def compile_count(self) -> int:
        return self._compile_scope.get()

    def set_compile_count(self, n: int) -> None:
        self._compile_scope.set(int(n))

    # ---- reading ----

    def quantile(self, q: float) -> float:
        """Latency quantile (seconds), conservative (upper bucket edge).
        A quantile landing in the unbounded overflow bucket (beyond the
        last edge) returns ``inf`` — a pathological tail must read as
        pathological, not as the largest edge; an empty histogram
        returns ``nan``. Semantics pinned by
        `obs/metrics.Histogram.quantile`."""
        return self.latency.quantile(q)

    def staleness_seconds(self) -> float:
        """Latest staleness read (NaN before the first flush)."""
        return self._staleness.get()

    def peak_staleness_seconds(self) -> float:
        """Worst staleness observed in the current measurement window
        (NaN if never observed) — the SLO-facing watermark."""
        return self._staleness_peak

    def ticks_per_sec(self) -> float:
        busy = self.busy_seconds
        return self.ticks / busy if busy > 0 else float("nan")

    def summary(self) -> Dict[str, float]:
        """JSON-ready metrics record.
        An empty measurement window reports ``None`` (JSON null) and an
        overflow-bucket quantile the string ``"inf"`` — never a bare
        NaN/Infinity token that breaks strict JSON consumers of the
        bench records. Schema frozen (``tests/test_obs.py``)."""

        def _q_ms(q: float):
            v = self.quantile(q)
            if np.isnan(v):
                return None
            return round(v * 1e3, 4) if np.isfinite(v) else "inf"

        tps = self.ticks_per_sec()
        return {
            "requests": self.requests,
            "ticks": self.ticks,
            "flushes": self.flushes,
            "ticks_per_sec": None if np.isnan(tps) else round(tps, 1),
            "latency_p50_ms": _q_ms(0.50),
            "latency_p90_ms": _q_ms(0.90),
            "latency_p99_ms": _q_ms(0.99),
            "degraded_responses": self.degraded_responses,
            "degraded_attaches": self.degraded_attaches,
            "superseded_responses": self.superseded_responses,
            "shed_ticks": self.shed_ticks,
            "rejected_attaches": self.rejected_attaches,
            "dispatch_errors": self.dispatch_errors,
            "device_loss_events": self.device_loss_events,
            "compile_count": int(self.compile_count),
            "h2d_bytes": self.h2d_bytes,
            "d2h_bytes": self.d2h_bytes,
            "carry_resident_bytes": self.carry_resident_bytes,
        }


# ---- adaptation-plane metrics (the adapt plane, still to port) ----


class AdaptMetrics:
    """Always-on counters/gauges for the tick-cadence adaptation plane
    (the JAX package's ``adapt/``): how often weights moved, how degenerate the
    particle cloud got, and how far up the escalation ladder
    (reweight → rejuvenate → refit, docs/maintenance.md) each window
    climbed. Lives in serve/ — not adapt/ — so the import stays DOWN
    the layer DAG (adapt ranks above serve) and the instruments share
    the scheduler metrics' attach-once registry discipline. Product
    metrics like ``ServeMetrics``: they record regardless of the trace
    flag. NOT in ``ServeMetrics.summary()`` (schema frozen); read them
    from the properties or the shared registry exports."""

    def __init__(self):
        self._reweight_ticks = obs_metrics.Counter()
        self._rejuvenations = obs_metrics.Counter()
        self._escalations = obs_metrics.Counter()
        # the smallest effective sample size observed across the fleet
        # since the last set — the degeneracy watermark the ESS-floor
        # gate (scripts/bench_diff.py) reads
        self._ess_min = obs_metrics.Gauge()
        for name, inst in (
            ("adapt.reweight_ticks", self._reweight_ticks),
            ("adapt.rejuvenations", self._rejuvenations),
            ("adapt.escalations", self._escalations),
            ("adapt.ess_min", self._ess_min),
        ):
            obs_metrics.attach(name, inst)

    def note_reweight(self, n: int = 1) -> None:
        self._reweight_ticks.inc(n)

    def note_rejuvenation(self, n: int = 1) -> None:
        self._rejuvenations.inc(n)

    def note_escalation(self, n: int = 1) -> None:
        self._escalations.inc(n)

    def set_ess_min(self, v: float) -> None:
        self._ess_min.set(v)

    @property
    def reweight_ticks(self) -> int:
        return int(self._reweight_ticks.get())

    @property
    def rejuvenations(self) -> int:
        return int(self._rejuvenations.get())

    @property
    def escalations(self) -> int:
        return int(self._escalations.get())

    @property
    def ess_min(self) -> float:
        return float(self._ess_min.get())


# ---- serve SLOs ----


@dataclass(frozen=True)
class SLOSpec:
    """Explicit serving objectives: p99 tick latency, snapshot staleness
    bound, post-warmup recompile budget. The defaults are a bar a CPU
    test passes; deployments pass their own. A spec is a gate
    definition, not workload."""

    p99_latency_ms: float = 250.0
    max_staleness_s: float = 900.0
    max_post_warmup_recompiles: int = 0


def evaluate_slo(
    spec: SLOSpec,
    *,
    p99_latency_ms: Any,
    staleness_s: Any,
    post_warmup_recompiles: Any,
) -> Dict[str, Any]:
    """One measurement window → SLO attainment verdict.

    ``p99_latency_ms`` accepts the ``summary()`` encoding directly
    (``None`` = empty window, ``"inf"`` = overflow tail) — both FAIL
    their check: attainment must be *demonstrated*, an unmeasured or
    pathological window cannot claim it. Returns a JSON-ready dict
    (``{"attained": bool, "spec": ..., "checks": {...}}``)."""

    def check(observed, limit) -> Dict[str, Any]:
        if observed is None:
            return {"observed": None, "limit": limit, "ok": False,
                    "reason": "unmeasured"}
        if isinstance(observed, str):  # the summary() "inf" encoding
            obs_v = float("inf") if observed == "inf" else float("nan")
        else:
            obs_v = float(observed)
        ok = bool(np.isfinite(obs_v) and obs_v <= limit)
        rec: Dict[str, Any] = {
            "observed": observed if isinstance(observed, str) else round(obs_v, 4),
            "limit": limit,
            "ok": ok,
        }
        if not np.isfinite(obs_v):
            rec["reason"] = "non-finite observation"
        return rec

    # NaN staleness (never observed) must fail, not pass vacuously
    if isinstance(staleness_s, float) and np.isnan(staleness_s):
        staleness_s = None
    checks = {
        "p99_latency_ms": check(p99_latency_ms, spec.p99_latency_ms),
        "staleness_s": check(staleness_s, spec.max_staleness_s),
        "post_warmup_recompiles": check(
            post_warmup_recompiles, spec.max_post_warmup_recompiles
        ),
    }
    return {
        "attained": all(c["ok"] for c in checks.values()),
        "spec": asdict(spec),
        "checks": checks,
    }
