#!/usr/bin/env python
"""Render one of the port's run manifests + metrics export as a text
dashboard (counterpart of ``scripts/obs_report.py``).

The consumer end of the port's observability stack:
`hhmm_tpu_torch/obs/manifest.py` pins what ran, `obs/trace.py` where the
time went, `obs/telemetry.py` what nvcc built and what the CUDA
allocator held, and `obs/metrics.py` the statistical health. This
script folds all of it into one readable report:

  == run ==          host, stack (python, torch, CUDA), hardware and the
                     card's name and power limit, git, workload digest
  == spans ==        hottest-first span table (count/total/p50/p99)
  == compile ==      the kernel builds: nvcc builds and library loads,
                     seconds per phase and per CUDA source, component
                     scopes
  == memory ==       the CUDA caching allocator's peaks per device
                     (allocated and reserved bytes, the card's memory)
  == plan ==         the execution planner's resolved layout
  == kernel costs == the `obs/profile.py` cost plane: per-kernel device
                     time, FLOPs, roofline fraction, and which dispatch
                     branches are DB-backed vs table-backed vs unmeasured
  == convergence ==  the per-chunk interim R-hat/ESS/divergence/quarantine
                     trajectory a traced `batch/fit.py` run emits
  == serving ==      tick latency, throughput, staleness, drift alarms,
                     overload/resilience counters
  == request timeline == the `obs/request.py` plane: per-tenant tick
                     latency decomposed into queue/device/other shares,
                     fairness observables, flush-order attribution
  == pipeline ==     the async flush plane: in-flight depth, the
                     sync-vs-async overlap duel, placement
  == storm ==        the serve-storm verdict: faults injected/escaped
  == maintenance ==  drift triggers -> warm refits -> shadow verdicts ->
                     promotions
  == adaptation ==   reweight -> rejuvenate -> refit ladder
  == analysis ==     the `hhmm_tpu_torch.analysis` static-analyzer
                     verdict: per-family + per-rule finding/suppression
                     counts, the lock-order DAG verdict, and the
                     zero-unsuppressed-findings assertion (embedded
                     `analysis` stanza or `--analysis report.json`)
  == slo ==          per-check PASS/FAIL + overall attainment

The sections whose stanzas have the JAX manifest's keys (spans, plan,
kernel costs, convergence, serving, request, pipeline, storm,
maintenance, adaptation, analysis, slo) render the same text as
``scripts/obs_report.py`` does; run, compile and memory read the port's
stanzas.

Inputs: the full manifest JSON (``obs.manifest.write_manifest``), which
embeds the metrics snapshot; ``--metrics`` optionally points at a JSONL
export (``obs.metrics.export_jsonl``) to use instead.

Stdlib only — no torch import: it renders records on hosts without the
port's stack. Exit 0 on success, 2 on unreadable input.

Usage::

    python obs_report_torch.py chiprun_out/obs_manifest.json
    python obs_report_torch.py MANIFEST --metrics run.metrics.jsonl \
        --analysis analysis.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

# ---- formatting helpers ----


def _table(headers: Tuple[str, ...], rows: List[Tuple[str, ...]], out) -> None:
    if not rows:
        print("  (empty)", file=out)
        return
    widths = [
        max(len(headers[i]), *(len(r[i]) for r in rows)) for i in range(len(headers))
    ]
    fmt = "  " + "  ".join(f"{{:<{w}}}" for w in widths)
    print(fmt.format(*headers), file=out)
    print(fmt.format(*("-" * w for w in widths)), file=out)
    for r in rows:
        print(fmt.format(*r), file=out)


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)


def _section(title: str, out) -> None:
    print(f"\n== {title} ==", file=out)


# ---- metrics helpers ----


def parse_metric_key(key: str) -> Tuple[str, Dict[str, str]]:
    """``name{k=v,...}`` → (name, labels) — the snapshot key format."""
    name, _, rest = key.partition("{")
    labels: Dict[str, str] = {}
    if rest:
        for pair in rest.rstrip("}").split(","):
            k, _, v = pair.partition("=")
            labels[k] = v
    return name, labels


def load_metrics_jsonl(path: str) -> Dict[str, Dict[str, Any]]:
    """JSONL export → the snapshot dict shape (keyed by rendered key)."""
    out: Dict[str, Dict[str, Any]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            key = rec.pop("key", None) or rec.get("name", "?")
            rec.pop("name", None)
            rec.pop("labels", None)
            out[key] = rec
    return out


def hist_quantile(state: Dict[str, Any], q: float) -> float:
    """Conservative upper-edge quantile from an exported histogram
    state — mirrors `obs/metrics.Histogram.quantile` without numpy."""
    total = state.get("count", 0)
    if not total:
        return float("nan")
    target = max(q * total, 1e-300)
    cum = 0
    for edge, c in zip(state["edges"], state["counts"]):
        cum += c
        if cum >= target:
            return float(edge)
    return float("inf")


# ---- sections ----


def render_run(man: Dict[str, Any], out) -> None:
    _section("run", out)
    versions = man.get("versions") or {}
    git = man.get("git") or {}
    rows = [
        ("host", _fmt(man.get("hostname"))),
        (
            "hardware",
            f"{_fmt(man.get('backend'))} / {_fmt(man.get('device_kind'))}"
            f" x{_fmt(man.get('device_count'))}",
        ),
        ("card", _fmt(man.get("nvidia_smi") and "; ".join(man["nvidia_smi"]))),
        (
            "stack",
            f"python {_fmt(versions.get('python'))}, "
            f"torch {_fmt(versions.get('torch'))}, "
            f"cuda {_fmt(versions.get('cuda_runtime'))} "
            f"(driver {_fmt(versions.get('cuda_driver'))})",
        ),
        (
            "git",
            f"{_fmt(git.get('rev'))[:12]}"
            + (" (dirty)" if git.get("dirty") else ""),
        ),
        ("seed", _fmt(man.get("seed"))),
        ("workload_digest", _fmt(man.get("workload_digest"))),
        ("trace_enabled", _fmt(man.get("trace_enabled"))),
        ("bench_mode", _fmt(man.get("bench_mode"))),
    ]
    _table(("field", "value"), rows, out)


def render_spans(man: Dict[str, Any], out) -> None:
    _section("spans (hottest first)", out)
    spans = man.get("spans") or {}
    rows = [
        (
            name,
            _fmt(t.get("count")),
            _fmt(t.get("total_s")),
            _fmt(t.get("p50_ms")),
            _fmt(t.get("p99_ms")),
            _fmt(t.get("max_ms")),
        )
        for name, t in spans.items()
    ]
    _table(("span", "count", "total_s", "p50_ms", "p99_ms", "max_ms"), rows, out)


def render_compile(man: Dict[str, Any], out) -> None:
    """The kernel builds (`obs/telemetry.py`, reported by
    `kernels/cuda_build.py`): CUDA sources built by nvcc in the run, the
    seconds of each phase (``nvcc_build``, ``library_load``), the same
    per source, and the component scopes."""
    _section("compile", out)
    comp = man.get("compile") or {}
    print(f"  nvcc builds: {_fmt(comp.get('backend_compiles'))}", file=out)
    secs = comp.get("compile_seconds") or {}
    for phase, s in sorted(secs.items()):
        print(f"  {phase}: {_fmt(s)} s", file=out)
    builds = comp.get("builds") or {}
    if builds:
        _table(
            ("source", "nvcc_build_s", "library_load_s"),
            [
                (src, _fmt(b.get("nvcc_build")), _fmt(b.get("library_load")))
                for src, b in sorted(builds.items())
                if isinstance(b, dict)
            ],
            out,
        )
    scopes = comp.get("scopes") or {}
    for label, v in sorted(scopes.items()):
        print(f"  scope {label}: {_fmt(v)}", file=out)


def render_memory(man: Dict[str, Any], out) -> None:
    """The CUDA caching allocator's high-watermarks per device
    (`obs/telemetry.py` ``sample_memory``): allocated and reserved bytes
    now and at peak, and the card's total memory."""
    peak = man.get("peak_memory") or {}
    _section("memory", out)
    if not peak:
        print("  (no CUDA device memory sampled in this run)", file=out)
        return
    rows = []
    for dev, st in sorted(peak.items()):
        rows.append(
            (
                f"cuda:{dev}",
                _fmt(st.get("bytes_in_use")),
                _fmt(st.get("peak_bytes_in_use")),
                _fmt(st.get("reserved_bytes")),
                _fmt(st.get("peak_reserved_bytes")),
                _fmt(st.get("bytes_limit")),
            )
        )
    _table(
        ("device", "allocated", "peak_allocated", "reserved", "peak_reserved", "limit"),
        rows,
        out,
    )


def _record_manifest(man: Dict[str, Any]) -> Dict[str, Any]:
    """The embedded record's compact manifest stanza, for stanzas
    (`slo`, `storm`, `kernel_costs`) that a benchmark driver attaches to the
    record rather than the full manifest's top level."""
    rec = man.get("record")
    if isinstance(rec, dict) and isinstance(rec.get("manifest"), dict):
        return rec["manifest"]
    return {}


def render_plan(man: Dict[str, Any], out) -> None:
    """The execution planner's resolved-layout stanza (`hhmm_tpu_torch/plan/`
    ``note_stanza("plan", ...)``): which mesh/chunk/
    branch actually ran, and why devices idled if any did."""
    plan = man.get("plan") or _record_manifest(man).get("plan")
    if not isinstance(plan, dict):
        return  # not a planned run: no section
    _section("plan", out)
    wl = plan.get("workload") or {}
    if wl:
        print(
            "  workload: "
            + " ".join(f"{k}={_fmt(wl.get(k))}" for k in ("B", "T", "C", "K")),
            file=out,
        )
    mesh = plan.get("mesh")
    if isinstance(mesh, dict) and mesh:
        mesh_s = " x ".join(f"{k}:{v}" for k, v in mesh.items())
    else:
        mesh_s = "none (single device)"
    print(
        f"  mesh: {mesh_s}  (devices used "
        f"{_fmt(plan.get('devices_used'))}/{_fmt(plan.get('devices'))} "
        f"on {_fmt(plan.get('platform'))})",
        file=out,
    )
    chunk, req = plan.get("chunk"), plan.get("chunk_requested")
    chunk_s = _fmt(chunk)
    if req is not None and req != chunk:
        chunk_s += f" (requested {_fmt(req)}, rounded to the series ways)"
    print(f"  chunk: {chunk_s}", file=out)
    buckets = plan.get("buckets")
    if buckets:
        print(
            f"  serve buckets: {buckets} (shard from "
            f"{_fmt(plan.get('shard_min_bucket'))} lanes)",
            file=out,
        )
    print(f"  time-parallel branch: {_fmt(plan.get('branch'))}", file=out)
    if plan.get("reason"):
        print(f"  rationale: {plan['reason']}", file=out)


def _pct(v: Any) -> str:
    return f"{100 * v:.1f}%" if isinstance(v, (int, float)) else "-"


def render_request(man: Dict[str, Any], out) -> None:
    """The request plane (`hhmm_tpu_torch/obs/request.py`): per-tenant
    lifecycle decomposition + fairness observables."""
    req = man.get("request") or _record_manifest(man).get("request")
    if not isinstance(req, dict):
        return  # no lifecycle recorder in this run: no section
    _section("request timeline", out)
    rows = []
    for tenant, t in sorted((req.get("tenants") or {}).items()):
        if not isinstance(t, dict):
            continue
        rows.append(
            (
                tenant,
                _fmt(t.get("ticks")),
                _fmt(t.get("sheds")),
                _fmt(t.get("p50_ms")),
                _fmt(t.get("p99_ms")),
                _pct(t.get("queue_share")),
                _pct(t.get("device_share")),
                _pct(t.get("other_share")),
                _fmt(t.get("max_queue_depth")),
            )
        )
    _table(
        (
            "tenant",
            "ticks",
            "sheds",
            "p50_ms",
            "p99_ms",
            "queue",
            "device",
            "other",
            "max_q",
        ),
        rows,
        out,
    )
    omitted = req.get("tenants_omitted")
    if omitted:
        print(f"  (+{omitted} tenant(s) omitted from the stanza)", file=out)
    overall = req.get("overall") or {}
    if overall:
        print(
            f"  overall: {_fmt(overall.get('ticks'))} ticks, "
            f"{_fmt(overall.get('sheds'))} sheds — queue "
            f"{_pct(overall.get('queue_share'))}, device "
            f"{_pct(overall.get('device_share'))}, other "
            f"{_pct(overall.get('other_share'))} "
            f"(window {_fmt(req.get('window_s'))} s)",
            file=out,
        )
    fair = req.get("fairness") or {}
    if fair:
        print(
            f"  fairness: p99 spread {_fmt(fair.get('p99_spread_ms'))} ms, "
            f"max queue-age at dispatch {_fmt(fair.get('max_queue_age_ms'))} "
            f"ms, {_fmt(fair.get('mean_flush_tenants'))} tenants/flush over "
            f"{_fmt(fair.get('flushes'))} flushes",
            file=out,
        )
    profiled = req.get("profiled_device_ms") or {}
    for k, v in sorted(profiled.items()):
        print(f"  warm device re-time {k}: {_fmt(v)} ms", file=out)
    sched = req.get("scheduler")
    if isinstance(sched, dict):
        print(
            f"  flush order: {_fmt(sched.get('order'))} "
            f"(credit cap {_fmt(sched.get('credit_cap'))} ticks, last "
            f"flush {'>'.join(sched.get('last_flush_order') or []) or '-'})",
            file=out,
        )
        rows = []
        for tenant, t in sorted((sched.get("tenants") or {}).items()):
            if not isinstance(t, dict):
                continue
            rows.append(
                (
                    tenant,
                    _fmt(t.get("share")),
                    _fmt(t.get("served")),
                    _fmt(t.get("stranded")),
                    _fmt(t.get("credit")),
                    _fmt(t.get("credit_max")),
                )
            )
        _table(
            ("tenant", "share", "served", "stranded", "credit", "credit_max"),
            rows,
            out,
        )
    events = req.get("events")
    if isinstance(events, dict):
        print(
            f"  regime events: {_fmt(events.get('flips'))} flips, "
            f"{_fmt(events.get('drifts'))} drift alarms "
            f"(serve/events.py feed)",
            file=out,
        )
        rows = []
        for tenant, t in sorted((events.get("tenants") or {}).items()):
            if not isinstance(t, dict):
                continue
            rows.append((tenant, _fmt(t.get("flips")), _fmt(t.get("drifts"))))
        _table(("tenant", "flips", "drifts"), rows, out)


def render_kernel_costs(man: Dict[str, Any], out) -> None:
    """The `obs/profile.py` cost plane: measured device time + counted cost
    analysis per kernel/branch, and the dispatch-source audit — which
    ``"auto"`` branches rest on a measured DB row, which on the
    checked-in table, which on nothing (`kernels/dispatch.py`)."""
    _section("kernel costs", out)
    kc = man.get("kernel_costs") or _record_manifest(man).get("kernel_costs")
    if not isinstance(kc, dict):
        print("  (no kernel-cost rows in this run)", file=out)
        return
    rows = []
    for r in kc.get("rows") or []:
        if not isinstance(r, dict):
            continue
        frac = r.get("flops_frac")
        rows.append(
            (
                f"{_fmt(r.get('kernel'))}[{_fmt(r.get('branch'))}]",
                _fmt(r.get("K")),
                _fmt(r.get("T")),
                _fmt(r.get("B")),
                _fmt(r.get("dtype")),
                _fmt(r.get("p50_ms")),
                _fmt(r.get("flops")),
                "-" if not isinstance(frac, (int, float)) else f"{100 * frac:.4g}%",
                "timing-only" if r.get("timing_only") else "",
            )
        )
    _table(
        ("kernel", "K", "T", "B", "dtype", "p50_ms", "flops", "flops_peak", ""),
        rows,
        out,
    )
    src_label = {
        "db": "DB-backed",
        "table": "table-backed",
        "plan": "plan-pinned",
        "default": "unmeasured (scan default)",
    }
    branches = kc.get("branches")
    if isinstance(branches, (list, tuple)) and branches:
        print(f"  raced branches: {'/'.join(str(b) for b in branches)}", file=out)
    for d in kc.get("dispatch") or []:
        if not isinstance(d, dict):
            continue
        raced = d.get("raced")
        tail = (
            f" [raced {'/'.join(str(b) for b in raced)}]"
            if isinstance(raced, (list, tuple)) and raced
            else ""
        )
        print(
            f"  auto {_fmt(d.get('kernel'))} K={_fmt(d.get('K'))} "
            f"T={_fmt(d.get('T'))}: {_fmt(d.get('auto'))} "
            f"({src_label.get(d.get('source'), _fmt(d.get('source')))})"
            f"{tail}",
            file=out,
        )
    if kc.get("db_path"):
        print(f"  cost DB: {kc['db_path']}", file=out)


def render_pipeline(man: Dict[str, Any], out) -> None:
    """The async flush pipeline (`hhmm_tpu_torch/pipeline/`): in-flight
    dispatch/harvest depth from the request stanza, the sync-vs-async
    overlap duel verdict (the benchmark's pipeline arm), consistent-hash
    placement and the per-device fan-out table."""
    pipe = man.get("pipeline") or _record_manifest(man).get("pipeline")
    req = man.get("request") or _record_manifest(man).get("request")
    flight = req.get("pipeline") if isinstance(req, dict) else None
    if not isinstance(pipe, dict) and not isinstance(flight, dict):
        return  # no async pipeline in this run: no section
    _section("pipeline", out)
    if isinstance(flight, dict):
        print(
            f"  in-flight: depth {_fmt(flight.get('in_flight_depth'))} "
            f"(peak {_fmt(flight.get('in_flight_peak'))}), "
            f"{_fmt(flight.get('harvested_flights'))} flight(s) harvested",
            file=out,
        )
    if not isinstance(pipe, dict):
        return
    if "async_queue_share" in pipe:
        print(
            "  overlap duel: queue share sync "
            f"{_pct(pipe.get('sync_queue_share'))} -> async "
            f"{_pct(pipe.get('async_queue_share'))}, hidden "
            f"{_pct(pipe.get('overlap_share'))} of device time, "
            f"{_fmt(pipe.get('parity_mismatches'))} parity mismatch(es) — "
            + ("OK" if pipe.get("ok") else "REGRESSED"),
            file=out,
        )
    # prefer the serving fleet's own counters (the main replay) over
    # the duel's synthetic cohort when both are present
    fleet = pipe.get("fleet")
    src = fleet if isinstance(fleet, dict) else pipe
    if src is fleet and "overlap_share" in src:
        print(
            f"  replay overlap share: {_pct(src.get('overlap_share'))}",
            file=out,
        )
    placement = src.get("placement")
    if isinstance(placement, dict) and placement:
        print(
            f"  placement: {_fmt(placement.get('algo'))} over "
            f"{_fmt(src.get('n_devices'))} device(s), "
            f"{_fmt(src.get('deferred_ticks'))} tick(s) deferred by the "
            "fold-order guard",
            file=out,
        )
    served = src.get("per_device_served")
    if isinstance(served, dict) and served:
        rows = [
            (str(d), _fmt(n))
            for d, n in sorted(served.items(), key=lambda kv: str(kv[0]))
        ]
        _table(("device", "served"), rows, out)


def render_storm(man: Dict[str, Any], out) -> None:
    """The serve-storm stanza (the benchmark's storm arm): injected-fault plan,
    escaped-fault count, the survival gates, and
    the two-tenant fairness arms (balanced probe vs skewed storm)."""
    storm = man.get("storm") or _record_manifest(man).get("storm")
    if not isinstance(storm, dict):
        return  # not a storm run: no section (unlike slo, storms are rare)
    _section("storm", out)
    esc = storm.get("faults_escaped")
    print(f"  faults escaped: {_fmt(esc)}", file=out)
    fair = storm.get("fairness")
    if isinstance(fair, dict):
        print(
            "  fairness arms: skewed p99 spread "
            f"{_fmt(fair.get('skewed_p99_spread_ms'))} ms vs balanced "
            f"{_fmt(fair.get('balanced_p99_spread_ms'))} ms",
            file=out,
        )
        if "drr_p99_spread_ms" in fair:
            print(
                "  fairness duel: fifo "
                f"{_fmt(fair.get('fifo_p99_spread_ms'))} ms -> drr "
                f"{_fmt(fair.get('drr_p99_spread_ms'))} ms (balanced arm "
                f"{_fmt(fair.get('probe_balanced_p99_spread_ms'))} ms, "
                f"storm order {_fmt(fair.get('flush_order'))})",
                file=out,
            )
    wpi = storm.get("warm_page_in")
    if isinstance(wpi, dict):
        print(
            "  warm page-in: "
            + ("parity" if wpi.get("parity") else "MISMATCH")
            + f" over {_fmt(wpi.get('ticks'))} ticks (loglik delta "
            f"{_fmt(wpi.get('loglik_delta'))}, page-ins "
            f"{_fmt(wpi.get('warm_page_ins'))})",
            file=out,
        )
    inj = storm.get("faults_injected") or {}
    if isinstance(inj, dict):
        for name, spec in sorted(inj.items()):
            print(f"  injected {name}: {_fmt(spec)}", file=out)
    failed = storm.get("gates_failed")
    if failed:
        for g in failed:
            print(f"  gate FAILED: {g}", file=out)
        print("  verdict: FAILED", file=out)
    else:
        print("  verdict: SURVIVED", file=out)


def render_maint(man: Dict[str, Any], out) -> None:
    """The ``maint`` stanza (`hhmm_tpu_torch/maint/`):
    the drift→refit→shadow→promote ladder's counters and the recent
    event window — how many alarms became refits, how many candidates
    won shadow evaluation and were promoted, and what each promotion's
    paired predictive-loglik verdict was."""
    maint = man.get("maint") or _record_manifest(man).get("maint")
    if not isinstance(maint, dict):
        return  # no maintenance plane in this run: no section
    _section("maintenance", out)
    for key, label in (
        ("triggers", "triggers (alarm/staleness -> refit request)"),
        ("refits", "warm refits"),
        ("promotions", "promotions"),
        ("shadow_rejections", "shadow rejections"),
        ("skipped_refits", "skipped refits"),
        ("failed_swaps", "failed swaps"),
        ("refit_seconds", "refit seconds"),
        ("dropped_triggers", "dropped triggers"),
        ("pending", "pending requests"),
    ):
        if key in maint:
            print(f"  {label}: {_fmt(maint.get(key))}", file=out)
    events = maint.get("events")
    if isinstance(events, list) and events:
        rows = []
        for e in events:
            if not isinstance(e, dict):
                continue
            shadow = e.get("shadow") or {}
            rows.append(
                (
                    _fmt(e.get("tick")),
                    _fmt(e.get("series")),
                    _fmt(e.get("outcome")),
                    _fmt(e.get("trigger") or e.get("reason")),
                    _fmt(shadow.get("mean_delta")),
                )
            )
        _table(("tick", "series", "outcome", "trigger", "shadow Δ/tick"), rows, out)
    promos = maint.get("promotions")
    if isinstance(promos, (int, float)):
        print(
            "  verdict: "
            + ("LOOP CLOSED" if promos > 0 else "NO PROMOTIONS"),
            file=out,
        )


def render_adapt(man: Dict[str, Any], out) -> None:
    """The ``adapt`` stanza (`hhmm_tpu_torch/adapt/`):
    the reweight→rejuvenate→refit ladder's counters, the per-series
    streaming-ESS table, the recent rejuvenation/escalation events,
    and the TRACKING/STALE verdict (did the adapted mixture beat the
    uniform-stale arm on the post-shift ticks)."""
    adapt = man.get("adapt") or _record_manifest(man).get("adapt")
    if not isinstance(adapt, dict):
        return  # no adaptation plane in this run: no section
    _section("adaptation", out)
    for key, label in (
        ("ess_floor_frac", "ESS floor (fraction of D)"),
        ("forget", "forgetting exponent"),
        ("shrink", "Liu-West shrink a"),
        ("escalate_after", "escalate after (strikes)"),
        ("reweight_ticks", "reweighted ticks"),
        ("rejuvenations", "rejuvenations"),
        ("escalations", "escalations (-> refit queue)"),
        ("ess_min", "ESS min (window)"),
        ("floor_breaches", "series below floor"),
        ("paired_mean_delta", "paired mean delta (nats/tick)"),
        ("pooled_mean_delta", "pooled mean delta (nats/tick)"),
        ("refits_adaptive", "refits (adaptive arm)"),
        ("refits_baseline", "refits (refit-only baseline)"),
    ):
        if key in adapt:
            print(f"  {label}: {_fmt(adapt.get(key))}", file=out)
    ess = adapt.get("ess")
    if isinstance(ess, list) and ess:
        rows = [
            (_fmt(e.get("series")), _fmt(e.get("ess")))
            for e in ess
            if isinstance(e, dict)
        ]
        _table(("series", "ESS"), rows, out)
    events = adapt.get("events")
    if isinstance(events, list) and events:
        rows = []
        for e in events:
            if not isinstance(e, dict):
                continue
            rows.append(
                (
                    _fmt(e.get("tick")),
                    _fmt(e.get("series")),
                    _fmt(e.get("kind")),
                    _fmt(e.get("reason") or e.get("strikes")),
                    _fmt(e.get("ess_before")),
                    _fmt(e.get("ess_after")),
                )
            )
        _table(
            ("tick", "series", "kind", "reason", "ESS before", "ESS after"),
            rows,
            out,
        )
    if "tracking_advantage" in adapt:
        print(
            "  verdict: "
            + ("TRACKING" if adapt.get("tracking_advantage") else "STALE"),
            file=out,
        )


def render_convergence(metrics: Dict[str, Dict[str, Any]], out) -> None:
    _section("convergence (interim, per fit chunk)", out)
    by_chunk: Dict[str, Dict[str, Any]] = {}
    for key, state in metrics.items():
        name, labels = parse_metric_key(key)
        if name.startswith("fit.interim.") and "chunk" in labels:
            by_chunk.setdefault(labels["chunk"], {})[
                name[len("fit.interim.") :]
            ] = state.get("value")
    rows = []
    for chunk in sorted(by_chunk, key=lambda c: (len(c), c)):
        vals = by_chunk[chunk]
        rows.append(
            (
                chunk,
                _fmt(vals.get("rhat_max")),
                _fmt(vals.get("ess_min")),
                _fmt(vals.get("divergence_rate")),
                _fmt(vals.get("quarantined_series")),
            )
        )
    _table(
        ("chunk", "rhat_max", "ess_min", "div_rate", "quarantined"), rows, out
    )
    totals = [
        ("fit.chunks", "chunks"),
        ("fit.divergences", "divergences"),
        ("fit.quarantined_series", "quarantined series"),
        ("fit.heal_attempts", "heal attempts"),
        ("fit.healed_series", "healed series"),
        ("fit.unhealed_series", "unhealed series"),
    ]
    for key, label in totals:
        if key in metrics:
            print(f"  total {label}: {_fmt(metrics[key].get('value'))}", file=out)
    for key, state in sorted(metrics.items()):
        name, labels = parse_metric_key(key)
        if name in ("infer.divergences", "infer.quarantined_chains"):
            print(
                f"  {name}[{labels.get('sampler', '?')}]: "
                f"{_fmt(state.get('value'))}",
                file=out,
            )


def render_serving(metrics: Dict[str, Dict[str, Any]], out) -> None:
    _section("serving", out)
    lat = metrics.get("serve.tick_latency_seconds")
    if lat and lat.get("type") == "histogram":
        p50, p99 = hist_quantile(lat, 0.5), hist_quantile(lat, 0.99)
        print(
            f"  tick latency: p50 {p50 * 1e3:g} ms, p99 {p99 * 1e3:g} ms "
            f"({lat.get('count', 0)} requests)",
            file=out,
        )
    simple = [
        ("serve.ticks", "ticks"),
        ("serve.flushes", "flushes"),
        ("serve.busy_seconds", "busy seconds"),
        ("serve.degraded_responses", "degraded responses"),
        ("serve.degraded_attaches", "degraded attaches"),
        ("serve.superseded_responses", "superseded responses"),
        ("serve.snapshot_staleness_seconds", "snapshot staleness (s)"),
        ("serve.drift_alarms", "drift alarms"),
        # the overload/failure ladder: every rung is a counted,
        # degraded-not-raised outcome — render them or the report
        # claims a storm run served clean traffic
        ("serve.shed_ticks", "shed ticks"),
        ("serve.rejected_attaches", "rejected attaches"),
        ("serve.dispatch_errors", "dispatch errors"),
        ("serve.device_loss_events", "device loss events"),
        ("serve.pager_evictions", "pager evictions"),
        ("serve.pager_reloads", "pager reloads"),
        ("serve.pager_resident_bytes", "pager resident bytes"),
        ("serve.profiled_flushes", "profiled flushes"),
        # transfer telemetry (device-resident carry plane): what the
        # serving path actually moved across the host/device boundary
        ("serve.h2d_bytes", "h2d bytes"),
        ("serve.d2h_bytes", "d2h bytes"),
        ("serve.carry_resident_bytes", "carry resident bytes"),
    ]
    seen = False
    for key, label in simple:
        if key in metrics:
            seen = True
            print(f"  {label}: {_fmt(metrics[key].get('value'))}", file=out)
    if not seen and not lat:
        print("  (no serving metrics in this run)", file=out)


def render_analysis(analysis: Optional[Dict[str, Any]], out) -> None:
    """The `hhmm_tpu_torch.analysis` static-analyzer verdict (``--format
    json`` report, embedded at manifest key ``analysis`` or passed via
    ``--analysis``): per-family and per-rule finding/suppression
    counts, the lock-order DAG verdict, and the
    zero-unsuppressed-findings assertion tier-1 runs under."""
    _section("analysis", out)
    if not isinstance(analysis, dict):
        print("  (no static-analysis report in this run)", file=out)
        return
    rules = analysis.get("rules") or {}
    print(
        f"  files: {_fmt(analysis.get('files_scanned'))}   "
        f"rules: {len(rules)}   "
        f"findings: {len(analysis.get('findings') or [])}   "
        f"suppressed: {_fmt(analysis.get('suppressed_count'))}   "
        f"allowlist: {_fmt(analysis.get('allowlist_entries'))}",
        file=out,
    )
    # per-family rollup (reports predating rule families fold into
    # "unknown" — the per-rule table below still carries them)
    fams: Dict[str, Dict[str, int]] = {}
    for rid, stats in rules.items():
        fam = str(stats.get("family") or "unknown")
        agg = fams.setdefault(fam, {"rules": 0, "findings": 0, "suppressed": 0})
        agg["rules"] += 1
        agg["findings"] += int(stats.get("findings") or 0)
        agg["suppressed"] += int(stats.get("suppressed") or 0)
    if fams:
        _table(
            ("family", "rules", "findings", "suppressed"),
            [
                (fam, str(a["rules"]), str(a["findings"]), str(a["suppressed"]))
                for fam, a in sorted(fams.items())
            ],
            out,
        )
    rows = []
    for rid, stats in sorted(rules.items()):
        if not (stats.get("findings") or stats.get("suppressed")):
            continue
        rows.append(
            (
                rid,
                _fmt(stats.get("severity")),
                _fmt(stats.get("findings")),
                _fmt(stats.get("suppressed")),
            )
        )
    if rows:
        _table(("rule", "severity", "findings", "suppressed"), rows, out)
    for f in (analysis.get("findings") or [])[:20]:
        loc = f"{f.get('file')}:{f.get('line')}" if f.get("line") else f.get("file")
        print(f"  {loc}: [{f.get('rule_id')}] {f.get('message')}", file=out)
    unused = analysis.get("allowlist_unused") or []
    if unused:
        print(f"  unused allowlist entries: {', '.join(map(str, unused))}", file=out)
    lock_order = (analysis.get("extras") or {}).get("lock_order")
    if isinstance(lock_order, dict):
        verdict = _fmt(lock_order.get("verdict"))
        print(
            f"  lock-order: {verdict}   "
            f"locks: {len(lock_order.get('locks') or [])}   "
            f"edges: {len(lock_order.get('edges') or [])}",
            file=out,
        )
        for cyc in lock_order.get("cycles") or []:
            print(f"    cycle: {' -> '.join(map(str, cyc))}", file=out)
    clean = bool(analysis.get("ok"))
    print(
        "  verdict: "
        + ("CLEAN (zero unsuppressed findings)" if clean else "FINDINGS"),
        file=out,
    )


def render_slo(man: Dict[str, Any], out) -> bool:
    _section("slo", out)
    slo = man.get("slo")
    if slo is None:
        rec = man.get("record")
        if isinstance(rec, dict):
            slo = (rec.get("manifest") or {}).get("slo")
    if not isinstance(slo, dict):
        print("  (no SLO verdict in this run)", file=out)
        return True
    rows = []
    for name, c in sorted((slo.get("checks") or {}).items()):
        rows.append(
            (
                name,
                _fmt(c.get("observed")),
                _fmt(c.get("limit")),
                "PASS" if c.get("ok") else "FAIL"
                + (f" ({c['reason']})" if c.get("reason") else ""),
            )
        )
    _table(("check", "observed", "limit", "verdict"), rows, out)
    attained = bool(slo.get("attained"))
    print(f"  overall: {'ATTAINED' if attained else 'UNMET'}", file=out)
    return attained


def render(
    man: Dict[str, Any],
    metrics: Dict[str, Dict[str, Any]],
    out,
    analysis: Optional[Dict[str, Any]] = None,
) -> None:
    print("hhmm_tpu_torch run report", file=out)
    render_run(man, out)
    render_spans(man, out)
    render_compile(man, out)
    render_memory(man, out)
    render_plan(man, out)
    render_kernel_costs(man, out)
    render_convergence(metrics, out)
    render_serving(metrics, out)
    render_request(man, out)
    render_pipeline(man, out)
    render_storm(man, out)
    render_maint(man, out)
    render_adapt(man, out)
    render_analysis(analysis if analysis is not None else man.get("analysis"), out)
    render_slo(man, out)


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("manifest", help="full run manifest JSON (hhmm_tpu_torch/obs/manifest.py)")
    ap.add_argument(
        "--metrics",
        default=None,
        metavar="JSONL",
        help="metrics JSONL export to render instead of the manifest's "
        "embedded snapshot (MetricsRegistry.export_jsonl)",
    )
    ap.add_argument(
        "--analysis",
        default=None,
        metavar="JSON",
        help="hhmm_tpu_torch.analysis --format json report to render instead "
        "of the manifest's embedded `analysis` stanza",
    )
    args = ap.parse_args(argv[1:])
    try:
        with open(args.manifest) as f:
            man = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"obs_report_torch: cannot read manifest {args.manifest}: {e}", file=sys.stderr)
        return 2
    if not isinstance(man, dict):
        print(f"obs_report_torch: {args.manifest} is not a manifest object", file=sys.stderr)
        return 2
    metrics: Dict[str, Dict[str, Any]] = {}
    if args.metrics is not None:
        try:
            metrics = load_metrics_jsonl(args.metrics)
        except (OSError, json.JSONDecodeError) as e:
            print(
                f"obs_report_torch: cannot read metrics {args.metrics}: {e}",
                file=sys.stderr,
            )
            return 2
    else:
        metrics = man.get("metrics") or {}
    analysis: Optional[Dict[str, Any]] = None
    if args.analysis is not None:
        try:
            with open(args.analysis) as f:
                analysis = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(
                f"obs_report_torch: cannot read analysis report {args.analysis}: {e}",
                file=sys.stderr,
            )
            return 2
    render(man, metrics, sys.stdout, analysis=analysis)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
