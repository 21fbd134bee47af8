"""The port's obs plane (`hhmm_tpu_torch/obs/`) against the JAX package's
(`hhmm_tpu/obs/`) on the same inputs, and its hooks in the port.

- spans: the same span and event sequence under the same injectable
  clock gives the same aggregate table (names, counts, durations) and
  the same nesting paths; ``sync`` passes a value with no CUDA tensor
  through and lets a device error raise;
- metrics: the same counter, gauge and histogram updates give
  byte-equal Prometheus text, equal snapshots and equal JSONL exports;
  ``record_sampler_health`` on the same stats gives the same counters,
  and with the plane off it does not touch its tensors;
- ``KernelCostDB``: the same rows give the same ``winner`` and
  ``dispatch_winner``; a corrupt file is quarantined as in JAX;
- ``device_time`` on CPU callables: the JAX statistics, ``arg_sets``
  and ``warmup`` given the same clock;
- ``collect_manifest``: the JAX key set but for the stack fields,
  rendered by ``scripts/obs_report.py`` with exit 0;
- telemetry: kernel builds and loads counted, no memory stats without a
  card; counted kernel costs and the roofline;
- hooks: a small Gaussian Gibbs fit and a ``fit_batched`` run on the CPU
  give bitwise-equal draws with the plane on and off, and the expected
  spans and counters; the dispatch spans name their branch.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hhmm_tpu.obs import manifest as j_manifest
from hhmm_tpu.obs import metrics as j_metrics
from hhmm_tpu.obs import profile as j_profile
from hhmm_tpu.obs import trace as j_trace
from hhmm_tpu_torch.batch import default_init, fit_batched
from hhmm_tpu_torch.infer import GibbsConfig, sample_gibbs
from hhmm_tpu_torch.kernels import dispatch as td
from hhmm_tpu_torch.models import GaussianHMM, NIGPrior
from hhmm_tpu_torch.obs import manifest as t_manifest
from hhmm_tpu_torch.obs import metrics as t_metrics
from hhmm_tpu_torch.obs import profile as t_profile
from hhmm_tpu_torch.obs import telemetry as t_telemetry
from hhmm_tpu_torch.obs import trace as t_trace

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Clock:
    """+1.0 a read (the JAX tests' fake clock); ``step`` sets the
    increment sequence instead, cycled."""

    def __init__(self, steps=(1.0,)):
        self.t, self.i, self.steps = 0.0, 0, steps

    def __call__(self):
        self.t += self.steps[self.i % len(self.steps)]
        self.i += 1
        return self.t


@pytest.fixture
def plane():
    """The port's process-wide plane, enabled and empty for the test,
    restored to the environment's setting after it."""
    t_trace.reset()
    t_metrics.reset()
    t_trace.enable()
    try:
        yield
    finally:
        t_trace.reset()
        t_metrics.reset()
        t_trace.tracer.use_env()
        t_metrics.use_env()


def _drive_tracer(mod):
    t = mod.Tracer(clock=_Clock((1.0, 2.0, 0.5)), sample_cap=4)
    t.enable()
    for i in range(7):
        with t.span("outer") as sp:
            sp.annotate(i=i)
            with t.span("inner"):
                pass
            if i % 3 == 0:
                with t.span("inner"):
                    t.event("branch", kind="x")
    wrapped = t.traced("deco")(lambda x: x + 1)
    assert wrapped(1) == 2
    return t


def test_span_aggregate_and_nesting_match_jax():
    tt, jt = _drive_tracer(t_trace), _drive_tracer(j_trace)
    assert tt.aggregate() == jt.aggregate()
    keys = ("name", "path", "dur_s", "synced", "meta")
    assert [{k: e.get(k) for k in keys} for e in tt.events()] == [
        {k: e.get(k) for k in keys} for e in jt.events()]
    assert tt.dropped() == jt.dropped() == 0


def test_disabled_span_is_the_shared_null_and_env_flag(monkeypatch):
    t = t_trace.Tracer()
    t.disable()
    assert t.span("a") is t.span("b") is t_trace._NULL_SPAN
    value = object()
    assert t.span("a").sync(value) is value
    for flag, on in (("1", True), ("off", False), ("No", False), ("", False)):
        monkeypatch.setenv("HHMM_TPU_TRACE", flag)
        t.use_env()
        assert t.enabled() is on


def test_sync_passes_host_values_and_raises_device_errors(monkeypatch):
    t = t_trace.Tracer()
    t.enable()
    host = (torch.ones(2), {"a": [np.zeros(1)]})
    with t.span("s") as sp:
        assert sp.sync(host) is host

    class _OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    seen = []

    def fail(dev):
        seen.append(dev)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.cuda, "synchronize", fail)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        with t.span("s") as sp:
            sp.sync([torch.zeros(1).as_subclass(_OnCard)])
    assert seen == [torch.device("cuda", 0)]


def _drive_metrics(mod):
    r = mod.MetricsRegistry(enabled=True)
    r.counter("fit.chunks").inc()
    r.counter("infer.divergences", sampler="nuts").inc(3)
    r.counter("infer.divergences", sampler="gibbs").inc(0)
    r.gauge("fit.interim.rhat_max", chunk="1").set(1.0125)
    r.gauge("fit.interim.ess_min", chunk="1")  # never set: NaN
    h = r.histogram("tick.latency", edges=[1e-3, 1e-2, 0.1], path="a b")
    for v in (5e-4, 2e-3, 2e-3, 0.05, 3.0):
        h.observe(v)
    owned = mod.Counter()
    owned.inc(7)
    r.attach("serve.flushes", owned, tenant="t0")
    return r, owned


def test_metrics_exports_match_jax(tmp_path):
    (tr, _keep_t), (jr, _keep_j) = _drive_metrics(t_metrics), _drive_metrics(j_metrics)
    assert tr.to_prometheus() == jr.to_prometheus()
    assert tr.snapshot() == jr.snapshot()
    tr.export_jsonl(str(tmp_path / "t.jsonl"))
    jr.export_jsonl(str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    h = tr.histogram("tick.latency", edges=[1e-3, 1e-2, 0.1], path="a b")
    assert h.quantile(0.5) == 1e-2 and h.quantile(1.0) == math.inf
    off = t_metrics.MetricsRegistry(enabled=False)
    assert off.counter("a") is off.gauge("b") is t_metrics._NULL_INSTRUMENT


class _NoTouch(torch.Tensor):
    """A tensor that fails the test if it is taken to the host."""

    def cpu(self, *a, **k):
        raise AssertionError("the disabled plane touched a tensor")

    def numpy(self, *a, **k):
        raise AssertionError("the disabled plane touched a tensor")


def test_record_sampler_health_matches_jax():
    rng = np.random.default_rng(0)
    stats = {"diverging": rng.random((3, 2, 40)) < 0.1, "chain_healthy": rng.random((3, 2)) < 0.7}
    t_metrics.reset()
    j_metrics.reset()
    t_metrics.enable()
    j_metrics.enable()
    try:
        for sampler in ("nuts", "chees", "gibbs"):
            t_metrics.record_sampler_health(sampler, {k: torch.as_tensor(v) for k, v in stats.items()})
            j_metrics.record_sampler_health(sampler, stats)
        assert t_metrics.snapshot() == j_metrics.snapshot()
        assert t_metrics.snapshot()["infer.transitions{sampler=nuts}"]["value"] == 240
    finally:
        t_metrics.reset()
        j_metrics.reset()
        t_metrics.use_env()
        j_metrics.use_env()
    t_metrics.disable()
    try:
        t_metrics.record_sampler_health("nuts", {
            "diverging": torch.zeros(2, 3, dtype=torch.bool).as_subclass(_NoTouch),
            "chain_healthy": torch.ones(2, dtype=torch.bool).as_subclass(_NoTouch)})
        assert t_metrics.snapshot() == {}
    finally:
        t_metrics.use_env()


ROWS = [  # (kernel, branch, K, T, B, dtype, p50_s)
    ("filter", "seq", 4, 1024, 64, "float32", 3e-3),
    ("filter", "assoc", 4, 1024, 64, "float32", 2e-3),
    ("filter", "pallas", 4, 1024, 64, "float32", 2.5e-3),
    ("filter", "seq", 4, 1024, 1, "float32", 1e-3),  # a lone branch: no race
    ("viterbi", "seq", 8, 256, 8, "float32", 1e-3),
    ("viterbi", "assoc", 8, 256, 8, "float32", 1e-3),  # exact tie: seq wins
    ("ffbs", "seq", 3, 500, 16, "float32", 5e-3),
    ("ffbs", "cuda", 3, 500, 16, "float32", 1e-3),
]


def _db(mod, path):
    db = mod.KernelCostDB(str(path))
    for kernel, branch, K, T, B, dtype, p50 in ROWS:
        timing = mod.DeviceTiming(reps=3, mean_s=p50, p50_s=p50, min_s=p50, max_s=p50,
                                  compile_s=None)
        db.put_row(kernel=kernel, branch=branch, K=K, T=T, B=B, dtype=dtype, timing=timing,
                   device_kind="kind-a", source="test")
    db.save()
    return db


def test_kernel_cost_db_winners_match_jax(tmp_path):
    tdb, jdb = _db(t_profile, tmp_path / "t.json"), _db(j_profile, tmp_path / "j.json")
    points = [("filter", 4, 1024), ("viterbi", 8, 256), ("ffbs", 3, 500), ("filter", 4, 99)]
    for allowed in (None, ("seq", "assoc"), ("seq", "cuda")):
        for kernel, K, T in points:
            assert tdb.winner(kernel, K, T, "kind-a", allowed) == jdb.winner(
                kernel, K, T, "kind-a", allowed)
    assert tdb.winner("filter", 4, 1024, "kind-a") == "assoc"
    assert tdb.winner("ffbs", 3, 500, "kind-b") is None
    t_profile.set_db(str(tmp_path / "t.json"))
    j_profile.set_db(str(tmp_path / "j.json"))
    try:
        for kernel, K, T in points:
            assert t_profile.dispatch_winner(kernel, K, T, "kind-a") == j_profile.dispatch_winner(
                kernel, K, T, "kind-a")
    finally:
        t_profile.set_db(None)
        j_profile.set_db(None)
    key = next(iter(tdb.rows()))
    assert key.split("|")[-1] == torch.__version__  # the JAX key's jax slot holds torch's


def test_kernel_cost_db_quarantines_a_corrupt_file(tmp_path, capsys):
    for mod, name in ((t_profile, "t.json"), (j_profile, "j.json")):
        path = tmp_path / name
        path.write_text('{"version": 1, "rows": [torn')
        assert mod.KernelCostDB(str(path)).load().rows() == {}
        assert not path.exists() and (tmp_path / (name + ".corrupt")).exists()
    err = capsys.readouterr().err
    assert err.count("# kernel_costs: dropping corrupt DB") == 2


def test_default_db_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("HHMM_TPU_TORCH_KERNEL_COSTS", raising=False)
    monkeypatch.delenv("HHMM_TPU_KERNEL_COSTS", raising=False)
    path = t_profile.default_db_path()
    assert path != j_profile.default_db_path()
    assert path.endswith(os.path.join("results_torch", "kernel_costs.json"))


@pytest.mark.parametrize("arg_sets,warmup", [(None, True), (None, False),
                                             ([(1,), (2,), (3,)], True), ([(1,), (2,)], False)])
def test_device_time_matches_jax_on_cpu_callables(monkeypatch, arg_sets, warmup):
    steps = (0.5, 1.0, 2.0, 0.25, 4.0, 1.5, 3.0)
    got = {}
    for mod in (t_profile, j_profile):
        monkeypatch.setattr(mod, "perf_counter", _Clock(steps))
        calls = []
        timing = mod.device_time(lambda x=0: calls.append(x) or np.zeros(1), *(() if arg_sets else (9,)),
                                 reps=5, arg_sets=arg_sets, warmup=warmup)
        got[mod] = (timing.to_json(), calls)
    assert got[t_profile] == got[j_profile]
    timing, calls = got[t_profile]
    assert timing["reps"] == 5 and len(calls) == 5 + warmup
    if arg_sets and warmup:
        assert calls == [3, 1, 2, 1, 2, 1]  # the last set warms up, the rest cycle


def test_phase_clock_is_the_obs_one():
    from hhmm_tpu_torch.apps.tayal import wf

    assert wf.PhaseClock is t_profile.PhaseClock
    sink = {}
    clock = t_profile.PhaseClock(sink, round_digits=3)
    with clock.phase("a"):
        pass
    clock.mark("b")
    assert set(sink) == {"a", "b"} and all(v >= 0 for v in sink.values())


def test_kernel_cost_roofline_and_bound():
    c = t_profile.kernel_cost("FWD", 4, 1024, 256)
    assert c == {"bytes_accessed": 4 * (4 * 256 + 16 * 256 + 2 * 1024 * 4 * 256 + 1024 * 256 + 256),
                 "flops": 1023 * 256 * 4 * 23 + 256 * 18}
    h100 = "NVIDIA H100 80GB HBM3"
    ms, by = t_profile.bound_ms(c, h100)
    assert by == "bytes" and ms == c["bytes_accessed"] / 3.35e12 * 1e3
    r = t_profile.roofline(c, ms / 1e3, h100)
    assert r["bytes_frac"] == pytest.approx(1.0)
    assert t_profile.roofline(c, 1e-3, "unknown card") is None
    for k in t_profile.KERNELS:
        cost = t_profile.kernel_cost(k, 3, 50, 8, valid_steps=100, series=4)
        assert cost["bytes_accessed"] > 0 and cost["flops"] > 0
    with pytest.raises(ValueError):
        t_profile.kernel_cost("GEMM", 3, 50, 8)


def test_telemetry_counts_builds_and_reads_no_memory_without_a_card():
    reg = t_telemetry.CompileRegistry()
    reg.note_build("ffbs_fwd.cu", 2.0)
    reg.note_build("vg_bwd.cu", 3.5)
    reg.note_load("ffbs_fwd.cu", 0.25)
    snap = reg.snapshot()
    assert snap["backend_compiles"] == 2
    assert snap["compile_seconds"] == {"nvcc_build": 5.5, "library_load": 0.25}
    assert snap["builds"]["ffbs_fwd.cu"] == {"nvcc_build": 2.0, "library_load": 0.25}
    assert set(j_manifest.telemetry.registry.snapshot()) <= set(snap)
    assert t_telemetry.sample_memory() == {} and t_telemetry.peak_memory() == {}


def test_manifest_keys_match_jax_and_obs_report_renders(tmp_path, plane):
    with t_trace.span("phase"):
        pass
    t_metrics.counter("fit.chunks").inc()
    kw = dict(config={"num_warmup": 2, "K": 3}, model=GaussianHMM(3), seed=7)
    man = t_manifest.collect_manifest(**kw)
    jman = j_manifest.collect_manifest(**kw)
    # the stack fields differ; stanzas noted by earlier code in this
    # process (a JAX plan, say) ride in every later manifest
    stack = {"platform_version", "backend_error", "nvidia_smi", "power_limit"}
    noted = set(j_manifest._noted_snapshot()) | set(t_manifest._noted_snapshot())
    assert set(man) - stack - noted == set(jman) - stack - noted
    assert set(man["versions"]) == {"python", "hhmm_tpu_torch", "torch", "cuda_runtime",
                                    "cuda_driver", "numpy"}
    assert man["backend"] == "cpu" and man["device_kind"] == "cpu" and man["power_limit"] is None
    assert man["spans"]["phase"]["count"] == 1
    assert man["metrics"]["fit.chunks"]["value"] == 1
    assert man["config_digest"] == jman["config_digest"]  # one digest rule
    path = tmp_path / "m.json"
    t_manifest.write_manifest(str(path), man)
    assert t_manifest.load_manifest(str(path))["seed"] == 7
    rep = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "obs_report.py"), str(path)],
                         capture_output=True, text=True, timeout=120)
    assert rep.returncode == 0, rep.stderr
    assert "phase" in rep.stdout and "cpu / cpu x1" in rep.stdout
    stanza = t_manifest.manifest_stanza(**kw)
    assert stanza["span_names"] == 1 and stanza["hottest_span"]["name"] == "phase"
    path.write_text("{torn")
    assert t_manifest.load_manifest(str(path)) is None and (tmp_path / "m.json.corrupt").exists()


def _gaussian(seed=0, B=3, T=40):
    rng = np.random.default_rng(seed)
    z = (np.cumsum(rng.random((B, T)) < 0.1, axis=1) % 2)
    x = np.where(z == 0, -1.0, 2.0) + rng.normal(size=(B, T)) * 0.7
    return {"x": torch.as_tensor(x, dtype=torch.float32)}


def test_gibbs_fit_is_bitwise_with_the_plane_on_and_off():
    model = GaussianHMM(2, nig_prior=NIGPrior())
    data = _gaussian()
    init = default_init(model, data, 3, 2, seed=1, device="cpu")
    cfg = GibbsConfig(num_warmup=5, num_samples=6, num_chains=2)
    t_trace.tracer.disable()
    try:
        qs0, st0 = sample_gibbs(model, data, init, cfg, seed=3, device="cpu")
        assert t_trace.aggregate() == {}
        t_trace.reset()
        t_metrics.reset()
        t_trace.enable()
        qs1, st1 = sample_gibbs(model, data, init, cfg, seed=3, device="cpu")
        table, snap = t_trace.aggregate(), t_metrics.snapshot()
    finally:
        t_trace.reset()
        t_metrics.reset()
        t_trace.tracer.use_env()
    assert torch.equal(qs0, qs1) and all(torch.equal(st0[k], st1[k]) for k in st0)
    assert table["infer.gibbs.sample"]["count"] == 1
    for name in ("kernels.dispatch.ffbs[plain]", "infer.gibbs.build", "infer.gibbs.update",
                 "infer.gibbs.guard"):
        assert table[name]["count"] == 11, name
    assert snap["infer.transitions{sampler=gibbs}"]["value"] == 3 * 2 * 6
    assert snap["infer.chains{sampler=gibbs}"]["value"] == 6


def test_fit_batched_chunk_spans_and_health(plane, capsys):
    model = GaussianHMM(2, nig_prior=NIGPrior())
    data = {"x": _gaussian(1, B=5, T=30)["x"].numpy()}
    cfg = GibbsConfig(num_warmup=4, num_samples=8, num_chains=2)
    qs, stats = fit_batched(model, data, cfg, chunk_size=3, seed=0, device="cpu")
    table, snap = t_trace.aggregate(), t_metrics.snapshot()
    assert table["batch.fit.chunk"]["count"] == 2
    assert table["infer.gibbs.sample"]["count"] == 2
    assert snap["fit.chunks"]["value"] == 2
    assert {"fit.interim.rhat_max{chunk=1}", "fit.interim.ess_min{chunk=2}",
            "fit.interim.quarantined_series{chunk=1}"} <= set(snap)
    assert "# fit_batched chunk 2/2 health: rhat_max=" in capsys.readouterr().err
    t_trace.disable()
    qs_off, _ = fit_batched(model, data, cfg, chunk_size=3, seed=0, device="cpu")
    assert torch.equal(qs, qs_off)


def test_dispatch_spans_name_their_branch(plane):
    rng = np.random.default_rng(2)
    N, T, K = 2, 12, 3
    lp = torch.log(torch.full((N, K), 1 / K))
    lA = torch.log(torch.as_tensor(rng.dirichlet(np.ones(K), (N, K)), dtype=torch.float32))
    lo = torch.as_tensor(rng.normal(size=(N, T, K)), dtype=torch.float32)
    m = torch.ones(N, T)
    td.forward_filter_dispatch(lp, lA, lo, m)
    td.viterbi_dispatch(lp, lA, lo, m)
    td.smooth_dispatch(lp, lA, lo, m)
    td.backward_dispatch(lA, lo, m)
    td.ffbs_dispatch(torch.Generator().manual_seed(0), lp, lA, lo, m)
    tv = lA[:, None].expand(N, T - 1, K, K)
    td.forward_filter_dispatch(lp, tv, lo, m)
    table = t_trace.aggregate()
    assert set(table) == {f"kernels.dispatch.{e}[plain]" for e in
                          ("forward_filter", "viterbi", "smooth", "backward", "ffbs")} | {
        "kernels.dispatch.forward_filter[seq]"}
    ev = [e for e in t_trace.events() if e["name"] == "kernels.dispatch.ffbs[plain]"]
    assert ev[0]["meta"] == {"K": K, "T": T}


def test_decode_kernel_fns_are_the_dispatch_entries():
    """The DB writers' decode entries: the port's three branches,
    ``cuda`` (the plain versions answer CPU tensors), ``assoc`` and
    ``seq``, on a flat batch or one series, computing what the dispatch
    entries compute with that branch forced."""
    rng = np.random.default_rng(4)
    lp, lA, lo, m = t_profile.dirichlet_hmm_inputs(rng, 3, 20, batch=2, device="cpu")
    assert lo.dtype == torch.float32 and tuple(lo.shape) == (2, 20, 3)
    fns = t_profile.decode_kernel_fns()
    assert {k: sorted(v) for k, v in fns.items()} == {
        "filter": ["assoc", "cuda", "seq"], "viterbi": ["assoc", "cuda", "seq"],
        "ffbs": ["assoc", "cuda", "seq"]}
    assert torch.equal(fns["filter"]["cuda"](lp, lA, lo, m), td.forward_filter_dispatch(lp, lA, lo, m)[1])
    for b in ("assoc", "seq"):
        assert torch.equal(fns["filter"][b](lp, lA, lo, m),
                           td.forward_filter_dispatch(lp, lA, lo, m, time_parallel=b)[1])
        assert torch.equal(fns["viterbi"][b](lp, lA, lo, m), fns["viterbi"]["cuda"](lp, lA, lo, m))
    assert torch.equal(fns["viterbi"]["cuda"](lp[0], lA[0], lo[0], m[0]),
                       td.viterbi_dispatch(lp[:1], lA[:1], lo[:1], m[:1])[0][0])
    z = fns["ffbs"]["cuda"](lp, lA, lo, m)
    assert torch.equal(z, fns["ffbs"]["cuda"](lp, lA, lo, m))  # a generator seeded 0
