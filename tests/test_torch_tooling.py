"""The port's repo tools beside the package:

- ``lint_torch.py --changed`` on a temporary git repo: renamed files are
  scanned under their new path, deleted ones never reach the engine;
- ``examples_torch/replication_figures.py``: the appendix is byte-equal
  to the JAX driver's ``appendix`` output on the committed artifact, and
  the driver writes only under the ``--out`` directory its caller names;
- ``obs_report_torch.py`` on a manifest from a traced CPU fit (and on
  the JAX report's fixture manifest): the sections whose stanzas share
  the JAX manifest's keys render byte-equal to ``scripts/obs_report.py``
  on the same manifest; run, compile and memory read the port's stanzas;
- each plotting driver of ``examples_torch/`` run ``--cpu --quick
  --plots-dir`` writes its PNGs (the four run at once, one thread each).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
EXAMPLES_TORCH = os.path.join(REPO, "examples_torch")
FIXTURES = os.path.join(REPO, "tests", "fixtures")

# ---------------------------------------------------------------------------
# lint_torch.py --changed


def _git(repo, *args):
    subprocess.run(
        ["git", "-C", str(repo), *args],
        check=True,
        capture_output=True,
        env={**os.environ, "GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
             "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t"},
    )


def _lint(*args):
    return subprocess.run([sys.executable, os.path.join(REPO, "lint_torch.py"), *args],
                          capture_output=True, text=True, cwd=REPO, timeout=120)


def test_lint_changed_renamed_and_deleted(tmp_path):
    pkg = tmp_path / "hhmm_tpu_torch"
    pkg.mkdir()
    (pkg / "a.py").write_text("def f():\n    try:\n        pass\n    except:\n        pass\n")
    (pkg / "b.py").write_text("Y = 2\n")
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "add", "-A")
    _git(tmp_path, "commit", "-qm", "seed")
    _git(tmp_path, "mv", "hhmm_tpu_torch/a.py", "hhmm_tpu_torch/renamed.py")
    (pkg / "b.py").unlink()
    (pkg / "fresh.py").write_text("import torch\n\nZ = torch.rand(3)\n")
    proc = _lint("--changed", "--repo", str(tmp_path), "--rules", "bare-except,torch-generator")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "hhmm_tpu_torch/renamed.py:4: [bare-except]" in proc.stdout
    assert "hhmm_tpu_torch/fresh.py:3: [torch-generator]" in proc.stdout
    assert "b.py" not in proc.stdout
    assert "2 file(s)" in proc.stdout


def test_lint_changed_clean_tree_and_full_scan(tmp_path):
    (tmp_path / "hhmm_tpu_torch").mkdir()
    (tmp_path / "hhmm_tpu_torch" / "a.py").write_text("X = 1\n")
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "add", "-A")
    _git(tmp_path, "commit", "-qm", "seed")
    proc = _lint("--changed", "--repo", str(tmp_path))
    assert proc.returncode == 0 and "no changed .py files" in proc.stdout
    proc = _lint("--format", "json", "--rules", "atomic-write")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout)["ok"] is True


# ---------------------------------------------------------------------------
# replication figures


def _import(path, name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.dirname(path))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.dirname(path))
    return mod


@pytest.fixture(scope="module")
def replication():
    with open(os.path.join(REPO, "results", "tayal_replication.json")) as f:
        return json.load(f)


def test_replication_appendix_byte_equal_to_the_jax_driver(tmp_path, replication):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    jrf = _import(os.path.join(EXAMPLES, "replication_figures.py"), "jax_replication_figures")
    trf = _import(os.path.join(EXAMPLES_TORCH, "replication_figures.py"), "torch_replication_figures")
    assert trf.PUBLISHED_T5_DAYS == _import(
        os.path.join(EXAMPLES, "tayal_replication.py"), "jax_tayal_replication").PUBLISHED_T5_DAYS

    jroot = tmp_path / "jax"
    os.makedirs(jroot / "docs" / "figures")
    old_out, old_root = jrf.OUT, jrf.ROOT
    jrf.OUT, jrf.ROOT = str(jroot / "docs" / "figures"), str(jroot)
    sys.path.insert(0, EXAMPLES)  # appendix imports tayal_replication
    try:
        jrf.appendix(replication, plt)
    finally:
        jrf.OUT, jrf.ROOT = old_out, old_root
        sys.path.remove(EXAMPLES)
    out = tmp_path / "port"
    text = trf.appendix(replication, plt, str(out))
    want = (jroot / "docs" / "appendix-wf.md").read_bytes()
    assert (out / "appendix-wf.md").read_bytes() == want == text.encode()
    symbols = {r["symbol"] for r in replication["wf"]["per_window"]}
    assert sorted(p.name for p in (out / "figures").iterdir()) == sorted(
        f"appendix_equity_{s}.png" for s in symbols)


def test_replication_driver_writes_only_under_out(tmp_path):
    docs_before = sorted(os.listdir(os.path.join(REPO, "docs")))
    out = tmp_path / "rf"
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_TORCH, "replication_figures.py"), "--out", str(out)],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    written = [ln.split(" ", 1)[1] for ln in proc.stdout.splitlines() if ln.startswith("wrote ")]
    assert written and all(w.startswith(str(out)) for w in written)
    assert {"tayal_phi_posterior.png", "tayal_wf_lags.png"} <= set(os.listdir(out / "figures"))
    assert sorted(os.listdir(tmp_path)) == ["rf"]
    assert sorted(os.listdir(os.path.join(REPO, "docs"))) == docs_before
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_TORCH, "replication_figures.py")],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=120)
    assert proc.returncode == 2 and "--out" in proc.stderr


# ---------------------------------------------------------------------------
# obs_report_torch.py

SHARED = {"spans (hottest first)", "plan", "kernel costs", "convergence (interim, per fit chunk)",
          "serving", "request timeline", "pipeline", "storm", "maintenance", "adaptation",
          "analysis", "slo"}


def _sections(text):
    """{title: body} of a report, split at its ``== title ==`` lines."""
    out, title = {}, None
    for line in text.splitlines():
        m = re.fullmatch(r"== (.*) ==", line)
        if m:
            title = m.group(1)
            out[title] = []
        elif title is not None:
            out[title].append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def _report(script, *args):
    proc = subprocess.run([sys.executable, script, *args], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.fixture(scope="module")
def traced_fit_manifest(tmp_path_factory):
    """A manifest from a traced Gibbs fit on the CPU (the obs phase of
    ``chip_smoke.py`` at a small size), its metrics export, and the
    port's analyzer report."""
    import torch

    from hhmm_tpu_torch.analysis import run_analysis
    from hhmm_tpu_torch.batch import default_init
    from hhmm_tpu_torch.infer import GibbsConfig, sample_gibbs
    from hhmm_tpu_torch.models import TayalHHMM
    from hhmm_tpu_torch.obs import manifest as obs_manifest
    from hhmm_tpu_torch.obs import metrics as obs_metrics
    from hhmm_tpu_torch.obs import trace as obs_trace
    from hhmm_tpu_torch.sim import tayal_batch

    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("obs")
    x, sign = tayal_batch(4, 48, seed=1, device="cpu")
    data = {"x": x, "sign": sign}
    model = TayalHHMM(gate_mode="hard")
    init = default_init(model, data, 4, 1, seed=2, device="cpu")
    cfg = GibbsConfig(num_warmup=4, num_samples=4, num_chains=1)
    obs_trace.reset()
    obs_metrics.reset()
    obs_trace.enable()
    obs_metrics.enable()
    try:
        sample_gibbs(model, data, init, cfg, seed=3, device="cpu")
        man = obs_manifest.collect_manifest(config=dict(vars(cfg), series=4, T=48), model=model,
                                            seed=3)
        obs_metrics.export_jsonl(str(d / "metrics.jsonl"))
    finally:
        obs_trace.reset()
        obs_metrics.reset()
        obs_trace.tracer.use_env()
        obs_metrics.use_env()
    path = d / "manifest.json"
    obs_manifest.write_manifest(str(path), man)
    (d / "analysis.json").write_text(json.dumps(run_analysis(root=REPO).to_json()))
    return path, d / "metrics.jsonl", d / "analysis.json"


def test_report_on_a_traced_cpu_fit(traced_fit_manifest):
    path, metrics, analysis = traced_fit_manifest
    args = [str(path), "--metrics", str(metrics), "--analysis", str(analysis)]
    port = _report(os.path.join(REPO, "obs_report_torch.py"), *args)
    jax = _report(os.path.join(REPO, "scripts", "obs_report.py"), *args)
    ps, js = _sections(port), _sections(jax)
    assert list(ps) == list(js)
    for title in SHARED & set(ps):
        assert ps[title] == js[title], title
    assert "infer.gibbs.sample" in ps["spans (hottest first)"]
    assert "CLEAN (zero unsuppressed findings)" in ps["analysis"]
    assert "lock-order: ACYCLIC" in ps["analysis"]
    assert re.search(r"stack +python [0-9.]+, torch [^,]+, cuda", ps["run"])
    assert "nvcc builds: 0" in ps["compile"]
    assert "(no CUDA device memory sampled in this run)" in ps["memory"]
    assert port.splitlines()[0] == "hhmm_tpu_torch run report"


def test_report_shared_sections_on_the_full_fixture_manifest(tmp_path):
    """The JAX report's fixture manifest carries every shared stanza
    (plan, kernel costs, request, pipeline, storm, maintenance,
    adaptation, analysis, slo)."""
    man = os.path.join(FIXTURES, "obs_report_manifest.json")
    port = _sections(_report(os.path.join(REPO, "obs_report_torch.py"), man))
    jax = _sections(_report(os.path.join(REPO, "scripts", "obs_report.py"), man))
    assert list(port) == list(jax)
    shared = SHARED & set(port)
    assert len(shared) >= 8
    for title in shared:
        assert port[title] == jax[title], title


def test_report_port_stanzas(tmp_path):
    man = {
        "version": 1, "backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3", "device_count": 1,
        "nvidia_smi": ["NVIDIA H100 80GB HBM3, 700.00 W"],
        "versions": {"python": "3.12.1", "torch": "2.6.0", "cuda_runtime": "12.4",
                     "cuda_driver": "550.1"},
        "compile": {"backend_compiles": 2, "compile_seconds": {"nvcc_build": 9.5, "library_load": 0.02},
                    "builds": {"ffbs_fwd.cu": {"nvcc_build": 4.5, "library_load": 0.01},
                               "vg_bwd.cu": {"nvcc_build": 5.0, "library_load": 0.01}},
                    "scopes": {"serve": 3}},
        "peak_memory": {"0": {"bytes_in_use": 10, "peak_bytes_in_use": 20, "reserved_bytes": 30,
                              "peak_reserved_bytes": 40, "bytes_limit": 80}},
    }
    p = tmp_path / "m.json"
    p.write_text(json.dumps(man))
    sec = _sections(_report(os.path.join(REPO, "obs_report_torch.py"), str(p)))
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in sec["run"]
    assert "torch 2.6.0, cuda 12.4 (driver 550.1)" in sec["run"]
    assert "nvcc builds: 2" in sec["compile"] and "nvcc_build: 9.5 s" in sec["compile"]
    assert re.search(r"vg_bwd\.cu +5 +0\.01", sec["compile"])
    assert "scope serve: 3" in sec["compile"]
    assert re.search(r"cuda:0 +10 +20 +30 +40 +80", sec["memory"])


def test_report_bad_input_exits_two(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{torn")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "obs_report_torch.py"), str(bad)],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2 and "obs_report_torch" in proc.stderr


# ---------------------------------------------------------------------------
# the drivers' plots

DRIVERS = {
    "hmm_main.py": (["--T", "60"], ["hmm_gaussian_stateprob.png", "hmm_gaussian_statepath.png"]),
    "iohmm_main.py": (["--T", "60"], ["iohmm_reg_inputoutput.png"]),
    "hassan_main.py": (["--T", "40", "--train-frac", "0.9"], ["hassan_forecast.png"]),
    "tayal_main.py": (["--legs-per-day", "60", "--train-days", "2"],
                      ["tayal_topstate_seq.png", "tayal_trading.png"]),
}


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """All four drivers at once, one thread each; ``{driver: (proc,
    plots dir)}``."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    runs = {}
    for driver, (args, _) in DRIVERS.items():
        plots = tmp_path_factory.mktemp(driver[:-3])
        runs[driver] = (subprocess.Popen(
            [sys.executable, os.path.join(EXAMPLES_TORCH, driver), "--cpu", "--quick",
             "--warmup", "5", "--samples", "5", "--plots-dir", str(plots), *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO), plots)
    yield runs
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_driver_writes_its_plots(driver, driver_runs):
    proc, plots = driver_runs[driver]
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out[-3000:]
    pngs = DRIVERS[driver][1]
    assert sorted(os.listdir(plots)) == sorted(pngs)
    for name in pngs:
        assert f"wrote {plots / name}" in out
        with open(plots / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
