"""Isolation of the PyTorch port from the JAX package, and its device
rules:

- no module of ``hhmm_tpu_torch/`` (its obs plane included), no driver
  of ``examples_torch/``, not ``chip_smoke.py`` and not
  ``bench_kernel_pair.py`` imports ``jax`` or ``hhmm_tpu`` (an AST scan of
  every import statement);
- entry points default to CUDA and raise on a host without it, rather
  than running on the CPU;
- a CUDA kernel request on a host without CUDA raises and never falls
  back to the plain version; importing the package builds and loads
  nothing;
- the package and every subpackage but ``viz`` import on a host without
  matplotlib (the card's machine has none); ``viz`` then raises
  ``ModuleNotFoundError`` naming matplotlib, and a driver given
  ``--plots-dir`` raises before it fits anything.
"""

import ast
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import hhmm_tpu_torch
from hhmm_tpu_torch.apps.tayal import (
    chain_marginal_ll,
    decode_states,
    degenerate_mode_probe,
    per_draw_relabel_stats,
    run_window,
    simulate_ticks,
    wf_trade,
)
from hhmm_tpu_torch.batch import default_init, fit_batched, init_from_snapshot
from hhmm_tpu_torch.convert import constrained_from_jax, params_from_jax
from hhmm_tpu_torch.infer import (
    ChEESConfig,
    GibbsConfig,
    SamplerConfig,
    init_chains,
    make_lp_bc,
    sample,
    sample_chees,
    sample_chees_batched,
    sample_gibbs,
    sample_nuts,
    sample_nuts_batched,
)
from hhmm_tpu_torch.kernels import cuda_semiring as cs
from hhmm_tpu_torch.kernels import cuda_traj as ct
from hhmm_tpu_torch.kernels import (
    ffbs_dispatch,
    forward_loglik,
    forward_value_and_grad,
    make_tayal_trajectory,
    viterbi_dispatch,
)
from hhmm_tpu_torch.kernels import dispatch as kernel_dispatch
from hhmm_tpu_torch.kernels.cuda_build import BUILD_DIR, build
from hhmm_tpu_torch.maint import (
    MaintenanceLoop,
    RefitRequest,
    predictive_logliks,
    shadow_evaluate,
    warm_refit,
)
from hhmm_tpu_torch.adapt import AdaptationLadder, Rejuvenator
from hhmm_tpu_torch.apps.hassan import simulate_ohlc, wf_forecast
from hhmm_tpu_torch.apps.jangmin import fit_market
from hhmm_tpu_torch.models import (
    GaussianHMM,
    GaussianHSMM,
    IOHMMHMixLite,
    IOHMMReg,
    MultinomialHMM,
    MultinomialHSMM,
    SemisupMultinomialHMM,
    TayalHHMM,
    TayalHHMMLite,
    TreeHMM,
)
from hhmm_tpu_torch.hhmm import hier2x2_tree
from hhmm_tpu_torch.obs.profile import dirichlet_hmm_inputs
from hhmm_tpu_torch.plan import WorkloadShape, make_plan
from hhmm_tpu_torch.robust import inject
from hhmm_tpu_torch.serve import MicroBatchScheduler, SnapshotPager, SnapshotRegistry
from hhmm_tpu_torch.sim import tayal_batch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "hhmm_tpu_torch").rglob("*.py")) + sorted(
    (REPO / "examples_torch").glob("*.py")) + [
    REPO / "chip_smoke.py",
    REPO / "bench_kernel_pair.py",
    REPO / "lint_torch.py",
    REPO / "obs_report_torch.py",
]
FORBIDDEN = {"jax", "jaxlib", "hhmm_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_file_list_is_complete():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for must in (
        "chip_smoke.py",
        "bench_kernel_pair.py",
        "hhmm_tpu_torch/kernels/cuda_semiring.py",
        "hhmm_tpu_torch/infer/gibbs.py",
        "hhmm_tpu_torch/models/tayal.py",
        "hhmm_tpu_torch/kernels/vg.py",
        "hhmm_tpu_torch/kernels/cuda_traj.py",
        "hhmm_tpu_torch/infer/chees.py",
        "hhmm_tpu_torch/infer/run.py",
        "hhmm_tpu_torch/infer/nuts.py",
        "hhmm_tpu_torch/infer/api.py",
        "hhmm_tpu_torch/kernels/grad.py",
        "hhmm_tpu_torch/models/gaussian_hmm.py",
        "hhmm_tpu_torch/core/dists.py",
        "hhmm_tpu_torch/infer/relabel.py",
        "hhmm_tpu_torch/batch/fit.py",
        "hhmm_tpu_torch/batch/pad.py",
        "hhmm_tpu_torch/batch/cache.py",
        "hhmm_tpu_torch/native/__init__.py",
        "hhmm_tpu_torch/native/zigzag.py",
        "hhmm_tpu_torch/apps/tayal/wf.py",
        "hhmm_tpu_torch/apps/tayal/pipeline.py",
        "hhmm_tpu_torch/apps/tayal/features.py",
        "hhmm_tpu_torch/apps/tayal/analytics.py",
        "hhmm_tpu_torch/apps/tayal/replication.py",
        "hhmm_tpu_torch/robust/faults.py",
        "hhmm_tpu_torch/robust/retry.py",
        "hhmm_tpu_torch/models/multinomial_hmm.py",
        "hhmm_tpu_torch/kernels/semiring.py",
        "hhmm_tpu_torch/kernels/ffbs.py",
        "hhmm_tpu_torch/core/bijectors.py",
        "hhmm_tpu_torch/models/iohmm.py",
        "hhmm_tpu_torch/sim/iohmm.py",
        "hhmm_tpu_torch/apps/hassan/__init__.py",
        "hhmm_tpu_torch/apps/hassan/data.py",
        "hhmm_tpu_torch/apps/hassan/forecast.py",
        "hhmm_tpu_torch/apps/hassan/wf.py",
        "hhmm_tpu_torch/hhmm/__init__.py",
        "hhmm_tpu_torch/hhmm/structure.py",
        "hhmm_tpu_torch/hhmm/simulate.py",
        "hhmm_tpu_torch/hhmm/examples.py",
        "hhmm_tpu_torch/hhmm/compile.py",
        "hhmm_tpu_torch/hhmm/routes.py",
        "hhmm_tpu_torch/models/tree.py",
        "hhmm_tpu_torch/apps/jangmin.py",
        "hhmm_tpu_torch/kernels/duration.py",
        "hhmm_tpu_torch/models/hsmm.py",
        "hhmm_tpu_torch/apps/rdata.py",
        "hhmm_tpu_torch/apps/data_io.py",
        "hhmm_tpu_torch/obs/__init__.py",
        "hhmm_tpu_torch/obs/trace.py",
        "hhmm_tpu_torch/obs/metrics.py",
        "hhmm_tpu_torch/obs/telemetry.py",
        "hhmm_tpu_torch/obs/manifest.py",
        "hhmm_tpu_torch/obs/profile.py",
        "hhmm_tpu_torch/kernels/assoc.py",
        "hhmm_tpu_torch/kernels/dispatch.py",
        "hhmm_tpu_torch/plan/__init__.py",
        "hhmm_tpu_torch/plan/planner.py",
        "hhmm_tpu_torch/obs/request.py",
        "hhmm_tpu_torch/serve/__init__.py",
        "hhmm_tpu_torch/serve/online.py",
        "hhmm_tpu_torch/serve/registry.py",
        "hhmm_tpu_torch/serve/lanes.py",
        "hhmm_tpu_torch/serve/metrics.py",
        "hhmm_tpu_torch/serve/events.py",
        "hhmm_tpu_torch/serve/pager.py",
        "hhmm_tpu_torch/serve/scheduler.py",
        "hhmm_tpu_torch/pipeline/__init__.py",
        "hhmm_tpu_torch/pipeline/dispatch.py",
        "hhmm_tpu_torch/pipeline/place.py",
        "hhmm_tpu_torch/adapt/__init__.py",
        "hhmm_tpu_torch/adapt/weights.py",
        "hhmm_tpu_torch/adapt/rejuvenate.py",
        "hhmm_tpu_torch/adapt/ladder.py",
        "hhmm_tpu_torch/maint/__init__.py",
        "hhmm_tpu_torch/maint/triggers.py",
        "hhmm_tpu_torch/maint/promote.py",
        "hhmm_tpu_torch/maint/shadow.py",
        "hhmm_tpu_torch/maint/refit.py",
        "hhmm_tpu_torch/maint/loop.py",
        "examples_torch/_common.py",
        "examples_torch/hmm_main.py",
        "examples_torch/iohmm_main.py",
        "examples_torch/hassan_main.py",
        "examples_torch/hassan_replication.py",
        "examples_torch/hhmm_main.py",
        "examples_torch/jangmin_main.py",
        "examples_torch/tayal_main.py",
        "examples_torch/tayal_strategy.py",
        "examples_torch/replication_figures.py",
        "hhmm_tpu_torch/analysis/__init__.py",
        "hhmm_tpu_torch/analysis/__main__.py",
        "hhmm_tpu_torch/analysis/engine.py",
        "hhmm_tpu_torch/analysis/astutil.py",
        "hhmm_tpu_torch/analysis/legacy.py",
        "hhmm_tpu_torch/analysis/concurrency.py",
        "hhmm_tpu_torch/analysis/layering.py",
        "hhmm_tpu_torch/analysis/prng.py",
        "hhmm_tpu_torch/analysis/purity.py",
        "hhmm_tpu_torch/analysis/dtype.py",
        "hhmm_tpu_torch/viz/__init__.py",
        "hhmm_tpu_torch/viz/plots.py",
        "hhmm_tpu_torch/viz/state_plots.py",
        "lint_torch.py",
        "obs_report_torch.py",
    ):
        assert must in names


@pytest.mark.parametrize("package,name,module", [
    ("hhmm_tpu_torch.robust", "inject", "hhmm_tpu_torch.robust.faults"),
    ("hhmm_tpu_torch.kernels", "forward_loglik", "hhmm_tpu_torch.kernels.grad"),
])
def test_package_exports_what_the_jax_package_exports(package, name, module):
    """The names the JAX package exports from a subpackage
    (``hhmm_tpu/robust/__init__.py``, ``hhmm_tpu/kernels/__init__.py``)
    are exported from the port's, and are the port's own functions."""
    import importlib

    pkg = importlib.import_module(package)
    assert name in pkg.__all__
    assert getattr(pkg, name) is getattr(importlib.import_module(module), name)
    assert {"inject": inject, "forward_loglik": forward_loglik}[name] is getattr(pkg, name)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _run_driver(driver, *args):
    import runpy
    import sys

    argv, sys.argv = sys.argv, [str(REPO / "examples_torch" / driver), *args]
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sys.argv = argv


def _tiny():
    x = torch.tensor([[1, 2, 3, 4, 5, 6]])
    sign = torch.tensor([[0, 1, 0, 1, 0, 1]])
    return x, sign


def _cpu_scheduler(**kw):
    return MicroBatchScheduler(TayalHHMM(gate_mode="hard"), device="cpu", **kw)


ENTRY_POINTS = {
    "tayal_batch": lambda: tayal_batch(2, 8, seed=0),
    "default_init": lambda: default_init(TayalHHMM(), dict(zip(("x", "sign"), _tiny())), 1, 1),
    "sample_gibbs": lambda: sample_gibbs(
        TayalHHMM(gate_mode="hard"), dict(zip(("x", "sign"), _tiny())),
        torch.zeros(1, 1, 35), GibbsConfig(1, 1),
    ),
    "generated": lambda: TayalHHMMLite().generated(
        torch.zeros(2, 35),
        {"x": _tiny()[0][0], "sign": _tiny()[1][0], "x_oos": _tiny()[0][0], "sign_oos": _tiny()[1][0]},
    ),
    "make_lp_bc": lambda: make_lp_bc(TayalHHMM(), dict(zip(("x", "sign"), _tiny()))),
    "make_tayal_trajectory": lambda: make_tayal_trajectory(dict(zip(("x", "sign"), _tiny())), 4),
    "sample_chees_batched": lambda: sample_chees_batched(
        lambda q: (q.sum(-1), q), torch.zeros(1, 2, 3), ChEESConfig(2, 2, num_chains=2)
    ),
    "sample_chees": lambda: sample_chees(
        lambda q: -(q * q).sum(-1), torch.zeros(2, 3), ChEESConfig(2, 2, num_chains=2)
    ),
    "params_from_jax": lambda: params_from_jax(TayalHHMM(), np.zeros((2, 35))),
    "base_generated": lambda: TayalHHMM(gate_mode="hard").generated(
        torch.zeros(2, 35), {"x": _tiny()[0][0], "sign": _tiny()[1][0]}
    ),
    "gaussian_generated": lambda: GaussianHMM(3).generated(
        torch.zeros(2, GaussianHMM(3).n_free), {"x": torch.zeros(6)}
    ),
    "state_draws": lambda: GaussianHMM(3).state_draws(
        torch.Generator(), torch.zeros(2, GaussianHMM(3).n_free), {"x": torch.zeros(6)}
    ),
    "fit_batched": lambda: fit_batched(
        TayalHHMM(gate_mode="hard"), dict(zip(("x", "sign"), _tiny())), GibbsConfig(1, 1)
    ),
    "wf_trade": lambda: wf_trade([]),
    "sample_nuts": lambda: sample_nuts(
        lambda q: -(q * q).sum(-1), torch.zeros(2, 3), SamplerConfig(2, 2, num_chains=2)
    ),
    "sample_nuts_batched": lambda: sample_nuts_batched(
        lambda q: (-(q * q).sum(-1), -q), torch.zeros(1, 1, 3), SamplerConfig(2, 2)
    ),
    "sample": lambda: sample(lambda q: -(q * q).sum(-1), torch.zeros(3), SamplerConfig(2, 2)),
    "init_chains": lambda: init_chains(
        TayalHHMM(), {"x": _tiny()[0][0], "sign": _tiny()[1][0]}, 2
    ),
    "fit_batched_nuts": lambda: fit_batched(
        TayalHHMM(), dict(zip(("x", "sign"), _tiny())), SamplerConfig(1, 1)
    ),
    "run_window": lambda: run_window(
        *simulate_ticks(np.random.default_rng(0), n_legs=60)[:3], ins_end_tick=100
    ),
    "decode_states": lambda: decode_states(
        TayalHHMMLite(), np.zeros((2, 35)),
        {"x": _tiny()[0][0], "sign": _tiny()[1][0], "x_oos": _tiny()[0][0], "sign_oos": _tiny()[1][0]},
    ),
    "filtered": lambda: TayalHHMMLite().filtered(
        torch.zeros(2, 35),
        {"x": _tiny()[0][0], "sign": _tiny()[1][0], "x_oos": _tiny()[0][0], "sign_oos": _tiny()[1][0]},
    ),
    "multinomial_generated": lambda: MultinomialHMM(3, 5).generated(
        torch.zeros(2, MultinomialHMM(3, 5).n_free), {"x": torch.zeros(6, dtype=torch.long)}
    ),
    "semisup_state_draws": lambda: SemisupMultinomialHMM(4, 9, (0, 1, 1, 0)).state_draws(
        torch.Generator(), torch.zeros(2, SemisupMultinomialHMM(4, 9, (0, 1, 1, 0)).n_free),
        {"x": torch.zeros(6, dtype=torch.long), "g": torch.zeros(6, dtype=torch.long)},
    ),
    "fit_batched_multinomial_healing": lambda: fit_batched(
        MultinomialHMM(2, 3), {"x": np.zeros((2, 6), np.int64)}, GibbsConfig(1, 1)
    ),
    "fit_batched_chees_per_series": lambda: fit_batched(
        TayalHHMM(), dict(zip(("x", "sign"), _tiny())),
        ChEESConfig(1, 1, num_chains=2, shared_adaptation=False),
    ),
    "chain_marginal_ll": lambda: chain_marginal_ll(
        TayalHHMM(), np.zeros((2, 3, 35)), {"x": _tiny()[0][0], "sign": _tiny()[1][0]}
    ),
    "degenerate_mode_probe": lambda: degenerate_mode_probe(
        TayalHHMM(), np.zeros(35), {"x": _tiny()[0][0], "sign": _tiny()[1][0]}, torch.Generator()
    ),
    "per_draw_relabel_stats": lambda: per_draw_relabel_stats(
        TayalHHMM(), np.zeros((2, 35)), {"x": _tiny()[0][0], "sign": _tiny()[1][0]},
        np.arange(6), np.arange(6) + 1, np.ones(8), torch.Generator(),
    ),
    "wf_forecast": lambda: wf_forecast(simulate_ohlc(np.random.default_rng(0), T=12), 10),
    # the IOHMM make_vg through the entry points that place its data
    "iohmm_fit_batched_nuts": lambda: fit_batched(
        IOHMMReg(2, 2), {"x": np.zeros((1, 6)), "u": np.zeros((1, 6, 2))}, SamplerConfig(1, 1)
    ),
    "iohmm_default_init": lambda: default_init(
        IOHMMReg(2, 2), {"x": np.zeros((1, 6)), "u": np.zeros((1, 6, 2))}, 1, 1
    ),
    "hmix_lite_generated": lambda: IOHMMHMixLite(2, 2, 2, np.ones(9)).generated(
        torch.zeros(2, IOHMMHMixLite(2, 2, 2, np.ones(9)).n_free),
        {"x": torch.zeros(6), "u": torch.zeros(6, 2)},
    ),
    # the tree HHMM: numpy data go to the card, the app fits there
    "tree_make_vg": lambda: TreeHMM(hier2x2_tree()).make_vg({"x": np.zeros(6, np.float32)}),
    "tree_generated": lambda: TreeHMM(hier2x2_tree()).generated(
        torch.zeros(2, TreeHMM(hier2x2_tree()).n_free), {"x": torch.zeros(6)}
    ),
    "fit_market": lambda: fit_market(np.zeros(10), np.zeros(10, np.int64)),
    # the HSMMs: K' = 12, and K' = 180 (the big layout) on the card too
    "hsmm_generated": lambda: GaussianHSMM(2, 6).generated(
        torch.zeros(2, GaussianHSMM(2, 6).n_free), {"x": torch.zeros(6)}
    ),
    "hsmm_big_k_state_draws": lambda: GaussianHSMM(3, 60).state_draws(
        torch.Generator(), torch.zeros(1, GaussianHSMM(3, 60).n_free), {"x": torch.zeros(6)}
    ),
    "multinomial_hsmm_fit_batched": lambda: fit_batched(
        MultinomialHSMM(2, 3, 4), {"x": np.zeros((1, 6), np.int64)}, GibbsConfig(1, 1)
    ),
    "dirichlet_hmm_inputs": lambda: dirichlet_hmm_inputs(np.random.default_rng(0), 3, 8, 2),
    # the planner over this host's devices, and a planned fit
    "make_plan": lambda: make_plan(WorkloadShape(B=2, T=8)),
    "fit_batched_mesh": lambda: fit_batched(
        TayalHHMM(gate_mode="hard"), dict(zip(("x", "sign"), _tiny())), GibbsConfig(1, 1),
        mesh=["cuda"],
    ),
    "wf_trade_time_parallel": lambda: wf_trade([], time_parallel=True),
    "example_driver": lambda: _run_driver("hmm_main.py", "--quick", "--T", "20"),
    # the serving plane: the scheduler, the pager and the warm-start inits
    "micro_batch_scheduler": lambda: MicroBatchScheduler(TayalHHMM(gate_mode="hard")),
    "snapshot_pager": lambda: SnapshotPager(
        SnapshotRegistry(str(Path(tempfile.mkdtemp()) / "reg"))),
    "init_from_snapshot": lambda: init_from_snapshot(np.zeros((4, 35), np.float32), 2),
    # the adaptation and maintenance planes over a scheduler on the CPU:
    # their own device still defaults to the card
    "rejuvenator": lambda: Rejuvenator(0),
    "adaptation_ladder": lambda: AdaptationLadder(_cpu_scheduler()),
    "maintenance_loop": lambda: MaintenanceLoop(
        _cpu_scheduler(history_tail=8), None, TayalHHMM(gate_mode="hard"), GibbsConfig(1, 1)),
    "warm_refit": lambda: warm_refit(TayalHHMM(gate_mode="hard"), [], {}, {}, GibbsConfig(1, 1)),
    "predictive_logliks": lambda: predictive_logliks(
        TayalHHMM(gate_mode="hard"), np.zeros((2, 35), np.float32),
        {"x": np.zeros(4, np.int64), "sign": np.zeros(4, np.int64)}),
    "shadow_evaluate": lambda: shadow_evaluate(
        TayalHHMM(gate_mode="hard"), np.zeros((2, 35), np.float32),
        np.zeros((2, 35), np.float32),
        {"x": np.zeros(4, np.int64), "sign": np.zeros(4, np.int64)}),
    "constrained_from_jax": lambda: constrained_from_jax(
        TayalHHMM(), {"p_11": np.float32(0.5), "A_row": np.full((2, 2), 0.5),
                      "phi_k": np.full((4, 9), 1 / 9)},
    ),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name]()


def test_explicit_cpu_runs_the_plain_path(no_cuda):
    x, sign = tayal_batch(2, 8, seed=0, device="cpu")
    assert x.device.type == "cpu" and x.shape == (2, 8)


def test_serving_entry_points_run_on_an_explicit_cpu(no_cuda, tmp_path):
    sch = MicroBatchScheduler(TayalHHMM(gate_mode="hard"), device="cpu")
    assert sch.device.type == "cpu"
    pager = SnapshotPager(SnapshotRegistry(str(tmp_path / "reg")), device="cpu")
    assert pager.budget_source.startswith("static fallback")
    init = init_from_snapshot(np.zeros((4, 35), np.float32), 2, device="cpu")
    assert init.device.type == "cpu" and init.shape == (2, 35)


def test_adaptation_and_maintenance_run_on_an_explicit_cpu(no_cuda):
    sched = _cpu_scheduler(history_tail=8)
    assert AdaptationLadder(sched, device="cpu").rejuvenator.device.type == "cpu"
    assert MaintenanceLoop(sched, None, TayalHHMM(gate_mode="hard"), GibbsConfig(1, 1),
                           device="cpu").device.type == "cpu"
    cands, skipped = warm_refit(TayalHHMM(gate_mode="hard"), [RefitRequest("s", "staleness", 1)],
                                {}, {}, GibbsConfig(1, 1), device="cpu")
    assert cands == {} and skipped == [("s", "no serving snapshot to warm-start from")]


# the port's planes that may import each other, downward only
LAYERS = {"serve": {"adapt", "maint"}, "adapt": {"maint"}}


@pytest.mark.parametrize("plane", sorted(LAYERS))
def test_layering(plane):
    """``serve`` imports neither ``adapt`` nor ``maint``; ``adapt`` does
    not import ``maint`` (the JAX package's layering rule)."""
    above = {f"hhmm_tpu_torch.{p}" for p in LAYERS[plane]}
    for path in sorted((REPO / "hhmm_tpu_torch" / plane).rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # relative: resolve inside the package
                    base = "hhmm_tpu_torch." + ".".join(
                        path.relative_to(REPO / "hhmm_tpu_torch").parts[:-node.level])
                    names = [f"{base}.{node.module}" if node.module else base]
                elif node.module:
                    names = [node.module]
            for n in names:
                assert not any(n == a or n.startswith(a + ".") for a in above), \
                    f"{path.relative_to(REPO)} imports {n}"


def test_kernel_build_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.build_kernels()
    with pytest.raises(RuntimeError, match="CUDA"):
        build([cs.FWD.source])
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.FWD.load()
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.TRAJ.load()
    assert all(k.launches == 0 for k in cs.KERNELS + ct.KERNELS)


def test_cuda_request_never_falls_back_to_plain(no_cuda, monkeypatch):
    """A CUDA operand reaches the kernel wrapper, which must raise (here:
    no CUDA to build for) instead of running the plain version."""
    called = []
    monkeypatch.setattr(cs, "fwd_plain", lambda *a: called.append("plain"))
    monkeypatch.setattr(cs, "bwd_sample_plain", lambda *a: called.append("plain"))

    class _CudaLike(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    def cudalike(t):
        return t.as_subclass(_CudaLike)

    monkeypatch.setattr(cs, "vg_bwd_plain", lambda *a: called.append("plain"))
    monkeypatch.setattr(ct, "traj_plain", lambda *a: called.append("plain"))
    K, N, T = 4, 3, 5
    lanes = [cudalike(torch.zeros(s)) for s in ((K, N), (K, K, N), (T, K, N), (T, N))]
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.fwd_lanes(*lanes)
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.bwd_sample_lanes(lanes[1], lanes[3], cudalike(torch.zeros(T, K, N)), lanes[3])
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.vg_bwd_lanes(lanes[1], lanes[2], lanes[3], cudalike(torch.zeros(T, K, N)),
                        cudalike(torch.zeros(N)))
    B, C, D = 3, 2, ct.DIM
    f32 = [cudalike(torch.zeros(s)) for s in ((D, B * C), (D, B * C), (D, B * C), (D, B))]
    data = [cudalike(torch.zeros((T, B), dtype=torch.int32)) for _ in range(2)]
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.traj_lanes(*f32, *data, cudalike(torch.ones(T, B)), cudalike(torch.ones(1)),
                      cudalike(torch.ones(1, dtype=torch.int32)), 4, C)
    assert called == []


def test_cuda_vg_rejects_what_the_kernels_do_not_take(monkeypatch):
    """On a CUDA operand the value-and-grad entry checks K and the dtype
    and raises, rather than running the plain pair."""
    monkeypatch.setattr(cs, "vg_bwd_plain", lambda *a: pytest.fail("plain version ran"))

    class _CudaLike(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    def args(K, dtype=torch.float32):
        shapes = ((2, K), (2, K, K), (2, 5, K), (2, 5))
        return [torch.zeros(s, dtype=dtype).as_subclass(_CudaLike) for s in shapes]

    with pytest.raises(ValueError, match="K >= 1"):
        forward_value_and_grad(*args(0))
    with pytest.raises(TypeError, match="float32"):
        forward_value_and_grad(*args(4, torch.float64))


@pytest.mark.parametrize("which", ["fwd", "bwd", "dispatch", "vg", "traj"])
def test_other_devices_raise(which):
    meta = dict(device="meta")
    if which == "fwd":
        with pytest.raises(ValueError, match="no kernel"):
            cs.fwd_lanes(torch.zeros(4, 2, **meta), torch.zeros(4, 4, 2, **meta),
                         torch.zeros(3, 4, 2, **meta), torch.zeros(3, 2, **meta))
    elif which == "bwd":
        with pytest.raises(ValueError, match="no kernel"):
            cs.bwd_sample_lanes(torch.zeros(4, 4, 2, **meta), torch.zeros(3, 2, **meta),
                                torch.zeros(3, 4, 2, **meta), torch.zeros(3, 2, **meta))
    elif which == "vg":
        with pytest.raises(ValueError, match="no kernel"):
            forward_value_and_grad(torch.zeros(2, 4, **meta), torch.zeros(2, 4, 4, **meta),
                                   torch.zeros(2, 3, 4, **meta), torch.zeros(2, 3, **meta))
    elif which == "traj":
        i32 = dict(dtype=torch.int32, **meta)
        with pytest.raises(ValueError, match="no kernel"):
            ct.traj_lanes(*(torch.zeros(ct.DIM, 2, **meta) for _ in range(4)),
                          torch.zeros(3, 2, **i32), torch.zeros(3, 2, **i32),
                          torch.zeros(3, 2, **meta), torch.zeros(1, **meta),
                          torch.zeros(1, **i32), 4, 1)
    else:
        with pytest.raises(ValueError, match="no FFBS path"):
            ffbs_dispatch(None, torch.zeros(2, 4, **meta), torch.zeros(2, 4, 4, **meta),
                          torch.zeros(2, 3, 4, **meta))


def test_homogeneous_viterbi_on_cuda_is_not_silently_plain(no_cuda, monkeypatch):
    """A homogeneous ``log_A`` on CUDA goes to the Viterbi kernels (here:
    no card to build for, so the wrapper raises) and never to the scan
    or the plain versions."""
    monkeypatch.setattr(cs, "viterbi_plain", lambda *a: pytest.fail("plain version ran"))
    monkeypatch.setattr(cs, "backtrack_plain", lambda *a: pytest.fail("plain version ran"))
    monkeypatch.setattr(kernel_dispatch, "viterbi", lambda *a: pytest.fail("scan ran"))

    class _CudaLike(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    shapes = ((2, 4), (2, 4, 4), (2, 6, 4), (2, 6))
    args = [torch.ones(s).as_subclass(_CudaLike) for s in shapes]
    with pytest.raises(RuntimeError, match="CUDA"):
        viterbi_dispatch(*args)


def test_cuda_decode_request_never_falls_back_to_plain(no_cuda, monkeypatch):
    """The decode kernels' wrappers raise on a CUDA operand without a card
    to build for, and never run their plain versions."""
    for name in ("filter_plain", "beta_plain", "viterbi_plain", "backtrack_plain"):
        monkeypatch.setattr(cs, name, lambda *a: pytest.fail("plain version ran"))

    class _CudaLike(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    K, N, T = 3, 4, 5
    pi, A, obs, mask = (
        torch.zeros(s).as_subclass(_CudaLike) for s in ((K, N), (K, K, N), (T, K, N), (T, N))
    )
    back = torch.zeros((T, N), dtype=torch.int32).as_subclass(_CudaLike)
    for call in (
        lambda: cs.filter_lanes(pi, A, obs, mask),
        lambda: cs.beta_lanes(A, obs, mask),
        lambda: cs.viterbi_lanes(pi, A, obs, mask),
        lambda: cs.backtrack_lanes(back, pi),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert all(k.launches == 0 for k in (cs.FILTER, cs.BETA, cs.VITERBI, cs.BACKTRACK))


def test_import_builds_and_loads_nothing():
    assert hhmm_tpu_torch.resolve_device("cpu").type == "cpu"
    assert all(k._fn is None for k in cs.KERNELS) or torch.cuda.is_available()
    if not torch.cuda.is_available():
        assert not BUILD_DIR.exists() or not any(BUILD_DIR.glob("*.so"))


def test_import_builds_no_native_library():
    """Importing the port, its apps included, neither builds nor loads
    the native extractor (a fresh interpreter: other tests in this
    process may have built it)."""
    import subprocess
    import sys

    code = (
        "import hhmm_tpu_torch.apps.tayal, hhmm_tpu_torch.batch\n"
        "import hhmm_tpu_torch.native as n\n"
        "assert n._handle is None and not n._tried\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)


# every subpackage of the port but viz, imported with matplotlib blocked
# a host without matplotlib: an import of it (or of a submodule) raises
# ModuleNotFoundError naming matplotlib, as on a machine that lacks it
_BLOCK_MATPLOTLIB = """
import sys


class _NoMatplotlib:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "matplotlib":
            raise ModuleNotFoundError("No module named 'matplotlib'", name="matplotlib")
        return None


sys.meta_path.insert(0, _NoMatplotlib())
"""

_NO_MATPLOTLIB = _BLOCK_MATPLOTLIB + """
import hhmm_tpu_torch
import hhmm_tpu_torch.adapt, hhmm_tpu_torch.analysis, hhmm_tpu_torch.apps.hassan
import hhmm_tpu_torch.apps.jangmin, hhmm_tpu_torch.apps.tayal, hhmm_tpu_torch.batch
import hhmm_tpu_torch.convert, hhmm_tpu_torch.core, hhmm_tpu_torch.hhmm, hhmm_tpu_torch.infer
import hhmm_tpu_torch.kernels, hhmm_tpu_torch.maint, hhmm_tpu_torch.models, hhmm_tpu_torch.native
import hhmm_tpu_torch.obs, hhmm_tpu_torch.pipeline, hhmm_tpu_torch.plan, hhmm_tpu_torch.robust
import hhmm_tpu_torch.serve, hhmm_tpu_torch.sim
try:
    import hhmm_tpu_torch.viz
except ModuleNotFoundError as e:
    assert e.name == "matplotlib", e.name
    print("viz raised for", e.name)
else:
    raise AssertionError("hhmm_tpu_torch.viz imported without matplotlib")
"""


def test_package_imports_without_matplotlib_and_viz_names_it():
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-c", _NO_MATPLOTLIB], capture_output=True, text=True,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "viz raised for matplotlib" in proc.stdout


def test_import_hhmm_tpu_torch_imports_neither_torch_nor_matplotlib():
    import subprocess
    import sys

    code = ("import sys, hhmm_tpu_torch\n"
            "assert not {'torch', 'numpy', 'matplotlib'} & set(sys.modules), sorted(sys.modules)\n"
            "assert hhmm_tpu_torch.resolve_device('cpu').type == 'cpu'\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)


@pytest.mark.parametrize("driver", ["hmm_main.py", "iohmm_main.py", "hassan_main.py", "tayal_main.py"])
def test_plots_dir_raises_without_matplotlib(driver, tmp_path):
    """A driver given ``--plots-dir`` on a host without matplotlib fails
    before its fit (no table printed) and writes nothing: it never
    quietly draws nothing."""
    import subprocess
    import sys

    code = _BLOCK_MATPLOTLIB + (
        "import runpy\n"
        "sys.argv = sys.argv[1:]\n"
        "runpy.run_path(sys.argv[0], run_name='__main__')\n"
    )
    plots = tmp_path / "plots"
    proc = subprocess.run(
        [sys.executable, "-c", code, str(REPO / "examples_torch" / driver), "--cpu", "--quick",
         "--plots-dir", str(plots)], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode != 0
    assert "ModuleNotFoundError" in proc.stderr and "matplotlib" in proc.stderr
    assert "divergence rate" not in proc.stdout and not plots.exists()


def test_only_the_plotting_drivers_take_plots_dir():
    import subprocess
    import sys

    for driver in ("hhmm_main.py", "jangmin_main.py", "tayal_strategy.py", "hassan_replication.py"):
        proc = subprocess.run([sys.executable, str(REPO / "examples_torch" / driver), "--help"],
                              capture_output=True, text=True, cwd=REPO, timeout=120)
        assert proc.returncode == 0 and "--plots-dir" not in proc.stdout, driver
