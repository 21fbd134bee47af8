"""The port's placement planner (``hhmm_tpu_torch/plan/``) against the JAX
planner (``hhmm_tpu/plan/planner.py``), and planned fits.

- golden parity with JAX ``make_plan(..., n_devices=D)`` (decided for a
  topology size; no virtual devices) over a grid of ``WorkloadShape``
  (series, steps, chains, the HSMM duration factor), D in {1, 2, 4, 8},
  the three layouts and two chunk sizes: axes, chunk, bucket ladder,
  ``admission_caps``, ``shard_bucket``, the sp decision and every field
  of the manifest stanza equal. The branch names differ where the
  packages name their branches differently: JAX ``"pallas"`` is the
  port's ``"cuda"``, and with nothing measured the JAX default is its
  sequential scan (``"scan"``), the port's its kernels (``"cuda"``);
  ``plan_for_mesh`` on a one-device mesh likewise;
- a planned ``fit_batched`` on 1 and 4 logical CPU devices equals the
  unplanned fit at the shard size, bit for bit, with a ragged final
  chunk and ragged T, by Gibbs and by ChEES; ``mesh=`` is the 1-D plan;
  ``plan=`` with ``mesh=`` raises, as does a plan whose chain ways do
  not divide the chains; a fit without either records a one-device
  plan; a plan's ``dispatch_scope`` pins its branch over ``"auto"``;
  ``place`` raises where the host has fewer devices than the plan.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from hhmm_tpu.plan import WorkloadShape as JShape
from hhmm_tpu.plan import make_plan as j_make_plan
from hhmm_tpu.plan import plan_for_mesh as j_plan_for_mesh
from hhmm_tpu_torch.batch import fit_batched
from hhmm_tpu_torch.infer import ChEESConfig, GibbsConfig
from hhmm_tpu_torch.kernels import dispatch as td
from hhmm_tpu_torch.models import GaussianHMM, NIGPrior
from hhmm_tpu_torch.obs import manifest as t_manifest
from hhmm_tpu_torch.plan import MIN_SP_CHUNK, Plan, WorkloadShape, make_plan, plan_for_mesh

torch.set_num_threads(1)

SHAPES = [dict(B=B, T=T, C=C, K=4, duration=d)
          for B, T, C, d in itertools.product((1, 3, 8, 64), (7, 64, 1024), (1, 2, 4), (1, 6))]
# the JAX branch a port branch is: the same name, but the kernels
JAX_BRANCH = {"cuda": "pallas", "assoc": "assoc", "scan": "scan", "seqshard": "seqshard"}


def _fields(p, branch_map=lambda b: b):
    st = p.stanza()
    st["branch"] = branch_map(st["branch"])
    st["reason"] = st["reason"].replace(f"branch={p.branch}", f"branch={branch_map(p.branch)}")
    return {
        "axes": tuple(p.axes), "chunk": p.chunk, "chunk_requested": p.chunk_requested,
        "buckets": tuple(p.buckets), "shard_min_bucket": p.shard_min_bucket,
        "n_devices": p.n_devices, "devices_used": p.devices_used, "mesh_shape": p.mesh_shape,
        "series_ways": p.series_ways, "chain": p.ways("chain"), "sp": p.ways("sp"),
        "caps": p.admission_caps(), "caps_custom": p.admission_caps(depth_factor=3, carry_factor=2),
        "shard": [p.shard_bucket(b) for b in (4, 8, 16, 32, 48, 64, 128)],
        "stanza": st,
    }


@pytest.mark.parametrize("chunk_size", [64, 5])
@pytest.mark.parametrize("layout", ["auto", "series", "single"])
@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_make_plan_matches_jax_field_for_field(D, layout, chunk_size):
    for sh in SHAPES:
        for tp in ("auto", True, False, "pallas"):
            port_tp = "cuda" if tp == "pallas" else tp
            got = make_plan(WorkloadShape(**sh), n_devices=D, chunk_size=chunk_size,
                            layout=layout, time_parallel=port_tp, platform="cpu")
            want = j_make_plan(JShape(**sh), n_devices=D, chunk_size=chunk_size, layout=layout,
                               time_parallel=tp, platform="cpu")
            if tp == "auto" and got.branch == "cuda":
                # nothing measured: the JAX default is its scan, the port's its kernels
                assert want.branch == "scan"
                mapped = _fields(got, {"cuda": "scan"}.get)
            else:
                mapped = _fields(got, JAX_BRANCH.get)
            assert mapped == _fields(want), (sh, tp)


def test_plan_for_mesh_matches_jax_on_one_device():
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("series",))
    for sh in SHAPES[:12]:
        got = plan_for_mesh(["cpu"], WorkloadShape(**sh), chunk_size=5, time_parallel=False)
        want = j_plan_for_mesh(mesh, JShape(**sh), chunk_size=5, time_parallel=False,
                               platform="cpu")
        assert _fields(got) == _fields(want)
    two = plan_for_mesh(["cpu", "cpu"], WorkloadShape(B=7, T=10), chunk_size=5)
    assert two.axes == (("series", 2),) and two.chunk == 6 and two.device_list() == [
        torch.device("cpu")] * 2


def test_sp_axis_needs_min_chunk_steps():
    assert make_plan(WorkloadShape(B=1, T=8 * MIN_SP_CHUNK), n_devices=8,
                     platform="cpu").axes == (("sp", 8),)
    assert make_plan(WorkloadShape(B=1, T=7 * MIN_SP_CHUNK), n_devices=8,
                     platform="cpu").axes == ()


def _gaussian(rng, B, T):
    z = (np.cumsum(rng.random((B, T)) < 0.1, axis=1) % 2)
    x = np.where(z == 0, -1.0, 2.0) + rng.normal(size=(B, T)) * 0.7
    lengths = rng.integers(T // 2, T + 1, size=B)  # ragged T
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return {"x": x.astype(np.float32), "mask": mask}


@pytest.mark.parametrize("sampler", ["gibbs", "chees"])
@pytest.mark.parametrize("devices", [1, 4])
def test_planned_fit_equals_the_unplanned_fit_at_the_shard_size(devices, sampler):
    rng = np.random.default_rng(devices)
    data = _gaussian(rng, 7, 30)  # B = 7: the last shard ragged
    model = GaussianHMM(2, nig_prior=NIGPrior())
    cfg = (GibbsConfig(3, 4, 2) if sampler == "gibbs"
           else ChEESConfig(3, 4, num_chains=2, max_leapfrogs=4))
    plan = make_plan(WorkloadShape(B=7, T=30, C=2, K=2), devices=["cpu"] * devices,
                     chunk_size=4, layout="series")
    assert plan.series_ways == devices and plan.chunk == 4
    qs, stats = fit_batched(model, data, cfg, plan=plan, seed=3, device="cpu")
    shard = plan.chunk // plan.series_ways
    want_qs, want_stats = fit_batched(model, data, cfg, chunk_size=shard, seed=3, device="cpu")
    assert torch.equal(qs, want_qs)
    assert all(torch.equal(stats[k], want_stats[k]) for k in stats)
    assert t_manifest.noted_stanza("plan")["chunk"] == shard  # the unplanned fit's own plan
    if devices > 1:  # mesh= is the 1-D series plan over its devices
        mq, _ = fit_batched(model, data, cfg, mesh=["cpu"] * devices, chunk_size=4, seed=3,
                            device="cpu")
        assert torch.equal(mq, qs)


def test_plan_and_mesh_errors(capsys):
    rng = np.random.default_rng(0)
    data = _gaussian(rng, 4, 12)
    model = GaussianHMM(2, nig_prior=NIGPrior())
    plan = make_plan(WorkloadShape(B=4, T=12, C=2), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="not both"):
        fit_batched(model, data, GibbsConfig(2, 2, 2), plan=plan, mesh=["cpu"], device="cpu")
    assert plan.ways("chain") == 2
    with pytest.raises(ValueError, match="not divisible"):
        fit_batched(model, data, GibbsConfig(2, 2, 3), plan=plan, device="cpu")
    other = make_plan(WorkloadShape(B=9, T=12, C=1), devices=["cpu"] * 2, chunk_size=3)
    fit_batched(model, data, GibbsConfig(2, 2, 1), plan=other, seed=1, device="cpu")
    err = capsys.readouterr().err
    assert "plan was built for B=9" in err and "chunk_size 3 rounded up to 4" in err


def test_a_fit_records_a_one_device_plan():
    rng = np.random.default_rng(1)
    data = _gaussian(rng, 3, 12)
    fit_batched(GaussianHMM(2, nig_prior=NIGPrior()), data, GibbsConfig(2, 2, 1), chunk_size=2,
                device="cpu")
    st = t_manifest.noted_stanza("plan")
    assert st["devices"] == 1 and st["platform"] == "cpu" and st["chunk"] == 2
    assert st["branch"] == "cuda" and st["mesh"] is None


@pytest.mark.parametrize("tp,branch,pinned", [(True, "assoc", "assoc"), (False, "scan", "seq"),
                                              ("auto", "cuda", "cuda")])
def test_dispatch_scope_pins_the_plan_s_branch(tp, branch, pinned):
    plan = make_plan(WorkloadShape(B=4, T=64), n_devices=1, time_parallel=tp, platform="cpu")
    assert plan.branch == branch
    with plan.dispatch_scope():
        assert td.resolve_auto(4, 64, device_type="cpu") == (pinned, "plan")
        # a time-varying call under a kernels' pin runs the scans
        assert td.resolve_routed(4, 64, cuda_ok=False, device_type="cpu") == (
            "seq" if pinned == "cuda" else pinned)
    assert td.resolve_auto(4, 64, device_type="cpu")[1] != "plan"


def test_place_needs_the_plan_s_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = make_plan(WorkloadShape(B=8, T=16), n_devices=4, platform="cuda", layout="series")
    assert isinstance(plan, Plan) and plan.device_list() == []
    with pytest.raises(RuntimeError, match="plan needs 4 devices"):
        plan.place(torch.zeros(2), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_plan(WorkloadShape(B=8, T=16))
    cpu = make_plan(WorkloadShape(B=8, T=16), devices=["cpu"] * 2, layout="series")
    assert cpu.place(torch.zeros(2), 1).device.type == "cpu"
