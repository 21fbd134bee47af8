"""The measured ``time_parallel=`` dispatch of the port
(``hhmm_tpu_torch/kernels/dispatch.py``) and its consumers.

- the ``"auto"`` resolve order: a plan scope, then a scratch kernel
  cost DB's measured winner for this device kind, then the
  ``ASSOC_CROSSOVER`` table, then the default — the kernels for a
  homogeneous call, the sequential scans for a time-varying one — on
  both device types (the card's rules checked by calling the resolver
  with ``device_type="cuda"``, no CUDA run); a measured row never routes
  a homogeneous call to the plain scans; forces pass through, ``"cuda"``
  on a time-varying ``log_A`` raises, and an unknown value (``"pallas"``
  among them) raises the JAX ``ValueError`` with the port's branches;
- the span of each entry names the branch that ran (``[assoc]``,
  ``[seq]``, ``[plain]`` for the kernels' plain versions on the CPU);
- on a small batch on the CPU, ``time_parallel=True`` gives the default
  route's paths and draws: ``generated`` (homogeneous and the IOHMM's
  time-varying ``log_A``), ``state_draws``, ``GibbsConfig(time_parallel=
  True)`` in both Tayal gates, and ``wf_trade`` given the same draws,
  which stamps the resolved branch into its phase timings.
"""

import json

import numpy as np
import pytest
import torch

from hhmm_tpu.kernels import dispatch as jd
from hhmm_tpu_torch.apps.tayal import simulate_ticks, wf_trade
from hhmm_tpu_torch.apps.tayal import wf as t_wf
from hhmm_tpu_torch.apps.tayal.wf import build_tasks
from hhmm_tpu_torch.batch import default_init
from hhmm_tpu_torch.infer import GibbsConfig, sample_gibbs
from hhmm_tpu_torch.kernels import dispatch as td
from hhmm_tpu_torch.models import GaussianHMM, IOHMMReg, NIGPrior, TayalHHMM
from hhmm_tpu_torch.obs import profile as t_profile
from hhmm_tpu_torch.obs import trace as t_trace
from hhmm_tpu_torch.sim import tayal_batch

torch.set_num_threads(1)

HOM, TV = ("cuda", "assoc"), ("seq", "assoc")
CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def scratch_db(tmp_path, monkeypatch):
    """An empty scratch DB bound for the test; the card's device kind
    named without a card; the default binding restored after."""
    db = t_profile.KernelCostDB(str(tmp_path / "kernel_costs.json"))
    t_profile.set_db(db)
    monkeypatch.setitem(td._DEVICE_KINDS, "cuda", CARD)
    yield db
    t_profile.set_db(None)


def _rows(db, kernel, K, T, kind, **p50):
    for branch, ms in p50.items():
        timing = t_profile.DeviceTiming(reps=3, mean_s=ms, p50_s=ms, min_s=ms, max_s=ms,
                                        compile_s=None)
        db.put_row(kernel=kernel, branch=branch, K=K, T=T, B=64, dtype="float32",
                   timing=timing, device_kind=kind, source="test")


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_nothing_measured_keeps_the_default_route(scratch_db, device_type):
    for kernel in ("filter", "viterbi", "ffbs"):
        assert td.resolve_auto(4, 1024, kernel=kernel, device_type=device_type,
                               allowed=HOM) == ("cuda", "default")
        assert td.resolve_auto(4, 1024, kernel=kernel, device_type=device_type,
                               allowed=TV) == ("seq", "default")
        assert td.resolve_routed(4, 1024, kernel=kernel, cuda_ok=True,
                                 device_type=device_type) == "cuda"
        assert td.resolve_routed(4, 1024, kernel=kernel, cuda_ok=False,
                                 device_type=device_type) == "seq"


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_table_then_db_then_plan(scratch_db, monkeypatch, device_type):
    kind = CARD if device_type == "cuda" else "cpu"
    monkeypatch.setitem(td.ASSOC_CROSSOVER, device_type, ((8, 512),))
    assert td.resolve_auto(4, 1024, device_type=device_type, allowed=HOM) == ("assoc", "table")
    assert td.resolve_auto(4, 256, device_type=device_type, allowed=HOM) == ("cuda", "table")
    assert td.resolve_auto(4, 256, device_type=device_type, allowed=TV) == ("seq", "table")
    assert td.resolve_auto(16, 1024, device_type=device_type, allowed=HOM) == ("cuda", "default")
    # a measured race of this kernel at this (K, T) on this device kind wins
    _rows(scratch_db, "filter", 4, 1024, kind, cuda=0.2, assoc=0.5, seq=0.1)
    assert td.resolve_auto(4, 1024, device_type=device_type, allowed=HOM) == ("cuda", "db")
    assert td.resolve_auto(4, 1024, device_type=device_type, allowed=TV) == ("seq", "db")
    # another kernel's rows and another device kind's rows decide nothing
    assert td.resolve_auto(4, 1024, kernel="viterbi", device_type=device_type,
                           allowed=HOM) == ("assoc", "table")
    other = "cpu" if device_type == "cuda" else "cuda"
    assert td.resolve_auto(4, 1024, device_type=other, allowed=HOM)[1] != "db"
    # a plan scope wins over all of them
    with td.plan_time_parallel(True):
        assert td.resolve_auto(4, 1024, device_type=device_type, allowed=HOM) == ("assoc", "plan")
    with td.plan_time_parallel("cuda"):
        assert td.resolve_auto(4, 1024, device_type=device_type, allowed=TV) == ("seq", "plan")
    with td.plan_time_parallel(False):
        assert td.resolve_auto(4, 1024, device_type=device_type, allowed=HOM) == ("seq", "plan")
    assert td.resolve_auto(4, 1024, device_type=device_type, allowed=HOM) == ("cuda", "db")


def test_a_measured_row_never_routes_a_homogeneous_call_to_the_scans(scratch_db):
    _rows(scratch_db, "ffbs", 2, 4096, CARD, cuda=0.9, assoc=0.8, seq=0.01)
    _rows(scratch_db, "viterbi", 2, 4096, CARD, cuda=0.9, seq=0.01)
    assert td.resolve_routed(2, 4096, kernel="ffbs", device_type="cuda") == "assoc"
    # seq against cuda alone: no race among the branches a homogeneous call takes
    assert td.resolve_routed(2, 4096, kernel="viterbi", device_type="cuda") == "cuda"
    assert td.resolve_routed(2, 4096, kernel="ffbs", cuda_ok=False, device_type="cuda") == "seq"


@pytest.mark.parametrize("value,want", [(True, "assoc"), ("assoc", "assoc"), (False, "seq"),
                                        ("seq", "seq"), ("cuda", "cuda")])
def test_forces_pass_through(scratch_db, value, want):
    _rows(scratch_db, "filter", 4, 1024, CARD, cuda=0.5, assoc=0.1)
    with td.plan_time_parallel("assoc"):
        assert td.resolve_routed(4, 1024, value, device_type="cuda") == want
        assert td.resolve_branch(4, 1024, value, "cuda") == want


@pytest.mark.parametrize("value", ["pallas", "scan", "fused", 1, None])
def test_unknown_values_raise_the_jax_error(value):
    """The JAX error for a value it does not know, its branches the
    port's (``"pallas"`` is a JAX branch, not a port one)."""
    with pytest.raises(ValueError) as port:
        td.resolve_routed(4, 100, value)
    with pytest.raises(ValueError) as jax_:
        jd.resolve_branch(4, 100, "bogus")
    want = str(jax_.value).replace("'pallas')", "'cuda')").replace("'bogus'", repr(value))
    assert "('seq', 'assoc', 'cuda')" in str(port.value)
    assert str(port.value) == want


def _case(rng, N=3, T=24, K=3, tv=False):
    lp = torch.log_softmax(torch.as_tensor(rng.normal(size=(N, K)), dtype=torch.float32), -1)
    shape = (N, T - 1, K, K) if tv else (N, K, K)
    lA = torch.log_softmax(torch.as_tensor(rng.normal(size=shape), dtype=torch.float32), -1)
    lo = torch.as_tensor(rng.normal(size=(N, T, K)), dtype=torch.float32)
    m = torch.ones(N, T)
    m[1, T // 2:] = 0
    return lp, lA, lo, m


def test_cuda_on_time_varying_operands_raises():
    args = _case(np.random.default_rng(0), tv=True)
    with pytest.raises(ValueError, match="homogeneous"):
        td.forward_filter_dispatch(*args, time_parallel="cuda")
    with pytest.raises(ValueError, match="pallas"):
        td.viterbi_dispatch(*args, time_parallel="pallas")


@pytest.mark.parametrize("tv", [False, True], ids=["homogeneous", "time_varying"])
@pytest.mark.parametrize("branch", ["assoc", "seq", "auto"])
def test_spans_name_the_branch_that_ran(tv, branch):
    args = _case(np.random.default_rng(1), tv=tv)
    t_trace.reset()
    t_trace.enable()
    try:
        td.forward_filter_dispatch(*args, time_parallel=branch)
        td.backward_dispatch(*args[1:], time_parallel=branch)
        td.smooth_dispatch(*args, time_parallel=branch)
        td.viterbi_dispatch(*args, time_parallel=branch)
        if not tv:
            td.ffbs_dispatch(torch.Generator().manual_seed(0), *args, time_parallel=branch)
        table = t_trace.aggregate()
    finally:
        t_trace.reset()
        t_trace.tracer.use_env()
    ran = branch if branch != "auto" else ("seq" if tv else "plain")
    entries = ["forward_filter", "backward", "smooth", "viterbi"] + ([] if tv else ["ffbs"])
    assert set(table) == {f"kernels.dispatch.{e}[{ran}]" for e in entries}


@pytest.mark.parametrize("time_parallel", [True, "seq", "cuda"])
def test_routes_agree_on_a_homogeneous_batch(time_parallel):
    """Every branch of every entry on the same batch: probabilities
    within 1e-5, paths and draws identical (seed fixed; no step of its
    draws lies near a CDF edge)."""
    args = _case(np.random.default_rng(2), N=4, T=40, K=4)
    ref = td.smooth_dispatch(*args)
    for got, want in zip(td.smooth_dispatch(*args, time_parallel=time_parallel), ref):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    assert torch.equal(td.viterbi_dispatch(*args, time_parallel=time_parallel)[0],
                       td.viterbi_dispatch(*args)[0])
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    assert torch.equal(td.ffbs_dispatch(gen(), *args, time_parallel=time_parallel)[0],
                       td.ffbs_dispatch(gen(), *args)[0])


def _gaussian(rng, B=3, T=40):
    z = (np.cumsum(rng.random((B, T)) < 0.1, axis=1) % 3)
    x = np.array([-2.0, 0.0, 2.5])[z] + rng.normal(size=(B, T)) * 0.6
    return {"x": torch.as_tensor(x, dtype=torch.float32)}


def test_generated_and_state_draws_take_time_parallel():
    rng = np.random.default_rng(3)
    data = _gaussian(rng)
    model = GaussianHMM(3, nig_prior=NIGPrior())
    draws = default_init(model, data, 3, 4, seed=3, device="cpu")  # [3, 4, n_free]
    ref = model.generated(draws, data, device="cpu")
    for tp in (True, "seq"):
        got = model.generated(draws, data, device="cpu", time_parallel=tp)
        assert torch.equal(got["zstar"], ref["zstar"])
        for k in ("alpha", "gamma", "loglik", "logp_zstar"):
            torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=1e-5)
        # the same generator state: the same draws (seed fixed away from CDF edges)
        z = model.state_draws(torch.Generator().manual_seed(9), draws, data, device="cpu",
                              time_parallel=tp)
        assert torch.equal(z, model.state_draws(torch.Generator().manual_seed(9), draws, data,
                                                device="cpu"))


def test_iohmm_time_varying_decode_takes_the_assoc_scans():
    rng = np.random.default_rng(4)
    T, M = 30, 2
    u = np.concatenate([np.ones((2, T, 1)), rng.normal(size=(2, T, M - 1))], -1)
    data = {"x": torch.as_tensor(rng.normal(size=(2, T)), dtype=torch.float32),
            "u": torch.as_tensor(u, dtype=torch.float32)}
    model = IOHMMReg(K=3, M=M)
    draws = default_init(model, data, 2, 3, seed=4, device="cpu")
    t_trace.reset()
    t_trace.enable()
    try:
        got = model.generated(draws, data, device="cpu", time_parallel=True)
        spans = set(t_trace.aggregate())
    finally:
        t_trace.reset()
        t_trace.tracer.use_env()
    assert spans == {"kernels.dispatch.smooth[assoc]", "kernels.dispatch.viterbi[assoc]"}
    ref = model.generated(draws, data, device="cpu")
    assert torch.equal(got["zstar"], ref["zstar"])
    for k in ("alpha", "gamma", "loglik"):
        torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gate_mode", ["hard", "stan"])
def test_gibbs_time_parallel_draws_the_default_route_s_draws(gate_mode):
    """``GibbsConfig(time_parallel=True)``: the same uniforms, the same
    inverse-CDF rule, so the same chains (seed fixed; its draws sit away
    from the CDF edges)."""
    x, sign = tayal_batch(3, 48, seed=5, device="cpu")
    data = {"x": x, "sign": sign}
    model = TayalHHMM(gate_mode=gate_mode)
    init = default_init(model, data, 3, 2, seed=5, device="cpu")
    runs = [sample_gibbs(model, data, init, GibbsConfig(4, 6, 2, time_parallel=tp), seed=7,
                         device="cpu") for tp in ("auto", True, "seq")]
    for qs, stats in runs[1:]:
        assert torch.equal(qs, runs[0][0])
        torch.testing.assert_close(stats["logp"], runs[0][1]["logp"], rtol=1e-5, atol=1e-4)


def _wf_tasks():
    rng = np.random.default_rng(11)
    days = {sym: [dict(zip(("price", "size", "t_seconds"), simulate_ticks(rng, n_legs=60)[:3]))
                  for _ in range(7)] for sym in ("AAA", "BBB")}
    return build_tasks(days, 5, 1)


class _FakeFit:
    """``fit_batched`` replaced by draws made from each group's data, and
    the batch sizes it was asked for."""

    def __init__(self, samples):
        self.samples, self.sizes = samples, []

    def __call__(self, model, data, config, **kw):
        B = data["x"].shape[0]
        self.sizes.append(B)
        q = default_init(model, data, B, 1, seed=int(data["x"].sum()), device="cpu")
        noise = torch.as_tensor(np.random.default_rng(B).normal(size=(B, 1, self.samples,
                                                                        q.shape[-1])) * 0.05,
                                dtype=torch.float32)
        qs = q[:, :, None] + noise
        zeros = torch.zeros((B, 1, self.samples))
        return qs, {"logp": zeros, "diverging": zeros.bool(),
                    "chain_healthy": torch.ones((B, 1), dtype=torch.bool)}


# the decode's draws a task and tasks a dispatch, cut for the CPU
D_DEC, G_DEC = 10, 2


@pytest.mark.parametrize("gate_mode,samples", [("hard", D_DEC), ("stan", 6)],
                         ids=["hard_full", "stan_under_filled"])
def test_wf_trade_time_parallel_decodes_as_the_default(gate_mode, samples, monkeypatch):
    tasks = _wf_tasks()
    monkeypatch.setattr(t_wf, "D_DEC", D_DEC)
    monkeypatch.setattr(t_wf, "G_DEC", G_DEC)
    runs = {}
    for tp in ("auto", True):
        monkeypatch.setattr(t_wf, "fit_batched", _FakeFit(samples))
        phases = {}
        res = wf_trade(tasks, GibbsConfig(1, samples, 1), gate_mode=gate_mode, chunk_size=3,
                       phase_timings=phases, device="cpu", time_parallel=tp)
        runs[tp] = (res, phases)
    (ref, p_ref), (got, p_got) = runs["auto"], runs[True]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.leg_topstate, b.leg_topstate)
        assert json.dumps(a.summary, sort_keys=True, default=float) == json.dumps(
            b.summary, sort_keys=True, default=float)
    v_auto = "cuda" if gate_mode == "hard" else "seq"
    assert {k for k in p_ref if k.startswith("decode.time_parallel[")} == {
        f"decode.time_parallel[a0v:{v_auto},a0v:{v_auto}]"}
    assert {k for k in p_got if k.startswith("decode.time_parallel[")} == {
        "decode.time_parallel[a1v:assoc,a1v:assoc]"}
    assert sum(v for k, v in p_got.items() if k.startswith("decode.time_parallel[")) == \
        p_got["decode.dispatches"]


def test_wf_trade_mesh_pads_groups_to_the_device_count(monkeypatch):
    tasks = _wf_tasks()
    monkeypatch.setattr(t_wf, "D_DEC", D_DEC)
    monkeypatch.setattr(t_wf, "G_DEC", G_DEC)
    fake = _FakeFit(D_DEC)
    monkeypatch.setattr(t_wf, "fit_batched", fake)
    with_mesh = wf_trade(tasks, GibbsConfig(1, D_DEC, 1), gate_mode="hard", chunk_size=3,
                         mesh=["cpu", "cpu"], device="cpu")
    assert fake.sizes and all(b % 2 == 0 for b in fake.sizes)
    assert len(with_mesh) == len(tasks)
