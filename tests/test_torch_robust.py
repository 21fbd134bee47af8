"""The port's fault injection and self-healing ``fit_batched``
(`hhmm_tpu_torch/robust/faults.py`, `robust/retry.py`, `batch/fit.py`)
against the JAX package.

- every in-scan corruption kind hits only its chain and its field, a
  wrong step is a no-op that adds no tensor op, ``corrupt_tree`` poisons
  only float leaves; the fault arrays equal the JAX ones;
- the escalation ladder field for field against the JAX ``escalate`` on
  NUTS, ChEES and Gibbs configs, and ``rejitter`` deterministic and
  distinct;
- a never-firing plan is bitwise the plan-free run for every sampler;
  a firing one quarantines exactly its chain (Gibbs, NUTS, ChEES, both
  arms);
- ``tests/test_robust.py``'s self-healing, sticky-fault, crash-resume
  and ``device_retries=0`` cases on its ``multinom_setup``
  (``MultinomialHMM(K=2, L=3)``, 4 x 50, Gibbs 5 + 15): the healed and
  the unhealed series and the ladder's log lines equal the JAX
  ``fit_batched``'s on the same plans (the draws differ by the random
  streams only). The JAX side runs once a plan for the module.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from hhmm_tpu.batch import fit_batched as j_fit_batched
from hhmm_tpu.infer import ChEESConfig as JChEESConfig
from hhmm_tpu.infer import GibbsConfig as JGibbsConfig
from hhmm_tpu.infer import SamplerConfig as JSamplerConfig
from hhmm_tpu.models import MultinomialHMM as JMultinomialHMM
from hhmm_tpu.robust import FaultPlan as JFaultPlan
from hhmm_tpu.robust import RetryPolicy as JRetryPolicy
from hhmm_tpu.robust import escalate as j_escalate
from hhmm_tpu.robust import faults as j_faults
from hhmm_tpu_torch.batch import fit_batched
from hhmm_tpu_torch.infer import (
    ChEESConfig,
    GibbsConfig,
    SamplerConfig,
    sample_chees_batched,
    sample_gibbs,
    sample_nuts_batched,
)
from hhmm_tpu_torch.models import MultinomialHMM
from hhmm_tpu_torch.robust import FaultPlan, RetryPolicy, SimulatedCrash, escalate, faults, rejitter

torch.set_num_threads(1)

LADDER = re.compile(r"(healing attempt .*|still quarantined .*)")


# ------------------------------------------------------------ corruption


def _arrays(kind, chain=1, step=5, n=3):
    with faults.inject(FaultPlan(kind=kind, step=step, chain=chain)):
        return faults.chain_fault_arrays(n)


@pytest.mark.parametrize(
    "kind,field,expect",
    [
        ("nan_logp", "logp", np.isnan),
        ("inf_logp", "logp", np.isinf),
        ("nan_grad", "grad", np.isnan),
        ("nan_state", "q", np.isnan),
    ],
)
def test_each_kind_hits_only_its_target(kind, field, expect):
    fs, fk = _arrays(kind)
    with j_faults.inject(JFaultPlan(kind=kind, step=5, chain=1)):
        jfs, jfk = j_faults.chain_fault_arrays(3)
    assert fs.tolist() == np.asarray(jfs).tolist() and fk.tolist() == np.asarray(jfk).tolist()
    lo, gr, qo = faults.corrupt(5, fs, fk, torch.zeros(3), torch.ones(3, 2), torch.ones(3, 2))
    out = {"logp": lo.numpy(), "grad": gr.numpy(), "q": qo.numpy()}
    assert expect(out[field][1]).all()
    for name, arr in out.items():
        mask = np.zeros(3, bool)
        mask[1] = name == field
        bad = ~np.isfinite(arr.reshape(3, -1)).all(axis=1)
        np.testing.assert_array_equal(bad, mask)


def test_wrong_step_is_noop():
    fs, fk = _arrays("nan_grad", step=5)
    logp, grad = torch.zeros(3), torch.ones(3, 2)
    lo, gr, qo = faults.corrupt(4, fs, fk, logp, grad, None)
    # no op at all: the very tensors come back
    assert lo is logp and gr is grad and qo is None


def test_corrupt_tree_nan_state():
    fs, fk = _arrays("nan_state", chain=0)
    tree = {"a": torch.ones(3, 2), "n": torch.arange(3)}
    out = faults.corrupt_tree(5, fs, fk, tree)
    assert torch.isnan(out["a"][0]).all() and torch.isfinite(out["a"][1:]).all()
    assert torch.equal(out["n"], torch.arange(3))


def test_batch_fault_arrays_target_one_series_and_plans_are_scoped():
    with faults.inject(FaultPlan(kind="nan_grad", step=7, chain=1, series=2)):
        fs, fk = faults.batch_fault_arrays(3, 2)
        with j_faults.inject(JFaultPlan(kind="nan_grad", step=7, chain=1, series=2)):
            jfs, jfk = j_faults.batch_fault_arrays(3, 2)
        assert fs.tolist() == np.asarray(jfs).tolist() and fk.tolist() == np.asarray(jfk).tolist()
        assert faults.active().series == 2
    assert faults.active() is None and faults.batch_fault_arrays(3, 2) is None
    with pytest.raises(TypeError, match="FaultPlan"):
        with faults.inject({"kind": "nan_grad"}):
            pass
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan(kind="bogus")


# ---------------------------------------------------------------- ladder


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.SamplerConfig(init_step_size=0.2, target_accept=0.8, max_treedepth=10),
        lambda m: m.SamplerConfig(max_treedepth=4),
        lambda m: m.ChEESConfig(max_leapfrogs=16, init_step_size=0.1),
        lambda m: m.ChEESConfig(max_leapfrogs=8, shared_adaptation=False),
        lambda m: m.GibbsConfig(),
    ],
    ids=["nuts", "nuts_floor", "chees", "chees_floor", "gibbs"],
)
@pytest.mark.parametrize("policy", [{}, {"step_size_factor": 0.25, "treedepth_step": 3,
                                         "target_accept_cap": 0.9}])
def test_escalation_ladder_matches_jax(make, policy):
    class Port:
        SamplerConfig, ChEESConfig, GibbsConfig = SamplerConfig, ChEESConfig, GibbsConfig

    class Jax:
        SamplerConfig, ChEESConfig, GibbsConfig = JSamplerConfig, JChEESConfig, JGibbsConfig

    cfg, jcfg = make(Port), make(Jax)
    for attempt in range(1, 5):
        got = _fields(escalate(cfg, attempt, RetryPolicy(**policy)))
        want = _fields(j_escalate(jcfg, attempt, JRetryPolicy(**policy)))
        assert got == {k: want[k] for k in got}, attempt
    assert escalate(cfg, 1) is cfg


def test_retry_policy_fields_match_jax():
    assert _fields(RetryPolicy()) == _fields(JRetryPolicy())
    assert [RetryPolicy(backoff_base_s=2.0).backoff(a) for a in range(3)] == [2.0, 4.0, 6.0]


def test_rejitter_deterministic_and_distinct():
    a1, a1b, a2 = rejitter(7, 1), rejitter(7, 1), rejitter(7, 2)
    assert a1 == a1b and a1 != a2 and a1 != 7 and rejitter(8, 1) != a1


# --------------------------------------------------------- in-scan guards


def _multinom_data(B=1, T=60, seed=0):
    return {"x": torch.as_tensor(np.random.default_rng(seed).integers(0, 3, size=(B, T)))}


def _run(sampler, plan=None):
    """One small run of ``sampler`` under ``plan`` (None: no plan)."""
    init = torch.as_tensor(np.random.default_rng(1).normal(size=(2, 2, 3)) * 0.3, dtype=torch.float32)

    def go():
        if sampler == "gibbs":
            model = MultinomialHMM(K=2, L=3)
            q0 = torch.as_tensor(np.random.default_rng(2).normal(size=(1, 2, model.n_free)),
                                 dtype=torch.float32)
            return sample_gibbs(model, _multinom_data(), q0, GibbsConfig(5, 20, 2), seed=3,
                                device="cpu")
        if sampler == "nuts":
            cfg = SamplerConfig(num_warmup=25, num_samples=10, num_chains=2, max_treedepth=4,
                                init_step_size=0.5)
            return sample_nuts_batched(lambda q: (-0.5 * (q * q).sum(-1), -q), init, cfg, seed=0,
                                       device="cpu")
        cfg = ChEESConfig(num_warmup=20, num_samples=15, num_chains=2, max_leapfrogs=8,
                          shared_adaptation=sampler == "chees")
        return sample_chees_batched(lambda q: (-0.5 * (q * q).sum(-1), -q), init, cfg, seed=0,
                                    device="cpu")

    if plan is None:
        return go()
    with faults.inject(plan):
        return go()


@pytest.mark.parametrize("sampler", ["gibbs", "nuts", "chees", "chees_per_series"])
def test_noop_plan_is_bitwise_control(sampler):
    qs0, st0 = _run(sampler)
    qs1, st1 = _run(sampler, FaultPlan(kind="nan_grad", step=-1, chain=-1))
    assert torch.equal(qs0, qs1)
    for k in st0:
        assert torch.equal(st0[k], st1[k]), k


@pytest.mark.parametrize(
    "sampler,plan,frozen_from",
    [
        ("gibbs", FaultPlan(kind="nan_logp", step=12, chain=0), 7),
        ("gibbs", FaultPlan(kind="nan_state", step=8, chain=0), 3),
        ("nuts", FaultPlan(kind="nan_grad", step=30, chain=0, series=1), 5),
        ("nuts", FaultPlan(kind="nan_logp", step=10, chain=1, series=0), 0),
        ("chees", FaultPlan(kind="nan_grad", step=25, chain=0, series=1), 5),
        ("chees_per_series", FaultPlan(kind="inf_logp", step=22, chain=1, series=0), 2),
    ],
)
def test_fault_quarantines_exactly_its_chain(sampler, plan, frozen_from):
    """`tests/test_robust.py`'s guard cases on the port: the targeted
    chain is quarantined at the fault's step, stays finite and frozen
    from the matching draw on, and every draw before it is bitwise the
    clean run's. (After it the other chains' draws may move: a batch
    draws from one generator, and how much of it a transition takes
    depends on the lanes, through the Gamma rejection sampler or the
    lockstep tree's depth.)"""
    qs0, _ = _run(sampler)
    qs, st = _run(sampler, plan)
    s, c = (0 if sampler == "gibbs" else plan.series), plan.chain
    healthy = torch.ones_like(st["chain_healthy"])
    healthy[s, c] = False
    assert torch.equal(st["chain_healthy"], healthy)
    assert int(st["quarantine_step"][s, c]) == plan.step
    assert torch.isfinite(qs).all() and torch.isfinite(st["logp"]).all()
    assert (qs[s, c, frozen_from:] == qs[s, c, frozen_from]).all()
    assert torch.equal(qs[:, :, :frozen_from], qs0[:, :, :frozen_from])


# ------------------------------------------------------- fit_batched heal


@pytest.fixture(scope="module")
def multinom_setup():
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 3, size=(4, 50))
    return xs, GibbsConfig(num_warmup=5, num_samples=15, num_chains=1)


def _ladder_lines(text):
    return [m.group(1) for line in text.splitlines() if (m := LADDER.search(line))]


@pytest.fixture(scope="module")
def jax_runs(multinom_setup):
    """The JAX ``fit_batched`` on each plan of the tests below, once:
    ``{name: (healthy [B, C], ladder log lines)}``."""
    import contextlib
    import io

    xs, _ = multinom_setup
    model = JMultinomialHMM(K=2, L=3)
    cfg = JGibbsConfig(num_warmup=5, num_samples=15, num_chains=1)
    plans = {
        "clean": (None, {}),
        "heal": (JFaultPlan(kind="unhealthy_result", series=1, chain=0, step=3), {}),
        "sticky": (JFaultPlan(kind="unhealthy_result", series=0, chain=0, step=3, sticky=True),
                   {"retry": JRetryPolicy(max_heal_attempts=2)}),
    }
    out = {}
    for name, (plan, kw) in plans.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), (
            j_faults.inject(plan) if plan is not None else contextlib.nullcontext()
        ):
            _, st = j_fit_batched(model, {"x": xs[:2]}, jax.random.PRNGKey(0), cfg, chunk_size=2, **kw)
        out[name] = (np.asarray(st["chain_healthy"]), _ladder_lines(buf.getvalue()))
    return out


def _port_fit(xs, cfg, capsys, plan=None, **kw):
    capsys.readouterr()
    model = MultinomialHMM(K=2, L=3)
    if plan is None:
        qs, st = fit_batched(model, {"x": xs}, cfg, device="cpu", **kw)
    else:
        with faults.inject(plan):
            qs, st = fit_batched(model, {"x": xs}, cfg, device="cpu", **kw)
    return qs, st, capsys.readouterr().err


def test_quarantined_series_redispatched_healthy_kept_bitwise(multinom_setup, jax_runs, tmp_path,
                                                              capsys):
    xs, cfg = multinom_setup
    xs = xs[:2]
    qs_clean, st_clean, err = _port_fit(xs, cfg, capsys, chunk_size=2)
    assert st_clean["chain_healthy"].all() and _ladder_lines(err) == jax_runs["clean"][1] == []
    plan = FaultPlan(kind="unhealthy_result", series=1, chain=0, step=3)
    qs, st, err = _port_fit(xs, cfg, capsys, plan, chunk_size=2, cache_dir=str(tmp_path))
    assert st["chain_healthy"].numpy().tolist() == jax_runs["heal"][0].tolist()
    assert st["chain_healthy"].all()
    assert _ladder_lines(err) == jax_runs["heal"][1] == [
        "healing attempt 1/3 for 1 quarantined series"]
    assert torch.isfinite(qs).all()
    # the untouched series is bitwise the clean result; the healed one
    # came from the re-jittered dispatch
    assert torch.equal(qs[0], qs_clean[0]) and not torch.equal(qs[1], qs_clean[1])
    # the cache holds the healed result: a rerun reads it back
    qs_r, st_r, err = _port_fit(xs, cfg, capsys, chunk_size=2, cache_dir=str(tmp_path))
    assert "cache hit" in err and torch.equal(qs, qs_r) and st_r["chain_healthy"].all()


def test_sticky_fault_degrades_gracefully(multinom_setup, jax_runs, capsys):
    xs, cfg = multinom_setup
    plan = FaultPlan(kind="unhealthy_result", series=0, chain=0, step=3, sticky=True)
    qs, st, err = _port_fit(xs[:2], cfg, capsys, plan, chunk_size=2,
                            retry=RetryPolicy(max_heal_attempts=2))
    healthy = st["chain_healthy"].numpy()
    assert healthy.tolist() == jax_runs["sticky"][0].tolist()
    assert not healthy[0].all() and healthy[1].all()
    assert int(st["quarantine_step"][0, 0]) == 3
    assert _ladder_lines(err) == jax_runs["sticky"][1] == [
        "healing attempt 1/2 for 1 quarantined series",
        "healing attempt 2/2 for 1 quarantined series",
        "still quarantined after 2 healing attempts (returned with chain_healthy=False)",
    ]


def test_padding_series_is_never_healed(multinom_setup, capsys):
    """A plan on the padding lane of a ragged chunk (weight 0) triggers
    no healing: sick series are real series only."""
    xs, cfg = multinom_setup
    plan = FaultPlan(kind="unhealthy_result", series=3, chain=0, step=3, sticky=True)
    qs, st, err = _port_fit(xs[:3], cfg, capsys, plan, chunk_size=2)
    assert st["chain_healthy"].all() and qs.shape[0] == 3 and _ladder_lines(err) == []


def test_crash_between_chunks_resumes_bitwise(multinom_setup, tmp_path, capsys):
    xs, cfg = multinom_setup
    d_ref, d_crash = str(tmp_path / "ref"), str(tmp_path / "crash")
    qs_ref, _, _ = _port_fit(xs, cfg, capsys, chunk_size=2, cache_dir=d_ref)
    with pytest.raises(SimulatedCrash):
        _port_fit(xs, cfg, capsys, FaultPlan(crash_after_chunks=1), chunk_size=2,
                  cache_dir=d_crash)
    # chunk 1 and the init entry survived the crash on disk
    import os

    assert len([f for f in os.listdir(d_crash) if f.endswith(".npz")]) == 2
    qs2, st2, err = _port_fit(xs, cfg, capsys, chunk_size=2, cache_dir=d_crash)
    assert "chunk 1/2: cache hit" in err and "chunk 2/2: computed + cached" in err
    assert torch.equal(qs_ref, qs2) and st2["chain_healthy"].all()


def test_device_retries_zero_still_runs_once(multinom_setup, capsys):
    xs, cfg = multinom_setup
    qs, st, err = _port_fit(xs[:2], cfg, capsys, chunk_size=2, retry=RetryPolicy(device_retries=0))
    assert qs.shape[0] == 2 and st["chain_healthy"].all()
    assert err.count("computed + cached") == 1


def test_in_scan_fault_escalates_nuts(capsys):
    """An in-scan fault fires on every dispatch (as in the JAX
    ``fit_batched``), so the series runs the whole ladder, escalated
    from attempt 2 on, and comes back quarantined."""
    model = MultinomialHMM(K=2, L=3)
    data = _multinom_data(B=2, T=30)
    cfg = SamplerConfig(num_warmup=6, num_samples=4, num_chains=1, max_treedepth=6)
    seen = []
    real = escalate

    def spy(config, attempt, policy):
        out = real(config, attempt, policy)
        seen.append((out.max_treedepth, out.init_step_size))
        return out

    import hhmm_tpu_torch.batch.fit as fit_module

    mp = pytest.MonkeyPatch()
    mp.setattr(fit_module, "escalate", spy)
    try:
        qs, st, err = _port_fit(data["x"], cfg, capsys, FaultPlan(kind="nan_grad", step=3, chain=0,
                                                                  series=1), chunk_size=2)
    finally:
        mp.undo()
    assert st["chain_healthy"][:, 0].tolist() == [True, False]
    assert seen == [(6, 0.1), (6, 0.05), (4, 0.025)]
    assert _ladder_lines(err)[-1].startswith("still quarantined after 3")
    assert "(escalated config)" in err
