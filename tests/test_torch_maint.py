"""The port's maintenance plane (`hhmm_tpu_torch/maint/`) against the
JAX package's (`hhmm_tpu/maint/`) on the CPU, on the same numpy inputs.

- :class:`MaintenancePolicy` driven by one call sequence in both
  packages, :func:`split_window`, and :func:`warm_refit`'s skips, batch
  layout and candidate ``meta`` (its sampler replaced in both packages
  by one deterministic fake): exact;
- :func:`predictive_logliks`, weighted and not, within rtol 1e-5 + atol
  1e-5, the ``-inf`` cases exact; :func:`shadow_evaluate`'s verdicts
  equal;
- both :class:`MaintenanceLoop`\\ s driven by twin schedulers on the same
  regime-shifted traffic, with the fake sampler, with the adaptation
  ladder wired (the JAX draws replayed into the port's rejuvenator) and
  without: identical counters, events, summaries and stanzas (numbers
  to the stanzas' own rounding, seconds excepted);
- the port's loop alone: the alarm routing through a ladder, the slots a
  failed refit hands back, and a real Gibbs refit on the CPU (the tail
  fills, then exactly one refit, promoted at the stated budget and
  seed).
"""

import json

import jax
import numpy as np
import pytest
import torch

import hhmm_tpu.maint.refit as jrefit_mod
import hhmm_tpu_torch.maint.loop as tloop_mod
import hhmm_tpu_torch.maint.refit as trefit_mod
from hhmm_tpu import adapt as jadapt
from hhmm_tpu import maint as jmaint
from hhmm_tpu import models as jm
from hhmm_tpu.serve import MicroBatchScheduler as JScheduler
from hhmm_tpu.serve import registry as jreg
from hhmm_tpu.serve.online import LoglikCUSUM as JCUSUM
from hhmm_tpu_torch import maint as tmaint
from hhmm_tpu_torch import models as tm
from hhmm_tpu_torch.adapt import AdaptationLadder
from hhmm_tpu_torch.infer import GibbsConfig
from hhmm_tpu_torch.maint import (
    MaintenanceLoop,
    MaintenancePolicy,
    RefitRequest,
    predictive_logliks,
    promote_snapshot,
    shadow_evaluate,
    split_window,
    warm_refit,
)
from hhmm_tpu_torch.serve import MicroBatchScheduler, PosteriorSnapshot, SnapshotRegistry
from hhmm_tpu_torch.serve import model_spec
from hhmm_tpu_torch.serve.online import LoglikCUSUM
from test_torch_adapt import JaxDraws

torch.set_num_threads(1)

A_TRUE = np.array([[0.9, 0.1], [0.1, 0.9]])
PHI_A = np.array([[0.80, 0.15, 0.05], [0.05, 0.15, 0.80]])
PHI_B = np.array([[0.05, 0.90, 0.05], [0.45, 0.10, 0.45]])  # category 1 is rare under A


def mhmm_series(rng, T, phi):
    z, xs = 0, []
    for _ in range(T):
        xs.append(rng.choice(3, p=phi[z]))
        z = rng.choice(2, p=A_TRUE[z])
    return np.asarray(xs, np.int64)


def bank(phi, D=6, seed=0, scale=0.05):
    """``[D, n_free]`` draws around the true parameters of one regime."""
    model = tm.MultinomialHMM(K=2, L=3)
    theta = model.pack({"p_1k": torch.tensor([0.5, 0.5]),
                        "A_ij": torch.tensor(A_TRUE, dtype=torch.float32),
                        "phi_k": torch.tensor(phi, dtype=torch.float32)}).numpy()
    rng = np.random.default_rng(seed)
    return (theta + rng.normal(size=(D, theta.shape[0])) * scale).astype(np.float32)


def snaps(draws, healthy=True, meta=None):
    tmod, jmod = tm.MultinomialHMM(K=2, L=3), jm.MultinomialHMM(K=2, L=3)
    return (PosteriorSnapshot(spec=model_spec(tmod), draws=draws, healthy=healthy,
                              meta=meta or {}),
            jreg.PosteriorSnapshot(spec=jreg.model_spec(jmod), draws=draws, healthy=healthy,
                                   meta=meta or {}))


# ---- the policy, the window ----


def policy_script(pol, MP):
    """One call sequence through a policy; returns every answer."""
    out = []
    out.append(pol.note_alarm("a", 10))
    out.append([(r.series_id, r.reason, r.tick) for r in pol.due(10)])
    pol.finish("a")
    out += [pol.note_alarm("a", 60), pol.pending_count, pol.note_alarm("a", 111)]
    out += [pol.note_alarm("b", 112), pol.note_alarm("b", 113)]
    out.append([(r.series_id, r.reason, r.tick) for r in pol.due(114)])
    out += [pol.note_alarm("b", 115), pol.inflight_count]
    for s in "cdefg":
        out.append(pol.note_alarm(s, 120))
    out += [pol.dropped, pol.pending_count]
    out += [pol.note_staleness("h", 5.0, 121), pol.note_staleness("h", float("nan"), 121),
            pol.note_staleness("h", 11.0, 121)]
    pol.finish("b")
    pol.finish("a")
    out.append([(r.series_id, r.reason, r.tick) for r in pol.due(130)])
    pol.reset_clock("c")
    pol.finish("c")
    out += [pol.note_alarm("c", 131), pol.pending_count, pol.inflight_count]
    return out


@pytest.mark.parametrize("kw", [
    dict(min_interval_ticks=100, max_concurrent=2, max_pending=3, max_staleness_s=10.0),
    dict(min_interval_ticks=0, max_concurrent=4, max_pending=64, max_staleness_s=None),
])
def test_policy_matches_jax(kw):
    assert policy_script(MaintenancePolicy(**kw), MaintenancePolicy) == \
        policy_script(jmaint.MaintenancePolicy(**kw), jmaint.MaintenancePolicy)


@pytest.mark.parametrize("kw", [dict(max_concurrent=0), dict(min_interval_ticks=-1),
                                dict(max_pending=0)])
def test_policy_validation(kw):
    with pytest.raises(ValueError):
        MaintenancePolicy(**kw)


def test_debounce_clock_lru_bounded(monkeypatch):
    import hhmm_tpu_torch.maint.triggers as triggers

    monkeypatch.setattr(triggers, "LAST_STARTED_CAP", 2)
    pol = MaintenancePolicy(min_interval_ticks=0, max_concurrent=8)
    for s in "abc":
        pol.note_alarm(s, 1)
    pol.due(1)
    assert len(pol._last_started) == 2


@pytest.mark.parametrize("n", [0, 3, 10])
def test_split_window_matches_jax(n):
    tail = {"x": np.arange(10), "sign": np.arange(10) % 2}
    got, want = split_window(tail, n), jmaint.split_window(tail, n)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError):
        split_window(tail, -1)


# ---- warm_refit with one deterministic fake sampler ----


class FakeFit:
    """``fit_batched`` of either package, replaced: records the data and
    inits it was given and returns, for row ``i``, the regime-B bank
    offset by ``0.01 i`` (``[B, C, D, dim]``), every chain healthy."""

    def __init__(self, torch_side, D=6):
        self.torch_side, self.D, self.calls = torch_side, D, []

    def __call__(self, model, data, *args, **kw):
        init, chunk = kw["init"], kw["chunk_size"]
        B, C = init.shape[:2]
        self.calls.append(dict(data={k: np.asarray(v) for k, v in data.items()},
                               init=np.asarray(init), chunk=chunk, B=B, C=C))
        draws = np.stack([bank(PHI_B, self.D, seed=5) + 0.01 * i for i in range(B)])
        samples = np.repeat(draws[:, None], C, axis=1)
        healthy = np.ones((B, C), bool)
        if self.torch_side:
            return torch.as_tensor(samples), {"chain_healthy": torch.as_tensor(healthy)}
        return samples, {"chain_healthy": healthy}


@pytest.fixture
def fake_fits(monkeypatch):
    tf, jf = FakeFit(True), FakeFit(False)
    monkeypatch.setattr(trefit_mod, "fit_batched", tf)
    monkeypatch.setattr(jrefit_mod, "fit_batched", jf)
    return tf, jf


def test_warm_refit_skips_layout_and_meta_match_jax(fake_fits):
    tf, jf = fake_fits
    rng = np.random.default_rng(1)
    reqs = [RefitRequest(s, "drift-alarm", 7) for s in ("nochamp", "notail", "short", "r1",
                                                         "keys", "r2")]
    jreqs = [jmaint.RefitRequest(r.series_id, r.reason, r.tick) for r in reqs]
    tails = {"notail": None, "short": {"x": np.arange(10)},
             "r1": {"x": rng.integers(0, 3, 32)}, "keys": {"y": np.arange(40)},
             "r2": {"x": rng.integers(0, 3, 27)}}
    champs = {s: snaps(bank(PHI_A, seed=i)) for i, s in enumerate(["notail", "short", "r1", "keys",
                                                                   "r2"])}
    cfg = GibbsConfig(2, 2, num_chains=3)
    tc, ts = warm_refit(tm.MultinomialHMM(K=2, L=3), reqs, tails,
                        {k: v[0] for k, v in champs.items()}, cfg, 5, eval_ticks=8,
                        min_fit_ticks=16, device="cpu")
    from hhmm_tpu.infer import GibbsConfig as JGibbs

    jc, js = jmaint.warm_refit(jm.MultinomialHMM(K=2, L=3), jreqs, tails,
                               {k: v[1] for k, v in champs.items()}, JGibbs(2, 2, num_chains=3),
                               jax.random.PRNGKey(5), eval_ticks=8, min_fit_ticks=16)
    assert ts == js
    assert [s for s, _ in ts] == ["nochamp", "notail", "short", "keys"]
    assert sorted(tc) == sorted(jc) == ["r1", "r2"]
    (tcall,), (jcall,) = tf.calls, jf.calls
    assert (tcall["B"], tcall["C"], tcall["chunk"]) == (jcall["B"], jcall["C"], jcall["chunk"]) \
        == (2, 3, 2)
    assert sorted(tcall["data"]) == sorted(jcall["data"]) == ["mask", "x"]
    for k in jcall["data"]:
        np.testing.assert_array_equal(tcall["data"][k], jcall["data"][k])
        assert tcall["data"][k].dtype == jcall["data"][k].dtype
    np.testing.assert_array_equal(tcall["init"], jcall["init"])
    for s in jc:
        assert tc[s].meta == jc[s].meta
        assert (tc[s].draws_dtype, tc[s].healthy) == (jc[s].draws_dtype, jc[s].healthy)
        np.testing.assert_array_equal(tc[s].draws, np.asarray(jc[s].draws))


def test_warm_refit_with_nothing_runnable_fits_nothing(fake_fits):
    tf, _ = fake_fits
    cands, skipped = warm_refit(tm.MultinomialHMM(K=2, L=3),
                                [RefitRequest("s", "staleness", 1)], {"s": None},
                                {"s": snaps(bank(PHI_A))[0]}, GibbsConfig(1, 1), device="cpu")
    assert cands == {} and skipped == [("s", "no history tail recorded")] and tf.calls == []


# ---- the shadow gate ----


def eval_tail(seed=3, T=12, phi=PHI_B):
    return {"x": mhmm_series(np.random.default_rng(seed), T, phi)}


def test_predictive_logliks_match_jax():
    tmod, jmod = tm.MultinomialHMM(K=2, L=3), jm.MultinomialHMM(K=2, L=3)
    ev = eval_tail()
    st, sj = snaps(bank(PHI_A, D=8, seed=2, scale=0.3))
    rng = np.random.default_rng(4)
    lw = np.log(rng.dirichlet(np.ones(8))).astype(np.float32)
    lw[[1, 5]] = -np.inf
    for w in (None, lw):
        got = predictive_logliks(tmod, st, ev, weights=w, device="cpu")
        want = jmaint.predictive_logliks(jmod, sj, ev, weights=w)
        assert got.shape == want.shape == (12,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the raw [D, dim] bank is taken too
    np.testing.assert_allclose(predictive_logliks(tmod, st.draws, ev, device="cpu"),
                               jmaint.predictive_logliks(jmod, sj.draws, ev), rtol=1e-5, atol=1e-5)


def gaussian_banks():
    tmod, jmod = tm.GaussianHMM(K=2), jm.GaussianHMM(K=2)
    rng = np.random.default_rng(0)
    ok = (rng.normal(size=(4, tmod.n_free)) * 0.3).astype(np.float32)
    part = ok.copy()
    part[[0, 2]] = np.nan
    dead = np.full_like(ok, np.nan)
    return tmod, jmod, ok, part, dead, {"x": rng.normal(size=16).astype(np.float32)}


def test_predictive_logliks_dead_draws_match_jax():
    tmod, jmod, ok, part, dead, ev = gaussian_banks()
    got = predictive_logliks(tmod, dead, ev, device="cpu")
    assert np.isneginf(got).all()
    np.testing.assert_array_equal(got, jmaint.predictive_logliks(jmod, dead, ev))
    got = predictive_logliks(tmod, part, ev, device="cpu")  # the two finite draws only
    np.testing.assert_allclose(got, jmaint.predictive_logliks(jmod, part, ev), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, predictive_logliks(tmod, ok[[1, 3]], ev, device="cpu"),
                               rtol=1e-5, atol=1e-5)
    w = np.full(4, -np.inf, np.float32)  # no finite weight: every tick -inf
    assert np.isneginf(predictive_logliks(tmod, ok, ev, weights=w, device="cpu")).all()
    assert np.isneginf(jmaint.predictive_logliks(jmod, ok, ev, weights=w)).all()


def verdict_tuple(v):
    return (v.series_id, v.ticks, v.accepted, v.margin, np.sign(v.mean_delta),
            np.isfinite(v.mean_delta))


def test_shadow_verdicts_match_jax():
    tmod, jmod = tm.MultinomialHMM(K=2, L=3), jm.MultinomialHMM(K=2, L=3)
    a, b = snaps(bank(PHI_A, seed=1)), snaps(bank(PHI_B, seed=2))
    sick = snaps(bank(PHI_B, seed=2), healthy=False)
    ev = eval_tail()
    cases = [(a, b, {}), (b, a, {}), (a, a, {}), (a, b, dict(margin=50.0)), (a, sick, {})]
    for champ, chall, kw in cases:
        got = shadow_evaluate(tmod, champ[0], chall[0], ev, series_id="s", device="cpu", **kw)
        want = jmaint.shadow_evaluate(jmod, champ[1], chall[1], ev, series_id="s", **kw)
        assert verdict_tuple(got) == verdict_tuple(want)
        for f in ("champion_loglik", "challenger_loglik", "mean_delta", "win_rate"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-5, atol=1e-5)
        assert set(got.stanza()) == set(want.stanza())
        json.dumps(got.stanza())
    assert shadow_evaluate(tmod, a[0], b[0], ev, device="cpu").accepted
    assert shadow_evaluate(tmod, a[0], a[0], ev, device="cpu").mean_delta == 0.0


def test_shadow_dead_sides_match_jax():
    tmod, jmod, ok, _, dead, ev = gaussian_banks()
    for champ, chall, delta in ((ok, dead, -np.inf), (dead, ok, np.inf)):
        got = shadow_evaluate(tmod, champ, chall, ev, device="cpu")
        want = jmaint.shadow_evaluate(jmod, champ, chall, ev)
        assert got.mean_delta == want.mean_delta == delta
        assert got.accepted == want.accepted == (delta > 0)


def test_shadow_eval_data_validation():
    tmod = tm.MultinomialHMM(K=2, L=3)
    with pytest.raises(ValueError, match="eval_data"):
        shadow_evaluate(tmod, bank(PHI_A), bank(PHI_B), {"x": np.zeros(0, np.int64)},
                        device="cpu")
    with pytest.raises(ValueError, match="eval_data"):
        shadow_evaluate(tmod, bank(PHI_A), bank(PHI_B),
                        {"x": np.zeros(3, np.int64), "y": np.zeros(4)}, device="cpu")


# ---- both loops on the same traffic ----


N_SERIES, SHIFT, TICKS = 3, 24, 64


class TwinLoops:
    """Twin registries, schedulers and loops (and ladders) on one
    regime-shifted stream of ``N_SERIES`` series."""

    def __init__(self, tmp_path, adapt):
        self.tmod, self.jmod = tm.MultinomialHMM(K=2, L=3), jm.MultinomialHMM(K=2, L=3)
        self.treg = SnapshotRegistry(str(tmp_path / "t"))
        self.jreg = jreg.SnapshotRegistry(str(tmp_path / "j"))
        self.ids = [f"m{i}" for i in range(N_SERIES)]
        for i, sid in enumerate(self.ids):
            st, sj = snaps(bank(PHI_A, seed=10 + i))
            self.treg.promote(sid, st)
            self.jreg.promote(sid, sj)
        self.ts = MicroBatchScheduler(self.tmod, buckets=(4,), registry=self.treg,
                                      history_tail=24, device="cpu")
        self.js = JScheduler(self.jmod, buckets=(4,), registry=self.jreg, history_tail=24)
        self.ts.attach_many([(s, self.treg.load_serving(s), None) for s in self.ids])
        self.js.attach_many([(s, self.jreg.load_serving(s), None) for s in self.ids])
        self.tl = self.jl = None
        if adapt:
            self.tl = AdaptationLadder(self.ts, escalate_after=1, device="cpu", source=JaxDraws(3))
            self.jl = jadapt.AdaptationLadder(self.js, jax.random.PRNGKey(3), escalate_after=1)
        pol = dict(min_interval_ticks=10, max_concurrent=4)
        from hhmm_tpu.infer import GibbsConfig as JGibbs

        self.tloop = MaintenanceLoop(
            self.ts, self.treg, self.tmod, GibbsConfig(2, 2), 7,
            policy=MaintenancePolicy(**pol), eval_ticks=6, min_fit_ticks=10,
            detector_factory=lambda sid: LoglikCUSUM(series=sid, threshold=3.0, calibrate=8),
            adapt=self.tl, device="cpu")
        self.jloop = jmaint.MaintenanceLoop(
            self.js, self.jreg, self.jmod, JGibbs(2, 2), jax.random.PRNGKey(7),
            policy=jmaint.MaintenancePolicy(**pol), eval_ticks=6, min_fit_ticks=10,
            detector_factory=lambda sid: JCUSUM(series=sid, threshold=3.0, calibrate=8),
            adapt=self.jl)
        rng = np.random.default_rng(0)
        self.x = np.stack([np.concatenate([mhmm_series(rng, SHIFT, PHI_A),
                                           mhmm_series(rng, TICKS - SHIFT, PHI_B)])
                           for _ in self.ids])

    def run(self):
        summaries = []
        for t in range(TICKS):
            for i, sid in enumerate(self.ids):
                self.ts.submit(sid, {"x": int(self.x[i, t])})
                self.js.submit(sid, {"x": int(self.x[i, t])})
            rt, rj = self.ts.flush(), self.js.flush()
            assert [r.series_id for r in rt] == [r.series_id for r in rj]
            if self.tl is not None:
                assert self.tl.observe(rt) == self.jl.observe(rj)
            assert self.tloop.observe(rt) == self.jloop.observe(rj)
            summaries.append((self.tloop.maybe_maintain(), self.jloop.maybe_maintain()))
        return summaries


def close_json(a, b, path="", tol=2e-4):
    """Equal JSON trees; floats to ``tol`` (both sides rounded to 4
    places), a key named ``seconds`` or ``*_seconds`` skipped."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, a, b)
        for k in b:
            if k == "seconds" or k.endswith("_seconds"):
                continue
            close_json(a[k], b[k], f"{path}.{k}", tol)
    elif isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            close_json(x, y, f"{path}[{i}]", tol)
    elif isinstance(b, float) and not isinstance(b, bool):
        assert isinstance(a, (float, int)) and abs(a - b) <= tol * max(1.0, abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("adapt", [False, True])
def test_loops_match_on_the_same_traffic(tmp_path, fake_fits, adapt):
    twin = TwinLoops(tmp_path, adapt)
    summaries = twin.run()
    for got, want in summaries:
        assert (got is None) == (want is None)
        if want is not None:
            close_json(got, want)
    st, sj = twin.tloop.stanza(), twin.jloop.stanza()
    close_json(st, sj)
    for k in ("triggers", "refits", "promotions", "shadow_rejections", "skipped_refits",
              "failed_swaps"):
        assert getattr(twin.tloop.metrics, k) == getattr(twin.jloop.metrics, k), k
    assert twin.tloop.promoted_series() == twin.jloop.promoted_series()
    assert st["promotions"] > 0 and st["refits"] > 0
    for sid in twin.tloop.promoted_series():
        assert twin.treg.serving_name(sid) == twin.jreg.serving_name(sid)
    if adapt:
        close_json(twin.tl.stanza(), twin.jl.stanza(), tol=2e-3)
        assert twin.tl.stanza()["rejuvenations"] > 0
    assert set(twin.tloop.stage_seconds) == {"refit", "shadow", "promote"}
    assert all(v > 0 for v in twin.tloop.stage_seconds.values())


# ---- the port's loop alone ----


def one_series_loop(tmp_path, policy, adapt=None, detector=None, tail=16, config=None, seed=0,
                    champion=None):
    model = tm.MultinomialHMM(K=2, L=3)
    reg = SnapshotRegistry(str(tmp_path))
    reg.save("s", PosteriorSnapshot(spec=model_spec(model),
                                    draws=bank(PHI_A, D=4) if champion is None else champion))
    sched = MicroBatchScheduler(model, buckets=(4,), registry=reg, history_tail=tail, device="cpu")
    sched.attach("s", reg.load_serving("s"))
    kw = {} if detector is None else dict(detector_factory=lambda sid: detector())
    loop = MaintenanceLoop(sched, reg, model, config or GibbsConfig(2, 2), seed, policy=policy,
                           adapt=adapt, device="cpu", **kw)
    return model, reg, sched, loop


class AlwaysAlarm:
    def update(self, inc):
        return float(inc), True

    def reset(self):
        pass


class FakeAdapt:
    def __init__(self, answers):
        self.answers, self.calls = list(answers), []

    def on_alarm(self, sid):
        self.calls.append(sid)
        return self.answers.pop(0)

    def on_promoted(self, sid):
        self.calls.append(("promoted", sid))


def tick(sched, loop, t):
    return loop.observe(sched.tick({"s": {"x": t % 3}}).values())


def test_fresh_alarm_consumed_by_ladder(tmp_path):
    fake = FakeAdapt(["rejuvenate", "rejuvenate", "escalate"])
    _, _, sched, loop = one_series_loop(tmp_path, MaintenancePolicy(min_interval_ticks=1),
                                        adapt=fake, detector=AlwaysAlarm)
    assert tick(sched, loop, 0) == 0 and fake.calls == []
    assert tick(sched, loop, 1) == 0 and tick(sched, loop, 2) == 0
    assert fake.calls == ["s", "s"]
    assert tick(sched, loop, 0) == 1 and fake.calls == ["s", "s", "s"]


def test_owed_alarm_skips_the_ladder(tmp_path):
    fake = FakeAdapt(["escalate"] * 3)
    _, _, sched, loop = one_series_loop(tmp_path, MaintenancePolicy(min_interval_ticks=1000),
                                        adapt=fake, detector=AlwaysAlarm)
    tick(sched, loop, 0)
    assert tick(sched, loop, 1) == 1 and fake.calls == ["s"]
    assert tick(sched, loop, 2) == 0 and fake.calls == ["s", "s"]
    assert tick(sched, loop, 0) == 0 and fake.calls == ["s", "s"]


def test_unwired_loop_routes_straight_to_policy(tmp_path):
    _, _, sched, loop = one_series_loop(tmp_path, MaintenancePolicy(min_interval_ticks=1),
                                        detector=AlwaysAlarm)
    tick(sched, loop, 0)
    assert tick(sched, loop, 1) == 1


def test_constructor_needs_history_tail_and_eval_ticks(tmp_path):
    model = tm.MultinomialHMM(K=2, L=3)
    sched = MicroBatchScheduler(model, buckets=(4,), device="cpu")
    with pytest.raises(ValueError, match="history_tail"):
        MaintenanceLoop(sched, None, model, GibbsConfig(1, 1), device="cpu")
    sched = MicroBatchScheduler(model, buckets=(4,), history_tail=8, device="cpu")
    with pytest.raises(ValueError, match="eval_ticks"):
        MaintenanceLoop(sched, None, model, GibbsConfig(1, 1), eval_ticks=0, device="cpu")


def test_exception_in_refit_releases_inflight_slots(tmp_path, monkeypatch):
    pol = MaintenancePolicy(max_concurrent=2)
    _, _, _, loop = one_series_loop(tmp_path, pol, tail=8)
    pol.note_alarm("s", 1)

    def boom(*a, **kw):
        raise RuntimeError("refit died")

    monkeypatch.setattr(tloop_mod, "warm_refit", boom)
    with pytest.raises(RuntimeError):
        loop.maybe_maintain()
    assert pol.inflight_count == 0


def test_promote_snapshot_registry_first_then_swap(tmp_path):
    model, reg, sched, _ = one_series_loop(tmp_path, MaintenancePolicy())
    sched.tick({"s": {"x": 1}})
    gen = sched.attach_generation("s")
    cand = PosteriorSnapshot(spec=model_spec(model), draws=bank(PHI_B, D=4), meta={"k": 1})
    res = promote_snapshot(sched, reg, "s", cand)
    assert res.swapped and res.reason is None and res.versioned_name == "s.v1"
    assert reg.serving_name("s") == "s.v1" and reg.load_serving("s").meta == {"k": 1}
    assert sched.attach_generation("s") == gen + 1
    np.testing.assert_array_equal(sched.draw_bank_of("s").numpy(), cand.draws)
    assert res.stanza() == {"series": "s", "version": "s.v1", "swapped": True}


def test_staleness_refit_skips_while_the_tail_fills_then_refits_once(tmp_path):
    """A real Gibbs refit on the CPU against a junk champion (random draws
    at scale 1.2, the JAX test's): early staleness triggers skip while
    the 24-tick tail fills (not burning the debounce), then the first
    full tail refits exactly once. Whether a 16-tick candidate beats the
    champion on 8 held-out ticks is itself random (the JAX counterpart
    fails its promotion on its own seed); this budget, 8 + 16 sweeps,
    and seed 3 give a promotion, which is asserted with its audit trail."""
    x = mhmm_series(np.random.default_rng(0), 30, PHI_B)
    junk = (np.random.default_rng(9).normal(size=(4, 7)) * 1.2).astype(np.float32)
    _, reg, sched, loop = one_series_loop(
        tmp_path,
        MaintenancePolicy(min_interval_ticks=10_000, max_concurrent=2, max_staleness_s=0.0),
        tail=24, config=GibbsConfig(8, 16), seed=3, champion=junk)
    loop.eval_ticks, loop.min_fit_ticks, loop.staleness_sweep_every = 8, 16, 1
    summaries = []
    for t in range(26):
        sched.submit("s", {"x": int(x[t])})
        loop.observe(sched.flush())
        s = loop.maybe_maintain()
        if s is not None:
            summaries.append(s)
    assert loop.metrics.skipped_refits >= 1
    assert loop.metrics.refits == 1
    assert loop.metrics.promotions == 1 and loop.promoted_series() == ["s"]
    assert reg.serving_name("s") == "s.v1"
    assert reg.load_serving("s").meta["maint"]["reason"] == "staleness"
    json.dumps(loop.stanza())


def test_public_names_match_the_jax_package():
    assert tmaint.__all__ == jmaint.__all__
    for name in tmaint.__all__:
        assert getattr(tmaint, name).__module__.startswith("hhmm_tpu_torch.maint")
