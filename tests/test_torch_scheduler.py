"""The port's micro-batching scheduler (`hhmm_tpu_torch/serve/
scheduler.py`, with its pager, faults and request recorder) against the
JAX scheduler: identical traffic through both on the CPU, every
:class:`TickResponse` compared at every flush.

The replays are those of the JAX ``TestScheduler``, ``TestAdmission``,
``TestFairScheduling``, ``TestPagerScheduler`` and ``TestTrafficFaults``
(`tests/test_serve.py`), cut to ≤ 32 series and ≤ 4 draws. Discrete
outputs — series order, ``shed``, ``degraded``, ``healthy_draws``,
``draw_ok``, the error's reason (its text before any exception
detail), rejected attaches, the counters and ``compile_count`` — must be
equal; ``probs``, ``loglik`` and the per-draw increments within rtol
1e-6 + atol 1e-5. The fairness replays use a fake recorder clock, as the
JAX tests do.
"""

import os

import numpy as np
import pytest
import torch

from hhmm_tpu import models as jm
from hhmm_tpu.obs.request import RequestRecorder as JRecorder
from hhmm_tpu.robust import faults as jfaults
from hhmm_tpu.serve import AdmissionPolicy as JAdmission
from hhmm_tpu.serve import MicroBatchScheduler as JScheduler
from hhmm_tpu.serve import SnapshotPager as JPager
from hhmm_tpu.serve import registry as jreg
from hhmm_tpu_torch import models as tm
from hhmm_tpu_torch.obs.request import RequestRecorder
from hhmm_tpu_torch.plan import WorkloadShape, make_plan
from hhmm_tpu_torch.robust import faults
from hhmm_tpu_torch.serve import AdmissionPolicy, MicroBatchScheduler, SnapshotPager
from hhmm_tpu_torch.serve import registry as treg
from hhmm_tpu_torch.sim import tayal_batch

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-5
COUNTERS = ("ticks", "shed_ticks", "rejected_attaches", "dispatch_errors", "device_loss_events",
            "degraded_responses", "degraded_attaches", "superseded_responses", "warm_page_ins",
            "compile_count")


def _draws(n_free, n_draws=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_draws, n_free)) * 0.3).astype(np.float32)


def _reason(err):
    return None if err is None else err.split(" (")[0]


def same_response(a, b):
    assert a.series_id == b.series_id
    assert (a.shed, a.degraded, a.healthy_draws) == (b.shed, b.degraded, b.healthy_draws), (a, b)
    assert _reason(a.error) == _reason(b.error), (a.error, b.error)
    np.testing.assert_allclose(a.probs, np.asarray(b.probs), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(a.loglik, b.loglik, rtol=RTOL, atol=ATOL)
    if b.per_draw_loglik is None:
        assert a.per_draw_loglik is None and a.draw_ok is None
    else:
        np.testing.assert_allclose(a.per_draw_loglik, np.asarray(b.per_draw_loglik),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(a.draw_ok, np.asarray(b.draw_ok))


class Twin:
    """The same model, snapshots and traffic on both schedulers."""

    def __init__(self, make_model, tmp_path=None, pager_budget=None, admission=None,
                 recorders=None, retry_sleep=None, compiles=True, **kw):
        self.tmodel, self.jmodel = make_model(tm), make_model(jm)
        self.compiles = compiles
        self.treg = self.jreg = self.tpager = self.jpager = None
        tkw, jkw = dict(kw), dict(kw)
        if tmp_path is not None:
            self.treg = treg.SnapshotRegistry(str(tmp_path / "t"))
            self.jreg = jreg.SnapshotRegistry(str(tmp_path / "j"))
            tkw["registry"], jkw["registry"] = self.treg, self.jreg
            if pager_budget is not None:
                pkw = {} if retry_sleep is None else {"retry_sleep": retry_sleep}
                self.tpager = SnapshotPager(self.treg, budget_bytes=pager_budget, device="cpu", **pkw)
                self.jpager = JPager(self.jreg, budget_bytes=pager_budget, **pkw)
                tkw["pager"], jkw["pager"] = self.tpager, self.jpager
        if admission is not None:
            tkw["admission"] = AdmissionPolicy(**admission)
            jkw["admission"] = JAdmission(**admission)
        if recorders is not None:
            tkw["recorder"], jkw["recorder"] = recorders
        self.t = MicroBatchScheduler(self.tmodel, device="cpu", **tkw)
        self.j = JScheduler(self.jmodel, **jkw)

    def snaps(self, draws, healthy=True):
        return (treg.PosteriorSnapshot(spec=treg.model_spec(self.tmodel), draws=draws, healthy=healthy),
                jreg.PosteriorSnapshot(spec=jreg.model_spec(self.jmodel), draws=draws, healthy=healthy))

    def save(self, name, draws, healthy=True):
        st, sj = self.snaps(draws, healthy)
        self.treg.save(name, st)
        self.jreg.save(name, sj)

    def attach_many(self, items):
        """``items``: (sid, draws_or_None, history, [tenant], [healthy])."""
        ti, ji = [], []
        for it in items:
            sid, draws, hist = it[:3]
            tenant = it[3] if len(it) > 3 else None
            healthy = it[4] if len(it) > 4 else True
            st, sj = (None, None) if draws is None else self.snaps(draws, healthy)
            ti.append((sid, st, hist, tenant))
            ji.append((sid, sj, hist, tenant))
        rt, rj = self.t.attach_many(ti), self.j.attach_many(ji)
        assert [r[0] for r in rt] == [r[0] for r in rj]
        assert [r[1].split(":")[0] for r in rt] == [r[1].split(":")[0] for r in rj]
        self.check()
        return rt

    def submit(self, sid, obs, tenant=None):
        self.t.submit(sid, obs, tenant=tenant)
        self.j.submit(sid, obs, tenant=tenant)

    def flush(self):
        rt, rj = self.t.flush(), self.j.flush()
        assert len(rt) == len(rj)
        for a, b in zip(rt, rj):
            same_response(a, b)
        self.check()
        return rt

    def tick(self, obs_by_series):
        rt, rj = self.t.tick(obs_by_series), self.j.tick(obs_by_series)
        assert list(rt) == list(rj)
        for k in rt:
            same_response(rt[k], rj[k])
        self.check()
        return rt

    def check(self):
        for name in COUNTERS:
            if name == "compile_count" and not self.compiles:
                continue
            assert getattr(self.t.metrics, name) == getattr(self.j.metrics, name), name
        assert self.t.series_ids() == self.j.series_ids()
        if self.tpager is not None:
            assert self.tpager.resident_names() == self.jpager.resident_names()
            st, sj = self.tpager.stats(), self.jpager.stats()
            for k in ("resident", "resident_bytes", "loads", "reloads", "evictions", "hits",
                      "misses", "load_retries"):
                assert st[k] == sj[k], k

    def states_close(self, sid):
        a, l, ok, _ = self.t.state(sid)
        ja, jl, jok, _ = self.j.state(sid)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


MULTI = lambda M: M.MultinomialHMM(2, 3)  # noqa: E731
TAYAL = lambda M: M.TayalHHMM(gate_mode="hard")  # noqa: E731
GAUSS = lambda M: M.GaussianHMM(2)  # noqa: E731
N_FREE_MULTI = tm.MultinomialHMM(2, 3).n_free


# ---- TestScheduler ----

def test_warmup_signatures_flat_32_series():
    """32 Tayal series, buckets (8, 16, 32): the same compile count at
    every flush, flat after the init and update warmup ticks; a partial
    flush pads into the smallest bucket (one new signature, then flat)."""
    B, T = 32, 8
    x, sign = (v.numpy() for v in tayal_batch(B, T, seed=3, device="cpu"))
    tw = Twin(TAYAL, buckets=(8, 16, 32))
    tw.attach_many([(f"s{i}", _draws(tw.tmodel.n_free, 4), None) for i in range(B)])
    for t in range(T):
        for i in range(B):
            tw.submit(f"s{i}", {"x": int(x[i, t]), "sign": int(sign[i, t])})
        tw.flush()
        if t == 1:
            warm = tw.t.metrics.compile_count
    assert tw.t.metrics.compile_count == warm > 0
    for i in range(3):
        tw.submit(f"s{i}", {"x": int(x[i, 0]), "sign": int(sign[i, 0])})
    tw.flush()
    assert tw.t.metrics.compile_count == warm + 1


def test_warm_start_history_and_ragged_replay():
    x, sign = (v.numpy() for v in tayal_batch(2, 40, seed=5, device="cpu"))
    tw = Twin(TAYAL, buckets=(4,))
    d = _draws(tw.tmodel.n_free, 3)
    tw.attach_many([("a", d, {"x": x[0, :30], "sign": sign[0, :30]}),
                    ("b", d, {"x": x[1, :17], "sign": sign[1, :17]})])
    for sid in ("a", "b"):
        tw.states_close(sid)
    for t in range(30, 36):
        tw.tick({"a": {"x": int(x[0, t]), "sign": int(sign[0, t])},
                 "b": {"x": int(x[1, t]), "sign": int(sign[1, t])}})


def test_degraded_fit_served_from_last_healthy_snapshot(tmp_path):
    tw = Twin(MULTI, tmp_path=tmp_path, buckets=(4,))
    good, bad = _draws(tw.tmodel.n_free, 4, 1), _draws(tw.tmodel.n_free, 4, 2)
    tw.attach_many([("s", good, None)])
    tw.tick({"s": {"x": 1}})
    tw.attach_many([("s", bad, None, None, False)])  # kept, not swapped
    tw.tick({"s": {"x": 2}})
    tw.save("r", good)
    tw.attach_many([("r", bad, None, None, False)])  # the registry's healthy draws
    tw.tick({"r": {"x": 0}})
    tw.attach_many([("q", bad, None, None, False)])  # no fallback: flagged
    assert tw.tick({"q": {"x": 0}})["q"].degraded


def test_nonfinite_draws_frozen_and_flagged():
    tw = Twin(GAUSS, buckets=(4,))
    rng = np.random.default_rng(0)
    x = rng.normal(size=6).astype(np.float32)
    ok = _draws(tw.tmodel.n_free, 4, 3)
    mixed = ok.copy()
    mixed[1] = np.nan
    tw.attach_many([("ok", ok, None), ("dead", np.full_like(ok, np.nan), None), ("mixed", mixed, None)])
    for t in range(4):
        out = tw.tick({s: {"x": float(x[t])} for s in ("ok", "dead", "mixed")})
        assert out["dead"].degraded and out["mixed"].healthy_draws == 3


def test_waves_keys_values_dtypes_and_latest_wins():
    tw = Twin(MULTI, buckets=(4,))
    d = _draws(tw.tmodel.n_free, 3, 4)
    tw.attach_many([("a", d, None), ("b", d, None), ("c", d, None)])
    # the pre-lock keyset is the wave majority: the oldest typo sheds
    tw.submit("c", {"y": 1})
    tw.submit("a", {"x": 0})
    tw.submit("b", {"x": 1})
    tw.flush()
    for xv in (0, 1, 2, 1):  # queued repeats fold as waves
        tw.submit("a", {"x": xv})
    tw.flush()
    # a malformed value poisons its wave's group only
    tw.submit("a", {"x": 1})
    tw.submit("a", {"x": 0})
    tw.submit("b", {"x": np.array([1, 2])})
    out = tw.flush()
    assert [r.shed for r in out] == [False, True, True]
    tw.submit("a", {"x": 0})  # queued before tick(): superseded
    tw.tick({"a": {"x": 1}, "b": {"x": 1}})
    tw.submit("nope", {"x": 0})  # not attached: shed
    tw.flush()
    for sid in ("a", "b"):
        tw.states_close(sid)


def test_float_ticks_after_int_warmup_promote():
    tw = Twin(GAUSS, buckets=(2,))
    tw.attach_many([("s", _draws(tw.tmodel.n_free, 2, 5), None)])
    tw.tick({"s": {"x": 1}})
    for v in (1.75, 2.5, 0.25):
        tw.tick({"s": {"x": v}})
    tw.states_close("s")


def test_attach_batch_rejects_per_item_commits_rest():
    # a warm replay that raises inside build leaves an entry in the JAX
    # jit cache; the port counts only signatures that ran, so the
    # compile counts are not compared here
    tw = Twin(MULTI, buckets=(4,), compiles=False)
    n = tw.tmodel.n_free
    bad = np.zeros((4, n + 1), np.float32)
    tw.attach_many([("b", bad, None)])
    assert tw.t.n_draws is None
    tw.attach_many([("a", _draws(n, 4, 2), None), ("b", bad, None)])
    tw.attach_many([("c", _draws(n, 4, 2), None), ("d", _draws(n, 4, 2), {"wrong_key": np.arange(5)}),
                    ("e", None, None), ("f", _draws(n, 8, 2), None)])
    assert tw.t.series_ids() == ["a", "c"]


# ---- TestAdmission ----

@pytest.mark.parametrize("policy,plan", [
    (dict(max_queue_depth=2), [("s0", 0), ("s1", 1), ("s2", 2), ("s3", 0)]),
    (dict(max_pending_per_series=1), [("quiet", 0), ("noisy", 0), ("noisy", 1)]),
    (dict(max_ticks_per_flush=2), [("s0", 0), ("s1", 1), ("s2", 2), ("s3", 0)]),
])
def test_admission_sheds_alike(policy, plan):
    tw = Twin(MULTI, buckets=(4,), admission=policy)
    d = _draws(tw.tmodel.n_free)
    tw.attach_many([(s, d, None) for s in sorted({s for s, _ in plan})])
    for s, x in plan:
        tw.submit(s, {"x": x})
    tw.flush()
    tw.flush()


def test_max_series_and_parked_responses_bounded():
    tw = Twin(MULTI, buckets=(4,), admission=dict(max_series=2, max_queue_depth=2))
    d = _draws(tw.tmodel.n_free)
    tw.attach_many([(f"s{i}", d, None) for i in range(3)])
    assert tw.attach_many([("s0", d, None)]) == []
    for i in range(20):
        tw.submit(f"ghost{i}", {"x": 0})
    assert len(tw.t._undelivered) == 8
    tw.check()
    tw.flush()


def test_over_cap_page_in_never_displaces_or_leaks(tmp_path):
    tw = Twin(MULTI, tmp_path=tmp_path, pager_budget=2 * 3 * N_FREE_MULTI * 4, buckets=(4,),
              admission=dict(max_series=2))
    for i in range(3):
        tw.save(f"p{i}", _draws(tw.tmodel.n_free, 3, i))
    tw.tick({"p0": {"x": 0}})
    tw.tick({"p1": {"x": 1}})
    assert tw.tick({"p2": {"x": 2}})["p2"].shed
    assert tw.tpager.stats()["evictions"] == 0


def test_admission_caps_from_plan_ladder():
    plan = make_plan(WorkloadShape(B=64, T=128, C=1, K=4), n_devices=1, buckets=(8, 32, 128),
                     platform="cpu")
    from hhmm_tpu.plan import WorkloadShape as JShape
    from hhmm_tpu.plan import make_plan as j_make_plan

    jplan = j_make_plan(JShape(B=64, T=128, C=1, K=4), n_devices=1, buckets=(8, 32, 128),
                        platform="cpu")
    for kw in ({}, dict(tenant_shares={"vip": 3.0}, flush_order="fifo", credit_factor=2)):
        assert AdmissionPolicy.from_plan(plan, **kw).__dict__ == JAdmission.from_plan(jplan, **kw).__dict__
    sched = MicroBatchScheduler(tm.MultinomialHMM(2, 3), plan=plan, admission="auto", device="cpu")
    assert sched.admission.max_ticks_per_flush == 4 * 128
    with pytest.raises(ValueError):
        AdmissionPolicy(flush_order="lifo")
    with pytest.raises(ValueError):
        AdmissionPolicy(max_queue_depth=0)


# ---- TestFairScheduling ----

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _skewed_replay(order, rounds=6):
    """The JAX fairness replay: a hot tenant floods 3 waves over 8 series
    (quota 8), a quiet tenant submits one tick last, a flush a round,
    the fake clock +10 ms a flush."""
    ct, cj = _Clock(), _Clock()
    recs = (RequestRecorder(enabled=True, window_s=600.0, clock=ct),
            JRecorder(enabled=True, window_s=600.0, clock=cj))
    tw = Twin(MULTI, buckets=(8,), recorders=recs,
              admission=dict(max_ticks_per_flush=8, max_pending_per_series=8, flush_order=order))
    d = _draws(tw.tmodel.n_free)
    tw.attach_many([(f"h{i}", d, None, "hot") for i in range(8)] + [("q", d, None, "quiet")])

    def step():
        ct.t += 0.010
        cj.t += 0.010
        return tw.flush()

    for _ in range(2):
        for i in range(8):
            tw.submit(f"h{i}", {"x": i % 3}, tenant="hot")
        tw.submit("q", {"x": 0}, tenant="quiet")
        for _ in range(8):
            if not step():
                break
    for r in recs:
        r.reset_window()
    for r in range(rounds):
        for j in range(3):
            for i in range(8):
                tw.submit(f"h{i}", {"x": (r + j + i) % 3}, tenant="hot")
        tw.submit("q", {"x": r % 3}, tenant="quiet")
        step()
    return tw, recs


@pytest.mark.parametrize("order", ["fifo", "drr"])
def test_fair_replay_matches_jax(order):
    tw, (rt, rj) = _skewed_replay(order)
    assert rt.p99_spread_ms() == pytest.approx(rj.p99_spread_ms(), abs=1e-9)
    pt, pj = rt.stanza()["scheduler"], rj.stanza()["scheduler"]
    assert pt["order"] == pj["order"] == order
    assert pt["last_flush_order"] == pj["last_flush_order"]
    for t in ("hot", "quiet"):
        for k in ("served", "stranded", "credit"):
            assert pt["tenants"][t][k] == pj["tenants"][t][k], (t, k)
    assert dict(tw.t._credit) == dict(tw.j._credit)


def test_drr_per_series_fifo_and_capped_credit():
    tw = Twin(MULTI, buckets=(4,), history_tail=8,
              admission=dict(max_ticks_per_flush=4, max_pending_per_series=4, credit_cap_ticks=2,
                             tenant_shares={"hot": 3.0, "quiet": 1.0}))
    d = _draws(tw.tmodel.n_free)
    tw.attach_many([(f"h{i}", d, None, "hot") for i in range(4)]
                   + [(f"q{i}", d, None, "quiet") for i in range(4)])
    for r in range(6):
        for j in range(3):
            for i in range(4):
                tw.submit(f"h{i}", {"x": (r + j) % 3}, tenant="hot")
        for j in range(2):
            for i in range(4):
                tw.submit(f"q{i}", {"x": (r + j) % 3}, tenant="quiet")
        tw.flush()
        assert dict(tw.t._credit) == dict(tw.j._credit)
        assert all(v <= 2 for v in tw.t._credit.values())
    folded = 0
    for sid in tw.t.series_ids():  # the same ticks folded, in the same order
        a, b = tw.t.history_tail_of(sid), tw.j.history_tail_of(sid)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a["x"], b["x"])
            folded += 1
    assert folded > 0


# ---- TestPagerScheduler ----

def _paged(tmp_path, n=6, resident=2, **kw):
    tw = Twin(MULTI, tmp_path=tmp_path, pager_budget=resident * 3 * N_FREE_MULTI * 4, buckets=(4,), **kw)
    for i in range(n):
        tw.save(f"p{i}", _draws(tw.tmodel.n_free, 3, i))
    return tw


def test_eviction_reload_and_churn_signatures_flat(tmp_path):
    tw = _paged(tmp_path)
    tw.tick({"p0": {"x": 0}, "p1": {"x": 1}})
    tw.tick({"p0": {"x": 1}, "p1": {"x": 2}})
    warm = tw.t.metrics.compile_count
    for t in range(2):
        for i in range(6):
            assert not tw.tick({f"p{i}": {"x": (t + i) % 3}})[f"p{i}"].shed
    assert tw.t.metrics.compile_count == warm
    assert tw.tpager.stats()["evictions"] > 0 and tw.tpager.stats()["reloads"] > 0
    assert tw.tpager.peak_resident_bytes() <= tw.tpager.budget_bytes


def test_pinned_detach_and_load_miss(tmp_path):
    tw = _paged(tmp_path)
    for i in range(6):
        tw.submit(f"p{i}", {"x": i % 3})
    assert "p0" in tw.tpager.resident_names()
    tw.flush()
    tw.tick({"p4": {"x": 0}, "p5": {"x": 1}})
    tw.submit("p5", {"x": 2})
    assert tw.t.detach("p5") and tw.j.detach("p5")
    tw.submit("unregistered", {"x": 0})
    tw.flush()


def test_warm_page_in_matches_never_evicted_stream(tmp_path):
    tw = _paged(tmp_path, n=1, resident=100, history_tail=16)
    control = MicroBatchScheduler(tm.MultinomialHMM(2, 3), buckets=(4,), history_tail=16, device="cpu")
    control.attach("p0", tw.treg.load("p0"))
    for t in range(10):
        if t == 5:
            assert tw.tpager.evict("p0") and tw.jpager.evict("p0")
        r = tw.tick({"p0": {"x": t % 3}})["p0"]
        rc = control.tick({"p0": {"x": t % 3}})["p0"]
        np.testing.assert_array_equal(r.probs, rc.probs)  # bitwise in the port
        assert r.loglik == rc.loglik
    assert tw.t.metrics.warm_page_ins == 1


def test_tail_byte_budget_accounting_matches_jax():
    tw = Twin(MULTI, buckets=(4,), history_tail=4, tail_budget_bytes=400)
    d = _draws(tw.tmodel.n_free)
    tw.attach_many([(f"s{i}", d, None) for i in range(6)])
    for t in range(4):
        for i in range(6):
            tw.tick({f"s{i}": {"x": (t + i) % 3}})
    assert tw.t.tail_stats() == tw.j.tail_stats()


def test_budget_from_device_watermarks(monkeypatch):
    from hhmm_tpu_torch.serve import pager as pager_mod
    from hhmm_tpu_torch.serve import resolve_budget_bytes

    monkeypatch.setattr(pager_mod.telemetry, "sample_memory", lambda: {
        "0": {"bytes_limit": 1 << 20}, "1": {"bytes_limit": 2 << 20}})
    b, src = resolve_budget_bytes(None, fraction=0.25)
    assert b == (1 << 20) // 4 and "bytes_limit" in src
    assert resolve_budget_bytes(77) == (77, "explicit")


# ---- TestTrafficFaults ----

def test_device_loss_degrades_and_recovers():
    tw = Twin(MULTI, buckets=(4,))
    d = _draws(tw.tmodel.n_free)
    tw.attach_many([("a", d, None), ("b", d, None)])
    tw.tick({"a": {"x": 0}, "b": {"x": 1}})
    with faults.inject(faults.TrafficFaultPlan(device_loss_at_dispatch=0)), \
            jfaults.inject(jfaults.TrafficFaultPlan(device_loss_at_dispatch=0)):
        out = tw.tick({"a": {"x": 1}, "b": {"x": 2}})
        assert out["a"].shed and "SimulatedDeviceLoss" in out["a"].error
        assert not tw.tick({"a": {"x": 1}, "b": {"x": 2}})["a"].shed
    assert tw.t.metrics.device_loss_events == 1
    tw.states_close("a")


@pytest.mark.parametrize("mode", ["torn", "transient", "slow"])
def test_snapshot_load_faults_degrade_alike(mode, tmp_path):
    heal = []

    def resave(delay):
        heal.append(delay)
        for reg in (tw.treg, tw.jreg):
            reg.save("s", (tw.snaps(_draws(N_FREE_MULTI))[0] if reg is tw.treg else tw.snaps(_draws(N_FREE_MULTI))[1]))

    tw = Twin(MULTI, tmp_path=tmp_path, pager_budget=10**9, buckets=(4,),
              retry_sleep=resave if mode == "transient" else (lambda d: None))
    tw.save("s", _draws(N_FREE_MULTI))
    plan = {"torn": dict(tear_load_every=1), "transient": dict(tear_load_every=2),
            "slow": dict(slow_load_s=0.02, slow_load_every=1)}[mode]
    with faults.inject(faults.TrafficFaultPlan(**plan)), \
            jfaults.inject(jfaults.TrafficFaultPlan(**plan)):
        if mode == "transient":
            faults.snapshot_load_fault(tw.treg.path("s"))
            jfaults.snapshot_load_fault(tw.jreg.path("s"))
        out = tw.tick({"s": {"x": 0}})
    if mode == "torn":
        assert out["s"].shed and os.path.exists(tw.treg.path("s") + ".corrupt")
        assert tw.tpager.stats()["load_retries"] == 2
    elif mode == "transient":
        assert not out["s"].shed and tw.tpager.stats()["load_retries"] == 1 and heal
    else:
        assert not out["s"].shed and out["s"].latency_s >= 0.02


def test_burst_multiplier_shapes_arrivals():
    plan, jplan = faults.TrafficFaultPlan(burst_factor=4, burst_every=3), \
        jfaults.TrafficFaultPlan(burst_factor=4, burst_every=3)
    assert [plan.burst_multiplier(r) for r in range(6)] == [jplan.burst_multiplier(r) for r in range(6)]
    with faults.inject(faults.RegimeShiftPlan(at_tick=3)):
        assert [faults.regime_shift_active(t) for t in range(5)] == [False] * 3 + [True] * 2
        assert faults.traffic_active() is None and faults.active() is None
