"""The port's carry plane, async pipeline, pager, event feed and request
recorder (`hhmm_tpu_torch/serve/lanes.py`, `pipeline/`, `serve/pager.py`,
`serve/events.py`, `obs/request.py`), on the CPU:

- the lane table's refcounts, exact-membership bank hits, racing
  releases and spill order (the JAX ``tests/test_lanes.py`` cases), and
  the resident scheduler bitwise equal to the staged one through every
  commit boundary (bucket promotion, detach and warm re-attach, swap,
  draw-bank replacement) and a slot budget that spills;
- the pipeline: ``DevicePlacement`` hashing every id to the JAX
  placement's device, the in-flight table's FIFO and guard, pipelined
  flushes and an overlapped ``dispatch_async`` / ``harvest`` drive
  bitwise equal to the sync scheduler over a plan of repeated ``cpu``
  logical devices (the JAX ``tests/test_pipeline.py`` gate), a failed
  flight shedding without torn state;
- the pager: racing loads coalescing into one read, per-device
  partitions, and the same residency as the JAX pager on one trace;
- the event feed against the JAX feed on one stream, and the same
  events from a sync and a pipelined scheduler;
- the request recorder against the JAX recorder on one lifecycle
  script with a fake clock.

Thread cases run a fixed number of iterations, bound every wait and
join with a timeout, and never poll with ``sleep``.
"""

import threading

import numpy as np
import pytest
import torch

from hhmm_tpu.obs.request import RequestRecorder as JRecorder
from hhmm_tpu.pipeline import DevicePlacement as JPlacement
from hhmm_tpu.serve import SnapshotPager as JPager
from hhmm_tpu.serve import events as jev
from hhmm_tpu.serve import registry as jreg
from hhmm_tpu_torch import models as tm
from hhmm_tpu_torch.obs import manifest as obs_manifest
from hhmm_tpu_torch.obs.request import RequestRecorder
from hhmm_tpu_torch.pipeline import DevicePlacement, Flight, InFlightTable, placement_for_plan
from hhmm_tpu_torch.plan import WorkloadShape, make_plan
from hhmm_tpu_torch.serve import (
    CarryBank,
    LaneTable,
    MicroBatchScheduler,
    PosteriorSnapshot,
    RegimeEventFeed,
    SnapshotPager,
    SnapshotRegistry,
    model_spec,
)

torch.set_num_threads(1)

JOIN_S = 30.0


def _snap(model, n_draws=3, seed=0):
    rng = np.random.default_rng(seed)
    draws = (rng.normal(size=(n_draws, model.n_free)) * 0.3).astype(np.float32)
    return PosteriorSnapshot(spec=model_spec(model), draws=draws)


def _key(r):
    return (r.shed, r.loglik, np.asarray(r.probs).tobytes(),
            None if r.per_draw_loglik is None else np.asarray(r.per_draw_loglik).tobytes(),
            None if r.draw_ok is None else np.asarray(r.draw_ok).tobytes())


def _bank(keys, D=2, K=2, fill=0.0):
    B = len(keys)
    return CarryBank(torch.full((B, D, K), fill), torch.zeros(B, D), torch.ones(B, D, dtype=torch.bool),
                     tuple(keys))


# ---- the lane table ----

def test_lane_table_commit_lookup_drop_and_supersede():
    lt = LaneTable()
    b1 = _bank(["a", "b", "b"])
    lt.commit(b1, {"a": 0, "b": 1})
    assert lt.lookup("a") == (b1, 0) and lt.stats()["banks"] == 1
    assert lt.resident_bytes() == b1.nbytes
    assert lt.bank_for(("a", "b", "b")) is b1
    assert lt.bank_for(("a", "b")) is None  # not the padded membership
    b2 = _bank(["a"])
    lt.commit(b2, {"a": 0})
    assert lt.lookup("a") == (b2, 0) and lt.stats()["banks"] == 2
    assert lt.bank_for(("a", "b", "b")) is None  # a moved
    assert lt.drop("b") and not lt.drop("b")
    assert lt.stats()["banks"] == 1 and lt.resident_bytes() == b2.nbytes
    # a release only drops mappings still pointing at the victim
    assert lt.release(b1, ["a"]) == []
    assert lt.release(b2, ["a"]) == ["a"] and lt.stats()["series"] == 0


def test_lane_table_spill_candidates_oldest_first_and_protect():
    lt = LaneTable()
    banks = []
    for i, keys in enumerate((["x0", "x1"], ["y0", "y1"], ["z0", "z1"])):
        b = _bank(keys)
        lt.commit(b, {k: j for j, k in enumerate(keys)})
        banks.append(b)
    victims = lt.spill_candidates(2, protect=banks[2])
    assert [v[0] for v in victims] == banks[:2]
    assert lt.spill_candidates(6) == []


def test_lane_table_two_thread_churn():
    """Two threads commit, look up and drop for a fixed number of
    iterations; the byte accounting matches a recount at the end."""
    lt = LaneTable()
    errors = []

    def worker(tag):
        try:
            for i in range(300):
                keys = [f"{tag}{i % 5}", f"{tag}{(i + 1) % 5}"]
                lt.commit(_bank(keys), {k: j for j, k in enumerate(keys)})
                lt.lookup_many(keys)
                if i % 7 == 0:
                    lt.drop(keys[0])
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in "pq"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "lane-table churn thread did not finish"
    assert not errors, errors
    st = lt.stats()
    live = {id(lt.lookup(s)[0]): lt.lookup(s)[0] for s in [f"{c}{i}" for c in "pq" for i in range(5)]
            if lt.lookup(s) is not None}
    assert st["banks"] == len(live)
    assert st["resident_bytes"] == sum(b.nbytes for b in live.values())


# ---- resident carry = staged, bitwise ----

def _commit_boundary_run(resident, carry_slots_cap=None):
    model = tm.GaussianHMM(K=2)
    sched = MicroBatchScheduler(model, buckets=(4, 8, 16), resident=resident, history_tail=8,
                                carry_slots_cap=carry_slots_cap, device="cpu")
    sids = [f"s{i}" for i in range(24)]
    sched.attach_many([(s, _snap(model, seed=i), None) for i, s in enumerate(sids)])
    rng = np.random.default_rng(11)
    out = {}

    def tick_round(t, subset):
        for s in subset:
            sched.submit(s, {"x": float(rng.normal())})
        for r in sched.flush():
            assert not r.shed, (t, r.series_id, r.error)
            out[(t, r.series_id)] = _key(r)

    tick_round(0, sids)
    tick_round(1, sids)
    tick_round(2, sids[:5])  # bucket promotion: 16 -> 8 shapes
    tail = sched.history_tail_of("s7")
    assert tail is not None and sched.detach("s7")
    sched.attach("s7", _snap(model, seed=7), history=tail)
    tick_round(3, sids)
    assert sched.swap_snapshot("s11", snapshot=_snap(model, seed=1011)) is None
    a, l, o = sched.filter_state_of("s13")
    assert sched.replace_draw_bank("s13", sched.draw_bank_of("s13") * 1.01, a, l, o) is None
    tick_round(4, sids)
    tick_round(5, sids)
    states = {s: tuple(v.numpy().tobytes() for v in sched.state(s)[:3]) for s in sids}
    return out, states, sched


@pytest.mark.parametrize("cap", [None, 8])
def test_resident_matches_staged_bitwise(cap):
    staged, st_states, _ = _commit_boundary_run(False)
    res, res_states, sched = _commit_boundary_run(True, carry_slots_cap=cap)
    assert staged == res and st_states == res_states
    if cap is not None:
        assert sched._carry_spills > 0
    assert sched.metrics.carry_resident_bytes > 0


# ---- placement and the in-flight table ----

def test_placement_hash_matches_jax():
    for n, salt in ((1, ""), (3, ""), (4, "z")):
        a, b = DevicePlacement(n, salt=salt), JPlacement(n, salt=salt)
        assert [a.device_of(f"series-{i}") for i in range(128)] == \
            [b.device_of(f"series-{i}") for i in range(128)]
    items = [(f"s{i}", i) for i in range(20)]
    split = DevicePlacement(3).split(items, key=lambda it: it[0])
    assert sorted((gi, it) for pairs in split.values() for gi, it in pairs) == list(enumerate(items))
    with pytest.raises(ValueError, match="n_devices"):
        DevicePlacement(0)


def test_placement_for_plan_over_repeated_cpu_devices():
    plan = make_plan(WorkloadShape(B=8, T=16), devices=["cpu", "cpu", "cpu"])
    assert placement_for_plan(plan).n_devices == 3
    assert placement_for_plan(plan, n_devices=8).n_devices == 3  # clamped
    DevicePlacement(3, salt="s").record(plan)
    stanza = obs_manifest.noted_stanza("plan")
    assert stanza["placement"] == {"algo": "blake2b8-mod", "n_devices": 3, "salt": "s"}


def test_inflight_table_fifo_and_guard():
    t = InFlightTable()

    def flight(group):
        return Flight(t.next_id(), "update", 4, 0, [(s,) for s in group], [], None, {}, None, (), 0.0)

    f1, f2 = flight(["a", "b", "b"]), flight(["c"])
    t.add(f1)
    t.add(f2)
    assert t.guarded("b") and t.series_in_flight() == {"a", "b", "c"} and t.depth() == 2
    assert t.pop_oldest() is f1 and not t.guarded("a")
    assert t.pop_oldest() is f2 and t.pop_oldest() is None
    assert t.stats() == {"depth": 0, "peak_depth": 2, "dispatched": 2, "harvested": 2}


# ---- the async pipeline = the sync scheduler, bitwise ----

def _tayal_ticks(B, T, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 9, size=(B, T)), (np.arange(T)[None, :] + rng.integers(0, 2, size=(B, 1))) % 2


def _replay(pipeline, resident=False, n_dev=3, B=24, T=4):
    model = tm.TayalHHMM(gate_mode="hard")
    x, sign = _tayal_ticks(B, T)
    plan = make_plan(WorkloadShape(B=B, T=T), devices=["cpu"] * n_dev, buckets=(4, 8, 16))
    sched = MicroBatchScheduler(model, plan=plan if pipeline else None, buckets=(4, 8, 16),
                                pipeline=pipeline, resident=resident, device="cpu",
                                events=RegimeEventFeed(hold=1))
    snap = _snap(model, n_draws=4)
    sched.attach_many([(f"s{i}", snap, None) for i in range(B)])
    out, warm = {}, None
    for t in range(T):
        for i in range(B):
            sched.submit(f"s{i}", {"x": int(x[i, t]), "sign": int(sign[i, t])})
        for r in sched.flush():
            out[(t, r.series_id)] = _key(r)
        if t == 1:
            warm = sched.metrics.compile_count
    return out, sched, warm


@pytest.mark.parametrize("resident", [False, True])
def test_pipelined_flush_matches_sync_bitwise(resident):
    sync, ss, _ = _replay(False)
    pipe, sp, warm = _replay(True, resident=resident)
    assert sync == pipe
    assert sp.metrics.compile_count == warm
    st = sp.pipeline_stats()
    assert st["dispatched"] == st["harvested"] and st["n_devices"] == 3
    served = st["per_device_served"]
    assert len(served) == 3 and all(v > 0 for v in served.values()) and sum(served.values()) == 24 * 4
    # the same events series by series (the fan-out commits devices in
    # turn, so the interleaving across series differs)
    ev_sync = sorted((e.series_id, e.tick, e.kind, e.regime) for e in ss.events.drain())
    assert ev_sync and ev_sync == sorted((e.series_id, e.tick, e.kind, e.regime)
                                         for e in sp.events.drain())


def test_overlapped_drive_defers_repeats_and_matches_sync():
    """Submit round t+1 while round t is in the air: the in-flight guard
    defers each series' next tick, and the harvested responses equal the
    sync scheduler's."""
    B, T = 10, 5
    sync, _, _ = _replay(False, B=B, T=T)
    model = tm.TayalHHMM(gate_mode="hard")
    x, sign = _tayal_ticks(B, T)
    sched = MicroBatchScheduler(model, buckets=(4, 8, 16), pipeline=True, device="cpu")
    sched.attach_many([(f"s{i}", _snap(model, n_draws=4), None) for i in range(B)])
    seen = {}
    t_of = {f"s{i}": 0 for i in range(B)}
    for t in range(T):
        for i in range(B):
            sched.submit(f"s{i}", {"x": int(x[i, t]), "sign": int(sign[i, t])})
        assert sched.dispatch_async() >= 1
        if t:
            assert sched.metrics.inflight_deferred_ticks > 0 or sched._inflight.depth() > 0
        for r in sched.harvest():
            seen[(t_of[r.series_id], r.series_id)] = _key(r)
            t_of[r.series_id] += 1
    while sched.dispatch_async():
        for r in sched.harvest():
            seen[(t_of[r.series_id], r.series_id)] = _key(r)
            t_of[r.series_id] += 1
    assert seen == sync


def test_failed_flight_sheds_without_torn_state():
    model = tm.MultinomialHMM(2, 3)
    sched = MicroBatchScheduler(model, buckets=(4,), pipeline=True, device="cpu")
    for i in range(3):
        sched.attach(f"s{i}", _snap(model))
        sched.submit(f"s{i}", {"x": i % 3})
    assert len(sched.flush()) == 3
    before = {f"s{i}": sched.filter_state_of(f"s{i}")[0].clone() for i in range(3)}
    for i in range(3):
        sched.submit(f"s{i}", {"x": (i + 1) % 3})
    assert sched.dispatch_async() == 1

    class _Lost:
        def synchronize(self):
            raise RuntimeError("CUDA error: device lost in flight")

    flight = next(iter(sched._inflight._flights.values()))
    flight.event = _Lost()
    out = sched.harvest()
    assert len(out) == 3 and all(r.shed and "flight failed" in r.error for r in out)
    assert sched.metrics.device_loss_events == 1
    for i in range(3):
        assert torch.equal(before[f"s{i}"], sched.filter_state_of(f"s{i}")[0])
    sched.submit("s0", {"x": 1})
    assert not sched.flush()[0].shed
    plain = MicroBatchScheduler(model, buckets=(4,), device="cpu")
    with pytest.raises(ValueError, match="pipeline"):
        plain.harvest()


# ---- the pager ----

class _SignalCounter:
    def __init__(self, event):
        self.value, self.event = 0, event

    def inc(self, n=1):
        self.value += n
        self.event.set()

    def get(self):
        return self.value


class _BlockingRegistry:
    def __init__(self, snap, result=True):
        self.snap, self.result, self.loads = snap, result, 0
        self.release, self.entered = threading.Event(), threading.Event()

    def serving_name(self, name):
        return None

    def path(self, name):
        return f"/nonexistent/{name}.npz"

    def load(self, name):
        self.loads += 1
        self.entered.set()
        assert self.release.wait(timeout=JOIN_S)
        return self.snap if self.result else None


@pytest.mark.parametrize("result", [True, False])
def test_racing_loads_collapse_to_one_read(result):
    snap = _snap(tm.MultinomialHMM(2, 3))
    reg = _BlockingRegistry(snap, result)
    pager = SnapshotPager(reg, budget_bytes=1 << 20, device="cpu")
    waiting = threading.Event()
    pager._load_coalesced = _SignalCounter(waiting)
    results = []
    t1 = threading.Thread(target=lambda: results.append(pager.load("hot")))
    t1.start()
    assert reg.entered.wait(timeout=JOIN_S)
    t2 = threading.Thread(target=lambda: results.append(pager.load("hot")))
    t2.start()
    assert waiting.wait(timeout=JOIN_S)  # the racer reached the coalescing wait
    reg.release.set()
    for t in (t1, t2):
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    assert results == ([snap, snap] if result else [None, None])
    assert reg.loads == (1 if result else pager.load_retry.attempts)
    assert pager.stats()["load_coalesced"] == 1 and pager._loading == {}


def test_pager_per_device_partition(tmp_path):
    model = tm.MultinomialHMM(2, 3)
    reg = SnapshotRegistry(str(tmp_path))
    placement = DevicePlacement(2)
    dev0 = [n for n in (f"p{i}" for i in range(64)) if placement.device_of(n) == 0][:3]
    dev1 = [n for n in (f"q{i}" for i in range(64)) if placement.device_of(n) == 1][:1]
    snap = _snap(model, n_draws=8)
    for n in dev0 + dev1:
        reg.save(n, snap)
    nbytes = int(np.asarray(snap.draws).nbytes)
    pager = SnapshotPager(reg, budget_bytes=4 * nbytes, device="cpu")
    pager.set_placement(placement)
    assert pager.touch(dev1[0]) is not None
    for n in dev0:
        assert pager.touch(n) is not None
    st = pager.stats()
    assert st["per_device_bytes"]["0"] <= 2 * nbytes and st["per_device_bytes"]["1"] == nbytes
    assert dev0[0] not in pager.resident_names() and dev1[0] in pager.resident_names()


def test_pager_residency_matches_jax(tmp_path):
    model = tm.MultinomialHMM(2, 3)
    treg_, jreg_ = SnapshotRegistry(str(tmp_path / "t")), jreg.SnapshotRegistry(str(tmp_path / "j"))
    for i in range(6):
        s = _snap(model, seed=i)
        treg_.save(f"p{i}", s)
        jreg_.save(f"p{i}", jreg.PosteriorSnapshot(spec=s.spec, draws=s.draws))
    budget = 3 * int(_snap(model).draws.nbytes)
    tp = SnapshotPager(treg_, budget_bytes=budget, device="cpu")
    jp = JPager(jreg_, budget_bytes=budget)
    for name in ("p0", "p1", "p2", "p0", "p3", "p4", "p1", "p5", "p2"):
        for p in (tp, jp):
            if name == "p4":
                p.pin("p0")
            p.touch(name)
        assert tp.resident_names() == jp.resident_names()
    keys = ("resident", "resident_bytes", "peak_resident_bytes", "loads", "reloads", "evictions",
            "hits", "misses", "budget_overruns")
    assert {k: tp.stats()[k] for k in keys} == {k: jp.stats()[k] for k in keys}


# ---- events ----

def test_event_feed_matches_jax():
    rng = np.random.default_rng(4)
    a = RegimeEventFeed(hold=2, margin=0.1, drift_calibrate=8, queue_cap=16)
    b = jev.RegimeEventFeed(hold=2, margin=0.1, drift_calibrate=8, queue_cap=16)
    ll = {s: 0.0 for s in ("x", "y")}
    for t in range(120):
        for s, tenant in (("x", "A"), ("y", "B")):
            top = (t // 9 + (s == "y")) % 2
            gap = 0.6 if t % 5 else 0.02  # decisive or indecisive, never near 0.1
            p = [0.5 + gap / 2, 0.5 - gap / 2][:: 1 if top == 0 else -1]
            ll[s] += rng.normal(-1.0, 0.1) if t < 70 else rng.normal(-3.0, 0.1)
            gen = 2 if (s == "x" and t >= 100) else 1
            a.observe(s, tenant, np.asarray(p), ll[s], generation=gen)
            b.observe(s, tenant, np.asarray(p), ll[s], generation=gen)
    fields = ("series_id", "tenant", "kind", "tick", "regime", "prev_regime")
    ea, eb = a.drain(), b.drain()
    assert [tuple(getattr(e, f) for f in fields) for e in ea] == \
        [tuple(getattr(e, f) for f in fields) for e in eb]
    assert {e.kind for e in ea} == {"flip", "drift"}
    np.testing.assert_allclose([e.stat for e in ea], [e.stat for e in eb], rtol=1e-9)
    assert a.stanza() == b.stanza()


# ---- the request recorder ----

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_request_recorder_matches_jax():
    ct, cj = _Clock(), _Clock()
    recs = (RequestRecorder(enabled=True, window_s=60.0, clock=ct),
            JRecorder(enabled=True, window_s=60.0, clock=cj))
    for step in range(30):
        for rec, clock in zip(recs, (ct, cj)):
            clock.t = step * 0.01
            traces = [rec.enqueue(f"s{i}", "hot" if i < 3 else f"t{i}") for i in range(5)]
            clock.t += 0.002
            rec.admit(traces[:4])
            rec.stage(traces[:4], "bucket")
            clock.t += 0.001
            rec.stage(traces[:4], "dispatch")
            rec.begin_flight(step, traces[:4])
            clock.t += 0.003
            rec.note_harvest(step)
            clock.t += 0.001
            rec.stage(traces[:4], "device")
            rec.complete_group(traces[:4], kernel="update", bucket=4)
            rec.shed(traces[4], "shed under pressure")
            rec.note_transfers(64, 32)
            rec.note_flush_plan("drr", [{"tenant": "hot", "share": 1.0, "served": 3, "stranded": 0,
                                         "credit": 0.0}], credit_cap=8.0)
            rec.note_event("hot", "flip")
            rec.flush_done()
    a, b = recs[0].stanza(), recs[1].stanza()
    assert _same_tree(a, b)
    assert recs[0].p99_spread_ms() == pytest.approx(recs[1].p99_spread_ms())


def test_request_recorder_totals_behind_the_shares():
    clock = _Clock()
    rec = RequestRecorder(enabled=True, window_s=60.0, clock=clock)
    for step in range(10):
        clock.t = step * 0.01
        traces = [rec.enqueue(f"s{i}", f"t{i % 2}") for i in range(3)]
        clock.t += 0.002
        rec.admit(traces)
        rec.stage(traces, "bucket")
        clock.t += 0.001
        rec.stage(traces, "dispatch")
        rec.begin_flight(step, traces)
        clock.t += 0.003
        rec.note_harvest(step)
        clock.t += 0.001
        rec.stage(traces, "device")
        rec.complete_group(traces, kernel="update", bucket=4)
        rec.flush_done()
    sums, overall = rec.totals(), rec.stanza()["overall"]
    assert set(sums) == {"total", "queue", "device", "other", "hidden", "stall"}
    for key in ("queue", "device", "other"):
        assert overall[f"{key}_share"] == round(sums[key] / sums["total"], 4)
    assert overall["overlap_share"] == round(sums["hidden"] / sums["device"], 4)
    # 30 series ticks, each 4 ms from dispatch to its device stamp
    assert sums["device"] == pytest.approx(30 * 0.004)
    assert sums["hidden"] > 0


def _same_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b), (set(a) ^ set(b))
        return all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        return all(_same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-9, abs=1e-12, nan_ok=True), (a, b)
        return True
    assert a == b, (a, b)
    return True
