"""The port's adaptation plane (`hhmm_tpu_torch/adapt/`) against the JAX
package's (`hhmm_tpu/adapt/`) on the CPU, on the same numpy inputs.

- weight math on ``[B, D]`` rows with dead and non-finite entries:
  rtol 1e-6 + atol 1e-6, the ``-inf`` positions exact;
- the ladder's batched fold against the per-response loop of
  :func:`update_log_weights` (a series twice in one flush included):
  equal;
- :func:`liu_west_move` given the JAX draws (the JAX key split as
  ``Rejuvenator.move`` splits it): resample indices and ``ok`` exact,
  draws, ``alpha`` and ``ll`` within rtol 1e-6 + atol 1e-6; weights are
  drawn away from the inverse-CDF bucket edges, where the f32 ``cumsum``
  of the two packages may round apart;
- the properties of the JAX ``TestRejuvenator`` and ``TestAdaptationLadder``
  on the port;
- both ladders on the same scheduler traffic, the JAX draws replayed
  into the port's rejuvenator: the same events (kind, series, tick,
  reason), ESS within 1e-5 and equal stanza keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhmm_tpu import adapt as jadapt
from hhmm_tpu import models as jm
from hhmm_tpu.serve import MicroBatchScheduler as JScheduler
from hhmm_tpu.serve import registry as jreg
from hhmm_tpu_torch import adapt as tadapt
from hhmm_tpu_torch import models as tm
from hhmm_tpu_torch.adapt import AdaptationLadder, Rejuvenator, liu_west_move
from hhmm_tpu_torch.adapt import weights as W
from hhmm_tpu_torch.serve import MicroBatchScheduler, PosteriorSnapshot, model_spec
from hhmm_tpu_torch.serve.scheduler import TickResponse

torch.set_num_threads(1)

RTOL = ATOL = 1e-6


class JaxDraws:
    """The JAX ``Rejuvenator.move`` key flow as a draw source for the
    port's: one split a move, one key a series, then ``(k_u, k_n)``."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, N, D, P, dtype, device):
        self.key, sub = jax.random.split(self.key)
        return jax_move_draws(jax.random.split(sub, N), D, P)


def jax_move_draws(keys, D, P):
    u0, eps = [], []
    for k in keys:
        k_u, k_n = jax.random.split(k)
        u0.append(np.asarray(jax.random.uniform(k_u, (), dtype=jnp.float32)))
        eps.append(np.asarray(jax.random.normal(k_n, (D, P), dtype=jnp.float32)))
    return torch.as_tensor(np.stack(u0)), torch.as_tensor(np.stack(eps))


def same(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def weight_rows(seed=0, B=6, D=8):
    """``[B, D]`` log-weights, increments and health with dead draws, a
    NaN, ±inf increments, an all-dead row and an all-unhealthy row."""
    rng = np.random.default_rng(seed)
    lw = rng.normal(size=(B, D)).astype(np.float32)
    lw[0, 1] = lw[2, 3] = -np.inf
    lw[5] = -np.inf
    inc = (rng.normal(size=(B, D)) * 2).astype(np.float32)
    inc[1, 0], inc[1, 4], inc[3, 2] = np.nan, np.inf, -np.inf
    inc[4] = np.nan
    ok = rng.random((B, D)) > 0.15
    ok[2] = False
    return lw, inc, ok


# ---- weights ----


@pytest.mark.parametrize("forget", [1.0, 0.9, 0.5])
@pytest.mark.parametrize("with_lw", [True, False])
@pytest.mark.parametrize("with_ok", [True, False])
def test_update_log_weights_matches_jax(forget, with_lw, with_ok):
    lw, inc, ok = weight_rows()
    args = (lw if with_lw else None, inc, ok if with_ok else None)
    got = W.update_log_weights(*args, forget=forget)
    want = jadapt.update_log_weights(*args, forget=forget)
    same(got, want)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("name", ["ess", "normalized_weights"])
def test_weight_summaries_match_jax(name):
    lw, _, _ = weight_rows(1)
    same(getattr(W, name)(lw), getattr(jadapt, name)(lw))


@pytest.mark.parametrize("with_ok", [True, False])
def test_mixture_logliks_match_jax(with_ok):
    lw, inc, ok = weight_rows(2)
    o = ok if with_ok else None
    same(W.weighted_mixture_loglik(lw, inc, o), jadapt.weighted_mixture_loglik(lw, inc, o))
    same(W.uniform_mixture_loglik(inc, o), jadapt.uniform_mixture_loglik(inc, o))


def test_weighted_state_probs_matches_jax():
    lw, _, _ = weight_rows(3)
    rng = np.random.default_rng(3)
    la = np.log(rng.dirichlet(np.ones(3), size=lw.shape).astype(np.float32))
    same(W.weighted_state_probs(lw[:5], la[:5]), jadapt.weighted_state_probs(lw[:5], la[:5]))


def test_uniform_log_weights_match_jax():
    for d in (1, 4, 32):
        np.testing.assert_array_equal(W.uniform_log_weights(d), jadapt.uniform_log_weights(d))


@pytest.mark.parametrize("bad", [0.0, -0.1, 1.5])
def test_forget_validation(bad):
    with pytest.raises(ValueError, match="forget"):
        W.update_log_weights(None, np.zeros(3, np.float32), forget=bad)


def test_all_dead_resets_to_uniform_and_ess_zero():
    lw = W.update_log_weights(None, np.full(4, np.nan, np.float32))
    np.testing.assert_allclose(lw.numpy(), W.uniform_log_weights(4), rtol=1e-6)
    assert float(W.ess(np.full(4, -np.inf, np.float32))) == 0.0
    assert np.isneginf(float(W.weighted_mixture_loglik(lw, np.full(4, np.nan, np.float32))))


def test_weights_run_on_the_device_of_their_input():
    lw, inc, ok = weight_rows(4)
    out = W.update_log_weights(torch.as_tensor(lw), torch.as_tensor(inc), torch.as_tensor(ok))
    assert out.device.type == "cpu" and out.shape == lw.shape


# ---- the ladder's batched fold ----


class WeightTable:
    """The scheduler's weight-state surface alone."""

    def __init__(self):
        self.w = {}

    def weight_state_of(self, sid):
        return self.w.get(sid)

    def set_weight_state(self, sid, state):
        self.w[sid] = state


def fold_rows(seed=5, D=8):
    rng = np.random.default_rng(seed)
    sids = ["a", "b", "c", "a", "d", "b", "a"]  # a three times, b twice
    rows = []
    for i, sid in enumerate(sids):
        inc = (rng.normal(size=D) * 1.5).astype(np.float32)
        ok = rng.random(D) > 0.2
        if i == 2:
            inc[:] = np.nan  # kills every draw of c: a uniform restart
        rows.append((sid, inc, ok))
    return rows


@pytest.mark.parametrize("forget", [1.0, 0.95])
def test_batched_fold_equals_the_per_response_loop(forget):
    rows = fold_rows()
    stored = {"b": np.log(np.random.default_rng(9).dirichlet(np.ones(8))).astype(np.float32)}
    table = WeightTable()
    table.w.update({k: v.copy() for k, v in stored.items()})
    ladder = AdaptationLadder(table, forget=forget, device="cpu")
    got = ladder.fold(rows)
    loop = {k: v.copy() for k, v in stored.items()}
    want = []
    for sid, inc, ok in rows:
        new = W.update_log_weights(loop.get(sid), inc, ok, forget=forget).numpy()
        loop[sid] = new
        want.append((sid, float(W.ess(new))))
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_array_equal([e for _, e in got], [e for _, e in want])
    assert sorted(table.w) == sorted(loop)
    for sid in loop:
        np.testing.assert_array_equal(table.w[sid], loop[sid])


def test_batched_fold_matches_the_jax_loop():
    """The JAX ladder's own per-response fold on the same rows."""
    rows = fold_rows(6)
    table = WeightTable()
    got = AdaptationLadder(table, device="cpu").fold(rows)
    state, want = {}, []
    for sid, inc, ok in rows:
        new = np.asarray(jadapt.update_log_weights(state.get(sid), inc, ok, forget=0.99))
        state[sid] = new
        want.append(float(jadapt.ess(new)))
    np.testing.assert_allclose([e for _, e in got], want, rtol=1e-5, atol=1e-5)
    for sid in state:
        same(table.w[sid], state[sid])


# ---- the Liu–West move ----


def edge_free_cloud(seed, N=5, D=8, P=6, K=3, dead_series=None):
    """A cloud whose resample positions stay at least 1e-4 from every
    CDF edge (the two packages' f32 cumsums may round apart there)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    u0, eps = jax_move_draws(keys, D, P)
    rng = np.random.default_rng(seed)
    for _ in range(200):
        lw = (rng.normal(size=(N, D)) * 1.5).astype(np.float32)
        ok = rng.random((N, D)) > 0.2
        ok[:, 0] = True
        if dead_series is not None:
            ok[dead_series] = False
        w = np.where(ok, np.exp(lw - lw.max(1, keepdims=True)), 0.0)
        w = w / np.maximum(w.sum(1, keepdims=True), 1e-30)
        cdf = np.cumsum(w, 1)
        pos = (u0.numpy()[:, None] + np.arange(D)) / D
        if np.abs(cdf[:, None, :] - pos[:, :, None]).min() > 1e-4:
            break
    else:
        raise AssertionError("no edge-free cloud in 200 tries")
    draws = rng.normal(size=(N, D, P)).astype(np.float32)
    alpha = np.log(rng.dirichlet(np.ones(K), size=(N, D))).astype(np.float32)
    ll = rng.normal(size=(N, D)).astype(np.float32) * 10
    return (draws, lw, alpha, ll, ok), keys, u0, eps


@pytest.mark.parametrize("seed,dead", [(0, None), (1, 3), (2, None)])
@pytest.mark.parametrize("shrink", [0.98, 0.7])
def test_liu_west_move_matches_jax_given_its_draws(seed, dead, shrink):
    cloud, keys, u0, eps = edge_free_cloud(seed, dead_series=dead)
    got = liu_west_move(*[torch.as_tensor(a) for a in cloud], u0, eps, shrink=shrink)
    want = [np.asarray(a) for a in jadapt.liu_west_move(*[jnp.asarray(a) for a in cloud], keys,
                                                        shrink)]
    alpha, ll, ok = cloud[2], cloud[3], cloud[4]
    # the resample indices, read back from the (distinct) filter rows
    idx_of = {(n, float(ll[n, d])): d for n in range(ll.shape[0]) for d in range(ll.shape[1])}
    got_idx = [[idx_of[(n, float(v))] for v in row] for n, row in enumerate(got[2].numpy())]
    want_idx = [[idx_of[(n, float(v))] for v in row] for n, row in enumerate(want[2])]
    assert got_idx == want_idx
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
    state = (cloud[0], alpha, ll, ok)
    for g, a in zip(got, state):
        assert g.dtype == torch.as_tensor(a).dtype and g.shape == a.shape
    if dead is not None:  # nothing alive: passes through
        for g, a in zip(got, state):
            np.testing.assert_array_equal(g[dead].numpy(), a[dead])


def test_rejuvenator_replaying_jax_draws_matches_the_jax_rejuvenator():
    cloud, _, _, _ = edge_free_cloud(4, N=4)
    got = Rejuvenator(shrink=0.9, device="cpu", source=JaxDraws(11)).move(*cloud)
    want = jadapt.Rejuvenator(jax.random.PRNGKey(11), shrink=0.9).move(*cloud)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def cloud(rng, n=2, d=6, p=5, k=3):
    return (rng.normal(size=(n, d, p)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(n, d, k)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32),
            np.ones((n, d), bool))


def test_rejuvenator_shapes_dtypes_preserved_and_deterministic():
    rng = np.random.default_rng(0)
    c = cloud(rng)
    r1, r2 = Rejuvenator(0, device="cpu"), Rejuvenator(0, device="cpu")
    out1, out2 = r1.move(*c), r2.move(*c)
    for a, b, ref in zip(out1, out2, (c[0], c[2], c[3], c[4])):
        assert a.shape == ref.shape and a.dtype == torch.as_tensor(ref).dtype
        assert torch.equal(a, b)
    assert not np.array_equal(out1[0].numpy(), c[0])
    assert not torch.equal(r1.move(*c)[0], out1[0])  # the stream advances
    assert r1.compile_count == 1
    r1.move(*cloud(rng, n=4))
    assert r1.compile_count == 2


def test_degenerate_weights_collapse_to_winner():
    draws, _, alpha, ll, ok = cloud(np.random.default_rng(1), n=1)
    lw = np.full((1, 6), -np.inf, np.float32)
    lw[0, 4] = 0.0
    nd, na, _, _ = Rejuvenator(3, device="cpu").move(draws, lw, alpha, ll, ok)
    np.testing.assert_allclose(nd.numpy(), np.broadcast_to(draws[:, 4:5], draws.shape), atol=1e-5)
    np.testing.assert_array_equal(na.numpy(), np.broadcast_to(alpha[:, 4:5], alpha.shape))


def test_dead_draws_never_resampled():
    draws, _, alpha, ll, ok = cloud(np.random.default_rng(2), n=1)
    draws[0, 2] = 100.0
    lw = np.zeros((1, 6), np.float32)
    lw[0, 2] = 50.0
    ok[0, 2] = False
    nd, _, _, nk = Rejuvenator(4, device="cpu").move(draws, lw, alpha, ll, ok)
    assert float(nd.max()) < 50.0 and bool(nk.all())


def test_all_dead_cloud_passes_through():
    draws, lw, alpha, ll, ok = cloud(np.random.default_rng(3))
    ok[1] = False
    nd, na, _, nk = Rejuvenator(5, device="cpu").move(draws, lw, alpha, ll, ok)
    assert not np.array_equal(nd[0].numpy(), draws[0])
    np.testing.assert_array_equal(nd[1].numpy(), draws[1])
    np.testing.assert_array_equal(na[1].numpy(), alpha[1])
    np.testing.assert_array_equal(nk[1].numpy(), ok[1])


@pytest.mark.parametrize("bad", [0.0, 1.0, -0.5, 1.5])
def test_shrink_validation(bad):
    with pytest.raises(ValueError, match="shrink"):
        Rejuvenator(0, shrink=bad, device="cpu")


def test_keeps_weighted_moments_approximately():
    rng = np.random.default_rng(7)
    d, p = 256, 3
    draws = rng.normal(size=(1, d, p)).astype(np.float32)
    lw = rng.normal(size=(1, d)).astype(np.float32)
    nd = Rejuvenator(7, device="cpu").move(draws, lw, np.zeros((1, d, 2), np.float32),
                                            np.zeros((1, d), np.float32),
                                            np.ones((1, d), bool))[0][0].numpy()
    w = np.exp(lw[0] - lw[0].max())
    w /= w.sum()
    m = (w[:, None] * draws[0]).sum(0)
    v = (w[:, None] * (draws[0] - m) ** 2).sum(0)
    np.testing.assert_allclose(nd.mean(0), m, atol=4 * np.sqrt(v / d).max())
    assert (nd.var(0) < 3 * v).all()


# ---- the ladder on a scheduler ----


def fake_draws(n_free, n_draws, seed):
    return (np.random.default_rng(seed).normal(size=(n_draws, n_free)) * 0.3).astype(np.float32)


def attached(n_draws=4, n_series=1, buckets=(4,), history_tail=16):
    model = tm.MultinomialHMM(K=2, L=3)
    sched = MicroBatchScheduler(model, buckets=buckets, history_tail=history_tail, device="cpu")
    snap = PosteriorSnapshot(spec=model_spec(model), draws=fake_draws(model.n_free, n_draws, 0))
    sched.attach_many([(f"s{i}", snap, None) for i in range(n_series)])
    for t in range(2):
        sched.tick({f"s{i}": {"x": (t + i) % 3} for i in range(n_series)})
    return model, sched


def resp(sid, inc, ok=None, shed=False):
    d = 0 if inc is None else len(inc)
    return TickResponse(
        series_id=sid, probs=np.array([0.5, 0.5]), loglik=0.0, healthy_draws=d, degraded=False,
        latency_s=0.0, shed=shed,
        per_draw_loglik=None if inc is None else np.asarray(inc, np.float32),
        draw_ok=None if inc is None else (np.ones(d, bool) if ok is None else np.asarray(ok, bool)))


def test_observe_reweights_and_skips_sheds():
    _, sched = attached()
    ladder = AdaptationLadder(sched, device="cpu")
    n = ladder.observe([resp("s0", [0.5, 0.0, 0.0, 0.0]), resp("ghost", None, shed=True),
                        resp("noinc", None)])
    assert n == 1
    lw = sched.weight_state_of("s0")
    assert isinstance(lw, np.ndarray) and lw.shape == (4,)
    assert int(np.argmax(W.normalized_weights(lw))) == 0
    assert sched.weight_state_of("ghost") is None and sched.weight_state_of("noinc") is None
    st = ladder.stanza()
    assert st["reweight_ticks"] == 1 and st["rejuvenations"] == 0 and st["ess"][0]["series"] == "s0"


def test_ess_floor_triggers_batched_rejuvenation():
    _, sched = attached()
    ladder = AdaptationLadder(sched, ess_floor_frac=0.9, forget=1.0, device="cpu")
    bank0 = sched.draw_bank_of("s0").clone()
    gen0 = sched.attach_generation("s0")
    ladder.observe([resp("s0", [50.0, 0.0, 0.0, 0.0])])
    assert ladder.metrics.rejuvenations == 1
    bank1 = sched.draw_bank_of("s0")
    assert bank1.shape == bank0.shape and bank1.dtype == bank0.dtype
    assert not torch.equal(bank1, bank0)
    assert sched.attach_generation("s0") == gen0 + 1
    np.testing.assert_allclose(sched.weight_state_of("s0"), W.uniform_log_weights(4), rtol=1e-6)
    ev = ladder.stanza()["events"][-1]
    assert ev["kind"] == "rejuvenate" and ev["reason"] == "ess_floor"
    assert ev["ess_after"] == 4.0 > ev["ess_before"]
    r = sched.tick({"s0": {"x": 2}})["s0"]
    assert not r.shed and not r.degraded


def test_rejuvenation_budget_caps_per_flush_and_lands_on_buckets():
    _, sched = attached(n_series=3)
    ladder = AdaptationLadder(sched, ess_floor_frac=1.0, max_rejuv_per_flush=1, device="cpu")
    ladder.observe([resp(f"s{i}", [9.0, 0, 0, 0]) for i in range(3)])
    assert ladder.metrics.rejuvenations == 1
    ladder.rejuvenate(["s0", "s1", "s2"])
    assert ladder.rejuvenator.compile_count == 1  # both moves padded to the bucket of 4


def test_plan_caps_and_validation():
    class FakePlan:
        def admission_caps(self):
            return {"ess_floor_frac": 0.25, "max_rejuv_per_flush": 3}

    _, sched = attached()
    ladder = AdaptationLadder(sched, plan=FakePlan(), device="cpu")
    assert (ladder.ess_floor_frac, ladder.max_rejuv_per_flush, ladder.ess_floor(8)) == (0.25, 3, 2.0)
    assert AdaptationLadder(sched, plan=FakePlan(), ess_floor_frac=0.5,
                            device="cpu").ess_floor_frac == 0.5
    with pytest.raises(ValueError, match="ess_floor_frac"):
        AdaptationLadder(sched, ess_floor_frac=0.0, device="cpu")
    with pytest.raises(ValueError, match="escalate_after"):
        AdaptationLadder(sched, escalate_after=0, device="cpu")


def test_alarm_strikes_rejuvenate_then_escalate():
    _, sched = attached()
    ladder = AdaptationLadder(sched, escalate_after=2, device="cpu")
    assert [ladder.on_alarm("s0") for _ in range(3)] == ["rejuvenate", "rejuvenate", "escalate"]
    assert ladder.metrics.rejuvenations == 2 and ladder.metrics.escalations == 1
    ev = ladder.stanza()["events"][-1]
    assert ev["kind"] == "escalate" and ev["strikes"] == 3
    ladder.on_promoted("s0")
    assert ladder.on_alarm("s0") == "rejuvenate"


def test_rejuvenate_skips_unattached_and_unticked():
    model, sched = attached()
    ladder = AdaptationLadder(sched, device="cpu")
    sched.attach("cold", PosteriorSnapshot(spec=model_spec(model),
                                           draws=fake_draws(model.n_free, 4, 1)))
    assert ladder.rejuvenate(["nope", "cold"]) == 0 and ladder.metrics.rejuvenations == 0


def test_tick_after_rejuvenation_adds_no_signature():
    _, sched = attached(n_series=2)
    ladder = AdaptationLadder(sched, ess_floor_frac=1.0, device="cpu")
    before = sched.metrics.compile_count
    ladder.observe([resp("s0", [9.0, 0, 0, 0]), resp("s1", [9.0, 0, 0, 0])])
    for t in range(3):
        sched.tick({"s0": {"x": t % 3}, "s1": {"x": (t + 1) % 3}})
    assert sched.metrics.compile_count == before


# ---- both ladders on the same traffic ----


@pytest.mark.parametrize("forget,floor", [(0.99, 0.9), (1.0, 0.75)])
def test_ladders_match_on_the_same_traffic(forget, floor):
    """Both schedulers and ladders on one stream of 24 flushes over 4
    series (D = 8): a flush that ticks one series twice, shed-free
    ESS-floor rejuvenations, alarms answered by rejuvenations, then an
    escalation, and a promotion. The port's rejuvenator replays the JAX
    key flow."""
    D, n = 8, 4
    tmod, jmod = tm.MultinomialHMM(K=2, L=3), jm.MultinomialHMM(K=2, L=3)
    draws = fake_draws(tmod.n_free, D, 3)
    ts = MicroBatchScheduler(tmod, buckets=(4,), history_tail=16, device="cpu")
    js = JScheduler(jmod, buckets=(4,), history_tail=16)
    ts.attach_many([(f"s{i}", PosteriorSnapshot(spec=model_spec(tmod), draws=draws), None)
                    for i in range(n)])
    js.attach_many([(f"s{i}", jreg.PosteriorSnapshot(spec=jreg.model_spec(jmod), draws=draws), None)
                    for i in range(n)])
    tl = AdaptationLadder(ts, forget=forget, ess_floor_frac=floor, device="cpu",
                          source=JaxDraws(21))
    jl = jadapt.AdaptationLadder(js, jax.random.PRNGKey(21), forget=forget, ess_floor_frac=floor)
    rng = np.random.default_rng(8)
    for t in range(24):
        ids = [f"s{i}" for i in range(n)] + (["s1"] if t in (5, 13) else [])
        obs = [{"x": int(v)} for v in rng.integers(0, 3, size=len(ids))]
        for sid, o in zip(ids, obs):
            ts.submit(sid, o)
            js.submit(sid, o)
        rt, rj = ts.flush(), js.flush()
        assert [r.series_id for r in rt] == [r.series_id for r in rj]
        assert tl.observe(rt) == jl.observe(rj)
        if t in (9, 10, 11):
            assert tl.on_alarm("s2") == jl.on_alarm("s2")
        if t == 15:
            tl.on_promoted("s2")
            jl.on_promoted("s2")
        for i in range(n):
            sid = f"s{i}"
            np.testing.assert_allclose(float(W.ess(ts.weight_state_of(sid))),
                                       float(jadapt.ess(js.weight_state_of(sid))),
                                       rtol=1e-5, atol=1e-5)
    st, sj = tl.stanza(), jl.stanza()
    assert set(st) == set(sj)
    key = ("kind", "series", "tick", "reason")
    assert [tuple(e.get(k) for k in key) for e in st["events"]] == \
        [tuple(e.get(k) for k in key) for e in sj["events"]]
    assert st["rejuvenations"] > 0 and st["escalations"] == 1
    for k in ("reweight_ticks", "rejuvenations", "escalations", "floor_breaches"):
        assert st[k] == sj[k], k
    for a, b in zip(st["ess"], sj["ess"]):
        assert a["series"] == b["series"]
        np.testing.assert_allclose(a["ess"], b["ess"], atol=2e-3)  # both rounded to 3 places
    assert tl.rejuvenator.compile_count == 1


def test_public_names_match_the_jax_package():
    assert tadapt.__all__ == jadapt.__all__
    for name in tadapt.__all__:
        assert getattr(tadapt, name).__module__.startswith("hhmm_tpu_torch.adapt")
