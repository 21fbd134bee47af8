"""The PyTorch port's Tayal application (``hhmm_tpu_torch/apps/tayal`` and
``hhmm_tpu_torch/native``) against the JAX package on the same inputs.

Tolerances: zig-zag features (both engines), tick expansions, padding,
integer trade fields and leg states exactly; trading and analytics
floats within 1e-12; the walk-forward results given the same posterior
draws (``fit_batched`` replaced in both packages, in the test only, by
one table of draws keyed by each task's in-sample data): leg top states
identical except at legs where the JAX median's top two bottom states
are within 1e-5 (counted and reported); buy-and-hold and counts equal
on every task, and trades, summaries and run counts equal (floats
within 1e-9) to the JAX ``label_and_trade`` of the port's own leg
states on every task, and to the JAX ``wf_trade``'s on every task whose
leg states agree; the device median reduction equal to ``np.median`` +
``np.argmax`` on the same probabilities.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import hhmm_tpu.apps.tayal.wf as j_wf
import hhmm_tpu_torch.apps.tayal.wf as t_wf
from hhmm_tpu.apps.tayal import analytics as j_an
from hhmm_tpu.apps.tayal import features as j_feat
from hhmm_tpu.apps.tayal import trading as j_tr
from hhmm_tpu.apps.tayal.constants import STATE_BEAR, STATE_BULL
from hhmm_tpu.apps.tayal.pipeline import decode_states as j_decode_states
from hhmm_tpu.apps.tayal.pipeline import label_and_trade as j_label_and_trade
from hhmm_tpu.apps.tayal.simulate import simulate_ticks as j_simulate_ticks
from hhmm_tpu.infer import GibbsConfig as JGibbsConfig
from hhmm_tpu.models import TayalHHMMLite as JTayalLite
from hhmm_tpu.native import zigzag as j_nz
from hhmm_tpu_torch.apps.tayal import analytics as t_an
from hhmm_tpu_torch.apps.tayal import features as t_feat
from hhmm_tpu_torch.apps.tayal import trading as t_tr
from hhmm_tpu_torch.apps.tayal import (
    build_tasks,
    decode_states,
    label_and_trade,
    simulate_ticks,
    wf_trade,
)
from hhmm_tpu_torch.apps.tayal.wf import D_DEC, median_states
from hhmm_tpu_torch.infer import GibbsConfig
from hhmm_tpu_torch.models import TayalHHMMLite
from hhmm_tpu_torch.native import zigzag as t_nz

torch.set_num_threads(1)

FIELDS = ("price", "start", "end", "size_av", "f0", "f1", "f2", "feature", "trend")
NEAR_TIE = 1e-5


def _sim(rng, T):
    """Random tick series (``tests/test_native.py``'s generator)."""
    price = 10 + 0.01 * np.round(np.cumsum(rng.choice([-1, 0, 1], T, p=[0.4, 0.2, 0.4])), 2)
    size = rng.integers(1, 500, T).astype(float)
    t = np.cumsum(rng.exponential(2.0, T))
    return price, size, t


def _assert_zig_equal(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.fixture(scope="module")
def native_available():
    if not t_nz.available():
        pytest.skip("no C++ compiler for the native extractor")
    return True


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------


class TestFeatures:
    def test_native_library_is_built_from_the_ports_source(self, native_available):
        from hhmm_tpu_torch.native import BUILD_DIR, SRC, library_path

        assert SRC.parent.name == "native" and SRC.parent.parent.name == "hhmm_tpu_torch"
        assert library_path().parent == BUILD_DIR and library_path().exists()

    @pytest.mark.parametrize("engine", ["numpy", "native"])
    def test_random_series_match_jax(self, rng, engine, native_available):
        checked = 0
        for _ in range(20):
            T = int(rng.integers(60, 3000))
            p, s, t = _sim(rng, T)
            try:
                want = j_feat.extract_features(p, s, t, engine="numpy")
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    t_feat.extract_features(p, s, t, engine=engine)
                continue
            _assert_zig_equal(t_feat.extract_features(p, s, t, engine=engine), want)
            checked += 1
        assert checked >= 10

    @pytest.mark.parametrize("engine", ["numpy", "native", "auto"])
    @pytest.mark.parametrize("alpha", [0.1, 0.25, 0.6])
    def test_simulated_days_match_jax(self, engine, alpha, native_available):
        got_days = [simulate_ticks(np.random.default_rng(7), n_legs=n) for n in (80, 300)]
        want_days = [j_simulate_ticks(np.random.default_rng(7), n_legs=n) for n in (80, 300)]
        for got, want in zip(got_days, want_days):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            p, s, t, _ = got
            _assert_zig_equal(
                t_feat.extract_features(p, s, t, alpha=alpha, engine=engine),
                j_feat.extract_features(p, s, t, alpha=alpha, engine="numpy"),
            )

    def test_native_counter_counts_series(self, rng, native_available):
        before = t_nz.series_extracted
        p, s, t = _sim(rng, 800)
        t_nz.extract_features_native(p, s, t)
        t_nz.extract_features_batch([(p, s, t)] * 3)
        assert t_nz.series_extracted == before + 4

    def test_batch_matches_jax_with_per_series_errors(self, rng, native_available):
        good = [_sim(rng, int(rng.integers(400, 2500))) for _ in range(5)]
        bad = (np.full(50, 3.0), np.ones(50), np.arange(50.0))
        short = (np.array([1.0, 2.0]), np.ones(2), np.arange(2.0))
        batch = good[:2] + [bad] + good[2:] + [short]
        got = t_nz.extract_features_batch(batch, n_threads=3)
        want = j_nz.extract_features_batch(batch, n_threads=3)
        assert len(got) == len(want) == len(batch)
        for g, w in zip(got, want):
            if isinstance(w, Exception):
                assert type(g) is type(w) and str(g) == str(w)
            else:
                _assert_zig_equal(g, w)
        assert t_nz.extract_features_batch([]) == []

    def test_error_messages_match_jax(self):
        cases = [
            (np.array([1.0, 2.0]), np.ones(2), np.arange(2.0)),
            (np.full(100, 5.0), np.ones(100), np.arange(100.0)),
        ]
        for p, s, t in cases:
            with pytest.raises(ValueError) as want:
                j_feat.extract_features(p, s, t, engine="numpy")
            for engine in ("numpy", "auto"):
                with pytest.raises(ValueError, match=str(want.value)):
                    t_feat.extract_features(p, s, t, engine=engine)
        with pytest.raises(ValueError, match="engine"):
            t_feat.extract_features(*cases[0], engine="fast")

    def test_model_inputs_and_expansions_match_jax(self, rng):
        p, s, t, _ = simulate_ticks(np.random.default_rng(3), n_legs=150)
        # duplicated timestamps: the xts join's pairwise matching
        t = np.floor(t / 3.0)
        zig = t_feat.extract_features(p, s, t, engine="numpy")
        jzig = j_feat.extract_features(p, s, t, engine="numpy")
        for a, b in zip(t_feat.to_model_inputs(zig.feature), j_feat.to_model_inputs(jzig.feature)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        vals = rng.integers(-1, 2, len(zig))
        np.testing.assert_array_equal(
            t_feat.expand_to_ticks(vals, zig, len(p)), j_feat.expand_to_ticks(vals, jzig, len(p))
        )
        np.testing.assert_array_equal(
            t_feat.expand_to_ticks_xts(vals, zig, t), j_feat.expand_to_ticks_xts(vals, jzig, t)
        )


# ---------------------------------------------------------------------------
# trading and analytics
# ---------------------------------------------------------------------------


def _assert_trades_equal(got, want, rtol=1e-12):
    assert got.lag == want.lag
    for f in ("action", "signal", "start", "end"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in ("entry_price", "exit_price", "perchg", "ret"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=rtol, atol=rtol,
                                   err_msg=f)


def _assert_summary_equal(got, want, rtol=1e-12):
    assert set(got) == set(want)
    for regime in want:
        assert set(got[regime]) == set(want[regime])
        for k, w in want[regime].items():
            np.testing.assert_allclose(got[regime][k], w, rtol=rtol, atol=rtol,
                                       err_msg=f"{regime}.{k}")


def _window(seed=5, n_legs=200):
    p, s, t, _ = simulate_ticks(np.random.default_rng(seed), n_legs=n_legs)
    zig = t_feat.extract_features(p, s, t, engine="numpy")
    return p, s, t, zig, j_feat.extract_features(p, s, t, engine="numpy")


class TestTradingAndAnalytics:
    def test_trading_matches_jax(self, rng):
        price = 20 + np.cumsum(rng.normal(0, 0.01, 500))
        top = np.where(rng.random(500) < 0.1, -1, 1)
        top = np.repeat(top[::10], 10)  # runs
        for lag in (0, 1, 3, 700):
            _assert_trades_equal(t_tr.topstate_trading(price, top, lag=lag),
                                 j_tr.topstate_trading(price, top, lag=lag))
        np.testing.assert_allclose(t_tr.buyandhold(price), j_tr.buyandhold(price), rtol=1e-12)
        r = rng.normal(0, 0.01, 300)
        np.testing.assert_allclose(t_tr.equity_curve(r), j_tr.equity_curve(r), rtol=1e-12)

    def test_analytics_match_jax(self, rng):
        p, _, _, zig, jzig = _window()
        state = rng.integers(0, 4, len(zig))
        np.testing.assert_array_equal(t_an.map_to_topstate(state), j_an.map_to_topstate(state))
        with pytest.raises(ValueError, match="not covered"):
            t_an.map_to_topstate(np.array([0, 5]))
        top = t_an.map_to_topstate(state)
        runs = t_an.topstate_runs(top, zig.start, zig.end, p)
        jruns = j_an.topstate_runs(top, jzig.start, jzig.end, p)
        for f in ("topstate", "start", "end", "length"):
            np.testing.assert_array_equal(getattr(runs, f), getattr(jruns, f))
        np.testing.assert_allclose(runs.ret, jruns.ret, rtol=1e-12, atol=1e-12)
        for flip in (False, True):  # both branches of the ex-post relabel
            rr = runs if not flip else t_an.TopRuns(-runs.topstate, runs.start, runs.end,
                                                    runs.length, runs.ret)
            jr = jruns if not flip else j_an.TopRuns(-jruns.topstate, jruns.start, jruns.end,
                                                     jruns.length, jruns.ret)
            got, want = t_an.relabel_by_return(rr, -top if flip else top), \
                j_an.relabel_by_return(jr, -top if flip else top)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[2] == want[2]
        _assert_summary_equal(t_an.topstate_summary(runs), j_an.topstate_summary(jruns))

    @pytest.mark.parametrize("dmax", [1, 2])
    def test_topstate_probs_matches_jax(self, rng, dmax):
        probs = rng.dirichlet(np.ones(4 * dmax), size=(3, 7))
        np.testing.assert_allclose(t_an.topstate_probs(probs, dmax=dmax),
                                   j_an.topstate_probs(probs, dmax=dmax), rtol=1e-12, atol=1e-12)
        if dmax > 1:
            with pytest.raises(ValueError, match="regime width"):
                t_an.topstate_probs(probs[..., : 2 * dmax], dmax=dmax)

    @pytest.mark.parametrize("expansion", ["xts", "positional"])
    def test_label_and_trade_matches_jax(self, rng, expansion):
        p, _, t, zig, jzig = _window(seed=9, n_legs=260)
        state = rng.integers(0, 4, len(zig))
        ins_end = int(zig.end[len(zig) * 3 // 4])
        lags = (0, 1, 2, 5)
        got = label_and_trade(p, zig, state, ins_end, lags, t_seconds=t, expansion=expansion)
        want = j_label_and_trade(p, jzig, state, ins_end, lags, t_seconds=t, expansion=expansion)
        np.testing.assert_array_equal(got.leg_topstate, want.leg_topstate)
        assert got.swapped == want.swapped
        np.testing.assert_allclose(got.bnh, want.bnh, rtol=1e-12)
        assert set(got.trades) == set(want.trades) == set(lags)
        for lag in lags:
            _assert_trades_equal(got.trades[lag], want.trades[lag])
        _assert_summary_equal(got.summary, want.summary)
        np.testing.assert_array_equal(got.runs.length, want.runs.length)


# ---------------------------------------------------------------------------
# the median-alpha decode
# ---------------------------------------------------------------------------


class TestMedianDecode:
    def test_device_reduction_equals_host_median_argmax(self, rng):
        model = TayalHHMMLite(gate_mode="stan")
        G, T, To = 3, 96, 40
        data = {
            "x": torch.as_tensor(rng.integers(0, 9, (G, T))),
            "sign": torch.as_tensor(rng.integers(0, 2, (G, T))),
            "x_oos": torch.as_tensor(rng.integers(0, 9, (G, To))),
            "sign_oos": torch.as_tensor(rng.integers(0, 2, (G, To))),
        }
        samples = torch.as_tensor(rng.normal(size=(G, D_DEC, model.n_free)) * 0.8,
                                  dtype=torch.float32)
        out = model.generated(samples, data, device="cpu")
        filt = model.filtered(samples, data, device="cpu")
        for key in ("alpha", "alpha_oos"):
            assert torch.equal(filt[key], out[key])
            a = out[key].numpy()
            host = np.argmax(np.median(a, axis=1), axis=-1)
            np.testing.assert_array_equal(median_states(out[key]).numpy(), host)

    @pytest.mark.parametrize("D", [4, 5])
    def test_even_median_and_first_maximum(self, D):
        """Even D averages the two middle draws (``torch.median`` would
        take the lower), and a tie goes to the lowest state."""
        rng = np.random.default_rng(D)
        probs = rng.dirichlet(np.ones(4), size=(2, D, 30)).astype(np.float32)
        probs[0, :, 0] = [0.4, 0.4, 0.1, 0.1]  # an exact tie of states 0 and 1
        host = np.argmax(np.median(probs, axis=1), axis=-1)
        got = median_states(torch.as_tensor(probs)).numpy()
        np.testing.assert_array_equal(got, host)
        assert got[0, 0] == 0

    def test_decode_states_matches_jax(self):
        p, _, _, zig, _ = _window(seed=12, n_legs=180)
        x, sign = t_feat.to_model_inputs(zig.feature)
        n_ins = len(x) - 40
        data = {"x": x[:n_ins], "sign": sign[:n_ins], "x_oos": x[n_ins:], "sign_oos": sign[n_ins:]}
        rng = np.random.default_rng(1)
        samples = (rng.normal(size=(1, 60, TayalHHMMLite().n_free)) * 0.5).astype(np.float32)
        got = decode_states(TayalHHMMLite(gate_mode="hard"), samples, data, n_thin=50,
                            device="cpu")
        want = j_decode_states(JTayalLite(gate_mode="hard"), samples, data, n_thin=50)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# wf_trade given the same posterior draws (the ROADMAP A3 gate)
# ---------------------------------------------------------------------------


class _Draws:
    """One table of posterior draws for both packages' ``fit_batched``,
    keyed by each task's in-sample ``(x, sign)``, so the grouping inside
    either ``wf_trade`` does not matter."""

    def __init__(self, tasks, chains, samples, basin_gap, seed=0):
        self.tasks, self.table = tasks, {}
        rng = np.random.default_rng(seed)
        n_free = TayalHHMMLite().n_free
        for task in tasks:
            zig = t_feat.extract_features(task.price, task.size, task.t_seconds, engine="numpy")
            x, sign = t_feat.to_model_inputs(zig.feature)
            n_ins = int((zig.end <= task.ins_end_tick).sum())
            centres = rng.normal(size=(chains, 1, n_free)) * 0.6
            qs = (centres + 0.05 * rng.normal(size=(chains, samples, n_free))).astype(np.float32)
            logp = (-1000.0 + rng.normal(size=(chains, samples))).astype(np.float32)
            logp[1:] -= basin_gap  # chains after the first sit basin_gap nats lower
            div = rng.random((chains, samples)) < 0.05
            self.table[self._key(x[:n_ins], sign[:n_ins])] = (qs, logp, div)

    @staticmethod
    def _key(x, sign):
        return np.asarray(x, np.int32).tobytes() + b"|" + np.asarray(sign, np.int32).tobytes()

    def lookup(self, padded):
        x, sign, mask = (np.asarray(padded[k]) for k in ("x", "sign", "mask"))
        rows = [self.table[self._key(x[b][mask[b] > 0], sign[b][mask[b] > 0])]
                for b in range(x.shape[0])]
        return tuple(np.stack(col) for col in zip(*rows))

    def jax_fit(self, model, padded, key, config, **kw):
        qs, logp, div = self.lookup(padded)
        return qs, {"logp": logp, "diverging": div}

    def torch_fit(self, model, padded, config, **kw):
        qs, logp, div = (torch.as_tensor(a) for a in self.lookup(padded))
        return qs, {"logp": logp, "diverging": div}

    def jax_median_gap(self, task, res, gate_mode, basin_nats=10.0):
        """Per leg, the gap between the JAX median filtered
        probabilities of the two most probable bottom states, over the
        draws the decode used."""
        import jax.numpy as jnp

        zig = j_feat.extract_features(task.price, task.size, task.t_seconds, engine="numpy")
        x, sign = j_feat.to_model_inputs(zig.feature)
        n = res.n_ins_legs
        qs, logp, _ = self.table[self._key(x[:n], sign[:n])]
        lp = logp.mean(-1)
        draws = qs[lp >= lp.max() - basin_nats].reshape(-1, qs.shape[-1])
        sel = np.linspace(0, len(draws) - 1, min(D_DEC, len(draws))).astype(int)
        data = {"x": jnp.asarray(x[:n]), "sign": jnp.asarray(sign[:n]),
                "x_oos": jnp.asarray(x[n:]), "sign_oos": jnp.asarray(sign[n:])}
        out = JTayalLite(gate_mode=gate_mode).generated(jnp.asarray(draws[sel]), data)
        med = np.concatenate([np.median(np.asarray(out["alpha"]), 0),
                              np.median(np.asarray(out["alpha_oos"]), 0)])
        top2 = np.sort(med, axis=-1)[:, -2:]
        return top2[:, 1] - top2[:, 0]


def _jax_trading_of(task, res):
    """The JAX ``label_and_trade`` of ``task`` on ``res``'s own leg
    states, as the JAX ``wf_trade`` reports it: the top states undone
    from their ex-post relabel onto bottom states 0 (bear) and 2 (bull),
    which map back to the same top states. A ``WFResult``-shaped
    namespace of the fields the host trading sets."""
    zig = j_feat.extract_features(task.price, task.size, task.t_seconds, engine="numpy")
    top = res.leg_topstate
    if res.swapped:
        top = np.where(top == STATE_BULL, STATE_BEAR, STATE_BULL)
    lw = j_label_and_trade(task.price, zig, np.where(top == STATE_BULL, 2, 0),
                           task.ins_end_tick, sorted(res.trades), t_seconds=task.t_seconds)
    oos_top = lw.leg_topstate[res.n_ins_legs:]
    return SimpleNamespace(
        leg_topstate=lw.leg_topstate, trades=lw.trades, summary=lw.summary, swapped=lw.swapped,
        oos_leg_switches=int((oos_top[1:] != oos_top[:-1]).sum()),
        run_len_mean=float(np.mean(lw.runs.length)),
        run_len_median=float(np.median(lw.runs.length)))


def _assert_trading_equal(g, w):
    assert g.swapped == w.swapped
    assert g.oos_leg_switches == w.oos_leg_switches
    np.testing.assert_allclose([g.run_len_mean, g.run_len_median],
                               [w.run_len_mean, w.run_len_median], rtol=1e-9)
    assert set(g.trades) == set(w.trades)
    for lag in w.trades:
        _assert_trades_equal(g.trades[lag], w.trades[lag], rtol=1e-9)
    _assert_summary_equal(g.summary, w.summary, rtol=1e-9)


def _compare(got, want, draws, gate_mode):
    """Every task's counts, ``bnh`` and divergences equal; its leg states
    equal except at the JAX median's near-ties; and its trading equal
    both to the JAX ``label_and_trade`` of its own leg states and, when
    no leg differs, to the JAX ``wf_trade``'s."""
    near_ties = 0
    for g, w, task in zip(got, want, draws.tasks):
        assert (g.symbol, g.window) == (w.symbol, w.window)
        assert (g.n_ins_legs, g.n_oos_legs, g.chains_pooled) == \
            (w.n_ins_legs, w.n_oos_legs, w.chains_pooled)
        np.testing.assert_allclose(g.diverged, w.diverged, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(g.bnh, w.bnh, rtol=1e-9, atol=1e-9)
        ref = _jax_trading_of(task, g)
        np.testing.assert_array_equal(g.leg_topstate, ref.leg_topstate)
        _assert_trading_equal(g, ref)
        differ = np.flatnonzero(g.leg_topstate != w.leg_topstate)
        if differ.size:
            gap = draws.jax_median_gap(task, w, gate_mode)
            assert np.all(gap[differ] < NEAR_TIE), (task.symbol, task.window, differ, gap[differ])
            near_ties += differ.size
        else:
            _assert_trading_equal(g, w)
    return near_ties


WF_CASES = {
    "hard_one_chain": ("hard", 1, 120, 0.0),
    "stan_one_chain": ("stan", 1, 120, 0.0),
    "hard_two_chains_basin": ("hard", 2, 120, 25.0),
    "stan_two_chains_basin": ("stan", 2, 120, 25.0),
    "hard_under_filled": ("hard", 1, 30, 0.0),
}


@pytest.mark.parametrize("case", sorted(WF_CASES))
def test_wf_trade_matches_jax_given_the_same_draws(case, tayal_wf_tasks, monkeypatch, capsys):
    gate_mode, chains, samples, basin_gap = WF_CASES[case]
    draws = _Draws(tayal_wf_tasks, chains, samples, basin_gap)
    monkeypatch.setattr(j_wf, "fit_batched", draws.jax_fit)
    monkeypatch.setattr(t_wf, "fit_batched", draws.torch_fit)
    want = j_wf.wf_trade(tayal_wf_tasks, JGibbsConfig(1, samples, chains), gate_mode=gate_mode,
                         chunk_size=3)
    phases = {}
    got = wf_trade(tayal_wf_tasks, GibbsConfig(1, samples, chains), gate_mode=gate_mode,
                   chunk_size=3, phase_timings=phases, device="cpu")
    assert len(got) == len(want) == len(tayal_wf_tasks)
    pooled = {r.chains_pooled for r in got}
    assert pooled == ({1} if basin_gap else {chains})
    full = samples * (1 if basin_gap else chains) >= D_DEC
    assert phases["decode.dispatches"] >= 1 and full == (case != "hard_under_filled")
    assert any(len(set(r.leg_topstate.tolist())) == 2 for r in want)  # both regimes decoded
    near_ties = _compare(got, want, draws, gate_mode)
    with capsys.disabled():
        print(f"\n[{case}] legs differing at JAX near-ties (< {NEAR_TIE}): {near_ties}")


def test_wf_trade_end_to_end_with_cache(tayal_wf_tasks, tmp_path, capsys):
    """Two tasks through the port's own ``fit_batched`` (Gibbs, hard gate,
    10 + 10 sweeps) on the CPU: every phase recorded, valid trades, and a
    second run served from the cache with identical leg states."""
    tasks = tayal_wf_tasks[:2]
    cfg = GibbsConfig(num_warmup=10, num_samples=10, num_chains=1)
    phases = {}
    first = wf_trade(tasks, cfg, gate_mode="hard", chunk_size=2, cache_dir=str(tmp_path),
                     phase_timings=phases, device="cpu")
    assert {"features", "fit", "decode", "host_trading", "decode.select", "decode.prep",
            "decode.first_call", "decode.host_reduce", "decode.cache_io",
            "decode.dispatches", "decode.shapes_pending"} <= set(phases)
    assert all(v >= 0 for v in phases.values()) and phases["decode.dispatches"] == 1
    for r in first:
        assert set(r.trades) == {0, 1, 2, 3, 4, 5}
        assert np.isfinite(r.bnh).all() and r.diverged == 0.0 and r.chains_pooled == 1
    capsys.readouterr()
    again = {}
    second = wf_trade(tasks, cfg, gate_mode="hard", chunk_size=2, cache_dir=str(tmp_path),
                      phase_timings=again, device="cpu")
    assert "cache hit" in capsys.readouterr().err
    assert again["decode.dispatches"] == 0  # every decode read back
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a.leg_topstate, b.leg_topstate)


def test_build_tasks_matches_jax(tayal_wf_tasks):
    """The fixture's tasks (built by the JAX package) rebuilt by the
    port's ``build_tasks`` from the same days."""
    rng = np.random.default_rng(11)
    days = {sym: [dict(zip(("price", "size", "t_seconds"), j_simulate_ticks(rng, n_legs=60)[:3]))
                  for _ in range(4)] for sym in ("AAA", "BBB")}
    got = build_tasks(days, train_days=2, trade_days=1)
    assert len(got) == len(tayal_wf_tasks)
    for g, w in zip(got, tayal_wf_tasks):
        assert (g.symbol, g.window, g.ins_end_tick) == (w.symbol, w.window, w.ins_end_tick)
        for f in ("price", "size", "t_seconds"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
