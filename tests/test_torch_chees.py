"""The port's ChEES-HMC (`hhmm_tpu_torch.infer.chees`) and its warmup
machinery (`infer/run.py`, `infer/nuts.py`) against the JAX package.

- ``halton_base2``, ``warmup_schedule``, the dual-averaging and Welford
  updates equal the JAX functions on the same inputs (within f32
  rounding);
- ``guard_update`` freezes a non-finite lane for good, as the JAX guard
  does;
- the exact-moment test of ``tests/test_chees.py`` (correlated 4-D
  Gaussian) on the port's sampler;
- a small stan-gate Tayal run through ``make_lp_bc`` and through the
  fused trajectory's plain version;
- posterior means of a small stan-gate Tayal fit agree with the JAX
  ChEES fit on the same data and inits within Monte Carlo error
  (``slow``: two full samplers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhmm_tpu.infer import ChEESConfig as JChEESConfig
from hhmm_tpu.infer import make_lp_bc as j_make_lp_bc
from hhmm_tpu.infer import sample_chees_batched as j_sample_chees_batched
from hhmm_tpu.infer.chees import halton_base2 as j_halton
from hhmm_tpu.infer.run import _da_init as j_da_init
from hhmm_tpu.infer.run import _da_update as j_da_update
from hhmm_tpu.infer.run import _welford_init as j_welford_init
from hhmm_tpu.infer.run import _welford_update as j_welford_update
from hhmm_tpu.infer.run import _welford_variance as j_welford_variance
from hhmm_tpu.infer.run import warmup_schedule as j_warmup_schedule
from hhmm_tpu.models import TayalHHMM as JTayalHHMM
from hhmm_tpu.robust.guards import guard_update as j_guard_update
from hhmm_tpu_torch.batch import default_init
from hhmm_tpu_torch.infer import (
    ChEESConfig,
    find_reasonable_step_size,
    halton_base2,
    make_lp_bc,
    sample_chees,
    sample_chees_batched,
    warmup_schedule,
)
from hhmm_tpu_torch.infer.run import _da_init, _da_update, _Welford, _welford_update, _welford_variance
from hhmm_tpu_torch.kernels import make_tayal_trajectory
from hhmm_tpu_torch.models import TayalHHMM
from hhmm_tpu_torch.robust import guard_update
from hhmm_tpu_torch.sim import tayal_batch

torch.set_num_threads(1)


class TestAdaptationPieces:
    @pytest.mark.parametrize("n", [1, 7, 300])
    def test_halton(self, n):
        np.testing.assert_array_equal(halton_base2(n), j_halton(n))

    @pytest.mark.parametrize("num_warmup", [10, 50, 149, 150, 300, 1000])
    def test_warmup_schedule(self, num_warmup):
        upd, end = warmup_schedule(num_warmup)
        jupd, jend = j_warmup_schedule(num_warmup)
        np.testing.assert_array_equal(upd, np.asarray(jupd))
        np.testing.assert_array_equal(end, np.asarray(jend))

    def test_dual_averaging(self, rng):
        acc = rng.random(40).astype(np.float32)
        s = _da_init(torch.tensor(0.1))
        js = j_da_init(jnp.float32(0.1))
        for a in acc:
            s = _da_update(s, torch.tensor(a), 0.651)
            js = j_da_update(js, jnp.float32(a), 0.651)
            for got, want in zip(s, js):
                np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)

    def test_welford(self, rng):
        xs = rng.normal(size=(30, 5)).astype(np.float32) * 3.0 + 1.0
        s = _Welford(torch.zeros(()), torch.zeros(5), torch.zeros(5))
        js = j_welford_init(5, jnp.float32)
        for x in xs:
            s = _welford_update(s, torch.from_numpy(x))
            js = j_welford_update(js, jnp.asarray(x))
        for got, want in zip(s, js):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)
        np.testing.assert_allclose(
            _welford_variance(s).numpy(), np.asarray(j_welford_variance(js)), rtol=1e-5
        )

    def test_guard_update(self, rng):
        new = rng.normal(size=(3, 2, 4)).astype(np.float32)
        new[1, 0, 2] = np.nan
        old = np.zeros((3, 2, 4), np.float32)
        healthy = np.array([[True, True], [True, True], [False, True]])
        (st,), ok = guard_update(torch.from_numpy(healthy), (torch.from_numpy(new),),
                                 (torch.from_numpy(old),), batch_ndim=2)
        (jst,), jok = j_guard_update(jnp.asarray(healthy), (jnp.asarray(new),),
                                     (jnp.asarray(old),), batch_ndim=2)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(st.numpy(), np.asarray(jst))

    def test_find_reasonable_step_size_crosses_half(self):
        """Stan's heuristic: the returned eps is init * 2^k and the
        one-step accept probability crosses 0.5 between eps and the
        previous probe."""

        def vg(q):
            return -0.5 * (q * q * 25.0).sum(-1), -25.0 * q

        q = torch.tensor([0.3, -0.2, 0.1])
        lp, g = vg(q)
        gen = torch.Generator().manual_seed(0)
        eps = float(find_reasonable_step_size(vg, torch.ones(3), q, lp, g, gen, 1.0))
        k = np.log2(eps)
        assert k == round(k) and eps < 1.0


class TestGaussianTarget:
    def test_moments_correlated_gaussian(self):
        """The exact-moment test of tests/test_chees.py on the port."""
        rng = np.random.default_rng(0)
        L = np.tril(rng.normal(size=(4, 4)) * 0.5) + np.eye(4)
        cov = L @ L.T
        prec = torch.tensor(np.linalg.inv(cov), dtype=torch.float32)
        mu = torch.tensor([1.0, -2.0, 0.5, 3.0])

        def logp(q):
            d = q - mu
            return -0.5 * ((d @ prec) * d).sum(-1)

        cfg = ChEESConfig(num_warmup=300, num_samples=500, num_chains=8)
        init = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 4)) * 2.0).float()
        qs, stats = sample_chees(logp, init, cfg, seed=0, device="cpu")
        s = qs.reshape(-1, 4).numpy()
        np.testing.assert_allclose(s.mean(0), mu.numpy(), atol=0.15)
        np.testing.assert_allclose(np.cov(s.T), cov, atol=0.35)
        assert float(stats["diverging"].float().mean()) == 0.0
        traj, eps = float(stats["traj_length"]), float(stats["step_size"])
        assert traj != pytest.approx(cfg.init_traj_length)
        assert traj <= eps * cfg.max_leapfrogs + 1e-6

    def test_requires_two_chains(self):
        with pytest.raises(ValueError, match=">=2 chains"):
            sample_chees(lambda q: -0.5 * (q * q).sum(-1), torch.zeros(1, 2),
                         ChEESConfig(num_chains=1), device="cpu")

    def test_trajectory_cap_must_cover_max_leapfrogs(self):
        def traj(*a):
            raise AssertionError("not reached")

        traj.cap = 4
        with pytest.raises(ValueError, match="caps leapfrogs"):
            sample_chees_batched(lambda q: None, torch.zeros(1, 2, 3),
                                 ChEESConfig(num_chains=2, max_leapfrogs=8), device="cpu",
                                 trajectory_fn=traj)


def _tayal_run(B, C, T, W, S, cap, fused, seed=4):
    x, sign = tayal_batch(B, T, seed=11, device="cpu")
    data = {"x": x, "sign": sign}
    model = TayalHHMM()
    init = default_init(model, data, B, C, seed=3, device="cpu")
    cfg = ChEESConfig(num_warmup=W, num_samples=S, num_chains=C, max_leapfrogs=cap)
    traj = make_tayal_trajectory(data, cap=cap, device="cpu") if fused else None
    qs, st = sample_chees_batched(
        make_lp_bc(model, data, device="cpu"), init, cfg, seed=seed, device="cpu",
        probe_vg=model.make_vg({"x": x[0], "sign": sign[0]}), trajectory_fn=traj,
    )
    return data, init, cfg, qs, st


class TestTayal:
    @pytest.mark.parametrize("fused", [False, True])
    def test_small_fit_runs_healthy(self, fused):
        B, C, W, S, cap = 2, 2, 20, 20, 4
        _, _, _, qs, st = _tayal_run(B, C, 24, W, S, cap, fused)
        assert qs.shape == (B, C, S, 35)
        assert bool(st["chain_healthy"].all())
        assert bool(torch.isfinite(st["logp"]).all()) and bool(torch.isfinite(qs).all())
        assert st["num_leaves"].shape == (B, C, S) and st["warmup_num_leaves"].shape == (B, W)
        assert int(st["num_leaves"].max()) <= cap and int(st["num_leaves"].min()) >= 1
        for k in ("accept_prob", "diverging", "logp"):
            assert st[k].shape == (B, C, S)
        assert st["step_size"].shape == (B, C) and st["inv_mass"].shape == (B, 35)

    @pytest.mark.slow
    def test_posterior_means_agree_with_jax(self):
        B, C, T, W, S, cap = 3, 2, 64, 100, 100, 8
        data, init, cfg, qs, st = _tayal_run(B, C, T, W, S, cap, fused=False)
        jm = JTayalHHMM()
        jd = {k: jnp.asarray(v.numpy()) for k, v in data.items()}
        jcfg = JChEESConfig(num_warmup=W, num_samples=S, num_chains=C, max_leapfrogs=cap)
        jqs, jst = j_sample_chees_batched(
            j_make_lp_bc(jm, jd), jax.random.PRNGKey(4), jnp.asarray(init.numpy()), jcfg,
            probe_vg=jm.make_vg({"x": jd["x"][0], "sign": jd["sign"][0]}),
        )
        assert not bool(st["diverging"].any()) and not bool(np.asarray(jst["diverging"]).any())
        m = qs.reshape(B, -1, 35).mean(1).numpy()
        jq = np.asarray(jqs).reshape(B, -1, 35)
        # within Monte Carlo error: 5 sd over sqrt(an effective 20 draws),
        # as tests/test_pallas_traj.py gates fused against unfused
        np.testing.assert_array_less(np.abs(m - jq.mean(1)), 5.0 * jq.std(1) / np.sqrt(20.0) + 0.25)
