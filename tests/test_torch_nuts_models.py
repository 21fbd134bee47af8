"""The NUTS path's model side and entry points in the port against the
JAX package on the same numpy inputs.

- ``kernels/grad.py::forward_loglik`` value and gradients against the
  JAX ``forward_loglik`` (the ``tests/test_grad.py`` cases: homogeneous,
  time-varying, ragged mask, ``MASK_NEG``-gated entries, and ``-inf``
  entries in ``log_A``), batched over a leading axis: within rtol 1e-5 /
  atol 1e-5;
- ``make_logp`` against the JAX ``make_logp`` for ``GaussianHMM`` (flat
  and NIG prior) and both Tayal gates, value within 1e-5 relative and
  gradient within 1e-4 absolute plus 1e-5 relative (an f32 sum over T
  terms of a gradient entry up to about 30), on theta ``[B, C,
  n_free]`` with data ``[B, T]``;
- the time-varying ``forward_value_and_grad`` against the JAX entry,
  gated and not; ``make_vg`` of a model whose hot-loop ``log_A`` is
  time-varying against autograd through ``make_logp`` and against the
  JAX ``make_logp`` gradient;
- ``sample`` dispatch (NUTS, ChEES, the ``GibbsConfig`` ``TypeError``)
  and ``init_chains``;
- the ``fit_batched`` NUTS arm (``SamplerConfig()`` its default),
  chunk by chunk bitwise equal to ``sample_nuts_batched`` over the
  chunk's ``make_vg`` with the derived seed, its ragged tail repeat
  padded, and its cache stage;
- a small ``GaussianHMM`` posterior against the JAX ``sample_nuts``
  posterior within 4 combined MCSE (``slow``);
- ``run_window`` and ``wf_trade`` (its default config NUTS) with a tiny
  ``SamplerConfig`` on simulated ticks.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhmm_tpu.core.lmath import MASK_NEG
from hhmm_tpu.infer import SamplerConfig as JSamplerConfig
from hhmm_tpu.infer import sample_nuts as j_sample_nuts
from hhmm_tpu.kernels import forward_loglik as j_forward_loglik
from hhmm_tpu.kernels.vg import forward_value_and_grad as j_fvg
from hhmm_tpu.models import GaussianHMM as JGaussianHMM
from hhmm_tpu.models import NIGPrior as JNIGPrior
from hhmm_tpu.models import TayalHHMM as JTayalHHMM
from hhmm_tpu_torch.apps.tayal import TayalWindowResult, build_tasks, run_window, simulate_ticks
from hhmm_tpu_torch.apps.tayal import wf_trade
from hhmm_tpu_torch.batch import default_init, derive_seed, fit_batched
from hhmm_tpu_torch.batch import fit as fit_module
from hhmm_tpu_torch.infer import (
    ChEESConfig,
    GibbsConfig,
    SamplerConfig,
    ess,
    init_chains,
    sample,
    sample_nuts_batched,
)
from hhmm_tpu_torch.kernels import forward_value_and_grad
from hhmm_tpu_torch.kernels.grad import forward_loglik
from hhmm_tpu_torch.models import GaussianHMM, NIGPrior, TayalHHMM
from hhmm_tpu_torch.sim import tayal_batch

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
LOGP_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5, 1e-4


def _log_norm(a, axis=-1):
    return a - np.log(np.exp(a).sum(axis, keepdims=True))


def _hmm_inputs(rng, B, T, K, time_varying=False):
    shape = (B, T - 1, K, K) if time_varying else (B, K, K)
    return (
        _log_norm(rng.normal(size=(B, K))).astype(np.float32),
        _log_norm(rng.normal(size=shape)).astype(np.float32),
        (rng.normal(size=(B, T, K)) - 1.0).astype(np.float32),
    )


def _torch_vg(log_pi, log_A, log_obs, mask=None):
    args = [torch.as_tensor(a).requires_grad_(True) for a in (log_pi, log_A, log_obs)]
    m = None if mask is None else torch.as_tensor(mask)
    ll = forward_loglik(*args, m)
    grads = torch.autograd.grad(ll.sum(), args)
    return ll.detach().numpy(), [g.numpy() for g in grads]


def _jax_vg(log_pi, log_A, log_obs, mask=None):
    def total(lp, lA, lo):
        if mask is None:
            return jax.vmap(j_forward_loglik)(lp, lA, lo).sum()
        return jax.vmap(j_forward_loglik)(lp, lA, lo, jnp.asarray(mask)).sum()

    args = [jnp.asarray(a) for a in (log_pi, log_A, log_obs)]
    ll = jax.vmap(j_forward_loglik)(*args, *([] if mask is None else [jnp.asarray(mask)]))
    return np.asarray(ll), [np.asarray(g) for g in jax.grad(total, argnums=(0, 1, 2))(*args)]


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    for g, w in zip(got[1], want[1]):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


class TestForwardLoglik:
    @pytest.mark.parametrize("time_varying", [False, True])
    @pytest.mark.parametrize("K", [2, 3, 5])
    def test_value_and_grad_match_jax(self, rng, time_varying, K):
        ins = _hmm_inputs(rng, 3, 17, K, time_varying)
        _assert_close(_torch_vg(*ins), _jax_vg(*ins))

    @pytest.mark.parametrize("time_varying", [False, True])
    def test_masked_matches_jax(self, rng, time_varying):
        B, T, K = 3, 21, 4
        ins = _hmm_inputs(rng, B, T, K, time_varying)
        lengths = np.array([13, 21, 17])
        mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
        got = _torch_vg(*ins, mask)
        _assert_close(got, _jax_vg(*ins, mask))
        for b, n in enumerate(lengths):  # padding steps get exactly zero obs-gradient
            assert np.all(got[1][2][b, n:] == 0.0)

    def test_first_step_masked_matches_jax(self, rng):
        """With ``mask[0] == 0``, the pi cotangent comes from the carry
        (the JAX ``gamma0`` detail)."""
        B, T, K = 2, 12, 3
        ins = _hmm_inputs(rng, B, T, K)
        mask = np.ones((B, T), np.float32)
        mask[:, :3] = 0.0
        got = _torch_vg(*ins, mask)
        _assert_close(got, _jax_vg(*ins, mask))
        assert np.abs(got[1][0]).sum() > 0

    @pytest.mark.parametrize("time_varying", [False, True])
    def test_gated_entries_match_jax(self, rng, time_varying):
        """``MASK_NEG``-gated transitions and emissions (the Tayal hard
        gate) and ``-inf`` transition entries: finite gradients, equal
        to the JAX package's."""
        B, T, K = 2, 15, 4
        log_pi, log_A, log_obs = _hmm_inputs(rng, B, T, K, time_varying)
        log_A[..., 0, 3] = MASK_NEG
        log_A[..., 2, 1] = -np.inf
        log_obs = np.where(rng.random((B, T, K)) < 0.3, MASK_NEG, log_obs).astype(np.float32)
        _assert_close(_torch_vg(log_pi, log_A, log_obs), _jax_vg(log_pi, log_A, log_obs))

    def test_leading_axes_and_broadcast(self, rng):
        """``[B, C, T, K]`` emissions with ``[B, C, ...]`` terms: the
        same values as the flat batch."""
        log_pi, log_A, log_obs = _hmm_inputs(rng, 6, 9, 3)
        flat = _torch_vg(log_pi, log_A, log_obs)[0]
        shaped = forward_loglik(*(torch.as_tensor(a).reshape((2, 3) + a.shape[1:])
                                  for a in (log_pi, log_A, log_obs)))
        np.testing.assert_array_equal(shaped.reshape(-1).numpy(), flat)


def _jax_logp_vg(jmodel, data, theta):
    """JAX ``make_logp`` value and gradient at ``theta [B, C, n]`` with
    data ``[B, T]``."""
    def one(d, th):
        return jax.value_and_grad(jmodel.make_logp(d))(th)

    inner = jax.vmap(one, in_axes=(None, 0))
    lp, g = jax.vmap(inner)({k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(theta))
    return np.asarray(lp), np.asarray(g)


def _port_logp_vg(model, data, theta):
    th = torch.as_tensor(theta).requires_grad_(True)
    lp = model.make_logp({k: torch.as_tensor(v) for k, v in data.items()})(th)
    (g,) = torch.autograd.grad(lp.sum(), th)
    return lp.detach().numpy(), g.numpy()


def _gaussian_data(rng, B, T):
    z = (rng.random((B, T)) < 0.4).astype(int)
    return {"x": (np.where(z, 2.0, 1.0) + 0.3 * rng.normal(size=(B, T))).astype(np.float32)}


class TestMakeLogp:
    @pytest.mark.parametrize("prior", [False, True])
    def test_gaussian_matches_jax(self, rng, prior):
        B, C, T = 2, 3, 40
        data = _gaussian_data(rng, B, T)
        pr = dict(m0=1.5, kappa0=0.2, a0=2.5, b0=1.5)
        model = GaussianHMM(2, nig_prior=NIGPrior(**pr) if prior else None)
        jmodel = JGaussianHMM(2, nig_prior=JNIGPrior(**pr) if prior else None)
        theta = (0.3 * rng.normal(size=(B, C, model.n_free))).astype(np.float32)
        got, want = _port_logp_vg(model, data, theta), _jax_logp_vg(jmodel, data, theta)
        np.testing.assert_allclose(got[0], want[0], rtol=LOGP_RTOL)
        np.testing.assert_allclose(got[1], want[1], rtol=GRAD_RTOL, atol=GRAD_ATOL)

    @pytest.mark.parametrize("gate_mode", ["stan", "hard"])
    def test_tayal_matches_jax(self, gate_mode):
        B, C, T = 2, 2, 48
        x, sign = tayal_batch(B, T, seed=4, device="cpu")
        data = {"x": x.numpy(), "sign": sign.numpy()}
        model = TayalHHMM(gate_mode=gate_mode)
        theta = default_init(model, data, B, C, seed=2, device="cpu").numpy()
        got = _port_logp_vg(model, data, theta)
        want = _jax_logp_vg(JTayalHHMM(gate_mode=gate_mode), data, theta)
        np.testing.assert_allclose(got[0], want[0], rtol=LOGP_RTOL)
        np.testing.assert_allclose(got[1], want[1], rtol=GRAD_RTOL, atol=GRAD_ATOL)

    @pytest.mark.parametrize("gate_mode", ["stan", "hard"])
    def test_make_vg_equals_make_logp_gradient(self, gate_mode):
        """The fused hot loop and autograd through ``make_logp`` are one
        density: the Tayal stan gate's time-varying ``log_A`` (scans) and
        its gate-key form (the kernel pair's plain versions)."""
        x, sign = tayal_batch(3, 64, seed=6, device="cpu")
        data = {"x": x, "sign": sign}
        model = TayalHHMM(gate_mode=gate_mode)
        theta = default_init(model, data, 3, 2, seed=1, device="cpu")
        lp_v, g_v = model.make_vg(data)(theta)
        lp_l, g_l = _port_logp_vg(model, data, theta.numpy())
        np.testing.assert_allclose(lp_v.numpy(), lp_l, rtol=LOGP_RTOL)
        np.testing.assert_allclose(g_v.numpy(), g_l, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _vg_args(rng, N, T, K, gated):
    log_pi, log_A, log_obs = _hmm_inputs(rng, N, T, K, time_varying=True)
    lengths = rng.integers(T // 2, T + 1, size=N)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    args = [log_pi, log_A, log_obs, mask]
    if gated:
        args += [rng.integers(0, 2, size=(N, T)).astype(np.float32),
                 np.tile(np.resize([1.0, 0.0, 0.0, 1.0], K).astype(np.float32), (N, 1))]
    return args


class TestTimeVaryingValueAndGrad:
    @pytest.mark.parametrize("gated", [False, True])
    @pytest.mark.parametrize("K", [2, 4])
    def test_matches_jax_entry(self, rng, gated, K):
        args = _vg_args(rng, 3, 24, K, gated)
        got = forward_value_and_grad(*(torch.as_tensor(a) for a in args))
        want = jax.vmap(j_fvg)(*(jnp.asarray(a) for a in args))
        assert tuple(got[2].shape) == args[1].shape  # d_A per slice
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=RTOL)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)

    def test_gate_keys_come_together(self, rng):
        args = _vg_args(rng, 2, 8, 4, True)
        with pytest.raises(ValueError, match="together"):
            forward_value_and_grad(*(torch.as_tensor(a) for a in args[:5]))

    def test_make_vg_passes_a_time_varying_log_A(self):
        """A model whose hot-loop build keeps the time-varying ``log_A``
        (as an input-driven model's does) runs ``make_vg`` unchanged:
        equal to autograd through ``make_logp`` and to the JAX
        ``make_logp`` gradient."""

        class TimeVaryingTayal(TayalHHMM):
            def build_vg(self, params, data):
                return self.build(params, data)

            def gate_keys(self, data):
                return None

        B, C, T = 2, 2, 40
        x, sign = tayal_batch(B, T, seed=8, device="cpu")
        data = {"x": x.numpy(), "sign": sign.numpy()}
        model = TimeVaryingTayal()
        theta = default_init(model, data, B, C, seed=3, device="cpu").numpy()
        lp_v, g_v = model.make_vg({k: torch.as_tensor(v) for k, v in data.items()})(
            torch.as_tensor(theta))
        lp_l, g_l = _port_logp_vg(model, data, theta)
        np.testing.assert_allclose(lp_v.numpy(), lp_l, rtol=LOGP_RTOL)
        np.testing.assert_allclose(g_v.numpy(), g_l, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        want = _jax_logp_vg(JTayalHHMM(), data, theta)
        np.testing.assert_allclose(g_v.numpy(), want[1], rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _std_normal(q):
    return -0.5 * (q * q).sum(-1)


class TestEntryPoints:
    def test_sample_dispatches_on_the_config(self):
        q0 = torch.zeros(2, 3)
        _, nuts = sample(_std_normal, q0, SamplerConfig(6, 4, num_chains=2), seed=1,
                         device="cpu")
        assert "depth" in nuts and tuple(nuts["depth"].shape) == (2, 4)
        _, chees = sample(_std_normal, q0, ChEESConfig(6, 4, num_chains=2), seed=1,
                          device="cpu")
        assert "traj_length" in chees and "depth" not in chees

    def test_sample_refuses_gibbs(self):
        with pytest.raises(TypeError, match="density-based"):
            sample(_std_normal, torch.zeros(3), GibbsConfig(2, 2), device="cpu")

    def test_sample_needs_a_density(self):
        with pytest.raises(ValueError, match="need logp_fn or vg_fn"):
            sample(None, torch.zeros(3), SamplerConfig(2, 2), device="cpu")

    def test_vg_fn_takes_precedence_and_is_seeded(self):
        calls = []

        def vg(q):
            calls.append(q.shape)
            return _std_normal(q), -q

        a = sample(lambda q: pytest.fail("logp_fn ran"), torch.zeros(3),
                   SamplerConfig(5, 5, num_chains=2), seed=4, device="cpu", vg_fn=vg)
        b = sample(None, torch.zeros(3), SamplerConfig(5, 5, num_chains=2), seed=4,
                   device="cpu", vg_fn=vg)
        assert torch.equal(a[0], b[0])
        assert all(s == (2, 3) for s in calls)  # every chain one lane of each call

    def test_init_chains(self):
        x, sign = tayal_batch(1, 50, seed=0, device="cpu")
        data = {"x": x[0], "sign": sign[0]}
        model = TayalHHMM()
        a = init_chains(model, data, 3, seed=5, device="cpu")
        assert tuple(a.shape) == (3, model.n_free)
        assert torch.equal(a, init_chains(model, data, 3, seed=5, device="cpu"))
        assert not torch.equal(a[0], a[1])  # dispersed


NUTS_SMALL = SamplerConfig(num_warmup=6, num_samples=4, num_chains=2, max_treedepth=4)


def _tayal_ragged(B, T):
    x, sign = tayal_batch(B, T, seed=2, device="cpu")
    mask = np.ones((B, T), np.float32)
    for b in range(B):
        mask[b, T - 5 * b:] = 0.0
    return {"x": x.numpy(), "sign": sign.numpy(), "mask": mask}


class TestFitBatchedNuts:
    def test_default_config_is_nuts(self):
        assert inspect.signature(fit_batched).parameters["config"].default == SamplerConfig()

    def test_chunks_are_sample_nuts_batched_with_the_derived_seed(self):
        B, T, chunk = 3, 40, 2
        data = _tayal_ragged(B, T)
        model = TayalHHMM()
        qs, stats = fit_batched(model, data, NUTS_SMALL, chunk_size=chunk, seed=7, device="cpu")
        assert tuple(qs.shape) == (B, 2, 4, model.n_free)
        assert all(v.shape[0] == B for v in stats.values())
        init = default_init(model, data, B, 2, seed=7, device="cpu")
        tdata = {k: torch.as_tensor(v) for k, v in data.items()}
        first = sample_nuts_batched(model.make_vg({k: v[:2] for k, v in tdata.items()}),
                                    init[:2], NUTS_SMALL, seed=derive_seed(7, 0), device="cpu")
        # the ragged last chunk: series 2 and a repeat of it
        last = {k: v[2:3].repeat(2, 1) for k, v in tdata.items()}
        tail = sample_nuts_batched(model.make_vg(last), init[2:3].repeat(2, 1, 1), NUTS_SMALL,
                                   seed=derive_seed(7, 2), device="cpu")
        assert torch.equal(qs[:2], first[0]) and torch.equal(qs[2], tail[0][0])
        for k in stats:
            assert torch.equal(stats[k][:2], first[1][k]), k
            assert torch.equal(stats[k][2], tail[1][k][0]), k

    def test_one_value_and_grad_call_over_the_chunk_a_leapfrog(self, monkeypatch):
        B, T = 2, 32
        data = _tayal_ragged(B, T)
        calls = []
        model = TayalHHMM()
        make_vg = model.make_vg

        def counted(chunk_data):
            fn = make_vg(chunk_data)

            def vg(q):
                calls.append(tuple(q.shape))
                return fn(q)

            return vg

        monkeypatch.setattr(model, "make_vg", counted)
        _, stats = fit_batched(model, data, NUTS_SMALL, chunk_size=B, seed=1, device="cpu")
        # the initial call, the step-size probes, then the lockstep leapfrogs
        leapfrogs = int(stats["lockstep_leapfrogs"][0].sum())
        assert len(calls) > 1 + leapfrogs and set(calls) == {(B, 2, model.n_free)}

    def test_cache_stage_and_hit(self, tmp_path, capsys):
        data = _tayal_ragged(2, 32)
        model = TayalHHMM()
        a = fit_batched(model, data, NUTS_SMALL, chunk_size=2, cache_dir=str(tmp_path), seed=3,
                        device="cpu")
        capsys.readouterr()
        b = fit_batched(model, data, NUTS_SMALL, chunk_size=2, cache_dir=str(tmp_path), seed=3,
                        device="cpu")
        assert capsys.readouterr().err.count("cache hit") == 1
        assert torch.equal(a[0], b[0])
        for k in a[1]:
            assert torch.equal(a[1][k], b[1][k]), k

    def test_stage_names_the_sampler(self, monkeypatch, tmp_path):
        stages = []
        real = fit_module.digest_key

        def spy(*parts):
            stages.extend(p for p in parts if isinstance(p, str))
            return real(*parts)

        monkeypatch.setattr(fit_module, "digest_key", spy)
        fit_batched(TayalHHMM(), _tayal_ragged(1, 24), NUTS_SMALL, cache_dir=str(tmp_path),
                    device="cpu")
        assert "sampler=nuts-vg-torch-v2-cpu" in stages


def _mcse(draws):
    mean = draws.mean((0, 1))
    se = np.array([draws[..., p].std(ddof=1) / np.sqrt(max(ess(draws[..., p]), 1.0))
                   for p in range(draws.shape[-1])])
    return mean, se


@pytest.mark.slow
def test_gaussian_posterior_agrees_with_jax():
    """``GaussianHMM(K=2)`` with a proper NIG prior on T=60 steps of
    `hmm/main.R`'s chain (A = [[.8, .2], [.35, .65]], means 1 and 2
    here, sigma 0.3): the port's and the JAX ``sample_nuts`` posterior
    means of every constrained scalar within 4 combined MCSE. (Under the
    flat prior a chain can leave for the improper region where one state
    owns no step and its mean runs off, as a JAX chain did on a first
    try of this test.)"""
    rng = np.random.default_rng(42)
    T = 60
    z = [0]
    for _ in range(T - 1):
        z.append(int(rng.random() < (0.2, 0.65)[z[-1]]))
    x = (np.where(np.array(z), 2.0, 1.0) + 0.3 * rng.normal(size=T)).astype(np.float32)
    pr = dict(m0=1.5, kappa0=0.2, a0=2.5, b0=0.5)
    model, jmodel = GaussianHMM(2, NIGPrior(**pr)), JGaussianHMM(2, JNIGPrior(**pr))
    init = init_chains(model, {"x": x}, 2, seed=1, device="cpu")
    W, S = 100, 200
    qs, st = sample(model.make_logp({"x": torch.as_tensor(x)}), init,
                    SamplerConfig(W, S, num_chains=2), seed=0, device="cpu")
    jqs, _ = j_sample_nuts(jmodel.make_logp({"x": jnp.asarray(x)}), jax.random.PRNGKey(0),
                           jnp.asarray(init.numpy()), JSamplerConfig(W, S, num_chains=2))
    assert float(st["diverging"].float().mean()) < 0.05
    post = model.constrained_draws(qs)
    jpost = jax.vmap(jax.vmap(lambda q: jmodel.unpack(q)[0]))(jqs)
    keys = ("p_1k", "A_ij", "mu_k", "sigma_k")
    mt = np.concatenate([post[k].reshape(2, S, -1).numpy() for k in keys], -1)
    mj = np.concatenate([np.asarray(jpost[k]).reshape(2, S, -1) for k in keys], -1)
    (m_t, se_t), (m_j, se_j) = _mcse(mt), _mcse(mj)
    assert np.all(np.abs(m_t - m_j) <= 4 * np.sqrt(se_t**2 + se_j**2))


def _ticks(seed, days=3, n_legs=60):
    rng = np.random.default_rng(seed)
    return {
        sym: [dict(zip(("price", "size", "t_seconds"), simulate_ticks(rng, n_legs=n_legs)[:3]))
              for _ in range(days)]
        for sym in ("AAA", "BBB")
    }


TINY_NUTS = SamplerConfig(num_warmup=3, num_samples=3, num_chains=1, max_treedepth=3)


def test_run_window_on_simulated_ticks():
    p, s, t, _ = simulate_ticks(np.random.default_rng(5), n_legs=120)
    res = run_window(p, s, t, ins_end_tick=int(0.7 * len(p)), config=TINY_NUTS, seed=2,
                     device="cpu")
    assert isinstance(res, TayalWindowResult)
    assert res.samples.shape == (1, 3, TayalHHMM().n_free)
    assert res.stats["chain_healthy"].all()
    assert len(res.leg_state) == len(res.zig) and set(res.trades) == set(range(6))
    assert np.isfinite(res.bnh).all()
    # seeded: the same call, the same draws
    again = run_window(p, s, t, ins_end_tick=int(0.7 * len(p)), config=TINY_NUTS, seed=2,
                       device="cpu")
    np.testing.assert_array_equal(res.samples, again.samples)


def test_run_window_defaults_follow_jax():
    params = inspect.signature(run_window).parameters
    assert params["config"].default == SamplerConfig(250, 250, 1)
    assert params["gate_mode"].default == "stan" and params["alpha"].default == 0.25


def test_wf_trade_runs_nuts_by_default():
    assert inspect.signature(wf_trade).parameters["config"].default == SamplerConfig(250, 250, 1)
    tasks = build_tasks(_ticks(3), train_days=2, trade_days=1)
    timings = {}
    res = wf_trade(tasks, TINY_NUTS, chunk_size=2, phase_timings=timings, seed=1, device="cpu")
    assert len(res) == len(tasks) == 2
    for r in res:
        assert set(r.trades) == set(range(6)) and np.isfinite(r.bnh).all()
        assert len(r.leg_topstate) == r.n_ins_legs + r.n_oos_legs
        assert 0.0 <= r.diverged <= 1.0
    assert timings["fit"] >= 0.0 and timings["decode.dispatches"] >= 1
