"""The port's explicit-duration HSMMs (`hhmm_tpu_torch/kernels/
duration.py`, `models/hsmm.py`, `sim/hmm.py::hsmm_sim`) against the JAX
package on the same numpy inputs, models carried across by
``convert.model_from_jax``:

- the count-down expansions bitwise at Dmax in {1, 3, 6} over lanes (with
  ``-inf`` duration cells), the collapses within 1e-6;
- ``build`` and the log-likelihood of both models within rtol 1e-5,
  ``make_vg``'s value and gradient too (the ``FWD`` + ``VG_BWD`` plain
  pair against the JAX fused entry);
- ``_hsmm_counts`` exactly, given the same expanded paths and masks;
- the Dmax = 1 contract: ``GaussianHSMM(K=3, Dmax=1)`` is the port's
  ``GaussianHMM`` bit for bit in ``build``, the filter's log-likelihood,
  the smoothed posteriors and the FFBS draws given the same generator;
- the ragged-mask and forbidden-duration cases of ``tests/test_hsmm.py``;
- ``hsmm_sim``'s completed dwells against ``dur`` (chi-square, p > 1e-3);
- (slow) a short Gibbs fit per model: posterior means within
  4·sqrt(mcse_port² + mcse_jax²) of the JAX Gibbs fit's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from hhmm_tpu.batch import default_init as j_default_init
from hhmm_tpu.infer import GibbsConfig as JGibbsConfig
from hhmm_tpu.infer import sample_gibbs as j_sample_gibbs
from hhmm_tpu.infer.diagnostics import ess as j_ess
from hhmm_tpu.kernels import duration as jd
from hhmm_tpu.models import GaussianHSMM as JGaussianHSMM
from hhmm_tpu.models import MultinomialHSMM as JMultinomialHSMM
from hhmm_tpu.models import NIGPrior as JNIGPrior
from hhmm_tpu_torch.convert import model_from_jax
from hhmm_tpu_torch.core.lmath import safe_log
from hhmm_tpu_torch.infer import GibbsConfig, sample_gibbs
from hhmm_tpu_torch.kernels import duration as td
from hhmm_tpu_torch.kernels.dispatch import (
    ffbs_dispatch,
    forward_filter_dispatch,
    smooth_dispatch,
)
from hhmm_tpu_torch.models import GaussianHMM, GaussianHSMM
from hhmm_tpu_torch.sim import hsmm_sim, obsmodel_gaussian

torch.set_num_threads(1)

PRIOR = dict(m0=0.0, kappa0=0.1, a0=2.0, b0=1.0)
RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL = 1e-5  # gradient entries near 0 (tests/test_torch_vg.py's D_ATOL)
# tests/test_hsmm.py's recovery configuration
A_ALT = np.array([[0.0, 1.0], [1.0, 0.0]])
DUR = np.array([[0.0, 0.0, 0.1, 0.3, 0.4, 0.2], [0.0, 0.1, 0.4, 0.4, 0.1, 0.0]])


def _log_dirichlet(rng, shape):
    return np.log(rng.dirichlet(np.ones(shape[-1]), size=shape[:-1])).astype(np.float32)


def _models(kind):
    if kind == "gaussian":
        jm = JGaussianHSMM(K=2, Dmax=4, nig_prior=JNIGPrior(**PRIOR), sticky_kappa=1.5)
    else:
        jm = JMultinomialHSMM(K=3, Dmax=3, L=4, sticky_kappa=0.5)
    return model_from_jax(jm), jm


def _data(rng, kind, B, T):
    """``{"x": [B, T], "mask": [B, T]}`` numpy, ragged prefix masks."""
    if kind == "gaussian":
        x = (rng.normal(size=(B, T)) + np.where(rng.random((B, T)) < 0.5, -1.0, 1.0))
        x = x.astype(np.float32)
    else:
        x = rng.integers(0, 4, size=(B, T)).astype(np.int32)
    lengths = rng.integers(T // 2, T + 1, size=B)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return {"x": x, "mask": mask}


def _jdata(data, b):
    return {k: jnp.asarray(v[b]) for k, v in data.items()}


def _tdata(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


@pytest.mark.parametrize("Dmax", [1, 3, 6])
def test_expansions_match_jax_bitwise(rng, Dmax):
    K, N, T = 3, 4, 7
    log_A = _log_dirichlet(rng, (N, K, K))
    log_pi = _log_dirichlet(rng, (N, K))
    log_dur = np.zeros((N, K, 1), np.float32) if Dmax == 1 else _log_dirichlet(rng, (N, K, Dmax))
    if Dmax > 1:
        log_dur[:, 0, 0] = -np.inf  # regime 0 forbids a dwell of 1
    log_obs = rng.normal(size=(N, T, K)).astype(np.float32)
    got = {
        "A": td.expand_transition(torch.from_numpy(log_A), torch.from_numpy(log_dur)),
        "pi": td.expand_initial(torch.from_numpy(log_pi), torch.from_numpy(log_dur)),
        "obs": td.expand_obs(torch.from_numpy(log_obs), Dmax),
    }
    assert got["A"].shape == (N, K * Dmax, K * Dmax)
    for n in range(N):
        want = {
            "A": jd.expand_transition(jnp.asarray(log_A[n]), jnp.asarray(log_dur[n])),
            "pi": jd.expand_initial(jnp.asarray(log_pi[n]), jnp.asarray(log_dur[n])),
            "obs": jd.expand_obs(jnp.asarray(log_obs[n]), Dmax),
        }
        for k in got:
            np.testing.assert_array_equal(got[k][n].numpy(), np.asarray(want[k]), err_msg=k)
    post = rng.dirichlet(np.ones(K * Dmax), size=(N, T)).astype(np.float32)
    lpost = np.log(post)
    np.testing.assert_allclose(td.collapse_probs(post, Dmax), np.asarray(jd.collapse_probs(post, Dmax)),
                               rtol=1e-6)
    np.testing.assert_allclose(td.collapse_probs(torch.from_numpy(post), Dmax).numpy(),
                               np.asarray(jd.collapse_probs(jnp.asarray(post), Dmax)), rtol=1e-6)
    np.testing.assert_allclose(
        td.regime_log_marginals(torch.from_numpy(lpost), Dmax).numpy(),
        np.asarray(jd.regime_log_marginals(jnp.asarray(lpost), Dmax)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        td.duration_posterior(torch.from_numpy(lpost), Dmax).numpy(),
        np.asarray(jd.duration_posterior(jnp.asarray(lpost), Dmax)), rtol=1e-6)
    z = rng.integers(0, K * Dmax, size=(N, T))
    np.testing.assert_array_equal(td.regime_path(torch.from_numpy(z), Dmax).numpy(),
                                  np.asarray(jd.regime_path(jnp.asarray(z), Dmax)))


def test_expand_transition_rows(rng):
    """Count-down rows are 0 at (k, c-1) and ``MASK_NEG`` elsewhere;
    entry rows normalize (``tests/test_hsmm.py``'s structure check)."""
    K, Dmax = 2, 3
    log_A = torch.log(torch.tensor([[0.1, 0.9], [0.6, 0.4]]))
    log_dur = torch.log(torch.tensor([[0.2, 0.3, 0.5], [0.7, 0.2, 0.1]]))
    L = td.expand_transition(log_A, log_dur).numpy()
    for k in range(K):
        for c in range(1, Dmax):
            row = L[k * Dmax + c]
            assert row[k * Dmax + c - 1] == 0.0
            np.testing.assert_array_equal(np.delete(row, k * Dmax + c - 1), -1.0e4)
        assert np.isclose(np.exp(L[k * Dmax]).sum(), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="inconsistent"):
        td.expand_transition(torch.zeros(3, 3), log_dur)


@pytest.mark.parametrize("kind", ["gaussian", "multinomial"])
def test_build_loglik_and_vg_match_jax(rng, kind):
    tm, jm = _models(kind)
    B, T = 3, 20
    data = _data(rng, kind, B, T)
    theta = (0.5 * rng.normal(size=(B, tm.n_free))).astype(np.float32)
    params, _ = tm.unpack(torch.from_numpy(theta))
    terms = tm.build(params, _tdata(data))
    ll = tm.loglik(params, _tdata(data))
    logp, grad = tm.make_vg(_tdata(data))(torch.from_numpy(theta))
    assert terms[1].shape == (B, tm.n_states, tm.n_states)
    for b in range(B):
        jp, _ = jm.unpack(jnp.asarray(theta[b]))
        jterms = jm.build(jp, _jdata(data, b))
        for name, g, w in zip(("log_pi", "log_A", "log_obs", "mask"), terms, jterms):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        np.testing.assert_allclose(float(ll[b]), float(jm.loglik(jp, _jdata(data, b))), rtol=RTOL)
        jlogp, jgrad = jm.make_vg(_jdata(data, b))(jnp.asarray(theta[b]))
        np.testing.assert_allclose(float(logp[b]), float(jlogp), rtol=RTOL)
        np.testing.assert_allclose(grad[b].numpy(), np.asarray(jgrad), rtol=RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(tm.log_prior(params).numpy(),
                               [float(jm.log_prior(jm.unpack(jnp.asarray(q))[0])) for q in theta],
                               rtol=RTOL)


@pytest.mark.parametrize("kind", ["gaussian", "multinomial"])
@pytest.mark.parametrize("masked", [False, True])
def test_hsmm_counts_match_jax_exactly(rng, kind, masked):
    tm, jm = _models(kind)
    B, T = 4, 30
    z = rng.integers(0, tm.n_states, size=(B, T))
    mask = _data(rng, kind, B, T)["mask"] if masked else None
    got = tm._hsmm_counts(torch.from_numpy(z), None if mask is None else torch.from_numpy(mask))
    for b in range(B):
        want = jm._hsmm_counts(jnp.asarray(z[b]), None if mask is None else jnp.asarray(mask[b]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


def test_dmax1_is_the_gaussian_hmm_bit_for_bit(rng):
    hmm, hsmm = GaussianHMM(K=3), GaussianHSMM(K=3, Dmax=1)
    assert hsmm.n_free == hmm.n_free and hsmm.n_states == 3
    B, T = 3, 60
    data = {"x": torch.from_numpy(_data(rng, "gaussian", B, T)["x"])}
    gen = torch.Generator()
    gen.manual_seed(0)
    theta = torch.stack([hmm.init_unconstrained(gen, {"x": data["x"][b]}) for b in range(B)])
    b1 = hmm.build(hmm.unpack(theta)[0], data)
    b2 = hsmm.build(hsmm.unpack(theta)[0], data)
    for a, b in zip(b1[:3], b2[:3]):
        assert torch.equal(a, b)
    mask = torch.ones(B, T)
    for a, b in zip(forward_filter_dispatch(*b1[:3], mask), forward_filter_dispatch(*b2[:3], mask)):
        assert torch.equal(a, b)
    for a, b in zip(smooth_dispatch(*b1[:3], mask), smooth_dispatch(*b2[:3], mask)):
        assert torch.equal(a, b)
    draws = []
    for terms in (b1, b2):
        gen.manual_seed(7)
        draws.append(ffbs_dispatch(gen, *terms[:3], mask)[0])
    assert torch.equal(*draws)


def test_ragged_mask_matches_truncation():
    """A tail mask on the expanded chain gives the log-likelihood of the
    truncated series (``tests/test_hsmm.py``)."""
    model = GaussianHSMM(K=2, Dmax=4)
    T, T_valid = 50, 31
    x = torch.from_numpy(np.random.default_rng(2).normal(size=T).astype(np.float32))
    params = {
        "p_1k": torch.tensor([0.6, 0.4]),
        "A_ij": torch.tensor([[0.1, 0.9], [0.8, 0.2]]),
        "dur_kd": torch.full((2, 4), 0.25),
        "mu_k": torch.tensor([-0.5, 0.5]),
        "sigma_k": torch.tensor([0.8, 0.8]),
    }
    mask = (torch.arange(T) < T_valid).to(torch.float32)
    ll_masked = model.loglik({k: v[None] for k, v in params.items()},
                             {"x": x[None], "mask": mask[None]})
    ll_trunc = model.loglik({k: v[None] for k, v in params.items()}, {"x": x[None, :T_valid]})
    np.testing.assert_allclose(float(ll_masked[0]), float(ll_trunc[0]), rtol=1e-6)


def test_forbidden_durations_degrade_without_nans():
    """``-inf`` duration cells flow through the filter, the smoother and
    the FFBS without NaNs, and a forbidden dwell is never drawn
    (``tests/test_hsmm.py``)."""
    K, Dmax, T = 2, 3, 40
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, T)).astype(np.float32))
    model = GaussianHSMM(K=K, Dmax=Dmax)
    params = {
        "p_1k": torch.tensor([[0.5, 0.5]]),
        "A_ij": torch.tensor([[[0.0, 1.0], [1.0, 0.0]]]),
        "dur_kd": torch.tensor([[[0.0, 0.5, 0.5], [0.5, 0.5, 0.0]]]),
        "mu_k": torch.tensor([[-1.0, 1.0]]),
        "sigma_k": torch.tensor([[1.0, 1.0]]),
    }
    log_pi, _, log_obs, _ = model.build(params, {"x": x})
    log_dur = torch.log(params["dur_kd"])  # -inf cells, not the safe_log floor
    assert not bool(torch.isfinite(log_dur).all())
    log_A = td.expand_transition(safe_log(params["A_ij"]), log_dur)
    log_pi = td.expand_initial(safe_log(params["p_1k"]), log_dur)
    mask = torch.ones(1, T)
    _, ll = forward_filter_dispatch(log_pi, log_A, log_obs, mask)
    assert bool(torch.isfinite(ll).all())
    _, _, log_gamma, _ = smooth_dispatch(log_pi, log_A, log_obs, mask)
    assert bool(torch.isfinite(torch.exp(log_gamma)).all())
    gen = torch.Generator()
    gen.manual_seed(0)
    z, _ = ffbs_dispatch(gen, log_pi, log_A, log_obs, mask)
    zk = model.regime_path(z[0]).numpy()
    runs, cur, n = [], zk[0], 1
    for v in zk[1:]:
        if v == cur:
            n += 1
        else:
            runs.append((cur, n))
            cur, n = v, 1
    assert all(n >= 2 for k, n in runs if k == 0)


def test_hsmm_sim_dwells_follow_dur():
    """Completed dwells (a series' first run included, its last,
    truncated run excluded) of each regime against its duration pmf:
    chi-square over the supported lengths, p > 1e-3."""
    gen = torch.Generator()
    gen.manual_seed(5)
    z, x = hsmm_sim(gen, 300, A_ALT, DUR, np.ones(2) / 2,
                    obsmodel_gaussian(np.array([-0.9, 0.9]), np.array([0.75, 0.75])), batch=(40,))
    assert z.shape == x.shape == (40, 300) and x.dtype == torch.float32
    counts = np.zeros_like(DUR)
    for row in z.numpy():
        change = np.flatnonzero(np.diff(row)) + 1
        starts, ends = np.r_[0, change], np.r_[change, len(row)]
        for s, e in zip(starts[:-1], ends[:-1]):
            counts[row[s], e - s - 1] += 1
    for k in range(2):
        support = DUR[k] > 0
        assert counts[k, ~support].sum() == 0
        expected = DUR[k, support] * counts[k].sum()
        assert chisquare(counts[k, support], expected).pvalue > 1e-3, counts[k]
    with pytest.raises(ValueError, match="pmf"):
        hsmm_sim(gen, 10, A_ALT, DUR * 2, np.ones(2) / 2, obsmodel_gaussian([0, 1], [1, 1]))
    with pytest.raises(ValueError, match="Dmax"):
        hsmm_sim(gen, 10, A_ALT, DUR[:1], np.ones(2) / 2, obsmodel_gaussian([0, 1], [1, 1]))


def test_model_from_jax_carries_the_configuration():
    from hhmm_tpu.models import GaussianHMM as JGaussianHMM
    from hhmm_tpu_torch.convert import constrained_from_jax, params_from_jax

    prior = JNIGPrior(m0=0.5, kappa0=0.3, a0=2.5, b0=1.25)
    for jm in (JGaussianHMM(K=3, nig_prior=prior, sticky_kappa=2.0),
               JGaussianHSMM(K=3, Dmax=5, nig_prior=prior, sticky_kappa=2.0),
               JGaussianHSMM(K=2, Dmax=4), JMultinomialHSMM(K=2, Dmax=3, L=4, sticky_kappa=1.0)):
        tm = model_from_jax(jm)
        assert type(tm).__name__ == type(jm).__name__
        assert (tm.K, tm.sticky_kappa, tm.n_free) == (jm.K, jm.sticky_kappa, jm.n_free)
        assert [n for n, _ in tm.specs()] == [n for n, _ in jm.specs()]
        for attr in ("Dmax", "L"):
            assert getattr(tm, attr, None) == getattr(jm, attr, None)
        jp = getattr(jm, "nig_prior", None)
        tp = getattr(tm, "nig_prior", None)
        assert (tp is None) == (jp is None)
        if jp is not None:
            assert (tp.m0, tp.kappa0, tp.a0, tp.b0) == (jp.m0, jp.kappa0, jp.a0, jp.b0)
        theta = np.random.default_rng(0).normal(size=(2, jm.n_free)).astype(np.float32)
        got = tm.unpack(params_from_jax(tm, theta, device="cpu"))[0]
        want = jax.vmap(lambda q: jm.unpack(q)[0])(jnp.asarray(theta))
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL)
        cons = constrained_from_jax(tm, {k: np.asarray(v) for k, v in want.items()}, device="cpu")
        assert set(cons) == set(got)


def test_gaussian_init_matches_jax():
    """The same k-means (``seed=0``) on the same data: the un-jittered
    parts equal the JAX init's, mu within 5 jitter sigma."""
    tm, jm = _models("gaussian")
    x = _data(np.random.default_rng(4), "gaussian", 1, 120)["x"][0]
    gen = torch.Generator().manual_seed(3)
    got = tm.unpack(tm.init_unconstrained(gen, {"x": torch.from_numpy(x)})[None])[0]
    want = jm.unpack(jm.init_unconstrained(jax.random.PRNGKey(3), {"x": x}))[0]
    for k in ("p_1k", "A_ij", "dur_kd", "sigma_k"):
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)
    sigma = np.asarray(want["sigma_k"])
    assert np.all(np.abs(got["mu_k"][0].numpy() - np.asarray(want["mu_k"])) <= 5 * 0.1 * 2 * sigma)


def _mcse(draws):
    mean = draws.mean(0)
    se = np.array([draws[:, p].std(ddof=1) / np.sqrt(max(j_ess(draws[None, :, p]), 1.0))
                   for p in range(draws.shape[1])])
    return mean, se


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["gaussian", "multinomial"])
def test_gibbs_posterior_agrees_with_jax(kind):
    """A short fit of simulated peaked-dwell series (2 a model, 1 chain,
    30 + 300 sweeps) by the port's Gibbs and by the JAX Gibbs from the
    same inits: every constrained scalar's posterior mean within
    4·sqrt(mcse_port² + mcse_jax²)."""
    B, T, warmup, samples = 2, 150, 30, 300
    gen = torch.Generator()
    gen.manual_seed(11)
    if kind == "gaussian":
        obs = obsmodel_gaussian(np.array([-1.0, 1.0]), np.array([0.5, 0.5]))
        jm = JGaussianHSMM(K=2, Dmax=6, nig_prior=JNIGPrior(**PRIOR))
        names = ("mu_k", "sigma_k", "A_ij", "dur_kd")
    else:
        from hhmm_tpu_torch.sim import obsmodel_categorical

        obs = obsmodel_categorical(np.array([[0.7, 0.1, 0.1, 0.1], [0.1, 0.1, 0.1, 0.7]]))
        jm = JMultinomialHSMM(K=2, Dmax=6, L=4)
        names = ("phi_k", "A_ij", "dur_kd")
    _, x = hsmm_sim(gen, T, A_ALT, DUR, np.ones(2) / 2, obs, batch=(B,))
    x = x.numpy().astype(np.float32 if kind == "gaussian" else np.int32)
    tm = model_from_jax(jm)
    init = np.asarray(j_default_init(jm, {"x": jnp.asarray(x)}, B, 1, jax.random.PRNGKey(3)))
    qs_t, st_t = sample_gibbs(tm, {"x": torch.from_numpy(x)}, torch.tensor(init),
                              GibbsConfig(num_warmup=warmup, num_samples=samples),
                              seed=0, device="cpu")
    assert bool(st_t["chain_healthy"].all()) and bool(torch.isfinite(st_t["logp"]).all())
    cfg = JGibbsConfig(num_warmup=warmup, num_samples=samples, num_chains=1)
    run = jax.jit(jax.vmap(
        lambda xi, qi, ki: j_sample_gibbs(jm, {"x": xi}, ki, cfg, init_q=qi, jit=False)[0]))
    qs_j = np.asarray(run(jnp.asarray(x), jnp.asarray(init), jax.random.split(jax.random.PRNGKey(0), B)))
    cons_t = tm.constrained_draws(qs_t)
    cons_j = jax.jit(jax.vmap(lambda q: jm.unpack(q)[0]))(jnp.asarray(qs_j.reshape(-1, tm.n_free)))
    for b in range(B):
        mt = np.concatenate([cons_t[k][b, 0].reshape(samples, -1).numpy() for k in names], 1)
        mj = np.concatenate([np.asarray(cons_j[k]).reshape(B, samples, -1)[b] for k in names], 1)
        mean_t, se_t = _mcse(mt)
        mean_j, se_j = _mcse(mj)
        bound = 4 * np.sqrt(se_t ** 2 + se_j ** 2) + 1e-3
        assert np.all(np.abs(mean_t - mean_j) <= bound), (b, np.abs(mean_t - mean_j) / bound)
