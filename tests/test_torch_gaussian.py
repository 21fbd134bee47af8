"""The PyTorch port's Gaussian HMM (`hmm/stan/hmm.stan`) and what it
needs — ``Positive`` / ``Ordered`` bijectors, ``core.dists``,
``sim.obsmodel_gaussian``, ``infer.relabel`` — against the JAX package
on the same numpy inputs.

- bijectors and the deterministic ``dists`` functions within 1e-6 (f32);
  the samplers by their moments;
- ``GaussianHMM`` ``build``, ``log_prior`` (NIG and sticky) and
  ``make_vg`` value and gradient against the JAX model (rtol 1e-5);
- ``gibbs_update``'s NIG conditional moments over 20k lanes against the
  closed-form posterior on a fixed, well-separated assignment;
- a small batched Gibbs fit: posterior means against the JAX Gibbs run
  within 4·sqrt(mcse_port² + mcse_jax²) per constrained scalar.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhmm_tpu.batch import default_init as j_default_init
from hhmm_tpu.core import bijectors as jb
from hhmm_tpu.core import dists as jdists
from hhmm_tpu.infer import GibbsConfig as JGibbsConfig
from hhmm_tpu.infer import make_lp_bc as j_make_lp_bc
from hhmm_tpu.infer import relabel as jrelabel
from hhmm_tpu.infer import sample_gibbs as j_sample_gibbs
from hhmm_tpu.infer.diagnostics import ess as j_ess
from hhmm_tpu.models import GaussianHMM as JGaussianHMM
from hhmm_tpu.models import NIGPrior as JNIGPrior
from hhmm_tpu_torch.batch import default_init
from hhmm_tpu_torch.core import Ordered, Positive, dists
from hhmm_tpu_torch.infer import (
    GibbsConfig,
    apply_relabel,
    confusion_matrix,
    greedy_relabel,
    sample_gibbs,
)
from hhmm_tpu_torch.models import GaussianHMM, NIGPrior
from hhmm_tpu_torch.sim import hmm_sim, obsmodel_gaussian

torch.set_num_threads(1)

TOL = 1e-6
A_TRUE = np.array([[0.8, 0.1, 0.1], [0.1, 0.8, 0.1], [0.05, 0.15, 0.8]])
MU_TRUE, SIGMA_TRUE = np.array([-2.0, 0.5, 3.0]), np.array([0.5, 0.8, 0.6])
PRIOR = dict(m0=0.0, kappa0=0.1, a0=2.0, b0=1.0)


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _sim(rng, B, T):
    """Numpy ``(z [B, T], x [B, T])`` from the ``hmm/main.R`` configuration."""
    z = np.zeros((B, T), dtype=np.int64)
    z[:, 0] = rng.integers(0, 3, size=B)
    for t in range(1, T):
        u = rng.random(B)
        z[:, t] = (u[:, None] >= np.cumsum(A_TRUE[z[:, t - 1]], -1)[:, :-1]).sum(-1)
    x = MU_TRUE[z] + SIGMA_TRUE[z] * rng.normal(size=(B, T))
    return z, _f32(x)


# ---------------------------------------------------------------------------
# bijectors and distributions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,lower", [((3,), 1e-4), ((), 0.0), ((2, 3), 0.5)])
def test_positive_matches_jax(rng, shape, lower):
    tb, jbij = Positive(shape, lower=lower), jb.Positive(shape=shape, lower=lower)
    x = _f32(rng.normal(size=(4, tb.n_free)))
    y, ldj = tb.forward(torch.from_numpy(x))
    jy, jldj = jax.vmap(jbij.forward)(jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ldj.numpy(), np.asarray(jldj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.inverse(y).numpy(), x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(3,), (2, 4)])
def test_ordered_matches_jax(rng, shape):
    tb, jbij = Ordered(shape), jb.Ordered(shape=shape)
    x = _f32(rng.normal(size=(5, tb.n_free)))
    y, ldj = tb.forward(torch.from_numpy(x))
    jy, jldj = jax.vmap(jbij.forward)(jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ldj.numpy(), np.asarray(jldj), rtol=TOL, atol=TOL)
    assert bool((y[..., 1:] > y[..., :-1]).all())
    np.testing.assert_allclose(tb.inverse(y).numpy(), x, rtol=1e-5, atol=1e-5)
    # the log-Jacobian is the one autograd finds (batch of scalars)
    xt = torch.from_numpy(x[0]).double().requires_grad_(True)
    jac = torch.autograd.functional.jacobian(lambda v: tb.forward(v)[0].reshape(-1), xt)
    ldj64 = float(tb.forward(xt)[1].detach())
    np.testing.assert_allclose(float(torch.logdet(jac)), ldj64, atol=1e-10)


def test_deterministic_dists_match_jax(rng):
    x = _f32(rng.normal(size=(6, 5)))
    mu, sigma = _f32(rng.normal(size=5)), _f32(rng.uniform(0.5, 2.0, size=5))
    got = dists.normal_logpdf(*map(torch.from_numpy, (x, mu, sigma)))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jdists.normal_logpdf(x, mu, sigma)), rtol=TOL, atol=TOL
    )
    log_p = _f32(rng.normal(size=(6, 4)))
    k = rng.integers(0, 4, size=6)
    np.testing.assert_allclose(
        dists.categorical_logpmf(torch.from_numpy(k), torch.from_numpy(log_p)).numpy(),
        np.asarray(jdists.categorical_logpmf(jnp.asarray(k), jnp.asarray(log_p))),
        rtol=TOL, atol=TOL,
    )
    p = _f32(rng.dirichlet(np.ones(4), size=6))
    p[0, 1] = 0.0  # a boundary point: xlogy keeps alpha = 1 finite
    alpha = _f32(rng.uniform(0.5, 3.0, size=(6, 4)))
    alpha[0, 1] = 1.0
    np.testing.assert_allclose(
        dists.dirichlet_logpdf(torch.from_numpy(p), torch.from_numpy(alpha)).numpy(),
        np.asarray(jdists.dirichlet_logpdf(p, alpha)), rtol=TOL, atol=1e-5,
    )
    log_w = _f32(np.log(rng.dirichlet(np.ones(3))))
    mus, sigmas = _f32(rng.normal(size=3)), _f32(rng.uniform(0.5, 1.5, size=3))
    xm = _f32(rng.normal(size=7))
    np.testing.assert_allclose(
        dists.mixture_normal_logpdf(*map(torch.from_numpy, (xm, log_w, mus, sigmas))).numpy(),
        np.asarray(jdists.mixture_normal_logpdf(xm, log_w, mus, sigmas)), rtol=TOL, atol=TOL,
    )


def test_samplers_draw_the_right_distributions():
    gen = torch.Generator()
    gen.manual_seed(0)
    n = 40_000
    s = dists.normal_sample(gen, 1.5, 2.0, (n,))
    assert abs(float(s.mean()) - 1.5) < 4 * 2.0 / math.sqrt(n)
    assert abs(float(s.std()) - 2.0) < 0.05
    p = np.array([0.2, 0.5, 0.3])
    for draw in (
        dists.categorical_sample(gen, torch.log(torch.tensor(p)), (n,)),
        dists.gumbel_argmax_sample(gen, torch.log(torch.tensor(p)).expand(n, 3)),
    ):
        freq = np.bincount(draw.numpy(), minlength=3) / n
        assert np.all(np.abs(freq - p) < 4 * np.sqrt(p * (1 - p) / n))


def test_obsmodel_gaussian_and_relabel(rng):
    gen = torch.Generator()
    gen.manual_seed(1)
    z, x = hmm_sim(gen, 2000, A_TRUE, np.ones(3) / 3,
                   obsmodel_gaussian(MU_TRUE, SIGMA_TRUE), batch=(3,))
    assert x.dtype == torch.float32 and x.shape == (3, 2000)
    for k in range(3):
        sel = x[z == k].double()
        assert abs(float(sel.mean()) - MU_TRUE[k]) < 0.05
        assert abs(float(sel.std()) - SIGMA_TRUE[k]) < 0.05
    zt = rng.integers(0, 3, size=200)
    perm_true = np.array([2, 0, 1])
    zh = np.argsort(perm_true)[zt]  # estimated labels: a permutation of the true
    np.testing.assert_array_equal(confusion_matrix(zt, zh, 3), jrelabel.confusion_matrix(zt, zh, 3))
    perm = greedy_relabel(zt, zh, 3)
    np.testing.assert_array_equal(perm, jrelabel.greedy_relabel(zt, zh, 3))
    np.testing.assert_array_equal(apply_relabel(zh, perm), zt)


# ---------------------------------------------------------------------------
# the model against the JAX model
# ---------------------------------------------------------------------------


def _models(prior=True, sticky=0.0):
    tp = NIGPrior(**PRIOR) if prior else None
    jp = JNIGPrior(**PRIOR) if prior else None
    return GaussianHMM(3, tp, sticky_kappa=sticky), JGaussianHMM(3, jp, sticky_kappa=sticky)


@pytest.mark.parametrize("prior,sticky", [(False, 0.0), (True, 0.0), (True, 2.5)])
def test_build_and_log_prior_match_jax(rng, prior, sticky):
    tm, jm = _models(prior, sticky)
    theta = _f32(0.5 * rng.normal(size=(4, tm.n_free)))
    _, x = _sim(rng, 1, 30)
    params, ldj = tm.unpack(torch.from_numpy(theta))
    terms = tm.build(params, {"x": torch.from_numpy(x[0])})
    lp = tm.log_prior(params)
    assert lp.shape == (4,)
    for i in range(4):
        jparams, jldj = jm.unpack(jnp.asarray(theta[i]))
        jterms = jm.build(jparams, {"x": jnp.asarray(x[0])})
        for got, want in zip(terms[:3], jterms[:3]):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(lp[i]), float(jm.log_prior(jparams)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(ldj[i]), float(jldj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prior,sticky", [(False, 0.0), (True, 1.0)])
def test_make_vg_matches_jax(rng, prior, sticky):
    B, C, T = 3, 2, 50
    tm, jm = _models(prior, sticky)
    _, x = _sim(rng, B, T)
    theta = _f32(0.3 * rng.normal(size=(B, C, tm.n_free)))
    logp, grad = tm.make_vg({"x": torch.from_numpy(x)})(torch.from_numpy(theta))
    jlp, jgrad = jax.jit(j_make_lp_bc(jm, {"x": jnp.asarray(x)}))(jnp.asarray(theta))
    assert logp.shape == (B, C) and grad.shape == (B, C, tm.n_free)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlp), rtol=1e-5)
    # each gradient entry sums T per-step terms, in another order in
    # each package: rtol 1e-5 plus 2e-5 of the largest entry
    scale = np.abs(np.asarray(jgrad)).max()
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=2e-5 * scale)


def test_nig_conditional_moments():
    """Over 20k lanes on one fixed, well-separated assignment: the drawn
    (mu, sigma^2) have the closed-form NIG posterior moments."""
    n, T = 20_000, 60
    rng = np.random.default_rng(4)
    z = np.repeat(np.arange(3), T // 3)
    x = _f32(MU_TRUE[z] + SIGMA_TRUE[z] * rng.normal(size=T))
    tm, _ = _models()
    pr = NIGPrior(**PRIOR)
    gen = torch.Generator()
    gen.manual_seed(0)
    zt = torch.from_numpy(z).expand(n, T)
    xt = torch.from_numpy(x).expand(n, T)
    params = {"mu_k": torch.tensor(MU_TRUE, dtype=torch.float32).expand(n, 3),
              "sigma_k": torch.tensor(SIGMA_TRUE, dtype=torch.float32).expand(n, 3)}
    new = tm.gibbs_update(gen, zt, {"x": xt}, params)
    v = new["sigma_k"].double() ** 2
    for k in range(3):
        xs = x[z == k].astype(np.float64)
        nk, xbar = len(xs), xs.mean()
        kap = pr.kappa0 + nk
        m_n = (pr.kappa0 * pr.m0 + xs.sum()) / kap
        a_n = pr.a0 + 0.5 * nk
        scatter = ((xs - xbar) ** 2).sum()
        b_n = pr.b0 + 0.5 * scatter + 0.5 * pr.kappa0 * nk * (xbar - pr.m0) ** 2 / kap
        ev = b_n / (a_n - 1)  # inverse-gamma mean
        sdv = ev / math.sqrt(a_n - 2)
        assert abs(float(v[:, k].mean()) - ev) < 4 * sdv / math.sqrt(n)
        mu = new["mu_k"][:, k].double()
        sd_mu = math.sqrt(ev / kap)  # marginal sd: E[v]/kappa_n
        assert abs(float(mu.mean()) - m_n) < 4 * sd_mu / math.sqrt(n)
        assert abs(float(mu.std()) - sd_mu) < 0.05 * sd_mu
    # the assignment is well separated: every lane's draw is ordered
    assert bool((new["mu_k"][:, 1:] > new["mu_k"][:, :-1]).all())
    A = new["A_ij"].double().mean(0).numpy()
    counts = np.zeros((3, 3))
    np.add.at(counts, (z[:-1], z[1:]), 1)
    conc = 1.0 + counts
    np.testing.assert_allclose(A, conc / conc.sum(1, keepdims=True), atol=0.01)


def test_ordered_cone_keeps_current_on_reject():
    """A draw that is not ordered leaves the lane's emission parameters
    as they were."""
    tm, _ = _models()
    gen = torch.Generator()
    gen.manual_seed(0)
    n, T = 2000, 6
    # two states share the same data: their draws are exchangeable, so
    # about half the lanes propose an unordered mu
    z = torch.tensor([0, 0, 1, 1, 2, 2]).expand(n, T)
    x = torch.tensor([0.0, 0.1, 0.05, 0.02, 5.0, 5.1]).expand(n, T)
    cur = {"mu_k": torch.tensor([-9.0, -8.0, 9.0]).expand(n, 3),
           "sigma_k": torch.tensor([1.0, 2.0, 3.0]).expand(n, 3)}
    new = tm.gibbs_update(gen, z, {"x": x}, cur)
    kept = (new["mu_k"] == cur["mu_k"]).all(-1)
    assert 0.2 < float(kept.float().mean()) < 0.8
    assert bool((new["sigma_k"][kept] == cur["sigma_k"][kept]).all())
    assert bool((new["mu_k"][:, 1:] > new["mu_k"][:, :-1]).all())


def test_nig_prior_sample_is_the_sorted_prior():
    pr = NIGPrior()  # a0 = 2.5: the variance of sigma^2 is finite
    gen = torch.Generator()
    gen.manual_seed(2)
    n = 20_000
    mu, sigma = pr.sample(gen, 3, (n,))
    assert mu.shape == sigma.shape == (n, 3)
    assert bool((mu[:, 1:] >= mu[:, :-1]).all()) and bool((sigma > 0).all())
    v = (sigma.double() ** 2).flatten()
    ev = pr.b0 / (pr.a0 - 1.0)
    sd = ev / math.sqrt(pr.a0 - 2.0)
    assert abs(float(v.mean()) - ev) < 4 * sd / math.sqrt(v.numel())
    # sorting is a permutation: the pooled mu keeps the prior mean m0
    assert abs(float(mu.double().mean()) - pr.m0) < 0.05
    # and the density agrees with the JAX prior's
    jpr = JNIGPrior()
    np.testing.assert_allclose(
        pr.log_density(mu[:4], sigma[:4]).numpy(),
        np.asarray(jax.vmap(jpr.log_density)(jnp.asarray(mu[:4].numpy()),
                                             jnp.asarray(sigma[:4].numpy()))),
        rtol=1e-5,
    )


def test_gibbs_without_prior_raises():
    with pytest.raises(ValueError, match="conjugate prior"):
        GaussianHMM(3).gibbs_update(torch.Generator(), torch.zeros(1, 4, dtype=torch.long),
                                    {"x": torch.zeros(1, 4)}, {})


def test_init_is_ordered_kmeans(rng):
    _, x = _sim(rng, 2, 200)
    tm, _ = _models()
    init = default_init(tm, {"x": torch.from_numpy(x)}, 2, 3, seed=0, device="cpu")
    assert init.shape == (2, 3, tm.n_free)
    mu = tm.constrained_draws(init)["mu_k"]
    assert bool((mu[..., 1:] > mu[..., :-1]).all())
    assert float((mu.mean(1) - torch.tensor(MU_TRUE)).abs().max()) < 0.5


def _mcse(draws):
    mean = draws.mean(0)
    se = np.array([
        draws[:, p].std(ddof=1) / np.sqrt(max(j_ess(draws[None, :, p]), 1.0))
        for p in range(draws.shape[1])
    ])
    return mean, se


def test_gibbs_posterior_agrees_with_jax(rng):
    """A small batched fit: the port's Gibbs and the JAX package's Gibbs
    on the same data and inits (1 chain a series)."""
    B, T, warmup, samples = 3, 150, 30, 300
    _, x = _sim(rng, B, T)
    tm, jm = _models()
    init = np.asarray(j_default_init(jm, {"x": jnp.asarray(x)}, B, 1, jax.random.PRNGKey(3)))
    qs_t, st_t = sample_gibbs(tm, {"x": torch.from_numpy(x)}, torch.tensor(init),
                              GibbsConfig(num_warmup=warmup, num_samples=samples),
                              seed=0, device="cpu")
    assert bool(st_t["chain_healthy"].all()) and bool(torch.isfinite(st_t["logp"]).all())
    cfg = JGibbsConfig(num_warmup=warmup, num_samples=samples, num_chains=1)
    run = jax.jit(jax.vmap(
        lambda xi, qi, ki: j_sample_gibbs(jm, {"x": xi}, ki, cfg, init_q=qi, jit=False)[0]
    ))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    qs_j = np.asarray(run(jnp.asarray(x), jnp.asarray(init), keys))
    cons_t = tm.constrained_draws(qs_t)
    cons_j = jax.jit(jax.vmap(lambda q: jm.unpack(q)[0]))(jnp.asarray(qs_j.reshape(-1, tm.n_free)))
    names = ("mu_k", "sigma_k", "A_ij")
    for b in range(B):
        mt = np.concatenate([cons_t[k][b, 0].reshape(samples, -1).numpy() for k in names], 1)
        mj = np.concatenate([np.asarray(cons_j[k]).reshape(B, samples, -1)[b] for k in names], 1)
        mean_t, se_t = _mcse(mt)
        mean_j, se_j = _mcse(mj)
        bound = 4 * np.sqrt(se_t ** 2 + se_j ** 2)
        assert np.all(np.abs(mean_t - mean_j) <= bound), (b, np.abs(mean_t - mean_j) / bound)
        np.testing.assert_allclose(mean_t[:3], MU_TRUE, atol=0.35)
