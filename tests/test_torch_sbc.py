"""Simulation-based calibration of the port's samplers (Cook, Gelman &
Rubin 2006), the gates of ``tests/test_sbc.py`` and ``tests/test_gibbs.py``
on ``hhmm_tpu_torch``: draw θ from the prior, simulate data, fit every
replication as one batch through ``fit_batched``, and rank θ among the
thinned posterior draws; over replications the ranks must be uniform.

- the Tayal hard-gate model by NUTS (``max_treedepth`` 5, the JAX
  suite's budget) and by blocked Gibbs;
- the Gaussian HMM with its NIG emission prior by blocked Gibbs.

Every case takes minutes on the CPU (the plain kernel versions), so
the whole file is ``slow``.
"""

import numpy as np
import pytest
import torch
from scipy.stats import kstest

from hhmm_tpu_torch.batch import fit_batched
from hhmm_tpu_torch.infer import GibbsConfig, SamplerConfig
from hhmm_tpu_torch.models import GaussianHMM, NIGPrior, TayalHHMM
from hhmm_tpu_torch.models.tayal import UP, _UP_STATES
from hhmm_tpu_torch.sim import hmm_sim, obsmodel_categorical, obsmodel_gaussian

pytestmark = pytest.mark.slow

THIN = 4


def _ranks(theta_true, draws, thin=THIN):
    thinned = draws[::thin]
    r = (thinned < theta_true[None, :]).sum(axis=0)
    return (r + 0.5) / (thinned.shape[0] + 1)


def _uniformity_ok(u):
    """The JAX suite's gates: rank mean in (0.3, 0.7), KS p > 1e-3 per
    quantity over the independent replications."""
    u = np.asarray(u)
    assert 0.30 < u.mean() < 0.70, f"rank mean {u.mean():.3f}"
    ps = np.array([kstest(c, "uniform").pvalue for c in u.T])
    assert ps.min() > 1e-3, f"KS uniformity min p={ps.min():.2e} (per-col {ps.round(4)})"


def _tayal_reps(rng, n_reps, T=300):
    model = TayalHHMM(gate_mode="hard")
    datasets, trues = [], []
    for _ in range(n_reps):
        p11 = rng.uniform()
        A_row = rng.dirichlet(np.ones(2), size=2)
        phi = rng.dirichlet(np.ones(9), size=4)
        params = {"p_11": torch.tensor(p11), "A_row": torch.as_tensor(A_row),
                  "phi_k": torch.as_tensor(phi)}
        pi, A = model.assemble(params)
        gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
        z, x = hmm_sim(gen, T, A.numpy(), pi.numpy(), obsmodel_categorical(phi), validate=False)
        sign = np.where(np.asarray(_UP_STATES)[z.numpy()], UP, 1 - UP)
        datasets.append({"x": x.numpy(), "sign": sign, "mask": np.ones(T, np.float32)})
        trues.append(np.concatenate([[p11], [A_row[0, 0], A_row[1, 0]], phi[:, 0], [phi[2, 4]]]))
    data = {k: np.stack([d[k] for d in datasets]) for k in datasets[0]}
    return model, data, trues


def _tayal_flat(model, qs_i):
    d = model.constrained_draws(qs_i.reshape(-1, qs_i.shape[-1]))
    A, phi = d["A_row"].reshape(-1, 4).numpy(), d["phi_k"].reshape(-1, 4, 9).numpy()
    return np.column_stack([d["p_11"].reshape(-1).numpy(), A[:, 0], A[:, 2],
                            *[phi[:, k, 0] for k in range(4)], phi[:, 2, 4]])


def test_tayal_nuts_rank_uniformity():
    """``tests/test_sbc.py::TestSBCTayal`` on the port's NUTS."""
    rng = np.random.default_rng(0)
    model, data, trues = _tayal_reps(rng, 24)
    cfg = SamplerConfig(num_warmup=150, num_samples=200, num_chains=1, max_treedepth=5)
    qs, stats = fit_batched(model, data, cfg, chunk_size=24, seed=0, device="cpu")
    assert float(stats["diverging"].float().mean()) < 0.1
    _uniformity_ok(np.stack([_ranks(trues[i], _tayal_flat(model, qs[i])) for i in range(24)]))


def test_tayal_gibbs_rank_uniformity():
    """``tests/test_gibbs.py::TestSBCGibbs::test_rank_uniformity_tayal``
    on the port's Gibbs sampler."""
    rng = np.random.default_rng(1)
    model, data, trues = _tayal_reps(rng, 12)
    cfg = GibbsConfig(num_warmup=100, num_samples=400, num_chains=1)
    qs, _ = fit_batched(model, data, cfg, chunk_size=12, seed=0, device="cpu")
    u = np.concatenate([_ranks(trues[i], _tayal_flat(model, qs[i])) for i in range(12)])
    assert 0.30 < u.mean() < 0.70, f"rank mean {u.mean():.3f}"
    assert kstest(u, "uniform").pvalue > 1e-3


def test_gaussian_gibbs_rank_uniformity():
    """``tests/test_sbc.py::TestSBCGaussianGibbs`` on the port's Gibbs
    sampler (NIG prior, sorted iid prior draws = the ordered-cone
    prior)."""
    rng = np.random.default_rng(2)
    K, T, n_reps = 2, 250, 24
    prior = NIGPrior(m0=0.0, kappa0=0.5, a0=3.0, b0=1.5)
    model = GaussianHMM(K=K, nig_prior=prior)
    datasets, trues = [], []
    for _ in range(n_reps):
        p1 = rng.dirichlet(np.ones(K))
        A = rng.dirichlet(np.ones(K), size=K)
        sigma = np.sqrt(1.0 / rng.gamma(prior.a0, 1.0 / prior.b0, size=K))
        mu = prior.m0 + sigma / np.sqrt(prior.kappa0) * rng.standard_normal(K)
        order = np.argsort(mu)
        mu, sigma = mu[order], sigma[order]
        gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
        _, x = hmm_sim(gen, T, A, p1, obsmodel_gaussian(mu, sigma), validate=False)
        datasets.append({"x": x.numpy().astype(np.float32), "mask": np.ones(T, np.float32)})
        trues.append(np.concatenate([mu, sigma, [A[0, 0], A[1, 1]], [p1[0]]]))
    data = {k: np.stack([d[k] for d in datasets]) for k in datasets[0]}
    cfg = GibbsConfig(num_warmup=150, num_samples=400, num_chains=1)
    qs, stats = fit_batched(model, data, cfg, chunk_size=n_reps, seed=2, device="cpu")
    assert torch.isfinite(stats["logp"]).all()
    units = []
    for i in range(n_reps):
        d = model.constrained_draws(qs[i].reshape(-1, qs.shape[-1]))
        flat = np.column_stack([d["mu_k"].numpy(), d["sigma_k"].numpy(),
                                d["A_ij"].numpy()[:, [0, 1], [0, 1]], d["p_1k"].numpy()[:, :1]])
        units.append(_ranks(trues[i], flat))
    _uniformity_ok(np.stack(units))
