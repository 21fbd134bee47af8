"""Per-series ChEES adaptation (``ChEESConfig(shared_adaptation=False)``,
`hhmm_tpu_torch/infer/chees.py`) and its route through ``fit_batched``.

- at B=1 the per-series arm is the shared arm, bit for bit (the sampler
  alone, and ``fit_batched`` on a small Tayal window);
- two series of very different curvature adapt different step sizes,
  and the lockstep runs each transition as long as its longest series;
- a weight-0 padding series changes nothing: not the real series'
  draws, not the leapfrogs the batch runs;
- ``fit_batched`` with a ragged chunk keeps every series' own step size
  and reports the lockstep efficiency;
- ``slow``: the posterior of a two-series multinomial batch against
  the JAX ``fit_batched`` with ``shared_adaptation=False`` within 4
  MCSE (label-invariant: the states sorted by their first emission
  probability).
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from hhmm_tpu.batch import fit_batched as j_fit_batched
from hhmm_tpu.infer import ChEESConfig as JChEESConfig
from hhmm_tpu.models import MultinomialHMM as JMultinomialHMM
from hhmm_tpu_torch.batch import fit_batched
from hhmm_tpu_torch.infer import ChEESConfig, ess, sample_chees_batched
from hhmm_tpu_torch.models import MultinomialHMM, TayalHHMM
from hhmm_tpu_torch.sim import tayal_batch

torch.set_num_threads(1)

CFG = ChEESConfig(num_warmup=40, num_samples=15, num_chains=3, max_leapfrogs=16)
PER_SERIES = replace(CFG, shared_adaptation=False)


def _gauss(prec):
    """``lp_bc`` of zero-mean Gaussians, one precision matrix a series."""
    prec = torch.as_tensor(np.asarray(prec), dtype=torch.float32)

    def lp_bc(q):
        pq = torch.einsum("bij,bcj->bci", prec, q)
        return -0.5 * (q * pq).sum(-1), -pq

    return lp_bc


def _init(B, seed=0, dim=3):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(B, 3, dim)) * 0.3,
                           dtype=torch.float32)


def _correlated(rho):
    cov = np.full((3, 3), rho) + (1 - rho) * np.eye(3)
    return np.linalg.inv(cov)


def test_b1_per_series_is_the_shared_arm_bitwise():
    lp = _gauss([_correlated(0.6)])
    a, sa = sample_chees_batched(lp, _init(1), CFG, seed=3, device="cpu")
    b, sb = sample_chees_batched(lp, _init(1), PER_SERIES, seed=3, device="cpu")
    assert torch.equal(a, b)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert float(sb["lockstep_efficiency"][0]) == 1.0


def test_b1_fit_batched_arms_bitwise():
    x, sign = tayal_batch(1, 48, seed=5, device="cpu")
    data = {"x": x, "sign": sign}
    cfg = ChEESConfig(num_warmup=12, num_samples=6, num_chains=2, max_leapfrogs=6)
    a, sa = fit_batched(TayalHHMM(), data, cfg, seed=2, device="cpu")
    b, sb = fit_batched(TayalHHMM(), data, replace(cfg, shared_adaptation=False), seed=2,
                        device="cpu")
    assert torch.equal(a, b) and torch.equal(sa["step_size"], sb["step_size"])
    assert torch.equal(sa["num_leaves"], sb["num_leaves"])


def test_series_adapt_their_own_step_sizes():
    lp = _gauss([np.eye(3), _correlated(0.98)])
    qs, st = sample_chees_batched(lp, _init(2), PER_SERIES, seed=1, device="cpu")
    eps = st["step_size"][:, 0]
    assert float(eps[0]) > 3 * float(eps[1])
    assert torch.equal(st["step_size"], eps[:, None].expand(2, 3))
    # every transition ran its longest series' leapfrogs
    steps = torch.cat([st["warmup_num_leaves"], st["num_leaves"][:, 0]], 1)  # [B, W + S]
    assert torch.equal(st["lockstep_leapfrogs"][0], steps.max(0).values)
    eff = float(st["lockstep_efficiency"][0])
    assert 0.5 < eff < 1.0
    assert abs(eff - float(steps.float().mean(0).sum() / steps.max(0).values.sum())) < 1e-6
    assert torch.isfinite(qs).all() and st["chain_healthy"].all()


def test_weight_zero_padding_series_changes_nothing():
    """The real series' draws and the batch's leapfrogs do not depend on
    what a weight-0 series holds, even a target that would need the most
    leapfrogs: it runs one a transition."""
    w = torch.tensor([1.0, 0.0])
    runs = []
    for other in (np.eye(3), 400.0 * _correlated(0.99)):
        lp = _gauss([_correlated(0.5), other])
        init = _init(2)
        init[1] = torch.as_tensor(np.random.default_rng(9).normal(size=(3, 3)), dtype=torch.float32)
        runs.append(sample_chees_batched(lp, init, PER_SERIES, seed=4, device="cpu",
                                         series_weight=w))
    (a, sa), (b, sb) = runs
    assert torch.equal(a[0], b[0])
    for k in ("step_size", "traj_length", "accept_prob", "num_leaves", "lockstep_leapfrogs"):
        assert torch.equal(sa[k][0], sb[k][0]), k
    assert (sa["num_leaves"][1] == 1).all() and (sb["num_leaves"][1] == 1).all()


def test_fit_batched_routes_per_series_with_a_ragged_chunk():
    x, sign = tayal_batch(3, 40, seed=6, device="cpu")
    cfg = ChEESConfig(num_warmup=10, num_samples=4, num_chains=2, max_leapfrogs=6,
                      shared_adaptation=False)
    qs, st = fit_batched(TayalHHMM(), {"x": x, "sign": sign}, cfg, chunk_size=2, seed=1,
                         device="cpu")
    assert qs.shape == (3, 2, 4, TayalHHMM().n_free)
    assert st["lockstep_leapfrogs"].shape == (3, 14) and st["lockstep_efficiency"].shape == (3,)
    eps = st["step_size"][:, 0]
    assert len(set(eps.tolist())) == 3  # one step size a series
    assert torch.isfinite(qs).all()


def _sorted_phi(model, qs):
    """Label-invariant statistics: phi rows sorted by phi[:, 0]."""
    phi = model.unpack(torch.as_tensor(np.array(qs), dtype=torch.float32))[0]["phi_k"]
    order = torch.argsort(phi[..., 0], dim=-1)
    return torch.gather(phi, -2, order[..., None].expand(phi.shape)).numpy()


@pytest.mark.slow
def test_posterior_matches_jax_per_series_arm():
    rng = np.random.default_rng(11)
    K, L, T, B = 2, 3, 300, 2
    phi = np.array([[0.8, 0.15, 0.05], [0.1, 0.2, 0.7]])
    xs = np.zeros((B, T), np.int64)
    for b in range(B):
        z = 0
        for t in range(T):
            z = z if rng.random() < 0.9 else 1 - z
            xs[b, t] = rng.choice(L, p=phi[z])
    cfg = dict(num_warmup=300, num_samples=400, num_chains=4, max_leapfrogs=32,
               shared_adaptation=False)
    jqs, _ = j_fit_batched(JMultinomialHMM(K, L), {"x": xs}, jax.random.PRNGKey(3),
                           JChEESConfig(**cfg))
    model = MultinomialHMM(K, L)
    qs, st = fit_batched(model, {"x": xs}, ChEESConfig(**cfg), seed=3, device="cpu")
    assert st["chain_healthy"].all()
    got, want = _sorted_phi(model, qs), _sorted_phi(model, jqs)  # [B, C, S, K, L]
    for b in range(B):
        for k in range(K):
            for l in range(L):
                g, w = got[b, ..., k, l], want[b, ..., k, l]
                mcse = np.hypot(g.std() / np.sqrt(max(ess(g), 1.0)),
                                w.std() / np.sqrt(max(ess(w), 1.0)))
                assert abs(g.mean() - w.mean()) < 4 * mcse + 1e-3, (b, k, l)
