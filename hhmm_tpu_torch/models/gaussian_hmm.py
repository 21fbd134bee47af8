"""Gaussian-emission HMM (counterpart of
``hhmm_tpu/models/gaussian_hmm.py``), the behaviour of
`hmm/stan/hmm.stan`.

Parameters (`hmm/stan/hmm.stan:14-22`): initial simplex ``p_1k``,
transition simplex rows ``A_ij``, ``ordered[K] mu_k`` (the
identifiability constraint, `hmm/stan/hmm.stan:20`), ``sigma_k > 1e-4``.
Without a prior the target is the marginalized forward log-likelihood
alone (flat priors on the constrained space). A conjugate
Normal–Inverse-Gamma emission prior (:class:`NIGPrior`) enables the
blocked Gibbs sampler, and ``log_prior`` adds the same terms to the HMC
target, so both samplers target one posterior.

Batch-native: parameters carry leading lane axes, data ``x [..., T]``
a prefix of them (``models/base.py::broadcast_data``). The Gibbs update
draws every lane at once from the sampler's ``torch.Generator``
(``torch._standard_gamma`` and ``torch.randn``). The k-means init
mirrors ``init_fun`` of the reference's `hmm/main.R:37-47` on the
host, as the JAX model does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hhmm_tpu_torch.core import dists
from hhmm_tpu_torch.core.bijectors import Bijector, Ordered, Positive, Simplex
from hhmm_tpu_torch.core.lmath import safe_log
from hhmm_tpu_torch.infer.gibbs import dirichlet, transition_counts
from hhmm_tpu_torch.models.base import BaseHMMModel, Params, broadcast_data

__all__ = ["GaussianHMM", "NIGPrior", "nig_emission_draw"]


@dataclass(frozen=True)
class NIGPrior:
    """Conjugate emission prior: ``sigma_k^2 ~ InvGamma(a0, b0)``,
    ``mu_k | sigma_k ~ N(m0, sigma_k^2 / kappa0)`` iid per state,
    restricted to the ordered cone (the distribution of the sorted
    draws; the likelihood is permutation-symmetric, so the restriction
    only renormalizes by the constant K!)."""

    m0: float = 0.0
    kappa0: float = 0.2
    a0: float = 2.5
    b0: float = 1.5

    def log_density(self, mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        """Log prior summed over the last (state) axis, as a density in
        (mu, sigma) — std, not variance: it includes the dv/dsigma =
        2 sigma Jacobian."""
        v = sigma * sigma
        lp_v = (
            self.a0 * math.log(self.b0)
            - math.lgamma(self.a0)
            - (self.a0 + 1.0) * torch.log(v)
            - self.b0 / v
        ) + torch.log(2.0 * sigma)
        lp_mu = dists.normal_logpdf(mu, self.m0, sigma / math.sqrt(self.kappa0))
        return (lp_v + lp_mu).sum(-1)

    def sample(
        self, generator: torch.Generator, K: int, shape: Tuple[int, ...] = ()
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact ordered-prior draws ``(mu, sigma) [*shape, K]``: iid NIG
        per state, then sorted by mu (the sort is the ordered-cone
        restriction)."""
        dev = generator.device
        a = torch.full(tuple(shape) + (K,), self.a0, device=dev)
        v = self.b0 / torch._standard_gamma(a, generator=generator)
        sigma = torch.sqrt(v)
        eps = torch.randn(a.shape, generator=generator, device=dev)
        mu = self.m0 + sigma / math.sqrt(self.kappa0) * eps
        mu, order = torch.sort(mu, dim=-1)
        return mu, torch.gather(sigma, -1, order)


def nig_emission_draw(
    pr: NIGPrior,
    generator: torch.Generator,
    x: torch.Tensor,  # [..., T]
    zoh: torch.Tensor,  # [..., T, K], mask-weighted one-hot assignment
    mu_cur: torch.Tensor,  # [..., K]
    sigma_cur: torch.Tensor,  # [..., K]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint NIG emission draw per lane with the exact ordered-cone step
    (see :meth:`GaussianHMM.gibbs_update`): sufficient statistics from
    ``zoh``, a joint ``(sigma^2, mu)`` posterior draw per state, accepted
    iff the lane's mu is ordered, else the lane keeps ``(mu_cur,
    sigma_cur)``."""
    n_k = zoh.sum(-2)
    sum_x = (x[..., None] * zoh).sum(-2)
    sum_x2 = ((x * x)[..., None] * zoh).sum(-2)

    xbar = torch.where(n_k > 0, sum_x / n_k.clamp_min(1.0), torch.full_like(n_k, pr.m0))
    scatter = (sum_x2 - n_k * xbar * xbar).clamp_min(0.0)
    kappa_n = pr.kappa0 + n_k
    m_n = (pr.kappa0 * pr.m0 + sum_x) / kappa_n
    a_n = pr.a0 + 0.5 * n_k
    b_n = pr.b0 + 0.5 * scatter + 0.5 * pr.kappa0 * n_k * (xbar - pr.m0) ** 2 / kappa_n
    v = b_n / torch._standard_gamma(a_n, generator=generator)
    sigma = torch.sqrt(v)
    eps = torch.randn(m_n.shape, generator=generator, dtype=m_n.dtype, device=m_n.device)
    mu = m_n + sigma / torch.sqrt(kappa_n) * eps

    ordered = (mu[..., 1:] > mu[..., :-1]).all(-1, keepdim=True)
    mu = torch.where(ordered, mu, mu_cur)
    sigma = torch.where(ordered, sigma, sigma_cur)
    return mu, sigma.clamp_min(2e-4)


class GaussianHMM(BaseHMMModel):
    def __init__(
        self,
        K: int,
        nig_prior: Optional[NIGPrior] = None,
        sticky_kappa: float = 0.0,
    ):
        """``sticky_kappa``: sticky-transition concentration (Fox et al.
        2011's kappa as a plain Dirichlet pseudo-count): the transition
        prior becomes ``A_k· ~ Dir(1 + kappa * e_k)``, which adds ``kappa
        * log A_kk`` to the HMC target and ``kappa`` to the Gibbs
        posterior's diagonal concentration. ``0.0`` is the flat-prior
        model."""
        if sticky_kappa < 0.0:
            raise ValueError("sticky_kappa must be >= 0")
        self.K = K
        self.nig_prior = nig_prior
        self.sticky_kappa = float(sticky_kappa)

    def specs(self) -> List[Tuple[str, Bijector]]:
        K = self.K
        return [
            ("p_1k", Simplex((K,))),
            ("A_ij", Simplex((K, K))),
            ("mu_k", Ordered((K,))),
            ("sigma_k", Positive((K,), lower=1e-4)),
        ]

    def build(self, params: Params, data: Dict[str, torch.Tensor]):
        mu, sigma = params["mu_k"], params["sigma_k"]
        lead = tuple(mu.shape[:-1])
        x = broadcast_data(data["x"], lead).to(mu.dtype)
        log_obs = dists.normal_logpdf(x[..., None], mu[..., None, :], sigma[..., None, :])
        return (
            safe_log(params["p_1k"]),
            safe_log(params["A_ij"]),
            log_obs,
            broadcast_data(data.get("mask"), lead),
        )

    def log_prior(self, params: Params) -> torch.Tensor:
        mu = params["mu_k"]
        lp = torch.zeros(mu.shape[:-1], dtype=mu.dtype, device=mu.device)
        if self.nig_prior is not None:
            lp = lp + self.nig_prior.log_density(mu, params["sigma_k"])
        if self.sticky_kappa:
            diag = torch.diagonal(params["A_ij"], dim1=-2, dim2=-1)
            lp = lp + self.sticky_kappa * safe_log(diag).sum(-1)
        return lp

    def gibbs_update(
        self,
        generator: torch.Generator,
        z: torch.Tensor,
        data: Dict[str, torch.Tensor],
        params: Params,
    ) -> Params:
        """Conjugate parameter block for blocked Gibbs, every lane at once.

        Dirichlet(1) draws for ``p_1k`` and the ``A_ij`` rows (the Stan
        model's implicit flat simplex priors). The emission block is a
        joint draw from the per-state NIG posterior

            sigma_k^2 | z ~ InvGamma(a0 + n_k/2, b_n)
            mu_k | sigma_k^2, z ~ N(m_n, sigma_k^2 / (kappa0 + n_k))

        followed by the exact ordered-cone step: the target restricted
        to ``mu_1 < ... < mu_K`` is proportional to the unordered NIG
        product there, so an independence-MH move proposing the
        unordered joint draw accepts with probability 1 when ordered and
        0 otherwise (the lane keeps its emission parameters)."""
        if self.nig_prior is None:
            raise ValueError(
                "GaussianHMM Gibbs needs a proper conjugate prior: construct "
                "with GaussianHMM(K, nig_prior=NIGPrior(...))"
            )
        K = self.K
        x = data["x"].to(torch.float32)
        mask = data.get("mask")
        zoh = torch.nn.functional.one_hot(z, K).to(torch.float32)  # [..., T, K]
        if mask is not None:
            zoh = zoh * mask[..., None].to(torch.float32)
        mu, sigma = nig_emission_draw(
            self.nig_prior, generator, x, zoh, params["mu_k"], params["sigma_k"]
        )
        conc_A = 1.0 + transition_counts(z, K, mask)
        if self.sticky_kappa:
            conc_A = conc_A + self.sticky_kappa * torch.eye(K, device=conc_A.device)
        return {
            "p_1k": dirichlet(generator, 1.0 + zoh[..., 0, :]),
            "A_ij": dirichlet(generator, conc_A),
            "mu_k": mu,
            "sigma_k": sigma,
        }

    def init_unconstrained(
        self, generator: torch.Generator, data: Dict[str, torch.Tensor]
    ) -> torch.Tensor:
        """k-means init for one series on the host (`hmm/main.R:37-47`,
        as the JAX model: ``scipy.cluster.vq.kmeans2``, ``minit="++"``,
        ``seed=0``): ordered cluster centres, per-cluster standard
        deviations, uniform ``A`` and ``p_1k``; a ``0.1 sigma`` jitter
        from ``generator`` keeps chains apart. Returns ``theta
        [n_free]`` on the generator's device."""
        from scipy.cluster.vq import kmeans2

        x = torch.as_tensor(data["x"]).detach().cpu().numpy()
        mask = data.get("mask")
        if mask is not None:
            x = x[torch.as_tensor(mask).detach().cpu().numpy() > 0]
        K = self.K
        centers, labels = kmeans2(x.astype(np.float64), K, minit="++", seed=0)
        order = np.argsort(centers)
        mu = np.sort(centers)
        sigma = np.array(
            [max(x[labels == order[k]].std(), 1e-2) if (labels == order[k]).any() else x.std()
             for k in range(K)]
        )
        dev = generator.device
        jitter = 0.1 * torch.randn(K, generator=generator, device=dev).cpu().numpy()
        params = {
            "p_1k": np.full(K, 1.0 / K),
            "A_ij": np.full((K, K), 1.0 / K),
            "mu_k": np.sort(mu + jitter * sigma),
            "sigma_k": sigma,
        }
        return self.pack(
            {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in params.items()}
        )
