"""Explicit-duration hidden semi-Markov models (counterpart of
``hhmm_tpu/models/hsmm.py``): :class:`GaussianHSMM` and
:class:`MultinomialHSMM`.

A duration pmf ``dur_kd [K, Dmax]`` on every regime, realized as an
ordinary HMM on the ``K * Dmax`` count-down expansion
(``kernels/duration.py``, Yu 2010), so the port's whole stack runs
unchanged on the expanded chain: the FFBS, value-and-grad and decode
kernels, ``sample_gibbs`` through :meth:`gibbs_update`, NUTS and ChEES
through ``make_vg``, ``generated`` and ``state_draws``. The models expose
``K`` (regimes) and ``n_states = K * Dmax`` (the width every kernel
runs); above ``K * Dmax = 128`` the kernels take their big layout
(``csrc/big_core.cuh``).

Degeneracy contract: at ``Dmax = 1`` the duration simplex has no free
parameter and the expansions are bitwise identities, so a ``Dmax = 1``
:class:`GaussianHSMM` is the port's :class:`GaussianHMM`: the same
terms, filter log-likelihoods, smoothed posteriors and FFBS draws.

Sticky transitions (Fox et al. 2011): ``sticky_kappa`` adds ``kappa``
pseudo-counts to the transition prior's diagonal (in the HSMM: re-enter
the same regime with a fresh duration).

Batch-native: parameters carry leading lane axes, data ``x [..., T]`` a
prefix of them (``models/base.py::broadcast_data``). The Gibbs
statistics of a batch of expanded paths are one-hot products (exact
integer counts in float32), no scatter.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hhmm_tpu_torch.core import dists
from hhmm_tpu_torch.core.bijectors import Bijector, Ordered, Positive, Simplex
from hhmm_tpu_torch.core.lmath import safe_log
from hhmm_tpu_torch.infer.gibbs import dirichlet, emission_counts
from hhmm_tpu_torch.kernels import duration
from hhmm_tpu_torch.models.base import BaseHMMModel, Params, broadcast_data
from hhmm_tpu_torch.models.gaussian_hmm import NIGPrior, nig_emission_draw
from hhmm_tpu_torch.models.tayal import _Emissions

__all__ = ["GaussianHSMM", "MultinomialHSMM"]


class _HSMMBase(BaseHMMModel):
    """The count-down expansion and the regime / duration statistics of
    expanded paths; subclasses supply the per-regime emissions
    (:meth:`_log_obs_k`, ``[..., T, K]``) and their parameter blocks."""

    def __init__(self, K: int, Dmax: int, sticky_kappa: float = 0.0):
        if K < 1 or Dmax < 1:
            raise ValueError(f"need K >= 1 and Dmax >= 1, got ({K}, {Dmax})")
        if sticky_kappa < 0.0:
            raise ValueError("sticky_kappa must be >= 0")
        self.K = K
        self.Dmax = Dmax
        self.sticky_kappa = float(sticky_kappa)

    @property
    def n_states(self) -> int:
        """Width of the expanded chain the kernels run."""
        return self.K * self.Dmax

    def _log_obs_k(self, params: Params, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def build(self, params: Params, data: Dict[str, torch.Tensor]):
        log_dur = safe_log(params["dur_kd"])
        lead = tuple(params["p_1k"].shape[:-1])
        return (
            duration.expand_initial(safe_log(params["p_1k"]), log_dur),
            duration.expand_transition(safe_log(params["A_ij"]), log_dur),
            duration.expand_obs(self._log_obs_k(params, data), self.Dmax),
            broadcast_data(data.get("mask"), lead),
        )

    def log_prior(self, params: Params) -> torch.Tensor:
        A = params["A_ij"]
        lp = torch.zeros(A.shape[:-2], dtype=A.dtype, device=A.device)
        if self.sticky_kappa:
            lp = lp + self.sticky_kappa * safe_log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)
        return lp

    def regime_probs(self, probs):
        """Expanded posterior probabilities ``[..., K*Dmax]`` → ``[..., K]``."""
        return duration.collapse_probs(probs, self.Dmax)

    def regime_path(self, z):
        """Expanded state paths → regime paths ``[..., T]``."""
        return duration.regime_path(z, self.Dmax)

    def _hsmm_counts(self, z: torch.Tensor, mask: Optional[torch.Tensor]):
        """Regime and duration statistics of expanded paths ``z [..., T]``.
        Step t is an entry step iff t = 0 or the previous count hit 0.
        Returns ``(zoh [..., T, K]`` mask-weighted regime one-hots,
        ``n_trans [..., K, K]`` regime transitions into entry steps,
        ``n_dur [..., K, Dmax]`` duration choices at entry steps)."""
        K, Dmax = self.K, self.Dmax
        zoh = torch.nn.functional.one_hot(duration.regime_path(z, Dmax), K).to(torch.float32)
        zc = z % Dmax  # remaining count at each step
        entry = torch.cat([torch.ones_like(zc[..., :1], dtype=torch.float32),
                           (zc[..., :-1] == 0).to(torch.float32)], dim=-1)
        w_pair, w_entry, zoh_m = entry[..., 1:], entry, zoh
        if mask is not None:
            m = mask.to(torch.float32)
            w_pair = w_pair * m[..., 1:]
            w_entry = w_entry * m
            zoh_m = zoh * m[..., None]
        n_trans = (zoh[..., :-1, :] * w_pair[..., None]).transpose(-1, -2) @ zoh[..., 1:, :]
        coh = torch.nn.functional.one_hot(zc, Dmax).to(torch.float32)
        n_dur = (zoh * w_entry[..., None]).transpose(-1, -2) @ coh
        return zoh_m, n_trans, n_dur

    def _draw_chain_params(self, generator: torch.Generator, zoh0, n_trans, n_dur) -> Params:
        conc_A = 1.0 + n_trans
        if self.sticky_kappa:
            conc_A = conc_A + self.sticky_kappa * torch.eye(self.K, device=conc_A.device)
        return {
            "p_1k": dirichlet(generator, 1.0 + zoh0),
            "A_ij": dirichlet(generator, conc_A),
            "dur_kd": dirichlet(generator, 1.0 + n_dur),
        }


class GaussianHSMM(_HSMMBase):
    """Gaussian-emission explicit-duration HSMM: ``p_1k [K]``, ``A_ij [K,
    K]``, ``dur_kd [K, Dmax]`` simplices, ``ordered[K] mu_k`` and
    ``sigma_k > 1e-4`` (the :class:`GaussianHMM` emission block, whose
    NIG conjugate draw it shares)."""

    def __init__(
        self,
        K: int,
        Dmax: int,
        nig_prior: Optional[NIGPrior] = None,
        sticky_kappa: float = 0.0,
    ):
        super().__init__(K, Dmax, sticky_kappa)
        self.nig_prior = nig_prior

    def specs(self) -> List[Tuple[str, Bijector]]:
        K, Dmax = self.K, self.Dmax
        return [
            ("p_1k", Simplex((K,))),
            ("A_ij", Simplex((K, K))),
            ("dur_kd", Simplex((K, Dmax))),
            ("mu_k", Ordered((K,))),
            ("sigma_k", Positive((K,), lower=1e-4)),
        ]

    def _log_obs_k(self, params: Params, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        mu, sigma = params["mu_k"], params["sigma_k"]
        x = broadcast_data(data["x"], tuple(mu.shape[:-1])).to(mu.dtype)
        return dists.normal_logpdf(x[..., None], mu[..., None, :], sigma[..., None, :])

    def log_prior(self, params: Params) -> torch.Tensor:
        lp = super().log_prior(params)
        if self.nig_prior is not None:
            lp = lp + self.nig_prior.log_density(params["mu_k"], params["sigma_k"])
        return lp

    def gibbs_update(
        self,
        generator: torch.Generator,
        z: torch.Tensor,
        data: Dict[str, torch.Tensor],
        params: Params,
    ) -> Params:
        """Conjugate block on the expanded paths ``z [..., T]`` (the FFBS
        draw of ``infer/gibbs.py``): the joint NIG emission draw with the
        exact ordered-cone step (``models/gaussian_hmm.py::
        nig_emission_draw``) on the collapsed regime assignment, then
        Dirichlet rows for ``p_1k``, ``A_ij`` (sticky diagonal) and
        ``dur_kd`` from :meth:`_hsmm_counts`."""
        if self.nig_prior is None:
            raise ValueError(
                "GaussianHSMM Gibbs needs a proper conjugate prior: construct "
                "with GaussianHSMM(K, Dmax, nig_prior=NIGPrior(...))"
            )
        x = data["x"].to(torch.float32)
        zoh_m, n_trans, n_dur = self._hsmm_counts(z, data.get("mask"))
        mu, sigma = nig_emission_draw(
            self.nig_prior, generator, x, zoh_m, params["mu_k"], params["sigma_k"]
        )
        out = self._draw_chain_params(generator, zoh_m[..., 0, :], n_trans, n_dur)
        out["mu_k"] = mu
        out["sigma_k"] = sigma
        return out

    def init_unconstrained(
        self, generator: torch.Generator, data: Dict[str, torch.Tensor]
    ) -> torch.Tensor:
        """k-means emission init for one series on the host (the
        :class:`GaussianHMM` recipe, ``hmm/main.R:37-47``) with uniform
        chain and duration simplices; ``theta [n_free]`` on the
        generator's device."""
        from scipy.cluster.vq import kmeans2

        x = torch.as_tensor(data["x"]).detach().cpu().numpy()
        mask = data.get("mask")
        if mask is not None:
            x = x[torch.as_tensor(mask).detach().cpu().numpy() > 0]
        K, Dmax = self.K, self.Dmax
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
            "dur_kd": np.full((K, Dmax), 1.0 / Dmax),
            "mu_k": np.sort(mu + jitter * sigma),
            "sigma_k": sigma,
        }
        return self.pack(
            {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in params.items()}
        )


class MultinomialHSMM(_HSMMBase):
    """Discrete-emission explicit-duration HSMM: ``simplex[L] phi_k`` per
    regime (the ``models/multinomial_hmm.py`` emission block) on the
    count-down expansion."""

    def __init__(self, K: int, Dmax: int, L: int, sticky_kappa: float = 0.0):
        super().__init__(K, Dmax, sticky_kappa)
        self.L = L

    def specs(self) -> List[Tuple[str, Bijector]]:
        K, Dmax, L = self.K, self.Dmax, self.L
        return [
            ("p_1k", Simplex((K,))),
            ("A_ij", Simplex((K, K))),
            ("dur_kd", Simplex((K, Dmax))),
            ("phi_k", Simplex((K, L))),
        ]

    def _log_obs_k(self, params: Params, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``log_obs[..., t, k] = log phi[..., k, x_t]`` (a gather with a
        run-to-run deterministic backward, ``models/tayal.py``)."""
        phi = params["phi_k"]
        x = broadcast_data(data["x"], tuple(phi.shape[:-2])).long()
        return _Emissions.apply(safe_log(phi), x)

    def gibbs_update(
        self,
        generator: torch.Generator,
        z: torch.Tensor,
        data: Dict[str, torch.Tensor],
        params: Optional[Params] = None,
    ) -> Params:
        """Flat-Dirichlet conjugate block on the expanded paths: emission
        counts over the collapsed regime assignment, transition and
        duration counts over entry steps."""
        mask = data.get("mask")
        zoh_m, n_trans, n_dur = self._hsmm_counts(z, mask)
        c_emis = emission_counts(self.regime_path(z), data["x"].long(), self.K, self.L, mask)
        out = self._draw_chain_params(generator, zoh_m[..., 0, :], n_trans, n_dur)
        out["phi_k"] = dirichlet(generator, 1.0 + c_emis)
        return out
