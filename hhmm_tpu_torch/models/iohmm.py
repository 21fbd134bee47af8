"""Input-output HMM models (counterpart of ``hhmm_tpu/models/iohmm.py``),
the behaviour of `iohmm-reg/stan/iohmm-reg.stan`,
`iohmm-mix/stan/iohmm-mix.stan`, `iohmm-mix/stan/iohmm-hmix.stan` and
`iohmm-mix/stan/iohmm-hmix-lite.stan`.

Shared transition structure (`iohmm-reg.stan:40-49`): at each step a
single K-vector ``a_t = softmax_j(u_t · w_j)``, input-driven and
independent of the previous state (the reference's rank-1
simplification, `hassan2005/main.Rmd:758`). Two ways to apply it in the
forward recursion:

- ``trans_mode="stan"`` (default): the reference's own, which indexes
  the vector by the *previous* state ``i`` (`iohmm-reg.stan:71`:
  ``unalpha[t-1,i] + log(A_ij[t][i]) + oblik[t][j]``);
- ``trans_mode="gen"``: the vector is a distribution over the
  *destination* state ``j``, as the simulator draws it
  (:func:`~hhmm_tpu_torch.sim.iohmm.iohmm_sim`); use it for recovery and
  calibration tests.

Both are rank-1 time-varying transition matrices ``[..., T-1, K, K]``
(:meth:`_IOHMMBase.build`) for the scans of ``kernels/filtering.py``.
The reference's backward pass uses the destination-indexed convention
whatever its forward does (`iohmm-reg.stan:94`); here backward and
smoothing always follow the forward's convention, as in the JAX package
(its `tests/test_models.py::test_iohmm_backward_convention_quantified`
measures the consequence: the reference's gamma equals its filtered
probabilities, this gamma genuinely smooths).

The sampler's hot loop takes :meth:`_IOHMMBase.build_vg`, which folds
the rank-1 factor into the emissions with ``log_A = 0``: the model is
then homogeneous and every value-and-grad call runs the ``FWD`` +
``VG_BWD`` kernel pair on the card. The fold preserves only the final
log-likelihood and its gradient, so ``generated``, ``oblik_t`` and
``state_draws`` keep to :meth:`build` (``gate_keys`` stays ``None``:
``state_draws`` takes the Gumbel-max FFBS for the time-varying
``log_A``, the JAX package's route).

Priors: `iohmm-reg.stan:113-121` (w, b ~ N(0, 5), s ~ half-N(0, 3));
`iohmm-mix.stan:124-126` (w ~ N(0, 5), mu ~ N(0, 10), s ~ half-N(0, 3));
the hmix variants take the reference's 9-vector ``hyperparams``
(`iohmm-hmix.stan:10,124-135`): w ~ N(h1, h2), mu_kl[j] ~
N(hypermu_k[j], h3), s ~ half-N(h4, h5), lambda ~ Beta(h6, h7)
elementwise, hypermu ~ N(h8, h9) with an ordered[K] constraint.

Batch-native: parameters carry leading lane axes; ``x`` and ``mask``
are ``[..., T]`` and ``u`` is ``[..., T, M]`` (``event_ndim``), each
with a prefix of the parameters' axes. No ``gibbs_update``: the Gibbs
sampler refuses these models.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike
from hhmm_tpu_torch.core import dists
from hhmm_tpu_torch.core.bijectors import Bijector, Identity, Ordered, Positive, Simplex
from hhmm_tpu_torch.core.lmath import safe_log
from hhmm_tpu_torch.kernels.filtering import forward_filter
from hhmm_tpu_torch.models.base import BaseHMMModel, Params, draw_lanes

__all__ = ["IOHMMReg", "IOHMMMix", "IOHMMHMix", "IOHMMHMixLite", "betaln"]


def betaln(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``log B(a, b) = lgamma(a) + lgamma(b) - lgamma(a + b)``."""
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _host64(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64)


class _IOHMMBase(BaseHMMModel):
    event_ndim = {"u": 2}

    def __init__(self, K: int, M: int, trans_mode: str = "stan"):
        if trans_mode not in ("stan", "gen"):
            raise ValueError("trans_mode must be 'stan' or 'gen'")
        self.K = K
        self.M = M
        self.trans_mode = trans_mode

    def _data(self, params: Params, data: Dict[str, torch.Tensor]):
        """``x [..., T]``, ``u [..., T, M]`` in the parameters' dtype and
        ``mask [..., T]`` (or None), aligned to the parameters' leading
        axes."""
        p = params["p_1k"]
        lanes = self._lanes(data, tuple(p.shape[:-1]))
        mask = lanes.get("mask")
        return (
            lanes["x"].to(p.dtype),
            lanes["u"].to(p.dtype),
            None if mask is None else mask.to(p.dtype),
        )

    def _log_a(self, params: Params, u: torch.Tensor) -> torch.Tensor:
        """Per-step transition vector ``log softmax(u_t · w)`` ``[..., T,
        K]``, the one source of the transition for both builds."""
        return torch.log_softmax(u @ params["w_km"].transpose(-1, -2), dim=-1)

    def _log_A_t(self, params: Params, u: torch.Tensor) -> torch.Tensor:
        """Rank-1 time-varying transition matrices ``[..., T-1, K, K]``."""
        log_a = self._log_a(params, u)[..., 1:, :]  # the vectors of t = 1..T-1
        shape = log_a.shape + (self.K,)
        if self.trans_mode == "stan":  # indexed by the previous state i (`iohmm-reg.stan:71`)
            return log_a[..., :, None].expand(shape)
        return log_a[..., None, :].expand(shape)  # by the destination j

    def _log_obs(self, params: Params, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _pack_host(self, params: Dict[str, np.ndarray], device) -> torch.Tensor:
        """Pack an init's float64 host values in float32 (the JAX package
        packs its numpy inits in float32 too)."""
        return self.pack(
            {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in params.items()}
        )

    def build(self, params: Params, data: Dict[str, torch.Tensor]):
        x, u, mask = self._data(params, data)
        return (
            safe_log(params["p_1k"]),
            self._log_A_t(params, u),
            self._log_obs(params, x, u),
            mask,
        )

    def build_vg(self, params: Params, data: Dict[str, torch.Tensor]):
        """Hot-loop build: the rank-1 transition folded into the
        emissions, so the homogeneous value-and-grad kernels apply.

        With every row of ``A_t`` identical (stan: constant over the
        destination j; gen: constant over the source i) the forward
        update factorizes as ``alpha_t = logsumexp(alpha_{t-1}) +
        (a-term) + obs_t``, the homogeneous recursion with ``log_A = 0``
        and the per-step vector folded into an effective emission:

        - gen:  ``obs'[t] = obs[t] + log a_t`` (t >= 1);
        - stan: ``a_t`` is indexed by the PREVIOUS state, so it attaches
          to step t-1: ``obs'[t-1] = obs[t-1] + mask[t] * log a_t`` (the
          mask factor drops the transition terms of padding steps, which
          the masked time-varying recursion never applies).

        Only the final alpha (the log-likelihood) and its gradient are
        preserved, not the intermediate filters. For T=1 nothing is
        folded."""
        x, u, mask = self._data(params, data)
        log_pi = safe_log(params["p_1k"])
        log_obs = self._log_obs(params, x, u)
        if log_obs.shape[-2] > 1:
            log_a = self._log_a(params, u)
            nxt = log_a[..., 1:, :]
            if self.trans_mode == "stan":
                if mask is not None:
                    nxt = nxt * mask[..., 1:, None]
                log_obs = torch.cat([log_obs[..., :-1, :] + nxt, log_obs[..., -1:, :]], dim=-2)
            else:
                log_obs = torch.cat([log_obs[..., :1, :], log_obs[..., 1:, :] + nxt], dim=-2)
        log_A0 = log_obs.new_zeros(log_pi.shape[:-1] + (self.K, self.K))
        return log_pi, log_A0, log_obs, mask

    def oblik_t(self, params: Params, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-step observation log-likelihood weighted by the normalized
        filter, ``[..., T]``: what the Hassan forecaster reads
        (`iohmm-hmix.stan:118-121`: ``logsumexp(log alpha_tk[t] +
        oblik_tk[t])``), through the time-varying forward scan."""
        log_pi, log_A, log_obs, mask = self.build(params, data)
        log_alpha, _ = forward_filter(log_pi, log_A, log_obs, mask)
        log_alpha_norm = torch.log_softmax(log_alpha, dim=-1)
        return torch.logsumexp(log_alpha_norm + log_obs, dim=-1)


class IOHMMReg(_IOHMMBase):
    """Linear-regression emissions: ``x_t ~ N(u_t · b_j, s_j)``
    (`iohmm-reg.stan:51-57`)."""

    def specs(self) -> List[Tuple[str, Bijector]]:
        K, M = self.K, self.M
        return [
            ("p_1k", Simplex((K,))),
            ("w_km", Identity((K, M))),
            ("b_km", Identity((K, M))),
            ("s_k", Positive((K,), lower=1e-4)),
        ]

    def _log_obs(self, params, x, u):
        mean = u @ params["b_km"].transpose(-1, -2)  # [..., T, K]
        return dists.normal_logpdf(x[..., None], mean, params["s_k"][..., None, :])

    def log_prior(self, params: Params) -> torch.Tensor:
        return (
            dists.normal_logpdf(params["w_km"], 0.0, 5.0).sum((-2, -1))
            + dists.normal_logpdf(params["b_km"], 0.0, 5.0).sum((-2, -1))
            + dists.normal_logpdf(params["s_k"], 0.0, 3.0).sum(-1)
        )

    def init_unconstrained(self, generator: torch.Generator, data) -> torch.Tensor:
        """Residual-clustering init: global OLS, k-means on the
        residuals, per-cluster OLS; it separates chains from the
        collapsed all-states-equal mode (the IOHMM analog of the
        reference's k-means inits, `hmm/main.R:37-47`). The clustering
        is the JAX package's (``kmeans2(..., seed=0)``); only the jitter
        (``0.2 N(0, 1)`` on ``b``, then ``0.1 N(0, 1)`` for ``w``) comes
        from ``generator``."""
        from scipy.cluster.vq import kmeans2

        u = _host64(data["u"])
        x = _host64(data["x"])
        K, M = self.K, self.M
        beta, *_ = np.linalg.lstsq(u, x, rcond=None)
        resid = x - u @ beta
        centers, labels = kmeans2(resid, K, minit="++", seed=0)
        order = np.argsort(centers)
        b = np.tile(beta, (K, 1))
        s = np.full(K, max(resid.std(), 1e-2))
        for rank, k in enumerate(order):
            m = labels == k
            if m.sum() > M + 1:
                bk, *_ = np.linalg.lstsq(u[m], x[m], rcond=None)
                b[rank] = bk
                s[rank] = max((x[m] - u[m] @ bk).std(), 1e-2)
            else:
                b[rank, 0] = beta[0] + centers[k]
        dev = generator.device
        jit = 0.2 * torch.randn((K, M), generator=generator, device=dev).double().cpu().numpy()
        w = 0.1 * torch.randn((K, M), generator=generator, device=dev).double().cpu().numpy()
        params = {"p_1k": np.full(K, 1.0 / K), "w_km": w, "b_km": b + jit * s[:, None], "s_k": s}
        return self._pack_host(params, dev)


class _MixEmissions:
    """Per-state L-component Gaussian-mixture emission log-likelihoods
    (`iohmm-mix.stan:53-65`)."""

    def _log_obs(self, params, x, u):
        log_lam = safe_log(params["lambda_kl"])[..., None, :, :]  # [..., 1, K, L]
        return dists.mixture_normal_logpdf(
            x[..., None], log_lam, params["mu_kl"][..., None, :, :], params["s_kl"][..., None, :, :]
        )


class IOHMMMix(_MixEmissions, _IOHMMBase):
    """Flat-prior mixture model (`iohmm-mix/stan/iohmm-mix.stan`)."""

    def __init__(self, K: int, M: int, L: int, trans_mode: str = "stan"):
        super().__init__(K, M, trans_mode)
        self.L = L

    def specs(self) -> List[Tuple[str, Bijector]]:
        K, M, L = self.K, self.M, self.L
        return [
            ("p_1k", Simplex((K,))),
            ("w_km", Identity((K, M))),
            ("lambda_kl", Simplex((K, L))),
            ("mu_kl", Ordered((K, L))),
            ("s_kl", Positive((K, L))),
        ]

    def log_prior(self, params: Params) -> torch.Tensor:
        return (
            dists.normal_logpdf(params["w_km"], 0.0, 5.0).sum((-2, -1))
            + dists.normal_logpdf(params["mu_kl"], 0.0, 10.0).sum((-2, -1))
            + dists.normal_logpdf(params["s_kl"], 0.0, 3.0).sum((-2, -1))
        )


class IOHMMHMix(IOHMMMix):
    """Hierarchical mixture: an ``ordered[K] hypermu_k`` hyperprior over
    the per-state component means (added because the flat model
    diverged, `log.md:554`), priors driven by the 9-vector
    ``hyperparams`` (`iohmm-hmix.stan:124-135`), kept as a float64
    numpy array and cast to the parameters' dtype where used."""

    def __init__(self, K, M, L, hyperparams, trans_mode: str = "stan"):
        super().__init__(K, M, L, trans_mode)
        hp = np.asarray(hyperparams, dtype=np.float64)
        if hp.shape != (9,):
            raise ValueError(
                f"hyperparams must have 9 elements (got {hp.shape}); the "
                "reference's iohmm-mix/main.R:31 passes 7, a known "
                "defect (SURVEY.md §2.8 item 5), not replicated here"
            )
        self.hyperparams = hp

    def specs(self) -> List[Tuple[str, Bijector]]:
        return super().specs() + [("hypermu_k", Ordered((self.K,)))]

    def log_prior(self, params: Params) -> torch.Tensor:
        lam = params["lambda_kl"]
        h = torch.as_tensor(self.hyperparams, dtype=lam.dtype, device=lam.device)
        log_beta_pdf = (
            (h[5] - 1.0) * safe_log(lam) + (h[6] - 1.0) * safe_log(1.0 - lam) - betaln(h[5], h[6])
        )
        return (
            dists.normal_logpdf(params["w_km"], h[0], h[1]).sum((-2, -1))
            + dists.normal_logpdf(params["mu_kl"], params["hypermu_k"][..., None], h[2]).sum((-2, -1))
            + dists.normal_logpdf(params["s_kl"], h[3], h[4]).sum((-2, -1))
            + log_beta_pdf.sum((-2, -1))
            + dists.normal_logpdf(params["hypermu_k"], h[7], h[8]).sum(-1)
        )

    def init_unconstrained(self, generator: torch.Generator, data) -> torch.Tensor:
        """Nested k-means init (reference: `iohmm-mix/R/iohmm-mix-init.R:
        2-22`): outer k-means over x gives K state clusters ordered by
        center, inner k-means per cluster gives L ordered component
        means and sds; the clustering is the JAX package's, the jitter
        (``0.05 N(0, 1)`` on ``mu``) comes from ``generator``."""
        from scipy.cluster.vq import kmeans2

        x = _host64(data["x"])
        K, L, M = self.K, self.L, self.M
        centers, labels = kmeans2(x, K, minit="++", seed=0)
        order = np.argsort(centers)
        mu_kl = np.zeros((K, L))
        s_kl = np.full((K, L), max(x.std(), 1e-2))
        for rank, k in enumerate(order):
            xk = x[labels == k]
            if len(xk) >= L:
                c2, l2 = kmeans2(xk, L, minit="++", seed=0)
                o2 = np.argsort(c2)
                mu_kl[rank] = np.sort(c2)
                for r2, l in enumerate(o2):
                    xl = xk[l2 == l]
                    if len(xl) > 1:
                        s_kl[rank, r2] = max(xl.std(), 1e-2)
            else:
                mu_kl[rank] = np.sort(xk.mean() + np.linspace(-1, 1, L) * x.std())
        mu_kl = np.sort(mu_kl, axis=1)
        # strictify the ordering for the bijector inverse (ties would fail it)
        mu_kl += np.arange(L)[None, :] * 1e-4
        dev = generator.device
        jit = 0.05 * torch.randn((K, L), generator=generator, device=dev).double().cpu().numpy()
        mu_kl = np.sort(mu_kl + jit * s_kl, axis=1)
        params = {
            "p_1k": np.full(K, 1.0 / K),
            "w_km": np.zeros((K, M)),
            "lambda_kl": np.full((K, L), 1.0 / L),
            "mu_kl": mu_kl,
            "s_kl": s_kl,
            "hypermu_k": np.sort(mu_kl.mean(axis=1)) + np.arange(K) * 1e-4,
        }
        return self._pack_host(params, dev)


class IOHMMHMixLite(IOHMMHMix):
    """Walk-forward fast path (`iohmm-mix/stan/iohmm-hmix-lite.stan`):
    the same parameters, priors and forward-only likelihood as
    :class:`IOHMMHMix`, with the generated quantities reduced to
    ``oblik_t``, the reference's minimum for forecasting (`log.md:572`,
    `hassan2005/main.Rmd:795`)."""

    def generated(
        self, theta_draws: torch.Tensor, data: Dict[str, torch.Tensor], device: DeviceLike = None
    ) -> Dict[str, torch.Tensor]:
        """``{"oblik_t": [..., T]}`` for draws ``[..., n_free]``; data as
        in :meth:`BaseHMMModel.generated` (``[T]`` / ``[T, M]`` for every
        draw, or a leading series axis; a ``mask`` for ragged series).
        Every draw is one lane of one time-varying forward scan."""
        lead, flat, lanes = draw_lanes(theta_draws, data, device, self.event_ndim)
        params, _ = self.unpack(flat)
        out = self.oblik_t(params, lanes)
        return {"oblik_t": out.reshape(lead + out.shape[1:])}
