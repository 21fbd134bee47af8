"""Model base: named parameters with constraint bijectors (counterpart
of ``hhmm_tpu/models/base.py``'s parameter contract).

A model declares ``specs()`` — an ordered list of ``(name, Bijector)`` —
and the flat unconstrained vector ``theta [..., n_free]`` is the
concatenation of each bijector's free slice, in order, exactly as in the
JAX package, so draws and inits move between the two packages
unchanged (``hhmm_tpu_torch.convert``). Every method is batch-native
over the leading axes of ``theta``.

Data arrays ``[..., T]`` carry a prefix of the parameters' leading axes
(series, then chains, as the JAX package nests its vmaps):
:func:`broadcast_data` aligns them to the parameters' axes.

Generated quantities (:meth:`BaseHMMModel.generated`,
:meth:`BaseHMMModel.state_draws`) take every posterior draw of every
series as one flat batch of lanes (:func:`per_lane` lays the data out),
so one call launches each decode kernel once.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.core.bijectors import Bijector
from hhmm_tpu_torch.kernels.dispatch import ffbs_dispatch, smooth_dispatch, viterbi_dispatch
from hhmm_tpu_torch.kernels.vg import ForwardLoglik

__all__ = ["BaseHMMModel", "broadcast_data", "per_lane", "draw_lanes"]

Params = Dict[str, torch.Tensor]


def broadcast_data(
    v: Optional[torch.Tensor], lead: Tuple[int, ...], event_ndim: int = 1
) -> Optional[torch.Tensor]:
    """A data array ``[*prefix, *event]`` whose leading axes are a prefix
    of ``lead`` (``[B, T]`` against lanes ``[B, C]``, say), as a view
    ``[*lead, *event]``: the missing trailing lane axes are inserted as
    singletons and expanded. ``None`` passes through."""
    if v is None:
        return None
    prefix = tuple(v.shape[: v.ndim - event_ndim])
    event = tuple(v.shape[v.ndim - event_ndim :])
    if prefix != tuple(lead[: len(prefix)]):
        raise ValueError(
            f"data leading axes {prefix} are not a prefix of the parameters' {tuple(lead)}"
        )
    fill = (1,) * (len(lead) - len(prefix))
    return v.reshape(prefix + fill + event).expand(tuple(lead) + event)


def per_lane(v: torch.Tensor, lead: Tuple[int, ...], n: int) -> torch.Tensor:
    """A data array as ``[n, T]`` lanes for draws with leading axes
    ``lead`` (``n = prod(lead)``): ``[T]`` is shared by every draw;
    ``[lead[0], T]`` holds one series per leading index, repeated over
    the remaining draw axes."""
    if v.ndim == 1:
        return v.expand(n, v.shape[0])
    if v.ndim == 2 and len(lead) >= 1 and v.shape[0] == lead[0]:
        return v.repeat_interleave(n // lead[0], dim=0)
    raise ValueError(
        f"data arrays must be [T] or [{lead[0] if lead else 'B'}, T] for draws "
        f"with leading axes {lead}, got {tuple(v.shape)}"
    )


def draw_lanes(theta_draws, data, device: DeviceLike):
    """``(lead, flat theta [n, n_free], data lanes {k: [n, T]})`` for
    draws ``[..., n_free]``, on ``device`` (None: CUDA)."""
    device = resolve_device(device)
    theta = torch.as_tensor(theta_draws, dtype=torch.float32, device=device)
    lead = tuple(theta.shape[:-1])
    flat = theta.reshape(-1, theta.shape[-1])
    n = flat.shape[0]
    lanes = {
        k: per_lane(torch.as_tensor(v, device=device), lead, n)
        for k, v in data.items()
        if v is not None
    }
    return lead, flat, lanes


class BaseHMMModel:
    """Subclasses define ``specs()`` and ``build()``."""

    def specs(self) -> List[Tuple[str, Bijector]]:
        raise NotImplementedError

    def build(self, params: Params, data: Dict[str, torch.Tensor]):
        """Return ``(log_pi, log_A, log_obs, mask)`` (mask may be None)."""
        raise NotImplementedError

    def build_vg(self, params: Params, data: Dict[str, torch.Tensor]):
        """Hot-loop variant of :meth:`build`, consistent with
        :meth:`gate_keys`: when gate keys are given, the returned
        ``log_A`` stays homogeneous and ungated (the kernels apply the
        gate). Default: same as ``build``."""
        return self.build(params, data)

    def gate_keys(self, data: Dict[str, torch.Tensor]):
        """``None`` (default) or ``(gate_key [..., T], state_key [...,
        K])`` float tensors with ``c[t, j] = gate_key[t] ==
        state_key[j]``."""
        return None

    def log_prior(self, params: Params) -> torch.Tensor:
        """Log prior on the constrained values; flat (zero) by default,
        as in the reference models that declare none."""
        return next(iter(params.values())).new_zeros(())

    def make_vg(
        self, data: Dict[str, torch.Tensor]
    ) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
        """Fused ``theta [..., n_free] -> (logp [...], grad [..., n_free])``
        for the sampler's hot loop (counterpart of the JAX ``make_vg``).

        The leading axes of ``theta`` are flattened into one batch of
        lanes and the forward recursion runs as ONE call of
        :class:`~hhmm_tpu_torch.kernels.vg.ForwardLoglik` (the ``FWD`` +
        ``VG_BWD`` kernel pair on the card). The chain rule back to
        ``theta`` (bijectors, builders, prior) is ordinary autograd; the
        recursion's own gradient is the pair's closed Baum-Welch form.
        ``data`` arrays carry a prefix of ``theta``'s leading axes
        (:func:`broadcast_data`)."""

        def vg(theta: torch.Tensor):
            lead = tuple(theta.shape[:-1])
            lanes = {k: broadcast_data(v, lead) for k, v in data.items() if v is not None}
            gk = self.gate_keys(lanes)
            n = math.prod(lead)
            with torch.enable_grad():
                th = theta.detach().requires_grad_(True)
                params, ldj = self.unpack(th)
                log_pi, log_A, log_obs, mask = self.build_vg(params, lanes)
                T, K = log_obs.shape[-2:]
                if mask is None:
                    mask = torch.ones(lead + (T,), dtype=log_obs.dtype, device=log_obs.device)
                gate = () if gk is None else (
                    gk[0].reshape(n, T), broadcast_data(gk[1], lead).reshape(n, K)
                )
                ll = ForwardLoglik.apply(
                    log_pi.reshape(n, K),
                    log_A.reshape(n, K, K),
                    log_obs.reshape(n, T, K),
                    mask.reshape(n, T),
                    *gate,
                )
                logp = ll.reshape(lead) + self.log_prior(params) + ldj
                (grad,) = torch.autograd.grad(logp.sum(), th)
            return logp.detach(), grad

        return vg

    @property
    def n_free(self) -> int:
        return sum(b.n_free for _, b in self.specs())

    def unpack(self, theta: torch.Tensor) -> Tuple[Params, torch.Tensor]:
        """``theta [..., n_free]`` → (constrained params with leading
        axes ``...``, total log|J| ``[...]``)."""
        if theta.shape[-1] != self.n_free:
            raise ValueError(
                f"theta has {theta.shape[-1]} free parameters, "
                f"{type(self).__name__} has {self.n_free}"
            )
        params: Params = {}
        ldj = torch.zeros(theta.shape[:-1], dtype=theta.dtype, device=theta.device)
        i = 0
        for name, bij in self.specs():
            val, d = bij.forward(theta[..., i : i + bij.n_free])
            params[name] = val
            ldj = ldj + d
            i += bij.n_free
        return params, ldj

    def pack(self, params: Params) -> torch.Tensor:
        """Constrained params (leading axes ``...``) → ``theta [...,
        n_free]``."""
        return torch.cat([bij.inverse(params[name]) for name, bij in self.specs()], dim=-1)

    def generated(
        self,
        theta_draws: torch.Tensor,
        data: Dict[str, torch.Tensor],
        device: DeviceLike = None,
    ) -> Dict[str, torch.Tensor]:
        """Per-draw generated quantities: ``alpha`` (filtered
        probabilities, softmax of log-alpha per step), ``gamma``
        (smoothed probabilities), ``zstar`` (Viterbi path, int64),
        ``logp_zstar`` and ``loglik`` — the reference's ``alpha_tk /
        gamma_tk / zstar_t`` (`hmm/stan/hmm.stan:48-130`).

        ``theta_draws [..., n_free]``; data arrays are ``[T]`` (one
        series, every draw) or ``[B, T]`` with ``theta_draws [B, ...,
        n_free]``. Every draw of every series goes into one flat batch
        of lanes: on the card a homogeneous model launches ``FILTER``,
        ``BETA``, ``VITERBI`` and ``BACKTRACK`` once each
        (``kernels/dispatch.py``); a time-varying ``log_A`` runs the
        scans. Outputs carry the draws' leading axes."""
        lead, flat, lanes = draw_lanes(theta_draws, data, device)
        params, _ = self.unpack(flat)
        log_pi, log_A, log_obs, mask = self.build(params, lanes)
        log_alpha, _, log_gamma, ll = smooth_dispatch(log_pi, log_A, log_obs, mask)
        zstar, logp_zstar = viterbi_dispatch(log_pi, log_A, log_obs, mask)
        out = {
            "alpha": torch.softmax(log_alpha, dim=-1),
            "gamma": torch.exp(log_gamma),
            "zstar": zstar,
            "logp_zstar": logp_zstar,
            "loglik": ll,
        }
        return {k: v.reshape(lead + v.shape[1:]) for k, v in out.items()}

    def state_draws(
        self,
        generator: torch.Generator,
        theta_draws: torch.Tensor,
        data: Dict[str, torch.Tensor],
        device: DeviceLike = None,
    ) -> torch.Tensor:
        """Exact joint posterior draws of the state path, one FFBS path
        per posterior draw: ``z [..., T]`` int64 for ``theta_draws [...,
        n_free]`` (data as in :meth:`generated`). All draws are one
        flat batch through ``ffbs_dispatch`` — one ``FWD`` and one
        ``BWD_SAMPLE`` launch on the card — with uniforms from
        ``generator``, which must live on ``device``. A model that
        expresses its gate by keys (:meth:`gate_keys`) keeps ``log_A``
        homogeneous through :meth:`build_vg`, as the Gibbs sweep does."""
        lead, flat, lanes = draw_lanes(theta_draws, data, device)
        params, _ = self.unpack(flat)
        gk = self.gate_keys(lanes)
        build = self.build_vg if gk is not None else self.build
        log_pi, log_A, log_obs, mask = build(params, lanes)
        z, _ = ffbs_dispatch(generator, log_pi, log_A, log_obs, mask, *(gk or (None, None)))
        return z.reshape(lead + z.shape[1:])

    def constrained_draws(self, theta_draws: torch.Tensor) -> Params:
        """Unconstrained draws ``[..., n_free]`` → constrained arrays with
        the same leading axes."""
        return self.unpack(theta_draws)[0]
