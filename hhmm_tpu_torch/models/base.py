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
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from hhmm_tpu_torch.core.bijectors import Bijector
from hhmm_tpu_torch.kernels.vg import ForwardLoglik

__all__ = ["BaseHMMModel", "broadcast_data"]

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

    def constrained_draws(self, theta_draws: torch.Tensor) -> Params:
        """Unconstrained draws ``[..., n_free]`` → constrained arrays with
        the same leading axes."""
        return self.unpack(theta_draws)[0]
