"""Constraint bijectors (counterpart of ``hhmm_tpu/core/bijectors.py``):
unconstrained ℝⁿ → constrained parameter spaces, with Stan's
log-Jacobians.

Ported: ``UnitInterval`` and ``Simplex`` (the Tayal model), ``Positive``
and ``Ordered`` (the Gaussian HMM), ``Identity`` and ``MaskedSimplex``
(the IOHMM regressions and the HHMM trees' sparse rows). All are
batch-native:
``forward`` maps ``x [..., n_free]`` to ``(y [..., *shape], log|J| [...])``
and ``inverse`` maps ``y [..., *shape]`` back to ``x [..., n_free]``, so a
whole batch of chains goes through one call.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["Bijector", "Identity", "UnitInterval", "Simplex", "MaskedSimplex", "Positive", "Ordered"]


class Bijector:
    """Maps an unconstrained vector of size ``n_free`` to a constrained array."""

    n_free: int
    shape: Tuple[int, ...]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Return (constrained_value, log_det_jacobian)."""
        raise NotImplementedError

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        """Constrained → unconstrained (used for inits; no jacobian)."""
        raise NotImplementedError


class Identity(Bijector):
    """y = x reshaped to ``shape``; log|J| = 0."""

    def __init__(self, shape: Tuple[int, ...] = ()):
        self.shape = tuple(shape)
        self.n_free = math.prod(self.shape)

    def forward(self, x):
        lead = x.shape[:-1]
        return x.reshape(lead + self.shape), torch.zeros(lead, dtype=x.dtype, device=x.device)

    def inverse(self, y):
        lead = y.shape[: y.ndim - len(self.shape)]
        return y.reshape(lead + (self.n_free,))


class UnitInterval(Bijector):
    """y = sigmoid(x); log|J| = sum(log y + log(1-y))."""

    def __init__(self, shape: Tuple[int, ...] = ()):
        self.shape = tuple(shape)
        self.n_free = math.prod(self.shape)

    def forward(self, x):
        lead = x.shape[:-1]
        ldj = (F.logsigmoid(x) + F.logsigmoid(-x)).sum(-1)
        return torch.sigmoid(x).reshape(lead + self.shape), ldj

    def inverse(self, y):
        lead = y.shape[: y.ndim - len(self.shape)]
        y = y.reshape(lead + (self.n_free,))
        return torch.log(y) - torch.log1p(-y)


class Simplex(Bijector):
    """Stan stick-breaking simplex; ``shape`` is the constrained shape,
    last axis K (the simplex axis); free size ``prod(shape[:-1]) * (K-1)``.

    z_k = sigmoid(x_k + log(1 / (K - k))),  y_k = z_k * (1 - sum_{j<k} y_j).
    """

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = tuple(shape)
        self._K = self.shape[-1]
        self.n_free = math.prod(self.shape[:-1]) * (self._K - 1)

    def _offsets(self, ref: torch.Tensor) -> torch.Tensor:
        return -torch.log(
            torch.arange(self._K - 1, 0, -1, dtype=ref.dtype, device=ref.device)
        )

    def forward(self, x):
        lead = x.shape[:-1]
        K = self._K
        if K == 1:
            ones = torch.ones(lead + self.shape, dtype=x.dtype, device=x.device)
            return ones, torch.zeros(lead, dtype=x.dtype, device=x.device)
        x = x.reshape(lead + self.shape[:-1] + (K - 1,))
        logit_z = x + self._offsets(x)
        log_z = F.logsigmoid(logit_z)
        log_1mz = F.logsigmoid(-logit_z)
        # log of the remaining stick after each break
        log_rem = torch.cumsum(log_1mz, dim=-1)
        log_rem_before = torch.cat(
            [torch.zeros_like(log_rem[..., :1]), log_rem[..., :-1]], dim=-1
        )
        log_y = torch.cat([log_z + log_rem_before, log_rem[..., -1:]], dim=-1)
        # |J| = prod_k z_k (1 - z_k) * rem_before_k  (Stan manual §10.7)
        ldj = (log_z + log_1mz + log_rem_before).reshape(lead + (-1,)).sum(-1)
        return torch.exp(log_y), ldj

    def inverse(self, y):
        lead = y.shape[: y.ndim - len(self.shape)]
        K = self._K
        if K == 1:
            return torch.zeros(lead + (0,), dtype=y.dtype, device=y.device)
        csum = torch.cumsum(y, dim=-1)
        if K > 2:
            rem_before = torch.cat(
                [torch.ones_like(csum[..., :1]), 1.0 - csum[..., :-2]], dim=-1
            )
        else:
            rem_before = torch.ones_like(y[..., :1])
        z = y[..., :-1] / rem_before
        x = torch.log(z) - torch.log1p(-z) - self._offsets(y)
        return x.reshape(lead + (-1,))


class MaskedSimplex(Bijector):
    """Simplex over a static support subset of a length-n vector: entries
    off the support are exactly 0 (an HHMM tree's structural zeros). A
    support of m entries costs m-1 free parameters; m == 1 is a
    deterministic row with none."""

    def __init__(self, support):
        mask = torch.as_tensor(support, dtype=torch.bool)
        if mask.ndim != 1:
            raise ValueError("support must be 1-D")
        m = int(mask.sum())
        if m < 1:
            raise ValueError("support must have at least one entry")
        self.support = mask.numpy()
        self.shape = tuple(mask.shape)
        self._idx = [int(i) for i in torch.nonzero(mask).flatten()]
        self._inner = Simplex((m,))
        self.n_free = self._inner.n_free

    def forward(self, x):
        vals, ldj = self._inner.forward(x)
        lead = vals.shape[:-1]
        y = torch.zeros(lead + self.shape, dtype=vals.dtype, device=vals.device)
        idx = torch.tensor(self._idx, dtype=torch.long, device=vals.device)
        return y.index_copy(-1, idx, vals), ldj

    def inverse(self, y):
        vals = y[..., self._idx]
        # renormalize the on-support mass: an init with (small) mass on
        # the structural zeros packs to the nearest valid point
        return self._inner.inverse(vals / vals.sum(-1, keepdim=True))


class Positive(Bijector):
    """y = lower + exp(x); log|J| = sum(x). ``lower`` is Stan's
    ``real<lower=...>`` shifted-exp transform (``real<lower=0.0001>
    sigma_k`` in `hmm/stan/hmm.stan:21`)."""

    def __init__(self, shape: Tuple[int, ...] = (), lower: float = 0.0):
        self.shape = tuple(shape)
        self.lower = float(lower)
        self.n_free = math.prod(self.shape)

    def forward(self, x):
        lead = x.shape[:-1]
        return self.lower + torch.exp(x).reshape(lead + self.shape), x.sum(-1)

    def inverse(self, y):
        lead = y.shape[: y.ndim - len(self.shape)]
        return torch.log(y - self.lower).reshape(lead + (self.n_free,))


class Ordered(Bijector):
    """Stan ordered vector along the last axis: y[0] = x[0], y[k] = y[k-1]
    + exp(x[k]); log|J| = sum of x[1:]. ``shape=(K, L)`` means K
    independent ordered-L vectors."""

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = tuple(shape)
        self.n_free = math.prod(self.shape)

    def forward(self, x):
        lead = x.shape[:-1]
        x = x.reshape(lead + self.shape)
        y = torch.cumsum(torch.cat([x[..., :1], torch.exp(x[..., 1:])], dim=-1), dim=-1)
        return y, x[..., 1:].reshape(lead + (-1,)).sum(-1)

    def inverse(self, y):
        lead = y.shape[: y.ndim - len(self.shape)]
        x = torch.cat([y[..., :1], torch.log(torch.diff(y, dim=-1))], dim=-1)
        return x.reshape(lead + (self.n_free,))
