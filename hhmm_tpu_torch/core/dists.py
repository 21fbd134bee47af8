"""Minimal distribution library (log-pdfs and samplers) for the model zoo
(counterpart of ``hhmm_tpu/core/dists.py``).

Normal emissions and priors (`hmm/stan/hmm.stan`), categorical
emissions (`hmm/stan/hmm-multinom.stan:21`), per-state Gaussian mixtures
(`iohmm-mix/stan/iohmm-mix.stan:53-65`) and Dirichlet priors on simplex
rows. Shapes broadcast; everything is differentiable. Samplers draw from
a ``torch.Generator`` on the device they sample on.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "normal_logpdf",
    "normal_sample",
    "categorical_logpmf",
    "categorical_sample",
    "dirichlet_logpdf",
    "mixture_normal_logpdf",
    "gumbel_argmax_sample",
]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _as(x, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def normal_logpdf(x, mu=0.0, sigma=1.0):
    x = torch.as_tensor(x)
    mu, sigma = _as(mu, x), _as(sigma, x)
    z = (x - mu) / sigma
    return -0.5 * z * z - torch.log(sigma) - _HALF_LOG_2PI


def normal_sample(generator: torch.Generator, mu=0.0, sigma=1.0, shape=()):
    eps = torch.randn(tuple(shape), generator=generator, device=generator.device)
    return _as(mu, eps) + _as(sigma, eps) * eps


def categorical_logpmf(x, log_p):
    """``x`` integer in [0, K); ``log_p`` [..., K] (need not be
    normalized)."""
    log_p = log_p - torch.logsumexp(log_p, dim=-1, keepdim=True)
    x = torch.as_tensor(x, device=log_p.device).long()
    idx = x[..., None].expand(torch.broadcast_shapes(x.shape, log_p.shape[:-1]) + (1,))
    return torch.gather(log_p.expand(idx.shape[:-1] + log_p.shape[-1:]), -1, idx)[..., 0]


def gumbel_argmax_sample(generator: torch.Generator, log_p, axis: int = -1):
    """Categorical draw by the Gumbel-max trick over ``axis``."""
    u = torch.rand(log_p.shape, generator=generator, dtype=log_p.dtype, device=log_p.device)
    tiny = torch.finfo(log_p.dtype).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(log_p + g, dim=axis)


def categorical_sample(generator: torch.Generator, log_p, shape=()):
    """Draws of shape ``shape`` (default ``log_p.shape[:-1]``) from the
    categorical with logits ``log_p [..., K]``."""
    shape = tuple(shape) or tuple(log_p.shape[:-1])
    return gumbel_argmax_sample(generator, log_p.expand(shape + log_p.shape[-1:]), axis=-1)


def dirichlet_logpdf(p, alpha):
    """Log-density of a simplex point ``p`` under Dirichlet(alpha), with
    xlogy semantics: a boundary point whose alpha component is 1 gives
    0·log(0) = 0, not NaN."""
    p = torch.as_tensor(p)
    alpha = _as(alpha, p)
    return (
        torch.xlogy(alpha - 1.0, p).sum(-1)
        + torch.lgamma(alpha.sum(-1))
        - torch.lgamma(alpha).sum(-1)
    )


def mixture_normal_logpdf(x, log_w, mu, sigma):
    """``logsumexp_l(log_w[l] + N(x | mu[l], sigma[l]))`` over a trailing
    mixture axis L of ``log_w``, ``mu`` and ``sigma``."""
    comp = normal_logpdf(torch.as_tensor(x)[..., None], mu, sigma)
    return torch.logsumexp(log_w + comp, dim=-1)
