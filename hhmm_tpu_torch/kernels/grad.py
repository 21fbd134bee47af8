"""Forward log-likelihood with the closed Baum-Welch gradient (counterpart
of ``hhmm_tpu/kernels/grad.py``).

The gradient of the marginal log-likelihood has a closed form in the
posterior state marginals, for any real matrices (unit-factor 0.0 and
``-inf``-masked entries included):

- ``d loglik / d log_obs[t, j] = gamma[t, j]``,
- ``d loglik / d log_pi[j] = gamma[0, j]``,
- ``d loglik / d log_A[i, j] = sum_t xi[t, i, j]`` (per slice for a
  time-varying ``log_A``),

with ``xi[t, i, j] = exp(alpha[t-1, i] + A[i, j] + obs[t, j] + beta[t,
j] - loglik)``. :func:`forward_loglik` is a ``torch.autograd.Function``
whose forward runs the guarded filter and whose backward runs the
guarded beta pass and forms these sums, the JAX ``custom_vjp`` in
PyTorch idiom. It is the target of ``models/base.py::make_logp``.

Routing (``kernels/dispatch.py``, its ``"auto"`` default routes): a
homogeneous ``log_A`` on CUDA runs the ``FILTER`` kernel forward and
the ``BETA`` kernel backward (float32, any K >= 1), their plain versions
on the CPU; a time-varying ``log_A`` runs the plain scans of
``kernels/filtering.py`` on either device (the JAX function is a
``lax.scan`` on every backend). A plan scope or a measured row may
route either to the scans of ``kernels/assoc.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from hhmm_tpu_torch.kernels.dispatch import backward_dispatch, forward_filter_dispatch
from hhmm_tpu_torch.kernels.filtering import time_varying

__all__ = ["baum_welch", "forward_loglik"]


def baum_welch(log_alpha, log_beta, log_A, log_obs, mask, ll):
    """The closed gradient sums of a flat batch, from the guarded filter
    and beta pass: ``(d_pi [N, K], xi [N, T-1, K, K], gamma [N, T,
    K])`` for ``log_A [N, K, K]`` or ``[N, T-1, K, K]``; ``d_A`` is
    ``xi`` summed over time (homogeneous) or ``xi`` itself."""
    # smoothed marginals; masked (padding) steps carry copied alpha and
    # beta, so their would-be gamma is the last valid filter: zeroed
    gamma = torch.exp(log_alpha + log_beta - ll[:, None, None]) * mask[..., None]
    # alpha[0] is log_pi + obs[0] (log_pi alone when step 0 is masked),
    # so the pi cotangent is gamma at t=0 either way, recomputed from
    # the carry because the masked gamma above was zeroed
    d_pi = torch.exp(log_alpha[:, 0] + log_beta[:, 0] - ll[:, None])
    lA = log_A if log_A.ndim == 4 else log_A[:, None]
    xi = torch.exp(
        log_alpha[:, :-1, :, None]
        + lA
        + (log_obs[:, 1:] + log_beta[:, 1:])[:, :, None, :]
        - ll[:, None, None, None]
    ) * mask[:, 1:, None, None]
    return d_pi, xi, gamma


class _ForwardLoglik(torch.autograd.Function):
    """``loglik [N]`` of a flat batch, with the Baum-Welch backward."""

    @staticmethod
    def forward(ctx, log_pi, log_A, log_obs, mask):
        log_alpha, ll = forward_filter_dispatch(log_pi, log_A, log_obs, mask)
        ctx.save_for_backward(log_A, log_obs, mask, log_alpha, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        log_A, log_obs, mask, log_alpha, ll = ctx.saved_tensors
        log_beta = backward_dispatch(log_A, log_obs, mask)
        d_pi, xi, gamma = baum_welch(log_alpha, log_beta, log_A, log_obs, mask, ll)
        if log_A.ndim == 4:
            d_A = g[:, None, None, None] * xi
        else:
            d_A = g[:, None, None] * xi.sum(1)
        return g[:, None] * d_pi, d_A, g[:, None, None] * gamma, None


def forward_loglik(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Marginal log-likelihood ``logsumexp(alpha[T-1])`` with the
    Baum-Welch backward, batch-native: ``log_obs [..., T, K]``,
    ``log_pi [..., K]``, ``log_A [..., K, K]`` or ``[..., T-1, K, K]``,
    ``mask [..., T]`` (optional, 1 valid / 0 padding), whose leading axes
    broadcast to ``log_obs``'s. Returns ``loglik [...]``; all leading
    axes run as one flat batch (one ``FILTER``, and backward one
    ``BETA``, on the card for a homogeneous ``log_A``)."""
    T, K = log_obs.shape[-2:]
    lead = tuple(log_obs.shape[:-2])
    n = math.prod(lead)
    tv = time_varying(log_A, log_obs)
    a_event = (T - 1, K, K) if tv else (K, K)
    if mask is None:
        mask = torch.ones(lead + (T,), dtype=log_obs.dtype, device=log_obs.device)
    ll = _ForwardLoglik.apply(
        log_pi.expand(lead + (K,)).reshape(n, K),
        log_A.expand(lead + a_event).reshape((n,) + a_event),
        log_obs.reshape(n, T, K),
        mask.expand(lead + (T,)).reshape(n, T).to(log_obs.dtype),
    )
    return ll.reshape(lead)
