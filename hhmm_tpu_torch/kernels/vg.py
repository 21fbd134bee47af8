"""Fused value-and-gradient of the forward log-likelihood (counterpart of
``hhmm_tpu/kernels/vg.py``).

``forward_value_and_grad(log_pi, log_A, log_obs, mask[, gate_key,
state_key])`` returns ``(loglik, d_pi, d_A, d_obs)`` for a flat batch
``[N, ...]`` — the HMC leapfrog needs exactly this pair at every step.
The gradients are the closed Baum-Welch forms, accumulated by the
``VG_BWD`` kernel in reverse time after the ``FWD`` kernel's forward
pass (``kernels/cuda_semiring.py::semiring_vg``).

Gated transitions: ``c[t, j] = (gate_key[t] == state_key[j])`` gates
``log_A`` per (step, destination) as in the JAX module, so ``log_A``
stays homogeneous and the Tayal stan gate runs the kernels. Inputs must
be finite (models use ``safe_log`` / ``MASK_NEG``).

A time-varying ``log_A [N, T-1, K, K]`` (an input-driven transition
matrix, the IOHMM's) takes the JAX module's ``_vg_core`` path on any
device: the guarded scans of ``kernels/filtering.py`` and the
Baum-Welch sums as torch ops, gated or not, with ``d_A`` per slice.

The JAX module's ``custom_vmap`` folds any nesting of series and chains
into one flat batch; here the caller hands the flat batch over directly
(``models/base.py::make_vg`` flattens its leading axes). Its TPU
eligibility gates (backend, VMEM-sized ``T*K``) have no counterpart:
routing is by device, a CUDA operand always launches the kernel pair
(float32, any ``K >= 1``, ``K_RANGE``; anything else raises) and a CPU operand
runs the kernels' plain versions.

:class:`ForwardLoglik` is the ``jax.custom_vjp`` of the JAX package in
PyTorch idiom: its forward runs the kernel pair and saves the
gradients, its backward scales them by the incoming gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hhmm_tpu_torch.kernels.cuda_semiring import semiring_vg
from hhmm_tpu_torch.kernels.filtering import backward_pass, forward_filter
from hhmm_tpu_torch.kernels.grad import baum_welch

__all__ = ["forward_value_and_grad", "ForwardLoglik"]


def _vg_time_varying(log_pi, log_A, log_obs, mask, gate_key, state_key):
    """The JAX ``_vg_core`` on the scans, for ``log_A [N, T-1, K, K]``."""
    cA = None
    if gate_key is not None:
        sk = state_key if state_key.ndim == 2 else state_key[None]
        cA = (gate_key[:, :, None] == sk[:, None, :])[:, 1:, None, :]  # [N, T-1, 1, K]
    A_eff = log_A if cA is None else torch.where(cA, log_A, torch.zeros_like(log_A))
    log_alpha, ll = forward_filter(log_pi, A_eff, log_obs, mask)
    log_beta = backward_pass(A_eff, log_obs, mask)
    d_pi, xi, gamma = baum_welch(log_alpha, log_beta, A_eff, log_obs, mask, ll)
    if cA is not None:
        xi = xi * cA  # chain rule: dA_eff/dA = c
    return ll, d_pi, xi, gamma


def forward_value_and_grad(
    log_pi: torch.Tensor,  # [N, K]
    log_A: torch.Tensor,  # [N, K, K]
    log_obs: torch.Tensor,  # [N, T, K]
    mask: torch.Tensor,  # [N, T]
    gate_key: Optional[torch.Tensor] = None,  # [N, T]
    state_key: Optional[torch.Tensor] = None,  # [N, K] or [K]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(loglik [N], d_pi [N, K], d_A [N, K, K], d_obs [N, T, K])``
    (``d_A [N, T-1, K, K]`` for a time-varying ``log_A``). ``mask`` is
    required (ones for dense series); gradients are taken with respect
    to ``log_pi``, ``log_A`` and ``log_obs`` only."""
    if (gate_key is None) != (state_key is None):
        raise ValueError("gate_key and state_key must be given together")
    if log_A.ndim == 4:
        return _vg_time_varying(log_pi, log_A, log_obs, mask.to(log_obs.dtype), gate_key,
                                state_key)
    return semiring_vg(log_pi, log_A, log_obs, mask, gate_key, state_key)


class ForwardLoglik(torch.autograd.Function):
    """``loglik [N]`` of the (optionally gated) forward filter, with the
    Baum-Welch gradients as its backward."""

    @staticmethod
    def forward(ctx, log_pi, log_A, log_obs, mask, gate_key=None, state_key=None):
        ll, d_pi, d_A, d_obs = forward_value_and_grad(
            log_pi, log_A, log_obs, mask, gate_key, state_key
        )
        ctx.save_for_backward(d_pi, d_A, d_obs)
        return ll

    @staticmethod
    def backward(ctx, g):
        d_pi, d_A, d_obs = ctx.saved_tensors
        g_A = g.reshape((-1,) + (1,) * (d_A.ndim - 1))
        return g[:, None] * d_pi, g_A * d_A, g[:, None, None] * d_obs, None, None, None

