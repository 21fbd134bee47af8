"""Input-output HMM simulator on ``torch.Generator`` streams (counterpart
of ``hhmm_tpu/sim/iohmm.py``).

The reference's ``iohmm_sim`` (`iohmm-reg/R/iohmm-sim.R:26-56`): states
evolve as ``z_t ~ Cat(softmax(u_t · w))``, input-driven,
time-inhomogeneous and (deliberately, as in the reference and its
write-up, `hassan2005/main.Rmd:758`) independent of ``z_{t-1}``: the
"transition matrix" at time t is one K-vector reused for every previous
state. Emissions are pluggable:

- :func:`obsmodel_reg`: per-state linear regression
  (`iohmm-reg/R/iohmm-sim.R:74-95`);
- :func:`obsmodel_mix`: per-state L-component Gaussian mixture
  (`iohmm-reg/R/iohmm-sim.R:110-131`).

Categorical draws are by the Gumbel-max trick, the JAX package's
``jax.random.categorical``; the streams differ from JAX's, so parity is
distributional. Everything lives on the generator's device.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from hhmm_tpu_torch.core.dists import gumbel_argmax_sample

__all__ = ["iohmm_sim", "obsmodel_reg", "obsmodel_mix"]


def obsmodel_reg(b, sigma) -> Callable:
    """Linear-Gaussian emission: ``x_t ~ N(u_t · b[z_t], sigma[z_t])``;
    ``b`` ``[K, M]`` regression weights per state, ``sigma`` ``[K]``.
    ``sample(generator, z, u)`` returns float32 draws shaped like ``z``."""
    b = np.asarray(b, dtype=np.float32)
    sigma = np.asarray(sigma, dtype=np.float32)

    def sample(generator: torch.Generator, z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        bz = torch.as_tensor(b, device=z.device)[z]  # [T, M]
        mean = (u * bz).sum(-1)
        s = torch.as_tensor(sigma, device=z.device)[z]
        return mean + s * torch.randn(z.shape, generator=generator, device=z.device)

    return sample


def obsmodel_mix(lambdas, mu, sigma) -> Callable:
    """Per-state Gaussian-mixture emission: ``lambdas`` ``[K, L]`` mixture
    weights, ``mu`` / ``sigma`` ``[K, L]``; the component is drawn, then
    the value."""
    log_lam = np.log(np.asarray(lambdas, dtype=np.float32))
    mu = np.asarray(mu, dtype=np.float32)
    sigma = np.asarray(sigma, dtype=np.float32)

    def sample(generator: torch.Generator, z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        del u
        dev = z.device
        comp = gumbel_argmax_sample(generator, torch.as_tensor(log_lam, device=dev)[z], axis=-1)
        m = torch.as_tensor(mu, device=dev)[z, comp]
        s = torch.as_tensor(sigma, device=dev)[z, comp]
        return m + s * torch.randn(z.shape, generator=generator, device=dev)

    return sample


def iohmm_sim(
    generator: torch.Generator,
    u,
    w,
    obs_model: Callable,
    validate: bool = True,
) -> Dict[str, torch.Tensor]:
    """Simulate an IOHMM given inputs ``u`` ``[T, M]`` and softmax weights
    ``w`` ``[K, M]``. Returns ``u`` (float32), ``z`` ``[T]`` (int64),
    ``x`` ``[T]`` and ``p_mat`` ``[T, K]`` (the per-step state
    probabilities), the reference's return list
    (`iohmm-reg/R/iohmm-sim.R:49-55`)."""
    dev = generator.device
    u = torch.as_tensor(np.asarray(u), dtype=torch.float32, device=dev)
    w = torch.as_tensor(np.asarray(w), dtype=torch.float32, device=dev)
    if validate:
        if u.ndim != 2:
            raise ValueError("u must be [T, M]")
        if w.ndim != 2 or w.shape[1] != u.shape[1]:
            raise ValueError(f"w must be [K, {u.shape[1]}], got {tuple(w.shape)}")
    logits = u @ w.T  # [T, K]
    z = gumbel_argmax_sample(generator, logits, axis=-1)
    x = obs_model(generator, z, u)
    return {"u": u, "z": z, "x": x, "p_mat": torch.softmax(logits, dim=-1)}
