"""HMM generative simulator on ``torch.Generator`` streams (counterpart
of ``hhmm_tpu/sim/hmm.py``).

Draws are by inverse CDF against uniforms from the generator, in float64
so a zero-probability transition can never be reached through rounding
of the cumulative sums. The state chain is a loop over t, batched over
any leading ``batch`` shape; everything lives on the generator's device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

__all__ = ["hmm_sim", "markov_chain_sim", "obsmodel_categorical", "obsmodel_gaussian"]


def _validate(A: np.ndarray, p_init: np.ndarray) -> None:
    A = np.asarray(A)
    p_init = np.asarray(p_init)
    K = p_init.shape[0]
    if A.shape != (K, K):
        raise ValueError(f"A must be ({K},{K}), got {A.shape}")
    if np.any(A < 0) or np.any(p_init < 0):
        raise ValueError("A and p_init must be non-negative")
    if not np.allclose(A.sum(axis=1), 1.0, atol=1e-6):
        raise ValueError("rows of A must sum to 1")
    if not np.isclose(p_init.sum(), 1.0, atol=1e-6):
        raise ValueError("p_init must sum to 1")


def _draw(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF categorical draw: ``#{k : u >= cdf_k}`` over the
    first K-1 cumulative probabilities ``cdf [..., K-1]``."""
    return (u[..., None] >= cdf).sum(-1)


def markov_chain_sim(
    generator: torch.Generator, T: int, A, p_init, batch: Tuple[int, ...] = ()
) -> torch.Tensor:
    """Sample state chains ``z [*batch, T]`` (int64)."""
    dev = generator.device
    A = torch.as_tensor(np.asarray(A), dtype=torch.float64, device=dev)
    p = torch.as_tensor(np.asarray(p_init), dtype=torch.float64, device=dev)
    cdf_A = torch.cumsum(A, dim=-1)[:, :-1]  # [K, K-1]
    u = torch.rand(tuple(batch) + (T,), generator=generator, dtype=torch.float64, device=dev)
    z = torch.empty(tuple(batch) + (T,), dtype=torch.long, device=dev)
    z[..., 0] = _draw(torch.cumsum(p, dim=-1)[:-1], u[..., 0])
    for t in range(1, T):
        z[..., t] = _draw(cdf_A[z[..., t - 1]], u[..., t])
    return z


def obsmodel_gaussian(mu, sigma) -> Callable:
    """Per-state Gaussian emission (`hmm/main.R:11` ``rnorm(1, mu[z],
    sigma[z])``); ``sample(generator, z)`` returns float32 draws shaped
    like ``z``."""
    mu = np.asarray(mu, dtype=np.float32)
    sigma = np.asarray(sigma, dtype=np.float32)

    def sample(generator: torch.Generator, z: torch.Tensor) -> torch.Tensor:
        m = torch.as_tensor(mu, device=z.device)[z]
        s = torch.as_tensor(sigma, device=z.device)[z]
        return m + s * torch.randn(z.shape, generator=generator, device=z.device)

    return sample


def obsmodel_categorical(phi) -> Callable:
    """Per-state categorical emission over L symbols (rows of ``phi``);
    ``sample(generator, z)`` returns int64 symbols shaped like ``z``."""
    phi = np.asarray(phi, dtype=np.float64)

    def sample(generator: torch.Generator, z: torch.Tensor) -> torch.Tensor:
        cdf = torch.cumsum(torch.as_tensor(phi, device=z.device), dim=-1)[:, :-1]
        u = torch.rand(z.shape, generator=generator, dtype=torch.float64, device=z.device)
        return _draw(cdf[z], u)

    return sample


def hmm_sim(
    generator: torch.Generator,
    T: int,
    A,
    p_init,
    obs_model: Callable,
    batch: Tuple[int, ...] = (),
    validate: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulate ``(z [*batch, T], x [*batch, T])`` from a K-state HMM;
    ``obs_model(generator, z) -> x``."""
    if validate:
        _validate(np.asarray(A), np.asarray(p_init))
    z = markov_chain_sim(generator, T, A, p_init, batch)
    return z, obs_model(generator, z)
