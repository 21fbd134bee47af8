"""HMC building blocks (counterpart of part of ``hhmm_tpu/infer/nuts.py``):
the leapfrog, the kinetic energy and Stan's initial step-size heuristic.
The No-U-Turn tree itself is not ported yet.

Conventions as in the JAX module: positions are unconstrained vectors,
``logp_fn(q) -> (logp, grad)`` is the joint log-density, kinetic energy
uses a diagonal inverse mass matrix, and randomness comes from a
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["find_reasonable_step_size"]

DELTA_MAX = 1000.0


def _leapfrog(logp_fn: Callable, inv_mass, eps, q, p, grad):
    p = p + 0.5 * eps * grad
    q = q + eps * inv_mass * p
    logp, grad = logp_fn(q)
    p = p + 0.5 * eps * grad
    return q, p, logp, grad


def _kinetic(inv_mass: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(inv_mass * p * p, dim=-1)


def find_reasonable_step_size(
    logp_fn: Callable,
    inv_mass: torch.Tensor,
    q: torch.Tensor,
    logp: torch.Tensor,
    grad: torch.Tensor,
    generator: torch.Generator,
    init_step: float = 1.0,
) -> torch.Tensor:
    """Stan's init heuristic: double or halve ε until the one-step accept
    probability crosses 0.5 (at most 50 steps, ε within (1e-7, 1e7)).
    ``q [dim]``; returns ε as a 0-dim tensor on ``q``'s device. Runs on
    the host's control flow (one sync per probe), once per fit."""
    p0 = torch.randn(q.shape, generator=generator, dtype=q.dtype, device=q.device)
    p0 = p0 / torch.sqrt(inv_mass)
    energy0 = -logp + _kinetic(inv_mass, p0)
    log_half = math.log(0.5)

    def accept_logprob(eps: float) -> float:
        _, p1, logp1, _ = _leapfrog(logp_fn, inv_mass, eps, q, p0, grad)
        d = float(energy0 - (-logp1 + _kinetic(inv_mass, p1)))
        return -math.inf if math.isnan(d) else d

    a = accept_logprob(init_step)
    direction = 1.0 if a > log_half else -1.0
    eps, it = float(init_step), 0
    # the first condition reuses the probe at init_step (the JAX loop
    # evaluates it a second time, to the same value)
    while True:
        keep = a > log_half if direction > 0 else a < log_half
        if not (keep and it < 50 and 1e-7 < eps < 1e7):
            break
        eps *= 2.0 if direction > 0 else 0.5
        it += 1
        a = accept_logprob(eps)
    return torch.tensor(eps, dtype=q.dtype, device=q.device)
