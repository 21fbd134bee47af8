"""Warmup adaptation machinery (counterpart of the adaptation half of
``hhmm_tpu/infer/run.py``): Stan's warmup schedule, dual-averaging
step-size adaptation and Welford variance estimation, shared by the
ChEES sampler (``infer/chees.py``).

- dual averaging (Hoffman & Gelman 2014, Stan's defaults γ=0.05, t0=10,
  κ=0.75);
- diagonal mass-matrix windows (init buffer 75, base window 25
  doubling, term buffer 50, rescaled for short warmups as Stan does);
- Welford online variance with Stan's shrinkage toward unit,
  ``(n / (n+5)) var + 1e-3 (5 / (n+5))``.

State is tensors (on the sampler's device), so an adaptation step does
not synchronise with the host; the schedule itself is numpy booleans
read by the host loop. ``sample_nuts`` is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["warmup_schedule"]


def warmup_schedule(num_warmup: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stan's three-phase warmup: ``(update_mass[t], window_end[t])``
    numpy bool arrays."""
    init_buffer, term_buffer, base_window = 75, 50, 25
    if num_warmup < init_buffer + term_buffer + base_window:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.10 * num_warmup)
        base_window = num_warmup - init_buffer - term_buffer
    update_mass = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    update_mass[init_buffer : num_warmup - term_buffer] = True
    # expanding windows: 25, 50, 100, ... within the mass phase
    t = init_buffer
    w = base_window
    while t < num_warmup - term_buffer:
        end = t + w
        if end + 2 * w > num_warmup - term_buffer:
            end = num_warmup - term_buffer
        window_end[min(end, num_warmup) - 1] = True
        t = end
        w *= 2
    return update_mass, window_end


class _DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def _da_init(eps: torch.Tensor) -> _DAState:
    # log_eps_bar starts at log(eps): the first update overwrites it
    # entirely (x_eta = 1 at count 1), so the init only matters when a
    # window closes with no further update, where eps_bar must be the
    # adapted eps and not exp(0)
    return _DAState(
        log_eps=torch.log(eps),
        log_eps_bar=torch.log(eps),
        h_bar=torch.zeros_like(eps),
        mu=torch.log(10.0 * eps),
        count=torch.zeros_like(eps),
    )


def _da_update(s: _DAState, accept_prob: torch.Tensor, target: float) -> _DAState:
    gamma, t0, kappa = 0.05, 10.0, 0.75
    count = s.count + 1.0
    eta = 1.0 / (count + t0)
    h_bar = (1.0 - eta) * s.h_bar + eta * (target - accept_prob)
    log_eps = s.mu - torch.sqrt(count) / gamma * h_bar
    x_eta = count ** (-kappa)
    log_eps_bar = x_eta * log_eps + (1.0 - x_eta) * s.log_eps_bar
    return _DAState(log_eps, log_eps_bar, h_bar, s.mu, count)


class _Welford(NamedTuple):
    n: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def _welford_update(s: _Welford, x: torch.Tensor) -> _Welford:
    n = s.n + 1.0
    d = x - s.mean
    mean = s.mean + d / n
    m2 = s.m2 + d * (x - mean)
    return _Welford(n, mean, m2)


def _welford_variance(s: _Welford) -> torch.Tensor:
    var = s.m2 / torch.clamp_min(s.n - 1.0, 1.0)
    # Stan's regularization toward the unit metric
    return (s.n / (s.n + 5.0)) * var + 1e-3 * (5.0 / (s.n + 5.0))
