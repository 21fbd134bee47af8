"""Liu–West rejuvenation: resample plus kernel-shrinkage jitter
(counterpart of ``hhmm_tpu/adapt/rejuvenate.py``).

When a series' ESS collapses, reweighting alone can only remove
diversity from a frozen bank. The Liu & West (2001) repair is a
kernel-smoothed resample in parameter space:

1. a systematic resample of the D draws by their normalised weights
   (inverse CDF with one uniform offset),
2. shrinkage of each survivor toward the weighted mean,
   ``θ* ← a·θ + (1-a)·m̄``,
3. jitter with the complementary variance,
   ``θ' = θ* + ε,  ε ~ N(0, h²·diag V̄),  h² = 1-a²``,

so the cloud keeps its weighted first two moments (diagonal
covariance) while getting D distinct support points back. It all
happens in the unconstrained space the scheduler serves (the flat
``[D, n_free]`` bank ``model.unpack`` maps), so no simplex or ordering
repair is needed. A draw and its filter state are one particle: the
``(log_alpha, loglik, ok)`` lanes are resampled with the same indices.

The JAX package vmaps a per-series move and splits one PRNG key per
series. Here one batched move runs over ``[N, D, P]`` (a batched
``searchsorted`` on the rows' CDFs, gathers with the same indices, the
weighted moments, a ``where`` on the rows with a live draw), and the
random numbers are arguments: :class:`Rejuvenator` draws them from one
``torch.Generator`` on its device, or from a ``source`` the caller
gives (the tests replay the JAX draws through one).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.core.lmath import safe_log_normalize

__all__ = ["Rejuvenator", "liu_west_move"]

# (N, D, P, dtype, device) -> (u0 [N] in [0, 1), eps [N, D, P] ~ N(0, 1))
DrawSource = Callable[[int, int, int, torch.dtype, torch.device], Tuple[torch.Tensor, torch.Tensor]]


def liu_west_move(draws, log_w, alpha, ll, ok, u0, eps, shrink: float):
    """One Liu–West move over a batch of series.

    ``draws [N, D, P]`` unconstrained banks, ``log_w [N, D]``
    log-weights (need not be normalised), ``alpha [N, D, K]`` /
    ``ll [N, D]`` / ``ok [N, D]`` the per-draw filter state, ``u0 [N]``
    the systematic resample's offsets in [0, 1), ``eps [N, D, P]``
    standard normal jitter, ``shrink`` the Liu–West ``a`` in (0, 1).
    Returns ``(draws', alpha', ll', ok')`` with the input shapes and
    dtypes. A series with no live draw passes through unchanged."""
    a = float(shrink)
    h2 = 1.0 - a * a
    dt = draws.dtype
    N, D, P = draws.shape
    ok = ok.to(torch.bool)
    # dead draws can never be resampled: mask before normalising
    lwn = safe_log_normalize(torch.where(ok, log_w, float("-inf")))
    w = torch.exp(lwn).to(dt)  # an all-dead row: all zeros
    any_alive = torch.isfinite(lwn).any(-1)  # [N]
    # systematic inverse-CDF resample (searchsorted's left side, as
    # jnp.searchsorted's default)
    pos = (u0.to(dt)[:, None] + torch.arange(D, dtype=dt, device=draws.device)) / float(D)
    cdf = torch.cumsum(w, -1)
    idx = torch.searchsorted(cdf, pos).clamp(0, D - 1)  # [N, D]
    # weighted moments of the old cloud (diagonal covariance)
    m = (w[..., None] * draws).sum(1, keepdim=True)  # [N, 1, P]
    v = (w[..., None] * (draws - m) ** 2).sum(1, keepdim=True)
    picked = torch.gather(draws, 1, idx[..., None].expand(N, D, P))
    new_draws = a * picked + (1.0 - a) * m + eps.to(dt) * torch.sqrt(
        torch.tensor(h2, dtype=dt, device=draws.device) * v)
    K = alpha.shape[-1]
    sel = any_alive[:, None]
    return (
        torch.where(sel[..., None], new_draws, draws),
        torch.where(sel[..., None], torch.gather(alpha, 1, idx[..., None].expand(N, D, K)), alpha),
        torch.where(sel, torch.gather(ll, 1, idx), ll),
        torch.where(sel, torch.gather(ok, 1, idx), ok),
    )


class Rejuvenator:
    """Runs the batched Liu–West move with its own random stream.

    ``shrink`` is the Liu–West ``a`` (default 0.98: gentle smoothing that
    keeps the cloud's moments while restoring support). ``seed`` seeds a
    ``torch.Generator`` on ``device`` (None: the card); ``source``, if
    given, replaces it (a :data:`DrawSource`). :attr:`compile_count` is
    the number of distinct ``(N, D, P, dtype)`` signatures moved so far
    (the port has no jit; the count stands where the JAX package counts
    traced programs: one a bucket shape, flat after warmup)."""

    def __init__(self, seed: int = 0, *, shrink: float = 0.98, device: DeviceLike = None,
                 source: Optional[DrawSource] = None):
        if not (0.0 < float(shrink) < 1.0):
            raise ValueError(f"shrink must be in (0, 1), got {shrink}")
        self.shrink = float(shrink)
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._source = source
        self._signatures: set = set()

    @property
    def compile_count(self) -> int:
        return len(self._signatures)

    def _draw(self, N: int, D: int, P: int, dtype: torch.dtype):
        if self._source is not None:
            u0, eps = self._source(N, D, P, dtype, self.device)
            return (torch.as_tensor(u0, dtype=dtype, device=self.device),
                    torch.as_tensor(eps, dtype=dtype, device=self.device))
        u0 = torch.rand((N,), generator=self._gen, dtype=dtype, device=self.device)
        eps = torch.randn((N, D, P), generator=self._gen, dtype=dtype, device=self.device)
        return u0, eps

    def move(self, draws, log_w, alpha, ll, ok) -> Tuple[torch.Tensor, ...]:
        """One batched move on this rejuvenator's device; advances the
        random stream. Inputs and outputs as :func:`liu_west_move` less
        the random numbers."""
        dev = self.device
        draws = torch.as_tensor(draws, device=dev)
        N, D, P = draws.shape
        u0, eps = self._draw(N, D, P, draws.dtype)
        self._signatures.add((N, D, P, str(draws.dtype)))
        return liu_west_move(
            draws,
            torch.as_tensor(log_w, device=dev),
            torch.as_tensor(alpha, device=dev),
            torch.as_tensor(ll, device=dev),
            torch.as_tensor(ok, device=dev),
            u0,
            eps,
            shrink=self.shrink,
        )
