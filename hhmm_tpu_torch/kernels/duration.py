"""Explicit-duration (HSMM) state-space expansion (counterpart of
``hhmm_tpu/kernels/duration.py``).

An explicit-duration HSMM (Yu 2010) over K regimes, each with a duration
pmf on {1..Dmax}, is an ordinary HMM on the ``K * Dmax`` states of the
count-down encoding

    expanded state s = k * Dmax + c,   c = remaining steps AFTER this one

with ``(k, c > 0) -> (k, c - 1)`` at log-probability 0 and ``(k, 0) ->
(j, d - 1)`` at ``log A[k, j] + log p_j(d)``. Every recursion of the
port (the FFBS, value-and-grad and decode kernels) runs unchanged on the
expanded chain; this module builds the expanded ``(log_pi, log_A,
log_obs)`` and collapses expanded posteriors back, over any leading lane
axes. Off-structure cells sit at the finite ``MASK_NEG`` floor; a
forbidden duration may arrive as a ``-inf`` cell of ``log_dur`` and
passes through the entry rows untouched.

The count-down structure is built in NumPy once per ``(K, Dmax)``,
device and dtype: the continue cells' 0 over the ``MASK_NEG`` floor, and
which rows are entry rows. A call of
:func:`expand_transition` is then three ops: the entry block's add, one
``where`` of it into the cached rows, and the reshape.

Degeneracy contract: at ``Dmax == 1`` with ``log_dur == 0.0`` every
expansion is the bitwise identity (``x + 0.0`` is exact on logs of
values in (0, 1]), so a ``Dmax = 1`` HSMM is the plain HMM, draw for
draw.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from hhmm_tpu_torch.core.lmath import MASK_NEG, safe_logsumexp

__all__ = [
    "expand_transition",
    "expand_initial",
    "expand_obs",
    "regime_log_marginals",
    "collapse_probs",
    "duration_posterior",
    "regime_path",
]


_STRUCTURE: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_STRUCTURE_LOCK = threading.Lock()


def _structure(K: int, Dmax: int, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rest [K, Dmax, K*Dmax], entry [K, Dmax, 1] bool)`` on ``like``'s
    device and dtype, built once in NumPy: row ``(k, c)`` of the expanded
    operator off its entry rows (0 at the continue cell ``(k, c - 1)``,
    ``MASK_NEG`` elsewhere), and whether row ``(k, c)`` is an entry row
    (``c == 0``)."""
    key = (K, Dmax, like.device, like.dtype)
    with _STRUCTURE_LOCK:  # serving threads expand concurrently
        if key not in _STRUCTURE:
            c = np.arange(Dmax)
            cont = ((c[:, None] == c[None, :] + 1)[None, :, None, :]
                    & np.eye(K, dtype=bool)[:, None, :, None])
            rest = np.where(cont, 0.0, MASK_NEG).reshape(K, Dmax, K * Dmax)
            entry = np.broadcast_to((c == 0)[None, :, None], (K, Dmax, 1)).copy()
            _STRUCTURE[key] = (torch.as_tensor(rest, dtype=like.dtype, device=like.device),
                               torch.as_tensor(entry, device=like.device))
        return _STRUCTURE[key]


def expand_transition(log_A: torch.Tensor, log_dur: torch.Tensor) -> torch.Tensor:
    """Expanded transition operator ``[..., K*Dmax, K*Dmax]`` from regime
    transitions ``log_A [..., K, K]`` and the duration log-pmf ``log_dur
    [..., K, Dmax]`` (``log_dur[k, d-1]`` = log P(duration = d | regime
    k)): entry rows ``(k, 0)`` hold ``log_A[k, j] + log_dur[j, d-1]`` at
    ``(j, d-1)``, count-down rows 0 at ``(k, c-1)``, every other cell
    ``MASK_NEG``. Keeps ``log_A``'s dtype."""
    K, Dmax = log_dur.shape[-2:]
    if tuple(log_A.shape[-2:]) != (K, K):
        raise ValueError(
            f"log_A {tuple(log_A.shape)} inconsistent with log_dur {tuple(log_dur.shape)}"
        )
    if Dmax == 1:
        # bitwise degeneracy: the entry block only
        return log_A + log_dur.transpose(-1, -2)
    lead = torch.broadcast_shapes(log_A.shape[:-2], log_dur.shape[:-2])
    entry = (log_A[..., :, :, None] + log_dur[..., None, :, :]).reshape(lead + (K, 1, K * Dmax))
    rest, is_entry = _structure(K, Dmax, log_A)
    return torch.where(is_entry, entry, rest).reshape(lead + (K * Dmax, K * Dmax))


def expand_initial(log_pi: torch.Tensor, log_dur: torch.Tensor) -> torch.Tensor:
    """Expanded initial distribution ``[..., K*Dmax]``: ``log p(s_1 = (k,
    d-1)) = log_pi[k] + log_dur[k, d-1]``."""
    out = log_pi[..., :, None] + log_dur
    return out.reshape(out.shape[:-2] + (-1,))


def expand_obs(log_obs: torch.Tensor, Dmax: int) -> torch.Tensor:
    """Expanded emissions ``[..., T, K*Dmax]`` from per-regime emissions
    ``[..., T, K]``: each regime's column repeated over its ``Dmax``
    count-down states."""
    return log_obs.repeat_interleave(Dmax, dim=-1) if Dmax > 1 else log_obs


def regime_log_marginals(log_post: torch.Tensor, Dmax: int) -> torch.Tensor:
    """Expanded log-posteriors ``[..., K*Dmax]`` → regime log-marginals
    ``[..., K]`` (guarded logsumexp over the count-down axis: an
    all-masked regime stays at ``MASK_NEG``, no NaN)."""
    if Dmax == 1:
        return log_post
    grid = log_post.reshape(log_post.shape[:-1] + (log_post.shape[-1] // Dmax, Dmax))
    return safe_logsumexp(grid, dim=-1, floor=MASK_NEG)


def collapse_probs(probs, Dmax: int):
    """Expanded probability vectors ``[..., K*Dmax]`` → regime
    probabilities ``[..., K]`` (reshape and sum); numpy arrays and
    tensors alike."""
    if Dmax == 1:
        return probs
    shp = tuple(probs.shape)
    return probs.reshape(shp[:-1] + (shp[-1] // Dmax, Dmax)).sum(axis=-1)


def duration_posterior(log_post: torch.Tensor, Dmax: int) -> torch.Tensor:
    """Remaining-duration posterior ``[..., K, Dmax]`` from expanded
    log-posteriors ``[..., K*Dmax]``: cell ``[k, c]`` is the probability
    of regime k with c steps remaining."""
    return torch.exp(log_post.reshape(log_post.shape[:-1] + (log_post.shape[-1] // Dmax, Dmax)))


def regime_path(z: torch.Tensor, Dmax: int) -> torch.Tensor:
    """Expanded state paths → regime paths: ``s = k * Dmax + c -> k``."""
    return z if Dmax == 1 else z // Dmax
