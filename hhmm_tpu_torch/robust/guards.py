"""Per-lane chain-health guards (counterpart of
``hhmm_tpu/robust/guards.py``): a lane whose proposed state holds a
non-finite float is kept at its previous state, and its ``healthy`` flag
drops for good. On all-finite inputs every helper is an exact identity.

State is a dict of tensors (or a tensor) whose leading ``batch_ndim``
axes are the lanes.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

__all__ = ["finite_mask", "all_finite", "guard_where", "guard_update"]

Tree = Union[torch.Tensor, Dict[str, torch.Tensor], tuple, list]


def _leaves(tree: Tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [leaf for v in tree for leaf in _leaves(v)]


def finite_mask(tree: Tree, batch_ndim: int = 1) -> torch.Tensor:
    """Per-lane finiteness of every float leaf: reduces all axes after
    the leading ``batch_ndim`` ones. Integer/bool leaves are ignored."""
    ok = None
    for leaf in _leaves(tree):
        if not leaf.is_floating_point():
            continue
        f = torch.isfinite(leaf).reshape(leaf.shape[:batch_ndim] + (-1,)).all(-1)
        ok = f if ok is None else ok & f
    if ok is None:
        raise ValueError("finite_mask needs at least one float leaf")
    return ok


def all_finite(*trees: Tree, batch_ndim: int = 1) -> torch.Tensor:
    """Per-lane bool: every float leaf of every argument is finite."""
    ok = None
    for tree in trees:
        f = finite_mask(tree, batch_ndim)
        ok = f if ok is None else ok & f
    return ok


def guard_where(ok: torch.Tensor, new: Tree, old: Tree) -> Tree:
    """Per-leaf ``torch.where(ok, new, old)`` with ``ok`` (the leading
    lane axes) broadcast over each leaf's trailing axes; a NamedTuple
    comes back as its own type."""
    if isinstance(new, torch.Tensor):
        cond = ok.reshape(ok.shape + (1,) * (new.ndim - ok.ndim))
        return torch.where(cond, new, old)
    if isinstance(new, dict):
        return {k: guard_where(ok, new[k], old[k]) for k in new}
    leaves = [guard_where(ok, n, o) for n, o in zip(new, old)]
    return type(new)(*leaves) if hasattr(new, "_fields") else type(new)(leaves)


def guard_update(
    healthy: torch.Tensor, new: Tree, old: Tree, batch_ndim: int = 1
) -> Tuple[Tree, torch.Tensor]:
    """The chain-health transition guard: a lane keeps ``new`` only if it
    was ``healthy`` and ``new`` is entirely finite; otherwise it stays at
    ``old`` and its flag drops for good. Returns ``(state, healthy')``
    with ``healthy' = healthy & finite(new)``."""
    ok = healthy & finite_mask(new, batch_ndim)
    return guard_where(ok, new, old), ok
