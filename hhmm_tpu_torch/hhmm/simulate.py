"""Recursive HHMM generative engine, host-side (the port's copy of
``hhmm_tpu/hhmm/simulate.py``: the same ``np.random.Generator`` calls,
so a seed gives the same leaf ids and observations bit for bit).

Behavioral equivalent of the reference's ``activate`` generics
(`hhmm/R/hhmm-sim.R:63-110`): vertical activation samples a child by
``pi``; a production leaf emits one observation and transitions
horizontally among its siblings by the parent's transition matrix; an
End target returns control to the grandparent level; exit at root level
restarts via the root's ``pi`` (`hhmm/R/hhmm-sim.R:73-77`).

Implemented iteratively (no recursion-depth limit — the reference had to
raise R's via ``options(expressions=1e4)``, `hhmm/main.R:107`). This is
data-dependent control flow, so it runs on host with NumPy, like the
zig-zag feature extraction (SURVEY.md §7.3); the card only ever sees
the *compiled* flat HMM (:mod:`hhmm_tpu_torch.hhmm.compile`), whose
transition law this simulator cross-validates.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np

from hhmm_tpu_torch.hhmm.structure import End, Internal, Production

__all__ = ["hhmm_sim", "sample_emission"]


def sample_emission(obs: Any, rng: np.random.Generator):
    """Draw one observation from an emission spec (see Production.obs)."""
    if callable(obs):
        return obs(rng)
    kind, par = obs
    if kind == "gaussian":
        return rng.normal(par["mu"], par["sigma"])
    if kind == "categorical":
        phi = np.asarray(par["phi"], dtype=np.float64)
        return int(rng.choice(len(phi), p=phi / phi.sum()))
    raise ValueError(f"unknown emission spec {kind!r}")


def _vertical(node: Internal, rng: np.random.Generator) -> Production:
    """Descend via pi until a Production leaf
    (`hhmm/R/hhmm-sim.R:79-82`)."""
    while isinstance(node, Internal):
        j = rng.choice(len(node.children), p=node.pi)
        node = node.children[j]
        if isinstance(node, End):  # excluded by finalize's pi check
            raise RuntimeError("vertical activation reached an End node")
    return node


def _horizontal(leaf: Production, root: Internal, rng: np.random.Generator):
    """One horizontal move after an emission: returns the next node to
    enter vertically (`hhmm/R/hhmm-sim.R:84-99,73-77`)."""
    cur = leaf
    while True:
        parent = cur.parent
        if parent is None:  # cur is root: restart
            return cur
        j = rng.choice(len(parent.children), p=parent.A[cur.index])
        target = parent.children[j]
        if isinstance(target, End):
            cur = parent
            continue
        return target


def hhmm_sim(
    root: Internal, T: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate ``(leaf_ids [T] int32, x [T])`` from a finalized tree
    (the reference's ``activate(r, T.length = T)``,
    `hhmm/R/hhmm-sim.R:63-71`)."""
    leaf = _vertical(root, rng)
    leaf_ids = np.empty(T, dtype=np.int32)
    xs = []
    for t in range(T):
        leaf_ids[t] = leaf.leaf_id
        xs.append(sample_emission(leaf.obs, rng))
        if t + 1 < T:
            nxt = _horizontal(leaf, root, rng)
            leaf = _vertical(nxt, rng) if isinstance(nxt, Internal) else nxt
    return leaf_ids, np.asarray(xs)
