"""HHMM structure DSL — node taxonomy and tree validation (the port's
copy of ``hhmm_tpu/hhmm/structure.py``, NumPy only).

Equivalent of the reference's S3 node classes
(`hhmm/R/hhmm-sim.R:3-26`): plain dataclasses instead of mutable
environments with ``ref``-pointer hacks (the reference's self-described
"ugliest hack", `hhmm/R/hhmm-sim.R:48-61`). Parent pointers and child
indices are assigned once by :func:`finalize`, which also validates the
tree (the orphan-node checks of `hhmm/main.R:93-103`, plus stochasticity
checks the reference lacks).

Convention note: transition matrices here are **row-stochastic**
(``A[i, j] = P(next sibling j | current sibling i)``). The reference
writes its matrices row-wise too (``byrow = TRUE`` everywhere) but then
samples from *column* ``A_d[, i]`` (`hhmm/R/hhmm-sim.R:86`), silently
renormalized by R's ``sample`` — a defect (row/column mix-up) we document
rather than replicate; SURVEY.md §2.8.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Union

import numpy as np

__all__ = ["Production", "End", "Internal", "Node", "finalize", "iter_leaves", "leaf_groups"]


@dataclass
class Production:
    """Leaf that emits one observation per activation
    (`hhmm/R/hhmm-sim.R:21-26,101-110`). ``obs`` is an emission spec:
    ``("gaussian", {"mu": m, "sigma": s})``, ``("categorical",
    {"phi": probs})``, or a callable ``rng -> value``."""

    obs: Any = None
    name: str = ""
    parent: Optional["Internal"] = field(default=None, repr=False, compare=False)
    index: int = -1  # position among siblings
    leaf_id: int = -1  # flat state id, assigned by finalize (DFS order)


@dataclass
class End:
    """Exit marker: landing here returns control to the grandparent level
    (`hhmm/R/hhmm-sim.R:97-99`)."""

    name: str = ""
    parent: Optional["Internal"] = field(default=None, repr=False, compare=False)
    index: int = -1


@dataclass
class Internal:
    """Internal (or root) node: owns the vertical-entry distribution
    ``pi`` and the sibling transition matrix ``A`` over its children
    (`hhmm/R/hhmm-sim.R:8-13`). The root is simply an Internal with no
    parent; on horizontal exit at root level the process restarts via
    ``pi`` (`hhmm/R/hhmm-sim.R:73-77`)."""

    pi: np.ndarray = None
    A: np.ndarray = None
    children: List["Node"] = field(default_factory=list)
    name: str = ""
    parent: Optional["Internal"] = field(default=None, repr=False, compare=False)
    index: int = -1


Node = Union[Production, End, Internal]


def finalize(root: Internal) -> Internal:
    """Assign parent pointers, sibling indices, and DFS leaf ids; validate.

    Checks (superset of `hhmm/main.R:93-103`'s orphan checks):
    - pi/A shapes match the child count; entries non-negative,
    - pi sums to 1 with zero mass on End children (entering a subtree
      and immediately exiting is not a generative step),
    - each non-End row of A sums to 1 (End rows are never used as a
      source — control ascends instead — and are ignored),
    - no node instance appears twice in the tree (aliasing would let the
      second visit silently overwrite parent/index/leaf_id).
    """
    leaf_counter = [0]
    seen: set = set()

    def visit(node: Internal):
        if id(node) in seen:
            raise ValueError(f"node {node.name!r} appears more than once in the tree")
        seen.add(id(node))
        n = len(node.children)
        if n == 0:
            raise ValueError(f"internal node {node.name!r} has no children")
        node.pi = np.asarray(node.pi, dtype=np.float64)
        node.A = np.asarray(node.A, dtype=np.float64)
        if node.pi.shape != (n,):
            raise ValueError(f"{node.name!r}: pi shape {node.pi.shape} != ({n},)")
        if node.A.shape != (n, n):
            raise ValueError(f"{node.name!r}: A shape {node.A.shape} != ({n},{n})")
        if np.any(node.pi < 0) or np.any(node.A < 0):
            raise ValueError(f"{node.name!r}: negative probabilities")
        if not np.isclose(node.pi.sum(), 1.0, atol=1e-8):
            raise ValueError(f"{node.name!r}: pi must sum to 1")
        has_prod = False
        for j, child in enumerate(node.children):
            child.parent = node
            child.index = j
            if isinstance(child, End):
                if node.pi[j] != 0.0:
                    raise ValueError(
                        f"{node.name!r}: pi mass {node.pi[j]} on End child {j}"
                    )
            else:
                if not np.isclose(node.A[j].sum(), 1.0, atol=1e-8):
                    raise ValueError(
                        f"{node.name!r}: A row {j} sums to {node.A[j].sum()}, not 1"
                    )
            if isinstance(child, Production):
                child.leaf_id = leaf_counter[0]
                leaf_counter[0] += 1
                has_prod = True
            elif isinstance(child, Internal):
                visit(child)
                has_prod = True
        if not has_prod:
            raise ValueError(f"{node.name!r}: no Production-reachable descendant")

    root.parent = None
    visit(root)
    return root


def iter_leaves(root: Internal) -> List[Production]:
    """Production leaves in DFS (= leaf_id) order."""
    out: List[Production] = []

    def visit(node: Internal):
        for child in node.children:
            if isinstance(child, Production):
                out.append(child)
            elif isinstance(child, Internal):
                visit(child)

    visit(root)
    return out


def leaf_groups(root: Internal, depth: int = 1) -> np.ndarray:
    """Map each leaf to the index of its ancestor at ``depth`` levels
    below the root (depth=1 → top-state labels). This is the group label
    ``g`` the semi-supervised models condition on
    (`hmm/stan/hmm-multinom-semisup.stan:13`) and the Tayal top-state
    mapping (`tayal2009/main.R:157-184`)."""
    out = []

    def visit(node: Internal, path):
        for child in node.children:
            if isinstance(child, Production):
                out.append(path[depth - 1] if len(path) >= depth else child.index)
            elif isinstance(child, Internal):
                visit(child, path + [child.index])

    visit(root, [])
    return np.asarray(out, dtype=np.int32)
