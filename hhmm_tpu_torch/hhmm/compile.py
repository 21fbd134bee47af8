"""HHMM → flat sparse HMM compiler (counterpart of
``hhmm_tpu/hhmm/compile.py``: the NumPy compiler copied, the
differentiable :func:`compile_params` in torch, batch-native).

Generalizes the hand derivation Tayal performed for the 2×2 bull/bear
tree (`tayal2009/main.Rmd:306-345`: expand the hierarchy into one flat
state per production leaf, with transition mass routed through End
states and re-entry distributions) to *any* finalized tree. The
compiled (π, A) drive the flat kernels / model zoo — the hierarchy is a
structure DSL, the card only ever sees a flat HMM.

Math: let ent(n) be the distribution over leaves reached by vertical
activation of n (leaf → itself; internal → Σ_j pi_j · ent(child_j)).
From leaf p the horizontal move walks up: at each ancestor level the
sibling row A[i] sends mass either into a sibling subtree (→ ent) or
onto End children, which forwards the remaining mass one level up; mass
exiting at root level restarts via ent(root)
(`hhmm/R/hhmm-sim.R:84-99,73-77`). The flat matrix is therefore exactly
the law of "emit → next leaf" of the recursive engine, which
``tests/test_hhmm.py`` verifies empirically against the simulator
(:func:`hhmm_tpu_torch.hhmm.simulate.hhmm_sim` is its copy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from hhmm_tpu_torch.hhmm.structure import End, Internal, Production, iter_leaves, leaf_groups

__all__ = [
    "FlatHMM",
    "compile_hhmm",
    "compile_params",
    "gaussian_leaf_params",
    "categorical_leaf_params",
]


@dataclass(frozen=True)
class FlatHMM:
    """Expanded sparse HMM: one state per production leaf."""

    pi: np.ndarray  # [K]
    A: np.ndarray  # [K, K] row-stochastic
    leaves: Tuple[Production, ...]  # leaf_id order
    groups: np.ndarray  # top-state (depth-1 ancestor) label per leaf

    @property
    def K(self) -> int:
        return self.pi.shape[0]

    @property
    def names(self) -> List[str]:
        return [leaf.name or f"leaf{leaf.leaf_id}" for leaf in self.leaves]


def _entry_dist(node, n_leaves: int) -> np.ndarray:
    if isinstance(node, Production):
        e = np.zeros(n_leaves)
        e[node.leaf_id] = 1.0
        return e
    e = np.zeros(n_leaves)
    for j, child in enumerate(node.children):
        if node.pi[j] > 0.0 and not isinstance(child, End):
            e += node.pi[j] * _entry_dist(child, n_leaves)
    return e


def compile_hhmm(root: Internal) -> FlatHMM:
    """Compile a finalized tree into the equivalent flat HMM."""
    leaves = iter_leaves(root)
    K = len(leaves)
    if K == 0:
        raise ValueError("tree has no production leaves")
    ent_cache = {}

    def ent(node):
        key = id(node)
        if key not in ent_cache:
            ent_cache[key] = _entry_dist(node, K)
        return ent_cache[key]

    A = np.zeros((K, K))
    for p in leaves:
        mult = 1.0
        cur = p
        while True:
            parent = cur.parent
            if parent is None:  # exited at root level → restart via pi
                A[p.leaf_id] += mult * ent(cur)
                break
            row = parent.A[cur.index]
            end_mass = 0.0
            for j, sib in enumerate(parent.children):
                if isinstance(sib, End):
                    end_mass += row[j]
                elif row[j] > 0.0:
                    A[p.leaf_id] += mult * row[j] * ent(sib)
            mult *= end_mass
            cur = parent
            if mult == 0.0:
                break

    pi = ent(root)
    if not np.allclose(A.sum(axis=1), 1.0, atol=1e-10):
        raise AssertionError(f"compiled A rows sum to {A.sum(axis=1)}")
    if not np.isclose(pi.sum(), 1.0, atol=1e-10):
        raise AssertionError(f"compiled pi sums to {pi.sum()}")
    return FlatHMM(pi=pi, A=A, leaves=tuple(leaves), groups=leaf_groups(root, depth=1))


def gaussian_leaf_params(flat: FlatHMM) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-leaf Gaussian (mu, sigma) — the compiled tree as inputs
    to the Gaussian-emission models/simulators."""
    mu = np.array([leaf.obs[1]["mu"] for leaf in flat.leaves])
    sigma = np.array([leaf.obs[1]["sigma"] for leaf in flat.leaves])
    return mu, sigma


def categorical_leaf_params(flat: FlatHMM) -> np.ndarray:
    """Stack per-leaf categorical emission rows ``phi [K, L]``."""
    return np.stack([np.asarray(leaf.obs[1]["phi"], dtype=np.float64) for leaf in flat.leaves])


def compile_params(root: Internal, pi_of, A_of):
    """Differentiable compile: same expansion algebra as
    :func:`compile_hhmm`, but per-node (pi, A) values come from the
    callables ``pi_of(node) -> [..., n]`` / ``A_of(node) -> [..., n, n]``
    (tensors whose leading axes are lanes; a node without lanes, such as
    a deterministic row taken from the spec, broadcasts). The
    *structure* — which entries are reachable, where End exits route —
    is taken from the spec's numeric arrays, so the expansion never
    branches on values. Returns ``(pi [..., K], A [..., K, K])``.

    This is the readable definition of the flat (π, A) of a tree's
    parameters: ``models/tree.py::TreeHMM.assemble`` evaluates the same
    algebra from a precompiled monomial plan and is held to this
    function.
    """
    leaves = iter_leaves(root)
    K = len(leaves)
    ent_cache = {}
    A_cache = {}
    ref = torch.as_tensor(pi_of(root))
    zeros = torch.zeros(K, dtype=ref.dtype, device=ref.device)

    def A_at(node):
        # one materialization per node: A_of may stack rows / convert
        # constants, and it is consulted once per (leaf, ancestor) pair
        key = id(node)
        if key not in A_cache:
            A_cache[key] = torch.as_tensor(A_of(node), dtype=ref.dtype, device=ref.device)
        return A_cache[key]

    def ent(node):
        if isinstance(node, Production):
            e = zeros.clone()
            e[node.leaf_id] = 1.0
            return e
        key = id(node)
        if key not in ent_cache:
            pi_val = torch.as_tensor(pi_of(node), dtype=ref.dtype, device=ref.device)
            e = zeros
            for j, child in enumerate(node.children):
                if node.pi[j] > 0.0 and not isinstance(child, End):
                    e = e + pi_val[..., j, None] * ent(child)
            ent_cache[key] = e
        return ent_cache[key]

    rows = []
    for p in leaves:
        acc = zeros
        mult = torch.ones((), dtype=ref.dtype, device=ref.device)
        cur = p
        while True:
            parent = cur.parent
            if parent is None:  # exited at root level → restart via pi
                acc = acc + mult[..., None] * ent(cur)
                break
            row_spec = parent.A[cur.index]
            row_val = A_at(parent)[..., cur.index, :]
            end_struct = 0.0
            end_val = torch.zeros((), dtype=ref.dtype, device=ref.device)
            for j, sib in enumerate(parent.children):
                if isinstance(sib, End):
                    if row_spec[j] > 0.0:
                        end_struct += row_spec[j]
                        end_val = end_val + row_val[..., j]
                elif row_spec[j] > 0.0:
                    acc = acc + (mult * row_val[..., j])[..., None] * ent(sib)
            if end_struct == 0.0:
                break
            mult = mult * end_val
            cur = parent
        rows.append(acc)

    pi = ent(root)
    rows = torch.broadcast_tensors(*rows, pi)
    return rows[-1], torch.stack(rows[:-1], dim=-2)
