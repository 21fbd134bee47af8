"""Fit any HHMM structure directly (counterpart of
``hhmm_tpu/models/tree.py``) — the reference's missing capability.

`hhmm/main.R:129,280` and `hhmm/sim-jangmin2004.R:1965` call Stan models
(`hhmm/stan/hhmm-semisup.stan`, `hhmm-unsup.stan`) that do not exist in
the repository (SURVEY.md §2.8 item 4). :class:`TreeHMM` provides what
those files were meant to: given a finalized
:class:`~hhmm_tpu_torch.hhmm.structure.Internal` tree, it

- treats the tree's numeric pi/A entries as *structure* (zero = forced,
  nonzero = free) and as chain-init values,
- exposes one constrained parameter per free slot: a
  :class:`~hhmm_tpu_torch.core.bijectors.MaskedSimplex` per internal-node
  pi and per sibling-transition row (deterministic rows — support size
  1 — cost no parameters),
- assembles the flat sparse (π, A) inside the target, so HMC samples the
  hierarchy's own parameters (gradients flow through the expansion),
- supports Gaussian leaves (ordered means, globally or per top-state
  group) and categorical leaves (per-leaf simplex rows),
- optionally conditions on observed top-state labels g[t]
  (``semisup=True``, `hmm/stan/hmm-multinom-semisup.stan:42-44`):
  ``gate_mode="stan"`` skips the transition factor on inconsistent
  destinations (gate keys in the hot loop), ``"hard"`` forbids them.

The expansion is precompiled once per tree, in NumPy, into a monomial
plan (:class:`_Expansion`): every flat ``A[i, j]`` and ``pi[j]`` is a sum
of products of node entries, so :meth:`TreeHMM.assemble` is a fixed
handful of batched ops (gather, products over the factors, sum over the
terms) whatever K is; the JAX package traces the symbolic
``compile_params`` once under ``jit`` instead, which run eagerly would be
one small op per node entry (about 3,900 for the 63-leaf Jangmin tree).
:func:`~hhmm_tpu_torch.hhmm.compile.compile_params` stays the readable
definition the plan is held to. The free slots' stick-breaking runs in
one padded block too (:meth:`TreeHMM.unpack`).

Batch-native: parameters carry leading lane axes, data ``x``, ``g``,
``mask`` ``[..., T]`` a prefix of them (``models/base.py::
broadcast_data``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hhmm_tpu_torch._device import resolve_device
from hhmm_tpu_torch.core.bijectors import (
    Bijector,
    Identity,
    MaskedSimplex,
    Ordered,
    Positive,
    Simplex,
)
from hhmm_tpu_torch.core.dists import gumbel_argmax_sample, normal_logpdf
from hhmm_tpu_torch.core.lmath import safe_log
from hhmm_tpu_torch.hhmm.compile import (
    categorical_leaf_params,
    compile_hhmm,
    gaussian_leaf_params,
)
from hhmm_tpu_torch.hhmm.routes import RouteTable
from hhmm_tpu_torch.hhmm.structure import End, Internal, Production, iter_leaves
from hhmm_tpu_torch.infer.gibbs import dirichlet, emission_counts
from hhmm_tpu_torch.models.base import BaseHMMModel, Params, broadcast_data, semisup_gate
from hhmm_tpu_torch.models.tayal import _Emissions

__all__ = ["TreeHMM"]


def _internal_nodes(root: Internal) -> List[Internal]:
    out = [root]

    def visit(node: Internal):
        for child in node.children:
            if isinstance(child, Internal):
                out.append(child)
                visit(child)

    visit(root)
    return out


class _TreeParams(dict):
    """A parameter dict that also holds the free slots' rows as one
    tensor ``slots [..., C]`` (each slot's entry of the dict is a view of
    it), so :meth:`TreeHMM.assemble` reads one tensor instead of
    concatenating one per slot. A plain dict works too."""

    slots: Optional[torch.Tensor] = None


class _PlanGather(torch.autograd.Function):
    """``v[..., idx]`` with a backward that sums each entry's gradient
    over its occurrences (``inv [V, occ]``, padded with ``len(idx)``) as
    a gather and a plain reduction: the gather's own backward scatters
    with atomic adds on CUDA, whose order changes from run to run (see
    ``models/tayal.py::_Emissions``)."""

    @staticmethod
    def forward(ctx, v, idx, inv):
        ctx.save_for_backward(inv)
        return v[..., idx]

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros(g.shape[:-1] + (1,))], dim=-1)
        return g[..., inv].sum(-1), None, None


class _Expansion:
    """The tree expansion of ``compile_params`` as a monomial plan, built
    once per tree in NumPy.

    Each flat cell (``A[i, j]`` at ``i * K + j``, ``pi[j]`` at ``K * K +
    j``) is a sum of terms ``coef * prod_m v[idx[c, r, m]]`` over the
    vector ``v = [slots, 1]``: the free slots' concatenated rows, then a
    one that pads short products. Spec constants (deterministic rows)
    are folded into ``coef``; a row with several supported End columns
    simply multiplies out into more terms. Where the tree allows it
    these are the routes of :class:`~hhmm_tpu_torch.hhmm.routes.
    RouteTable`, one term a route."""

    def __init__(self, root: Internal, inodes: List[Internal], slots):
        leaves = iter_leaves(root)
        K = len(leaves)
        node_idx = {id(n): d for d, n in enumerate(inodes)}
        col_of, off = {}, 0  # (node, kind, row) -> first column in v
        for _name, kind, d, i, support in slots:
            col_of[(d, kind, i)] = off
            off += len(support)
        self.C = off

        # polynomials: lists of monomials, a monomial a tuple of entries
        # (node index, kind, row, column); vectors: {leaf: polynomial}
        ent_cache: Dict[int, Dict[int, list]] = {}

        def ent(node):
            if isinstance(node, Production):
                return {node.leaf_id: [()]}
            key = id(node)
            if key not in ent_cache:
                d = node_idx[key]
                out: Dict[int, list] = {}
                for j, child in enumerate(node.children):
                    if node.pi[j] > 0.0 and not isinstance(child, End):
                        e = (d, "pi", -1, j)
                        for leaf, poly in ent(child).items():
                            out.setdefault(leaf, []).extend((e,) + m for m in poly)
                ent_cache[key] = out
            return ent_cache[key]

        cells: Dict[int, list] = {}
        for p in leaves:
            mult = [()]
            cur = p
            while True:
                parent = cur.parent
                if parent is None:  # exited at root level → restart via pi
                    for leaf, poly in ent(cur).items():
                        cells.setdefault(p.leaf_id * K + leaf, []).extend(
                            a + b for a in mult for b in poly)
                    break
                d = node_idx[id(parent)]
                row_spec = parent.A[cur.index]
                exits = []
                for j, sib in enumerate(parent.children):
                    if row_spec[j] <= 0.0:
                        continue
                    e = (d, "A", cur.index, j)
                    if isinstance(sib, End):
                        exits.append(e)
                    else:
                        for leaf, poly in ent(sib).items():
                            cells.setdefault(p.leaf_id * K + leaf, []).extend(
                                a + (e,) + b for a in mult for b in poly)
                if not exits:
                    break
                mult = [a + (e,) for a in mult for e in exits]
                cur = parent
        for leaf, poly in ent(root).items():
            cells.setdefault(K * K + leaf, []).extend(poly)

        def factor(entry):
            """``(column in v, None)`` of a free entry, ``(None, value)``
            of a spec constant."""
            d, kind, row, col = entry
            base = col_of.get((d, kind, row))
            if base is not None:
                return base + col, None
            node = inodes[d]
            return None, float((node.pi if kind == "pi" else node.A[row])[col])

        order = sorted(cells)
        R = max(len(cells[c]) for c in order)
        terms = []
        for c in order:
            row = []
            for mono in cells[c]:
                cols, coef = [], 1.0
                for entry in mono:
                    col, val = factor(entry)
                    if col is None:
                        coef *= val
                    else:
                        cols.append(col)
                row.append((cols, coef))
            terms.append(row)
        M = max([len(cols) for row in terms for cols, _ in row] + [1])
        idx = np.full((len(order), R, M), self.C, np.int64)  # C: the padding one
        coef = np.zeros((len(order), R))
        for ci, row in enumerate(terms):
            for r, (cols, cf) in enumerate(row):
                idx[ci, r, : len(cols)] = cols
                coef[ci, r] = cf
        cell_map = np.full(K * K + K, len(order), np.int64)  # len(order): zero
        cell_map[np.asarray(order)] = np.arange(len(order))
        # occurrences of each column of v in idx, for the gather's backward
        flat = idx.reshape(-1)
        occ = [np.flatnonzero(flat == v) for v in range(self.C)] + [np.zeros(0, np.int64)]
        inv = np.full((self.C + 1, max(len(o) for o in occ) or 1), flat.size, np.int64)
        for v, o in enumerate(occ):
            inv[v, : len(o)] = o
        self.K, self.R, self.M, self.n_cells = K, R, M, len(order)
        self.idx, self.coef, self.cell_map, self.inv = flat, coef, cell_map, inv
        self._dev: Dict[Tuple[str, torch.dtype], tuple] = {}

    def on(self, ref: torch.Tensor):
        """The plan's index and coefficient tensors on ``ref``'s device,
        made once per device."""
        key = (str(ref.device), ref.dtype)
        if key not in self._dev:
            dev = ref.device
            self._dev[key] = (
                torch.as_tensor(self.idx, device=dev),
                torch.as_tensor(self.inv, device=dev),
                torch.as_tensor(self.coef, dtype=ref.dtype, device=dev),
                torch.as_tensor(self.cell_map, device=dev),
            )
        return self._dev[key]

    def __call__(self, slots: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(pi [..., K], A [..., K, K])`` from the slots' rows ``[...,
        C]``: one gather, M - 1 products (one by one: ``torch.prod``'s
        backward takes a special path at zeros), one sum over the terms,
        one gather of the cells into the flat matrix."""
        idx, inv, coef, cell_map = self.on(slots)
        lead = slots.shape[:-1]
        v = torch.cat([slots, slots.new_ones(lead + (1,))], dim=-1)
        f = _PlanGather.apply(v, idx, inv).reshape(lead + (self.n_cells, self.R, self.M))
        prod, *rest = f.unbind(-1)
        for factor in rest:
            prod = prod * factor
        cell = (prod * coef).sum(-1)
        flat = torch.cat([cell, cell.new_zeros(lead + (1,))], dim=-1)[..., cell_map]
        K = self.K
        return flat[..., K * K :], flat[..., : K * K].reshape(lead + (K, K))


class TreeHMM(BaseHMMModel):
    """Model over an HHMM structure tree, fittable by NUTS, ChEES and
    (with ``order_mu="none"`` and proper priors) the route-augmented
    blocked Gibbs sampler.

    ``root`` must be finalized; its numeric pi/A double as structural
    support and chain-init values. ``order_mu`` ∈ {"global", "group",
    "none"} (Gaussian leaves only; default "group" when ``semisup``
    else "global").

    Gaussian leaves carry weakly-informative priors μ ~ N(0,
    ``prior_mu_scale``), σ ~ half-N(0, ``prior_sigma_scale``): a deep
    tree routinely has leaves with no assigned observations (the 63-leaf
    Jangmin tree on T=100), whose μ/σ posterior is improper under a flat
    prior. Set the scales to ``None`` to recover flat priors.
    """

    def __init__(
        self,
        root: Internal,
        semisup: bool = False,
        gate_mode: str = "stan",
        order_mu: Optional[str] = None,
        prior_mu_scale: Optional[float] = 10.0,
        prior_sigma_scale: Optional[float] = 3.0,
    ):
        if gate_mode not in ("stan", "hard"):
            raise ValueError("gate_mode must be 'stan' or 'hard'")
        self.prior_mu_scale = prior_mu_scale
        self.prior_sigma_scale = prior_sigma_scale
        self.root = root
        self.flat0 = compile_hhmm(root)  # numeric spec compile: init + groups
        self.K = self.flat0.K
        self.leaves = self.flat0.leaves
        self.groups = self.flat0.groups
        self.semisup = semisup
        self.gate_mode = gate_mode

        fams = {(leaf.obs[0] if isinstance(leaf.obs, tuple) else "callable") for leaf in self.leaves}
        if fams == {"gaussian"}:
            self.family = "gaussian"
        elif fams == {"categorical"}:
            self.family = "categorical"
        else:
            raise ValueError(
                f"TreeHMM needs homogeneous gaussian or categorical leaves, got {fams}"
            )
        if order_mu is None:
            order_mu = "group" if semisup else "global"
        if order_mu not in ("global", "group", "none"):
            raise ValueError("order_mu must be 'global', 'group', or 'none'")
        self.order_mu = order_mu
        if self.family == "categorical":
            Ls = {len(np.asarray(leaf.obs[1]["phi"])) for leaf in self.leaves}
            if len(Ls) != 1:
                raise ValueError(f"categorical leaves disagree on L: {Ls}")
            self.L = Ls.pop()

        # group blocks must be contiguous in leaf (DFS) order for the
        # per-group ordered-mean bijectors
        self._group_sizes = []
        g = np.asarray(self.groups)
        if self.order_mu == "group":
            boundaries = np.flatnonzero(np.diff(g)) + 1
            blocks = np.split(g, boundaries)
            if len({b[0] for b in blocks}) != len(blocks):
                raise ValueError("top-state groups are not contiguous in leaf order")
            self._group_sizes = [len(b) for b in blocks]

        # free probability slots, in deterministic node-DFS order
        self._inodes = _internal_nodes(root)
        self._slots: List[Tuple[str, str, int, int, np.ndarray]] = []
        # (param_name, kind, node_idx, row_idx, support)
        for d, node in enumerate(self._inodes):
            pi_support = np.asarray(node.pi) > 0.0
            if pi_support.sum() > 1:
                self._slots.append((f"pi_n{d}", "pi", d, -1, pi_support))
            for i, child in enumerate(node.children):
                if isinstance(child, End):
                    continue
                row_support = np.asarray(node.A[i]) > 0.0
                if row_support.sum() > 1:
                    self._slots.append((f"A_n{d}_r{i}", "A", d, i, row_support))
        self._specs = self._make_specs()
        self._expansion = _Expansion(root, self._inodes, self._slots)
        self._simplex_plan()
        self._routes = None
        self._dev: Dict[str, Dict[str, torch.Tensor]] = {}

    # ---- parameters ----

    def _make_specs(self) -> List[Tuple[str, Bijector]]:
        out: List[Tuple[str, Bijector]] = [
            (name, MaskedSimplex(support)) for name, _, _, _, support in self._slots
        ]
        if self.family == "gaussian":
            if self.order_mu == "global":
                out.append(("mu", Ordered(shape=(self.K,))))
            elif self.order_mu == "group":
                for gi, sz in enumerate(self._group_sizes):
                    out.append((f"mu_g{gi}", Ordered(shape=(sz,))))
            else:
                out.append(("mu", Identity(shape=(self.K,))))
            out.append(("sigma", Positive(shape=(self.K,), lower=1e-4)))
        else:
            out.append(("phi_k", Simplex(shape=(self.K, self.L))))
        return out

    def specs(self) -> List[Tuple[str, Bijector]]:
        return list(self._specs)

    def _simplex_plan(self) -> None:
        """Index tables of the free slots' stick-breaking as one padded
        block ``[..., n_slots, B]`` (B the most breaks a slot has): slot
        s has ``m_s - 1`` breaks of ``theta``'s first ``P`` entries,
        offsets ``-log(m_s - 1 - k)`` as :class:`Simplex` takes them,
        and its ``m_s`` values go to its support columns of the slots'
        concatenated rows (``_Expansion.C`` columns)."""
        ms = [int(np.sum(s)) for *_, s in self._slots]
        self._n_slot_free = sum(m - 1 for m in ms)
        B = max(ms, default=1) - 1
        n = len(ms)
        P = self._n_slot_free
        brk = np.full((n, B), P, np.int64)  # P: a zero pad
        off = np.zeros((n, B))
        valid = np.zeros((n, B), bool)
        ymap = np.full(self._expansion.C, n * (B + 1), np.int64)  # n (B + 1): zero
        i, c = 0, 0
        for s, ((_name, _k, _d, _r, support), m) in enumerate(zip(self._slots, ms)):
            brk[s, : m - 1] = np.arange(i, i + m - 1)
            off[s, : m - 1] = -np.log(np.arange(m - 1, 0, -1))
            valid[s, : m - 1] = True
            cols = np.flatnonzero(support)
            ymap[c + cols[:-1]] = s * (B + 1) + np.arange(m - 1)
            ymap[c + cols[-1]] = s * (B + 1) + B
            i += m - 1
            c += len(support)
        self._brk = (brk, off, valid, ymap)
        self._slot_views = []
        c = 0
        for name, *_rest, support in self._slots:
            self._slot_views.append((name, c, c + len(support)))
            c += len(support)

    def _on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """Index tables on ``device``, made once per device."""
        key = str(device)
        if key not in self._dev:
            brk, off, valid, ymap = self._brk
            self._dev[key] = {
                "brk": torch.as_tensor(brk, device=device),
                "off": torch.as_tensor(off, device=device),
                "valid": torch.as_tensor(valid, device=device),
                "ymap": torch.as_tensor(ymap, device=device),
                "groups": torch.as_tensor(self.groups, dtype=torch.long, device=device),
            }
        return self._dev[key]

    def _slot_rows(self, theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(slots [..., C], log|J| [...])``: every free slot's
        :class:`MaskedSimplex` forward at once — :class:`Simplex`'s
        stick-breaking over the padded block, its values placed on the
        support columns."""
        t = self._on(theta.device)
        lead = theta.shape[:-1]
        x = torch.cat([theta[..., : self._n_slot_free], theta.new_zeros(lead + (1,))], dim=-1)
        logit_z = x[..., t["brk"]] + t["off"].to(theta.dtype)
        log_z = F.logsigmoid(logit_z)
        log_1mz = torch.where(t["valid"], F.logsigmoid(-logit_z), 0.0)
        log_rem = torch.cumsum(log_1mz, dim=-1)
        log_rem_before = F.pad(log_rem[..., :-1], (1, 0))
        # padded breaks add 0 to the stick: the last entry is log_rem[-1]
        log_y = torch.cat([log_z + log_rem_before, log_rem[..., -1:]], dim=-1)
        ldj = torch.where(t["valid"], log_z + log_1mz + log_rem_before, 0.0).sum((-2, -1))
        y = torch.exp(log_y).flatten(-2)
        rows = torch.cat([y, y.new_zeros(lead + (1,))], dim=-1)[..., t["ymap"]]
        return rows, ldj

    def _params_from_rows(self, rows: torch.Tensor) -> _TreeParams:
        params = _TreeParams()
        for name, a, b in self._slot_views:
            params[name] = rows[..., a:b]
        params.slots = rows
        return params

    def unpack(self, theta: torch.Tensor) -> Tuple[Params, torch.Tensor]:
        """``theta [..., n_free]`` → (constrained params, log|J| ``[...]``),
        the layout of ``specs()``; the free slots in one padded block."""
        if theta.shape[-1] != self.n_free:
            raise ValueError(
                f"theta has {theta.shape[-1]} free parameters, "
                f"{type(self).__name__} has {self.n_free}"
            )
        if self._slots:
            rows, ldj = self._slot_rows(theta)
            params = self._params_from_rows(rows)
        else:
            params = _TreeParams()
            ldj = theta.new_zeros(theta.shape[:-1])
        i = self._n_slot_free
        for name, bij in self._specs[len(self._slots) :]:
            val, d = bij.forward(theta[..., i : i + bij.n_free])
            params[name] = val
            ldj = ldj + d
            i += bij.n_free
        return params, ldj

    def spec_params(self) -> Dict[str, np.ndarray]:
        """Constrained parameter dict at the tree's own numeric values —
        chain-init center and the fixture for structure tests."""
        params: Dict[str, np.ndarray] = {}
        for name, kind, d, i, _ in self._slots:
            node = self._inodes[d]
            params[name] = np.asarray(node.pi if kind == "pi" else node.A[i], dtype=np.float64)
        if self.family == "gaussian":
            mu, sigma = gaussian_leaf_params(self.flat0)
            if self.order_mu == "group":
                start = 0
                for gi, sz in enumerate(self._group_sizes):
                    params[f"mu_g{gi}"] = np.sort(mu[start : start + sz])
                    start += sz
            elif self.order_mu == "global":
                params["mu"] = np.sort(mu)
            else:
                params["mu"] = mu
            params["sigma"] = sigma
        else:
            params["phi_k"] = categorical_leaf_params(self.flat0)
        return params

    def _mu(self, params: Params) -> torch.Tensor:
        if self.order_mu == "group":
            return torch.cat(
                [params[f"mu_g{gi}"] for gi in range(len(self._group_sizes))], dim=-1
            )
        return params["mu"]

    def _lead(self, params: Params) -> Tuple[int, ...]:
        if self.family == "gaussian":
            return tuple(params["sigma"].shape[:-1])
        return tuple(params["phi_k"].shape[:-2])

    # ---- assembly ----

    def assemble(self, params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat ``(pi [..., K], A [..., K, K])`` from the free slots
        through the precompiled expansion (:class:`_Expansion`)."""
        rows = getattr(params, "slots", None)
        if rows is None:
            if self._slots:
                rows = torch.cat([params[name] for name, *_ in self._slots], dim=-1)
            else:
                ref = params["sigma" if self.family == "gaussian" else "phi_k"]
                rows = ref.new_zeros(self._lead(params) + (0,))
        return self._expansion(rows)

    def log_prior(self, params: Params) -> torch.Tensor:
        ref = params["sigma" if self.family == "gaussian" else "phi_k"]
        lp = ref.new_zeros(self._lead(params))
        if self.family != "gaussian":
            return lp  # simplex params: flat proper (compact support)
        if self.prior_mu_scale is not None:
            lp = lp + normal_logpdf(self._mu(params), 0.0, self.prior_mu_scale).sum(-1)
        if self.prior_sigma_scale is not None:
            # half-normal: normal logpdf on the positive value (the
            # log 2 normalization is constant — dropped, as Stan does)
            lp = lp + normal_logpdf(params["sigma"], 0.0, self.prior_sigma_scale).sum(-1)
        return lp

    def _aligned(self, params: Params, data: Dict[str, torch.Tensor], key: str):
        return broadcast_data(data.get(key), self._lead(params))

    def _log_obs(self, params: Params, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = self._aligned(params, data, "x")
        if self.family == "gaussian":
            mu, sigma = self._mu(params), params["sigma"]
            return normal_logpdf(x[..., :, None], mu[..., None, :], sigma[..., None, :])
        # the emission gather with a run-to-run deterministic backward
        return _Emissions.apply(safe_log(params["phi_k"]), x.long())

    def _consistency(self, params: Params, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``[..., T, K]``: whether leaf k's top state matches the label
        g[t], the one source of the gate for the build and the Gibbs
        count weights."""
        g = self._aligned(params, data, "g")
        return g.long()[..., None] == self._on(g.device)["groups"]

    def build(self, params: Params, data: Dict[str, torch.Tensor]):
        pi, A = self.assemble(params)
        log_obs = self._log_obs(params, data)
        log_pi, log_A = safe_log(pi), safe_log(A)
        mask = self._aligned(params, data, "mask")
        if not self.semisup:
            return log_pi, log_A, log_obs, mask
        consistent = self._consistency(params, data)
        return (*semisup_gate(log_pi, log_A, log_obs, consistent, self.gate_mode), mask)

    def build_vg(self, params: Params, data: Dict[str, torch.Tensor]):
        """Hot-loop build: semisup stan-mode gating moves to gate keys so
        ``log_A`` stays homogeneous (the kernels apply the gate)."""
        if not self.semisup or self.gate_mode == "hard":
            return self.build(params, data)
        pi, A = self.assemble(params)
        log_obs = self._log_obs(params, data)
        return safe_log(pi), safe_log(A), log_obs, self._aligned(params, data, "mask")

    def gate_keys(self, data: Dict[str, torch.Tensor]):
        if not self.semisup or self.gate_mode == "hard":
            return None
        g = data["g"].to(torch.float32)  # [..., T] observed top-state labels
        groups = torch.as_tensor(self.groups, dtype=torch.float32, device=g.device)
        return g, groups.expand(g.shape[:-1] + (self.K,))

    @staticmethod
    def _placed(data: Dict[str, object]) -> Dict[str, torch.Tensor]:
        """Data arrays as tensors: a tensor keeps its device, anything
        else (a numpy array) goes to the card (``resolve_device(None)``,
        which raises without one)."""
        return {k: v if isinstance(v, torch.Tensor) or v is None
                else torch.as_tensor(v, device=resolve_device(None)) for k, v in data.items()}

    def make_logp(self, data):
        """:meth:`BaseHMMModel.make_logp` on :meth:`_placed` data."""
        return super().make_logp(self._placed(data))

    def make_vg(self, data):
        """:meth:`BaseHMMModel.make_vg` on :meth:`_placed` data: every
        leapfrog one ``FWD`` + ``VG_BWD`` call on the card."""
        return super().make_vg(self._placed(data))

    # ---- blocked Gibbs (route-augmented conjugacy) ----

    @property
    def routes(self) -> RouteTable:
        """Lazily-built static route table (`hhmm/routes.py`) — the data
        augmentation that factorizes the flat transition likelihood into
        per-node multinomials."""
        if self._routes is None:
            self._routes = RouteTable(self.root, self._inodes, self._slots)
            # flat gather plan for one vectorized Dirichlet draw across
            # every free slot: gamma(1 + counts) / segment sum
            pos, seg = [], []
            for si, (name, *_rest) in enumerate(self._slots):
                p = self._routes.slot_count_pos[name]
                pos.append(p)
                seg.append(np.full(len(p), si, np.int32))
            self._dir_pos = np.concatenate(pos) if pos else np.zeros(0, np.int32)
            self._dir_seg = np.concatenate(seg) if seg else np.zeros(0, np.int32)
            # the segment sum as a padded gather: row s lists slot s's
            # positions in the draw (padding: one past the end, a zero)
            width = max((len(p) for p in pos), default=1)
            seg_pad = np.full((len(pos), width), len(self._dir_pos), np.int64)
            # where each draw lands among the slots' concatenated rows
            dir_cols = np.zeros(len(self._dir_pos), np.int64)
            o, c = 0, 0
            for si, (name, *_rest, support) in enumerate(self._slots):
                n = len(pos[si])
                seg_pad[si, :n] = np.arange(o, o + n)
                dir_cols[o : o + n] = c + self._routes.slot_cols[name]
                o += n
                c += len(support)
            rows_map = np.full(self._expansion.C, len(self._dir_pos), np.int64)
            rows_map[dir_cols] = np.arange(len(self._dir_pos))
            self._dir_tables = (seg_pad, rows_map)
        return self._routes

    @property
    def gibbs_gate_modes(self):
        # hard semisup gating only masks emissions (transitions stay the
        # exact compiled HMM); the stan soft gate is conjugate through
        # destination-consistency count weights, as in models/tayal.py
        # (an inconsistent step's pairwise factor is a unit — no
        # information about any transition slot)
        return ("hard", "stan")

    def gibbs_update(
        self,
        generator: torch.Generator,
        z: torch.Tensor,
        data: Dict[str, torch.Tensor],
        params: Params,
    ) -> Params:
        """Conjugate parameter block for blocked Gibbs (``infer/gibbs.py``)
        on the tree's own parameters, over lanes ``z [N, T]`` — the
        sampler the reference's abandoned Jangmin replication needed
        (`hhmm/sim-jangmin2004.R:1963-2010`).

        Augments each flat step with its ROUTE through the hierarchy
        (drawn from the exact conditional — the per-route factors of
        `hhmm/routes.py`, whose sum is the compiled flat A). Given
        routes, every free MaskedSimplex slot's conditional under its
        flat prior is Dirichlet(1 + event counts): exit events
        (child→End), horizontal sibling moves, and vertical pi picks each
        increment exactly one entry of one node row. Gaussian leaves: mu
        | sigma is conjugate normal under the N(0, s_mu) prior; sigma
        takes 2 Metropolis-within-Gibbs steps in log-space targeting the
        half-normal-prior conditional. Categorical leaves: Dirichlet on
        emission counts. Requires ``order_mu="none"`` for Gaussian leaves
        (the ordered-cone constraint breaks per-leaf separability)."""
        if self.family == "gaussian":
            if self.order_mu != "none":
                raise ValueError(
                    "TreeHMM.gibbs_update needs order_mu='none' (the "
                    "ordered-mean constraint breaks per-leaf conjugacy); "
                    "use an HMC sampler for ordered models"
                )
            if self.prior_mu_scale is None:
                raise ValueError(
                    "TreeHMM.gibbs_update needs a proper mu prior "
                    "(prior_mu_scale); a flat prior is improper for "
                    "leaves with no assigned observations"
                )
            if self.prior_sigma_scale is None:
                raise ValueError(
                    "TreeHMM.gibbs_update needs a proper sigma prior "
                    "(prior_sigma_scale); a flat prior leaves the sigma "
                    "conditional improper for leaves with no assigned "
                    "observations"
                )
        rt = self.routes
        x = data["x"]
        mask = data.get("mask")
        z = z.long()
        dev = z.device

        # 1) route per step from its exact conditional
        lr = rt.route_logprobs(params).flatten(-3, -2)  # [N, K * K, R]
        pair = (z[..., :-1] * self.K + z[..., 1:])[..., None]
        step_lr = lr.gather(-2, pair.expand(pair.shape[:-1] + (rt.R,)))  # [N, T-1, R]
        routes = gumbel_argmax_sample(generator, step_lr)

        # 2) transition-event counts (soft gate: steps whose destination
        # is label-inconsistent carry a unit pairwise factor — zero
        # weight, exactly the Tayal consistency weighting)
        w = (torch.ones(z[..., 1:].shape, device=dev) if mask is None
             else mask[..., 1:].to(torch.float32))
        if self.semisup and self.gate_mode == "stan":
            cons = self._consistency(params, data)[..., 1:, :]
            w = w * cons.gather(-1, z[..., 1:, None])[..., 0].to(w.dtype)
        counts = rt.counts(z, routes, w)

        # 3) one vectorized Dirichlet draw across all free slots
        new = _TreeParams()
        if len(self._dir_pos):
            t = self._on(dev)
            if "dir_pos" not in t:
                seg_pad, rows_map = self._dir_tables
                t.update(dir_pos=torch.as_tensor(self._dir_pos, dtype=torch.long, device=dev),
                         dir_seg=torch.as_tensor(self._dir_seg, dtype=torch.long, device=dev),
                         seg_pad=torch.as_tensor(seg_pad, device=dev),
                         rows_map=torch.as_tensor(rows_map, device=dev))
            gam = torch._standard_gamma(1.0 + counts[..., t["dir_pos"]], generator=generator)
            gam_ext = torch.cat([gam, gam.new_zeros(gam.shape[:-1] + (1,))], dim=-1)
            vals = gam / gam_ext[..., t["seg_pad"]].sum(-1)[..., t["dir_seg"]]
            vals = torch.cat([vals, vals.new_zeros(vals.shape[:-1] + (1,))], dim=-1)
            new = self._params_from_rows(vals[..., t["rows_map"]])

        # 4) emissions
        m = torch.ones(z.shape, device=dev) if mask is None else mask.to(torch.float32)
        if self.family == "categorical":
            c_emis = emission_counts(z, x.long(), self.K, self.L, m)
            new["phi_k"] = dirichlet(generator, 1.0 + c_emis)
            return new

        x = x.to(torch.float32)
        oh = F.one_hot(z, self.K).to(torch.float32) * m[..., None]  # [N, T, K]
        n_k = oh.sum(-2)
        s1 = (oh * x[..., None]).sum(-2)
        s2 = (oh * (x * x)[..., None]).sum(-2)
        sigma = params["sigma"]
        prec = n_k / sigma**2 + 1.0 / self.prior_mu_scale**2
        var = 1.0 / prec
        mu = (s1 / sigma**2) * var + torch.sqrt(var) * torch.randn(
            n_k.shape, generator=generator, device=dev)
        new["mu"] = mu

        rss = s2 - 2.0 * mu * s1 + n_k * mu**2  # Σ (x - mu_z)² per leaf

        def log_target(sig):
            # the guard above makes prior_sigma_scale non-None here
            return (-n_k * torch.log(sig) - 0.5 * rss / sig**2
                    - 0.5 * (sig / self.prior_sigma_scale) ** 2)

        lower = 1e-4  # Positive bijector support floor (specs())
        for _ in range(2):
            prop = sigma * torch.exp(0.3 * torch.randn(sigma.shape, generator=generator, device=dev))
            log_acc = (log_target(prop) - log_target(sigma)
                       + torch.log(prop) - torch.log(sigma))  # log-space proposal Jacobian
            log_acc = torch.where(prop > lower, log_acc, float("-inf"))
            u = torch.rand(sigma.shape, generator=generator, device=dev)
            sigma = torch.where(torch.log(u) < log_acc, prop, sigma)
        new["sigma"] = sigma
        return new

    # ---- init ----

    def init_unconstrained(
        self, generator: torch.Generator, data: Dict[str, torch.Tensor]
    ) -> torch.Tensor:
        """Chain init for one series mirroring the reference's k-means
        discipline (`hmm/main.R:37-47`), as the JAX model: probability
        slots at the tree's own values; Gaussian means at ordered
        k-means centres (``scipy.cluster.vq.kmeans2``, ``minit="++"``,
        ``seed=0``; assigned to group blocks in order for
        ``order_mu="group"``), sigmas at within-cluster sds; categorical
        rows at the leaf spec. Only the jitter comes from ``generator``:
        ``0.05 N(0, 1)`` on the means, ``0.2 Dirichlet(20)`` on the rows.
        Returns ``theta [n_free]`` on the generator's device."""
        params = self.spec_params()
        x = torch.as_tensor(data["x"]).detach().cpu().numpy().astype(np.float64)
        dev = generator.device
        if self.family == "gaussian":
            from scipy.cluster.vq import kmeans2

            centers, labels = kmeans2(x.reshape(-1, 1), self.K, minit="++", seed=0)
            order = np.argsort(centers[:, 0])
            centers = centers[order, 0]
            sds = np.array(
                [
                    max(float(np.std(x[labels == order[k]])), 1e-2)
                    if np.any(labels == order[k])
                    else float(np.std(x))
                    for k in range(self.K)
                ]
            )
            # break ties so Ordered.inverse sees strict increase
            centers = centers + 1e-6 * np.arange(self.K)
            jit = 0.05 * torch.randn(self.K, generator=generator, device=dev).cpu().numpy()
            if self.order_mu == "group":
                start = 0
                for gi, sz in enumerate(self._group_sizes):
                    params[f"mu_g{gi}"] = np.sort(
                        centers[start : start + sz] + jit[start : start + sz])
                    start += sz
            elif self.order_mu == "global":
                params["mu"] = np.sort(centers + jit)
            else:
                params["mu"] = centers + jit
            params["sigma"] = sds
        else:
            alpha = torch.full((self.K, self.L), 20.0, device=dev)
            noise = dirichlet(generator, alpha).cpu().numpy()
            params["phi_k"] = 0.8 * params["phi_k"] + 0.2 * noise
            params["phi_k"] /= params["phi_k"].sum(axis=1, keepdims=True)
        return self.pack(
            {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in params.items()}
        )
