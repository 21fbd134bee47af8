"""Route decomposition of the flat HHMM transition law — the data
augmentation that makes tree models conjugate (counterpart of
``hhmm_tpu/hhmm/routes.py``: the NumPy tables copied, the per-draw
methods in torch over lanes ``[N, ...]``).

:func:`hhmm_tpu_torch.hhmm.compile.compile_params` expands the hierarchy into
a flat ``A[i, j]`` by SUMMING over routes: from leaf i, exit 0+ levels
(End mass at each ancestor), take one horizontal sibling step at a
common ancestor of i and j (or fall off the root and restart), then
enter vertically down to j (pi mass at each node on j's path)
(`hhmm/R/hhmm-sim.R:73-99`). Each route's probability is a product of
per-node (pi, A) ENTRIES — so conditioned on which route every step
took, the augmented likelihood factorizes into independent multinomials
per node row, and flat-prior tree models (MaskedSimplex slots,
`models/tree.py`) get closed-form Dirichlet conditionals: the blocked
Gibbs sampler the reference's abandoned Jangmin replication needed
(`hhmm/sim-jangmin2004.R:1963-2010` calls a Stan model that does not
exist; on the TPU, NUTS/ChEES mixed poorly on the 63-leaf tree —
``results/bench_zoo_r04.txt``).

:class:`RouteTable` precomputes, once per tree (all numpy, structural —
no branching on values):

- a global index space over every (node, pi/A-row, column) entry with
  structural support, with a value plan mapping free-slot parameters
  (``models/tree.py::TreeHMM._slots``) and deterministic spec constants
  into one flat value vector;
- ``ev_idx [K, K, R, M]``: for each ordered leaf pair and route, the
  (padded) list of entry indices whose product is that route's
  probability — shared by route SAMPLING (route log-prob = sum of log
  values, gathered) and route COUNTING (scatter-add of the chosen
  route's events);
- ``init_idx [K, M0]``: the t=0 vertical-entry events (the flat pi is a
  pure product — no route choice).

Identity pinned by ``tests/test_routes.py`` (and for the port by
``tests/test_torch_hhmm.py``): for any admissible values,
``logsumexp_r(route_logprob[i, j, :]) == log A_flat[i, j]`` and
``sum(init events) == log pi_flat`` against ``compile_params`` — route
decomposition IS the compile algebra, per-route.

Limitation: a node row may route exit mass through at most one End
child (every tree in the repo does); multiple supported End columns in
one row would make the exit event ambiguous and raise at construction.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from hhmm_tpu_torch.hhmm.structure import End, Internal, Production, iter_leaves

__all__ = ["RouteTable"]


class RouteTable:
    """Static route/event tables for one finalized tree.

    ``slots`` is ``TreeHMM._slots`` — (name, kind, node_idx, row_idx,
    support) over ``inodes`` (the DFS internal-node list) — so the value
    plan can address free parameters by name.
    """

    def __init__(self, root: Internal, inodes: List[Internal], slots):
        leaves = iter_leaves(root)
        K = len(leaves)
        node_idx = {id(n): d for d, n in enumerate(inodes)}

        # ancestor chains: chain[i] = [(node, child-index-on-path), ...]
        # from parent up to root
        chains = []
        for p in leaves:
            chain = []
            cur = p
            while cur.parent is not None:
                chain.append((cur.parent, cur.index))
                cur = cur.parent
            chains.append(chain)
        Dmax = max(len(c) for c in chains)
        R = Dmax + 1  # horizontal move at height 0..Dmax-1, or root restart

        # ---- entry index space + value plan ----
        self._entries: List[Tuple[int, str, int, int]] = []  # (node_d, kind, row, col)
        index: Dict[Tuple[int, str, int, int], int] = {}
        free_of = {}  # (node_d, kind, row) -> slot name
        for name, kind, d, i, _support in slots:
            free_of[(d, kind, i)] = name

        def eidx(node, kind, row, col) -> int:
            d = node_idx[id(node)]
            key = (d, kind, row, col)
            if key not in index:
                index[key] = len(self._entries)
                self._entries.append(key)
            return index[key]

        def end_col(node, row) -> int:
            """The single supported End column of this row (or -1)."""
            cols = [
                j
                for j, sib in enumerate(node.children)
                if isinstance(sib, End) and node.A[row][j] > 0.0
            ]
            if len(cols) > 1:
                raise NotImplementedError(
                    f"node {node.name!r} row {row} routes exit mass through "
                    f"{len(cols)} End children; route augmentation needs at "
                    "most one"
                )
            return cols[0] if cols else -1

        def entry_events(j: int, h: int):
            """Vertical-entry events for leaf j from its ancestor at
            height h down (pi picks at heights h-1 .. 0); None if some
            pi entry lacks structural support."""
            ev = []
            for l in range(h - 1, -1, -1):
                node, col = chains[j][l]
                if node.pi[col] <= 0.0:
                    return None
                ev.append(eidx(node, "pi", -1, col))
            return ev

        ev_lists = [[[None] * R for _ in range(K)] for _ in range(K)]
        for i in range(K):
            exits: List[int] = []  # accumulated End events below height h
            exits_ok = True
            for h in range(len(chains[i]) + 1):
                if not exits_ok:
                    break
                if h == len(chains[i]):  # root restart: all levels exited
                    for j in range(K):
                        ent = entry_events(j, len(chains[j]))
                        if ent is None:
                            continue
                        ev_lists[i][j][Dmax] = exits + ent
                    break
                node, ci = chains[i][h]
                row = np.asarray(node.A[ci])
                for j in range(K):
                    # is node a common ancestor of j, and at what height?
                    hj = next(
                        (
                            l
                            for l in range(len(chains[j]))
                            if chains[j][l][0] is node
                        ),
                        None,
                    )
                    if hj is None:
                        continue
                    cj = chains[j][hj][1]
                    if row[cj] <= 0.0:
                        continue
                    ent = entry_events(j, hj)
                    if ent is None:
                        continue
                    ev_lists[i][j][h] = (
                        exits + [eidx(node, "A", ci, cj)] + ent
                    )
                ec = end_col(node, ci)
                if ec < 0:
                    exits_ok = False  # cannot exit this level: no higher routes
                else:
                    exits.append(eidx(node, "A", ci, ec))

        # leaves with zero vertical-entry mass (e.g. a string leaf only
        # reachable by horizontal advance) have flat pi[j] = 0 — their
        # init row stays all-padding and init_valid masks the logprob
        init_lists = [entry_events(j, len(chains[j])) for j in range(K)]
        init_valid = np.asarray([e is not None for e in init_lists])

        # every free-slot support column gets a position even if no route
        # ever references it (its count is then always zero) — so the
        # Dirichlet gather below covers the whole support
        self.slot_count_pos: Dict[str, np.ndarray] = {}
        self.slot_cols: Dict[str, np.ndarray] = {}
        for name, kind, d, i, support in slots:
            cols = np.flatnonzero(np.asarray(support))
            pos = []
            for col in cols:
                key = (d, kind, i if kind == "A" else -1, int(col))
                if key not in index:
                    index[key] = len(self._entries)
                    self._entries.append(key)
                pos.append(index[key])
            self.slot_count_pos[name] = np.asarray(pos, np.int32)
            self.slot_cols[name] = cols

        S = len(self._entries)  # final: padding index = S
        M = max(
            [len(e) for row in ev_lists for cell in row for e in cell if e]
            + [1]
        )
        M0 = max([len(e) for e in init_lists if e is not None] + [1])
        ev_idx = np.full((K, K, R, M), S, np.int32)  # S = padding (log 1)
        valid = np.zeros((K, K, R), bool)
        for i in range(K):
            for j in range(K):
                for r in range(R):
                    e = ev_lists[i][j][r]
                    if e is None:
                        continue
                    valid[i, j, r] = True
                    ev_idx[i, j, r, : len(e)] = e
        init_idx = np.full((K, M0), S, np.int32)
        for j, e in enumerate(init_lists):
            if e is not None:
                init_idx[j, : len(e)] = e

        # ---- value plan: entry -> (free param gather) or constant ----
        # free entries grouped per slot: one vectorized gather/scatter
        # pair per slot instead of one scalar op per entry
        const = np.zeros(S)
        by_slot: Dict[str, List[Tuple[int, int]]] = {}
        for s, (d, kind, row, col) in enumerate(self._entries):
            node = inodes[d]
            name = free_of.get((d, kind, row if kind == "A" else -1))
            if name is not None:
                by_slot.setdefault(name, []).append((s, col))
            else:
                const[s] = (node.pi if kind == "pi" else node.A[row])[col]
                assert const[s] > 0.0, (node.name, kind, row, col)
        self.free_plan = [
            (
                name,
                np.asarray([p for p, _ in pairs], np.int32),
                np.asarray([c for _, c in pairs], np.int32),
            )
            for name, pairs in by_slot.items()
        ]

        self.K, self.R, self.S, self.M = K, R, S, M
        self.ev_idx = ev_idx
        self.valid = valid
        self.init_idx = init_idx
        self.init_valid = init_valid
        self.const = const

        # the torch value plan: entry s takes column _free_cols[s] of the
        # slots' concatenated rows where _is_free[s], else const[s]
        self._slot_names = [name for name, *_ in slots]
        offset, off = {}, 0
        for name, _kind, _d, _i, support in slots:
            offset[name] = off
            off += len(support)
        self._free_cols = np.zeros(S, np.int64)
        self._is_free = np.zeros(S, bool)
        for name, pos, cols in self.free_plan:
            self._free_cols[pos] = offset[name] + cols
            self._is_free[pos] = True
        self._dev: Dict[str, Dict[str, torch.Tensor]] = {}

    # ---- per-draw value assembly (torch, lanes [N, ...]) ----

    def _on(self, device) -> Dict[str, torch.Tensor]:
        """The tables as tensors on ``device``, made once per device."""
        key = str(device)
        if key not in self._dev:
            K, R, M = self.K, self.R, self.M
            self._dev[key] = {
                "ev_idx": torch.as_tensor(self.ev_idx, dtype=torch.long, device=device),
                "ev_routes": torch.as_tensor(
                    self.ev_idx.reshape(K * K * R, M), dtype=torch.long, device=device),
                "valid": torch.as_tensor(self.valid, device=device),
                "init_idx": torch.as_tensor(self.init_idx, dtype=torch.long, device=device),
                "init_valid": torch.as_tensor(self.init_valid, device=device),
                "free_cols": torch.as_tensor(self._free_cols, device=device),
                "is_free": torch.as_tensor(self._is_free, device=device),
                "const": torch.as_tensor(self.const, dtype=torch.float32, device=device),
            }
        return self._dev[key]

    def values(self, params) -> torch.Tensor:
        """Value matrix ``[N, S]`` of every route entry under the lanes'
        free-slot parameters (constants filled from the spec): one gather
        and one select, whatever the number of slots. A tree without free
        slots gives its constants ``[S]``."""
        if not self._slot_names:
            ref = next(iter(params.values()))
            return torch.as_tensor(self.const, dtype=ref.dtype, device=ref.device)
        # every free slot's full row, concatenated in slot order
        free = torch.cat([params[name] for name in self._slot_names], dim=-1)
        t = self._on(free.device)
        return torch.where(t["is_free"], free[..., t["free_cols"]], t["const"].to(free.dtype))

    def _log_values(self, params) -> torch.Tensor:
        """``[N, S + 1]``: log entry values with the padding index S at
        log 1 = 0."""
        vals = self.values(params)
        logv = torch.log(torch.clamp_min(vals, 1e-300))
        return torch.cat([logv, torch.zeros_like(logv[..., :1])], dim=-1)

    def route_logprobs(self, params, mask_neg: float = -1.0e30) -> torch.Tensor:
        """``[N, K, K, R]`` route log-probabilities under ``params``
        (invalid routes at ``mask_neg``). ``logsumexp`` over R equals
        the log of the compiled flat A (pinned by
        ``tests/test_torch_hhmm.py``)."""
        logv = self._log_values(params)
        t = self._on(logv.device)
        lr = logv[..., t["ev_idx"]].sum(-1)
        return torch.where(t["valid"], lr, mask_neg)

    def init_logprobs(self, params, mask_neg: float = -1.0e30) -> torch.Tensor:
        """``[N, K]`` log of the compiled flat pi (pure product — no
        routes; leaves with zero vertical-entry mass at ``mask_neg``)."""
        logv = self._log_values(params)
        t = self._on(logv.device)
        lp = logv[..., t["init_idx"]].sum(-1)
        return torch.where(t["init_valid"], lp, mask_neg)

    def counts(self, z: torch.Tensor, routes: torch.Tensor, w: torch.Tensor, z0_w: float = 1.0):
        """Entry counts ``[N, S]`` for state paths ``z [N, T]`` with
        chosen ``routes [N, T-1]`` and per-step weights ``w [N, T-1]``
        (soft gate / mask), plus the t=0 entry events weighted ``z0_w``:
        one ``scatter_add_`` over a flat ``[N, S + 1]`` buffer (the
        padding index S takes the padding events and is dropped)."""
        t = self._on(z.device)
        ev = t["ev_routes"][(z[..., :-1] * self.K + z[..., 1:]) * self.R + routes]
        init = t["init_idx"][z[..., 0]]
        index = torch.cat([ev.flatten(-2), init], dim=-1)
        w = w.to(torch.float32)
        src = torch.cat([
            w[..., None].expand(ev.shape).flatten(-2),
            torch.full(init.shape, float(z0_w), dtype=w.dtype, device=w.device),
        ], dim=-1)
        c = torch.zeros(z.shape[:-1] + (self.S + 1,), dtype=w.dtype, device=z.device)
        return c.scatter_add_(-1, index, src)[..., :-1]
