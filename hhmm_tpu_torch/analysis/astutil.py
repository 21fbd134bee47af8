"""Shared ``ast`` helpers for the analyzer's rules (counterpart of
``hhmm_tpu/analysis/astutil.py``, with the torch device-sync spelling
for JAX's ``block_until_ready``).

Alias tracking is the recurring chore: every rule must see through
``import jax.numpy as jnp`` / ``from jax import random as jr`` /
``from time import perf_counter as pc`` spellings or it is trivially
evaded. These helpers centralize that bookkeeping.
"""

from __future__ import annotations

import ast
import weakref
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

# one flattened walk per parsed tree, shared by every rule — the
# engine runs 18 rules over ~100 modules and re-walking the full tree
# per (rule, helper) call dominated the runtime (profiled: >3M
# ast.walk calls → ~8 s; cached: <2 s, inside the tier-1 <10 s budget)
_WALK_CACHE: "weakref.WeakKeyDictionary[ast.AST, List[ast.AST]]" = (
    weakref.WeakKeyDictionary()
)


def cached_walk(tree: ast.AST) -> List[ast.AST]:
    """``list(ast.walk(tree))``, memoized per tree object. Use for
    FULL-module walks only (sub-scope walks are cheap and varied)."""
    try:
        return _WALK_CACHE[tree]
    except KeyError:
        nodes = list(ast.walk(tree))
        try:
            _WALK_CACHE[tree] = nodes
        except TypeError:
            pass
        return nodes


def imported_symbols(tree: ast.AST, modules: Sequence[str]) -> Set[str]:
    """Names bound from ``from <module> import ...`` for any of
    ``modules`` (package re-exports count too)."""
    names: Set[str] = set()
    for node in cached_walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module in modules:
            for alias in node.names:
                names.add(alias.asname or alias.name)
    return names


def called_names(tree: ast.AST) -> Set[str]:
    calls: Set[str] = set()
    for node in cached_walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            calls.add(node.func.id)
    return calls


_ALIAS_CACHE: "weakref.WeakKeyDictionary[ast.AST, Dict[str, Set[str]]]" = (
    weakref.WeakKeyDictionary()
)


def module_aliases(tree: ast.AST, module: str) -> Set[str]:
    """Names bound to ``module`` itself — ``import numpy as np`` →
    ``{"np"}``; ``from torch import cuda as tc`` → ``{"tc"}`` when
    ``module == "torch.cuda"``. Dotted imports without ``as`` are
    excluded (a bare ``import torch.cuda`` binds ``torch``, not
    ``torch.cuda``). Memoized per (tree, module): every rule asks."""
    try:
        per_tree = _ALIAS_CACHE[tree]
    except KeyError:
        per_tree = {}
        try:
            _ALIAS_CACHE[tree] = per_tree
        except TypeError:
            pass
    hit = per_tree.get(module)
    if hit is not None:
        return set(hit)
    out: Set[str] = set()
    parent, _, leaf = module.rpartition(".")
    for node in cached_walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == module:
                    if alias.asname:
                        out.add(alias.asname)
                    elif "." not in module:
                        out.add(module)
        elif isinstance(node, ast.ImportFrom) and parent and node.module == parent:
            for alias in node.names:
                if alias.name == leaf:
                    out.add(alias.asname or alias.name)
    per_tree[module] = frozenset(out)
    return out


def own_scope_nodes(node: ast.AST) -> List[ast.AST]:
    """All descendants of ``node`` EXCLUDING nested function/lambda
    bodies — a nested def is its own scope and is analyzed as such."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return out


def function_defs(tree: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def build_parents(scope: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(scope):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def mutually_exclusive(
    a: ast.AST, b: ast.AST, parents: Dict[ast.AST, ast.AST]
) -> bool:
    """True when ``a`` and ``b`` sit in different branches of the same
    ``if``/``try`` — at most one of them executes, so a "both consume
    the key" diagnosis would be a false positive."""

    def chain(n: ast.AST) -> List[ast.AST]:
        out = [n]
        while n in parents:
            n = parents[n]
            out.append(n)
        return out

    ca, cb = chain(a), chain(b)
    sa = set(map(id, ca))
    lca = next((n for n in cb if id(n) in sa), None)
    if lca is None or not isinstance(lca, (ast.If, ast.Try)):
        return False

    # child of the LCA on each path
    def child_of_lca(c: List[ast.AST]) -> Optional[ast.AST]:
        for i, n in enumerate(c):
            if n is lca:
                return c[i - 1] if i > 0 else None
        return None

    ka, kb = child_of_lca(ca), child_of_lca(cb)
    if ka is None or kb is None:
        return False

    def branch_of(child: ast.AST) -> Optional[str]:
        for fname, value in ast.iter_fields(lca):
            if isinstance(value, list) and any(v is child for v in value):
                return fname
            if value is child:
                return fname
        return None

    fa, fb = branch_of(ka), branch_of(kb)
    return fa is not None and fb is not None and fa != fb


def perf_counter_names(tree: ast.AST) -> Set[str]:
    """Bare names bound to ``perf_counter`` (any source module, any
    alias) — the attribute spelling is matched structurally."""
    names: Set[str] = set()
    for node in cached_walk(tree):
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name == "perf_counter":
                    names.add(alias.asname or alias.name)
    return names


def is_perf_counter_call(node: ast.AST, pc_names: Set[str]) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Name) and fn.id in pc_names:
        return True
    return isinstance(fn, ast.Attribute) and fn.attr == "perf_counter"


def is_device_sync_call(node: ast.AST) -> bool:
    """A call that waits for the device: any ``.synchronize()``
    (``torch.cuda.synchronize``, a CUDA event's or stream's)."""
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "synchronize"
    )


def call_target_names(arg: ast.AST) -> List[str]:
    """Candidate function names a callable argument refers to —
    ``f`` → ``["f"]``, ``self._step`` → ``["_step"]``."""
    if isinstance(arg, ast.Name):
        return [arg.id]
    if isinstance(arg, ast.Attribute):
        return [arg.attr]
    return []


# ---------------------------------------------------------------------------
# dataflow support for the concurrency rule family (analysis/concurrency.py)


def attr_chain(node: ast.AST) -> Optional[List[str]]:
    """The dotted-name chain of a Name/Attribute expression —
    ``self._lock`` → ``["self", "_lock"]``, ``jax.random.normal`` →
    ``["jax", "random", "normal"]`` — or ``None`` when the expression
    is not a pure chain (a call/subscript in the middle breaks it)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    parts.reverse()
    return parts


# threading constructors the concurrency rules model. Condition and
# Semaphore are deliberately absent — the repo's discipline is plain
# Lock/RLock plus thread-local state; anything fancier should stand out
# in review, not be silently blessed by the analyzer.
_THREADING_CTORS = ("Lock", "RLock", "local")


def threading_ctor(node: ast.AST, threading_aliases: Set[str]) -> str:
    """``"Lock"`` / ``"RLock"`` / ``"local"`` when ``node`` is a call
    constructing one (``threading.Lock()``, aliased module, or a bare
    imported name), else ``""``."""
    if not isinstance(node, ast.Call):
        return ""
    f = node.func
    if (
        isinstance(f, ast.Attribute)
        and f.attr in _THREADING_CTORS
        and isinstance(f.value, ast.Name)
        and f.value.id in threading_aliases
    ):
        return f.attr
    if isinstance(f, ast.Name) and f.id in _THREADING_CTORS:
        return f.id
    return ""


# container-mutating method names: a call ``<target>.append(...)`` etc.
# mutates <target> in place. `get`/`items`/`copy` and friends are reads
# and deliberately excluded.
MUTATOR_METHODS = frozenset(
    {
        "append",
        "appendleft",
        "extend",
        "insert",
        "add",
        "discard",
        "remove",
        "clear",
        "update",
        "setdefault",
        "pop",
        "popitem",
        "popleft",
        "move_to_end",
        "sort",
        "reverse",
    }
)


def mutation_roots(node: ast.AST) -> List[Tuple[List[str], int]]:
    """The (attr-chain, line) roots ``node`` mutates in place, for the
    shared-state race lint:

    - ``Assign``/``AnnAssign``/``AugAssign`` whose target is an
      attribute chain (``self.x = ...``) or a subscript of one
      (``self.x[k] = ...``, ``D[k] += 1``);
    - ``Delete`` of either shape;
    - mutator-method calls (:data:`MUTATOR_METHODS`) on a chain
      (``self.x.append(v)``, ``CACHE.clear()``).

    Bare-name rebinding (``x = ...``) is NOT a mutation — rebinding a
    local is scope-private, and rebinding a module global via ``global``
    swaps the object rather than mutating shared contents."""
    out: List[Tuple[List[str], int]] = []

    def chain_of_target(t: ast.AST) -> Optional[List[str]]:
        if isinstance(t, ast.Subscript):
            t = t.value
        if isinstance(t, (ast.Attribute, ast.Name)):
            c = attr_chain(t)
            # a bare Name rebind is not a mutation; a bare Name
            # SUBSCRIPT store is (handled by the Subscript unwrap)
            return c
        return None

    def add_target(t: ast.AST, line: int) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for elt in t.elts:
                add_target(elt, line)
            return
        sub = isinstance(t, ast.Subscript)
        c = chain_of_target(t)
        if c is not None and (len(c) > 1 or sub):
            out.append((c, line))

    if isinstance(node, ast.Assign):
        for t in node.targets:
            add_target(t, node.lineno)
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        add_target(node.target, node.lineno)
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            add_target(t, node.lineno)
    elif isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in MUTATOR_METHODS:
            c = attr_chain(f.value)
            if c is not None:
                out.append((c, node.lineno))
    return out
