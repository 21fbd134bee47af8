"""Concurrency-discipline rules for the port (counterpart of
``hhmm_tpu/analysis/concurrency.py``, the same four rules).

The port's serving plane runs locks in the scheduler, the pager and the
registry, its obs plane keeps lock-guarded tables, and the async flush
pipeline makes the serving path genuinely concurrent. These rules are
the repo's lock conventions enforced as a lint pass:

- ``lock-order`` (error) — the package-wide nested-acquisition graph.
  Every ``with <lock>`` / ``.acquire()`` site is resolved to a lock
  identity (``module::_LOCK`` or ``module::Class._lock`` — one node
  per *definition*, instances abstracted); an acquisition while
  another lock is held adds an order edge, including through calls
  (interprocedural: same-module call graph plus cross-module edges
  resolved through import aliases and ``self.attr = Ctor()`` type
  bindings). Any cycle is a potential deadlock; acquiring a
  non-reentrant ``Lock`` already held is a guaranteed self-deadlock.
  The full order DAG is emitted into the JSON report
  (``extras["lock_order"]``) and rendered by ``obs_report_torch.py``.

- ``shared-state-race`` (error) — guard inference over lock-using
  classes: an attribute mutated under a lock anywhere in the class is
  *guarded*; mutating a guarded attribute in a method not dominated by
  the lock (lexically, or via the all-call-sites-hold-the-lock
  inference that blesses private ``"lock held"`` helpers like
  ``Tracer._append``) is a race finding. ``__init__`` is exempt
  (construction precedes sharing); ``threading.local`` attributes are
  exempt by design. The module-scope half: a module-level mutable
  container mutated from function scope without a module lock held
  (and not ``threading.local``) is a finding.

- ``held-lock-escape`` (error) — latency-cliff and deadlock hazards
  inside critical sections: device syncs (``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()`` — each waits for the device and copies to
  the host —, ``torch.cuda.synchronize`` and any ``.synchronize()``,
  and a blocking ``.wait()`` such as a CUDA event's), snapshot/file
  I/O (``open``,
  ``.load``/``.save``/``.savez``/``.write_text``/... ,
  ``atomic_write_text``), ``sleep``, and user callbacks
  (``self._on_evict(...)``-style: ``_on_*``/``*_callback``/
  ``*_listener``/``*_hook`` names — statically unresolvable code run
  while holding a lock is how re-entrancy deadlocks are born) while a
  lock is held, directly or through a resolvable callee. Each finding
  names the acquisition site. Do the slow thing outside, publish under
  the lock.

- ``atomic-write`` (error) — raw text-mode ``open(..., "w")`` /
  ``Path.write_text`` under ``hhmm_tpu_torch/`` outside ``obs/trace.py``
  (which IS the atomic-write substrate): every text artifact routes
  through ``trace.atomic_write_text`` so a crashed writer can never
  strand a torn file. Binary writes (``"wb"``) are out of scope: the
  ``.npz`` stores implement the same temp+replace discipline in bytes
  and the fault injector's torn-file writer is *deliberately*
  non-atomic.

Scope: ``hhmm_tpu_torch/`` except ``hhmm_tpu_torch/analysis/`` for the
three lock rules — the analyzer is a single-threaded CLI process and
imports only the stdlib; ``atomic-write`` does cover ``analysis/`` (its
one writer carries an inline pragma with the rationale).

Known limits (documented, deliberate): lock identities are
per-definition, so two instances of one class share a node (a
self-edge between sibling instances is conservatively a cycle);
``.acquire()``/``.release()`` pairing is linear within one function;
locks passed as arguments are not tracked.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from .astutil import (
    attr_chain,
    cached_walk,
    module_aliases,
    mutation_roots,
    threading_ctor,
)
from .engine import Finding, Module, Project, Rule, register

PKG = "hhmm_tpu_torch"
_SCOPE = PKG + "/"
# the analyzer itself: single-threaded CLI, stdlib only — exempt from
# the lock rules
_LOCK_RULE_EXEMPT = "hhmm_tpu_torch/analysis/"

_CONTAINER_CTORS = {
    "dict",
    "list",
    "set",
    "OrderedDict",
    "defaultdict",
    "deque",
    "WeakKeyDictionary",
    "WeakValueDictionary",
}

_IO_ATTRS = {
    "load",
    "save",
    "savez",
    "savez_compressed",
    "write_text",
    "read_text",
    "write_bytes",
    "read_bytes",
    "dump",
}

# zero-argument tensor methods that copy to the host, so wait for the
# device
_SYNC_COPIES = ("item", "tolist", "cpu", "numpy")

_CALLBACK_RE = re.compile(r"^_?on_|_callback(s)?$|_listener(s)?$|_hook(s)?$|_cb$")


@dataclass(frozen=True)
class LockId:
    """One lock *definition* (instances abstracted)."""

    module: str  # repo-relative file
    qual: str  # "_LOCK" or "Class._attr"
    kind: str = "Lock"  # "Lock" | "RLock"

    def label(self) -> str:
        return f"{self.module}::{self.qual}"


Held = Tuple[Tuple[LockId, int], ...]  # ((lock, acquisition line), ...)


@dataclass
class _FnSummary:
    rel: str
    qual: str  # "fn" or "Class.method"
    cls: Optional[str]
    # (lock, line, held-at-acquisition)
    acquires: List[Tuple[LockId, int, Held]] = field(default_factory=list)
    # (raw target spec, line, held)
    calls: List[Tuple[Tuple, int, Held]] = field(default_factory=list)
    # (category, description, line, held)
    escapes: List[Tuple[str, str, int, Held]] = field(default_factory=list)
    # (attr chain, line, held)
    mutations: List[Tuple[List[str], int, Held]] = field(default_factory=list)


@dataclass
class _ClassInfo:
    name: str
    lock_attrs: Dict[str, LockId] = field(default_factory=dict)
    local_attrs: Set[str] = field(default_factory=set)
    # attr -> raw ctor chain (resolved to a (module, Class) globally)
    attr_types: Dict[str, List[str]] = field(default_factory=dict)
    methods: Set[str] = field(default_factory=set)


def _module_rel_cache(project: Project) -> Dict[str, str]:
    """Per-PROJECT dotted-path → repo-relative-file cache. A global
    would leak resolutions across run_analysis() calls (the test
    suite runs many toy projects in one process; a module shipped as
    a file in one tree and a package in the next must not alias)."""
    return project.caches.setdefault("concurrency_module_rel", {})


def _module_rel(project: Project, dotted: str) -> Optional[str]:
    """Repo-relative file for a ``hhmm_tpu_torch.*`` dotted module path
    (``hhmm_tpu_torch.obs.metrics`` → ``hhmm_tpu_torch/obs/metrics.py``), trying
    the module file then the package ``__init__``."""
    parts = dotted.split(".")
    if parts[0] != PKG:
        return None
    base = "/".join(parts)
    for rel in (base + ".py", base + "/__init__.py"):
        if project.module(rel) is not None:
            _module_rel_cache(project)[dotted] = rel
            return rel
    return None


def _is_container_ctor(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.DictComp, ast.ListComp)):
        return True
    if isinstance(node, ast.Call):
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else ""
        )
        return name in _CONTAINER_CTORS
    return False


def _needs_eager_index(mod: Module) -> bool:
    """Only modules that touch ``threading`` (locks, thread-locals) or
    define a module-level mutable container can contribute lock
    regions or race findings — everything else is indexed LAZILY, and
    only if some held-lock call site actually resolves into it. This
    keeps the concurrency pass from summarizing a hundred lock-free
    kernel/model modules on every scan (measured: ~2x pass speedup on
    the repo). The substring probe is deliberately loose — a comment
    mentioning threading eagerly indexes one extra module, which only
    costs time, never a verdict."""
    if "threading" in mod.source:
        return True
    for st in mod.tree.body:
        value = None
        targets: List[ast.AST] = []
        if isinstance(st, ast.Assign):
            value, targets = st.value, st.targets
        elif isinstance(st, ast.AnnAssign):
            value, targets = st.value, [st.target]
        # `__all__` and other dunders are module metadata, not state:
        # nearly every module has one, and indexing each for it alone
        # doubled the pass
        if all(
            isinstance(t, ast.Name) and t.id.startswith("__") and t.id.endswith("__")
            for t in targets
        ):
            continue
        if value is not None and _is_container_ctor(value):
            return True
    return False


class _ModIndex:
    """Everything the concurrency rules need to know about one module:
    lock/thread-local/container definitions, import aliases, class
    layouts, and per-function walk summaries with held-lock context."""

    def __init__(self, project: Project, mod: Module):
        self.rel = mod.rel
        self._mod_rel_cache = _module_rel_cache(project)
        tree = mod.tree
        self.threading = module_aliases(tree, "threading")

        # import resolution
        self.mod_alias: Dict[str, str] = {}  # name -> repo-rel module file
        self.name_imports: Dict[str, Tuple[str, str]] = {}  # name -> (rel, symbol)
        for node in cached_walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    rel = _module_rel(project, a.name)
                    if rel is None:
                        continue
                    if a.asname:
                        self.mod_alias[a.asname] = rel
                    # a bare `import hhmm_tpu_torch.obs.metrics` binds
                    # `hhmm_tpu`; full-chain calls resolve via the
                    # dotted fallback in _call_target
            elif isinstance(node, ast.ImportFrom):
                dotted = node.module or ""
                if node.level:
                    pkg = mod.rel.split("/")[:-1]
                    base = pkg[: len(pkg) - (node.level - 1)]
                    dotted = ".".join(base + (dotted.split(".") if dotted else []))
                if dotted != PKG and not dotted.startswith(PKG + "."):
                    continue
                src_rel = _module_rel(project, dotted)
                for a in node.names:
                    sub = _module_rel(project, f"{dotted}.{a.name}")
                    if sub is not None:
                        self.mod_alias[a.asname or a.name] = sub
                    elif src_rel is not None:
                        self.name_imports[a.asname or a.name] = (src_rel, a.name)

        # module-scope definitions
        self.mod_locks: Dict[str, LockId] = {}
        self.mod_locals: Set[str] = set()
        self.mod_containers: Dict[str, int] = {}
        self.mod_attr_types: Dict[str, List[str]] = {}  # name -> ctor chain
        self.mod_fn_aliases: Dict[str, List[str]] = {}  # name -> value chain
        for st in tree.body:
            targets: List[ast.AST] = []
            value: Optional[ast.AST] = None
            if isinstance(st, ast.Assign):
                targets, value = st.targets, st.value
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                targets, value = [st.target], st.value
            if value is None:
                continue
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                tc = threading_ctor(value, self.threading)
                if tc in ("Lock", "RLock"):
                    self.mod_locks[t.id] = LockId(self.rel, t.id, tc)
                elif tc == "local":
                    self.mod_locals.add(t.id)
                elif _is_container_ctor(value):
                    self.mod_containers[t.id] = st.lineno
                elif isinstance(value, ast.Call):
                    c = attr_chain(value.func)
                    if c:
                        self.mod_attr_types[t.id] = c
                else:
                    c = attr_chain(value)
                    if c and len(c) > 1:
                        self.mod_fn_aliases[t.id] = c

        # classes and functions
        self.classes: Dict[str, _ClassInfo] = {}
        self.functions: Set[str] = set()
        self.summaries: Dict[str, _FnSummary] = {}
        for st in tree.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.add(st.name)
            elif isinstance(st, ast.ClassDef):
                info = _ClassInfo(st.name)
                for sub in st.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        info.methods.add(sub.name)
                        for n in ast.walk(sub):
                            if isinstance(n, ast.Assign):
                                a_targets, a_value = n.targets, n.value
                            elif isinstance(n, ast.AnnAssign) and n.value is not None:
                                a_targets, a_value = [n.target], n.value
                            else:
                                continue
                            for t in a_targets:
                                if (
                                    isinstance(t, ast.Attribute)
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"
                                ):
                                    tc = threading_ctor(a_value, self.threading)
                                    if tc in ("Lock", "RLock"):
                                        info.lock_attrs[t.attr] = LockId(
                                            self.rel, f"{st.name}.{t.attr}", tc
                                        )
                                    elif tc == "local":
                                        info.local_attrs.add(t.attr)
                                    elif isinstance(a_value, ast.Call):
                                        c = attr_chain(a_value.func)
                                        if c:
                                            info.attr_types[t.attr] = c
                self.classes[st.name] = info
        for st in tree.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._summarize(st, st.name, None)
            elif isinstance(st, ast.ClassDef):
                for sub in st.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self._summarize(sub, f"{st.name}.{sub.name}", st.name)

    # ---- lock / call resolution (module-local view) ----

    def _resolve_lock(self, expr: ast.AST, cls: Optional[str]) -> Optional[LockId]:
        c = attr_chain(expr)
        if c is None:
            return None
        if len(c) == 1:
            return self.mod_locks.get(c[0])
        if c[0] == "self" and cls is not None and len(c) == 2:
            return self.classes[cls].lock_attrs.get(c[1])
        return None

    def _call_target(self, f: ast.AST, cls: Optional[str]) -> Optional[Tuple]:
        c = attr_chain(f)
        if c is None:
            return None
        if len(c) == 1:
            return ("name", self.rel, c[0])
        if c[0] == "self" and cls is not None:
            if len(c) == 2:
                return ("self", self.rel, cls, c[1])
            if len(c) == 3:
                return ("selfattr", self.rel, cls, c[1], c[2])
            return None
        if c[0] in self.mod_alias:
            return ("modattr", self.mod_alias[c[0]], tuple(c[1:]))
        if c[0] == PKG:
            # full dotted spelling under a bare `import hhmm_tpu_torch.x.y`
            for split in range(len(c) - 1, 1, -1):
                dotted = ".".join(c[:split])
                rel = self._mod_rel_cache.get(dotted)
                if rel is not None:
                    return ("modattr", rel, tuple(c[split:]))
            return None
        if c[0] in self.mod_attr_types and len(c) == 2:
            # module-level instance: `tracer.span(...)`
            return ("instattr", self.rel, c[0], c[1])
        return None

    def _escape_of(self, node: ast.Call) -> Optional[Tuple[str, str]]:
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr == "synchronize":
                return ("sync", "`.synchronize()` device sync")
            if f.attr in _SYNC_COPIES and not node.args and not node.keywords:
                return ("sync", f"`.{f.attr}()` device-to-host copy (a device sync)")
            if f.attr == "wait":
                return ("sync", "blocking `.wait()`")
            if f.attr == "sleep":
                return ("sleep", "blocking `sleep`")
            if f.attr in _IO_ATTRS:
                return ("io", f"`.{f.attr}(...)` file/snapshot I/O")
            if _CALLBACK_RE.search(f.attr):
                return ("callback", f"user callback `{f.attr}(...)`")
        elif isinstance(f, ast.Name):
            if f.id == "open":
                return ("io", "`open(...)` file I/O")
            if f.id == "atomic_write_text":
                return ("io", "`atomic_write_text(...)` file I/O")
            if f.id == "sleep":
                return ("sleep", "blocking `sleep`")
            if _CALLBACK_RE.search(f.id):
                return ("callback", f"user callback `{f.id}(...)`")
        return None

    # ---- the held-context walker ----

    def _summarize(self, fndef: ast.AST, qual: str, cls: Optional[str]) -> None:
        summ = _FnSummary(self.rel, qual, cls)
        self.summaries[qual] = summ
        held: List[Tuple[LockId, int]] = []

        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return  # nested scope — analyzed separately if ever needed
            if isinstance(node, (ast.With, ast.AsyncWith)):
                got = 0
                for item in node.items:
                    lk = self._resolve_lock(item.context_expr, cls)
                    if lk is not None:
                        summ.acquires.append((lk, node.lineno, tuple(held)))
                        held.append((lk, node.lineno))
                        got += 1
                    else:
                        visit(item.context_expr)
                for st in node.body:
                    visit(st)
                for _ in range(got):
                    held.pop()
                return
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in ("acquire", "release"):
                    lk = self._resolve_lock(f.value, cls)
                    if lk is not None:
                        if f.attr == "acquire":
                            summ.acquires.append((lk, node.lineno, tuple(held)))
                            held.append((lk, node.lineno))
                        else:
                            for i in range(len(held) - 1, -1, -1):
                                if held[i][0] == lk:
                                    del held[i]
                                    break
                        return
                esc = self._escape_of(node)
                if esc is not None:
                    summ.escapes.append((esc[0], esc[1], node.lineno, tuple(held)))
                target = self._call_target(f, cls)
                if target is not None:
                    summ.calls.append((target, node.lineno, tuple(held)))
            for chain, line in mutation_roots(node):
                summ.mutations.append((chain, line, tuple(held)))
            for child in ast.iter_child_nodes(node):
                visit(child)

        for st in fndef.body:
            visit(st)


class _Analysis:
    """The package-wide pass shared by the three lock rules: per-module
    indexes, cross-module call resolution, transitive lock/escape
    footprints, and the global acquisition-order graph."""

    def __init__(self, project: Project):
        self.project = project
        self.idx: Dict[str, _ModIndex] = {}
        self.scanned: List[str] = []
        for mod in project.iter_modules():
            if not mod.rel.startswith(_SCOPE):
                continue
            if mod.rel.startswith(_LOCK_RULE_EXEMPT):
                continue
            if not _needs_eager_index(mod):
                continue  # lazily indexed via index_for if ever called into
            self.idx[mod.rel] = _ModIndex(project, mod)
            self.scanned.append(mod.rel)
        self._foot_cache: Dict[Tuple[str, str], Tuple[FrozenSet, FrozenSet]] = {}
        self._in_progress: Set[Tuple[str, str]] = set()
        # edges: (from, to) -> first (file, line) observed
        self.edges: Dict[Tuple[LockId, LockId], Tuple[str, int]] = {}
        self.self_deadlocks: List[Tuple[LockId, str, int, str]] = []
        self._build_graph()

    # ---- lazy module indexing (cross-module targets) ----

    def index_for(self, rel: str) -> Optional[_ModIndex]:
        ix = self.idx.get(rel)
        if ix is not None:
            return ix
        mod = self.project.module(rel)
        if mod is None or rel.startswith(_LOCK_RULE_EXEMPT):
            return None
        ix = self.idx[rel] = _ModIndex(self.project, mod)
        return ix

    # ---- target resolution ----

    def resolve_type(
        self, chain: Sequence[str], ix: _ModIndex
    ) -> Optional[Tuple[str, str]]:
        """A constructor chain → (module rel, class name)."""
        if len(chain) == 1:
            n = chain[0]
            if n in ix.classes:
                return (ix.rel, n)
            imp = ix.name_imports.get(n)
            if imp is not None:
                ix2 = self.index_for(imp[0])
                if ix2 is not None and imp[1] in ix2.classes:
                    return (ix2.rel, imp[1])
        elif len(chain) == 2 and chain[0] in ix.mod_alias:
            ix2 = self.index_for(ix.mod_alias[chain[0]])
            if ix2 is not None and chain[1] in ix2.classes:
                return (ix2.rel, chain[1])
        return None

    def resolve(self, target: Tuple) -> Optional[Tuple[str, str]]:
        """A raw call-target spec → a summary key ``(rel, qual)``."""
        kind = target[0]
        if kind == "name":
            _, rel, n = target
            ix = self.index_for(rel)
            if ix is None:
                return None
            if n in ix.functions:
                return (rel, n)
            if n in ix.classes:
                return (rel, f"{n}.__init__") if "__init__" in ix.classes[
                    n
                ].methods else None
            imp = ix.name_imports.get(n)
            if imp is not None:
                return self.resolve(("name", imp[0], imp[1]))
            alias = ix.mod_fn_aliases.get(n)
            if alias is not None:
                return self._resolve_bound_method(alias, ix)
            return None
        if kind == "self":
            _, rel, cls, meth = target
            ix = self.index_for(rel)
            if ix is not None and cls in ix.classes and meth in ix.classes[cls].methods:
                return (rel, f"{cls}.{meth}")
            return None
        if kind == "selfattr":
            _, rel, cls, attr, meth = target
            ix = self.index_for(rel)
            if ix is None or cls not in ix.classes:
                return None
            chain = ix.classes[cls].attr_types.get(attr)
            if chain is None:
                return None
            t = self.resolve_type(chain, ix)
            return self._class_method(t, meth)
        if kind == "instattr":
            _, rel, name, meth = target
            ix = self.index_for(rel)
            if ix is None:
                return None
            chain = ix.mod_attr_types.get(name)
            if chain is None:
                return None
            t = self.resolve_type(chain, ix)
            return self._class_method(t, meth)
        if kind == "modattr":
            _, rel, chain = target
            ix = self.index_for(rel)
            if ix is None:
                return None
            if len(chain) == 1:
                return self.resolve(("name", rel, chain[0]))
            if len(chain) == 2:
                n, meth = chain
                if n in ix.classes:
                    return self._class_method((rel, n), meth)
                tchain = ix.mod_attr_types.get(n)
                if tchain is not None:
                    return self._class_method(self.resolve_type(tchain, ix), meth)
            return None
        return None

    def _class_method(
        self, t: Optional[Tuple[str, str]], meth: str
    ) -> Optional[Tuple[str, str]]:
        if t is None:
            return None
        rel, cls = t
        ix = self.index_for(rel)
        if ix is not None and cls in ix.classes and meth in ix.classes[cls].methods:
            return (rel, f"{cls}.{meth}")
        return None

    def _resolve_bound_method(
        self, chain: Sequence[str], ix: _ModIndex
    ) -> Optional[Tuple[str, str]]:
        """``attach = registry.attach``-style module aliases."""
        if len(chain) == 2:
            tchain = ix.mod_attr_types.get(chain[0])
            if tchain is not None:
                return self._class_method(self.resolve_type(tchain, ix), chain[1])
        return None

    # ---- transitive footprints ----

    def footprint(self, key: Tuple[str, str]) -> Tuple[FrozenSet, FrozenSet]:
        """(locks it may acquire, escape ops it may perform) —
        transitive over resolvable callees; call cycles degrade to the
        partial answer (fine for a lint)."""
        cached = self._foot_cache.get(key)
        if cached is not None:
            return cached
        if key in self._in_progress:
            return frozenset(), frozenset()
        ix = self.index_for(key[0])
        summ = ix.summaries.get(key[1]) if ix is not None else None
        if summ is None:
            out = (frozenset(), frozenset())
            self._foot_cache[key] = out
            return out
        self._in_progress.add(key)
        locks = {lk for lk, _, _ in summ.acquires}
        escapes = {(cat, desc) for cat, desc, _, _ in summ.escapes}
        for target, _, _ in summ.calls:
            k2 = self.resolve(target)
            if k2 is not None and k2 != key:
                l2, e2 = self.footprint(k2)
                locks |= l2
                escapes |= e2
        self._in_progress.discard(key)
        out = (frozenset(locks), frozenset(escapes))
        self._foot_cache[key] = out
        return out

    # ---- the order graph ----

    def _build_graph(self) -> None:
        for rel in self.scanned:
            ix = self.idx[rel]
            for summ in ix.summaries.values():
                for lk, line, held in summ.acquires:
                    for h, _hline in held:
                        if h == lk:
                            if lk.kind == "Lock":
                                self.self_deadlocks.append(
                                    (lk, rel, line, summ.qual)
                                )
                            continue
                        self.edges.setdefault((h, lk), (rel, line))
                for target, line, held in summ.calls:
                    if not held:
                        continue
                    k2 = self.resolve(target)
                    if k2 is None:
                        continue
                    locks, _ = self.footprint(k2)
                    for lk in locks:
                        for h, _hline in held:
                            if h == lk:
                                if lk.kind == "Lock":
                                    self.self_deadlocks.append(
                                        (lk, rel, line, summ.qual)
                                    )
                                continue
                            self.edges.setdefault((h, lk), (rel, line))

    def all_locks(self) -> List[LockId]:
        locks: Set[LockId] = set()
        for rel in self.scanned:
            ix = self.idx[rel]
            locks.update(ix.mod_locks.values())
            for info in ix.classes.values():
                locks.update(info.lock_attrs.values())
        for a, b in self.edges:
            locks.add(a)
            locks.add(b)
        return sorted(locks, key=lambda l: l.label())

    def cycles(self) -> List[List[LockId]]:
        """Simple-cycle detection over the order graph (the graph is
        tiny — a dozen locks): iterative DFS from each node, reporting
        each cycle once by its node set. Paths are bounded by the NODE
        COUNT, never an arbitrary constant — a silent cap would let a
        long cycle report ACYCLIC, the one lie this rule must never
        tell."""
        adj: Dict[LockId, List[LockId]] = {}
        nodes: Set[LockId] = set()
        for (a, b) in self.edges:
            adj.setdefault(a, []).append(b)
            nodes.add(a)
            nodes.add(b)
        max_len = len(nodes)  # a simple cycle visits each node once
        seen_sets: Set[FrozenSet[LockId]] = set()
        out: List[List[LockId]] = []

        def dfs(start: LockId) -> None:
            stack: List[Tuple[LockId, List[LockId]]] = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in adj.get(node, ()):
                    if nxt == start and len(path) > 1:
                        key = frozenset(path)
                        if key not in seen_sets:
                            seen_sets.add(key)
                            out.append(list(path))
                    elif nxt not in path and len(path) < max_len:
                        stack.append((nxt, path + [nxt]))

        for node in sorted(adj, key=lambda l: l.label()):
            dfs(node)
        return out

    def dag_json(self) -> Dict[str, object]:
        cycles = [[l.label() for l in c] for c in self.cycles()]
        for lk, rel, line, qual in self.self_deadlocks:
            cycles.append([lk.label()])
        return {
            "locks": [l.label() for l in self.all_locks()],
            "edges": [
                {"from": a.label(), "to": b.label(), "file": f, "line": n}
                for (a, b), (f, n) in sorted(
                    self.edges.items(), key=lambda kv: (kv[0][0].label(), kv[0][1].label())
                )
            ],
            "cycles": cycles,
            "verdict": "CYCLES" if cycles else "ACYCLIC",
        }


def _analysis(project: Project) -> _Analysis:
    a = project.caches.get("concurrency")
    if a is None:
        a = project.caches["concurrency"] = _Analysis(project)
    return a


def _held_desc(held: Held) -> str:
    lk, line = held[-1]
    return f"`{lk.label()}` (acquired at line {line})"


# ---------------------------------------------------------------------------
# rules


@register
class LockOrderRule(Rule):
    id = "lock-order"
    title = "lock acquisition order is a DAG (no potential deadlocks)"
    doc = (
        "Every nested acquisition — `with a: ... with b:` directly or "
        "through resolvable calls — adds an order edge a→b to the "
        "package-wide graph. A cycle means two threads can each hold "
        "one lock of a pair while waiting on the other: a potential "
        "deadlock the async serving pipeline would eventually hit "
        "under load. Re-acquiring a non-reentrant Lock already held is "
        "a guaranteed self-deadlock. The full order DAG lands in the "
        "JSON report (extras.lock_order) and obs_report_torch.py."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        a = _analysis(project)
        dag = a.dag_json()
        project.extras["lock_order"] = dag
        for lk, rel, line, qual in a.self_deadlocks:
            yield self.finding(
                rel,
                line,
                f"non-reentrant lock `{lk.label()}` acquired in `{qual}` "
                "while already held — guaranteed self-deadlock (use the "
                "caller's lock, restructure, or make the inner path "
                "lock-free)",
            )
        for cycle in a.cycles():
            path = " -> ".join(l.label() for l in cycle + [cycle[0]])
            sites = []
            ring = cycle + [cycle[0]]
            for i in range(len(cycle)):
                site = a.edges.get((ring[i], ring[i + 1]))
                if site:
                    sites.append(f"{site[0]}:{site[1]}")
            rel, line = (sites[0].rsplit(":", 1) if sites else ("", "0"))
            yield self.finding(
                rel or cycle[0].module,
                int(line),
                f"potential deadlock: lock-order cycle {path} "
                f"(edges at {', '.join(sites) or 'unresolved sites'}) — "
                "pick one global order and acquire in that order "
                "everywhere, or collapse the locks",
            )


@register
class SharedStateRaceRule(Rule):
    id = "shared-state-race"
    title = "lock-guarded state is only mutated under its lock"
    doc = (
        "For classes that use locks: an attribute mutated under a lock "
        "anywhere is inferred guarded; mutating it in a method not "
        "dominated by the lock (lexically, or via every-call-site-"
        "holds-it inference for private helpers) is a race. __init__ "
        "and threading.local attributes are exempt. Module-level "
        "mutable containers mutated from function scope without a "
        "module lock (and not threading.local) are the module-scope "
        "half of the same defect."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        a = _analysis(project)
        for rel in a.scanned:
            ix = a.idx[rel]
            yield from self._check_classes(ix)
            yield from self._check_module_containers(ix)

    # -- classes --

    def _check_classes(self, ix: _ModIndex) -> Iterable[Finding]:
        for cls, info in ix.classes.items():
            methods = {
                qual.split(".", 1)[1]: summ
                for qual, summ in ix.summaries.items()
                if summ.cls == cls
            }
            uses_locks = bool(info.lock_attrs) or any(
                s.acquires for s in methods.values()
            )
            if not uses_locks:
                continue
            # same-class call sites: method -> [(caller, held?)]
            sites: Dict[str, List[Tuple[str, bool]]] = {}
            for mname, summ in methods.items():
                for target, _line, held in summ.calls:
                    if target[0] == "self" and target[2] == cls:
                        sites.setdefault(target[3], []).append(
                            (mname, bool(held))
                        )
            dominated: Set[str] = set()
            changed = True
            while changed:
                changed = False
                for mname in methods:
                    if mname in dominated or mname == "__init__":
                        continue
                    ss = sites.get(mname)
                    if ss and all(h or c in dominated for c, h in ss):
                        dominated.add(mname)
                        changed = True
            # a helper with SOME held call sites contributes guard
            # EVIDENCE (the class clearly means the attr to be locked)
            # even when an unlocked call path keeps it from being
            # dominated — that mixed shape is exactly the defect
            partially_held = {
                m for m, ss in sites.items() if any(h for _c, h in ss)
            }

            def mut_sites(mname: str):
                summ = methods[mname]
                for chain, line, held in summ.mutations:
                    if chain[0] != "self" or len(chain) < 2:
                        continue
                    attr = chain[1]
                    if attr in info.local_attrs or attr in info.lock_attrs:
                        continue
                    yield attr, line, bool(held)

            guarded: Set[str] = set()
            for mname in methods:
                if mname == "__init__":
                    continue
                evidence = mname in dominated or mname in partially_held
                for attr, _line, lex in mut_sites(mname):
                    if lex or evidence:
                        guarded.add(attr)
            for mname in methods:
                if mname == "__init__":
                    continue
                for attr, line, lex in mut_sites(mname):
                    if not lex and mname not in dominated and attr in guarded:
                        yield self.finding(
                            ix.rel,
                            line,
                            f"`self.{attr}` is lock-guarded elsewhere in "
                            f"`{cls}` but mutated in `{mname}` without the "
                            "lock on every path — a concurrent "
                            "reader/writer tears it; take the lock or make "
                            "every call site of the helper hold it",
                        )

    # -- module-scope containers --

    def _check_module_containers(self, ix: _ModIndex) -> Iterable[Finding]:
        if not ix.mod_containers:
            return
        # module-level function call sites for domination inference
        sites: Dict[str, List[Tuple[str, bool]]] = {}
        for qual, summ in ix.summaries.items():
            for target, _line, held in summ.calls:
                if target[0] == "name" and target[1] == ix.rel:
                    sites.setdefault(target[2], []).append((qual, bool(held)))
        dominated: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for qual, summ in ix.summaries.items():
                if summ.cls is not None or qual in dominated:
                    continue
                ss = sites.get(qual)
                if ss and all(h or c in dominated for c, h in ss):
                    dominated.add(qual)
                    changed = True
        for qual, summ in ix.summaries.items():
            for chain, line, held in summ.mutations:
                name = chain[0]
                if name not in ix.mod_containers or name in ix.mod_locals:
                    continue
                if held or qual in dominated:
                    continue
                hint = (
                    "hold the module lock"
                    if ix.mod_locks
                    else "add a module lock or make it threading.local"
                )
                yield self.finding(
                    ix.rel,
                    line,
                    f"module-level container `{name}` mutated in "
                    f"`{qual}` with no lock held — concurrent callers "
                    f"tear it; {hint} (or pragma a single-thread "
                    "contract with its rationale)",
                )


@register
class HeldLockEscapeRule(Rule):
    id = "held-lock-escape"
    title = "no device sync, I/O, sleeps, or callbacks under a lock"
    doc = (
        "Work inside a critical section serializes every thread that "
        "touches the lock: a device sync (.item(), .tolist(), .cpu(), "
        ".numpy(), torch.cuda.synchronize, an event's synchronize or "
        "wait) turns it into a device-latency cliff, snapshot/file I/O into a disk "
        "stall, and a user callback into a re-entrancy deadlock (the "
        "callback may call back into the locked component). Findings "
        "name the acquisition site; fire callbacks and do I/O outside, "
        "publish results under the lock."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        a = _analysis(project)
        for rel in a.scanned:
            ix = a.idx[rel]
            for summ in ix.summaries.values():
                for cat, desc, line, held in summ.escapes:
                    if not held:
                        continue
                    yield self.finding(
                        ix.rel,
                        line,
                        f"{desc} while holding {_held_desc(held)} — "
                        "move the slow/re-entrant work outside the "
                        "critical section",
                    )
                reported: Set[Tuple[int, str]] = set()
                for target, line, held in summ.calls:
                    if not held:
                        continue
                    k2 = a.resolve(target)
                    if k2 is None:
                        continue
                    _, escapes = a.footprint(k2)
                    for cat, desc in sorted(escapes):
                        if (line, cat) in reported:
                            continue
                        reported.add((line, cat))
                        yield self.finding(
                            ix.rel,
                            line,
                            f"call into `{k2[1]}` ({k2[0]}) performs "
                            f"{desc} while holding {_held_desc(held)} — "
                            "move the slow/re-entrant work outside the "
                            "critical section",
                        )


@register
class AtomicWriteRule(Rule):
    id = "atomic-write"
    title = "text artifacts route through trace.atomic_write_text"
    doc = (
        "A raw text-mode open(..., 'w')/Path.write_text under "
        "hhmm_tpu_torch/ can strand a torn file on a crash mid-write; every "
        "text artifact (manifests, metrics exports, cost DBs) routes "
        "through the shared obs/trace.py atomic_write_text "
        "(temp + fsync + rename). Binary .npz stores implement the "
        "same discipline in bytes and are out of scope, as is "
        "obs/trace.py itself (the substrate)."
    )

    _WRITE_MODES = re.compile(r"^[wax]t?\+?$")

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            rel = mod.rel
            if not rel.startswith(_SCOPE) or rel == "hhmm_tpu_torch/obs/trace.py":
                continue
            for node in cached_walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "write_text":
                    yield self.finding(
                        rel,
                        node.lineno,
                        "raw `.write_text(...)` — route through "
                        "hhmm_tpu_torch.obs.trace.atomic_write_text so a crash "
                        "mid-write can never strand a torn artifact",
                    )
                    continue
                if not (isinstance(f, ast.Name) and f.id == "open"):
                    continue
                mode = None
                if len(node.args) >= 2:
                    mode = node.args[1]
                for kw in node.keywords:
                    if kw.arg == "mode":
                        mode = kw.value
                if (
                    isinstance(mode, ast.Constant)
                    and isinstance(mode.value, str)
                    and self._WRITE_MODES.match(mode.value)
                ):
                    yield self.finding(
                        rel,
                        node.lineno,
                        f'raw `open(..., "{mode.value}")` text write — '
                        "route through hhmm_tpu_torch.obs.trace."
                        "atomic_write_text so a crash mid-write can "
                        "never strand a torn artifact",
                    )
