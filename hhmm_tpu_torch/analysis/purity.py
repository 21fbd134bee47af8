"""Hot-path purity rules for the port (counterpart of
``hhmm_tpu/analysis/purity.py``).

The defect class: host work on a device path. In the JAX package the
device paths are what ``jit``/``lax.scan``/``vmap`` trace. The port has
no tracer: its device paths are the code that runs between kernel
launches, where a host sync (``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``torch.cuda.synchronize``, ``float(tensor)``) stalls the
launch queue for a device round trip, and a ``print``, a file or a
clock read puts host I/O on it. One stray sync in a per-step path
serializes the whole pipeline.

Two rules:

- ``hot-path-purity`` — per module, mark every function reachable
  (same-module call graph: bare-name calls and ``self``/``cls``/``ctx``
  method calls) from a device root, and flag host-sync/IO operations
  inside those functions. The roots are:

  - ``forward`` and ``backward`` of every ``torch.autograd.Function``
    subclass (``class F(torch.autograd.Function)`` or a bare imported
    ``Function``): autograd runs them inside every fit's gradient;
  - in ``kernels/cuda_semiring.py`` and ``kernels/cuda_traj.py``, every
    function that launches a kernel (calls ``<kernel>.launch(...)``):
    the wrappers each sampler step goes through.

  ``float(x)``/``int(x)`` are flagged only when the argument is
  array-shaped (contains a call/subscript/attribute), and not when it
  reads a ``.shape``/``.ndim`` or a ``len(...)``, which are host ints.
  ``np.float32``-style dtype constructors are fine; ``np.anything(...)``
  calls are not.
- ``raw-clock`` — raw ``perf_counter``/``monotonic`` reads anywhere
  under ``hhmm_tpu_torch/`` outside the obs/ substrate (which IS the
  clock plane) and outside serve/ (owned by the stricter ``serve-clock``
  rule). Host-side phase attribution belongs in ``obs.profile.PhaseClock``
  / ``obs.trace.span`` so the timings reach manifests and stay
  comparable; a raw read is a number nothing else can see. The
  benchmark drivers and harnesses are exempt (their timed loops are the
  measurement products).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set

from .astutil import attr_chain, cached_walk, module_aliases
from .engine import Finding, Module, Project, Rule, register

PKG_PREFIX = "hhmm_tpu_torch/"
# the modules whose kernel-launching functions are device roots
LAUNCH_MODULES = (
    "hhmm_tpu_torch/kernels/cuda_semiring.py",
    "hhmm_tpu_torch/kernels/cuda_traj.py",
)
_AUTOGRAD_METHODS = ("forward", "backward")

# np attribute CALLS that are pure dtype/constant constructors
_NP_PURE_ATTRS = {
    "float32",
    "float64",
    "int8",
    "int16",
    "int32",
    "int64",
    "uint8",
    "uint32",
    "bool_",
    "dtype",
}
_CLOCK_ATTRS = ("time", "perf_counter", "monotonic", "monotonic_ns", "perf_counter_ns")
# tensor methods that copy to the host (and so wait for the device)
_SYNC_METHODS = {
    "item": "`.item()` host transfer",
    "tolist": "`.tolist()` host transfer",
    "cpu": "`.cpu()` host transfer",
    "numpy": "`.numpy()` host transfer",
    "synchronize": "`.synchronize()` device sync",
}


class _ModuleIndex:
    """Per-module device-root detection + same-module reachability."""

    def __init__(self, mod: Module):
        self.mod = mod
        tree = mod.tree
        self.torch = module_aliases(tree, "torch")
        self.np = module_aliases(tree, "numpy")
        self.time_mods = module_aliases(tree, "time")
        self.function_names: Set[str] = set()
        for node in cached_walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module in (
                "torch.autograd",
                "torch.autograd.function",
            ):
                for a in node.names:
                    if a.name == "Function":
                        self.function_names.add(a.asname or a.name)
        self.defs: Dict[str, List[ast.AST]] = {}

    def _is_autograd_function(self, cls: ast.ClassDef) -> bool:
        for base in cls.bases:
            c = attr_chain(base)
            if c is None:
                continue
            if len(c) == 1 and c[0] in self.function_names:
                return True
            if len(c) == 3 and c[0] in self.torch and c[1:] == ["autograd", "Function"]:
                return True
        return False

    def device_roots(self) -> List[ast.AST]:
        """The autograd ``forward``/``backward`` methods, and (in the
        launch modules) the functions that launch a kernel."""
        roots: List[ast.AST] = []
        for node in cached_walk(self.mod.tree):
            if isinstance(node, ast.ClassDef) and self._is_autograd_function(node):
                for sub in node.body:
                    if (
                        isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and sub.name in _AUTOGRAD_METHODS
                    ):
                        roots.append(sub)
        if self.mod.rel in LAUNCH_MODULES:
            for node in self.mod.tree.body:
                if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if any(
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "launch"
                    and isinstance(n.func.value, ast.Name)
                    for n in ast.walk(node)
                ):
                    roots.append(node)
        return roots

    def reachable(self) -> List[ast.AST]:
        """Roots plus the defs reachable from them via same-module
        bare-name and ``self``/``cls``/``ctx`` calls. Cross-module
        reachability is out of scope."""
        out: List[ast.AST] = []
        seen_nodes: Set[int] = set()
        frontier: List[ast.AST] = list(self.device_roots())
        if not frontier:
            return out
        for node in cached_walk(self.mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs.setdefault(node.name, []).append(node)
        seen_names: Set[str] = set()
        while frontier:
            d = frontier.pop()
            if id(d) in seen_nodes:
                continue
            seen_nodes.add(id(d))
            out.append(d)
            for n in ast.walk(d):
                if not isinstance(n, ast.Call):
                    continue
                f = n.func
                name = None
                if isinstance(f, ast.Name) and f.id in self.defs:
                    name = f.id
                elif (
                    isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id in ("self", "cls", "ctx")
                    and f.attr in self.defs
                ):
                    name = f.attr
                if name is not None and name not in seen_names:
                    seen_names.add(name)
                    frontier.extend(self.defs[name])
        return out


def _arrayish(arg: ast.AST) -> bool:
    """Heuristic: the expression can hold a tensor — it contains a call,
    subscript, or attribute read. Bare names, constants, and arithmetic
    over them stay exempt, as is anything routed through a
    ``.shape``/``.ndim`` read or ``len(...)`` — those are host ints."""
    for n in ast.walk(arg):
        if isinstance(n, ast.Attribute) and n.attr in ("shape", "ndim"):
            return False
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id == "len":
            return False
    for n in ast.walk(arg):
        if isinstance(n, (ast.Call, ast.Subscript, ast.Attribute)):
            return True
    return False


@register
class HotPathPurityRule(Rule):
    id = "hot-path-purity"
    title = "no host sync/IO in functions reachable from a device root"
    doc = (
        ".item(), .tolist(), .cpu(), .numpy(), .synchronize() "
        "(torch.cuda.synchronize, an event's or stream's), float()/int() "
        "on array-shaped arguments, np.*() calls, print(), open() and raw "
        "clock reads are flagged inside any function reachable — through "
        "the module's own call graph — from a torch.autograd.Function's "
        "forward/backward or a kernel-launching wrapper of "
        "kernels/cuda_semiring.py and kernels/cuda_traj.py. Each is a "
        "device round trip or host I/O on a per-step path. Deliberate "
        "syncs live OUTSIDE those functions; anything that genuinely "
        "must stay gets an inline pragma or an allowlist entry with a "
        "rationale."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            if not mod.rel.startswith(PKG_PREFIX):
                continue
            idx = _ModuleIndex(mod)
            for body in idx.reachable():
                fname = getattr(body, "name", "<lambda>")
                for n in ast.walk(body):
                    msg = self._impure(n, idx)
                    if msg:
                        yield self.finding(
                            mod.rel,
                            n.lineno,
                            f"{msg} inside `{fname}`, which is reachable from "
                            "an autograd forward/backward or a kernel launch "
                            "wrapper — host work there is a device round "
                            "trip per call (hot-path purity)",
                        )

    def _impure(self, n: ast.AST, idx: _ModuleIndex) -> str:
        if not isinstance(n, ast.Call):
            return ""
        f = n.func
        if isinstance(f, ast.Attribute):
            if f.attr in _SYNC_METHODS and not n.args:
                return _SYNC_METHODS[f.attr]
            if isinstance(f.value, ast.Name):
                if f.value.id in idx.np and f.attr not in _NP_PURE_ATTRS:
                    return f"`{f.value.id}.{f.attr}(...)` NumPy host call"
                if f.value.id in idx.time_mods and f.attr in _CLOCK_ATTRS:
                    return f"raw clock read `{f.value.id}.{f.attr}()`"
        elif isinstance(f, ast.Name):
            if f.id == "print":
                return "`print(...)` host IO"
            if f.id == "open":
                return "`open(...)` file IO"
            if f.id in ("float", "int", "bool") and n.args and _arrayish(n.args[0]):
                return f"`{f.id}(...)` cast of an array-shaped value"
            if f.id == "perf_counter":
                return "raw clock read `perf_counter()`"
        return ""


@register
class RawClockRule(Rule):
    id = "raw-clock"
    title = "host-side clock reads route through the obs plane"
    doc = (
        "Raw perf_counter/monotonic reads under hhmm_tpu_torch/ (outside "
        "obs/, which is the clock substrate, and serve/, owned by the "
        "stricter serve-clock rule) are flagged: phase attribution "
        "belongs in obs.profile.PhaseClock or obs.trace.span so timings "
        "reach manifests and aggregate consistently. The benchmark "
        "drivers and harnesses are exempt — their timed loops are the "
        "measurement products themselves."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            rel = mod.rel
            if not rel.startswith(PKG_PREFIX):
                continue
            if rel.startswith(PKG_PREFIX + "obs/") or rel.startswith(PKG_PREFIX + "serve/"):
                continue
            if rel.startswith(PKG_PREFIX + "analysis/"):
                continue
            time_mods = module_aliases(mod.tree, "time")
            bare: Set[str] = set()
            for node in cached_walk(mod.tree):
                if isinstance(node, ast.ImportFrom) and node.module == "time":
                    for a in node.names:
                        if a.name in ("perf_counter", "monotonic"):
                            bare.add(a.asname or a.name)
            for node in cached_walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                hit = ""
                if isinstance(f, ast.Name) and f.id in bare:
                    hit = f.id
                elif (
                    isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id in time_mods
                    and f.attr in ("perf_counter", "monotonic")
                ):
                    hit = f"{f.value.id}.{f.attr}"
                if hit:
                    yield self.finding(
                        mod.rel,
                        node.lineno,
                        f"raw `{hit}()` read — route phase attribution "
                        "through hhmm_tpu_torch.obs.profile.PhaseClock (or an "
                        "obs.trace span) so the timing reaches manifests "
                        "and aggregates consistently",
                    )
