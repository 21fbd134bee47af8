"""Random-stream discipline rules for the port (the counterpart of
``hhmm_tpu/analysis/prng.py``).

The defect class: torch's global random stream. The JAX package's keys
are values, so its defects are a key consumed twice and a dead split.
The port draws from ``torch.Generator`` objects instead: every sampler
takes a generator seeded from the run's seed (``derive_seed`` and
friends), so a run is a function of its seed. A draw that names no
generator reads the process-wide stream — whatever another thread,
library or earlier phase left there — and a call that reseeds that
stream moves every other such draw in the process. Either one makes a
run stop being a function of its seed, silently: the numbers still look
random.

Two rules, over every module of the package:

- ``torch-generator`` (error) — a random draw that names no
  ``generator=``: ``torch.rand/randn/randint/randperm/multinomial/
  bernoulli/normal/poisson`` (any alias of torch, or a bare imported
  name) and the in-place draws ``.uniform_/.normal_/.exponential_/
  .bernoulli_/.random_/.cauchy_/.log_normal_/.geometric_`` on any
  tensor. A call that passes ``**kwargs`` is taken to name one. It also
  flags, wherever they appear, the calls that can take no generator or
  that reseed the global stream: every ``torch.*_like`` draw
  (``rand_like``, ``randn_like``, ``randint_like``), ``torch.manual_seed``,
  ``torch.seed``, ``torch.random.manual_seed``, ``torch.cuda.manual_seed``
  / ``manual_seed_all`` / ``seed`` / ``seed_all`` and
  ``torch.set_rng_state`` / ``torch.cuda.set_rng_state``.
  ``generator.manual_seed(...)`` on a generator object is how a stream
  is seeded and is fine.
- ``generator-dead`` (warning) — a name bound to a fresh
  ``torch.Generator(...)`` (or ``torch.Generator(...).manual_seed(s)``)
  that is never read afterwards in the same scope: a stream made and
  dropped usually means a draw was refactored onto the wrong stream
  (often the global one). Underscore-prefixed names are exempt
  (explicitly discarded).

Calls are read as AST nodes, so a ``generator=`` on a later line of a
call spread over several lines counts; the finding sits on the call's
first line.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Set

from .astutil import attr_chain, cached_walk, module_aliases, own_scope_nodes
from .engine import Finding, Module, Project, Rule, register

PKG_PREFIX = "hhmm_tpu_torch/"

# torch functions that draw and take a keyword-only `generator=`
_DRAWS = (
    "rand",
    "randn",
    "randint",
    "randperm",
    "multinomial",
    "bernoulli",
    "normal",
    "poisson",
)
# in-place tensor draws (methods); each takes `generator=`
_INPLACE = (
    "uniform_",
    "normal_",
    "exponential_",
    "bernoulli_",
    "random_",
    "cauchy_",
    "log_normal_",
    "geometric_",
)
# calls on the global stream itself: no generator can be named
_GLOBAL = {
    ("manual_seed",): "reseeds the global stream",
    ("seed",): "reseeds the global stream",
    ("random", "manual_seed"): "reseeds the global stream",
    ("random", "seed"): "reseeds the global stream",
    ("set_rng_state",): "overwrites the global stream",
    ("random", "set_rng_state"): "overwrites the global stream",
    ("cuda", "manual_seed"): "reseeds the global CUDA stream",
    ("cuda", "manual_seed_all"): "reseeds the global CUDA streams",
    ("cuda", "seed"): "reseeds the global CUDA stream",
    ("cuda", "seed_all"): "reseeds the global CUDA streams",
    ("cuda", "set_rng_state"): "overwrites the global CUDA stream",
    ("cuda", "set_rng_state_all"): "overwrites the global CUDA streams",
}


def _torch_names(tree: ast.AST):
    """(aliases of torch, bare names imported from torch that draw or
    reseed → their torch name)."""
    mods = module_aliases(tree, "torch")
    bare: Dict[str, str] = {}
    for node in cached_walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name in _DRAWS or a.name.endswith("_like") or (a.name,) in _GLOBAL:
                    bare[a.asname or a.name] = a.name
    return mods, bare


def _names_generator(call: ast.Call) -> bool:
    return any(k.arg == "generator" or k.arg is None for k in call.keywords)


def _torch_tail(f: ast.AST, mods: Set[str]):
    """The attribute path after a torch alias — ``torch.cuda.manual_seed``
    → ``("cuda", "manual_seed")`` — or None."""
    c = attr_chain(f)
    if c is None or len(c) < 2 or c[0] not in mods:
        return None
    return tuple(c[1:])


@register
class TorchGeneratorRule(Rule):
    id = "torch-generator"
    title = "every random draw names its torch.Generator"
    doc = (
        "A draw without generator= reads torch's process-wide stream, and "
        "manual_seed/seed/set_rng_state (torch or torch.cuda) rewrite it: "
        "either makes a run stop being a function of its seed, silently. "
        "Pass the sampler's generator (generator=) to every torch.rand/"
        "randn/randint/randperm/multinomial/bernoulli/normal/poisson and "
        "in-place draw; *_like draws take no generator — draw with the "
        "shape and generator instead."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            if not mod.rel.startswith(PKG_PREFIX):
                continue
            mods, bare = _torch_names(mod.tree)
            for node in cached_walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                msg = self._defect(node, mods, bare)
                if msg:
                    yield self.finding(mod.rel, node.lineno, msg)

    def _defect(self, node: ast.Call, mods: Set[str], bare: Dict[str, str]) -> str:
        f = node.func
        name = None
        tail = _torch_tail(f, mods)
        if tail is not None:
            spelled = "torch." + ".".join(tail)
        elif isinstance(f, ast.Name) and f.id in bare:
            tail = (bare[f.id],)
            spelled = f.id
        elif isinstance(f, ast.Attribute) and f.attr in _INPLACE:
            if _names_generator(node):
                return ""
            return (
                f"in-place draw `.{f.attr}(...)` names no generator= — it "
                "reads torch's global stream, so the run stops being a "
                "function of its seed; pass the sampler's torch.Generator"
            )
        else:
            return ""
        if tail in _GLOBAL:
            return (
                f"`{spelled}(...)` {_GLOBAL[tail]} — every draw without a "
                "generator moves with it; seed a torch.Generator of your "
                "own instead"
            )
        if len(tail) == 1:
            name = tail[0]
        if name is None:
            return ""
        if name.endswith("_like") and name[:-5] in ("rand", "randn", "randint"):
            return (
                f"`{spelled}(...)` takes no generator and reads torch's "
                "global stream — draw with the shape and the sampler's "
                "generator (torch.rand(x.shape, generator=g, ...))"
            )
        if name in _DRAWS and not _names_generator(node):
            return (
                f"`{spelled}(...)` names no generator= — it reads torch's "
                "global stream, so the run stops being a function of its "
                "seed; pass the sampler's torch.Generator"
            )
        return ""


def _is_generator_ctor(value: ast.AST, mods: Set[str], bare: Set[str]) -> bool:
    """``torch.Generator(...)``, a bare imported ``Generator(...)``, or
    either with ``.manual_seed(s)`` chained on."""
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    if isinstance(f, ast.Attribute) and f.attr == "manual_seed":
        return _is_generator_ctor(f.value, mods, bare)
    if isinstance(f, ast.Name):
        return f.id in bare
    c = attr_chain(f)
    return c is not None and len(c) == 2 and c[0] in mods and c[1] == "Generator"


@register
class GeneratorDeadRule(Rule):
    id = "generator-dead"
    severity = "warning"
    title = "no torch.Generator made and never used"
    doc = (
        "A generator bound to a name and never read in its scope is a "
        "stream made and dropped — usually a draw was refactored onto "
        "the wrong stream (often the global one). Use it, delete it, or "
        "bind the discard to an underscore-prefixed name."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            if not mod.rel.startswith(PKG_PREFIX):
                continue
            mods = module_aliases(mod.tree, "torch")
            bare = {
                a.asname or a.name
                for node in cached_walk(mod.tree)
                if isinstance(node, ast.ImportFrom) and node.module == "torch"
                for a in node.names
                if a.name == "Generator"
            }
            if not mods and not bare:
                continue
            binds = [
                n
                for n in cached_walk(mod.tree)
                if isinstance(n, (ast.Assign, ast.AnnAssign))
                and n.value is not None
                and _is_generator_ctor(n.value, mods, bare)
            ]
            if not binds:
                continue
            scopes = [
                n
                for n in cached_walk(mod.tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            ]
            for n in binds:
                yield from self._check_bind(mod, n, scopes)

    def _check_bind(self, mod: Module, n, scopes) -> Iterable[Finding]:
        # the function whose own scope holds the binding is its scope
        # (module-level bindings are out of scope); a nested def or
        # lambda reading the name uses it too
        holders = [
            f
            for f in scopes
            if f.lineno <= n.lineno <= getattr(f, "end_lineno", f.lineno)
            and any(s is n for s in own_scope_nodes(f))
        ]
        if not holders:
            return
        scope = holders[0]
        loads = {
            m.id
            for m in ast.walk(scope)
            if isinstance(m, ast.Name) and isinstance(m.ctx, ast.Load)
        }
        targets = n.targets if isinstance(n, ast.Assign) else [n.target]
        for t in targets:
            if not isinstance(t, ast.Name) or t.id.startswith("_"):
                continue
            if t.id not in loads:
                yield self.finding(
                    mod.rel,
                    n.lineno,
                    f"generator `{t.id}` is made and never used in this "
                    "scope — a dropped stream (a draw likely reads the "
                    "wrong one)",
                )
