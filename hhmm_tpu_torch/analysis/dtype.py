"""Dtype discipline rules for the port's device-code directories
(counterpart of ``hhmm_tpu/analysis/dtype.py``).

The defect class: silent float64. The port's kernels run f32 (the CUDA
kernels take f32 only; an H100 runs f64 at a fraction of its f32 rate),
with f64 as an explicitly requested test mode of the plain versions, so
a stray ``float64`` in a kernel either tanks throughput or forks
numerics against the f32 production path; and a tensor constructor with
no dtype takes torch's ambient default, which a caller's
``torch.set_default_dtype(torch.float64)`` flips. Scope: the same as the
JAX rule's — ``hhmm_tpu_torch/kernels/``, ``hhmm_tpu_torch/core/``, and
``hhmm_tpu_torch/serve/online.py``. Host-side boundary conversions
(``models/*``, app drivers) are out of scope by construction; the rare
in-scope host-side site carries an allowlist entry with its rationale.

- ``dtype-float64`` (error) — any ``float64`` spelling: the
  ``torch.float64``/``torch.double``/``np.float64`` attribute, a
  ``"float64"`` string fed to a call, and the ``.double()`` cast.
- ``dtype-implicit`` (error) — ``torch.zeros``/``ones``/``empty``/
  ``full``/``tensor``/``arange`` (any alias of torch, or a bare imported
  name) with no ``dtype=``. Derive the dtype from an input
  (``x.dtype``) instead of hardcoding one where the function is generic
  over f32/f64, and name the integer or f32 dtype where it is not.
"""

from __future__ import annotations

import ast
from typing import Iterable, Set

from .astutil import cached_walk, module_aliases
from .engine import Finding, Project, Rule, register

_SCOPE_PREFIXES = ("hhmm_tpu_torch/kernels/", "hhmm_tpu_torch/core/")
_SCOPE_FILES = ("hhmm_tpu_torch/serve/online.py",)

_CTORS = ("zeros", "ones", "empty", "full", "tensor", "arange")


def _in_scope(rel: str) -> bool:
    return rel.startswith(_SCOPE_PREFIXES) or rel in _SCOPE_FILES


def _numeric_aliases(tree: ast.AST) -> Set[str]:
    return module_aliases(tree, "torch") | module_aliases(tree, "numpy")


@register
class DtypeFloat64Rule(Rule):
    id = "dtype-float64"
    title = "no float64 literals/casts in device-code directories"
    doc = (
        "f64 runs at a fraction of the f32 rate on the card and the CUDA "
        "kernels take f32 only; a hard-coded f64 forks numerics against "
        "the f32 production path. Kernels stay generic: propagate an "
        "input's dtype. Genuine host-side boundary sites in scope are "
        "allowlisted with a rationale."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            if not _in_scope(mod.rel):
                continue
            aliases = _numeric_aliases(mod.tree)
            torch_aliases = module_aliases(mod.tree, "torch")
            for node in cached_walk(mod.tree):
                if (
                    isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and (
                        (node.attr == "float64" and node.value.id in aliases)
                        or (node.attr == "double" and node.value.id in torch_aliases)
                    )
                ):
                    yield self.finding(
                        mod.rel,
                        node.lineno,
                        f"`{node.value.id}.{node.attr}` in device-code scope — "
                        "f64 is slow on the card and forks numerics vs the "
                        "f32 path; propagate an input dtype instead",
                    )
                elif isinstance(node, ast.Call):
                    f = node.func
                    if isinstance(f, ast.Attribute) and f.attr == "double" and not node.args:
                        yield self.finding(
                            mod.rel,
                            node.lineno,
                            "`.double()` cast in device-code scope — f64 is "
                            "slow on the card and forks numerics vs the f32 "
                            "path; propagate an input dtype instead",
                        )
                    for arg in list(node.args) + [k.value for k in node.keywords]:
                        if (
                            isinstance(arg, ast.Constant)
                            and arg.value == "float64"
                        ):
                            yield self.finding(
                                mod.rel,
                                node.lineno,
                                'string dtype "float64" in device-code scope '
                                "— f64 is slow on the card; propagate an "
                                "input dtype instead",
                            )


@register
class DtypeImplicitRule(Rule):
    id = "dtype-implicit"
    title = "no dtype-less torch.zeros/ones/empty/full/tensor/arange in device-code directories"
    doc = (
        "A tensor constructor with no dtype takes torch's ambient default "
        "(float for zeros/ones/empty/full and float literals, int64 for "
        "integer aranges), which torch.set_default_dtype flips under the "
        "kernels; an implicit constructor silently forks numerics per "
        "caller. Pass dtype= — derived from an input (`x.dtype`) where "
        "the function is generic over f32/f64."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            if not _in_scope(mod.rel):
                continue
            aliases = module_aliases(mod.tree, "torch")
            bare = {}
            for node in cached_walk(mod.tree):
                if isinstance(node, ast.ImportFrom) and node.module == "torch":
                    for a in node.names:
                        if a.name in _CTORS:
                            bare[a.asname or a.name] = a.name
            for node in cached_walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                spelled = ""
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr in _CTORS
                    and isinstance(f.value, ast.Name)
                    and f.value.id in aliases
                ):
                    spelled = f"{f.value.id}.{f.attr}"
                elif isinstance(f, ast.Name) and f.id in bare:
                    spelled = f.id
                if not spelled:
                    continue
                if not any(k.arg in ("dtype", None) for k in node.keywords):
                    yield self.finding(
                        mod.rel,
                        node.lineno,
                        f"dtype-less `{spelled}(...)` in device-code scope — "
                        "the ambient default dtype flips with "
                        "torch.set_default_dtype; pass dtype= (derived from "
                        "an input, e.g. `x.dtype`, where the code is generic)",
                    )
