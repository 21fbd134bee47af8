"""Import-layering rules for the port (counterpart of
``hhmm_tpu/analysis/layering.py``): the layer map as an enforced DAG,
and the single entry to the CUDA kernel machinery.

Every subpackage has a rank; imports must point strictly DOWN the
ranks. A back-edge import couples a substrate to a consumer: the next
refactor of the consumer breaks the substrate, and import cycles start
appearing as "lazy import inside a function" workarounds that this rule
makes visible instead of letting them accrete silently.

Ranks (higher may import lower; equal ranks may NOT import each
other — siblings stay decoupled)::

    10 viz
    9  convert
    8  apps
    7  maint
    6  adapt
    5  serve
    4  models, batch, pipeline
    3  infer, plan
    2  kernels
    1  obs, sim
    0  core, hhmm, native, robust, analysis
   -1  _device

The ranks from ``core`` to ``apps`` are the JAX package's, but for
``sim``. The port adds two modules that sit directly under
``hhmm_tpu_torch/`` and count as layers of their own: ``_device``
(device resolution, imported from every layer, imports nothing of the
package: below all) and ``convert`` (builds a port model from a JAX
model object; it reads ``models`` and ``hhmm`` and nothing imports it
but tests). ``sim`` moves up one rank: the port's simulators draw
through ``core.dists`` (the Gumbel-max sampler) and resolve devices,
where the JAX ones call ``jax.random`` directly. ``viz`` stays on top:
it draws what ``apps`` computes.

``import hhmm_tpu_torch`` (the root package: version metadata only) is
allowed from anywhere. Function-scoped (lazy) imports are findings too —
laziness hides a cycle, it does not remove it; a deliberate
cycle-breaking lazy import carries an inline ``# lint: ok layer-import
-- why`` pragma so every such edge is audited.

``cuda-import`` (the port's ``pallas-import``): ``triton``,
``torch.utils.cpp_extension`` and the kernel machinery
(``kernels.cuda_build``, ``kernels.cuda_semiring``, ``kernels.cuda_traj``)
are imported only inside ``hhmm_tpu_torch/kernels/``: everything above
enters the kernels through the dispatch layer and the kernels package's
public entries.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from .astutil import cached_walk
from .engine import Finding, Project, Rule, register

PKG = "hhmm_tpu_torch"

LAYERS = {
    "_device": -1,
    "core": 0,
    "hhmm": 0,
    "native": 0,
    "robust": 0,
    "analysis": 0,
    "obs": 1,
    "sim": 1,
    "kernels": 2,
    "infer": 3,
    "plan": 3,
    "models": 4,
    "batch": 4,
    "pipeline": 4,
    "serve": 5,
    "adapt": 6,
    "maint": 7,
    "apps": 8,
    "convert": 9,
    "viz": 10,
}


def _src_package(rel: str) -> Optional[str]:
    """The layer a repo-relative file belongs to: its subpackage, or,
    for a module directly under the package whose name is a layer
    (``_device.py``, ``convert.py``), that module; None for the other
    files directly under the package (the root ``__init__`` and
    toy-fixture modules are unconstrained)."""
    parts = rel.split("/")
    if len(parts) < 2 or parts[0] != PKG:
        return None
    if len(parts) == 2:
        stem = parts[1][:-3] if parts[1].endswith(".py") else parts[1]
        return stem if stem in LAYERS and stem != "__init__" else None
    return parts[1]


def _import_targets(node: ast.AST, rel: str) -> List[Tuple[int, str]]:
    """(line, dst_layer) pairs for one import node."""
    out: List[Tuple[int, str]] = []
    if isinstance(node, ast.Import):
        for a in node.names:
            p = a.name.split(".")
            if p[0] == PKG and len(p) > 1:
                out.append((node.lineno, p[1]))
    elif isinstance(node, ast.ImportFrom):
        if node.module and node.module.split(".")[0] == PKG and node.level == 0:
            p = node.module.split(".")
            if len(p) > 1:
                out.append((node.lineno, p[1]))
            else:
                # `from hhmm_tpu_torch import serve` — each alias may be a
                # layer
                for a in node.names:
                    if a.name in LAYERS:
                        out.append((node.lineno, a.name))
        elif node.level >= 2 or (node.level == 1 and len(rel.split("/")) == 2):
            # relative import reaching ABOVE the current subpackage (or
            # any relative import from a module directly under the
            # package): resolve against the file's own package path
            pkg_parts = rel.split("/")[:-1]
            base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
            mod = base + (node.module.split(".") if node.module else [])
            if len(mod) > 1 and mod[0] == PKG:
                out.append((node.lineno, mod[1]))
            elif mod == [PKG]:
                # `from .. import apps` — the aliases are the layers,
                # exactly like the absolute spelling
                for a in node.names:
                    if a.name in LAYERS:
                        out.append((node.lineno, a.name))
    return out


KERNELS_PREFIX = f"{PKG}/kernels/"
# the kernel machinery: built, bound and launched only inside kernels/
CUDA_MODULES = ("cuda_build", "cuda_semiring", "cuda_traj")
# third-party build routes: a Triton kernel or an inline C++ extension
CUDA_PACKAGES = ("triton", "torch.utils.cpp_extension")


def _is_cuda_package(dotted: str) -> bool:
    return any(dotted == p or dotted.startswith(p + ".") for p in CUDA_PACKAGES)


def _cuda_import_sites(node: ast.AST, rel: str) -> List[Tuple[int, str]]:
    """(line, dotted-target) pairs where this import reaches the CUDA
    kernel machinery, any spelling: absolute ``import``/``from ...
    import``, the ``from hhmm_tpu_torch.kernels import cuda_x`` alias
    form, ``from torch.utils import cpp_extension``, and relative
    imports resolved against the file's own package path."""
    out: List[Tuple[int, str]] = []

    def kernel_module(parts: List[str], names) -> None:
        if parts[:2] != [PKG, "kernels"]:
            return
        if len(parts) > 2 and parts[2] in CUDA_MODULES:
            out.append((node.lineno, ".".join(parts)))
        elif len(parts) == 2:
            for a in names:
                if a.name in CUDA_MODULES:
                    out.append((node.lineno, ".".join(parts) + f".{a.name}"))

    if isinstance(node, ast.Import):
        for a in node.names:
            p = a.name.split(".")
            if _is_cuda_package(a.name):
                out.append((node.lineno, a.name))
            elif p[:2] == [PKG, "kernels"] and len(p) > 2 and p[2] in CUDA_MODULES:
                out.append((node.lineno, a.name))
    elif isinstance(node, ast.ImportFrom):
        if node.level == 0 and node.module:
            if _is_cuda_package(node.module):
                out.append((node.lineno, node.module))
            elif node.module == "torch.utils":
                for a in node.names:
                    if a.name == "cpp_extension":
                        out.append((node.lineno, "torch.utils.cpp_extension"))
            else:
                kernel_module(node.module.split("."), node.names)
        elif node.level >= 1:
            pkg_parts = rel.split("/")[:-1]
            base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
            kernel_module(base + (node.module.split(".") if node.module else []), node.names)
    return out


@register
class CudaImportRule(Rule):
    id = "cuda-import"
    title = "the CUDA kernel machinery is imported only inside kernels/"
    doc = (
        "No `triton`, `torch.utils.cpp_extension`, or "
        "`hhmm_tpu_torch.kernels.cuda_build` / `cuda_semiring` / "
        "`cuda_traj` import outside the kernels package: the kernels "
        "package's dispatch layer is the one entry per primitive — a "
        "direct import bypasses the branch arbitration (the plain "
        "versions on the CPU, the CUDA kernels on the card), the "
        "eligibility checks, and the span/plan observability, and a "
        "second build route would load libraries the manifest's compile "
        "stanza never sees. The port's counterpart of pallas-import."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            if mod.rel.startswith(KERNELS_PREFIX):
                continue
            for node in cached_walk(mod.tree):
                for line, target in _cuda_import_sites(node, mod.rel):
                    yield self.finding(
                        mod.rel,
                        line,
                        f"direct CUDA kernel-machinery import `{target}` "
                        "outside hhmm_tpu_torch/kernels/ — go through the "
                        "dispatch layer (`hhmm_tpu_torch.kernels` and "
                        "`kernels.dispatch` export the sanctioned entries; "
                        "the device of the tensors selects the branch)",
                    )


@register
class LayerImportRule(Rule):
    id = "layer-import"
    title = "imports follow the layering DAG (no back-edges)"
    doc = (
        "_device ← core ← obs/sim ← kernels ← infer/plan ← models/batch/pipeline "
        "← serve ← adapt ← maint ← apps ← convert ← viz: imports must "
        "point strictly down the ranks; same-rank siblings stay "
        "decoupled. A back-edge couples a substrate to its consumer and "
        "breeds import cycles. Deliberate lazy cycle-breaking imports "
        "carry an inline pragma with a rationale; a new subpackage must "
        "be added to the layer map (hhmm_tpu_torch/analysis/layering.py) "
        "before it can import anything."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            src = _src_package(mod.rel)
            if src is None:
                continue
            src_rank = LAYERS.get(src)
            if src_rank is None:
                yield self.finding(
                    mod.rel,
                    0,
                    f"subpackage `{src}` is not in the layer map — add it "
                    "to hhmm_tpu_torch/analysis/layering.py LAYERS",
                )
                continue
            for node in cached_walk(mod.tree):
                for line, dst in _import_targets(node, mod.rel):
                    if dst == src:
                        continue
                    dst_rank = LAYERS.get(dst)
                    if dst_rank is None:
                        yield self.finding(
                            mod.rel,
                            line,
                            f"imports unmapped subpackage `{PKG}.{dst}` — "
                            "add it to the layer map "
                            "(hhmm_tpu_torch/analysis/layering.py)",
                        )
                    elif dst_rank >= src_rank:
                        kind = (
                            "back-edge"
                            if dst_rank > src_rank
                            else "same-rank sibling"
                        )
                        yield self.finding(
                            mod.rel,
                            line,
                            f"{kind} import `{PKG}.{dst}` (rank "
                            f"{dst_rank}) from `{src}` (rank {src_rank}) — "
                            "violates the layering DAG; invert the "
                            "dependency or pragma a deliberate lazy "
                            "cycle-breaker with its rationale",
                        )
