"""The guard invariants as rules (counterpart of
``hhmm_tpu/analysis/legacy.py``): the same scoping, detection logic and
message shapes, with each rule's pinned paths moved to the port's
counterparts.

Rule ids (pragma keys):

====================  ==============================================
``bare-except``       no bare ``except:`` in the package
``sampler-guard``     infer/{run,chees,gibbs}.py call a chain guard
``serve-norm-guard``  serve/online.py calls safe_log_normalize
``semiring-guard``    kernels/semiring.py, assoc.py: guarded lse only
``monotonic-clock``   no raw ``time.time()``
``kernel-build``      ``.so`` loads only in kernels/cuda_build.py
``metrics-plane``     one shared metrics registry
``placement``         placement objects only under plan/
``serve-degrade``     scheduler hot paths degrade, never raise
``timing-harness``    timing loops only in obs/profile.py
``serve-clock``       no raw perf_counter under serve/
====================  ==============================================

``kernel-build`` takes the place of the JAX package's ``jit-telemetry``:
the port has no jit to register. Its cold start is ``nvcc`` and a
library load, which ``kernels/cuda_build.py`` reports to
``obs/telemetry.py``; a library loaded anywhere else is a build the run
manifest never sees.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Tuple

from .astutil import (
    attr_chain,
    cached_walk,
    called_names,
    imported_symbols,
    is_device_sync_call,
    is_perf_counter_call,
    own_scope_nodes,
    perf_counter_names,
)
from .engine import Finding, Module, Project, Rule, register

# ---------------------------------------------------------------------------
# shared tables (the JAX package's, moved to the port's paths)

SAMPLER_MODULES = {
    "hhmm_tpu_torch/infer/run.py": ("guard_update", "guard_where"),
    "hhmm_tpu_torch/infer/chees.py": ("guard_update", "guard_where"),
    "hhmm_tpu_torch/infer/gibbs.py": ("guard_update", "guard_where"),
}
GUARDS_MODULE = "hhmm_tpu_torch.robust.guards"

SERVE_MODULES = {
    "hhmm_tpu_torch/serve/online.py": ("safe_log_normalize",),
}
LMATH_MODULES = ("hhmm_tpu_torch.core.lmath", "hhmm_tpu_torch.core")

SEMIRING_MODULES = (
    "hhmm_tpu_torch/kernels/semiring.py",
    "hhmm_tpu_torch/kernels/assoc.py",
)
RAW_LSE_ATTRS = ("logaddexp", "logsumexp")
RAW_LSE_WRAPPERS = ("logsumexp", "log_vecmat", "log_matvec", "log_normalize")

TELEMETRY_MODULES = ("hhmm_tpu_torch.obs.telemetry", "hhmm_tpu_torch.obs")
BUILD_MODULE = "hhmm_tpu_torch/kernels/cuda_build.py"
BUILD_HOOKS = ("note_build", "note_load")

METRICS_MODULES = ("hhmm_tpu_torch.obs.metrics", "hhmm_tpu_torch.obs")
METRIC_FNS = ("counter", "gauge", "histogram")
AD_HOC_COUNT_RE = re.compile(r"(^|_)(counts?|counters?)$")

# the torch.distributed placement objects: a device mesh and a
# DTensor's distribution (the JAX package's Mesh / NamedSharding /
# PartitionSpec)
SHARDING_CTORS = ("DeviceMesh", "init_device_mesh", "distribute_tensor")
SHARDING_MODULES = (
    "torch.distributed.device_mesh",
    "torch.distributed.tensor",
    "torch.distributed._tensor",
)
PLACEMENT_ALLOWED_PREFIX = "hhmm_tpu_torch/plan/"

SERVE_HOT_PATH_FILE = "hhmm_tpu_torch/serve/scheduler.py"
HOT_PATH_METHOD_RE = re.compile(r"^(tick|flush|submit|attach\w*)$")
HOT_PATH_DISPATCH_ATTR = "_dispatch"

TIMING_HARNESS_FILE = "hhmm_tpu_torch/obs/profile.py"
SERVE_DIR_PREFIX = "hhmm_tpu_torch/serve/"

# the port's root tools (the default targets beside the package)
_ROOT_TOOLS = ("lint_torch.py", "obs_report_torch.py")


def _in_package(rel: str) -> bool:
    return rel.startswith("hhmm_tpu_torch/")


def _clock_scope(rel: str) -> bool:
    return _in_package(rel) or rel in _ROOT_TOOLS


# ---------------------------------------------------------------------------


@register
class BareExceptRule(Rule):
    id = "bare-except"
    title = "no bare `except:` anywhere under hhmm_tpu_torch/"
    doc = (
        "A bare handler swallows KeyboardInterrupt/SystemExit and masks "
        "the device faults the retry layer (robust/retry.py) must see to "
        "classify (a lost card vs a deterministic error). Catch concrete "
        "types."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            if not _in_package(mod.rel):
                continue
            for node in cached_walk(mod.tree):
                if isinstance(node, ast.ExceptHandler) and node.type is None:
                    yield self.finding(
                        mod.rel,
                        node.lineno,
                        "bare `except:` (name the exception types)",
                    )


class _GuardedImportRule(Rule):
    """sampler-guard and serve-norm-guard share one shape: named
    modules must import a guard function from a named source module AND
    call it."""

    spec: Dict[str, Tuple[str, ...]] = {}
    source_modules: Tuple[str, ...] = ()
    kind = ""
    noun = ""
    what = ""

    def check(self, project: Project) -> Iterable[Finding]:
        for rel, guard_fns in sorted(self.spec.items()):
            mod = project.module(rel)
            if mod is None:
                yield self.finding(rel, 0, f"{self.kind} module missing")
                continue
            imported = imported_symbols(mod.tree, self.source_modules) & set(guard_fns)
            if not imported:
                yield self.finding(
                    rel,
                    0,
                    f"does not import a {self.noun} from "
                    f"{self.source_modules[0]} (expected one of {guard_fns})",
                )
                continue
            if not (imported & called_names(mod.tree)):
                yield self.finding(
                    rel,
                    0,
                    f"imports {sorted(imported)} but never calls it — {self.what}",
                )


@register
class SamplerGuardRule(_GuardedImportRule):
    id = "sampler-guard"
    title = "every sampler entry point routes through the chain-health guard"
    doc = (
        "Each sampler module (infer/run.py, infer/chees.py, infer/gibbs.py) "
        "must import from hhmm_tpu_torch.robust.guards and call a guard — a "
        "sampler refactored without it silently reintroduces NaN poisoning "
        "of batched lanes."
    )
    spec = SAMPLER_MODULES
    source_modules = (GUARDS_MODULE, "hhmm_tpu_torch.robust")
    kind = "sampler"
    noun = "chain-health guard"
    what = "transitions are unguarded"


@register
class ServeNormGuardRule(_GuardedImportRule):
    id = "serve-norm-guard"
    title = "the online filter step routes through safe_log_normalize"
    doc = (
        "serve/online.py must import and call safe_log_normalize from "
        "hhmm_tpu_torch.core.lmath — a streaming update normalized with a bare "
        "log_normalize turns impossible evidence into NaN state instead of "
        "the −inf floor the scheduler's quarantine mask detects."
    )
    spec = SERVE_MODULES
    source_modules = LMATH_MODULES
    kind = "serving"
    noun = "guarded normalization"
    what = "the online step is unguarded"


@register
class SemiringGuardRule(Rule):
    id = "semiring-guard"
    title = "semiring combines use the guarded logsumexp only"
    doc = (
        "Semiring identity elements are −inf by construction, so every "
        "combine hits the all-(−inf) reduction edge case; a raw logsumexp "
        "there has NaN cotangents. kernels/semiring.py and kernels/assoc.py "
        "must import+call safe_logsumexp and must not touch any raw "
        "logsumexp spelling (torch.logsumexp, torch.logaddexp)."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for rel in SEMIRING_MODULES:
            mod = project.module(rel)
            if mod is None:
                yield self.finding(rel, 0, "time-parallel kernel module missing")
                continue
            imported = imported_symbols(mod.tree, LMATH_MODULES)
            if "safe_logsumexp" not in imported:
                yield self.finding(
                    rel,
                    0,
                    f"does not import safe_logsumexp from {LMATH_MODULES[0]} "
                    "— semiring combines would be unguarded",
                )
            elif "safe_logsumexp" not in called_names(mod.tree):
                yield self.finding(
                    rel,
                    0,
                    "imports safe_logsumexp but never calls it — "
                    "semiring combines are unguarded",
                )
            for node in cached_walk(mod.tree):
                if isinstance(node, ast.Attribute) and node.attr in RAW_LSE_ATTRS:
                    yield self.finding(
                        rel,
                        node.lineno,
                        f"raw `.{node.attr}` — semiring combines must use the "
                        "guarded safe_logsumexp from hhmm_tpu_torch.core.lmath",
                    )
                if isinstance(node, ast.ImportFrom):
                    for alias in node.names:
                        if (
                            alias.name in RAW_LSE_ATTRS
                            and node.module not in LMATH_MODULES
                        ) or (
                            alias.name in RAW_LSE_WRAPPERS
                            and node.module in LMATH_MODULES
                        ):
                            yield self.finding(
                                rel,
                                node.lineno,
                                f"imports raw `{alias.name}` from {node.module} "
                                "— use safe_logsumexp from hhmm_tpu_torch.core.lmath",
                            )


@register
class MonotonicClockRule(Rule):
    id = "monotonic-clock"
    title = "no raw time.time() — monotonic clocks only"
    doc = (
        "Durations must come from time.perf_counter (directly or via "
        "hhmm_tpu_torch/obs/trace.py): a wall-clock step (NTP slew, suspend/ "
        "resume) under time.time() silently corrupts every throughput "
        "record, and the measured crossover table kernels/dispatch.py "
        "bets decode throughput on. Covers hhmm_tpu_torch/ and the root "
        "tools (lint_torch.py, obs_report_torch.py)."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            if not _clock_scope(mod.rel):
                continue
            yield from self._check(mod)

    def _check(self, mod: Module) -> Iterable[Finding]:
        aliases = set()
        for node in cached_walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "time":
                        aliases.add(alias.asname or alias.name)
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name == "time":
                        yield self.finding(
                            mod.rel,
                            node.lineno,
                            "imports raw `time.time` — use time.perf_counter "
                            "(or hhmm_tpu_torch.obs.trace)",
                        )
        if not aliases:
            return
        for node in cached_walk(mod.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "time"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in aliases
            ):
                yield self.finding(
                    mod.rel,
                    node.lineno,
                    f"raw `{node.func.value.id}.time()` timing read — "
                    "wall-clock steps corrupt throughput records; use "
                    "time.perf_counter (or hhmm_tpu_torch.obs.trace)",
                )


# the calls that load a shared library: ctypes.CDLL / PyDLL /
# cdll.LoadLibrary, torch.ops.load_library
_LOADERS = ("CDLL", "PyDLL", "LoadLibrary", "load_library")


def _library_loads(tree: ast.AST) -> List[Tuple[int, str]]:
    """(line, spelling) of every shared-library load call, through the
    attribute chain (``ctypes.CDLL``, ``ctypes.cdll.LoadLibrary``,
    ``torch.ops.load_library``) or a bare imported name
    (``from ctypes import CDLL``)."""
    bare = {}
    for node in cached_walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module in ("ctypes", "torch.ops"):
            for alias in node.names:
                if alias.name in _LOADERS:
                    bare[alias.asname or alias.name] = alias.name
    out: List[Tuple[int, str]] = []
    for node in cached_walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _LOADERS:
            chain = attr_chain(f)
            out.append((node.lineno, ".".join(chain) if chain else f.attr))
        elif isinstance(f, ast.Name) and f.id in bare:
            out.append((node.lineno, f.id))
    return out


@register
class KernelBuildRule(Rule):
    id = "kernel-build"
    title = "kernel libraries load only through kernels/cuda_build.py"
    doc = (
        "A shared library is loaded (ctypes.CDLL, ctypes.cdll.LoadLibrary, "
        "torch.ops.load_library) only in hhmm_tpu_torch/kernels/"
        "cuda_build.py, which must import its build/load hooks from "
        "hhmm_tpu_torch.obs.telemetry and call them — a kernel library "
        "loaded anywhere else is an nvcc build and a load the run "
        "manifest's compile stanza never sees (the port's counterpart of "
        "the JAX package's jit-telemetry). A library that is not a CUDA "
        "kernel (the native zig-zag extractor) carries an audited "
        "allowlist entry."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            if not _clock_scope(mod.rel) or mod.rel == BUILD_MODULE:
                continue
            for line, spelled in _library_loads(mod.tree):
                yield self.finding(
                    mod.rel,
                    line,
                    f"loads a shared library with `{spelled}(...)` outside "
                    f"{BUILD_MODULE} — kernel libraries are built and loaded "
                    "by kernels/cuda_build.py, which reports each build and "
                    "load to obs/telemetry.py (the manifest's compile stanza)",
                )
        mod = project.module(BUILD_MODULE)
        if mod is None:
            return
        direct = imported_symbols(mod.tree, TELEMETRY_MODULES) & set(BUILD_HOOKS)
        module_aliases = set()
        for node in cached_walk(mod.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "hhmm_tpu_torch.obs":
                for alias in node.names:
                    if alias.name == "telemetry":
                        module_aliases.add(alias.asname or alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "hhmm_tpu_torch.obs.telemetry" and alias.asname:
                        module_aliases.add(alias.asname)
        called = set(direct & called_names(mod.tree))
        for node in cached_walk(mod.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in BUILD_HOOKS
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in module_aliases
            ):
                called.add(node.func.attr)
        if not (direct or module_aliases):
            yield self.finding(
                BUILD_MODULE,
                0,
                "builds and loads the kernel libraries but never imports a "
                f"telemetry hook from {TELEMETRY_MODULES[0]} (expected "
                f"{BUILD_HOOKS}) — builds would be missing from run manifests",
            )
        elif set(BUILD_HOOKS) - called:
            yield self.finding(
                BUILD_MODULE,
                0,
                "imports telemetry but never calls "
                f"{sorted(set(BUILD_HOOKS) - called)} — some builds or loads "
                "are unreported",
            )


@register
class MetricsPlaneRule(Rule):
    id = "metrics-plane"
    title = "one shared metrics plane (hhmm_tpu_torch.obs.metrics)"
    doc = (
        "No private MetricsRegistry() outside obs/metrics.py (a second "
        "registry forks the sink: its counters never reach the exports, "
        "manifests, or obs_report_torch.py); bare counter/gauge/histogram calls "
        "must be bound from the metrics module; no module-level count-dict "
        "stores."
    )

    def _applies(self, rel: str) -> bool:
        return _in_package(rel) and rel != "hhmm_tpu_torch/obs/metrics.py"

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            if self._applies(mod.rel):
                yield from self._check(mod)

    def _check(self, mod: Module) -> Iterable[Finding]:
        tree = mod.tree
        imported = imported_symbols(tree, METRICS_MODULES)
        for node in cached_walk(tree):
            if isinstance(node, ast.Call):
                fn = node.func
                if (isinstance(fn, ast.Name) and fn.id == "MetricsRegistry") or (
                    isinstance(fn, ast.Attribute) and fn.attr == "MetricsRegistry"
                ):
                    yield self.finding(
                        mod.rel,
                        node.lineno,
                        "instantiates a private MetricsRegistry — a second "
                        "registry forks the metrics sink; use the shared "
                        "hhmm_tpu_torch.obs.metrics registry",
                    )
                elif (
                    isinstance(fn, ast.Name)
                    and fn.id in METRIC_FNS
                    and fn.id not in imported
                ):
                    yield self.finding(
                        mod.rel,
                        node.lineno,
                        f"calls bare `{fn.id}(...)` not imported from "
                        "hhmm_tpu_torch.obs.metrics — ad-hoc metric sinks never "
                        "reach the exports/manifests/obs_report",
                    )
        # module-level count-dict assignments only (function-local
        # working dicts are algorithm state, not a metrics sink)
        for node in mod.tree.body:
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
                value = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
                value = node.value
            else:
                continue
            is_dictish = isinstance(value, (ast.Dict, ast.DictComp)) or (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id in ("dict", "defaultdict")
            )
            if not is_dictish:
                continue
            for t in targets:
                if isinstance(t, ast.Name) and AD_HOC_COUNT_RE.search(t.id):
                    yield self.finding(
                        mod.rel,
                        node.lineno,
                        f"module-level count store `{t.id}` — route counts "
                        "through the shared hhmm_tpu_torch.obs.metrics registry",
                    )


@register
class PlacementRule(Rule):
    id = "placement"
    title = "placement objects confined to the planner"
    doc = (
        "No device-mesh or sharding construction (torch.distributed "
        "DeviceMesh / init_device_mesh / distribute_tensor) outside "
        "hhmm_tpu_torch/plan/ — a new callsite constructing placement "
        "objects directly re-fragments the decision the planner "
        "centralizes, and its layout is invisible to the manifest plan "
        "stanza."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            if not _clock_scope(mod.rel):
                continue
            rel = mod.rel
            if rel.startswith(PLACEMENT_ALLOWED_PREFIX):
                continue
            aliases = {}
            for node in cached_walk(mod.tree):
                if isinstance(node, ast.ImportFrom) and node.module in SHARDING_MODULES:
                    for alias in node.names:
                        if alias.name in SHARDING_CTORS:
                            aliases[alias.asname or alias.name] = alias.name
            for node in cached_walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                ctor = None
                if isinstance(fn, ast.Name) and fn.id in aliases:
                    ctor = aliases[fn.id]
                elif isinstance(fn, ast.Attribute) and fn.attr in SHARDING_CTORS:
                    ctor = fn.attr
                if ctor is not None:
                    yield self.finding(
                        rel,
                        node.lineno,
                        f"constructs `{ctor}` outside hhmm_tpu_torch/plan/ — "
                        "placement decisions belong to the execution planner "
                        "(take a Plan from hhmm_tpu_torch.plan)",
                    )


def _handler_catches_exception(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    names: List[str] = []
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    return "Exception" in names


@register
class ServeDegradeRule(Rule):
    id = "serve-degrade"
    title = "serve hot paths degrade, never raise"
    doc = (
        "In serve/scheduler.py the hot-path entry points (tick/flush/"
        "submit/attach*) contain no bare re-`raise` and keep every "
        "self._dispatch(...) call under a try/except-Exception degrade "
        "handler — one malformed observation or a device loss must shed, "
        "not take down every other series' flush."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        mod = project.module(SERVE_HOT_PATH_FILE)
        if mod is None:
            return
        for cls in [n for n in cached_walk(mod.tree) if isinstance(n, ast.ClassDef)]:
            for fn in [
                n
                for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and HOT_PATH_METHOD_RE.match(n.name)
            ]:
                guarded_spans: List[Tuple[int, int]] = []
                for node in ast.walk(fn):
                    if isinstance(node, ast.Raise) and node.exc is None:
                        yield self.finding(
                            mod.rel,
                            node.lineno,
                            f"bare `raise` in serve hot path `{fn.name}` — "
                            "per-series failures must degrade into shed "
                            "TickResponses, not propagate (the overload "
                            "ladder)",
                        )
                    if isinstance(node, ast.Try) and any(
                        _handler_catches_exception(h) for h in node.handlers
                    ):
                        lo = min(s.lineno for s in node.body)
                        hi = max(getattr(s, "end_lineno", s.lineno) for s in node.body)
                        guarded_spans.append((lo, hi))
                for node in ast.walk(fn):
                    if (
                        isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == HOT_PATH_DISPATCH_ATTR
                    ):
                        if not any(
                            lo <= node.lineno <= hi for lo, hi in guarded_spans
                        ):
                            yield self.finding(
                                mod.rel,
                                node.lineno,
                                f"`{HOT_PATH_DISPATCH_ATTR}` call in serve hot "
                                f"path `{fn.name}` outside a try/except-"
                                "Exception degrade handler — one malformed "
                                "observation or device loss would fail every "
                                "series in the flush",
                            )


@register
class TimingHarnessRule(Rule):
    id = "timing-harness"
    title = "raw timing loops confined to obs/profile.py"
    doc = (
        "No perf_counter-around-device-sync timing loop (a loop that "
        "calls torch.cuda.synchronize or an event's synchronize, between "
        "two clock reads outside it) outside "
        "the obs/profile.py harness: every such loop re-derives the "
        "warmup, fresh-input and order-statistic discipline by hand, so "
        "its numbers are incomparable with the kernel cost DB rows "
        "dispatch bets on. Per-iteration clock reads (attribution) are "
        "fine; the benchmark drivers and harnesses are exempt."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            if not _in_package(mod.rel) or mod.rel == TIMING_HARNESS_FILE:
                continue
            yield from self._check(mod)

    def _check(self, mod: Module) -> Iterable[Finding]:
        pc_names = perf_counter_names(mod.tree)
        # a timing loop needs two clock reads in one function: a module
        # with fewer has none (the per-function walk is the rule's cost)
        if sum(is_perf_counter_call(n, pc_names) for n in cached_walk(mod.tree)) < 2:
            return
        fns = [
            n
            for n in cached_walk(mod.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for fn in fns:
            own = own_scope_nodes(fn)
            pc_lines = [n.lineno for n in own if is_perf_counter_call(n, pc_names)]
            if len(pc_lines) < 2:
                continue
            for loop in own:
                if not isinstance(loop, (ast.For, ast.While)):
                    continue
                body_nodes = [
                    n for s in loop.body for n in [s, *own_scope_nodes(s)]
                ]
                if not any(is_device_sync_call(n) for n in body_nodes):
                    continue
                if any(is_perf_counter_call(n, pc_names) for n in body_nodes):
                    continue  # per-iteration clock read: attribution, fine
                end = getattr(loop, "end_lineno", loop.lineno)
                if any(l < loop.lineno for l in pc_lines) and any(
                    l > end for l in pc_lines
                ):
                    yield self.finding(
                        mod.rel,
                        loop.lineno,
                        "raw perf_counter-around-device-sync timing loop — "
                        "device timings must go through "
                        "hhmm_tpu_torch.obs.profile.device_time (the one "
                        "harness with the warmup split and order-statistic "
                        "discipline, on CUDA events)",
                    )


@register
class ServeClockRule(Rule):
    id = "serve-clock"
    title = "serve-layer clocks route through the request plane"
    doc = (
        "No raw perf_counter read anywhere under hhmm_tpu_torch/serve/ — "
        "neither the bare imported name nor the attribute spelling. A raw "
        "read there is a timing the request plane cannot see; route it "
        "through obs_request.now or a lifecycle recorder stage stamp "
        "(the request plane, obs/request.py)."
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.iter_modules():
            if not mod.rel.startswith(SERVE_DIR_PREFIX):
                continue
            pc_names = perf_counter_names(mod.tree)
            for node in cached_walk(mod.tree):
                if is_perf_counter_call(node, pc_names):
                    yield self.finding(
                        mod.rel,
                        node.lineno,
                        "raw `perf_counter` read in the serve layer — "
                        "per-tick timing must route through the "
                        "request-plane lifecycle recorder (hhmm_tpu_torch.obs."
                        "request `now`/stage stamps)",
                    )
