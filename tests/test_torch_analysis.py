"""The port's static analyzer (``hhmm_tpu_torch.analysis``) against the
JAX package's (``hhmm_tpu.analysis``):

- parity: the framework-independent rules (the guard invariants, the
  clocks, layering, the lock rules, atomic writes) give the same
  ``(rule, line)`` findings through both engines on the fixture sources
  of ``tests/test_analysis.py``, written under ``hhmm_tpu/`` for the JAX
  engine and ``hhmm_tpu_torch/`` for the port's;
- the torch rules (``torch-generator``, ``generator-dead``,
  ``cuda-import``, ``kernel-build``, the torch spellings of
  ``held-lock-escape``, ``hot-path-purity`` and the dtype rules) fire on
  their bad fixture and stay silent on their good one;
- pragmas, the allowlist and the CLI (exit codes 0/1/2, ``--format
  json``, ``--list-rules``, the ratchet);
- the port's full default scan is clean, acyclic and under 10 s, and
  each repair this scan asked for is held by a fixture of the repaired
  site;
- the analyzer imports only the stdlib.

Pure ``ast`` work over tmp_path toy trees plus a few subprocess runs of
the CLI.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from hhmm_tpu.analysis import run_analysis as jax_run_analysis
from hhmm_tpu_torch.analysis import (
    DEFAULT_TARGETS,
    RULES,
    AllowlistError,
    load_allowlist,
    run_analysis,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "hhmm_tpu_torch"


def _tree(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return root


def _run(tmp_path, files, rules, paths=(PKG,)):
    _tree(tmp_path, files)
    return run_analysis(root=tmp_path, paths=list(paths), rules=list(rules))


def _fires(report, rule_id):
    return [f for f in report.findings if f.rule_id == rule_id]


def _ids(report):
    return [(f.file, f.line, f.rule_id) for f in report.findings]


# ---------------------------------------------------------------------------
# parity with the JAX engine on the framework-independent fixtures
#
# Each case: ({relpath with "{pkg}": source with "{pkg}"}, rules). The
# sources are those of tests/test_analysis.py; "{pkg}" is hhmm_tpu for
# the JAX engine and hhmm_tpu_torch for the port's.

_LOCK_CYCLE = (
    "import threading\n"
    "\n"
    "LOCK_A = threading.Lock()\n"
    "LOCK_B = threading.Lock()\n"
    "\n"
    "def ab():\n"
    "    with LOCK_A:\n"
    "        with LOCK_B:\n"
    "            pass\n"
    "\n"
    "def ba():\n"
    "    with LOCK_B:\n"
    "        with LOCK_A:\n"
    "            pass\n"
)

_LOCK_ORDERED = _LOCK_CYCLE.replace(
    "def ba():\n    with LOCK_B:\n        with LOCK_A:",
    "def ab_again():\n    with LOCK_A:\n        with LOCK_B:",
)

_CLASS_LOCK = (
    "import threading\n"
    "\n"
    "class C:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.{kind}()\n"
    "    def inner(self):\n"
    "        with self._lock:\n"
    "            pass\n"
    "    def outer(self):\n"
    "        with self._lock:\n"
    "            self.inner()\n"
)

_RACE = (
    "import threading\n"
    "\n"
    "class C:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._items = []\n"
    "    def good(self, x):\n"
    "        with self._lock:\n"
    "            self._items.append(x)\n"
    "    def bad(self, x):\n"
    "        self._items.append(x)\n"
)

_HELPER = (
    "import threading\n"
    "\n"
    "class C:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._items = []\n"
    "    def put(self, x):\n"
    "        with self._lock:\n"
    "            self._append(x)\n"
    "    def {second}(self, x):\n"
    "{second_body}"
    "    def _append(self, x):\n"
    "        self._items.append(x)\n"
)

_ESCAPE_BAD = (
    "import threading\n"
    "import time\n"
    "\n"
    "_LOCK = threading.Lock()\n"
    "\n"
    "def bad(x, on_done):\n"
    "    with _LOCK:\n"
    "        open('/tmp/x.txt')\n"
    "        time.sleep(0.1)\n"
    "        on_done()\n"
    "    return x\n"
)

_ESCAPE_GOOD = (
    "import threading\n"
    "import time\n"
    "\n"
    "_LOCK = threading.Lock()\n"
    "\n"
    "def good(x, on_done):\n"
    "    with _LOCK:\n"
    "        z = [x]\n"
    "    time.sleep(0.1)\n"
    "    on_done()\n"
    "    return z\n"
)

PARITY = {
    "bare_except": (
        {"{pkg}/bad.py": "try:\n    pass\nexcept:\n    pass\n"},
        ["bare-except"],
    ),
    "monotonic_clock": (
        {"{pkg}/apps/x.py": "import time\nfrom time import time as now\n\ndef f():\n    return time.time() + now()\n"},
        ["monotonic-clock"],
    ),
    "metrics_plane": (
        {
            "{pkg}/serve/x.py": (
                "from {pkg}.obs.metrics import MetricsRegistry\n\n"
                "SHED_COUNTS = {}\n\n"
                "def f():\n"
                "    reg = MetricsRegistry()\n"
                "    counter('x').inc()\n"
                "    return reg\n"
            )
        },
        ["metrics-plane"],
    ),
    "serve_degrade": (
        {
            "{pkg}/serve/scheduler.py": (
                "class S:\n"
                "    def tick(self, x):\n"
                "        try:\n"
                "            self._dispatch(x)\n"
                "        except Exception:\n"
                "            raise\n"
                "    def flush(self, x):\n"
                "        return self._dispatch(x)\n"
            )
        },
        ["serve-degrade"],
    ),
    "serve_clock": (
        {"{pkg}/serve/x.py": "import time\nfrom time import perf_counter as pc\n\ndef f():\n    return pc() - time.perf_counter()\n"},
        ["serve-clock"],
    ),
    "raw_clock_bad": (
        {"{pkg}/apps/toy.py": "from time import perf_counter\n\ndef drive():\n    t0 = perf_counter()\n    return perf_counter() - t0\n"},
        ["raw-clock"],
    ),
    "raw_clock_scope": (
        {
            "{pkg}/obs/toy.py": "from time import perf_counter\n\nT0 = perf_counter()\n",
            "{pkg}/serve/toy.py": "from time import perf_counter\n\nT0 = perf_counter()\n",
        },
        ["raw-clock"],
    ),
    "raw_clock_pragma": (
        {"{pkg}/apps/x.py": "import time as _t\n\ndef f():\n    # lint: ok raw-clock -- toy\n    return _t.perf_counter()\n\ndef g():\n    return _t.perf_counter()  # lint: ok bare-except -- wrong id\n"},
        ["raw-clock"],
    ),
    "semiring_guard": (
        {
            "{pkg}/kernels/semiring.py": (
                "import torch\nfrom {pkg}.core.lmath import safe_logsumexp\n\n"
                "def f(a):\n    return torch.logsumexp(a, 0) + safe_logsumexp(a)\n"
            ),
            "{pkg}/kernels/assoc.py": "from {pkg}.core.lmath import logsumexp\n",
        },
        ["semiring-guard"],
    ),
    "guards_missing": (
        {"{pkg}/infer/run.py": "def sample_nuts():\n    pass\n", "{pkg}/serve/online.py": "X = 1\n"},
        ["sampler-guard", "serve-norm-guard"],
    ),
    "layer_back_edge": (
        {"{pkg}/core/toy.py": "from {pkg}.serve.online import StreamState\n\nX = 1\n"},
        ["layer-import"],
    ),
    "layer_lazy_and_pragma": (
        {
            "{pkg}/kernels/toy.py": (
                "def f():\n"
                "    from {pkg}.apps.tayal import wf\n"
                "    return wf\n"
                "def g():\n"
                "    from {pkg}.apps.tayal import wf  # lint: ok layer-import -- toy cycle breaker\n"
                "    return wf\n"
            )
        },
        ["layer-import"],
    ),
    "layer_siblings_and_downward": (
        {
            "{pkg}/models/toy.py": "from {pkg}.batch import fit_batched\n",
            "{pkg}/serve/toy.py": (
                "import {pkg}\n"
                "from {pkg}.core.lmath import safe_logsumexp\n"
                "from {pkg}.kernels import dispatch\n"
                "from {pkg}.obs.trace import span\n"
                "from {pkg}.pipeline import InFlightTable\n"
            ),
            "{pkg}/pipeline/toy.py": "from {pkg}.serve.scheduler import MicroBatchScheduler\n",
            "{pkg}/apps/toy.py": "from {pkg}.mystery import thing\n",
        },
        ["layer-import"],
    ),
    "layer_maint_adapt": (
        {
            "{pkg}/maint/toy.py": "from {pkg}.serve import SnapshotRegistry\nfrom {pkg}.adapt import AdaptationLadder\nfrom {pkg}.apps.tayal import wf\n",
            "{pkg}/adapt/toy.py": "from {pkg}.maint import MaintenanceLoop\nfrom {pkg}.serve.metrics import AdaptMetrics\n",
            "{pkg}/serve/toy2.py": "from {pkg}.adapt import AdaptationLadder\nfrom {pkg}.maint import promote_snapshot\n",
        },
        ["layer-import"],
    ),
    "layer_relative": (
        {"{pkg}/core/toy.py": "from ..serve import online\n", "{pkg}/serve/toy.py": "from .. import apps\n"},
        ["layer-import"],
    ),
    "lock_cycle": ({"{pkg}/serve/toy.py": _LOCK_CYCLE}, ["lock-order"]),
    "lock_ordered": ({"{pkg}/serve/toy.py": _LOCK_ORDERED}, ["lock-order"]),
    "lock_self_deadlock": ({"{pkg}/serve/toy.py": _CLASS_LOCK.format(kind="Lock")}, ["lock-order"]),
    "lock_rlock": ({"{pkg}/serve/toy.py": _CLASS_LOCK.format(kind="RLock")}, ["lock-order"]),
    "lock_cross_module": (
        {
            "{pkg}/obs/toymetrics.py": "import threading\n\n_LOCK = threading.Lock()\n\ndef publish():\n    with _LOCK:\n        pass\n",
            "{pkg}/serve/toy.py": (
                "import threading\nfrom {pkg}.obs import toymetrics\n\n_TOP = threading.Lock()\n\n"
                "def flush():\n    with _TOP:\n        toymetrics.publish()\n\n"
                "def back():\n    with toymetrics._LOCK:\n        pass\n"
            ),
        },
        ["lock-order"],
    ),
    "race_bad": ({"{pkg}/serve/toy.py": _RACE}, ["shared-state-race"]),
    "race_dominated_helper": (
        {"{pkg}/serve/toy.py": _HELPER.format(second="put2", second_body="        with self._lock:\n            self._append(x)\n")},
        ["shared-state-race"],
    ),
    "race_unlocked_helper": (
        {"{pkg}/serve/toy.py": _HELPER.format(second="sneak", second_body="        self._append(x)\n")},
        ["shared-state-race"],
    ),
    "race_module_container": (
        {
            "{pkg}/serve/toy.py": "CACHE = {}\n\ndef put(k, v):\n    CACHE[k] = v\n",
            "{pkg}/serve/toy2.py": "import threading\n\nCACHE = {}\n_LOCK = threading.Lock()\n\ndef put(k, v):\n    with _LOCK:\n        CACHE[k] = v\n",
            "{pkg}/serve/toy3.py": "import threading\n\n_TLS = threading.local()\n\ndef put(v):\n    _TLS.stack = [v]\n",
        },
        ["shared-state-race"],
    ),
    "escape_bad": ({"{pkg}/serve/toy.py": _ESCAPE_BAD}, ["held-lock-escape"]),
    "escape_good": ({"{pkg}/serve/toy.py": _ESCAPE_GOOD}, ["held-lock-escape"]),
    "escape_interprocedural": (
        {"{pkg}/serve/toy.py": "import threading\n\n_LOCK = threading.Lock()\n\ndef write_out(p):\n    open(p)\n\ndef bad(p):\n    with _LOCK:\n        write_out(p)\n"},
        ["held-lock-escape"],
    ),
    "atomic_write": (
        {
            "{pkg}/serve/toy.py": "def dump(p, q, text):\n    with open(p, 'w') as f:\n        f.write(text)\n    q.write_text(text)\n    with open(p, 'wb') as f:\n        f.write(b'x')\n",
            "{pkg}/obs/trace.py": "def atomic(p, text):\n    with open(p, 'w') as f:\n        f.write(text)\n",
        },
        ["atomic-write"],
    ),
    "syntax_error": ({"{pkg}/apps/bad.py": "def broken(:\n"}, ["raw-clock"]),
}


def _materialize(files, pkg):
    return {rel.replace("{pkg}", pkg): src.replace("{pkg}", pkg) for rel, src in files.items()}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_framework_independent_rules_match_the_jax_engine(case, tmp_path):
    files, rules = PARITY[case]
    jax_root = _tree(tmp_path / "jax", _materialize(files, "hhmm_tpu"))
    port_root = _tree(tmp_path / "port", _materialize(files, PKG))
    jrep = jax_run_analysis(root=jax_root, paths=["hhmm_tpu"], rules=rules)
    prep = run_analysis(root=port_root, paths=[PKG], rules=rules)

    def key(rep, pkg):
        return sorted((f.file.replace(pkg, "{pkg}", 1), f.line, f.rule_id) for f in rep.findings)

    assert key(prep, PKG) == key(jrep, "hhmm_tpu")
    assert len(prep.suppressed) == len(jrep.suppressed)
    assert prep.ok == jrep.ok
    if "lock_order" in jrep.extras:
        jd, pd = jrep.extras["lock_order"], prep.extras["lock_order"]
        assert pd["verdict"] == jd["verdict"]
        assert len(pd["edges"]) == len(jd["edges"])


def test_parity_cases_fire_somewhere():
    """The parity table is not vacuous: most cases have findings."""
    firing = 0
    for case, (files, rules) in PARITY.items():
        import tempfile
        import pathlib

        with tempfile.TemporaryDirectory() as d:
            rep = run_analysis(root=_tree(pathlib.Path(d), _materialize(files, PKG)),
                               paths=[PKG], rules=rules)
            firing += bool(rep.findings)
    assert firing >= len(PARITY) - 6


def test_allowlist_parity(tmp_path):
    files = {
        "{pkg}/apps/x.py": "import time as _t\n\ndef f():\n    return _t.perf_counter()\ndef g():\n    return _t.perf_counter()\n",
        "{pkg}/analysis/allowlist.txt": "raw-clock {pkg}/apps/x.py:4 -- line-pinned toy entry\nraw-clock {pkg}/apps/never.py -- stale\n",
    }
    jrep = jax_run_analysis(root=_tree(tmp_path / "j", _materialize(files, "hhmm_tpu")),
                            paths=["hhmm_tpu"], rules=["raw-clock"])
    prep = run_analysis(root=_tree(tmp_path / "p", _materialize(files, PKG)),
                        paths=[PKG], rules=["raw-clock"])
    assert [(f.line) for f in prep.findings] == [f.line for f in jrep.findings] == [6]
    assert prep.to_json()["allowlist_unused"] == [f"raw-clock {PKG}/apps/never.py"]


# ---------------------------------------------------------------------------
# the torch rules: each fires on its bad fixture, silent on its good one

_GEN_BAD = """\
import torch
from torch import randn


def draw(x, g):
    a = torch.rand(3)
    b = randn(2)
    x.uniform_()
    c = torch.multinomial(x, 1)
    d = torch.rand_like(x)
    torch.manual_seed(0)
    torch.cuda.manual_seed_all(1)
    torch.set_rng_state(g.get_state())
    return a, b, c, d
"""

_GEN_GOOD = """\
import torch


def draw(x, g, **kw):
    a = torch.rand(3, generator=g)
    b = torch.randn(
        2,
        dtype=x.dtype,
        generator=g,
    )
    x.uniform_(generator=g)
    c = torch.multinomial(x, 1, generator=g)
    d = torch.rand(x.shape, generator=g, device=x.device)
    e = torch.bernoulli(x, **kw)
    g.manual_seed(3)
    gen = torch.Generator(device="cpu").manual_seed(5)
    return a, b, c, d, e, torch.randint(0, 4, (2,), generator=gen)
"""


def test_torch_generator_bad_fires_each_spelling(tmp_path):
    rep = _run(tmp_path, {f"{PKG}/infer/toy.py": _GEN_BAD}, ["torch-generator"])
    assert sorted(f.line for f in _fires(rep, "torch-generator")) == [6, 7, 8, 9, 10, 11, 12, 13]
    msgs = " | ".join(f.message for f in rep.findings)
    for needle in ("torch.rand(", "randn(", ".uniform_(", "rand_like", "reseeds the global stream",
                   "global CUDA streams", "overwrites"):
        assert needle in msgs, needle


def test_torch_generator_good_silent(tmp_path):
    rep = _run(tmp_path, {f"{PKG}/infer/toy.py": _GEN_GOOD}, ["torch-generator"])
    assert not rep.findings, _ids(rep)


def test_torch_generator_scope_is_the_package(tmp_path):
    rep = _run(tmp_path, {"tools/toy.py": _GEN_BAD}, ["torch-generator"], paths=("tools",))
    assert not rep.findings


def test_generator_dead(tmp_path):
    src = (
        "import torch\n\n"
        "def f(x):\n"
        "    g = torch.Generator().manual_seed(1)\n"
        "    h = torch.Generator()\n"
        "    _spare = torch.Generator()\n"
        "    k = torch.Generator()\n"
        "    inner = lambda: torch.rand(2, generator=k)\n"
        "    return torch.rand(2, generator=h), inner\n"
    )
    rep = _run(tmp_path, {f"{PKG}/sim/toy.py": src}, ["generator-dead"])
    hits = _fires(rep, "generator-dead")
    assert [(h.line, h.severity) for h in hits] == [(4, "warning")] and "`g`" in hits[0].message
    assert rep.ok  # a warning does not fail the scan


_CUDA_BAD = """\
import triton
import hhmm_tpu_torch.kernels.cuda_semiring
from torch.utils.cpp_extension import load_inline
from torch.utils import cpp_extension
from hhmm_tpu_torch.kernels import cuda_traj
from hhmm_tpu_torch.kernels.cuda_build import build


def f():
    from ..kernels.cuda_semiring import fwd_lanes
    return fwd_lanes
"""

_CUDA_GOOD = """\
from hhmm_tpu_torch.kernels import ffbs_dispatch, forward_value_and_grad
from hhmm_tpu_torch.kernels.dispatch import forward_filter_dispatch
from hhmm_tpu_torch.kernels import viterbi
import torch.utils.data
"""


def test_cuda_import_bad_fires_each_spelling(tmp_path):
    rep = _run(tmp_path, {f"{PKG}/infer/toy.py": _CUDA_BAD}, ["cuda-import"])
    assert sorted(f.line for f in _fires(rep, "cuda-import")) == [1, 2, 3, 4, 5, 6, 10]
    assert all(f.severity == "error" for f in rep.findings)


def test_cuda_import_good_and_in_kernels_silent(tmp_path):
    rep = _run(tmp_path, {f"{PKG}/infer/toy.py": _CUDA_GOOD,
                          f"{PKG}/kernels/toy.py": _CUDA_BAD.replace("..kernels.", ".")},
               ["cuda-import"])
    assert not rep.findings, _ids(rep)


def test_cuda_import_root_tools_in_scope(tmp_path):
    rep = _run(tmp_path, {"lint_torch.py": "import triton\n"}, ["cuda-import"], paths=("lint_torch.py",))
    assert len(_fires(rep, "cuda-import")) == 1


_BUILD_GOOD = """\
import ctypes
import time

from hhmm_tpu_torch.obs import telemetry


def build(src):
    telemetry.note_build(src, 1.0)


def load(path):
    t0 = time.perf_counter()
    lib = ctypes.CDLL(path)
    telemetry.note_load(path, time.perf_counter() - t0)
    return lib
"""


def test_kernel_build_loads_outside_cuda_build_fire(tmp_path):
    src = (
        "import ctypes\nimport torch\nfrom ctypes import CDLL as Dll\n\n"
        "def f(p):\n"
        "    a = ctypes.CDLL(p)\n"
        "    b = ctypes.cdll.LoadLibrary(p)\n"
        "    torch.ops.load_library(p)\n"
        "    return a, b, Dll(p)\n"
    )
    rep = _run(tmp_path, {f"{PKG}/kernels/cuda_build.py": _BUILD_GOOD,
                          f"{PKG}/serve/toy.py": src}, ["kernel-build"])
    assert [(f.file, f.line) for f in rep.findings] == [(f"{PKG}/serve/toy.py", n) for n in (6, 7, 8, 9)]


def test_kernel_build_hooks_required(tmp_path):
    rep = _run(tmp_path, {f"{PKG}/kernels/cuda_build.py": _BUILD_GOOD}, ["kernel-build"])
    assert not rep.findings
    unhooked = _BUILD_GOOD.replace("    telemetry.note_load(path, time.perf_counter() - t0)\n", "")
    rep = _run(tmp_path / "u", {f"{PKG}/kernels/cuda_build.py": unhooked}, ["kernel-build"])
    assert [(f.line, "note_load" in f.message) for f in rep.findings] == [(0, True)]
    bare = "import ctypes\n\ndef load(p):\n    return ctypes.CDLL(p)\n"
    rep = _run(tmp_path / "b", {f"{PKG}/kernels/cuda_build.py": bare}, ["kernel-build"])
    assert [f.line for f in rep.findings] == [0]


_ESCAPE_TORCH_BAD = """\
import threading
import torch

_LOCK = threading.Lock()


def bad(x, ev):
    with _LOCK:
        a = x.item()
        b = x.tolist()
        c = x.cpu()
        d = x.numpy()
        torch.cuda.synchronize()
        ev.synchronize()
        ev.wait()
    return a, b, c, d
"""

_ESCAPE_TORCH_GOOD = """\
import threading
import torch

_LOCK = threading.Lock()


def good(x, ev):
    a = x.item()
    b = x.cpu()
    torch.cuda.synchronize()
    ev.synchronize()
    with _LOCK:
        y = torch.exp(x)
        z = [a, b, y, x.to(x.device)]
    return z
"""


def test_held_lock_escape_torch_syncs(tmp_path):
    rep = _run(tmp_path, {f"{PKG}/serve/toy.py": _ESCAPE_TORCH_BAD}, ["held-lock-escape"])
    assert sorted(f.line for f in rep.findings) == list(range(9, 16))
    msgs = "\n".join(f.message for f in rep.findings)
    for needle in (".item()", ".tolist()", ".cpu()", ".numpy()", ".synchronize()", ".wait()",
                   "acquired at line 8"):
        assert needle in msgs, needle
    rep = _run(tmp_path / "g", {f"{PKG}/serve/toy.py": _ESCAPE_TORCH_GOOD}, ["held-lock-escape"])
    assert not rep.findings, _ids(rep)


_PURITY_BAD = """\
import time

import numpy as np
import torch


def helper(x):
    print("tick")
    return np.asarray(x)


class F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = float(x.sum())
        n = x.item()
        ctx.save_for_backward(x)
        return x * s * n + helper(x).sum()

    @staticmethod
    def backward(ctx, g):
        torch.cuda.synchronize()
        t = time.perf_counter()
        return g.cpu() * t
"""

_PURITY_GOOD = """\
import numpy as np
import torch
from torch.autograd import Function


def host_driver(x):
    # not reachable from a device root: may sync freely
    print(float(x.sum()), x.item())
    return np.asarray(x)


class F(Function):
    @staticmethod
    def forward(ctx, x):
        n = int(x.shape[0])
        k = float(len(x))
        ctx.save_for_backward(x)
        return x * n * k + torch.zeros(1, dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * x.to(np.float32 and x.dtype)
"""


def test_hot_path_purity_autograd_roots(tmp_path):
    rep = _run(tmp_path, {f"{PKG}/models/toy.py": _PURITY_BAD}, ["hot-path-purity"])
    msgs = " | ".join(f.message for f in _fires(rep, "hot-path-purity"))
    for needle in ("print", "np.asarray", "`float(...)` cast", ".item()", ".synchronize()",
                   "perf_counter", ".cpu()", "inside `helper`", "inside `backward`"):
        assert needle in msgs, f"missing {needle!r} in: {msgs}"
    rep = _run(tmp_path / "g", {f"{PKG}/models/toy.py": _PURITY_GOOD}, ["hot-path-purity"])
    assert not rep.findings, _ids(rep)


def test_hot_path_purity_launch_wrappers(tmp_path):
    src = (
        "import torch\n\n"
        "def _plain(x):\n"
        "    return x.tolist()\n\n"
        "def fwd_lanes(x):\n"
        "    if x.device.type == 'cpu':\n"
        "        return _plain(x)\n"
        "    FWD.launch(int(x.numel()))\n"
        "    return x\n\n"
        "def host_only(x):\n"
        "    return x.tolist()\n"
    )
    for rel in (f"{PKG}/kernels/cuda_semiring.py", f"{PKG}/kernels/cuda_traj.py"):
        rep = _run(tmp_path / rel.replace("/", "_"), {rel: src}, ["hot-path-purity"])
        assert sorted(f.line for f in rep.findings) == [4, 9], _ids(rep)
    # the same source elsewhere has no launch roots
    rep = _run(tmp_path / "other", {f"{PKG}/kernels/other.py": src}, ["hot-path-purity"])
    assert not rep.findings


def test_dtype_rules_torch_spellings(tmp_path):
    bad = (
        "import numpy as np\nimport torch\nfrom torch import zeros\n\n"
        "def f(x, n):\n"
        "    a = x.to(torch.float64)\n"
        "    b = x.double()\n"
        "    c = torch.empty(3, dtype=torch.double)\n"
        "    d = np.float64(1.0)\n"
        "    e = torch.ones(3, dtype='float64')\n"
        "    return a, b, c, d, e\n\n"
        "def g(x, n):\n"
        "    return (torch.zeros(3), torch.ones(2), torch.empty(n), torch.full((2,), 1.0),\n"
        "            torch.tensor([1.0]), torch.arange(\n"
        "                n,\n"
        "            ), zeros(1))\n"
    )
    rep = _run(tmp_path, {f"{PKG}/kernels/toy.py": bad}, ["dtype-float64", "dtype-implicit"])
    assert sorted(f.line for f in _fires(rep, "dtype-float64")) == [6, 7, 8, 9, 10]
    assert sorted(f.line for f in _fires(rep, "dtype-implicit")) == [14, 14, 14, 14, 15, 15, 17]
    good = (
        "import torch\n\n"
        "def g(x, n, **kw):\n"
        "    return (torch.zeros(3, dtype=x.dtype), torch.arange(n, dtype=torch.long),\n"
        "            torch.full((2,), 1.0, dtype=torch.float32, device=x.device),\n"
        "            torch.tensor([1], **kw), torch.zeros_like(x), x.to(x.dtype))\n"
    )
    rep = _run(tmp_path / "g", {f"{PKG}/core/toy.py": good}, ["dtype-float64", "dtype-implicit"])
    assert not rep.findings, _ids(rep)
    rep = _run(tmp_path / "o", {f"{PKG}/models/toy.py": bad}, ["dtype-float64", "dtype-implicit"])
    assert not rep.findings  # host-side boundary code is out of scope


def test_placement_torch_spellings(tmp_path):
    src = (
        "import torch.distributed as dist\n"
        "from torch.distributed.device_mesh import init_device_mesh as mesh\n"
        "from torch.distributed.tensor import distribute_tensor\n\n"
        "def f(t):\n"
        "    m = mesh('cuda', (2,))\n"
        "    d = dist.device_mesh.DeviceMesh('cuda', [0, 1])\n"
        "    return distribute_tensor(t, m), d\n"
    )
    rep = _run(tmp_path, {f"{PKG}/serve/x.py": src, f"{PKG}/plan/x.py": src}, ["placement"])
    assert [(f.file, f.line) for f in rep.findings] == [(f"{PKG}/serve/x.py", n) for n in (6, 7, 8)]


def test_timing_harness_torch_spellings(tmp_path):
    bad = (
        "import time\nimport torch\n\n"
        "def bench(f, x, n, ev):\n"
        "    t0 = time.perf_counter()\n"
        "    for _ in range(n):\n"
        "        f(x)\n"
        "        torch.cuda.synchronize()\n"
        "    while n:\n"
        "        n -= 1\n"
        "        ev.synchronize()\n"
        "    return time.perf_counter() - t0\n"
    )
    good = (
        "import time\nimport torch\n\n"
        "def attribute(f, x, n):\n"
        "    t0 = time.perf_counter()\n"
        "    for _ in range(n):\n"
        "        f(x)\n"
        "        torch.cuda.synchronize()\n"
        "        t1 = time.perf_counter()\n"
        "    return t1 - t0\n"
    )
    rep = _run(tmp_path, {f"{PKG}/kernels/x.py": bad, f"{PKG}/obs/profile.py": bad,
                          f"{PKG}/kernels/y.py": good}, ["timing-harness"])
    assert [(f.file, f.line) for f in rep.findings] == [(f"{PKG}/kernels/x.py", 6),
                                                         (f"{PKG}/kernels/x.py", 9)]


def test_torch_rule_families():
    fam = {rid: r.family for rid, r in RULES.items()}
    assert fam["torch-generator"] == fam["generator-dead"] == "prng"
    assert fam["cuda-import"] == fam["layer-import"] == "layering"
    assert fam["kernel-build"] == "legacy"
    assert RULES["generator-dead"].severity == "warning"
    assert "jit-telemetry" not in RULES and "pallas-import" not in RULES
    assert "prng-key-reuse" not in RULES


# ---------------------------------------------------------------------------
# engine mechanics


def test_pragma_statement_anchor(tmp_path):
    src = (
        "import numpy as np\n"
        "def f(x):\n"
        "    return np.asarray(  # lint: ok dtype-float64 -- multi-line anchor test\n"
        "        x,\n"
        "        np.float64,\n"
        "    )\n"
        "def g(x):  # lint: ok dtype-float64 -- must not blanket the body\n"
        "    y = 1\n"
        "    return np.asarray(x, np.float64)\n"
    )
    rep = _run(tmp_path, {f"{PKG}/kernels/toy.py": src}, ["dtype-float64"])
    assert [f.line for f in rep.suppressed] == [5]
    assert [f.line for f in rep.findings] == [9]


def test_allowlist_requires_rationale(tmp_path):
    p = tmp_path / "allow.txt"
    for bad in ("raw-clock x.py\n", "raw-clock x.py --   \n", "raw-clock x.py:seven -- why\n"):
        p.write_text(bad)
        with pytest.raises(AllowlistError):
            load_allowlist(p)
    p.write_text("# comment\n\nraw-clock a.py:7 -- why\n")
    assert [(e.rule_id, e.file, e.line) for e in load_allowlist(p)] == [("raw-clock", "a.py", 7)]


def test_repo_allowlist_entries_each_have_a_rationale_and_are_used():
    import pathlib

    entries = load_allowlist(pathlib.Path(REPO, PKG, "analysis", "allowlist.txt"))
    assert entries and all(len(e.rationale) > 20 for e in entries)
    rep = run_analysis(root=REPO)
    assert rep.to_json()["allowlist_unused"] == []


def test_unknown_rule_raises(tmp_path):
    with pytest.raises(KeyError):
        run_analysis(root=tmp_path, paths=[], rules=["no-such-rule"])


def _cli(*args, cwd=REPO):
    return subprocess.run([sys.executable, "-m", f"{PKG}.analysis", *args],
                          capture_output=True, text=True, cwd=cwd, timeout=120)


def test_cli_json_default_scan_exits_zero():
    proc = _cli("--format", "json")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr
    js = json.loads(proc.stdout)
    assert js["ok"] is True and js["findings"] == []
    assert js["files_scanned"] > 100
    assert set(js["rules"]) == set(RULES)
    assert js["extras"]["lock_order"]["verdict"] == "ACYCLIC"


def test_cli_list_rules_and_bad_allowlist(tmp_path):
    proc = _cli("--list-rules")
    assert proc.returncode == 0 and all(rid in proc.stdout for rid in RULES)
    bad = tmp_path / "allow.txt"
    bad.write_text("raw-clock some/file.py\n")
    proc = _cli("--allowlist", str(bad), f"{PKG}/analysis")
    assert proc.returncode == 2 and "rationale" in proc.stderr
    proc = _cli("--rules", "no-such-rule")
    assert proc.returncode == 2


def test_cli_findings_exit_one_and_ratchet(tmp_path):
    (tmp_path / PKG / "infer").mkdir(parents=True)
    toy = tmp_path / PKG / "infer" / "toy.py"
    toy.write_text("import torch\n\ndef f():\n    g = torch.Generator()\n    return torch.rand(2)\n")
    base = tmp_path / "baseline.json"
    proc = _cli("--root", str(tmp_path), PKG)
    assert proc.returncode == 1 and "[torch-generator]" in proc.stdout
    proc = _cli("--root", str(tmp_path), "--rules", "generator-dead", PKG)
    assert proc.returncode == 0  # warnings alone do not fail
    proc = _cli("--root", str(tmp_path), "--rules", "generator-dead", PKG, "--baseline", str(base))
    assert proc.returncode == 1 and f"generator-dead {PKG}/infer/toy.py: 0 -> 1" in proc.stdout
    proc = _cli("--root", str(tmp_path), "--rules", "generator-dead", PKG, "--baseline", str(base),
                "--update-baseline")
    assert proc.returncode == 0
    assert json.loads(base.read_text())["counts"] == {f"generator-dead {PKG}/infer/toy.py": 1}
    proc = _cli("--root", str(tmp_path), "--rules", "generator-dead", PKG, "--baseline", str(base))
    assert proc.returncode == 0 and "match the baseline" in proc.stdout
    base.write_text("{not json")
    proc = _cli("--root", str(tmp_path), PKG, "--baseline", str(base))
    assert proc.returncode == 2


# ---------------------------------------------------------------------------
# the port's own scan


def test_default_targets():
    assert DEFAULT_TARGETS == (PKG, "lint_torch.py", "obs_report_torch.py")


def test_full_default_scan_clean_acyclic_and_under_ten_seconds():
    t0 = time.perf_counter()
    rep = run_analysis(root=REPO)
    dt = time.perf_counter() - t0
    assert rep.findings == [], "\n".join(f.format() for f in rep.findings)
    assert rep.files_scanned > 100 and set(rep.rules_run) == set(RULES)
    dag = rep.extras["lock_order"]
    assert dag["verdict"] == "ACYCLIC" and not dag["cycles"]
    assert f"{PKG}/serve/pager.py::SnapshotPager._lock" in dag["locks"]
    assert dt < 10.0, f"full scan took {dt:.1f}s (tier-1 budget is <10s)"


def test_every_suppression_carries_a_reason():
    """Each inline pragma in the port names its rule and a ``-- why``."""
    import re

    pragma = re.compile(r"#\s*lint:\s*ok\s+(?P<ids>[A-Za-z0-9_,\s-]+?)\s*(?:--(?P<why>.*))?$")
    seen = 0
    for dirpath, _, names in os.walk(os.path.join(REPO, PKG)):
        if "analysis" in dirpath.split(os.sep):
            continue
        for name in names:
            if not name.endswith(".py"):
                continue
            for line in open(os.path.join(dirpath, name)).read().splitlines():
                m = pragma.search(line)
                if m:
                    seen += 1
                    assert set(re.split(r"[,\s]+", m.group("ids").strip())) <= set(RULES), line
                    assert m.group("why") and len(m.group("why").strip()) > 15, line
    assert seen >= 8


# the repairs this scan asked for: each repaired site, reverted in a toy
# copy, fires its rule again (and the repaired file is clean)
REPAIRS = [
    ("dtype-implicit", "kernels/assoc.py", "torch.arange(T, dtype=torch.long, device=z.device)",
     "torch.arange(T, device=z.device)"),
    ("dtype-implicit", "kernels/cuda_semiring.py",
     "lane = torch.arange(N, dtype=torch.long, device=alpha_t.device)",
     "lane = torch.arange(N, device=alpha_t.device)"),
    ("dtype-implicit", "kernels/cuda_traj.py",
     "lane_b = torch.arange(N, dtype=torch.long, device=q_t.device) // C",
     "lane_b = torch.arange(N, device=q_t.device) // C"),
    ("dtype-implicit", "kernels/ffbs.py", "steps = torch.arange(T, dtype=torch.long, device=z.device)",
     "steps = torch.arange(T, device=z.device)"),
    ("dtype-implicit", "kernels/semiring.py", "return torch.arange(K, dtype=torch.long, device=device)",
     "return torch.arange(K, device=device)"),
    ("dtype-implicit", "kernels/viterbi.py",
     "identity = torch.arange(K, dtype=torch.long, device=log_obs.device)",
     "identity = torch.arange(K, device=log_obs.device)"),
    ("dtype-implicit", "core/bijectors.py",
     "torch.tensor(self._idx, dtype=torch.long, device=vals.device)",
     "torch.tensor(self._idx, device=vals.device)"),
    ("shared-state-race", "kernels/dispatch.py", "    with _DEVICE_KINDS_LOCK:\n", "    if True:\n"),
    ("shared-state-race", "kernels/duration.py",
     "    with _STRUCTURE_LOCK:  # serving threads expand concurrently\n", "    if True:\n"),
    ("layer-import", "robust/retry.py", "    return derive_seed(seed, _SALT, attempt)",
     "    from hhmm_tpu_torch.batch.fit import derive_seed as d\n\n    return d(seed, _SALT, attempt)"),
]


@pytest.mark.parametrize("rule,rel,fixed,broken", REPAIRS, ids=[f"{r[0]}:{r[1]}" for r in REPAIRS])
def test_repaired_site_fires_when_reverted(rule, rel, fixed, broken, tmp_path):
    src = open(os.path.join(REPO, PKG, rel)).read()
    assert fixed in src
    path = f"{PKG}/{rel}"
    rep = _run(tmp_path / "fixed", {path: src}, [rule], paths=(path,))
    assert not rep.findings, _ids(rep)
    rep = _run(tmp_path / "broken", {path: src.replace(fixed, broken, 1)}, [rule], paths=(path,))
    assert _fires(rep, rule), f"reverting the repair of {rel} did not fire {rule}"


def test_derive_seed_lives_below_batch_and_matches_the_digest():
    """``derive_seed`` moved from batch/fit.py to robust/retry.py (the
    layer-import repair): the same seeds as the digest of
    ``batch.cache.digest_key`` it was, re-exported from ``batch``."""
    import random

    from hhmm_tpu_torch.batch import derive_seed as from_batch
    from hhmm_tpu_torch.batch.cache import digest_key
    from hhmm_tpu_torch.robust.retry import _SALT, derive_seed, rejitter

    assert from_batch is derive_seed
    rnd = random.Random(0)
    for _ in range(300):
        parts = [rnd.randint(-(2**40), 2**62) for _ in range(rnd.randint(1, 4))]
        assert derive_seed(*parts) == int(digest_key(*parts)[:15], 16)
    assert rejitter(7, 2) == int(digest_key(7, _SALT, 2)[:15], 16)


def test_locked_caches_under_concurrent_callers():
    """The two module caches the race rule asked to lock return one
    object per key when many threads fill them at once."""
    import torch

    from hhmm_tpu_torch.kernels import dispatch
    from hhmm_tpu_torch.kernels import duration

    like = torch.zeros(1, dtype=torch.float32)
    got, kinds = [], []
    barrier = threading.Barrier(8)

    def work():
        barrier.wait()
        got.append(duration._structure(3, 7, like))
        kinds.append(dispatch._device_kind("cpu"))

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(g is got[0] for g in got) and set(kinds) == {"cpu"}


def test_analyzer_imports_only_the_stdlib():
    pkg = os.path.join(REPO, PKG, "analysis")
    stdlib = set(sys.stdlib_module_names)
    for name in sorted(os.listdir(pkg)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(pkg, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            for r in roots:
                assert r in stdlib or r == "__future__", f"{name}: imports {r}"


def test_cli_runs_without_torch():
    """``python -m hhmm_tpu_torch.analysis`` imports neither torch nor
    numpy: the root package loads nothing at import."""
    code = (
        "import sys, runpy\n"
        "sys.argv = ['x', '--list-rules']\n"
        "try:\n"
        "    runpy.run_module('hhmm_tpu_torch.analysis', run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "assert 'torch' not in sys.modules and 'numpy' not in sys.modules, sorted(sys.modules)\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
