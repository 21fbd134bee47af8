"""Run manifests: persisted provenance for every expensive run
(counterpart of ``hhmm_tpu/obs/manifest.py``, same keys).

A bare throughput number is uninterpretable a week later: host speed
moves the port's fits by up to two times between calls, and a card may
run below its maximum power. A manifest pins, for one run:

- **code**: git revision (+dirty flag), package version;
- **stack**: python, hhmm_tpu_torch, torch, the CUDA runtime torch was
  built for, the driver, numpy (``versions``, the mapping
  ``scripts/obs_report.py`` renders);
- **hardware**: backend (``cuda`` or ``cpu``), device kind and count,
  and the card's name and power limit as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` gives them
  (``power_limit``, ``nvidia_smi``), so every number in a manifest
  stands beside the card's name and limit;
- **workload**: digests of the model fingerprint and the run config
  (plus a combined ``workload_digest``, the comparability key), the
  seed;
- **telemetry**: the span table (`obs/trace.py` aggregate), kernel
  build counts and seconds (`obs/telemetry.py`), device-memory
  watermarks, the metrics snapshot (`obs/metrics.py`).

Files follow the `batch/cache.py` conventions: a ``version`` field,
atomic writes (temp + fsync + ``os.replace``), and corrupt-tolerant
reads (a torn or garbage manifest is quarantined aside as ``.corrupt``
and reads as ``None``). A device field that cannot be read (no
``nvidia-smi``, no card) is recorded as ``None``; provenance never
raises.

Digesting here is self-contained (sha256 over a canonical-JSON/array
encoding) rather than importing ``batch.cache.digest_key``: the obs
layer sits below ``batch/`` in the import graph.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import socket
import subprocess
import sys
import threading
from typing import Any, Dict, List, Optional

from hhmm_tpu_torch.obs import metrics as obs_metrics
from hhmm_tpu_torch.obs import telemetry, trace

__all__ = [
    "MANIFEST_VERSION",
    "git_revision",
    "stack_versions",
    "device_info",
    "config_digest",
    "note_stanza",
    "noted_stanza",
    "collect_manifest",
    "manifest_stanza",
    "write_manifest",
    "load_manifest",
]

MANIFEST_VERSION = 1

# decision stanzas noted by subsystems for embedding into every
# subsequently collected manifest (a planner's resolved layout, the way
# kernels/dispatch.py records its resolved branch in span names). Last note per name wins (the manifest
# describes the run's current decisions, not a history — the span table
# carries the history). Lock-guarded (the obs/trace.py discipline): a
# serving thread noting a plan while another thread collects a manifest
# must not tear the iteration.
_NOTED_STANZAS: Dict[str, Any] = {}
_NOTED_LOCK = threading.Lock()


def note_stanza(name: str, stanza: Any) -> None:
    """Record a subsystem decision (e.g. the execution ``plan``) to be
    embedded verbatim in every manifest collected afterward."""
    with _NOTED_LOCK:
        _NOTED_STANZAS[str(name)] = stanza


def noted_stanza(name: str) -> Optional[Any]:
    """The most recently noted stanza for ``name`` (or ``None``)."""
    with _NOTED_LOCK:
        return _NOTED_STANZAS.get(str(name))


def _noted_snapshot() -> Dict[str, Any]:
    with _NOTED_LOCK:
        return dict(_NOTED_STANZAS)


def _digest_update(h, obj) -> None:
    """Canonical recursive hash — dict keys sorted, arrays by
    dtype/shape/bytes (mirrors `batch/cache.py` semantics without the
    import)."""
    if isinstance(obj, dict):
        for k in sorted(obj):
            h.update(str(k).encode())
            _digest_update(h, obj[k])
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _digest_update(h, v)
    elif hasattr(obj, "dtype") and hasattr(obj, "tobytes"):
        import numpy as np

        arr = np.ascontiguousarray(obj)
        h.update(str(arr.dtype).encode() + str(arr.shape).encode())
        h.update(arr.tobytes())
    elif hasattr(obj, "detach") and hasattr(obj, "cpu"):  # torch tensors
        _digest_update(h, obj.detach().cpu().numpy())
    elif hasattr(obj, "tolist"):  # numpy scalars
        import numpy as np

        _digest_update(h, np.asarray(obj))
    else:
        h.update(json.dumps(obj, sort_keys=True, default=str).encode())


def config_digest(*parts: Any) -> str:
    """Short stable digest of a nested config/fingerprint structure."""
    h = hashlib.sha256()
    for p in parts:
        _digest_update(h, p)
    return h.hexdigest()[:16]


# per-process cache: the revision and dirty flag cannot change inside
# one run, and `git status` costs real time on a large tree — a bench
# sweep stamping every record must not pay it per record. Lock-guarded
# (shared-state-race): a serving thread stamping a manifest while a
# bench thread stamps a record must not tear the dict; the subprocess
# itself runs OUTSIDE the lock (held-lock-escape) — a raced first call
# pays git twice, first writer wins via setdefault.
_GIT_CACHE: Dict[str, Optional[Dict[str, Any]]] = {}
_GIT_LOCK = threading.Lock()


def git_revision(root: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """``{"rev": <sha>, "dirty": bool}`` for the repo containing
    ``root`` (default: this package's checkout), or ``None`` when git
    or the repo is unavailable — provenance is best-effort, never a
    crash. Cached per (process, root)."""
    cwd = root or os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    with _GIT_LOCK:
        if cwd in _GIT_CACHE:
            return _GIT_CACHE[cwd]
    out = _git_revision_uncached(cwd)
    with _GIT_LOCK:
        return _GIT_CACHE.setdefault(cwd, out)


def _git_revision_uncached(cwd: str) -> Optional[Dict[str, Any]]:
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd, capture_output=True, text=True, timeout=10,
        )
        if rev.returncode != 0:
            return None
        status = subprocess.run(
            ["git", "status", "--porcelain"],
            cwd=cwd, capture_output=True, text=True, timeout=10,
        )
        return {
            "rev": rev.stdout.strip(),
            "dirty": bool(status.stdout.strip()) if status.returncode == 0 else None,
        }
    except (OSError, subprocess.SubprocessError):
        return None


_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
_SMI_CACHE: Dict[str, Any] = {}
_SMI_LOCK = threading.Lock()


def _smi(query: List[str]) -> Optional[List[str]]:
    """The output lines of one ``nvidia-smi`` query, or ``None`` where it
    cannot run. Cached per process (the card's name, limit and driver do
    not change within a run); the subprocess runs outside the lock."""
    key = " ".join(query)
    with _SMI_LOCK:
        if key in _SMI_CACHE:
            return _SMI_CACHE[key]
    try:
        out = subprocess.run(query, capture_output=True, text=True, timeout=30)
        lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
        got = lines if out.returncode == 0 and lines else None
    except (OSError, subprocess.SubprocessError):
        got = None
    with _SMI_LOCK:
        return _SMI_CACHE.setdefault(key, got)


def stack_versions() -> Dict[str, str]:
    """python, hhmm_tpu_torch, torch, the CUDA runtime torch was built
    for (``cuda_runtime``, None for a CPU build), the driver (where
    ``nvidia-smi`` answers) and numpy."""
    import numpy
    import torch

    import hhmm_tpu_torch

    out = {
        "python": platform.python_version(),
        "hhmm_tpu_torch": getattr(hhmm_tpu_torch, "__version__", "unknown"),
        "torch": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "numpy": numpy.__version__,
    }
    driver = _smi(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"])
    out["cuda_driver"] = driver[0] if driver else None
    return out


def device_info(mesh=None) -> Dict[str, Any]:
    """Backend (``cuda`` where a card is visible, else ``cpu``), device
    kind (``torch.cuda.get_device_name(0)``, or ``cpu``) and count, and
    the ``nvidia-smi`` name and power-limit lines (``nvidia_smi``, one a
    card; ``power_limit`` the first card's limit as printed). ``mesh``:
    a mapping of axis sizes, recorded as ``mesh_shape``."""
    import torch

    out: Dict[str, Any] = {}
    if torch.cuda.is_available():
        out["backend"] = "cuda"
        out["device_count"] = torch.cuda.device_count()
        out["device_kind"] = torch.cuda.get_device_name(0)
    else:
        out["backend"] = "cpu"
        out["device_count"] = 1
        out["device_kind"] = "cpu"
    smi = _smi(_SMI_QUERY) if out["backend"] == "cuda" else None
    out["nvidia_smi"] = smi
    out["power_limit"] = smi[0].split(",")[-1].strip() if smi else None
    if mesh is not None:
        try:
            out["mesh_shape"] = dict(mesh)
        except (TypeError, ValueError):
            out["mesh_shape"] = str(mesh)
    return out


def collect_manifest(
    *,
    config: Any = None,
    model: Any = None,
    seed: Any = None,
    mesh=None,
    workload_config: Any = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Assemble the full manifest dict for the current process state.

    ``config``: the run's config (dict / argparse namespace vars / a
    dataclass's ``vars()``) — digested AND embedded. ``model``: any
    object; scalar/array attributes form its fingerprint digest (same
    attribute discipline as `batch/fit.py`'s cache keys). ``seed``:
    whatever identifies the PRNG stream. ``workload_config``: when the
    full config carries knobs that CANNOT affect the measured workload
    (output paths, profiler flags), pass the workload-relevant subset
    here — ``config_digest``/``workload_digest`` are computed from it
    so an observability flag can never fork the comparability key and
    fail the `scripts/bench_diff.py` gate open. ``extra``: caller
    stanzas merged in at the top level (e.g. the bench's metric name).
    """
    cfg = dict(config) if isinstance(config, dict) else (
        vars(config) if hasattr(config, "__dict__") else config
    )
    digest_src = workload_config if workload_config is not None else cfg
    model_fp = None
    if model is not None:
        attrs: Dict[str, Any] = {"class": type(model).__name__}
        for k, v in sorted(vars(model).items()):
            if isinstance(v, (int, float, str, bool, tuple, list)):
                attrs[k] = v
            elif hasattr(v, "dtype"):
                attrs[k] = v
        model_fp = {"class": attrs["class"], "digest": config_digest(attrs)}
    dev = device_info(mesh)
    cfg_digest = config_digest(digest_src) if digest_src is not None else None
    man: Dict[str, Any] = {
        "version": MANIFEST_VERSION,
        "hostname": socket.gethostname(),
        "argv": list(sys.argv),
        "versions": stack_versions(),
        "git": git_revision(),
        **dev,
        "seed": None if seed is None else int(seed) if isinstance(seed, (int, bool)) else str(seed),
        "config": cfg,
        "config_digest": cfg_digest,
        "model": model_fp,
        # the bench_diff comparability key: same code-independent
        # workload identity (config + model + device kind) means two
        # records' throughputs are comparable
        "workload_digest": config_digest(
            {
                "config": cfg_digest,
                "model": model_fp["digest"] if model_fp else None,
                "device_kind": dev.get("device_kind"),
            }
        ),
        "spans": trace.aggregate(),
        "trace_enabled": trace.enabled(),
        # the statistical-health plane (obs/metrics.py): interim fit
        # convergence gauges, divergence/quarantine counters, serving
        # staleness — whatever the run's producers emitted
        "metrics": obs_metrics.snapshot(),
        **telemetry.telemetry_snapshot(),
    }
    # subsystem decision stanzas (note_stanza): the execution planner's
    # resolved layout rides in every manifest as man["plan"]
    for k, v in _noted_snapshot().items():
        man.setdefault(k, v)
    if extra:
        man.update(extra)
    return man


def manifest_stanza(
    *,
    config: Any = None,
    model: Any = None,
    seed: Any = None,
    mesh=None,
    workload_config: Any = None,
) -> Dict[str, Any]:
    """Compact manifest for embedding into an emitted JSON record (the
    `bench.py` ``"manifest"`` stanza): full provenance identity, but
    the span table collapsed to its size and hottest entry so one-line
    records stay one line. Write :func:`collect_manifest` to a file for
    the full table."""
    man = collect_manifest(
        config=config,
        model=model,
        seed=seed,
        mesh=mesh,
        workload_config=workload_config,
    )
    spans = man.pop("spans")
    compile_st = man.pop("compile")
    man.pop("argv", None)
    man.pop("config", None)  # the records already carry their config
    # compact: the full metrics table lives in the file manifest; the
    # embedded stanza keeps only its size (callers wanting a metric in
    # the record — e.g. the bench's SLO attainment — add it explicitly)
    man["metrics_keys"] = len(man.pop("metrics", {}) or {})
    hottest = next(iter(spans), None)
    man["span_count"] = sum(t["count"] for t in spans.values())
    man["span_names"] = len(spans)
    man["hottest_span"] = (
        {"name": hottest, **spans[hottest]} if hottest else None
    )
    man["backend_compiles"] = compile_st["backend_compiles"]
    man["compile_listener"] = compile_st["listening"]
    return man


def write_manifest(path: str, manifest: Dict[str, Any]) -> None:
    """Atomic JSON write (`obs/trace.py`'s ``atomic_write_text``) so a
    reader can never observe a half-written manifest — the
    `batch/cache.py` discipline applied to JSON."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    trace.atomic_write_text(
        path, json.dumps(manifest, indent=2, sort_keys=False, default=str) + "\n"
    )


def load_manifest(path: str) -> Optional[Dict[str, Any]]:
    """Corrupt-tolerant read: a missing file is ``None``; a torn or
    garbage one is ALSO ``None`` — quarantined aside as ``.corrupt``
    (so a re-write under the same name works) with one stderr line,
    never an exception."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            man = json.load(f)
        if not isinstance(man, dict) or "version" not in man:
            raise ValueError("not a manifest (no version field)")
        return man
    except (OSError, ValueError) as e:
        print(
            f"# manifest: dropping corrupt file {os.path.basename(path)} "
            f"({type(e).__name__}: {e})",
            file=sys.stderr,
            flush=True,
        )
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass
        return None
