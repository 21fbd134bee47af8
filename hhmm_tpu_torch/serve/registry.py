"""Posterior snapshot registry (counterpart of
``hhmm_tpu/serve/registry.py``): fitted posteriors as servable
artifacts.

A **snapshot** is thinned unconstrained draws, a reconstructible model
spec, a health flag and a format version, saved under a stable
per-series name so the scheduler can attach, re-attach after a restart,
and fall back to the last healthy snapshot when a new fit comes back
quarantined (``serve/scheduler.py``).

The on-disk format is the JAX package's, field for field
(``SNAPSHOT_VERSION``, ``spec_json``, the draw bank packed as
``draws_dtype`` says: float32, bfloat16 as a uint16 bit view, or
float16), so a snapshot written by either package loads in the other;
``build_model`` resolves the spec's class name against
``hhmm_tpu_torch.models``, whose constructors take the JAX models'
keyword arguments.

Storage uses ``batch/cache.py``'s helpers: atomic writes (temp name,
fsync, ``os.replace``), corrupt-tolerant reads (a torn or garbage file
is a miss, quarantined aside as ``<name>.npz.corrupt``) and version
checks (a foreign version is a miss, left in place).
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from hhmm_tpu_torch.batch.cache import (
    atomic_write_npz,
    load_npz_tolerant,
    quarantine_corrupt,
)
from hhmm_tpu_torch.obs.trace import atomic_write_text

__all__ = [
    "SNAPSHOT_VERSION",
    "SNAPSHOT_DTYPES",
    "PosteriorSnapshot",
    "SnapshotRegistry",
    "model_spec",
    "build_model",
    "snapshot_from_fit",
    "quantize_draws",
    "dequantize_draws",
]

SNAPSHOT_VERSION = "serve-snapshot-v1"

# ---- draw-bank quantization ----
#
# The pager (`serve/pager.py`) budgets RESIDENT bytes; the draw bank is
# ~all of a snapshot's bytes. Quantizing it bf16/f16 halves the
# resident cost — 2× more snapshots under the same byte budget (the
# `serve.pager_resident_bytes` gauge proves it) — at a posterior-draw
# precision loss the one-step predictive loglik parity gate bounds.
# Storage: the packed representation goes into the .npz verbatim (bf16
# as a uint16 bit-view — numpy has no native bfloat16), tagged by
# ``draws_dtype``; dequantization to f32 happens at ATTACH
# (`serve/scheduler.py`), so residency stays packed end to end.

SNAPSHOT_DTYPES = ("float32", "bfloat16", "float16")


def quantize_draws(draws: np.ndarray, dtype: str) -> np.ndarray:
    """Pack an f32/f64 draw bank into the storage representation of
    ``dtype``: ``"float32"`` is the identity (legacy layout),
    ``"float16"`` a native-numpy cast, ``"bfloat16"`` a
    round-to-nearest-even truncation to the high 16 bits of the f32
    pattern, stored as uint16 (portable — no ml_dtypes dependency)."""
    if dtype == "float32":
        return np.asarray(draws)
    if dtype == "float16":
        return np.asarray(draws, np.float32).astype(np.float16)
    if dtype == "bfloat16":
        f32 = np.ascontiguousarray(np.asarray(draws, np.float32))
        # uint64 intermediate: the rounding add must not wrap the
        # all-ones (-NaN) bit pattern around to +0
        bits = f32.view(np.uint32).astype(np.uint64)
        # IEEE round-to-nearest-even on the dropped 16 mantissa bits
        rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)
        # NaN payloads below bit 16 would round to ±inf; force a
        # mantissa bit instead (the standard bf16-converter NaN rule)
        # so a diverged draw bank keeps its NaN markers through the
        # pack — downstream health checks must still see them
        nan_packed = ((bits >> 16) | 0x40).astype(np.uint16)
        return np.where(np.isnan(f32), nan_packed, rounded)
    raise ValueError(
        f"unsupported snapshot dtype {dtype!r} (supported: {SNAPSHOT_DTYPES})"
    )


def dequantize_draws(packed: np.ndarray, dtype: str) -> np.ndarray:
    """The inverse of :func:`quantize_draws`, always returning
    float32 — the serving numerics every attach path feeds the
    device."""
    if dtype == "float32":
        return np.asarray(packed, np.float32)
    if dtype == "float16":
        return np.asarray(packed).astype(np.float32)
    if dtype == "bfloat16":
        u16 = np.ascontiguousarray(np.asarray(packed, np.uint16))
        return (u16.astype(np.uint32) << 16).view(np.float32)
    raise ValueError(
        f"unsupported snapshot dtype {dtype!r} (supported: {SNAPSHOT_DTYPES})"
    )


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---- model spec round-trip ----


def model_spec(model) -> Dict[str, Any]:
    """Reconstructible identity of a model instance: class name + the
    constructor kwargs read back off the instance (every model in the
    zoo stores its constructor args as same-named attributes).

    Only JSON-safe values survive: scalars, strings, ``None``, numpy
    arrays (tagged), and ``NIGPrior`` (tagged dataclass). A model whose
    constructor needs anything richer (e.g. ``TreeHMM``'s tree
    structure) is rejected with a clear error rather than silently
    pickled — snapshots must stay loadable across refactors."""
    cls = type(model)
    kwargs: Dict[str, Any] = {}
    for name, p in inspect.signature(cls.__init__).parameters.items():
        if name == "self" or p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if not hasattr(model, name):
            raise ValueError(
                f"{cls.__name__}.{name} is a constructor arg but not an "
                "instance attribute — cannot build a snapshot spec"
            )
        kwargs[name] = _encode_value(cls.__name__, name, getattr(model, name))
    return {"class": cls.__name__, "kwargs": kwargs}


def _encode_value(cls_name: str, name: str, v: Any) -> Any:
    from hhmm_tpu_torch.models import NIGPrior

    if isinstance(v, NIGPrior):
        return {"__nig__": dataclasses.asdict(v)}
    if isinstance(v, np.ndarray) or hasattr(v, "tolist") and not isinstance(
        v, (int, float, bool)
    ):
        arr = np.asarray(v)
        return {"__array__": arr.tolist(), "dtype": str(arr.dtype)}
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    raise ValueError(
        f"{cls_name}.{name}={type(v).__name__} is not snapshot-serializable "
        "(supported: scalars, str, None, arrays, NIGPrior)"
    )


def _decode_value(v: Any) -> Any:
    from hhmm_tpu_torch.models import NIGPrior

    if isinstance(v, dict) and "__nig__" in v:
        return NIGPrior(**v["__nig__"])
    if isinstance(v, dict) and "__array__" in v:
        return np.asarray(v["__array__"], dtype=v["dtype"])
    return v


def build_model(spec: Dict[str, Any]):
    """Instantiate the model a snapshot was fitted with."""
    import hhmm_tpu_torch.models as models

    cls = getattr(models, spec["class"], None)
    if cls is None:
        raise ValueError(f"unknown model class in snapshot spec: {spec['class']!r}")
    return cls(**{k: _decode_value(v) for k, v in spec["kwargs"].items()})


# ---- snapshot ----


@dataclass(frozen=True)
class PosteriorSnapshot:
    """A servable posterior: thinned draws + spec + health.

    ``draws`` holds the STORAGE representation: the raw float bank for
    ``draws_dtype="float32"`` (the legacy layout), or the packed
    quantized bank (f16, or bf16 as a uint16 bit-view) otherwise — so
    a resident snapshot costs its quantized bytes in the pager.
    Consumers that feed draws to the device go through
    :meth:`dequantized_draws` (the attach-time dequantize)."""

    spec: Dict[str, Any]
    draws: np.ndarray  # [D, dim] thinned unconstrained draws (packed)
    healthy: bool = True
    version: str = SNAPSHOT_VERSION
    meta: Dict[str, Any] = field(default_factory=dict)
    draws_dtype: str = "float32"

    def model(self):
        return build_model(self.spec)

    def dequantized_draws(self) -> np.ndarray:
        """The draw bank in serving numerics: the stored array
        untouched for float32 snapshots (legacy dtype behavior
        preserved bit for bit), else the f32 dequantization of the
        packed bank."""
        if self.draws_dtype == "float32":
            return np.asarray(self.draws)
        return dequantize_draws(self.draws, self.draws_dtype)


def snapshot_from_fit(
    model,
    samples,
    chain_healthy=None,
    n_draws: int = 64,
    meta: Optional[Dict[str, Any]] = None,
    dtype: str = "float32",
) -> PosteriorSnapshot:
    """Thin one series' fit into a servable snapshot.

    ``samples`` [chains, draws, dim] — one series' slice of
    :func:`hhmm_tpu_torch.batch.fit_batched`'s output (a tensor on any
    device, or an array); ``chain_healthy``
    [chains] — the same slice of ``stats["chain_healthy"]`` (the
    `robust/` quarantine mask). Quarantined chains' draws are excluded
    from the thinning; a fit whose *every* chain is quarantined yields
    ``healthy=False`` (the scheduler then refuses to let it replace a
    healthy serving state). Thinning is the evenly-spaced ``linspace``
    selection the walk-forward decode uses, repeat-padded so every
    snapshot carries exactly ``n_draws`` rows (fixed draw count = one
    compile per scheduler bucket).

    ``dtype`` opts the draw bank into quantized storage/residency
    (``"bfloat16"``/``"float16"`` — see :func:`quantize_draws`): the
    snapshot then costs half its f32 bytes in the pager budget, and
    the scheduler dequantizes at attach. Gate adoption on the
    one-step predictive-loglik parity test."""
    samples = _host(samples)
    if samples.ndim != 3:
        raise ValueError(f"samples must be [chains, draws, dim], got {samples.shape}")
    if chain_healthy is None:
        keep = np.ones(samples.shape[0], dtype=bool)
    else:
        keep = _host(chain_healthy).astype(bool).reshape(samples.shape[0])
    healthy = bool(keep.any())
    flat = (samples[keep] if healthy else samples).reshape(-1, samples.shape[-1])
    if flat.shape[0] == 0:
        raise ValueError(
            f"fit has zero draws (samples shape {samples.shape}) — "
            "nothing to thin into a snapshot"
        )
    sel = np.linspace(0, len(flat) - 1, min(n_draws, len(flat))).astype(int)
    draws = flat[sel]
    if len(draws) < n_draws:  # repeat-pad tiny posteriors to the fixed D
        draws = draws[np.arange(n_draws) % len(draws)]
    if dtype not in SNAPSHOT_DTYPES:
        raise ValueError(
            f"unsupported snapshot dtype {dtype!r} (supported: {SNAPSHOT_DTYPES})"
        )
    return PosteriorSnapshot(
        spec=model_spec(model),
        draws=np.ascontiguousarray(quantize_draws(draws, dtype)),
        healthy=healthy,
        meta=dict(meta or {}),
        draws_dtype=dtype,
    )


# ---- registry ----


class SnapshotRegistry:
    """Named snapshot store (one ``.npz`` per name) with atomic writes
    and corrupt-tolerant reads — see the module docstring."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # serializes promote()'s aliases read-modify-write: two
        # IN-PROCESS promoters of different series must not lose one
        # repoint (the whole-map rewrite is not commutative). Across
        # processes the store keeps its existing single-writer-per-root
        # contract, same as the chunk cache.
        self._alias_lock = threading.Lock()

    def _path(self, name: str) -> str:
        if not name or any(c in name for c in "/\\\0") or name.startswith("."):
            raise ValueError(f"invalid snapshot name: {name!r}")
        return os.path.join(self.root, f"{name}.npz")

    def path(self, name: str) -> str:
        """On-disk path a snapshot lives (or would live) at — the
        paging and fault-injection surface (`serve/pager.py` hands it
        to `robust.faults.snapshot_load_fault`; tests tear it)."""
        return self._path(name)

    def exists(self, name: str) -> bool:
        """Whether a servable file is on disk under ``name`` (corrupt
        quarantines and stranded temps don't count — they have
        different suffixes)."""
        return os.path.exists(self._path(name))

    def names(self) -> List[str]:
        # temps are "<name>.npz.tmp.<pid>.npz" (a crash can strand one)
        # and quarantined files "<name>.npz.corrupt": neither is a
        # servable snapshot
        return sorted(
            f[: -len(".npz")]
            for f in os.listdir(self.root)
            if f.endswith(".npz") and ".npz.tmp." not in f
        )

    def save(self, name: str, snap: PosteriorSnapshot) -> str:
        """Write ``snap`` under ``name`` (atomic).

        A quarantined snapshot (``healthy=False``) never *displaces* a
        healthy one: the registry's serving contract is that
        ``load(name)`` yields the last healthy posterior for the
        scheduler's degraded-fit fallback, so overwriting it with an
        unservable artifact would destroy exactly the state the
        fallback needs. Such a save is refused (logged, existing path
        returned); with no healthy predecessor on disk it proceeds —
        a degraded posterior beats none."""
        path = self._path(name)
        if not snap.healthy and os.path.exists(path):
            prev = self.load(name)
            if prev is not None and prev.healthy:
                print(
                    f"# SnapshotRegistry: refusing to replace healthy "
                    f"snapshot {name!r} with a quarantined fit "
                    "(healthy=False); keeping the servable artifact",
                    file=sys.stderr,
                    flush=True,
                )
                return path
        atomic_write_npz(
            path,
            {
                "version": np.asarray(snap.version),
                "spec_json": np.asarray(json.dumps(snap.spec, sort_keys=True)),
                # the PACKED bank goes to disk verbatim (bf16 stays a
                # uint16 bit-view): quantized snapshots are quantized
                # at rest AND resident, not just in flight
                "draws": np.asarray(snap.draws),
                "draws_dtype": np.asarray(str(snap.draws_dtype)),
                "healthy": np.asarray(bool(snap.healthy)),
                "meta_json": np.asarray(
                    json.dumps(snap.meta, sort_keys=True, default=str)
                ),
            },
        )
        return path

    # ---- promotion (the maintenance plane's atomic swap target) ----
    #
    # A promotion is two atomic writes in a fixed order: (1) the
    # candidate archive lands under a FRESH versioned name
    # ("<name>.v<N>", never overwritten), (2) the aliases file — one
    # JSON map "serving/<name>" -> versioned name, written via the
    # shared `trace.atomic_write_text` — repoints. A reader resolving
    # through `load_serving` therefore always loads a COMPLETE archive:
    # the old one (alias not yet repointed) or the new one (repointed,
    # and its archive was fully on disk first). Never a miss, never a
    # torn file — the save+tear race discipline of the snapshot store
    # extended to the pointer (symlink-free: .npz stores must load on
    # hosts where symlinks are unavailable or stripped).

    def _aliases_path(self) -> str:
        return os.path.join(self.root, "aliases.json")

    def _load_aliases(self) -> Dict[str, str]:
        path = self._aliases_path()
        try:
            with open(path, "r") as f:
                raw = json.load(f)
            if not isinstance(raw, dict):
                raise ValueError(f"aliases must be a JSON object, got {type(raw).__name__}")
            return {str(k): str(v) for k, v in raw.items()}
        except FileNotFoundError:
            return {}
        except Exception as e:
            # corrupt alias map: quarantine-as-miss (readers fall back
            # to plain names — the pre-promotion snapshots), a re-save
            # at the next promote heals it
            quarantine_corrupt(path, "SnapshotRegistry.aliases", e)
            return {}

    def promote(self, name: str, snap: PosteriorSnapshot) -> str:
        """Save ``snap`` under a fresh versioned name and atomically
        repoint the ``serving/<name>`` alias at it. Returns the
        versioned name. Old versions stay on disk (the rollback
        surface, and the other half of the reader race guarantee: a
        reader mid-``load_serving`` on the old alias still finds its
        archive). ``load_serving(name)`` serves the promoted snapshot;
        plain ``load(name)`` keeps reading the un-promoted artifact."""
        self._path(name)  # validate the base name
        alias_key = f"serving/{name}"
        # the version pick + archive write happen OUTSIDE the lock (the
        # slow .npz save must not serialize concurrent promoters); only
        # the aliases read-modify-write is the critical section — a
        # whole-map rewrite racing another series' promote would lose
        # one repoint and silently revert that series to its stale
        # plain-name artifact
        prev = self._load_aliases().get(alias_key)
        n = 1
        if prev is not None and prev.startswith(f"{name}.v"):
            try:
                n = int(prev[len(name) + 2 :]) + 1
            except ValueError:
                n = 1
        versioned = f"{name}.v{n}"
        while self.exists(versioned):  # archived versions are immutable
            n += 1
            versioned = f"{name}.v{n}"
        self.save(versioned, snap)
        with self._alias_lock:
            # the alias-map I/O is deliberately inside the lock: the
            # read-modify-write IS the invariant being protected, both
            # files are tiny, and the archive write above (the slow
            # I/O) already happened outside
            aliases = self._load_aliases()  # lint: ok held-lock-escape -- the aliases read-modify-write must be atomic; tiny JSON, slow npz I/O stays outside
            aliases[alias_key] = versioned
            atomic_write_text(  # lint: ok held-lock-escape -- same critical section: the repoint must pair with the read above
                self._aliases_path(),
                json.dumps(aliases, sort_keys=True, indent=1) + "\n",
            )
        return versioned

    def serving_name(self, name: str) -> Optional[str]:
        """The versioned name the ``serving/<name>`` alias points at,
        or ``None`` when ``name`` was never promoted."""
        return self._load_aliases().get(f"serving/{name}")

    def load_serving(self, name: str) -> Optional[PosteriorSnapshot]:
        """Load the snapshot *serving* under ``name``: the promoted
        (alias-resolved) version when one exists, else the plain-name
        artifact — so pre-promotion registries behave exactly as
        before. A stale alias whose archive is missing/corrupt falls
        back to the plain name rather than reporting a miss for a
        series that still has a servable posterior."""
        target = self.serving_name(name)
        if target is not None:
            snap = self.load(target)
            if snap is not None:
                return snap
        return self.load(name)

    def load(self, name: str) -> Optional[PosteriorSnapshot]:
        path = self._path(name)
        raw = load_npz_tolerant(path, "SnapshotRegistry")
        if raw is None:
            return None
        try:
            version = str(raw["version"])
            spec = json.loads(str(raw["spec_json"]))
            draws = np.asarray(raw["draws"])
            # pre-quantization archives carry no tag: they are f32
            draws_dtype = (
                str(raw["draws_dtype"]) if "draws_dtype" in raw else "float32"
            )
            if draws_dtype not in SNAPSHOT_DTYPES:
                raise ValueError(f"unknown draws_dtype {draws_dtype!r}")
            healthy = bool(raw["healthy"])
            meta = json.loads(str(raw["meta_json"]))
        except Exception as e:
            # archive readable but fields missing/garbled (a foreign or
            # damaged payload): same quarantine-as-miss discipline
            quarantine_corrupt(path, "SnapshotRegistry", e)
            return None
        if version != SNAPSHOT_VERSION:
            # foreign format: a miss, but NOT corrupt — leave it alone
            print(
                f"# SnapshotRegistry: snapshot {name!r} has version "
                f"{version!r} (want {SNAPSHOT_VERSION!r}); treating as a miss",
                file=sys.stderr,
                flush=True,
            )
            return None
        return PosteriorSnapshot(
            spec=spec,
            draws=draws,
            healthy=healthy,
            version=version,
            meta=meta,
            draws_dtype=draws_dtype,
        )
