"""Digest-keyed on-disk result cache (a copy of the NumPy-only
``hhmm_tpu/batch/cache.py``, so the port needs nothing from the JAX
package).

Parity with the reference's RDS memoization, its only
checkpoint/restart mechanism (SURVEY.md §5): every expensive fit is
keyed by a hash of (model identity, data, sampler config, seed) and
skipped on re-run — `tayal2009/main.R:91-112`,
`tayal2009/R/wf-trade.R:86-109`, `hassan2005/R/wf-forecast.R:27-35`.
A crashed batch rerun resumes where it stopped, task by task.

Stored as ``.npz`` of posterior/stat arrays under a content-addressed
filename; the digest covers raw data bytes, so any change to inputs,
budget, or model config is a cache miss (same semantics as the
reference's ``digest()`` of its inputs).

Crash safety (`docs/robustness.md`): writes are atomic — the archive is
written to a unique temp name in the same directory and ``os.replace``d
into place, so a reader can never observe a half-written entry — and
``get`` treats an unreadable/corrupt entry (torn by a crash predating
atomic writes, damaged storage, a partial copy) as a cache miss: the
broken file is quarantined aside and the entry recomputed, instead of
an exception wedging every future resume of the sweep.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import uuid
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["digest_key", "ResultCache", "atomic_write_npz", "load_npz_tolerant"]


def atomic_write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Crash-safe ``.npz`` write: unique temp name in the same directory
    (same filesystem for ``os.replace``; pid+uuid so concurrent writers
    — other processes AND other threads of this one — cannot tear each
    other's temp), fsync, atomic replace. A reader can never observe a
    half-written archive."""
    tmp = path + f".tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}.npz"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def quarantine_corrupt(path: str, label: str, err: Exception) -> None:
    """Move an unreadable entry aside as ``<path>.corrupt`` (so a
    re-write under the same name works) and log why."""
    print(
        f"# {label}: dropping corrupt entry {os.path.basename(path)} "
        f"({type(err).__name__}: {err})",
        file=sys.stderr,
        flush=True,
    )
    try:
        os.replace(path, path + ".corrupt")
    except OSError:
        pass


def load_npz_tolerant(path: str, label: str) -> Optional[Dict[str, np.ndarray]]:
    """Corrupt-tolerant ``.npz`` read: a missing file is ``None``; a
    torn/garbage/unreadable one is ALSO ``None`` (a miss, quarantined
    aside via :func:`quarantine_corrupt`) instead of an exception
    wedging the consumer. Members are fully materialized inside the
    guard — a torn archive can pass the header check and fail
    mid-member."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    except Exception as e:
        quarantine_corrupt(path, label, e)
        return None


def _update(h, obj) -> None:
    if isinstance(obj, dict):
        for k in sorted(obj):
            h.update(str(k).encode())
            _update(h, obj[k])
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _update(h, v)
    elif isinstance(obj, np.ndarray):
        h.update(str(obj.dtype).encode() + str(obj.shape).encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif hasattr(obj, "tolist"):  # jax arrays and numpy scalars
        _update(h, np.asarray(obj))
    else:
        h.update(json.dumps(obj, sort_keys=True, default=str).encode())


def digest_key(*parts: Any) -> str:
    """SHA-256 over a nested structure of dicts/arrays/scalars."""
    h = hashlib.sha256()
    for p in parts:
        _update(h, p)
    return h.hexdigest()[:32]


class ResultCache:
    """``get``/``put`` of dicts of arrays keyed by a digest."""

    def __init__(self, cache_dir: Optional[str]):
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"{key}.npz")

    def get(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        if not self.cache_dir:
            return None
        # corrupt/unreadable entry == cache miss, moved aside so the
        # recompute can re-put under the same key
        return load_npz_tolerant(self._path(key), "ResultCache")

    def put(self, key: str, value: Dict[str, np.ndarray]) -> None:
        if not self.cache_dir:
            return
        atomic_write_npz(self._path(key), value)
