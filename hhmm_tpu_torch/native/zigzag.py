"""ctypes binding for the native zig-zag feature extractor (a copy of
``hhmm_tpu/native/zigzag.py`` over the port's own build).

:func:`extract_features_native` is semantically identical to
:func:`hhmm_tpu_torch.apps.tayal.features.extract_features` (NumPy) —
``tests/test_torch_tayal_app.py`` pins the two against each other and
against the JAX package's extractor — and :func:`extract_features_batch`
runs B ragged series through the C++ thread pool in one call, the
host-side batch loader for the walk-forward workloads
(`tayal2009/R/wf-trade.R`'s ~204 per-window extractions).

``series_extracted`` counts the series the native library has processed
in this process (single calls and batches alike), so a caller can show
that the native engine, not the NumPy fallback, ran.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hhmm_tpu_torch.native import load

__all__ = ["available", "extract_features_native", "extract_features_batch", "series_extracted"]

_ERRORS = {
    -1: "need at least 3 ticks",
    -2: "too few direction changes for zig-zag features",
    -3: "invalid leg triple",
}

_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_int64_p = ctypes.POINTER(ctypes.c_int64)
_configured = False
series_extracted = 0


def _lib() -> Optional[ctypes.CDLL]:
    global _configured
    lib = load()
    if lib is None:
        return None
    if not _configured:
        lib.zz_extract.restype = ctypes.c_int64
        lib.zz_extract.argtypes = [
            _c_double_p, _c_double_p, _c_double_p, ctypes.c_int64,
            ctypes.c_double,
            _c_double_p, _c_int64_p, _c_int64_p, _c_double_p,
            _c_int64_p, _c_int64_p, _c_int64_p, _c_int64_p, _c_int64_p,
        ]
        lib.zz_extract_batch.restype = ctypes.c_int64
        lib.zz_extract_batch.argtypes = [
            _c_double_p, _c_double_p, _c_double_p, _c_int64_p,
            ctypes.c_int64, ctypes.c_double,
            _c_double_p, _c_int64_p, _c_int64_p, _c_double_p,
            _c_int64_p, _c_int64_p, _c_int64_p, _c_int64_p, _c_int64_p,
            _c_int64_p, ctypes.c_int64,
        ]
        _configured = True
    return lib


def available() -> bool:
    return _lib() is not None


def _as_c(a: np.ndarray, ptr):
    return a.ctypes.data_as(ptr)


def _alloc(T: int):
    return (
        np.empty(T, np.float64),  # leg_price
        np.empty(T, np.int64),  # start
        np.empty(T, np.int64),  # end
        np.empty(T, np.float64),  # size_av
        np.empty(T, np.int64),  # f0
        np.empty(T, np.int64),  # f1
        np.empty(T, np.int64),  # f2
        np.empty(T, np.int64),  # feature
        np.empty(T, np.int64),  # trend
    )


def _to_zigzag(bufs, n: int):
    # imported here: apps.tayal.features imports this module for its fast
    # path, and the return type lives beside the NumPy engine
    from hhmm_tpu_torch.apps.tayal.features import ZigZag  # lint: ok layer-import -- deliberate lazy cycle-breaker: apps.tayal.features imports native for the fast path; the return type lives beside the NumPy engine

    lp, st, en, sa, f0, f1, f2, ft, tr = bufs
    return ZigZag(
        price=lp[:n].copy(),
        start=st[:n].copy(),
        end=en[:n].copy(),
        size_av=sa[:n].copy(),
        f0=f0[:n].copy(),
        f1=f1[:n].copy(),
        f2=f2[:n].copy(),
        feature=ft[:n].copy(),
        trend=tr[:n].copy(),
    )


def extract_features_native(
    price: np.ndarray,
    size: np.ndarray,
    t_seconds: np.ndarray,
    alpha: float = 0.25,
):
    """Single-series native extraction; raises the same ValueError
    messages as the NumPy path."""
    global series_extracted
    lib = _lib()
    if lib is None:
        raise RuntimeError("native zigzag library unavailable")
    price = np.ascontiguousarray(price, dtype=np.float64)
    size = np.ascontiguousarray(size, dtype=np.float64)
    t_seconds = np.ascontiguousarray(t_seconds, dtype=np.float64)
    if not (price.shape == size.shape == t_seconds.shape) or price.ndim != 1:
        raise ValueError(
            "price, size, t_seconds must be equal-length 1-D arrays, got "
            f"{price.shape}, {size.shape}, {t_seconds.shape}"
        )
    T = price.shape[0]
    bufs = _alloc(max(T, 1))
    n = lib.zz_extract(
        _as_c(price, _c_double_p), _as_c(size, _c_double_p),
        _as_c(t_seconds, _c_double_p), T, alpha,
        _as_c(bufs[0], _c_double_p), _as_c(bufs[1], _c_int64_p),
        _as_c(bufs[2], _c_int64_p), _as_c(bufs[3], _c_double_p),
        _as_c(bufs[4], _c_int64_p), _as_c(bufs[5], _c_int64_p),
        _as_c(bufs[6], _c_int64_p), _as_c(bufs[7], _c_int64_p),
        _as_c(bufs[8], _c_int64_p),
    )
    series_extracted += 1
    if n < 0:
        raise ValueError(_ERRORS.get(n, f"zigzag error {n}"))
    return _to_zigzag(bufs, n)


def extract_features_batch(
    series: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    alpha: float = 0.25,
    n_threads: int = 0,
) -> List:
    """Extract features for B (price, size, t_seconds) series with the
    C++ thread pool. Returns a list of ``ZigZag`` (an entry is the
    ``ValueError`` instance instead when that series fails — callers
    decide per-series error policy, as the reference's `%dopar%` workers
    do). ``n_threads <= 0``: hardware concurrency."""
    global series_extracted
    lib = _lib()
    if lib is None:
        raise RuntimeError("native zigzag library unavailable")
    B = len(series)
    if B == 0:
        return []
    for b, (p, s, t) in enumerate(series):
        p, s, t = np.asarray(p), np.asarray(s), np.asarray(t)
        if not (p.shape == s.shape == t.shape) or p.ndim != 1:
            raise ValueError(
                f"series {b}: price, size, t_seconds must be equal-length "
                f"1-D arrays, got {p.shape}, {s.shape}, {t.shape}"
            )
    price = np.ascontiguousarray(
        np.concatenate([np.asarray(p, np.float64) for p, _, _ in series])
    )
    size = np.ascontiguousarray(
        np.concatenate([np.asarray(s, np.float64) for _, s, _ in series])
    )
    tsec = np.ascontiguousarray(
        np.concatenate([np.asarray(t, np.float64) for _, _, t in series])
    )
    lengths = np.array([len(p) for p, _, _ in series], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    total = int(offsets[-1])
    bufs = _alloc(total)
    n_legs = np.empty(B, dtype=np.int64)
    lib.zz_extract_batch(
        _as_c(price, _c_double_p), _as_c(size, _c_double_p),
        _as_c(tsec, _c_double_p), _as_c(offsets, _c_int64_p), B, alpha,
        _as_c(bufs[0], _c_double_p), _as_c(bufs[1], _c_int64_p),
        _as_c(bufs[2], _c_int64_p), _as_c(bufs[3], _c_double_p),
        _as_c(bufs[4], _c_int64_p), _as_c(bufs[5], _c_int64_p),
        _as_c(bufs[6], _c_int64_p), _as_c(bufs[7], _c_int64_p),
        _as_c(bufs[8], _c_int64_p), _as_c(n_legs, _c_int64_p), n_threads,
    )
    series_extracted += B
    out: List = []
    for b in range(B):
        n = int(n_legs[b])
        if n < 0:
            out.append(ValueError(_ERRORS.get(n, f"zigzag error {n}")))
            continue
        off = int(offsets[b])
        view = tuple(buf[off : off + n] for buf in bufs)
        out.append(_to_zigzag(view, n))
    return out
