"""Ragged-series padding and masks (a copy of the NumPy-only
``hhmm_tpu/batch/pad.py``).

The reference's batch workloads (walk-forward windows, multi-ticker
backtests) have per-series lengths that differ — zig-zag feature counts
vary by day and ticker (`tayal2009/R/wf-trade.R:44-61`). The TPU path
pads every series to a common T and gates both the scan carries and the
log-likelihood with a {0,1} mask (SURVEY.md §7.3 "Ragged batching"); the
kernels already treat masked steps as no-ops, pinned by the
masked-vs-truncated equivalence test in ``tests/test_kernels.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["pad_ragged", "pad_datasets"]


def pad_ragged(
    arrays: Sequence[np.ndarray], pad_value: float = 0, length: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack ragged [T_i, ...] arrays → (padded [B, T, ...], mask [B, T]).

    ``pad_value`` must be a *valid* value for the consumer (e.g. symbol 0
    for categorical emissions) — masked steps contribute nothing to the
    loglik but still flow through the (finite-arithmetic) kernels.
    """
    if not arrays:
        raise ValueError("no arrays to pad")
    T = max(a.shape[0] for a in arrays) if length is None else length
    if any(a.shape[0] > T for a in arrays):
        raise ValueError(f"a series exceeds requested length {T}")
    B = len(arrays)
    tail = arrays[0].shape[1:]
    out = np.full((B, T) + tail, pad_value, dtype=np.asarray(arrays[0]).dtype)
    mask = np.zeros((B, T), dtype=np.float32)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
        mask[i, : a.shape[0]] = 1.0
    return out, mask


def pad_datasets(
    datasets: Sequence[Dict[str, np.ndarray]],
    time_keys: Sequence[str],
    pad_values: Optional[Dict[str, float]] = None,
) -> Dict[str, np.ndarray]:
    """Batch per-series data dicts into one padded dict + ``mask``.

    Keys in ``time_keys`` are padded along their leading (time) axis to
    the common maximum; all series must agree on every other key's shape.
    Adds ``mask [B, T]`` (and leaves any pre-existing mask alone).
    """
    pad_values = pad_values or {}
    out: Dict[str, np.ndarray] = {}
    mask = None
    for key in datasets[0]:
        arrs = [np.asarray(d[key]) for d in datasets]
        if key in time_keys:
            padded, m = pad_ragged(arrs, pad_value=pad_values.get(key, 0))
            out[key] = padded
            if mask is None:
                mask = m
            elif not np.array_equal(mask, m):
                raise ValueError(f"time key {key!r} has inconsistent lengths")
        else:
            out[key] = np.stack(arrs)
    if "mask" not in out:
        out["mask"] = mask
    return out
