"""Data loading — the framework's stand-in for the reference's data
acquisition layer.

The reference pulls daily OHLC with quantmod (`hassan2005/R/data.R:6-24`,
including a Google-date-gap workaround) and ships tick days as xts
`.RData` blobs (`tayal2009/data/`). Neither network fetching nor R
serialization applies here; the equivalents are plain-text loaders with
the same downstream contracts:

- :func:`load_ohlc_csv` → ``[T, 4]`` float array for
  :func:`hhmm_tpu_torch.apps.hassan.data.make_dataset`;
- :func:`load_ticks_csv` → the ``{"price", "size", "t_seconds"}`` dict
  consumed by :func:`hhmm_tpu_torch.apps.tayal.wf.build_tasks` and
  :func:`hhmm_tpu_torch.apps.tayal.features.extract_features`;
- :func:`load_tick_days` → per-day dicts from a directory of CSVs named
  ``<anything>.<YYYY.MM.DD>.csv`` (the reference's per-day file layout,
  `tayal2009/data/<SYM>.TO/2007.05.DD.<SYM>.TO.RData`).

Timestamps may be numeric seconds or ``HH:MM:SS[.ffffff]`` strings;
rows must already be time-ordered (validated).
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["load_ohlc_csv", "load_ticks_csv", "load_tick_days"]

_OHLC_NAMES = ("open", "high", "low", "close")


def _find_columns(header: Sequence[str], wanted: Sequence[str]) -> List[int]:
    lower = [h.strip().lower() for h in header]
    idx = []
    for name in wanted:
        # exact name wins over dotted-suffix matches ("close" must never
        # silently bind to an earlier "adj.close")
        exact = [i for i, h in enumerate(lower) if h == name]
        matches = exact or [i for i, h in enumerate(lower) if h.endswith("." + name)]
        if not matches:
            raise ValueError(f"column {name!r} not found in header {header}")
        idx.append(matches[0])
    return idx


def load_ohlc_csv(path: str) -> np.ndarray:
    """Read a daily OHLC CSV (header must contain open/high/low/close,
    case-insensitive, extra columns ignored) → ``[T, 4]`` float64."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        cols = _find_columns(header, _OHLC_NAMES)
        rows = [[float(row[c]) for c in cols] for row in reader if row]
    if not rows:
        raise ValueError(f"{path}: no data rows")
    ohlc = np.asarray(rows, dtype=np.float64)
    if np.any(ohlc <= 0):
        raise ValueError(f"{path}: non-positive prices")
    if np.any(ohlc[:, 1] < ohlc[:, 2]):
        raise ValueError(f"{path}: high < low")
    return ohlc


def _parse_time(value: str) -> float:
    value = value.strip()
    try:
        return float(value)
    except ValueError:
        pass
    m = re.fullmatch(r"(\d{1,2}):(\d{2}):(\d{2}(?:\.\d+)?)", value)
    if m is None:
        raise ValueError(f"unparseable timestamp {value!r}")
    return float(m.group(1)) * 3600 + float(m.group(2)) * 60 + float(m.group(3))


def load_ticks_csv(path: str) -> Dict[str, np.ndarray]:
    """Read a tick CSV with columns time/price/size (case-insensitive;
    time = seconds or HH:MM:SS) → ``{"price", "size", "t_seconds"}``."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        t_col, p_col, s_col = _find_columns(header, ("time", "price", "size"))
        t, p, s = [], [], []
        for row in reader:
            if not row:
                continue
            t.append(_parse_time(row[t_col]))
            p.append(float(row[p_col]))
            s.append(float(row[s_col]))
    if not p:
        raise ValueError(f"{path}: no data rows")
    t_seconds = np.asarray(t, dtype=np.float64)
    if np.any(np.diff(t_seconds) < 0):
        raise ValueError(f"{path}: timestamps not sorted")
    return {
        "price": np.asarray(p, dtype=np.float64),
        "size": np.asarray(s, dtype=np.float64),
        "t_seconds": t_seconds,
    }


_DAY_RE = re.compile(r"(\d{4}[.\-]\d{2}[.\-]\d{2})")


def load_tick_days(
    directory: str, symbol: Optional[str] = None
) -> List[Dict[str, np.ndarray]]:
    """Load every ``*.csv`` in ``directory`` (optionally filtered to
    names containing ``symbol``) as one tick day each, ordered by the
    date embedded in the file name (``YYYY.MM.DD`` or ``YYYY-MM-DD``),
    ready for :func:`hhmm_tpu_torch.apps.tayal.wf.build_tasks`."""
    entries: List[Tuple[str, str]] = []
    for name in os.listdir(directory):
        if not name.endswith(".csv"):
            continue
        if symbol is not None and symbol not in name:
            continue
        m = _DAY_RE.search(name)
        if m is None:
            raise ValueError(f"{name}: no YYYY.MM.DD date in file name")
        entries.append((m.group(1).replace("-", "."), name))
    if not entries:
        raise ValueError(f"no matching tick CSVs in {directory}")
    entries.sort()
    return [load_ticks_csv(os.path.join(directory, name)) for _, name in entries]
