"""Native (C++) host-side components (counterpart of
``hhmm_tpu/native``): the zig-zag feature extractor and its threaded
batch loader (``zigzag.cpp``, the port's own copy of the reference's
source).

The shared library is built with the system g++ (``-O3 -std=c++17
-shared -fPIC -pthread``) at first use, never at import, into
``native/_build/`` (listed in ``.gitignore``) under a name keyed by a
digest of the source, so an edited source is rebuilt and a stale
library is never loaded. The build writes a process-private temporary
file and ``os.replace``s it into place, so concurrent builds (test
workers) never expose a half-written library to another process's
``dlopen``. :func:`load` returns the ctypes handle, or ``None`` when no
compiler is available — callers then fall back to the NumPy engine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

__all__ = ["SRC", "BUILD_DIR", "library_path", "load"]

SRC = Path(__file__).resolve().parent / "zigzag.cpp"
BUILD_DIR = SRC.parent / "_build"

_handle: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library built from the current ``zigzag.cpp`` lives."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"_zigzag-{digest}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", str(SRC), "-o", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, lib)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def load() -> Optional[ctypes.CDLL]:
    """The library handle, building it if it is missing; ``None`` when it
    cannot be built or loaded (asked once per process)."""
    global _handle, _tried
    if _handle is not None:
        return _handle
    if _tried:
        return None
    _tried = True
    lib = library_path()
    if not lib.exists() and not _build(lib):
        return None
    try:
        _handle = ctypes.CDLL(str(lib))
    except OSError:
        return None
    return _handle
