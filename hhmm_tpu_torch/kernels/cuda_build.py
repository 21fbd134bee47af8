"""Build and bind the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source has a plain C entry point and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``.
Nothing here runs at import time: a library is built at its kernel's
first CUDA call (or by :func:`build` ahead of time, all sources in
parallel), from the sources in the checkout, into ``kernels/_build/``
(listed in ``.gitignore``). Library names carry a digest of the source,
of every header it includes with a quoted ``#include`` (found next to
it, as ``nvcc`` finds them) and of the flags, so an edited source or
header is rebuilt and never mixed with a stale binary. Every build and
every library load reports its seconds to ``obs/telemetry.py`` (the
run manifest's ``compile`` stanza).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

from hhmm_tpu_torch.obs import telemetry

__all__ = ["CudaKernel", "build", "build_and_load", "NVCC_FLAGS", "BUILD_DIR", "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# -Xptxas -v: registers, shared memory and spills of every kernel go into
# the build log (nothing else on the card's machine reports them)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_NVCC_TIMEOUT_S = 600


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the CUDA kernels")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _with_headers(source: Path) -> list:
    """``source`` and every file it includes with a quoted ``#include``,
    directly or through another header, each once, in first-seen order."""
    seen = [source]
    for path in seen:
        for name in _INCLUDE.findall(path.read_bytes()):
            header = path.parent / name.decode()
            if header not in seen:
                seen.append(header)
    return seen


def _lib_path(source: Path) -> Path:
    text = b"".join(f.read_bytes() for f in _with_headers(source))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:12]}.so"


def build(sources: Iterable[Path]) -> Dict[str, dict]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source (a source named twice is built once), all started
    together. Returns ``{source name: {"seconds", "log", "cached"}}``;
    raises ``RuntimeError`` naming every failed source with its compiler
    output. No ``nvcc`` outlives the call."""
    if not torch.cuda.is_available():
        raise RuntimeError("building the CUDA kernels needs a CUDA device")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: Dict[str, dict] = {}
    running = []
    try:
        for src in dict.fromkeys(Path(s) for s in sources):
            out = _lib_path(src)
            if out.exists():
                report[src.name] = {"seconds": 0.0, "log": "", "cached": True}
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            running.append((src, out, tmp, proc, time.perf_counter()))  # lint: ok raw-clock -- the build's seconds go to obs/telemetry.py (note_build), the manifest's compile stanza
        errors = []
        for src, out, tmp, proc, t0 in running:
            log, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                errors.append(f"{src.name} (rc={proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            seconds = time.perf_counter() - t0  # lint: ok raw-clock -- reported by note_build below
            telemetry.note_build(src.name, seconds)
            report[src.name] = {"seconds": seconds, "log": log, "cached": False}
        if errors:
            raise RuntimeError("nvcc failed for " + "\n".join(errors))
    finally:
        for _, _, tmp, proc, _ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return report


class CudaKernel:
    """One hand-written kernel: its source, its C entry point and
    argument types, the TPU kernel it replaces, and ``launches`` — the
    count of its launches, raised by one by the wrapper at each launch
    and nowhere else."""

    def __init__(
        self,
        name: str,
        source: str,
        symbol: str,
        argtypes: Sequence,
        replaces: str,
    ):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None

    def load(self):
        """The bound C entry point, building the library on first use."""
        if self._fn is None:
            build([self.source])
            # lint: ok raw-clock -- the load's seconds go to obs/telemetry.py (note_load)
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(_lib_path(self.source)))
            # lint: ok raw-clock -- reported by note_load on this line
            telemetry.note_load(self.source.name, time.perf_counter() - t0)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point (which launches on the given stream) and
        raise on a refused launch; count the launch."""
        rc = self.load()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: kernel launch failed (code {rc})")
        self.launches += 1


def build_and_load(kernels: Sequence[CudaKernel]) -> Dict[str, dict]:
    """Build the sources of ``kernels`` now, all in parallel, and bind
    each kernel (otherwise each builds at its first CUDA call). Returns
    :func:`build`'s report."""
    report = build([k.source for k in kernels])
    for k in kernels:
        k.load()
    return report
