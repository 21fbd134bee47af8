"""Build the semiring kernels' CUDA sources (`hhmm_tpu_torch/kernels/
csrc`) for the host with `g++` over the CPU emulation of
`tests/cuda_warp_emu.h`, and bind their C entries with the wrappers'
argument types (`tests/test_torch_forward_emu.py`,
`tests/test_torch_backward_emu.py`).

The rewrites: `#include <cuda_runtime.h>` becomes the emulation header;
each of `lane_group.cuh`'s three cp.async statements becomes a plain copy
or nothing (the copy has landed when the thread reads it, which is what
wait_group guarantees); `extern __shared__ T name[];` becomes a pointer to
the block's dynamic shared memory; and each `kernel<...><<<grid, block,
smem, stream>>>(` launch becomes a call of the emulation's `Launcher`.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from hhmm_tpu_torch.kernels.cuda_build import CSRC_DIR

HERE = Path(__file__).resolve().parent
_ASM = {
    "cp.async.ca.shared.global": "*smem = *gmem;",
    "cp.async.cg.shared.global": "std::memcpy(smem, gmem, 16);",
    "cp.async.commit_group": ";",
    "cp.async.wait_group": ";",
}
_LAUNCH = re.compile(r"(\w+_kernel(?:<[^>]*>)?)<<<(.*?), (.*?), (.*?), (?:stream|s)>>>\(", re.S)
_EXTERN = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];")


def emulated(text: str) -> str:
    """A kernel source or header rewritten for the emulation."""
    text = text.replace("#include <cuda_runtime.h>", '#include "cuda_warp_emu.h"')

    def asm(m):
        for key, body in _ASM.items():
            if key in m.group(0):
                return body
        raise AssertionError(f"unknown inline asm: {m.group(0)}")

    text = re.sub(r"asm volatile\(.*?\);", asm, text, flags=re.S)
    text = _EXTERN.sub(r"\1* \2 = reinterpret_cast<\1*>(g_smem);", text)
    return _LAUNCH.sub(r"Launcher{\2, \3, (size_t)(\4)}(\1, ", text)


def build(kernels, work: Path) -> dict:
    """``{kernel.name: bound C entry}`` for ``kernels`` (of
    ``cuda_semiring``), their sources and every header of ``csrc``
    rewritten into ``work`` and compiled at once, one ``g++`` a source.
    Skips the test without ``g++``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources over the warp emulation")
    for header in CSRC_DIR.glob("*.cuh"):
        text = emulated(header.read_text())
        assert "asm" not in text and "<<<" not in text, header.name
        (work / header.name).write_text(text)
    procs = {}
    for source in dict.fromkeys(k.source for k in kernels):
        text = emulated(source.read_text())
        assert "<<<" not in text and "extern __shared__" not in text, source.name
        src = work / f"{source.stem}.cpp"
        src.write_text(text)
        lib = work / f"lib{source.stem}_emu.so"
        procs[source] = lib, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
             f"-I{HERE}", f"-I{work}", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for source, (lib, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err
        libs[source] = ctypes.CDLL(str(lib))
    fns = {}
    for kernel in kernels:
        fn = getattr(libs[kernel.source], kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        fns[kernel.name] = fn
    return fns
