"""The trajectory kernel's CUDA source (`hhmm_tpu_torch/kernels/csrc/
tayal_traj.cu`), compiled for the host with `g++` over a warp emulation
(`tests/cuda_warp_emu.h`: a thread per CUDA thread, barriers for
`__syncwarp` and the shuffles), against `traj_plain` on the same inputs.

This runs the kernel's own schedule — the staged series, the warp's
parallel unpack, the serial recursions of thread 0, the passes over the
stored per-step values and the shuffle reductions — at small shapes on
the CPU, with the tolerances of `tests/test_pallas_traj.py`. The card
runs the same source through `nvcc` (`chip_smoke.py`).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from hhmm_tpu_torch.kernels import cuda_traj as ct
from hhmm_tpu_torch.sim import tayal_batch

TOL = {"q": (2e-4, 2e-4), "p": (2e-3, 2e-3), "logp": (1e-4, 5e-3), "grad": (2e-3, 2e-3)}
HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def emu_kernel(tmp_path_factory):
    """The kernel source built for the host over the warp emulation, its
    C entry bound with the wrapper's argument types."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source over the warp emulation")
    src = ct.TRAJ.source.read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_warp_emu.h"')
    src = src.replace("extern __shared__ __align__(16) uint8_t smem[];", "uint8_t* smem = g_smem;")
    src, n = re.subn(r"(tayal_traj_kernel<\w+>)<<<(.*?), (.*?), (.*?), s>>>\(",
                     r"Launcher{\2, \3, (size_t)(\4)}(\1, ", src)
    assert n == 2, "both launches of the kernel are rewritten"
    work = tmp_path_factory.mktemp("traj_emu")
    (work / "traj_emu.cpp").write_text(src)
    lib = work / "libtraj_emu.so"
    out = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{HERE}",
                          "-o", str(lib), str(work / "traj_emu.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    fn = ctypes.CDLL(str(lib)).hhmm_tayal_traj
    fn.argtypes = ct.TRAJ.argtypes
    fn.restype = ctypes.c_int
    return fn


def _case(seed, B, T, C, both_ends):
    rng = np.random.default_rng(seed)
    x, sign = tayal_batch(B, T, seed=seed, device="cpu")
    valid = np.ones((B, T), bool)
    if both_ends:
        valid &= np.arange(T)[None] < rng.integers(max(T // 2, 1), T + 1, size=B)[:, None]
        valid &= np.arange(T)[None] >= rng.integers(0, T // 8 + 1, size=B)[:, None]
    x_t, s_t, m_t = ct._data_lanes(x, sign, torch.from_numpy(valid.astype(np.float32)), "cpu")
    N = B * C
    lanes = [torch.from_numpy((sc * rng.normal(size=(ct.DIM, N))).astype(np.float32))
             for sc in (0.5, 0.7, 1.0)]
    im = torch.from_numpy(np.exp(0.3 * rng.normal(size=(ct.DIM, B))).astype(np.float32))
    return lanes, im, x_t, s_t, m_t


def _run(fn, lanes, im, x_t, s_t, m_t, n_steps, cap, C, scratch):
    D, N = lanes[0].shape
    T, B = x_t.shape
    out = [torch.full((D, N), float("nan")) for _ in range(3)] + [torch.full((N,), float("nan"))]
    eps = torch.tensor([0.02])
    n = torch.tensor([n_steps], dtype=torch.int32)
    tp = -(-T // ct.T_PAD) * ct.T_PAD
    scr = torch.empty(N * ct.STEP_BYTES * tp, dtype=torch.uint8) if scratch else None
    ptrs = [a.data_ptr() for a in (*lanes, im, x_t, s_t, m_t, eps, n, *out)]
    rc = fn(*ptrs, None if scr is None else scr.data_ptr(), cap, C, T, N, B, None)
    assert rc == 0
    return out[0], out[1], out[3], out[2]


@pytest.mark.parametrize(
    "B,T,C,n_steps,both_ends,scratch",
    [
        (3, 64, 2, 3, False, False),   # full masks, a block of 4 warps and a partial one
        (3, 75, 3, 2, True, False),    # masked runs at both ends, C=3, T off a chunk
        (5, 1, 2, 12, True, False),    # T=1; n_steps past cap
        (1, 70, 1, 2, True, False),    # one lane
        (2, 64, 2, 0, True, False),    # no leapfrog: the inputs back, logp 0
        (2, 97, 2, 2, True, True),     # the device-scratch layout
    ],
)
def test_kernel_source_matches_plain(emu_kernel, B, T, C, n_steps, both_ends, scratch):
    lanes, im, x_t, s_t, m_t = _case(B * 100 + T, B, T, C, both_ends)
    got = _run(emu_kernel, lanes, im, x_t, s_t, m_t, n_steps, 8, C, scratch)
    want = ct.traj_plain(*lanes, im, x_t, s_t, m_t, torch.tensor([0.02]),
                         torch.tensor([n_steps]), 8, C)
    for name, a, b in zip(("q", "p", "logp", "grad"), got, want):
        rtol, atol = TOL[name]
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol, err_msg=name)


def test_kernel_source_repeats_bitwise(emu_kernel):
    """Two launches on the same inputs give the same bits: every sum has a
    fixed order (no atomics)."""
    lanes, im, x_t, s_t, m_t = _case(7, 2, 80, 2, True)
    a = _run(emu_kernel, lanes, im, x_t, s_t, m_t, 3, 8, 2, False)
    b = _run(emu_kernel, lanes, im, x_t, s_t, m_t, 3, 8, 2, False)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_shared_and_scratch_layouts_agree(emu_kernel):
    """The shared-memory and the device-scratch layout run the same
    arithmetic: identical results."""
    lanes, im, x_t, s_t, m_t = _case(8, 3, 50, 2, True)
    a = _run(emu_kernel, lanes, im, x_t, s_t, m_t, 2, 8, 2, False)
    b = _run(emu_kernel, lanes, im, x_t, s_t, m_t, 2, 8, 2, True)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
