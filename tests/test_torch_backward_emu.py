"""The backward-recursion kernels' CUDA sources (`hhmm_tpu_torch/kernels/
csrc/vg_bwd.cu` and `semiring_beta.cu`, both on `beta_core.cuh` and
`lane_group.cuh`), compiled for the host with `g++` over a warp emulation
(`tests/cuda_warp_emu.h`: a thread per CUDA thread, barriers for the
shuffles; each `cp.async` rewritten into a plain copy and its commit and
wait into nothing), against `vg_bwd_plain` / `beta_plain` on the same
inputs.

This runs the kernels' own schedule — a group of threads a lane, the
gathers, the ring filled backward in time in chunks, the masked step as a
select, the Baum-Welch sums in the recursion's threads — at K in {2, 3,
4, 5, 8, 12, 16} (groups of 2, 4, 8 and 16 threads, idle threads at K =
3, 5 and 12), and for the guarded beta also at K in {17, 20, 32} (a warp
a lane), gated and not, with ragged masks and masked runs at both
ends, T off the ring's chunk and T = 1, on the CPU. The host's `expf` /
`logf` are not the card's nor torch's, so the tolerances below are
stated, not bitwise: a T-step recursion in f32 carries a few ulps of its
largest values (|log beta| up to a few hundred at T = 256: 1e-4
absolute). On the card, `chip_smoke.py` holds the same sources bitwise to
the plain versions.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from hhmm_tpu_torch.core.lmath import MASK_NEG
from hhmm_tpu_torch.kernels import cuda_semiring as cs
from hhmm_tpu_torch.kernels.cuda_build import CSRC_DIR

HERE = Path(__file__).resolve().parent
KS = (2, 3, 4, 5, 8, 12, 16)
BETA_KS = KS + (17, 20, 32)  # the decode kernels take K up to 32
LOG_ATOL = 1e-4  # log beta: a few ulps of |log beta| <= a few hundred
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4  # d_pi / d_obs (probabilities) and d_A (a sum of T terms)

# the three inline-asm statements of lane_group.cuh's cp.async helpers
_ASM = {
    "cp.async.ca.shared.global": "*smem = *gmem;",
    "cp.async.commit_group": ";",
    "cp.async.wait_group": ";",
}


def _emulated(text: str) -> str:
    text = text.replace("#include <cuda_runtime.h>", '#include "cuda_warp_emu.h"')

    def asm(m):
        for key, body in _ASM.items():
            if key in m.group(0):
                return body
        raise AssertionError(f"unknown inline asm: {m.group(0)}")

    return re.sub(r"asm volatile\(.*?\);", asm, text, flags=re.S)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """Both sources built for the host over the warp emulation, their C
    entries bound with the wrappers' argument types."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources over the warp emulation")
    work = tmp_path_factory.mktemp("backward_emu")
    header = _emulated((CSRC_DIR / "lane_group.cuh").read_text())
    assert header.count("*smem = *gmem;") == 1 and "asm" not in header
    (work / "lane_group.cuh").write_text(header)
    core, n = re.subn(r"(beta_kernel<[^>]*>)<<<(.*?), (.*?), (.*?), stream>>>\(",
                      r"Launcher{\2, \3, (size_t)(\4)}(\1, ", (CSRC_DIR / "beta_core.cuh").read_text())
    assert n == 1, "the launch of the kernel is rewritten"
    (work / "beta_core.cuh").write_text(core)
    fns = {}
    for kernel in (cs.VG_BWD, cs.BETA):
        src = work / f"{kernel.source.stem}.cpp"
        src.write_text(kernel.source.read_text())
        lib = work / f"lib{kernel.name}_emu.so"
        out = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                              "-pthread", f"-I{HERE}", f"-I{work}", "-o", str(lib), str(src)],
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr
        fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        fns[kernel.name] = fn
    return fns


def _lanes(seed, N, T, K, *, gated=False, decode=False):
    """Lane-layout ``(A, obs, mask, gate, sk)``: normalized A, N(-1, 1)
    emissions, every lane's tail past a length in [T/2, T] masked and its
    first [0, T/8] steps too; gated: 0/1 gate keys against a Tayal-like
    state key. ``decode``: about a fifth of A at ``MASK_NEG`` and two
    lanes with an all -inf evidence row at a valid step."""
    rng = np.random.default_rng(seed)
    log_A = rng.normal(size=(N, K, K))
    log_A -= np.log(np.exp(log_A).sum(-1, keepdims=True))
    log_obs = rng.normal(size=(N, T, K)) - 1.0
    steps = np.arange(T)[None, :]
    ends = rng.integers(max(T // 2, 1), T + 1, size=N)
    valid = (steps < ends[:, None]) & (steps >= rng.integers(0, T // 8 + 1, size=N)[:, None])
    if decode:
        log_A[rng.random((N, K, K)) < 0.2] = MASK_NEG
        for n in range(min(2, N)):
            log_obs[n, rng.integers(0, ends[n])] = -np.inf
    f32 = dict(dtype=torch.float32)
    gk = sk = None
    if gated:
        gk = torch.as_tensor(rng.integers(0, 2, size=(N, T)), **f32)
        sk = torch.as_tensor(np.resize([1.0, 0.0, 0.0, 1.0], K), **f32)
    log_pi = torch.as_tensor(np.full((N, K), -np.log(K)), **f32)
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = cs.to_lanes(
        log_pi, torch.as_tensor(log_A, **f32), torch.as_tensor(log_obs, **f32),
        torch.as_tensor(valid, **f32), gk, sk)
    return pi_t, A_t, obs_t, mask_t, gate_t, sk_t


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run_vg(fn, A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t):
    T, K, N = obs_t.shape
    out = [torch.full(s, float("nan")) for s in ((K, N), (K, K, N), (T, K, N))]
    rc = fn(K, int(gate_t is not None), *map(_ptr, (A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)),
            *map(_ptr, out), T, N, None)
    assert rc == 0
    return out


def _run_beta(fn, A_t, obs_t, mask_t):
    T, K, N = obs_t.shape
    beta = torch.full((T, K, N), float("nan"))
    assert fn(K, *map(_ptr, (A_t, obs_t, mask_t, beta)), T, N, None) == 0
    return beta


SHAPES = [(5, 75), (8, 256), (3, 1)]  # (N, T): T off the 8-step chunk, T = 256, T = 1


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("K", KS)
def test_vg_bwd_source_matches_plain(emu, K, gated):
    for N, T in SHAPES:
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = _lanes(10 * K + gated + T, N, T, K, gated=gated)
        ll, alpha = cs.fwd_plain(pi_t, A_t, obs_t, mask_t, gate_t, sk_t)
        got = _run_vg(emu["vg_bwd"], A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)
        want = cs.vg_bwd_plain(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)
        for name, g, w in zip(("d_pi", "d_A", "d_obs"), got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{name} N={N} T={T}")


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("K", BETA_KS)
def test_beta_source_matches_plain(emu, K, decode):
    for N, T in SHAPES:
        _, A_t, obs_t, mask_t, _, _ = _lanes(20 * K + decode + T, N, T, K, decode=decode)
        got = _run_beta(emu["semiring_beta"], A_t, obs_t, mask_t).numpy()
        want = cs.beta_plain(A_t, obs_t, mask_t).numpy()
        assert not np.isnan(got).any()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=LOG_ATOL,
                                   err_msg=f"N={N} T={T}")


def test_sources_repeat_bitwise(emu):
    """Two launches on the same inputs give the same bits: every sum has a
    fixed order (no atomics)."""
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = _lanes(7, 6, 90, 5, gated=True)
    ll, alpha = cs.fwd_plain(pi_t, A_t, obs_t, mask_t, gate_t, sk_t)
    a = _run_vg(emu["vg_bwd"], A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)
    b = _run_vg(emu["vg_bwd"], A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(_run_beta(emu["semiring_beta"], A_t, obs_t, mask_t),
                       _run_beta(emu["semiring_beta"], A_t, obs_t, mask_t))


def test_sources_refuse_k_outside_the_range(emu):
    pi_t, A_t, obs_t, mask_t, _, _ = _lanes(3, 2, 4, 2)
    for K in (1, 33):
        assert emu["semiring_beta"](K, *map(_ptr, (A_t, obs_t, mask_t, obs_t)), 4, 2, None) == -1
    out = torch.zeros(64)
    for K in (1, 17):
        assert emu["vg_bwd"](K, 0, *map(_ptr, (A_t, obs_t, mask_t, obs_t, out, None, None)),
                             *map(_ptr, (out, out, out)), 4, 2, None) == -1
