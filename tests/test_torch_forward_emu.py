"""The forward kernels' CUDA sources (`hhmm_tpu_torch/kernels/csrc/
ffbs_fwd.cu`, `semiring_filter.cu` and `semiring_viterbi.cu`, all on
`fwd_core.cuh` and `lane_group.cuh`), compiled for the host with `g++`
over a warp emulation (`tests/cuda_warp_emu.h`: a thread per CUDA
thread, barriers for the shuffles; each `cp.async` rewritten into a plain
copy and its commit and wait into nothing), against `fwd_plain`,
`filter_plain`, `viterbi_plain` and `backtrack_plain` on the same inputs.

This runs the kernels' own schedule — a group of threads a lane, the
gathers, the ring filled in chunks with a checked partial chunk, the
masked step as a select, the map words ORed across the group — at K in
{2, 3, 4, 5, 8, 12, 16} (groups of 2, 4, 8 and 16 threads, idle threads
at K = 3, 5 and 12, two map words a step above 8) and, for the decode's
two, at K in {17, 20, 32} (a warp a lane, byte-wide map fields, five to
eight words a step), with masked runs at both ends of every lane, T off
the ring's chunk and T = 1, all -inf evidence rows and
``MASK_NEG``-sparse A, lanes whose max-plus scores tie exactly, and the
clamped filter gated and not. Max-plus is exact on the host too, so the maps, dlast, the
scores and the paths are held identical. The host's `expf` / `logf` are
not the card's nor torch's, so the filter is held within a stated
tolerance: a T-step recursion in f32 carries a few ulps of its largest
values (|log alpha| up to a few hundred at T = 256: 1e-4 absolute). On
the card, `chip_smoke.py` holds the same sources bitwise to the plain
versions.
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
DECODE_KS = KS + (17, 20, 32)  # FILTER and VITERBI take K up to 32, FWD up to 16
LOG_ATOL = 1e-4  # log alpha: a few ulps of |log alpha| <= a few hundred
# (N, T): T off the 8-step chunk, T - 1 one full chunk, T = 256, T = 1
SHAPES = [(5, 75), (4, 9), (8, 256), (3, 1)]

# the three inline-asm statements of lane_group.cuh's cp.async helpers
_ASM = {
    "cp.async.ca.shared.global": "*smem = *gmem;",
    "cp.async.commit_group": ";",
    "cp.async.wait_group": ";",
}
_LAUNCH = re.compile(r"(\w+_kernel<[^>]*>)<<<(.*?), (.*?), (.*?), stream>>>\(", re.S)


def _emulated(text: str) -> str:
    text = text.replace("#include <cuda_runtime.h>", '#include "cuda_warp_emu.h"')

    def asm(m):
        for key, body in _ASM.items():
            if key in m.group(0):
                return body
        raise AssertionError(f"unknown inline asm: {m.group(0)}")

    text = re.sub(r"asm volatile\(.*?\);", asm, text, flags=re.S)
    return _LAUNCH.sub(r"Launcher{\2, \3, (size_t)(\4)}(\1, ", text)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The three sources built for the host over the warp emulation (the
    ``g++`` runs at once), their C entries bound with the wrappers'
    argument types."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources over the warp emulation")
    work = tmp_path_factory.mktemp("forward_emu")
    header = _emulated((CSRC_DIR / "lane_group.cuh").read_text())
    assert header.count("*smem = *gmem;") == 1 and "asm" not in header
    (work / "lane_group.cuh").write_text(header)
    core = _emulated((CSRC_DIR / "fwd_core.cuh").read_text())
    assert core.count("Launcher{") == 1, "the launch of the kernel is rewritten"
    (work / "fwd_core.cuh").write_text(core)
    procs = {}
    for source in (cs.FWD.source, cs.FILTER.source, cs.VITERBI.source):
        text = _emulated(source.read_text())
        assert "<<<" not in text
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
    for kernel in (cs.FWD, cs.FILTER, cs.VITERBI, cs.BACKTRACK):
        fn = getattr(libs[kernel.source], kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        fns[kernel.name] = fn
    return fns


def _lanes(seed, N, T, K, *, decode=False, ties=False, gated=False):
    """Lane-layout ``(pi, A, obs, mask)``: normalized pi and A, N(-1, 1)
    emissions, every lane's tail past a length in [T/2, T] masked and its
    first [0, T/8] steps too. ``decode``: about a fifth of A at
    ``MASK_NEG`` and two lanes with an all -inf evidence row at a valid
    step. ``ties``: every other lane has uniform pi and A and integer
    emissions, so the max-plus scores tie exactly. ``gated``: also
    ``(gate, sk)``, 0/1 gate keys against a Tayal-like state key."""
    rng = np.random.default_rng(seed)

    def log_norm(a):
        return a - np.log(np.exp(a).sum(-1, keepdims=True))

    log_pi = log_norm(rng.normal(size=(N, K)))
    log_A = log_norm(rng.normal(size=(N, K, K)))
    log_obs = rng.normal(size=(N, T, K)) - 1.0
    steps = np.arange(T)[None, :]
    ends = rng.integers(max(T // 2, 1), T + 1, size=N)
    valid = (steps < ends[:, None]) & (steps >= rng.integers(0, T // 8 + 1, size=N)[:, None])
    if decode:
        log_A[rng.random((N, K, K)) < 0.2] = MASK_NEG
        for n in range(min(2, N)):
            log_obs[n, rng.integers(0, ends[n])] = -np.inf
    if ties:
        tie = np.arange(N) % 2 == 0
        log_pi[tie] = -np.log(K)
        log_A[tie] = -np.log(K)
        log_obs[tie] = np.round(log_obs[tie])
    f32 = dict(dtype=torch.float32)
    keys = (None, None)
    if gated:
        keys = (torch.as_tensor(rng.integers(0, 2, size=(N, T)), **f32),
                torch.as_tensor(np.resize([1.0, 0.0, 0.0, 1.0], K), **f32))
    lanes = cs.to_lanes(*(torch.as_tensor(a, **f32) for a in (log_pi, log_A, log_obs, valid)),
                        *keys)
    return lanes if gated else lanes[:4]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run_filter(fn, pi_t, A_t, obs_t, mask_t):
    T, K, N = obs_t.shape
    ll, alpha = torch.full((N,), float("nan")), torch.full((T, K, N), float("nan"))
    assert fn(K, *map(_ptr, (pi_t, A_t, obs_t, mask_t, ll, alpha)), T, N, None) == 0
    return ll, alpha


def _run_fwd(fn, pi_t, A_t, obs_t, mask_t, gate_t, sk_t):
    T, K, N = obs_t.shape
    ll, alpha = torch.full((N,), float("nan")), torch.full((T, K, N), float("nan"))
    rc = fn(K, int(gate_t is not None), *map(_ptr, (pi_t, A_t, obs_t, mask_t, gate_t, sk_t)),
            _ptr(ll), _ptr(alpha), T, N, None)
    assert rc == 0
    return ll, alpha


def _run_viterbi(fns, pi_t, A_t, obs_t, mask_t):
    """``(score, dlast, back, path)`` of the emulated ``VITERBI`` and
    ``BACKTRACK``; every output starts as a pattern no kernel writes."""
    T, K, N = obs_t.shape
    score, dlast = torch.full((N,), float("nan")), torch.full((K, N), float("nan"))
    back = torch.full(cs._map_shape(T, K, N), -1, dtype=torch.int32)
    assert fns["viterbi_fwd"](K, *map(_ptr, (pi_t, A_t, obs_t, mask_t, score, dlast, back)),
                              T, N, None) == 0
    path = torch.full((T, N), -1, dtype=torch.int32)
    assert fns["viterbi_backtrack"](K, *map(_ptr, (back, dlast, path)), T, N, None) == 0
    return score, dlast, back, path


def _assert_logs_close(got, want, what):
    got, want = got.numpy(), want.numpy()
    assert not np.isnan(got).any(), what
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=LOG_ATOL, err_msg=what)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("K", KS)
def test_fwd_source_matches_plain(emu, K, gated):
    """``FWD``, the clamped mode of the same core, gated and not."""
    for N, T in SHAPES:
        lanes = _lanes(50 * K + gated + T, N, T, K, gated=True)
        if not gated:
            lanes = lanes[:4] + (None, None)
        ll, alpha = _run_fwd(emu["ffbs_fwd"], *lanes)
        ll_p, alpha_p = cs.fwd_plain(*lanes)
        _assert_logs_close(alpha, alpha_p, f"alpha N={N} T={T}")
        _assert_logs_close(ll, ll_p, f"ll N={N} T={T}")


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("K", DECODE_KS)
def test_filter_source_matches_plain(emu, K, decode):
    for N, T in SHAPES:
        lanes = _lanes(30 * K + decode + T, N, T, K, decode=decode)
        ll, alpha = _run_filter(emu["semiring_filter"], *lanes)
        ll_p, alpha_p = cs.filter_plain(*lanes)
        _assert_logs_close(alpha, alpha_p, f"alpha N={N} T={T}")
        _assert_logs_close(ll, ll_p, f"ll N={N} T={T}")
        if not decode:  # finite inputs: the clamped filter's arithmetic
            ll_f, alpha_f = cs.fwd_plain(*lanes)
            _assert_logs_close(alpha, alpha_f, f"alpha vs fwd_plain N={N} T={T}")
            _assert_logs_close(ll, ll_f, f"ll vs fwd_plain N={N} T={T}")


@pytest.mark.parametrize("case", ["plain", "decode", "ties"])
@pytest.mark.parametrize("K", DECODE_KS)
def test_viterbi_source_matches_plain(emu, K, case):
    for N, T in SHAPES:
        lanes = _lanes(40 * K + len(case) + T, N, T, K, decode=case == "decode",
                       ties=case == "ties")
        score, dlast, back, path = _run_viterbi(emu, *lanes)
        score_p, dlast_p, back_p = cs.viterbi_plain(*lanes)
        what = f"K={K} {case} N={N} T={T}"
        assert torch.equal(back, back_p), what
        assert torch.equal(dlast, dlast_p), what
        assert torch.equal(score, score_p), what
        assert torch.equal(path, cs.backtrack_plain(back_p, dlast_p)), what


@pytest.mark.parametrize("K", [12, 20])
def test_full_ties_take_the_lowest_index(emu, K):
    """Uniform pi and A and one emission for every state at a step: every
    score of every step ties, so each map points every state at state 0
    (the identity on masked steps) and the path ends in state 0, as the
    ascending strict-> chain gives."""
    N, T = 3, 40
    rng = np.random.default_rng(5)
    pi_t, A_t, obs_t, mask_t = _lanes(5, N, T, K)
    pi_t.fill_(-np.log(K))
    A_t.fill_(-np.log(K))
    obs_t.copy_(torch.as_tensor(rng.normal(size=(T, 1, N)), dtype=torch.float32).expand(T, K, N))
    _, _, back, path = _run_viterbi(emu, pi_t, A_t, obs_t, mask_t)
    ptr = cs.unpack_back(back, K)  # [T, K, N]
    want = torch.where(mask_t[:, None, :] > 0, 0, torch.arange(K)[None, :, None])
    want[0] = torch.arange(K)[:, None]  # back_0 is the identity
    assert torch.equal(ptr, want)
    assert int(path[-1].abs().sum()) == 0


def test_sources_repeat_bitwise(emu):
    """Two launches on the same inputs give the same bits: every sum has a
    fixed order and every map word a fixed OR (no atomics)."""
    lanes = _lanes(7, 6, 90, 5, decode=True)
    a, b = _run_filter(emu["semiring_filter"], *lanes), _run_filter(emu["semiring_filter"], *lanes)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    a, b = _run_viterbi(emu, *lanes), _run_viterbi(emu, *lanes)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_sources_refuse_k_outside_the_range(emu):
    pi_t, A_t, obs_t, mask_t = _lanes(3, 2, 4, 2)
    out = torch.zeros(64)
    for K in (1, 33):
        assert emu["semiring_filter"](K, *map(_ptr, (pi_t, A_t, obs_t, mask_t, out, out)),
                                      4, 2, None) == -1
        assert emu["viterbi_fwd"](K, *map(_ptr, (pi_t, A_t, obs_t, mask_t, out, out, out)),
                                  4, 2, None) == -1
        assert emu["viterbi_backtrack"](K, *map(_ptr, (out, out, out)), 4, 2, None) == -1
    for K in (1, 17):
        assert emu["ffbs_fwd"](K, 0, *map(_ptr, (pi_t, A_t, obs_t, mask_t, None, None, out, out)),
                               4, 2, None) == -1
