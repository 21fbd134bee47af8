"""The backward kernels' CUDA sources (`hhmm_tpu_torch/kernels/csrc/
vg_bwd.cu` and `semiring_beta.cu`, on `beta_core.cuh`, `wide_core.cuh`
and `lane_group.cuh`, and `ffbs_bwd_sample.cu`), compiled for the host
with `g++` over a warp emulation (`tests/cuda_warp_emu.h`, built by
`tests/cuda_emu.py`: a thread per CUDA thread, barriers for the shuffles
and `__syncthreads`, a per-block buffer for dynamic shared memory; each
`cp.async` rewritten into a plain copy and its commit and wait into
nothing), against `vg_bwd_plain`, `beta_plain` and `bwd_sample_plain`
on the same inputs.

This runs the kernels' own schedule — a group of threads a lane up to
K = 32 (the gathers, the ring filled backward in time in chunks, the
masked step as a select, the Baum-Welch sums in the recursion's
threads), a block a lane above (A and d_A in shared memory, e exchanged
there with one barrier a step); and for backward sampling the three
phases at K <= 16 (every candidate draw packed four bits a state, the
chase, the copy out; the maps in shared memory or, at T = 2100, in the
device scratch) and the chunked block-a-lane layout above (byte maps,
one chunk of them on chip at a time) — at K in {2, 3, 4, 5, 8, 12, 16,
17, 20, 32, 33, 64}, gated and not, with ragged masks and masked runs
at both ends, T off the rings' chunks and T = 1, on the CPU. The host's
`expf` / `logf` are not the card's nor torch's, so the tolerances below
are stated, not bitwise: a T-step recursion in f32 carries a few ulps of
its largest values (|log beta| up to a few hundred at T = 256: 1e-4
absolute); the draws are held identical, on uniforms redrawn until each
lies at least 1e-4 from an inverse-CDF edge (`tests/test_torch_kernels.py`'s
helper), so that host and torch exponentials do not decide a draw. On
the card, `chip_smoke.py` holds the same sources bitwise to the plain
versions.
"""

import numpy as np
import pytest
import torch

from cuda_emu import build
from test_torch_kernels import _lane_uniforms_off_edges
from hhmm_tpu_torch.core.lmath import MASK_NEG
from hhmm_tpu_torch.kernels import cuda_semiring as cs

KS = (1, 2, 3, 4, 5, 8, 12, 16, 17, 20, 32, 33, 64)
LOG_ATOL = 1e-4  # log beta: a few ulps of |log beta| <= a few hundred
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4  # d_pi / d_obs (probabilities) and d_A (a sum of T terms)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The three sources built for the host over the warp emulation, their
    C entries bound with the wrappers' argument types."""
    return build((cs.VG_BWD, cs.BETA, cs.BWD_SAMPLE), tmp_path_factory.mktemp("backward_emu"))


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
WIDE_SHAPES = [(3, 75), (2, 1)]  # a block a lane: fewer lanes


def _shapes(K):
    return SHAPES if K <= 32 else WIDE_SHAPES


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("K", KS)
def test_vg_bwd_source_matches_plain(emu, K, gated):
    for N, T in _shapes(K):
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = _lanes(10 * K + gated + T, N, T, K, gated=gated)
        ll, alpha = cs.fwd_plain(pi_t, A_t, obs_t, mask_t, gate_t, sk_t)
        got = _run_vg(emu["vg_bwd"], A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)
        want = cs.vg_bwd_plain(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)
        for name, g, w in zip(("d_pi", "d_A", "d_obs"), got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{name} N={N} T={T}")


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("K", KS)
def test_beta_source_matches_plain(emu, K, decode):
    for N, T in _shapes(K):
        _, A_t, obs_t, mask_t, _, _ = _lanes(20 * K + decode + T, N, T, K, decode=decode)
        got = _run_beta(emu["semiring_beta"], A_t, obs_t, mask_t).numpy()
        want = cs.beta_plain(A_t, obs_t, mask_t).numpy()
        assert not np.isnan(got).any()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=LOG_ATOL,
                                   err_msg=f"N={N} T={T}")


def _run_bwd_sample(fn, A_t, mask_t, alpha_t, u_t, gate_t, sk_t):
    T, K, N = alpha_t.shape
    z = torch.full((T, N), -1, dtype=torch.int32)
    words = cs._map_words(K) * (-(-T // 32) * 32)
    scratch = (torch.zeros((N, words), dtype=torch.int32)
               if K <= 16 and words > cs._BWD_SMEM_MAX_WORDS else None)
    rc = fn(K, int(gate_t is not None), *map(_ptr, (A_t, mask_t, alpha_t, u_t, gate_t, sk_t, z,
                                                    scratch)), T, N, None)
    assert rc == 0
    return z


BWD_SAMPLE_CASES = [(1, (5, 75)), (1, (2, 2100)), (3, (5, 75)), (3, (2, 2100)), (16, (5, 75)), (16, (2, 1100)),
                    (20, (5, 75)), (33, (3, 75)), (64, (2, 40))]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("K,shape", BWD_SAMPLE_CASES)
def test_bwd_sample_source_matches_plain(emu, K, shape, gated):
    """``BWD_SAMPLE``, four-bit maps in shared memory or (T = 2100 at K =
    3, T = 1100 at K = 16) in the device scratch, byte maps a chunk at a
    time above 16; every draw identical, at T off the chunks and at T =
    1, with masked runs at both ends; the clamped A (as ``semiring_ffbs``
    hands it over) with a fifth of its entries at ``MASK_NEG``, and two
    lanes with an all -inf evidence row (zero-width buckets)."""
    N, T = shape
    for n_lanes, steps in ((N, T), (2, 1)):
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = _lanes(60 * K + gated + steps, n_lanes, steps,
                                                        K, gated=gated, decode=True)
        A_t = A_t.clamp_min(-1e30)
        _, alpha = cs.fwd_plain(pi_t, A_t, obs_t, mask_t, gate_t, sk_t)
        u_t = _lane_uniforms_off_edges(np.random.default_rng(K + steps), A_t, mask_t, alpha,
                                       gate_t, sk_t)
        got = _run_bwd_sample(emu["ffbs_bwd_sample"], A_t, mask_t, alpha, u_t, gate_t, sk_t)
        want = cs.bwd_sample_plain(A_t, mask_t, alpha, u_t, gate_t, sk_t)
        assert torch.equal(got, want), f"K={K} N={n_lanes} T={steps}"


def test_sources_repeat_bitwise(emu):
    """Two launches on the same inputs give the same bits: every sum has a
    fixed order (no atomics)."""
    for K in (5, 40):
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = _lanes(7, 6, 90, K, gated=True)
        ll, alpha = cs.fwd_plain(pi_t, A_t, obs_t, mask_t, gate_t, sk_t)
        a = _run_vg(emu["vg_bwd"], A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)
        b = _run_vg(emu["vg_bwd"], A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        assert torch.equal(_run_beta(emu["semiring_beta"], A_t, obs_t, mask_t),
                           _run_beta(emu["semiring_beta"], A_t, obs_t, mask_t))


def test_sources_refuse_k_outside_the_range(emu):
    pi_t, A_t, obs_t, mask_t, _, _ = _lanes(3, 2, 4, 2)
    out = torch.zeros(64)
    for K in (0, -1):
        assert emu["semiring_beta"](K, *map(_ptr, (A_t, obs_t, mask_t, obs_t)), 4, 2, None) == -1
        assert emu["vg_bwd"](K, 0, *map(_ptr, (A_t, obs_t, mask_t, obs_t, out, None, None)),
                             *map(_ptr, (out, out, out)), 4, 2, None) == -1
        assert emu["ffbs_bwd_sample"](K, 0, *map(_ptr, (A_t, mask_t, obs_t, out, None, None, out,
                                                        None)), 4, 2, None) == -1
