"""The forward kernels' CUDA sources (`hhmm_tpu_torch/kernels/csrc/
ffbs_fwd.cu`, `semiring_filter.cu` and `semiring_viterbi.cu`, on
`fwd_core.cuh`, `wide_core.cuh` and `lane_group.cuh`), compiled for the
host with `g++` over a warp emulation (`tests/cuda_warp_emu.h`, built by
`tests/cuda_emu.py`: a thread per CUDA thread, barriers for the shuffles
and `__syncthreads`, a per-block buffer for dynamic shared memory; each
`cp.async` rewritten into a plain copy and its commit and wait into
nothing), against `fwd_plain`, `filter_plain`, `viterbi_plain` and
`backtrack_plain` on the same inputs.

This runs the kernels' own schedule — a group of threads a lane up to
K = 32 (the gathers, the ring filled in chunks with a checked partial
chunk, the masked step as a select, the map words ORed across the
group), a block a lane above (A in shared memory, the step's vector
exchanged there with one barrier a step, byte fields ORed across four
threads), and the backtrack's ring of map chunks in shared memory, its
chase (registers at K <= 16, a byte load above) and the coalesced copy
out, on 1 to 32 lanes a block — at K in {2, 3, 4, 5, 8, 12, 16,
17, 20, 32, 33, 64}, with masked runs at both ends of every lane, T off
the rings' chunks and T = 1, all -inf evidence rows and
``MASK_NEG``-sparse A, lanes whose max-plus scores tie exactly, and the
clamped filter gated and not. Max-plus is exact on the host too, so the
maps, dlast, the scores and the paths are held identical. The host's
`expf` / `logf` are not the card's nor torch's, so the filter is held
within a stated tolerance: a T-step recursion in f32 carries a few ulps
of its largest values (|log alpha| up to a few hundred at T = 256: 1e-4
absolute). On the card, `chip_smoke.py` holds the same sources bitwise
to the plain versions.
"""

import numpy as np
import pytest
import torch

from cuda_emu import build
from hhmm_tpu_torch.core.lmath import MASK_NEG
from hhmm_tpu_torch.kernels import cuda_semiring as cs

# a group of 2, 4, 8, 16 and 32 threads a lane (idle threads at K = 3, 5,
# 12, 17 and 20; two nibble words a step above 8, byte fields above 16),
# then a block a lane (two warps, idle threads at K = 33)
KS = (1, 2, 3, 4, 5, 8, 12, 16, 17, 20, 32, 33, 64)
LOG_ATOL = 1e-4  # log alpha: a few ulps of |log alpha| <= a few hundred
# (N, T): T off the 8-step chunk, T - 1 one full chunk, T = 256, T = 1
SHAPES = [(5, 75), (4, 9), (8, 256), (3, 1)]
WIDE_SHAPES = [(3, 75), (2, 9), (2, 1)]  # a block a lane: fewer lanes


def _shapes(K):
    return SHAPES if K <= 32 else WIDE_SHAPES


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The three sources built for the host over the warp emulation (the
    ``g++`` runs at once), their C entries bound with the wrappers'
    argument types."""
    return build((cs.FWD, cs.FILTER, cs.VITERBI, cs.BACKTRACK),
                 tmp_path_factory.mktemp("forward_emu"))


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
    """``FWD``, the clamped mode of the same cores, gated and not."""
    for N, T in _shapes(K):
        lanes = _lanes(50 * K + gated + T, N, T, K, gated=True)
        if not gated:
            lanes = lanes[:4] + (None, None)
        ll, alpha = _run_fwd(emu["ffbs_fwd"], *lanes)
        ll_p, alpha_p = cs.fwd_plain(*lanes)
        _assert_logs_close(alpha, alpha_p, f"alpha N={N} T={T}")
        _assert_logs_close(ll, ll_p, f"ll N={N} T={T}")


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("K", KS)
def test_filter_source_matches_plain(emu, K, decode):
    for N, T in _shapes(K):
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
@pytest.mark.parametrize("K", KS)
def test_viterbi_source_matches_plain(emu, K, case):
    for N, T in _shapes(K):
        lanes = _lanes(40 * K + len(case) + T, N, T, K, decode=case == "decode",
                       ties=case == "ties")
        score, dlast, back, path = _run_viterbi(emu, *lanes)
        score_p, dlast_p, back_p = cs.viterbi_plain(*lanes)
        what = f"K={K} {case} N={N} T={T}"
        assert torch.equal(back, back_p), what
        assert torch.equal(dlast, dlast_p), what
        assert torch.equal(score, score_p), what
        assert torch.equal(path, cs.backtrack_plain(back_p, dlast_p)), what


def _random_maps(rng, T, K, N):
    """Packed maps of uniform random pointers, identity maps on a masked
    run at each lane's end, and a ``dlast`` with exact ties."""
    ptr = torch.as_tensor(rng.integers(0, K, size=(T, K, N)))
    for n in range(N):
        ptr[rng.integers(T // 2, T + 1):, :, n] = torch.arange(K)
    back = torch.stack([cs._pack(ptr[t]) for t in range(T)]).view(cs._map_shape(T, K, N))
    dlast = torch.as_tensor(np.round(rng.normal(size=(K, N))), dtype=torch.float32)
    return back.contiguous(), dlast


@pytest.mark.parametrize("K", [1, 3, 8, 9, 16, 20, 33, 64, 128])
def test_backtrack_source_matches_plain(emu, K):
    """``BACKTRACK`` alone on random maps: nibble words in registers (one
    word a step up to K = 8, two up to 16), byte loads above; 1 to 32
    lanes a block (N = 1, 9, 17, 40, 70, 128, 130 over the emulation's
    four SMs; 8 at K = 128 from N = 128, where 32 would pass the ring's
    100 KB; 16-byte copies and stores at N = 40 and 128),
    T off the 32- and 64-step chunks, one chunk and one step past it, and
    T = 1 and 2."""
    rng = np.random.default_rng(K)
    for N in (1, 9, 17, 40, 70, 128, 130):
        for T in (1, 2, 33, 65, 70):
            back, dlast = _random_maps(rng, T, K, N)
            path = torch.full((T, N), -1, dtype=torch.int32)
            rc = emu["viterbi_backtrack"](K, *map(_ptr, (back, dlast, path)), T, N, None)
            assert rc == 0
            assert torch.equal(path, cs.backtrack_plain(back, dlast)), f"K={K} N={N} T={T}"


@pytest.mark.parametrize("K", [12, 20, 40])
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


@pytest.mark.parametrize("K", [5, 40])
def test_sources_repeat_bitwise(emu, K):
    """Two launches on the same inputs give the same bits: every sum has a
    fixed order and every map word a fixed OR (no atomics)."""
    lanes = _lanes(7, 6, 90, K, decode=True)
    a, b = _run_filter(emu["semiring_filter"], *lanes), _run_filter(emu["semiring_filter"], *lanes)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    a, b = _run_viterbi(emu, *lanes), _run_viterbi(emu, *lanes)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_sources_refuse_k_outside_the_range(emu):
    pi_t, A_t, obs_t, mask_t = _lanes(3, 2, 4, 2)
    out = torch.zeros(64)
    for K in (0, -1):
        assert emu["semiring_filter"](K, *map(_ptr, (pi_t, A_t, obs_t, mask_t, out, out)),
                                      4, 2, None) == -1
        assert emu["viterbi_fwd"](K, *map(_ptr, (pi_t, A_t, obs_t, mask_t, out, out, out)),
                                  4, 2, None) == -1
        assert emu["viterbi_backtrack"](K, *map(_ptr, (out, out, out)), 4, 2, None) == -1
        assert emu["ffbs_fwd"](K, 0, *map(_ptr, (pi_t, A_t, obs_t, mask_t, None, None, out, out)),
                               4, 2, None) == -1
