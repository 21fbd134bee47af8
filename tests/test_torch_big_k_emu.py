"""The semiring kernels' CUDA sources above K = 128 (`hhmm_tpu_torch/
kernels/csrc/big_core.cuh`, the big kernel of `ffbs_bwd_sample.cu` and
the 16-bit backtrack of `semiring_viterbi.cu`), compiled for the host
with `g++` over the warp emulation of `tests/cuda_warp_emu.h` (built by
`tests/cuda_emu.py`), against their plain versions on the same inputs.

This runs the big layout's own schedule: a block a lane, the lane's A
(and ``VG_BWD``'s d_A) in a stream-ordered scratch copied out of the lane
layout first, the step's vector in shared memory with one barrier a
step, byte map fields ORed across four threads up to K = 256 and 16-bit
fields across two above, the backward sampler's chunks shrinking with K,
and above K = 1024 a thread owning several states — at K in {129, 257}
on ragged lanes with masked runs at both ends, and at K = 1025 on one
lane of three steps. Max-plus is exact on the host too, so maps, dlast,
scores, paths and draws are held identical; the log-values and gradients
within the tolerances of the K <= 128 emulation tests (the host's
`expf` / `logf` are not the card's). On the card, `chip_smoke.py` holds
the same sources bitwise to the plain versions.
"""

import numpy as np
import pytest
import torch

from cuda_emu import build
from test_torch_backward_emu import GRAD_ATOL, GRAD_RTOL, _run_beta, _run_bwd_sample, _run_vg
from test_torch_forward_emu import _assert_logs_close, _lanes, _run_filter, _run_fwd, _run_viterbi
from test_torch_kernels import _lane_uniforms_off_edges
from hhmm_tpu_torch.kernels import cuda_semiring as cs

# (K, N, T): byte fields, 16-bit fields, and more states than threads
CASES = [(129, 2, 20), (257, 2, 11), (1025, 1, 3)]


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return build(cs.KERNELS, tmp_path_factory.mktemp("big_k_emu"))


@pytest.mark.parametrize("K,N,T", CASES)
def test_forward_sources_match_plain_above_128(emu, K, N, T):
    for gated in (False, True):
        lanes = _lanes(K + gated, N, T, K, gated=True)
        if not gated:
            lanes = lanes[:4] + (None, None)
        got = _run_fwd(emu["ffbs_fwd"], *lanes)
        want = cs.fwd_plain(*lanes)
        for name, g, w in zip(("ll", "alpha"), got, want):
            _assert_logs_close(g, w, f"FWD {name} gated={gated}")
    lanes = _lanes(3 * K, N, T, K, decode=True, ties=True)
    for name, g, w in zip(("ll", "alpha"), _run_filter(emu["semiring_filter"], *lanes),
                          cs.filter_plain(*lanes)):
        _assert_logs_close(g, w, f"FILTER {name}")
    score, dlast, back, path = _run_viterbi(emu, *lanes)
    w_score, w_dlast, w_back = cs.viterbi_plain(*lanes)
    assert torch.equal(back, w_back)
    assert torch.equal(dlast, w_dlast) and torch.equal(score, w_score)
    assert torch.equal(path, cs.backtrack_plain(w_back, w_dlast))


@pytest.mark.parametrize("K,N,T", CASES)
def test_backward_sources_match_plain_above_128(emu, K, N, T):
    for gated in (False, True):
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = _lanes(5 * K + gated, N, T, K, gated=True)
        if not gated:
            gate_t = sk_t = None
        ll, alpha = cs.fwd_plain(pi_t, A_t, obs_t, mask_t, gate_t, sk_t)
        got = _run_vg(emu["vg_bwd"], A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)
        want = cs.vg_bwd_plain(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)
        for name, g, w in zip(("d_pi", "d_A", "d_obs"), got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"VG_BWD {name} gated={gated}")
        A_c = A_t.clamp_min(-1e30)
        _, alpha = cs.fwd_plain(pi_t, A_c, obs_t, mask_t, gate_t, sk_t)
        u_t = _lane_uniforms_off_edges(np.random.default_rng(K), A_c, mask_t, alpha, gate_t, sk_t)
        z = _run_bwd_sample(emu["ffbs_bwd_sample"], A_c, mask_t, alpha, u_t, gate_t, sk_t)
        assert torch.equal(z, cs.bwd_sample_plain(A_c, mask_t, alpha, u_t, gate_t, sk_t))
    _, A_t, obs_t, mask_t = _lanes(7 * K, N, T, K, decode=True)
    got = _run_beta(emu["semiring_beta"], A_t, obs_t, mask_t)
    _assert_logs_close(got, cs.beta_plain(A_t, obs_t, mask_t), "BETA")
