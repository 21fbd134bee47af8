"""The seven semiring kernels above K = 128 on the card, each bitwise
against its plain version on the same CUDA tensors (8 lanes, T = 40,
ragged masks, ``MASK_NEG``-sparse A clamped at -1e30 as ``semiring_ffbs``
hands it over): byte map fields (129, 180), 16-bit fields (257) and more
states than a block's 1024 threads (1025). Skipped without a card; this
file imports no JAX (``tests/test_torch_big_k.py`` holds the plain
versions to the JAX package on the CPU)."""

import numpy as np
import pytest
import torch

from hhmm_tpu_torch.core.lmath import MASK_NEG
from hhmm_tpu_torch.kernels import cuda_semiring as cs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _lanes(seed, N, T, K, device):
    rng = np.random.default_rng(seed)

    def log_norm(a):
        return a - np.log(np.exp(a).sum(-1, keepdims=True))

    log_A = log_norm(rng.normal(size=(N, K, K)))
    log_A[rng.random((N, K, K)) < 0.2] = MASK_NEG
    valid = np.arange(T)[None, :] < rng.integers(T // 2, T + 1, size=N)[:, None]
    f32 = dict(dtype=torch.float32, device=device)
    lanes = cs.to_lanes(torch.as_tensor(log_norm(rng.normal(size=(N, K))), **f32),
                        torch.as_tensor(log_A, **f32).clamp_min(-1e30),
                        torch.as_tensor(rng.normal(size=(N, T, K)) - 1.0, **f32),
                        torch.as_tensor(valid, **f32))
    return lanes[:4], torch.as_tensor(rng.random((T, N)), **f32)


def _same(got, want):
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    torch.cuda.synchronize()
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [129, 180, 257, 1025])
def test_cuda_kernels_match_plain_above_128(cuda_device, K):
    (pi_t, A_t, obs_t, mask_t), u_t = _lanes(K, 8, 40, K, cuda_device)
    before = [k.launches for k in cs.KERNELS]
    ll, alpha = cs.fwd_plain(pi_t, A_t, obs_t, mask_t)
    assert _same(cs.fwd_lanes(pi_t, A_t, obs_t, mask_t), (ll, alpha))
    assert _same(cs.bwd_sample_lanes(A_t, mask_t, alpha, u_t),
                 cs.bwd_sample_plain(A_t, mask_t, alpha, u_t))
    assert _same(cs.vg_bwd_lanes(A_t, obs_t, mask_t, alpha, ll),
                 cs.vg_bwd_plain(A_t, obs_t, mask_t, alpha, ll))
    assert _same(cs.filter_lanes(pi_t, A_t, obs_t, mask_t),
                 cs.filter_plain(pi_t, A_t, obs_t, mask_t))
    assert _same(cs.beta_lanes(A_t, obs_t, mask_t), cs.beta_plain(A_t, obs_t, mask_t))
    score, dlast, back = cs.viterbi_plain(pi_t, A_t, obs_t, mask_t)
    assert _same(cs.viterbi_lanes(pi_t, A_t, obs_t, mask_t), (score, dlast, back))
    assert _same(cs.backtrack_lanes(back, dlast), cs.backtrack_plain(back, dlast))
    assert [k.launches - b for k, b in zip(cs.KERNELS, before)] == [1] * 7
