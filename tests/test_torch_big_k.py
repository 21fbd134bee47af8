"""The port above K = 128 — every semiring plain version at K in {129,
180, 257} (T <= 16, two series) and at K = 1025 — against the JAX
package on the same numpy inputs, with the helpers and tolerances of
``tests/test_torch_decode.py`` and ``tests/test_torch_vg.py``:

- the filter, beta and Viterbi plain versions (``semiring_filter``,
  ``semiring_beta``, ``semiring_viterbi`` and the decode dispatch)
  against the JAX dispatch entries on their scans: log-values within
  rtol 1e-6 + atol 1e-5 with -inf at the same places, paths and scores
  identical;
- the value-and-grad pair (``FWD`` + ``VG_BWD``, gated and not) against
  the JAX ``forward_value_and_grad``;
- ``semiring_ffbs`` (``FWD`` + ``BWD_SAMPLE``) draw for draw against the
  JAX ``ffbs_invcdf_reference`` given the same uniforms, redrawn off the
  inverse-CDF edges;
- ``GaussianHMM(180).generated`` at T = 16 against the JAX ``generated`` (zstar
  identical, probabilities within 5e-4 and no farther from the float64
  oracle than 1.5 times the JAX package's distance);
- at K = 1025, T = 4, the filter, beta and Viterbi plain versions in
  float64 against ``tests/oracle.py``;
- the 16-bit map layout (above K = 256) through ``viterbi_plain``,
  ``unpack_back`` and ``backtrack_plain``.

The CUDA kernels themselves at these K are held bitwise to the plain
versions by the ``cuda``-marked tests of ``tests/test_torch_big_k_cuda.py``
(skipped without a card) and by ``chip_smoke.py``'s ``big_k`` phase, and
their sources run over the host emulation in
``tests/test_torch_big_k_emu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode import (
    LL_RTOL,
    _assert_logs_close,
    _case,
    _check_generated_gaussian_k,
    _np_maps,
    _t,
)
from test_torch_kernels import _lane_uniforms_off_edges
from test_torch_vg import _assert_vg_close, _batch, _j_args
from test_torch_vg import _t as _vg_t

import oracle
from hhmm_tpu.kernels import dispatch as jd
from hhmm_tpu.kernels.ffbs import ffbs_invcdf_reference as j_ffbs_reference
from hhmm_tpu.kernels.vg import forward_value_and_grad as j_fvg
from hhmm_tpu_torch.kernels import cuda_semiring as cs
from hhmm_tpu_torch.kernels import dispatch as td
from hhmm_tpu_torch.kernels import forward_value_and_grad

torch.set_num_threads(1)

KS = [129, 180, 257]  # byte map fields, the HSMM's K' = 3 x 60, 16-bit fields
B, T = 2, 12


def _jax_seq(fn, *args):
    """A JAX dispatch entry on its sequential scan, vmapped over series."""
    return jax.vmap(lambda *a: fn(*a, time_parallel="seq"))(*(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("K", KS)
def test_decode_plain_versions_match_jax(rng, K):
    args = _case(rng, B, T, K, neg_inf=True, sparse=True)
    la, ll = cs.semiring_filter(*_t(args))
    jla, jll = _jax_seq(jd.forward_filter_dispatch, *args)
    _assert_logs_close(la.numpy(), jla)
    _assert_logs_close(ll.numpy(), jll)
    lb = cs.semiring_beta(*_t(args[1:]))
    _assert_logs_close(lb.numpy(), _jax_seq(jd.backward_dispatch, *args[1:]))
    path, score = cs.semiring_viterbi(*_t(args))
    jpath, jscore = _jax_seq(jd.viterbi_dispatch, *args)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    dpath, dscore = td.viterbi_dispatch(*_t(args))
    np.testing.assert_array_equal(dpath.numpy(), np.asarray(jpath))
    np.testing.assert_array_equal(dscore.numpy(), np.asarray(jscore))


@pytest.mark.parametrize("K", KS)
def test_value_and_grad_matches_jax(rng, K):
    for gated in (False, True):
        d = _batch(rng, B, T, K, gated)
        _assert_vg_close(forward_value_and_grad(**_vg_t(d)), jax.vmap(j_fvg)(*_j_args(d)))


@pytest.mark.parametrize("K", KS)
def test_ffbs_draw_for_draw_matches_jax(rng, K):
    args = _case(rng, B, T, K)
    log_pi, log_A, log_obs, mask = _t(args)
    pi_t, A_t, obs_t, mask_t, _, _ = cs.to_lanes(log_pi, log_A.clamp_min(-1e30), log_obs, mask)
    _, alpha_t = cs.fwd_plain(pi_t, A_t, obs_t, mask_t)
    u = _lane_uniforms_off_edges(rng, A_t, mask_t, alpha_t, None, None).t().contiguous().numpy()
    z, ll = cs.semiring_ffbs(*_t(args), torch.from_numpy(u))
    for b in range(B):
        rz, rll = j_ffbs_reference(*(jnp.asarray(a[b]) for a in args), jnp.asarray(u[b]))
        np.testing.assert_array_equal(z[b].numpy(), np.asarray(rz))
        np.testing.assert_allclose(float(ll[b]), float(rll), rtol=LL_RTOL)


def test_generated_gaussian_k180_matches_jax(rng):
    _check_generated_gaussian_k(rng, 180, "seq", T=16)


def test_k1025_plain_versions_match_oracle_f64(rng):
    """More states than a block has threads on the card: the filter, beta
    and Viterbi plain versions in float64 against the numpy oracle."""
    K, steps = 1025, 4
    lp, lA, lo = oracle.random_hmm(rng, K, steps)
    args = _t((lp[None], lA[None], lo[None], np.ones((1, steps))), torch.float64)
    la, ll = cs.semiring_filter(*args)
    ra, rll = oracle.forward_np(lp, lA, lo)
    np.testing.assert_allclose(la[0].numpy(), ra, rtol=1e-12, atol=1e-11)
    np.testing.assert_allclose(float(ll[0]), rll, rtol=1e-12)
    lb = cs.semiring_beta(*args[1:])
    np.testing.assert_allclose(lb[0].numpy(), oracle.backward_np(lA, lo), rtol=1e-12, atol=1e-11)
    path, score = cs.semiring_viterbi(*args)
    rpath, rscore = oracle.viterbi_np(lp, lA, lo)
    np.testing.assert_array_equal(path[0].numpy(), rpath)
    np.testing.assert_allclose(float(score[0]), rscore, rtol=1e-12)


@pytest.mark.parametrize("K", [256, 257, 300])
def test_map_layout_round_trips(rng, K):
    """Byte fields up to K = 256, 16-bit fields above (P = 2 states a
    word, W = ceil(K / 2)): the Viterbi maps unpack to numpy's first-argmax
    backpointers, and the backtrack chases them to the JAX scan's path."""
    args = _case(rng, B, T, K, sparse=True)
    pi_t, A_t, obs_t, mask_t, _, _ = cs.to_lanes(*_t(args))
    score, dlast, back = cs.viterbi_plain(pi_t, A_t, obs_t, mask_t)
    assert cs._map_bits(K) == (8 if K <= 256 else 16)
    assert back.shape == (T, -(-K // (4 if K <= 256 else 2)), B) and back.dtype == torch.int32
    np.testing.assert_array_equal(cs.unpack_back(back, K).permute(2, 0, 1).numpy(),
                                  _np_maps(*args))
    ptr = torch.from_numpy(rng.integers(0, K, size=(K, B)))
    assert torch.equal(cs.unpack_back(cs._pack(ptr)[None], K)[0], ptr)
    jpath, _ = _jax_seq(jd.viterbi_dispatch, *args)
    np.testing.assert_array_equal(cs.backtrack_plain(back, dlast).t().numpy(), np.asarray(jpath))
