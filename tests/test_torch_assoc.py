"""The port's time-parallel scans (``hhmm_tpu_torch/kernels/assoc.py``)
against the JAX package's (``hhmm_tpu/kernels/assoc.py``) on the same
numpy inputs, against ``tests/oracle.py`` in float64, and against the
port's own sequential scans and the kernels' plain versions.

- every entry at K in {1, 2, 4, 9}, homogeneous and time-varying, with
  and without a ragged mask, against the JAX entry (vmapped over the
  series): log-values within rtol 1e-6 + atol 1e-5, -inf at the same
  places, Viterbi paths identical;
- float64 against the oracle within 1e-10 (smoothing against brute-force
  path enumeration where K^T is small), and against the JAX entries
  under ``jax.enable_x64(True)``;
- against the port's scans (``filtering.py``, ``viterbi.py``) and, for a
  homogeneous ``log_A``, the kernels' plain versions;
- FFBS draws, ungated and gated, identical to the JAX ``ffbs_assoc`` and
  to ``ffbs_invcdf_reference`` given the same uniforms; the uniforms are
  redrawn until every step's lies at least ``EDGE`` from a CDF edge of
  the reference's draw, and ``ffbs_assoc_sample`` draws what
  ``ffbs_fused`` draws from the same generator;
- the scan's combine tree is JAX's (bitwise on a max-plus product, where
  the order of the additions decides the rounding), the reversed scan
  keeps the operand order, all -inf rows give -inf and no NaN, lane
  blocking changes no bit, and ``forward_filter_seqshard`` over 1, 2
  and 4 CPU shards agrees with ``forward_filter_assoc``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import oracle
import pytest
import torch

from hhmm_tpu.kernels import assoc as ja
from hhmm_tpu.kernels.semiring import maxplus_matmul as j_maxplus
from hhmm_tpu_torch.kernels import assoc as ta
from hhmm_tpu_torch.kernels import cuda_semiring as cs
from hhmm_tpu_torch.kernels import filtering as tf
from hhmm_tpu_torch.kernels.ffbs import ffbs_fused, ffbs_invcdf_reference
from hhmm_tpu_torch.kernels.semiring import compose_maps, maxplus_matmul
from hhmm_tpu_torch.kernels.viterbi import viterbi as t_viterbi

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-5
EDGE = 1e-4  # the least distance of a uniform from an inverse-CDF edge
B, T = 3, 21  # T odd: the scan's odd and even branches both taken
KS = (1, 2, 4, 9)


def _log_norm(a):
    return a - np.log(np.exp(a).sum(-1, keepdims=True))


def _case(rng, K, *, tv=False, masked=True, b=B, t=T, dtype=np.float32):
    log_pi = _log_norm(rng.normal(size=(b, K)))
    shape = (b, t - 1, K, K) if tv else (b, K, K)
    log_A = _log_norm(rng.normal(size=shape))
    log_obs = rng.normal(size=(b, t, K)) - 1.0
    mask = None
    if masked:
        lengths = rng.integers(t // 2, t + 1, size=b)
        mask = (np.arange(t)[None, :] < lengths[:, None]).astype(dtype)
        mask[0, 0] = 0.0  # a masked first step
    return tuple(None if a is None else a.astype(dtype) for a in (log_pi, log_A, log_obs, mask))


def _t(args):
    return tuple(None if a is None else torch.as_tensor(a) for a in args)


_JITTED = {}


def _jax(fn, *args):
    """A JAX single-series entry over the series axis of numpy args
    (jitted: one compile a shape instead of one a primitive)."""
    n = len(args)
    while n and args[n - 1] is None:
        n -= 1
    key = (fn, n)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(jax.vmap(fn))
    out = _JITTED[key](*(jnp.asarray(a) for a in args[:n]))
    return jax.tree_util.tree_map(np.asarray, out)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert not np.isnan(got).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "ragged"])
@pytest.mark.parametrize("tv", [False, True], ids=["homogeneous", "time_varying"])
@pytest.mark.parametrize("K", KS)
def test_entries_match_jax_assoc(K, tv, masked):
    rng = np.random.default_rng(100 * K + 10 * tv + masked)
    args = _case(rng, K, tv=tv, masked=masked)
    # smoothing holds the filter and the beta pass (the JAX smooth_assoc
    # runs forward_filter_assoc and backward_assoc): one compile for three
    la, ll = ta.forward_filter_assoc(*_t(args))
    lb = ta.backward_assoc(*_t(args[1:]))
    smooth = ta.smooth_assoc(*_t(args))
    assert torch.equal(smooth[0], la) and torch.equal(smooth[1], lb) and torch.equal(smooth[3], ll)
    for got, want in zip(smooth, _jax(ja.smooth_assoc, *args)):
        _close(got, want)
    path, score = ta.viterbi_assoc(*_t(args))
    jpath, jscore = _jax(ja.viterbi_assoc, *args)
    assert path.dtype == torch.int64
    np.testing.assert_array_equal(path.numpy(), jpath)
    _close(score, jscore)


def _oracle_case(rng, K, tv, t):
    log_pi, log_A, log_obs = oracle.random_hmm(rng, K, t, time_varying=tv)
    return log_pi, log_A, log_obs


@pytest.mark.parametrize("tv", [False, True], ids=["homogeneous", "time_varying"])
@pytest.mark.parametrize("K", KS)
def test_f64_matches_the_oracle_and_jax_x64(K, tv):
    rng = np.random.default_rng(7 + K + 50 * tv)
    t = 6 if K <= 4 else 9
    lp, lA, lo = _oracle_case(rng, K, tv, t)
    args = _t((lp, lA, lo))
    la, ll = ta.forward_filter_assoc(*args)
    ola, oll = oracle.forward_np(lp, lA, lo)
    np.testing.assert_allclose(la.numpy(), ola, rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(ll), oll, rtol=0, atol=1e-10)
    lb = ta.backward_assoc(*args[1:])
    np.testing.assert_allclose(lb.numpy(), oracle.backward_np(lA, lo), rtol=0, atol=1e-10)
    _, _, lg, _ = ta.smooth_assoc(*args)
    want = (oracle.smoothing_marginals_brute(lp, lA, lo) if K ** t <= 5000
            else oracle.smooth_np(ola, oracle.backward_np(lA, lo)))
    np.testing.assert_allclose(lg.numpy(), want, rtol=0, atol=1e-10)
    path, score = ta.viterbi_assoc(*args)
    opath, oscore = oracle.viterbi_np(lp, lA, lo)
    np.testing.assert_array_equal(path.numpy(), opath)
    np.testing.assert_allclose(float(score), oscore, rtol=0, atol=1e-10)
    with jax.enable_x64(True):
        jla, jll = jax.jit(ja.forward_filter_assoc)(jnp.asarray(lp), jnp.asarray(lA), jnp.asarray(lo))
        assert jla.dtype == jnp.float64
        np.testing.assert_allclose(la.numpy(), np.asarray(jla), rtol=0, atol=1e-10)


@pytest.mark.parametrize("tv", [False, True], ids=["homogeneous", "time_varying"])
@pytest.mark.parametrize("K", (2, 4, 9))
def test_match_the_scans_and_the_plain_versions(K, tv):
    rng = np.random.default_rng(300 + K + tv)
    args = _t(_case(rng, K, tv=tv))
    ref = tf.forward_backward(*args)
    for got, want in zip(ta.smooth_assoc(*args), ref):
        _close(got, want)
    path, score = ta.viterbi_assoc(*args)
    spath, sscore = t_viterbi(*args)
    assert torch.equal(path, spath)
    _close(score, sscore)
    if not tv:  # the kernels' plain versions take a homogeneous log_A
        la, ll = cs.semiring_filter(*args)
        _close(ta.forward_filter_assoc(*args)[0], la)
        _close(ta.backward_assoc(*args[1:]), cs.semiring_beta(*args[1:]))
        kpath, _ = cs.semiring_viterbi(*args)
        assert torch.equal(path, kpath)


def _uniforms_off_edges(rng, lp, lA, lo, mask, gk=None, sk=None):
    """Uniforms ``u [B, T]`` redrawn until every step's lies at least
    ``EDGE`` from a CDF edge of ``ffbs_invcdf_reference``'s draw there
    (masked steps too: every form draws them)."""
    b, t, K = lo.shape
    u = torch.from_numpy(rng.random((b, t)).astype(np.float32))
    if K == 1:
        return u
    if gk is None:
        la, _ = tf.forward_filter(lp, lA, lo, mask)
    else:
        c = gk[..., :, None] == sk[..., None, :]
        la, _ = tf.forward_filter(lp, torch.where(c[:, 1:, None, :], lA[:, None], 0.0), lo, mask)
    for _ in range(100):
        z, _ = ffbs_invcdf_reference(lp, lA, lo, mask, u, gk, sk)
        logits = la.double().clone()
        for s in range(t - 1):
            g = mask[:, s + 1] > 0
            if gk is not None:
                g = g & (gk[:, s + 1] == sk.gather(-1, z[:, s + 1, None])[:, 0])
            col = lA.gather(-1, z[:, s + 1, None, None].expand(b, K, 1))[..., 0].double()
            logits[:, s] = torch.where(g[:, None], logits[:, s] + col, logits[:, s])
        cum = torch.cumsum(torch.softmax(logits, -1)[..., :-1], -1)
        near = (cum - u.double()[..., None]).abs().amin(-1) < EDGE
        if not near.any():
            return u
        u[near] = torch.from_numpy(rng.random(int(near.sum())).astype(np.float32))
    raise AssertionError("could not draw uniforms away from the CDF edges")


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("K", KS)
def test_ffbs_draws_match_jax_and_the_reference(K, gated):
    rng = np.random.default_rng(500 + K + gated)
    lp, lA, lo, mask = _case(rng, K)
    gk = sk = None
    if gated:
        gk = rng.integers(0, 2, size=(B, T)).astype(np.float32)
        sk = np.tile(np.resize([1.0, 0.0, 0.0, 1.0], K).astype(np.float32), (B, 1))
    targs = _t((lp, lA, lo, mask, gk, sk))
    u = _uniforms_off_edges(rng, *targs)
    z, ll = ta.ffbs_assoc(*targs[:4], u, *targs[4:])
    zr, llr = ffbs_invcdf_reference(*targs[:4], u, *targs[4:])
    assert z.dtype == torch.int64 and torch.equal(z, zr)
    _close(ll, llr)
    jz, jll = _jax(ja.ffbs_assoc, lp, lA, lo, mask, u.numpy(), gk, sk)
    np.testing.assert_array_equal(z.numpy(), jz)
    _close(ll, jll)
    # the generator convention: the draws ffbs_fused makes from the same state
    gen = lambda: torch.Generator().manual_seed(K)  # noqa: E731
    za, _ = ta.ffbs_assoc_sample(gen(), *targs)
    zf, _ = ffbs_fused(gen(), *targs)
    assert torch.equal(za, zf)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 33])
def test_scan_combine_tree_is_jax_s(n):
    """``_scan`` is ``jax.lax.associative_scan``'s recursion: bitwise on
    a max-plus matrix product (f32 additions, rounded in the order the
    tree takes them), and the reversed scan keeps the operand order."""
    rng = np.random.default_rng(n)
    M = (rng.normal(size=(n, 3, 3)) * 1e3).astype(np.float32)
    got = ta._scan(maxplus_matmul, torch.as_tensor(M)[None])[0]
    want = np.asarray(jax.jit(lambda m: jax.lax.associative_scan(j_maxplus, m, axis=0))(M))
    np.testing.assert_array_equal(got.numpy(), want)
    maps = torch.as_tensor(rng.integers(0, 4, size=(1, n, 4)))
    suffix = ta._suffix_scan(compose_maps, maps)[0]
    for s in range(n):  # out[s] = maps[s] o maps[s+1] o ... o maps[-1]
        comp = maps[0, n - 1]
        for r in range(n - 2, s - 1, -1):
            comp = maps[0, r][comp]
        assert torch.equal(suffix[s], comp)


@pytest.mark.parametrize("K", (2, 4))
def test_all_neg_inf_rows_give_neg_inf_not_nan(K):
    """Impossible evidence at a valid step and a transition column of -inf:
    the guarded combines give -inf and no NaN, where the scans do."""
    rng = np.random.default_rng(900 + K)
    lp, lA, lo, mask = _case(rng, K, masked=False)
    lo[0, 5] = -np.inf
    lA[1, :, 0] = -np.inf
    args = _t((lp, lA, lo, mask))
    ref = tf.forward_backward(*args)
    for got, want in zip(ta.smooth_assoc(*args), ref):
        assert not torch.isnan(got).any()
        _close(got, want)
    assert bool(torch.isneginf(ta.forward_filter_assoc(*args)[1][0]))
    path, _ = ta.viterbi_assoc(*args)
    assert torch.equal(path[1:], t_viterbi(*args)[0][1:])


@pytest.mark.parametrize("tv", [False, True], ids=["homogeneous", "time_varying"])
def test_lane_blocking_is_bitwise(tv, monkeypatch):
    rng = np.random.default_rng(77)
    args = _t(_case(rng, 4, tv=tv, b=5))
    u = torch.from_numpy(rng.random((5, T)).astype(np.float32))
    full = (ta.smooth_assoc(*args), ta.viterbi_assoc(*args))
    if not tv:
        full += (ta.ffbs_assoc(*args, u),)
    monkeypatch.setattr(ta, "_COMBINE_BYTES", 64 * 4 * 3)  # three rows a combine, one lane a block
    blocked = (ta.smooth_assoc(*args), ta.viterbi_assoc(*args))
    if not tv:
        blocked += (ta.ffbs_assoc(*args, u),)
    for a, b in zip(full, blocked):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("batched", [False, True], ids=["one_series", "series_axis"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_seqshard_matches_the_assoc_filter(shards, batched):
    rng = np.random.default_rng(40 + shards)
    lp, lA, lo, mask = _t(_case(rng, 3, t=32))
    if not batched:
        lp, lA, lo, mask = lp[1], lA[1], lo[1], mask[1]
    la, ll = ta.forward_filter_seqshard(lp, lA, lo, mask, devices=["cpu"] * shards)
    wa, wl = ta.forward_filter_assoc(lp, lA, lo, mask)
    assert la.shape == wa.shape and ll.shape == wl.shape
    _close(la, wa)
    _close(ll, wl)


def test_seqshard_and_ffbs_refuse_what_jax_refuses():
    rng = np.random.default_rng(3)
    lp, lA, lo, mask = _t(_case(rng, 3, t=30))
    with pytest.raises(ValueError, match="divisible"):
        ta.forward_filter_seqshard(lp, lA, lo, mask, devices=["cpu"] * 4)
    tv = lA[:, None].expand(B, 29, 3, 3)
    with pytest.raises(ValueError, match="homogeneous"):
        ta.forward_filter_seqshard(lp[0], tv[0], lo[0], mask[0], devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="homogeneous"):
        ta.ffbs_assoc(lp, tv, lo, mask, torch.rand(B, 30))
    with pytest.raises(ValueError, match="together"):
        ta.ffbs_assoc(lp, lA, lo, mask, torch.rand(B, 30), gate_key=mask)
    with pytest.raises(ValueError, match="T-1=29"):
        ta.forward_filter_assoc(lp, tv[:, :5], lo, mask)
    # T = 1: no transition to take, a time-varying kernel of any length
    one = ta.forward_filter_assoc(lp, tv[:, :3], lo[:, :1], mask[:, :1])
    assert one[0].shape == (B, 1, 3)
