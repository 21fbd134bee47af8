"""The PyTorch port's decode path — the guarded filter, beta, Viterbi and
backtrack kernels' plain versions, their JAX-layout entries, the decode
dispatch and ``BaseHMMModel.generated`` / ``state_draws`` — against the
JAX package on the same numpy inputs.

- ``filter_plain`` / ``beta_plain`` / ``viterbi_plain`` +
  ``backtrack_plain`` through ``semiring_filter`` / ``semiring_beta`` /
  ``semiring_viterbi``, against the JAX ``semiring_*`` entries run in
  interpret mode through ``hhmm_tpu.kernels.dispatch`` (as
  ``tests/test_pallas_semiring.py`` runs them) and against the JAX
  scans, at K in {2, 3, 4, 8} with ragged masks, all -inf evidence rows,
  ``MASK_NEG``-sparse transitions and exact max-plus ties. Log-values
  within rtol 1e-6 + atol 1e-5 (the exponentials are summed in another
  order), -inf at identical places, no NaN; Viterbi paths and scores
  identical (max-plus has no summation order);
- the packed backpointer maps against a numpy first-argmax;
- in float64, the plain versions against ``tests/oracle.py`` within
  1e-10 (smoothing against brute-force path enumeration);
- ``generated`` of the hard-gate Tayal HHMM and of the Gaussian HMM
  (K=3) against the JAX ``generated`` on its pallas and seq routes:
  alpha and gamma within 1e-5, zstar identical, loglik and logp_zstar
  within rtol 1e-5; ``state_draws`` marginals against gamma within 4
  Monte Carlo standard errors;
- K from 5 to 16 (above 8 the maps take two int32 words a step): the
  plain versions against the JAX ``semiring_*`` entries and scans,
  ``viterbi_plain`` + ``backtrack_plain`` at every K in 9..16 against
  ``kernels/viterbi.py::viterbi``, the numpy first-argmax maps and, in
  float64, ``tests/oracle.py``; ``GaussianHMM(K).generated`` against the
  JAX ``generated`` and ``state_draws`` against the JAX FFBS reference on
  the same uniforms, at K in {5, 9, 12, 16}; every entry raises for K
  above 128, on the CPU route and on the card, K = 1 on the card only;
- K from 17 to 128 (byte-wide map fields, up to 32 words a step; on the
  card a block a lane above 32): the plain versions against the JAX
  pallas branch (K 20 and 32 here, the rest in
  ``tests/test_torch_wide_k.py``), the numpy maps and the float64
  oracle; the decode dispatch's plain versions against the port's
  scans; ``GaussianHMM(K).generated`` at K in {17, 20} here (24 to 128
  in ``test_torch_wide_k.py``) against the JAX ``generated`` on its
  pallas and seq routes (zstar identical, loglik within rtol 1e-5,
  probabilities within 7e-5, 5e-4 from K = 33, and no farther from the
  float64 oracle than the JAX package's, from K = 24 within 1.5 times
  its distance); T <= 32 and two series from K = 33 on;
- ``smooth_dispatch`` on one lane-layout copy: bitwise the two entries
  called apart;
- routing: the CPU runs the plain versions, a time-varying ``log_A``
  the scans, a CUDA operand the kernels (or a raise), mixed devices and
  non-float32 CUDA operands raise; ``cuda``-marked cases launch each
  kernel and skip without a card.
"""

import jax
import jax.numpy as jnp
import contextlib

import numpy as np
import oracle
import pytest
import torch

from hhmm_tpu.kernels import dispatch as jd
from hhmm_tpu.kernels.filtering import backward_pass as j_backward_pass
from hhmm_tpu.kernels.filtering import forward_backward as j_forward_backward
from hhmm_tpu.kernels.ffbs import ffbs_invcdf_reference as j_ffbs_reference
from hhmm_tpu.kernels.filtering import forward_filter as j_forward_filter
from hhmm_tpu.kernels.viterbi import viterbi as j_viterbi
from hhmm_tpu.models import GaussianHMM as JGaussianHMM
from hhmm_tpu.models import TayalHHMM as JTayalHHMM
from hhmm_tpu_torch.core.lmath import MASK_NEG
from hhmm_tpu_torch.kernels import cuda_build
from hhmm_tpu_torch.kernels import cuda_semiring as cs
from hhmm_tpu_torch.kernels import dispatch as td
from hhmm_tpu_torch.kernels import filtering as tf
from hhmm_tpu_torch.kernels.viterbi import viterbi as t_viterbi
from hhmm_tpu_torch.models import GaussianHMM, TayalHHMM
from hhmm_tpu_torch.sim import tayal_batch

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-5  # log-values: exponentials summed in another order
PROB_ATOL = 1e-5
# K >= 9: the f32 filtered and smoothed probabilities of either package
# are up to 1.5e-5 off the float64 oracle (T = 30), so the two packages
# differ by up to twice that; the port is held to be no farther from the
# oracle than the JAX package, within WIDE_ORACLE_SLACK
WIDE_PROB_ATOL, WIDE_ORACLE_SLACK = 3e-5, 1e-6
# K > 16: at K = 20 either package's gamma is up to 3.1e-5 off the
# float64 oracle (T = 30), in opposite directions (6.0e-5 apart), so the
# packages are held within twice that plus a margin, and the port again
# no farther from the oracle than the JAX one
WIDEST_PROB_ATOL = 7e-5
# K >= 33: at T = 30 either package's gamma is up to 2.5e-4 off the
# float64 oracle (K = 128; 2.1e-4 at K = 64), and the two packages differ
# by up to 2.4e-4 (K = 64): the limit is twice that, with the oracle
# check as above
WIDER_PROB_ATOL = 5e-4
# K >= 24 (the cases of the K = 128 range): the port's largest error off
# the oracle within 1.5 times the JAX package's, plus WIDE_ORACLE_SLACK.
# Each sums its exponentials in another order, so which is the closer is
# a matter of rounding: over three seeds at K in {17, 20, 24, 33, 64, 128}
# and both routes the ratio reached 1.27 (K = 17), 1.12 from K = 24 on
WIDER_ORACLE_RATIO = 1.5
LL_RTOL = 1e-5


def _log_norm(a):
    return a - np.log(np.exp(a).sum(-1, keepdims=True))


def _case(rng, B, T, K, *, ragged=True, neg_inf=False, sparse=False, ties=False):
    """Numpy f32 ``(log_pi, log_A, log_obs, mask)``: normalized (pi, A),
    N(-1, 1) emissions, prefix masks of lengths in [T/2, T]. ``sparse``
    sets about a fifth of the A entries to ``MASK_NEG``; ``neg_inf``
    gives two series an all -inf evidence row at a valid step; ``ties``
    makes every series a tie case (uniform pi and A, integer
    emissions)."""
    log_pi = _log_norm(rng.normal(size=(B, K)))
    log_A = _log_norm(rng.normal(size=(B, K, K)))
    log_obs = rng.normal(size=(B, T, K)) - 1.0
    if sparse:
        log_A[rng.random((B, K, K)) < 0.2] = MASK_NEG
    if ties:
        log_pi[:] = -np.log(K)
        log_A[:] = -np.log(K)
        log_obs = np.round(log_obs)
    lengths = rng.integers(T // 2, T + 1, size=B) if ragged else np.full(B, T)
    if neg_inf:
        for b in range(min(2, B)):
            log_obs[b, rng.integers(1, lengths[b])] = -np.inf
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return tuple(a.astype(np.float32) for a in (log_pi, log_A, log_obs)) + (mask,)


def _t(args, dtype=None):
    return tuple(torch.as_tensor(a, dtype=dtype) for a in args)


def _jax_pallas(fn, *args):
    """A JAX dispatch entry forced onto its blocked Pallas branch (run in
    interpret mode off the TPU), vmapped over series."""
    return jax.vmap(lambda *a: fn(*a, time_parallel="pallas"))(*(jnp.asarray(a) for a in args))


def _assert_logs_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


CASES = {
    "plain": dict(),
    "neg_inf": dict(neg_inf=True),
    "sparse": dict(sparse=True),
    "ties": dict(ties=True),
}


# ---------------------------------------------------------------------------
# the plain versions against the JAX Pallas entries and scans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [2, 3, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_filter_matches_jax(rng, K, case):
    args = _case(rng, 4, 48, K, **CASES[case])
    la, ll = cs.semiring_filter(*_t(args))
    jla, jll = _jax_pallas(jd.forward_filter_dispatch, *args)
    _assert_logs_close(la.numpy(), jla)
    _assert_logs_close(ll.numpy(), jll)
    sla, sll = jax.vmap(j_forward_filter)(*(jnp.asarray(a) for a in args))
    _assert_logs_close(la.numpy(), sla)
    _assert_logs_close(ll.numpy(), sll)


@pytest.mark.parametrize("K", [2, 3, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_beta_matches_jax(rng, K, case):
    args = _case(rng, 4, 48, K, **CASES[case])
    lb = cs.semiring_beta(*_t(args[1:]))
    _assert_logs_close(lb.numpy(), _jax_pallas(jd.backward_dispatch, *args[1:]))
    scan = jax.vmap(j_backward_pass)(*(jnp.asarray(a) for a in args[1:]))
    _assert_logs_close(lb.numpy(), scan)


@pytest.mark.parametrize("K", [2, 3, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_viterbi_matches_jax(rng, K, case):
    args = _case(rng, 4, 48, K, **CASES[case])
    path, score = cs.semiring_viterbi(*_t(args))
    jpath, jscore = _jax_pallas(jd.viterbi_dispatch, *args)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    spath, sscore = jax.vmap(j_viterbi)(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(path.numpy(), np.asarray(spath))
    np.testing.assert_array_equal(score.numpy(), np.asarray(sscore))


def test_smooth_dispatch_matches_jax_pallas(rng):
    args = _case(rng, 3, 64, 4, sparse=True, neg_inf=True)
    out = td.smooth_dispatch(*_t(args))
    jout = _jax_pallas(jd.smooth_dispatch, *args)
    for got, want in zip(out, jout):
        _assert_logs_close(got.numpy(), want)


def _np_maps(log_pi, log_A, log_obs, mask):
    """First-argmax backpointers ``[B, T, K]`` by numpy in f32 (identity
    at t = 0 and on masked steps)."""
    B, T, K = log_obs.shape
    back = np.tile(np.arange(K), (B, T, 1))
    delta = log_pi + log_obs[:, 0]
    for t in range(1, T):
        scores = delta[:, :, None] + log_A  # f32 adds, as the kernel
        new = scores.max(1) + log_obs[:, t]
        valid = mask[:, t] > 0
        back[valid, t] = scores.argmax(1)[valid]
        delta = np.where(valid[:, None], new, delta)
    return back


@pytest.mark.parametrize("K", [2, 3, 8])
def test_packed_maps_match_numpy_first_argmax(rng, K):
    args = _case(rng, 5, 40, K, sparse=True)
    args_ties = _case(rng, 3, 40, K, ties=True)
    for a in (args, args_ties):
        pi_t, A_t, obs_t, mask_t, _, _ = cs.to_lanes(*_t(a))
        _, _, back = cs.viterbi_lanes(pi_t, A_t, obs_t, mask_t)
        assert back.dtype == torch.int32
        got = cs.unpack_back(back, K).permute(2, 0, 1).numpy()  # [B, T, K]
        np.testing.assert_array_equal(got, _np_maps(*a))


def test_viterbi_ties_go_to_lowest_index():
    z = torch.zeros
    path, _ = cs.semiring_viterbi(z(2, 3), z(2, 3, 3), z(2, 6, 3), torch.ones(2, 6))
    assert int(path.abs().sum()) == 0
    # an all -inf evidence row: every score -inf, the argmax is state 0
    obs = torch.zeros(1, 4, 3)
    obs[0, 2] = float("-inf")
    path, score = cs.semiring_viterbi(z(1, 3), z(1, 3, 3), obs, torch.ones(1, 4))
    assert float(score) == float("-inf") and path.tolist() == [[0, 0, 0, 0]]


def test_padded_viterbi_tail_repeats_last_state(rng):
    log_pi, log_A, log_obs, mask = _case(rng, 4, 30, 3)
    path, score = cs.semiring_viterbi(*_t((log_pi, log_A, log_obs, mask)))
    for b, n in enumerate(mask.sum(1).astype(int)):
        assert bool((path[b, n - 1 :] == path[b, n - 1]).all())
        one = _t((log_pi[b : b + 1], log_A[b : b + 1], log_obs[b : b + 1, :n], mask[b : b + 1, :n]))
        p1, s1 = cs.semiring_viterbi(*one)
        np.testing.assert_array_equal(path[b, :n].numpy(), p1[0].numpy())
        assert float(score[b]) == float(s1[0])


# ---------------------------------------------------------------------------
# float64 against the numpy oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [2, 3, 4])
def test_plain_versions_f64_against_oracle(rng, K):
    T = 30
    series = [oracle.random_hmm(rng, K, T) for _ in range(3)]
    args = tuple(np.stack([s[i] for s in series]) for i in range(3))
    mask = np.ones((3, T))
    t64 = _t(args + (mask,), torch.float64)
    la, ll = cs.semiring_filter(*t64)
    lb = cs.semiring_beta(*t64[1:])
    path, score = cs.semiring_viterbi(*t64)
    assert la.dtype == torch.float64
    for b, (lp, lA, lo) in enumerate(series):
        ra, rll = oracle.forward_np(lp, lA, lo)
        np.testing.assert_allclose(la[b].numpy(), ra, atol=1e-10, rtol=1e-10)
        np.testing.assert_allclose(float(ll[b]), rll, atol=1e-10, rtol=1e-10)
        rb = oracle.backward_np(lA, lo)
        np.testing.assert_allclose(lb[b].numpy(), rb, atol=1e-10, rtol=1e-10)
        rpath, rscore = oracle.viterbi_np(lp, lA, lo)
        np.testing.assert_array_equal(path[b].numpy(), rpath)
        np.testing.assert_allclose(float(score[b]), rscore, atol=1e-10, rtol=1e-10)


def test_smooth_f64_against_brute_force(rng):
    K, T = 3, 6
    series = [oracle.random_hmm(rng, K, T) for _ in range(2)]
    args = tuple(np.stack([s[i] for s in series]) for i in range(3))
    _, _, log_gamma, _ = td.smooth_dispatch(*_t(args, torch.float64))
    for b, s in enumerate(series):
        brute = oracle.smoothing_marginals_brute(*s)  # log marginals
        np.testing.assert_allclose(log_gamma[b].numpy(), brute, atol=1e-10, rtol=1e-10)


# ---------------------------------------------------------------------------
# the plain scans (time-varying log_A)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tv", [False, True])
def test_scans_match_jax(rng, tv):
    B, T, K = 3, 40, 3
    args = list(_case(rng, B, T, K))
    if tv:
        args[1] = _log_norm(rng.normal(size=(B, T - 1, K, K))).astype(np.float32)
    out = tf.forward_backward(*_t(args))
    jout = jax.vmap(j_forward_backward)(*(jnp.asarray(a) for a in args))
    for got, want in zip(out, jout):
        _assert_logs_close(got.numpy(), want)


def test_filter_step_is_the_scan_step(rng):
    args = _t(_case(rng, 2, 10, 4, ragged=False))
    la, _ = tf.forward_filter(*args)
    step = tf.filter_step(la[:, 3], args[1], args[2][:, 4], args[3][:, 4])
    assert torch.equal(step, la[:, 4])


# ---------------------------------------------------------------------------
# generated and state_draws against the JAX models
# ---------------------------------------------------------------------------


def _theta(rng, model, shape):
    return (0.5 * rng.normal(size=shape + (model.n_free,))).astype(np.float32)


def _assert_generated_close(out, ref):
    for k in ("alpha", "gamma"):
        np.testing.assert_allclose(out[k], ref[k], atol=PROB_ATOL)
    np.testing.assert_array_equal(out["zstar"], ref["zstar"])
    for k in ("loglik", "logp_zstar"):
        np.testing.assert_allclose(out[k], ref[k], rtol=LL_RTOL)


@pytest.mark.parametrize("route", ["pallas", "seq"])
def test_generated_tayal_hard_matches_jax(rng, route):
    B, D, T = 2, 3, 40
    x, sign = tayal_batch(B, T, seed=3, device="cpu")
    theta = _theta(rng, TayalHHMM(), (B, D))
    out = TayalHHMM(gate_mode="hard").generated(
        torch.from_numpy(theta), {"x": x, "sign": sign}, device="cpu"
    )
    jm = JTayalHHMM(gate_mode="hard")
    for b in range(B):
        data_b = {"x": jnp.asarray(x[b].numpy()), "sign": jnp.asarray(sign[b].numpy())}
        ref = jm.generated(jnp.asarray(theta[b]), data_b, time_parallel=route)
        _assert_generated_close({k: v[b].numpy() for k, v in out.items()},
                                {k: np.asarray(v) for k, v in ref.items()})


def _gaussian_data(rng, B, T):
    mu, sigma = np.array([-2.0, 0.5, 3.0]), np.array([0.5, 0.8, 0.6])
    z = rng.integers(0, 3, size=(B, T))
    return (mu[z] + sigma[z] * rng.normal(size=(B, T))).astype(np.float32)


@pytest.mark.parametrize("route", ["pallas", "seq"])
def test_generated_gaussian_matches_jax(rng, route):
    B, D, T = 2, 3, 40
    x = _gaussian_data(rng, B, T)
    model = GaussianHMM(K=3)
    theta = _theta(rng, model, (B, D))
    out = model.generated(torch.from_numpy(theta), {"x": torch.from_numpy(x)}, device="cpu")
    jm = JGaussianHMM(K=3)
    for b in range(B):
        ref = jm.generated(jnp.asarray(theta[b]), {"x": jnp.asarray(x[b])}, time_parallel=route)
        _assert_generated_close({k: v[b].numpy() for k, v in out.items()},
                                {k: np.asarray(v) for k, v in ref.items()})


def test_generated_shared_series_and_shapes(rng):
    T = 25
    x = _gaussian_data(rng, 1, T)[0]
    model = GaussianHMM(K=3)
    theta = torch.from_numpy(_theta(rng, model, (2, 4)))
    out = model.generated(theta, {"x": torch.from_numpy(x)}, device="cpu")
    assert out["alpha"].shape == (2, 4, T, 3) and out["zstar"].shape == (2, 4, T)
    assert out["zstar"].dtype == torch.int64 and out["loglik"].shape == (2, 4)
    np.testing.assert_allclose(out["gamma"].sum(-1).numpy(), 1.0, atol=PROB_ATOL)


def test_state_draws_marginals_match_gamma(rng):
    T, n = 12, 4000
    x = _gaussian_data(rng, 1, T)[0]
    model = GaussianHMM(K=3)
    theta = torch.from_numpy(_theta(rng, model, ()))
    draws = theta.expand(n, model.n_free)
    gen = torch.Generator()
    gen.manual_seed(0)
    z = model.state_draws(gen, draws, {"x": torch.from_numpy(x)}, device="cpu")
    assert z.shape == (n, T) and z.dtype == torch.int64
    gamma = model.generated(theta[None], {"x": torch.from_numpy(x)}, device="cpu")["gamma"][0]
    freq = torch.nn.functional.one_hot(z, 3).double().mean(0)
    se = torch.sqrt(gamma.double() * (1 - gamma.double()) / n).clamp_min(1.0 / n)
    assert bool(((freq - gamma.double()).abs() <= 4 * se).all())


def test_state_draws_stan_gate_uses_the_gate_keys(rng):
    """The stan-gate Tayal model's ``log_A`` is time-varying in ``build``;
    ``state_draws`` takes the hot-loop contract (homogeneous ``log_A`` and
    gate keys) as the Gibbs sweep does."""
    x, sign = tayal_batch(2, 20, seed=1, device="cpu")
    model = TayalHHMM()
    gen = torch.Generator()
    gen.manual_seed(0)
    z = model.state_draws(gen, torch.from_numpy(_theta(rng, model, (2, 3))),
                          {"x": x, "sign": sign}, device="cpu")
    assert z.shape == (2, 3, 20) and bool(((z >= 0) & (z < 4)).all())


# ---------------------------------------------------------------------------
# K from 5 to 16: two map words a step above 8
# ---------------------------------------------------------------------------


def _series(K):
    """Series a case takes: two from K = 33 on (a block a lane on the
    card), to keep the plain versions' Python loops short."""
    return 3 if K <= 32 else 2


@pytest.mark.parametrize("K", [5, 9, 12, 16, 20, 32])
@pytest.mark.parametrize("case", ["sparse", "ties"])
def test_wide_k_plain_versions_match_jax(rng, K, case):
    check_plain_versions_match_jax(rng, K, case)


def check_plain_versions_match_jax(rng, K, case):
    """The filter, beta and Viterbi plain versions (and the decode
    dispatch's Viterbi) against the JAX pallas branch in interpret mode,
    on sparse A with -inf evidence rows or on exact ties."""
    args = _case(rng, _series(K), 24, K, neg_inf=case == "sparse", **{case: True})
    la, ll = cs.semiring_filter(*_t(args))
    jla, jll = _jax_pallas(jd.forward_filter_dispatch, *args)
    _assert_logs_close(la.numpy(), jla)
    _assert_logs_close(ll.numpy(), jll)
    lb = cs.semiring_beta(*_t(args[1:]))
    _assert_logs_close(lb.numpy(), _jax_pallas(jd.backward_dispatch, *args[1:]))
    path, score = cs.semiring_viterbi(*_t(args))
    jpath, jscore = _jax_pallas(jd.viterbi_dispatch, *args)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    dpath, dscore = td.viterbi_dispatch(*_t(args))
    np.testing.assert_array_equal(dpath.numpy(), np.asarray(jpath))
    np.testing.assert_array_equal(dscore.numpy(), np.asarray(jscore))


@pytest.mark.parametrize("K", [*range(9, 18), 20, 24, 25, 32, 33, 64, 128])
def test_wide_k_viterbi_plain_matches_jax_and_oracle(rng, K):
    B, T = (4, 40) if K <= 32 else (2, 32)
    args = _case(rng, B, T, K, sparse=True)
    pi_t, A_t, obs_t, mask_t, _, _ = cs.to_lanes(*_t(args))
    score, dlast, back = cs.viterbi_plain(pi_t, A_t, obs_t, mask_t)
    words = 2 if K <= 16 else -(-K // 4)  # nibbles up to K = 16, bytes above
    assert back.shape == (T, words, B) and back.dtype == torch.int32
    np.testing.assert_array_equal(cs.unpack_back(back, K).permute(2, 0, 1).numpy(),
                                  _np_maps(*args))
    path = cs.backtrack_plain(back, dlast).t()
    spath, sscore = jax.vmap(j_viterbi)(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(path.numpy(), np.asarray(spath))
    np.testing.assert_array_equal(score.numpy(), np.asarray(sscore))
    # float64 against the numpy oracle
    series = [oracle.random_hmm(rng, K, 30) for _ in range(2)]
    a64 = tuple(np.stack([s[i] for s in series]) for i in range(3)) + (np.ones((2, 30)),)
    path64, score64 = cs.semiring_viterbi(*_t(a64, torch.float64))
    for b, (lp, lA, lo) in enumerate(series):
        rpath, rscore = oracle.viterbi_np(lp, lA, lo)
        np.testing.assert_array_equal(path64[b].numpy(), rpath)
        np.testing.assert_allclose(float(score64[b]), rscore, atol=1e-10, rtol=1e-10)


def _gaussian_k_data(rng, K, B, T):
    z = rng.integers(0, K, size=(B, T))
    return (1.5 * z - 0.75 * K + 0.6 * rng.normal(size=(B, T))).astype(np.float32)


def _oracle_probs(log_pi, log_A, log_obs):
    """Filtered and smoothed probabilities ``[T, K]`` in float64."""
    la, _ = oracle.forward_np(log_pi, log_A, log_obs)
    lg = la + oracle.backward_np(log_A, log_obs)
    norm = lambda v: np.exp(v - np.logaddexp.reduce(v, axis=-1, keepdims=True))  # noqa: E731
    return {"alpha": norm(la), "gamma": norm(lg)}


def _check_generated_gaussian_k(rng, K, route, T=30):
    """``GaussianHMM(K).generated`` against the JAX ``generated`` on
    ``route``: zstar identical, loglik and logp_zstar within ``LL_RTOL``,
    probabilities within ``PROB_ATOL`` (``WIDE_PROB_ATOL`` from K = 9,
    ``WIDEST_PROB_ATOL`` above 16, ``WIDER_PROB_ATOL`` from 33) and no
    farther from the float64 oracle than the JAX package's (from K = 24
    within ``WIDER_ORACLE_RATIO`` times its distance)."""
    B, D = 2, 2
    x = _gaussian_k_data(rng, K, B, T)
    model = GaussianHMM(K=K)
    theta = _theta(rng, model, (B, D))
    out = model.generated(torch.from_numpy(theta), {"x": torch.from_numpy(x)}, device="cpu")
    jm = JGaussianHMM(K=K)
    atol = (PROB_ATOL if K <= 8 else WIDE_PROB_ATOL if K <= 16
            else WIDEST_PROB_ATOL if K <= 32 else WIDER_PROB_ATOL)
    for b in range(B):
        ref = jm.generated(jnp.asarray(theta[b]), {"x": jnp.asarray(x[b])}, time_parallel=route)
        got = {k: v[b].numpy() for k, v in out.items()}
        want = {k: np.asarray(v) for k, v in ref.items()}
        np.testing.assert_array_equal(got["zstar"], want["zstar"])
        for k in ("loglik", "logp_zstar"):
            np.testing.assert_allclose(got[k], want[k], rtol=LL_RTOL)
        for d in range(D):
            terms = jm.build(jm.unpack(jnp.asarray(theta[b, d]))[0], {"x": jnp.asarray(x[b])})
            truth = _oracle_probs(*(np.asarray(a, np.float64) for a in terms[:3]))
            for k in ("alpha", "gamma"):
                np.testing.assert_allclose(got[k][d], want[k][d], atol=atol, err_msg=k)
                port_err = np.abs(got[k][d] - truth[k]).max()
                jax_err = np.abs(want[k][d] - truth[k]).max()
                ratio = 1.0 if K <= 20 else WIDER_ORACLE_RATIO
                assert port_err <= ratio * jax_err + WIDE_ORACLE_SLACK, (k, port_err, jax_err)


@pytest.mark.parametrize("K", [5, 9, 12, 16])
def test_generated_gaussian_k_matches_jax(rng, K):
    _check_generated_gaussian_k(rng, K, "seq")


@pytest.mark.parametrize("K", [5, 9, 12, 16])
def test_state_draws_gaussian_k_match_jax_ffbs(rng, K):
    check_state_draws_gaussian_k(rng, K)


def check_state_draws_gaussian_k(rng, K):
    """``state_draws`` draws its uniforms from the generator, then runs
    the FFBS plain versions; the JAX FFBS reference on the JAX model's
    terms and the same uniforms draws the same paths."""
    B, T = _series(K), 30
    x = _gaussian_k_data(rng, K, B, T)
    model = GaussianHMM(K=K)
    theta = _theta(rng, model, (B,))
    gen = torch.Generator()
    gen.manual_seed(11)
    z = model.state_draws(gen, torch.from_numpy(theta), {"x": torch.from_numpy(x)}, device="cpu")
    gen.manual_seed(11)
    u = torch.rand((B, T), generator=gen).numpy()
    jm = JGaussianHMM(K=K)
    for b in range(B):
        lp, lA, lo, _ = jm.build(jm.unpack(jnp.asarray(theta[b]))[0], {"x": jnp.asarray(x[b])})
        jz, _ = j_ffbs_reference(lp, lA, lo, jnp.ones(T), jnp.asarray(u[b]))
        np.testing.assert_array_equal(z[b].numpy(), np.asarray(jz))


def test_k_above_16_raises_on_every_route(rng):
    """Above K = 16, 32 and 128 every entry answers: at K = 129 the FFBS,
    value-and-grad and decode entries, their plain versions and the
    models' ``generated`` / ``state_draws`` give finite values on the CPU
    route here (``tests/test_torch_big_k.py`` holds them to the JAX
    package). At K = 1, float32 operands on a CUDA device reach the
    kernel of every route (its library is loaded to launch it), never a
    plain version."""
    args = _t(_case(rng, 1, 4, 129))
    u = torch.rand(1, 4)
    runs = [lambda a: cs.semiring_ffbs(*a, u), lambda a: cs.fwd_lanes(*cs.to_lanes(*a)),
            lambda a: cs.semiring_vg(*a), lambda a: cs.semiring_viterbi(*a),
            lambda a: td.viterbi_dispatch(*a), lambda a: cs.semiring_filter(*a),
            lambda a: cs.semiring_beta(*a[1:]), lambda a: td.smooth_dispatch(*a),
            lambda a: cs.filter_lanes(*cs.to_lanes(*a)[:4])]
    for run in runs:
        for out in run(args):
            assert out.shape[0] in (1, 4) and not torch.isnan(out.double()).any()
    one = _cudalike(_case(rng, 1, 4, 1))
    with _kernels_reached() as reached:
        for run in runs:
            with pytest.raises(_Launched):
                run(one)
    assert reached == ["ffbs_fwd", "ffbs_fwd", "ffbs_fwd", "viterbi_fwd", "viterbi_fwd",
                       "semiring_filter", "semiring_beta", "semiring_filter", "semiring_filter"]
    model = GaussianHMM(K=129)
    theta = torch.from_numpy(_theta(rng, model, (1,)))
    z = model.state_draws(torch.Generator(), theta, {"x": torch.zeros(4)}, device="cpu")
    assert tuple(z.shape) == (1, 4) and int(z.min()) >= 0 and int(z.max()) < 129
    out = model.generated(theta, {"x": torch.zeros(4)}, device="cpu")
    assert tuple(out["gamma"].shape) == (1, 4, 129) and torch.isfinite(out["loglik"]).all()


@pytest.mark.parametrize("K", [17, 20])
@pytest.mark.parametrize("route", ["pallas", "seq"])
def test_generated_gaussian_k_above_16_matches_jax(rng, K, route):
    _check_generated_gaussian_k(rng, K, route)


@pytest.mark.parametrize("K", [17, 32, 64])
def test_dispatch_above_16_plain_versions_match_the_scans(rng, record_plain, K):
    """Above K = 16 the decode dispatch still takes the kernels' route
    (their plain versions here): the Viterbi path and score equal the
    port's scan, the log-probabilities agree within ``RTOL`` and
    ``ATOL``, with -inf at the same places."""
    args = _t(_case(rng, _series(K), 24, K, neg_inf=True, sparse=True))
    for got, want in zip(td.viterbi_dispatch(*args), t_viterbi(*args)):
        assert torch.equal(got, want)
    for got, want in zip(td.smooth_dispatch(*args), tf.forward_backward(*args)):
        _assert_logs_close(got.numpy(), want.numpy())
    for got, want in zip(td.forward_filter_dispatch(*args), tf.forward_filter(*args)):
        _assert_logs_close(got.numpy(), want.numpy())
    _assert_logs_close(td.backward_dispatch(*args[1:]).numpy(),
                       tf.backward_pass(*args[1:]).numpy())
    assert record_plain == ["viterbi_plain", "backtrack_plain", "filter_plain", "beta_plain",
                            "filter_plain", "beta_plain"]


def test_smooth_dispatch_one_layout_copy_equals_two_entries(rng):
    """The kernels' route of ``smooth_dispatch`` builds the lane layout once
    for both passes; its outputs are bitwise those of ``semiring_filter``
    and ``semiring_beta`` called apart."""
    args = _t(_case(rng, 3, 40, 5, neg_inf=True, sparse=True))
    la, lb, lg, ll = td.smooth_dispatch(*args)
    want_la, want_ll = cs.semiring_filter(*args)
    want_lb = cs.semiring_beta(*args[1:])
    assert torch.equal(la, want_la) and torch.equal(ll, want_ll) and torch.equal(lb, want_lb)
    assert torch.equal(lg, tf.smooth(want_la, want_lb))


class _Launched(Exception):
    """Raised in place of loading a kernel's library: the wrapper got as
    far as launching it."""


@contextlib.contextmanager
def _kernels_reached():
    """Every ``CudaKernel.load`` records its kernel's name and raises
    :class:`_Launched`, so a test on CUDA-like operands sees which kernel a
    wrapper would launch (no plain version runs: they are not loaded)."""
    reached = []

    def load(self):
        reached.append(self.name)
        raise _Launched(self.name)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_build.CudaKernel, "load", load)
        yield reached


def test_k_1_runs_on_the_cpu_and_raises_on_the_card():
    """K = 1 answers on the CPU (a zero path, the sum of the steps) and, on
    the card, goes to the kernel like every other K: the lane wrappers
    check the operands and load ``VITERBI``, ``BACKTRACK``, ``FILTER``,
    ``BETA``, ``FWD``, ``BWD_SAMPLE`` and ``VG_BWD`` (K = 0 still raises)."""
    z = torch.zeros
    path, score = cs.semiring_viterbi(z(2, 1), z(2, 1, 1), z(2, 5, 1), torch.ones(2, 5))
    assert int(path.abs().sum()) == 0 and score.tolist() == [0.0, 0.0]
    lanes = _cudalike([np.zeros(s) for s in ((1, 2), (1, 1, 2), (5, 1, 2), (5, 2))])
    pi_t, A_t, obs_t, mask_t = lanes
    back = torch.zeros(5, 2, dtype=torch.int32).as_subclass(_CudaLike)
    runs = [lambda: cs.viterbi_lanes(*lanes), lambda: cs.backtrack_lanes(back, pi_t),
            lambda: cs.filter_lanes(*lanes), lambda: cs.beta_lanes(A_t, obs_t, mask_t),
            lambda: cs.fwd_lanes(*lanes),
            lambda: cs.bwd_sample_lanes(A_t, mask_t, obs_t, mask_t),
            lambda: cs.vg_bwd_lanes(A_t, obs_t, mask_t, obs_t, pi_t[0])]
    with _kernels_reached() as reached:
        for run in runs:
            with pytest.raises(_Launched):
                run()
    assert reached == [k.name for k in (cs.VITERBI, cs.BACKTRACK, cs.FILTER, cs.BETA, cs.FWD,
                                        cs.BWD_SAMPLE, cs.VG_BWD)]
    none = _cudalike([np.zeros(s) for s in ((0, 2), (0, 0, 2), (5, 0, 2), (5, 2))])
    with pytest.raises(ValueError, match="K >= 1"):
        cs.viterbi_lanes(*none)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


class _CudaLike(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda")


def _cudalike(args, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype).as_subclass(_CudaLike) for a in args]


@pytest.fixture
def record_plain(monkeypatch):
    calls = []
    for name in ("filter_plain", "beta_plain", "viterbi_plain", "backtrack_plain"):
        fn = getattr(cs, name)
        monkeypatch.setattr(cs, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))
    return calls


def test_cpu_routes_to_the_plain_versions(rng, record_plain):
    args = _t(_case(rng, 2, 16, 4))
    td.smooth_dispatch(*args)
    td.viterbi_dispatch(*args)
    td.forward_filter_dispatch(*args)
    td.backward_dispatch(*args[1:])
    assert record_plain == ["filter_plain", "beta_plain", "viterbi_plain", "backtrack_plain",
                            "filter_plain", "beta_plain"]


def test_time_varying_routes_to_the_scans(rng, record_plain):
    B, T, K = 2, 16, 3
    args = list(_t(_case(rng, B, T, K)))
    args[1] = torch.as_tensor(_log_norm(rng.normal(size=(B, T - 1, K, K))), dtype=torch.float32)
    path, _ = td.viterbi_dispatch(*args)
    la, lb, lg, ll = td.smooth_dispatch(*args)
    assert record_plain == []
    ref = tf.forward_backward(*args)
    for got, want in zip((la, lb, lg, ll), ref):
        assert torch.equal(got, want)
    assert path.shape == (B, T)


def test_no_mask_means_every_step_valid(rng):
    args = _t(_case(rng, 2, 16, 4, ragged=False))
    for fn, a in ((td.forward_filter_dispatch, args), (td.viterbi_dispatch, args)):
        for got, want in zip(fn(*a[:3]), fn(*a)):
            assert torch.equal(got, want)
    assert torch.equal(td.backward_dispatch(*args[1:3]), td.backward_dispatch(*args[1:]))


@pytest.mark.parametrize("fn", ["forward_filter", "backward", "smooth", "viterbi"])
def test_mixed_devices_raise(fn):
    meta = torch.zeros(2, 4, device="meta")
    cpu = [torch.zeros(2, 4, 4), torch.zeros(2, 5, 4)]
    with pytest.raises(ValueError, match="device"):
        if fn == "backward":
            td.backward_dispatch(cpu[0], cpu[1], torch.ones(2, 5, device="meta"))
        else:
            getattr(td, f"{fn}_dispatch")(meta, *cpu)


@pytest.mark.parametrize("fn", ["forward_filter", "backward", "smooth", "viterbi"])
def test_cuda_non_float32_raises(fn):
    args = _cudalike([np.zeros((2, 4)), np.zeros((2, 4, 4)), np.zeros((2, 5, 4))], torch.float64)
    with pytest.raises(TypeError, match="float32"):
        if fn == "backward":
            td.backward_dispatch(*args[1:])
        else:
            getattr(td, f"{fn}_dispatch")(*args)


@pytest.mark.parametrize("fn", ["forward_filter", "backward", "smooth", "viterbi"])
def test_cuda_homogeneous_reaches_the_kernel(monkeypatch, record_plain, fn):
    """A CUDA float32 operand goes to the kernel wrapper, which launches
    (here: raises, there is no card to build for) and never runs the
    plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _cudalike([np.zeros((2, 4)), np.zeros((2, 4, 4)), np.zeros((2, 5, 4)), np.ones((2, 5))])
    with pytest.raises(RuntimeError, match="CUDA"):
        if fn == "backward":
            td.backward_dispatch(*args[1:])
        else:
            getattr(td, f"{fn}_dispatch")(*args)
    assert record_plain == []


def test_cuda_wrappers_check_k_and_layout():
    K, N, T = 5, 3, 4
    shapes = ((K, N), (K, K, N), (T, K, N), (T, N))
    lanes = _cudalike([np.zeros(s) for s in shapes])
    none = _cudalike([np.zeros(s) for s in ((0, N), (0, 0, N), (T, 0, N), (T, N))])
    with pytest.raises(ValueError, match="K >= 1"):
        cs.filter_lanes(*none)
    with pytest.raises(TypeError, match="int32"):
        cs.backtrack_lanes(torch.zeros(T, N).as_subclass(_CudaLike), lanes[0])
    with pytest.raises(ValueError, match="lane layout"):
        cs.beta_lanes(lanes[1], lanes[2], lanes[3][:2])


# ---------------------------------------------------------------------------
# the CUDA kernels themselves (skipped without a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 3, 4, 5, 8, 9, 12, 16, 20, 33, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_decode_kernels_match_plain(rng, cuda_device, K, case):
    args = [a.to(cuda_device) for a in _t(_case(rng, 300, 130, K, **CASES[case]))]
    pi_t, A_t, obs_t, mask_t, _, _ = cs.to_lanes(*args)
    before = [k.launches for k in (cs.FILTER, cs.BETA, cs.VITERBI, cs.BACKTRACK)]
    ll_k, a_k = cs.filter_lanes(pi_t, A_t, obs_t, mask_t)
    b_k = cs.beta_lanes(A_t, obs_t, mask_t)
    sc_k, dl_k, bk_k = cs.viterbi_lanes(pi_t, A_t, obs_t, mask_t)
    path_k = cs.backtrack_lanes(bk_k, dl_k)
    after = [k.launches for k in (cs.FILTER, cs.BETA, cs.VITERBI, cs.BACKTRACK)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]
    ll_p, a_p = cs.filter_plain(pi_t, A_t, obs_t, mask_t)
    sc_p, dl_p, bk_p = cs.viterbi_plain(pi_t, A_t, obs_t, mask_t)
    torch.cuda.synchronize()
    assert torch.equal(a_k, a_p) and torch.equal(ll_k, ll_p)
    assert torch.equal(b_k, cs.beta_plain(A_t, obs_t, mask_t))
    assert torch.equal(sc_k, sc_p) and torch.equal(dl_k, dl_p) and torch.equal(bk_k, bk_p)
    assert torch.equal(path_k, cs.backtrack_plain(bk_p, dl_p))


@pytest.mark.cuda
def test_cuda_generated_launches_each_kernel_once(rng, cuda_device):
    x = torch.from_numpy(_gaussian_data(rng, 4, 64)).to(cuda_device)
    model = GaussianHMM(K=3)
    theta = torch.from_numpy(_theta(rng, model, (4, 5))).to(cuda_device)
    kernels = (cs.FILTER, cs.BETA, cs.VITERBI, cs.BACKTRACK)
    before = [k.launches for k in kernels]
    out = model.generated(theta, {"x": x}, device=cuda_device)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1, 1]
    ref = model.generated(theta.cpu(), {"x": x.cpu()}, device="cpu")
    np.testing.assert_array_equal(out["zstar"].cpu().numpy(), ref["zstar"].numpy())
    np.testing.assert_allclose(out["gamma"].cpu().numpy(), ref["gamma"].numpy(), atol=PROB_ATOL)
