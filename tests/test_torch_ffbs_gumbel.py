"""The Gumbel-max FFBS, the bijectors ``Identity`` / ``MaskedSimplex``,
the semiring algebra and the Tayal replication diagnostics against the
JAX package.

- ``backward_sample`` / ``ffbs_sample`` draw for draw against the JAX
  functions, homogeneous and time-varying ``log_A``, with and without a
  tail mask: the port takes the Gumbel noise as an input, rebuilt here
  from the JAX keys (``categorical(k, l) = argmax(l + gumbel(k))``, the
  last step's key first, then one key a step, a padded successor reusing
  its step's noise);
- ``state_draws`` routes a time-varying ``log_A`` (no gate keys) to the
  Gumbel FFBS, whose per-step state frequencies match the smoothed
  marginals and the keyed route's;
- ``Identity`` and ``MaskedSimplex`` forward (value and log-Jacobian)
  and inverse (renormalizing off-support mass) against the JAX ones;
- ``kernels/semiring.py`` against the JAX module;
- ``apps/tayal/replication.py``: ``chain_marginal_ll``,
  ``ml_weighted_pool``, ``degenerate_mode_probe`` and
  ``per_draw_relabel_stats`` against the JAX functions given the same
  noise;
- autograd through ``safe_logsumexp`` gives 0, not NaN, on an all-−inf
  row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhmm_tpu.apps.tayal import replication as j_rep
from hhmm_tpu.core import bijectors as jb
from hhmm_tpu.kernels import semiring as j_sr
from hhmm_tpu.kernels.ffbs import backward_sample as j_backward_sample
from hhmm_tpu.kernels.ffbs import ffbs_sample as j_ffbs_sample
from hhmm_tpu.kernels.filtering import forward_filter as j_forward_filter
from hhmm_tpu.models import TayalHHMM as JTayalHHMM
from hhmm_tpu_torch.apps.tayal import replication as rep
from hhmm_tpu_torch.core import Identity, MaskedSimplex
from hhmm_tpu_torch.core.lmath import safe_logsumexp
from hhmm_tpu_torch.kernels import semiring as sr
from hhmm_tpu_torch.kernels.ffbs import backward_sample, ffbs_sample
from hhmm_tpu_torch.kernels.filtering import forward_backward
from hhmm_tpu_torch.models import SemisupMultinomialHMM, TayalHHMM
from hhmm_tpu_torch.models import base as base_module

torch.set_num_threads(1)


def jax_noise(key, T, K):
    """The Gumbel noise ``[T, K]`` the JAX ``backward_sample`` draws
    from ``key``."""
    key_last, key_rest = jax.random.split(key)
    keys = jax.random.split(key_rest, T - 1)
    rest = jax.vmap(lambda k: jax.random.gumbel(k, (K,), jnp.float32))(keys)
    last = jax.random.gumbel(key_last, (K,), jnp.float32)
    return np.concatenate([np.asarray(rest), np.asarray(last)[None]])


def _case(seed, T, K, tv, masked):
    rng = np.random.default_rng(seed)
    log_pi = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    shape = (T - 1, K, K) if tv else (K, K)
    log_A = np.log(rng.dirichlet(np.ones(K), size=shape[:-1])).astype(np.float32)
    log_obs = rng.normal(size=(T, K)).astype(np.float32)
    mask = (np.arange(T) < T - 5).astype(np.float32) if masked else None
    return log_pi, log_A, log_obs, mask


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("tv", [False, True], ids=["homogeneous", "time_varying"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_backward_sample_draw_for_draw(seed, tv, masked):
    T, K = 64, 4
    log_pi, log_A, log_obs, mask = _case(seed, T, K, tv, masked)
    jm = None if mask is None else jnp.asarray(mask)
    jla, _ = j_forward_filter(jnp.asarray(log_pi), jnp.asarray(log_A), jnp.asarray(log_obs), jm)
    key = jax.random.PRNGKey(100 + seed)
    want = np.asarray(j_backward_sample(key, jla, jnp.asarray(log_A), jm))
    tm = None if mask is None else torch.as_tensor(mask)
    got = backward_sample(None, torch.as_tensor(np.array(jla)), torch.as_tensor(log_A), tm,
                          noise=torch.as_tensor(jax_noise(key, T, K)))
    np.testing.assert_array_equal(got.numpy(), want)
    # end to end, the port's own filter
    got2 = ffbs_sample(None, *(torch.as_tensor(v) for v in (log_pi, log_A, log_obs)), tm,
                       noise=torch.as_tensor(jax_noise(key, T, K)))
    want2 = np.asarray(j_ffbs_sample(key, jnp.asarray(log_pi), jnp.asarray(log_A),
                                     jnp.asarray(log_obs), jm))
    np.testing.assert_array_equal(got2.numpy(), want2)


def test_backward_sample_is_batch_native_and_draws_from_a_generator():
    T, K = 30, 3
    cases = [_case(s, T, K, True, True) for s in range(3)]
    stack = [torch.as_tensor(np.stack([c[i] for c in cases])) for i in range(4)]
    noise = torch.as_tensor(np.random.default_rng(0).gumbel(size=(3, T, K)).astype(np.float32))
    z = ffbs_sample(None, *stack, noise=noise)
    for b in range(3):
        one = ffbs_sample(None, *(torch.as_tensor(v) for v in cases[b]), noise=noise[b])
        assert torch.equal(z[b], one)
    g1 = ffbs_sample(torch.Generator().manual_seed(5), *stack)
    g2 = ffbs_sample(torch.Generator().manual_seed(5), *stack)
    assert torch.equal(g1, g2) and g1.shape == (3, T)
    # padded tail repeats the last valid state
    assert (g1[:, T - 5 :] == g1[:, T - 6 : T - 5]).all()
    with pytest.raises(ValueError, match="T-1=29 slices"):
        backward_sample(None, torch.zeros(T, K), torch.zeros(T, K, K), noise=torch.zeros(T, K))


class _Unkeyed(SemisupMultinomialHMM):
    """The stan gate without gate keys: ``build``'s time-varying
    ``log_A`` reaches ``state_draws``."""

    def gate_keys(self, data):
        return None


def test_state_draws_time_varying_route(monkeypatch):
    """A time-varying ``log_A`` takes the Gumbel FFBS (``ffbs_dispatch``
    is not called), and its per-step state frequencies match the
    smoothed marginals of the same terms and the keyed route's (the
    FFBS kernels' plain versions), within 5 binomial sigma."""
    T, n = 10, 6000
    model, keyed = _Unkeyed(K=4, L=5, groups=(0, 1, 1, 0)), SemisupMultinomialHMM(4, 5, (0, 1, 1, 0))
    rng = np.random.default_rng(3)
    data = {"x": torch.as_tensor(rng.integers(0, 5, T)), "g": torch.as_tensor(rng.integers(0, 2, T))}
    theta = torch.as_tensor(rng.normal(size=(1, model.n_free)), dtype=torch.float32)
    real = base_module.ffbs_dispatch
    monkeypatch.setattr(base_module, "ffbs_dispatch", lambda *a: pytest.fail("kernel route"))
    z = model.state_draws(torch.Generator().manual_seed(0), theta.expand(n, -1), data, device="cpu")
    monkeypatch.setattr(base_module, "ffbs_dispatch", real)
    zk = keyed.state_draws(torch.Generator().manual_seed(1), theta.expand(n, -1), data, device="cpu")
    params = model.unpack(theta[0])[0]
    log_pi, log_A, log_obs, _ = model.build(params, data)
    assert log_A.shape == (T - 1, 4, 4)
    gamma = torch.exp(forward_backward(log_pi, log_A, log_obs)[2]).numpy()
    freq = np.stack([(z.numpy() == k).mean(0) for k in range(4)], -1)
    freq_k = np.stack([(zk.numpy() == k).mean(0) for k in range(4)], -1)
    sigma = np.sqrt(gamma * (1 - gamma) / n) + 1e-3
    assert (np.abs(freq - gamma) < 5 * sigma).all()
    assert (np.abs(freq - freq_k) < 5 * np.sqrt(2) * sigma).all()


# -------------------------------------------------------------- bijectors


def test_identity_bijector_matches_jax():
    b, jbij = Identity((2, 3)), jb.Identity((2, 3))
    x = np.random.default_rng(0).normal(size=6).astype(np.float32)
    y, ldj = b.forward(torch.as_tensor(x))
    jy, jldj = jbij.forward(jnp.asarray(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert float(ldj) == float(jldj) == 0.0 and b.n_free == jbij.n_free == 6
    np.testing.assert_array_equal(b.inverse(y).numpy(), np.asarray(jbij.inverse(jy)))
    yb, ldjb = b.forward(torch.as_tensor(np.stack([x, 2 * x])))
    assert yb.shape == (2, 2, 3) and ldjb.shape == (2,) and b.inverse(yb).shape == (2, 6)


@pytest.mark.parametrize("support", [[1, 0, 1, 1, 0], [0, 1, 0], [1, 1, 1, 1]])
def test_masked_simplex_matches_jax(support):
    b, jbij = MaskedSimplex(support), jb.MaskedSimplex(np.asarray(support, bool))
    assert b.n_free == jbij.n_free and b.shape == tuple(jbij.shape)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, b.n_free)).astype(np.float32)
    y, ldj = b.forward(torch.as_tensor(x))
    for i in range(4):
        jy, jldj = jbij.forward(jnp.asarray(x[i]))
        np.testing.assert_allclose(y[i].numpy(), np.asarray(jy), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(ldj[i]), float(jldj), rtol=1e-6, atol=1e-6)
    off = ~np.asarray(support, bool)
    assert (y.numpy()[:, off] == 0).all()
    # inverse renormalizes the on-support mass, as the JAX one does
    y_bad = y.numpy() + 0.05 * off
    got = b.inverse(torch.as_tensor(y_bad)).numpy()
    for i in range(4):
        np.testing.assert_allclose(got[i], np.asarray(jbij.inverse(jnp.asarray(y_bad[i]))),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, x, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="at least one"):
        MaskedSimplex([0, 0])


# ---------------------------------------------------------------- semiring


def test_semiring_matches_jax():
    rng = np.random.default_rng(2)
    K, T = 4, 9
    P = rng.normal(size=(3, K, K)).astype(np.float32)
    Q = rng.normal(size=(3, K, K)).astype(np.float32)
    P[0, 1, :] = -np.inf  # an all -inf fiber
    for fn, jfn in ((sr.logsumexp_matmul, j_sr.logsumexp_matmul),
                    (sr.maxplus_matmul, j_sr.maxplus_matmul)):
        np.testing.assert_allclose(fn(torch.as_tensor(P), torch.as_tensor(Q)).numpy(),
                                   np.asarray(jfn(jnp.asarray(P), jnp.asarray(Q))),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(sr.semiring_eye(K).numpy(), np.asarray(j_sr.semiring_eye(K, jnp.float32)))
    F = rng.integers(0, K, (5, K))
    G = rng.integers(0, K, (5, K))
    np.testing.assert_array_equal(sr.compose_maps(torch.as_tensor(F), torch.as_tensor(G)).numpy(),
                                  np.asarray(j_sr.compose_maps(jnp.asarray(F), jnp.asarray(G))))
    np.testing.assert_array_equal(sr.identity_map(K).numpy(), np.asarray(j_sr.identity_map(K)))
    log_obs = rng.normal(size=(T, K)).astype(np.float32)
    mask = (np.arange(T) < 6).astype(np.float32)
    for shape in ((K, K), (T - 1, K, K)):
        log_A = rng.normal(size=shape).astype(np.float32)
        for m in (None, mask):
            got = sr.step_operators(torch.as_tensor(log_A), torch.as_tensor(log_obs),
                                    None if m is None else torch.as_tensor(m))
            want = j_sr.step_operators(jnp.asarray(log_A), jnp.asarray(log_obs),
                                       None if m is None else jnp.asarray(m))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the guarded combine: an all -inf fiber has a zero, not NaN, gradient
    Pt = torch.as_tensor(P).requires_grad_(True)
    sr.logsumexp_matmul(Pt, torch.as_tensor(Q))[0, 1].sum().backward()
    assert torch.isfinite(Pt.grad).all()


def test_safe_logsumexp_gradient_on_all_neg_inf_row():
    x = torch.tensor([[float("-inf"), float("-inf"), float("-inf")], [0.0, 1.0, -2.0]],
                     requires_grad=True)
    out = safe_logsumexp(x, dim=-1)
    out.sum().backward()
    assert out[0] == float("-inf")
    assert torch.equal(x.grad[0], torch.zeros(3))
    np.testing.assert_allclose(x.grad[1].numpy(), torch.softmax(x[1].detach(), -1).numpy(),
                               rtol=1e-6)


# ------------------------------------------------------------- replication


@pytest.fixture(scope="module")
def tayal_window():
    rng = np.random.default_rng(4)
    T = 80
    x = rng.integers(0, 9, T).astype(np.int32)
    sign = (np.arange(T) % 2).astype(np.int32)
    sign[rng.random(T) < 0.2] = 0
    price = 100.0 + np.cumsum(rng.normal(size=5 * T + 3)).astype(np.float32)
    leg_start = (np.arange(T) * 5).astype(np.int64)
    leg_end = leg_start + 5
    draws = rng.normal(scale=0.5, size=(6, 35)).astype(np.float32)
    return {"x": x, "sign": sign}, price, leg_start, leg_end, draws


def test_chain_marginal_ll_and_pool_match_jax(tayal_window):
    data, _, _, _, draws = tayal_window
    samples = draws.reshape(2, 3, 35)
    for gate in ("stan", "hard"):
        got = rep.chain_marginal_ll(TayalHHMM(gate_mode=gate), samples, data, n_draws=2, device="cpu")
        want = j_rep.chain_marginal_ll(JTayalHHMM(gate_mode=gate), samples,
                                       {k: jnp.asarray(v) for k, v in data.items()}, n_draws=2)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    per_chain = {"phi_45": np.array([0.8, 0.6]), "phi_25": np.array([0.7, 0.9])}
    assert rep.ml_weighted_pool(per_chain, got) == j_rep.ml_weighted_pool(per_chain, got)


def test_degenerate_mode_probe_matches_jax(tayal_window):
    data, _, _, _, draws = tayal_window
    T = len(data["x"])
    key = jax.random.PRNGKey(8)
    want = j_rep.degenerate_mode_probe(JTayalHHMM(), jnp.asarray(draws[0]),
                                       {k: jnp.asarray(v) for k, v in data.items()}, key)
    got = rep.degenerate_mode_probe(TayalHHMM(), draws[0], data, noise=jax_noise(key, T, 4),
                                    device="cpu")
    for k in ("path_sign_consistency", "state_occupancy"):
        assert got[k] == want[k], k
    for k in ("pure_loglik", "log_jacobian"):
        assert abs(got[k] - want[k]) <= 0.1 + 1e-9, k


def test_per_draw_relabel_stats_matches_jax(tayal_window):
    data, price, leg_start, leg_end, draws = tayal_window
    T = len(data["x"])
    key, chunk = jax.random.PRNGKey(9), 4
    want = j_rep.per_draw_relabel_stats(JTayalHHMM(), draws, {k: jnp.asarray(v) for k, v in data.items()},
                                        leg_start, leg_end, price, key, chunk=chunk)
    noise = []
    for i in range(0, len(draws), chunk):
        ks = jax.random.split(jax.random.fold_in(key, i), len(draws[i : i + chunk]))
        noise += [jax_noise(k, T, 4) for k in ks]
    got = rep.per_draw_relabel_stats(TayalHHMM(), draws, data, leg_start, leg_end, price,
                                     noise=torch.as_tensor(np.stack(noise)), chunk=chunk, device="cpu")
    np.testing.assert_array_equal(got["swapped"], want["swapped"])
    for k in ("phi_45", "phi_25"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got["ll"], want["ll"], rtol=1e-5)
    # a generator draws the noise otherwise, one batch of lanes a chunk
    g = rep.per_draw_relabel_stats(TayalHHMM(), draws, data, leg_start, leg_end, price,
                                   generator=torch.Generator().manual_seed(0), device="cpu")
    assert g["phi_45"].shape == (6,) and g["swapped"].dtype == bool
