"""The port's online filter (`hhmm_tpu_torch/serve/online.py`, the model
tick hooks of `models/base.py`, the served app functions) against the JAX
package on the same numpy inputs:

- ``tick_init`` / ``tick_terms`` of the Tayal HHMM in both gates, the
  Gaussian, multinomial, IOHMM and explicit-duration models against the
  JAX hooks, lane by lane, within rtol 1e-6 + atol 1e-5; a tick fold of
  them against each model's own batch log-likelihood (the JAX
  ``TestTickTerms`` check);
- the fold of ``stream_step`` equals ``filter_scan`` bitwise in the
  port (f32 and f64, masked, time-varying);
- the port's scan against the JAX ``filter_scan`` within tolerance, and
  in float64 against ``tests/oracle.py`` within 1e-10 (not against the
  JAX f64 cases, which are reference reds);
- the one-step predictive and ``posterior_predictive_mean`` (weights,
  quarantined draws, the ``dmax`` collapse), ``RegimeDetector``,
  ``LoglikCUSUM`` and the apps' ``online_flip_detector`` /
  ``online_forecast_mean`` against the JAX ones (discrete outputs
  exactly; the detectors' inputs sit away from their margins).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhmm_tpu import models as jm
from hhmm_tpu.apps.hassan import online_forecast_mean as j_online_forecast_mean
from hhmm_tpu.apps.tayal import online_flip_detector as j_online_flip_detector
from hhmm_tpu.serve import MicroBatchScheduler as JScheduler
from hhmm_tpu.serve import PosteriorSnapshot as JSnapshot
from hhmm_tpu.serve import model_spec as j_model_spec
from hhmm_tpu.serve import online as jon
from hhmm_tpu_torch import models as tm
from hhmm_tpu_torch.apps.hassan import online_forecast_mean
from hhmm_tpu_torch.apps.tayal import online_flip_detector
from hhmm_tpu_torch.serve import MicroBatchScheduler, PosteriorSnapshot, model_spec
from hhmm_tpu_torch.serve import online as ton
from tests.oracle import forward_np

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-5
LANES = 3


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _random_hmm(rng, B, T, K, dtype=np.float32, time_varying=False):
    log_pi = np.log(rng.dirichlet(np.ones(K), size=B)).astype(dtype)
    shape = (B, T - 1, K) if time_varying else (B, K)
    log_A = np.log(rng.dirichlet(np.ones(K), size=shape)).astype(dtype)
    log_obs = (rng.normal(size=(B, T, K)) - 1.0).astype(dtype)
    return log_pi, log_A, log_obs


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


# ---- the tick hooks against the JAX ones ----

def _tayal_obs(rng, n):
    return {"x": rng.integers(0, 9, size=n), "sign": rng.integers(0, 2, size=n)}


MODELS = {
    "tayal_hard": (lambda: tm.TayalHHMM(gate_mode="hard"), lambda: jm.TayalHHMM(gate_mode="hard"),
                   _tayal_obs),
    "tayal_stan": (lambda: tm.TayalHHMM(gate_mode="stan"), lambda: jm.TayalHHMM(gate_mode="stan"),
                   _tayal_obs),
    "gaussian": (lambda: tm.GaussianHMM(K=3), lambda: jm.GaussianHMM(K=3),
                 lambda rng, n: {"x": rng.normal(size=n).astype(np.float32)}),
    "multinomial": (lambda: tm.MultinomialHMM(3, 5), lambda: jm.MultinomialHMM(3, 5),
                    lambda rng, n: {"x": rng.integers(0, 5, size=n)}),
    "iohmm_reg": (lambda: tm.IOHMMReg(2, 3), lambda: jm.IOHMMReg(2, 3),
                  lambda rng, n: {"x": rng.normal(size=n).astype(np.float32),
                                  "u": rng.normal(size=(n, 3)).astype(np.float32)}),
    "gaussian_hsmm": (lambda: tm.GaussianHSMM(2, 3), lambda: jm.GaussianHSMM(2, 3),
                      lambda rng, n: {"x": rng.normal(size=n).astype(np.float32)}),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tick_hooks_match_jax(name):
    make_t, make_j, make_obs = MODELS[name]
    model, jmodel = make_t(), make_j()
    rng = np.random.default_rng(11)
    theta = (0.4 * rng.normal(size=(LANES, model.n_free))).astype(np.float32)
    obs = make_obs(rng, LANES)
    params, _ = model.unpack(torch.as_tensor(theta))
    tobs = {k: torch.as_tensor(v) for k, v in obs.items()}
    log_pi, log_obs0 = model.tick_init(params, tobs)
    log_A, log_obs_t = model.tick_terms(params, tobs)
    for i in range(LANES):
        jp, _ = jmodel.unpack(jnp.asarray(theta[i]))
        ob = {k: jnp.asarray(v[i]) for k, v in obs.items()}
        jpi, jobs0 = jmodel.tick_init(jp, ob)
        jA, jobs_t = jmodel.tick_terms(jp, ob)
        _close(log_pi[i], jpi)
        _close(log_obs0[i], jobs0)
        _close(log_A[i], jA)
        _close(log_obs_t[i], jobs_t)


@pytest.mark.parametrize("gate_mode", ["hard", "stan"])
def test_tayal_tick_fold_matches_batch_loglik(gate_mode):
    """A tick fold of the hooks reproduces the model's batch
    log-likelihood (the JAX ``TestTickTerms`` check, in the port)."""
    rng = np.random.default_rng(3)
    T = 60
    x = rng.integers(0, 9, size=T)
    sign = np.arange(T) % 2  # zig-zag legs alternate up and down
    model = tm.TayalHHMM(gate_mode=gate_mode)
    theta = torch.as_tensor((0.3 * rng.normal(size=model.n_free)).astype(np.float32))
    params, _ = model.unpack(theta)
    st = ton.stream_init(*model.tick_init(params, {"x": torch.tensor(x[0]), "sign": torch.tensor(sign[0])}))
    for t in range(1, T):
        lA, lobs = model.tick_terms(params, {"x": torch.tensor(x[t]), "sign": torch.tensor(sign[t])})
        st = ton.stream_step(st, lA, lobs)
    ll = model.loglik(params, {"x": torch.as_tensor(x), "sign": torch.as_tensor(sign)})
    np.testing.assert_allclose(float(st.loglik), float(ll), rtol=0, atol=2e-4)


def test_gaussian_tick_fold_matches_batch_loglik():
    rng = np.random.default_rng(4)
    x = rng.normal(size=50).astype(np.float32)
    model = tm.GaussianHMM(K=3)
    params, _ = model.unpack(torch.as_tensor((0.3 * rng.normal(size=model.n_free)).astype(np.float32)))
    st = ton.stream_init(*model.tick_init(params, {"x": torch.tensor(x[0])}))
    for t in range(1, len(x)):
        st = ton.stream_step(st, *model.tick_terms(params, {"x": torch.tensor(x[t])}))
    ll = model.loglik(params, {"x": torch.as_tensor(x)})
    np.testing.assert_allclose(float(st.loglik), float(ll), rtol=0, atol=2e-4)


# ---- fold = scan, bitwise, in the port ----

def _fold(log_pi, log_A, log_obs, mask=None):
    st = ton.stream_init(log_pi, log_obs[..., 0, :], None if mask is None else mask[..., 0])
    alphas, lls = [st.log_alpha], [st.loglik]
    tv = log_A.ndim == log_obs.ndim + 1
    for t in range(1, log_obs.shape[-2]):
        lA = log_A[..., t - 1, :, :] if tv else log_A
        st = ton.stream_step(st, lA, log_obs[..., t, :], None if mask is None else mask[..., t])
        alphas.append(st.log_alpha)
        lls.append(st.loglik)
    return torch.stack(alphas, dim=-2), torch.stack(lls, dim=-1)


@pytest.mark.parametrize("case", ["f32", "f64", "masked", "time_varying"])
def test_fold_matches_scan_bitwise(case):
    rng = np.random.default_rng(5)
    dtype = np.float64 if case == "f64" else np.float32
    lp, lA, lo = _t(*_random_hmm(rng, 4, 64, 4, dtype, time_varying=case == "time_varying"))
    mask = None
    if case == "masked":
        m = np.ones((4, 64), np.float32)
        m[1, 40:] = 0.0
        m[2, 10:20] = 0.0
        mask = torch.as_tensor(m)
    a_fold, l_fold = _fold(lp, lA, lo, mask)
    a_scan, l_scan = ton.filter_scan(lp, lA, lo, mask)
    assert torch.equal(a_fold, a_scan) and torch.equal(l_fold, l_scan)


@pytest.mark.parametrize("time_varying", [False, True])
def test_scan_matches_jax_scan(time_varying):
    rng = np.random.default_rng(6)
    lp, lA, lo = _random_hmm(rng, 3, 48, 4, time_varying=time_varying)
    m = np.ones((3, 48), np.float32)
    m[0, 30:] = 0.0
    a, l = ton.filter_scan(*_t(lp, lA, lo, m))
    for i in range(3):
        ja, jl = jon.filter_scan(jnp.asarray(lp[i]), jnp.asarray(lA[i]), jnp.asarray(lo[i]),
                                 jnp.asarray(m[i]))
        _close(a[i], ja, rtol=1e-5)
        _close(l[i], jl, rtol=1e-5)


@pytest.mark.parametrize("time_varying", [False, True])
def test_scan_f64_matches_oracle(time_varying):
    """The normalisation identity against the float64 oracle:
    ``log_alpha_norm = alpha - lse(alpha)``, ``loglik = lse(alpha)``."""
    from scipy.special import logsumexp

    rng = np.random.default_rng(7)
    lp, lA, lo = _random_hmm(rng, 2, 40, 3, np.float64, time_varying=time_varying)
    a, l = ton.filter_scan(*_t(lp, lA, lo))
    for i in range(2):
        alpha, _ = forward_np(lp[i], lA[i], lo[i])
        lse = logsumexp(alpha, axis=-1)
        np.testing.assert_allclose(a[i].numpy(), alpha - lse[:, None], rtol=0, atol=1e-10)
        np.testing.assert_allclose(l[i].numpy(), lse, rtol=0, atol=1e-10)


def test_impossible_evidence_degrades_not_nan():
    lp = torch.log(torch.tensor([0.5, 0.5]))
    lA = torch.log(torch.tensor([[0.9, 0.1], [0.1, 0.9]]))
    st = ton.stream_init(lp, torch.zeros(2))
    st = ton.stream_step(st, lA, torch.full((2,), float("-inf")))
    assert not torch.isnan(st.log_alpha).any() and not torch.isnan(st.loglik)
    assert st.loglik == float("-inf")
    j = jon.stream_step(jon.stream_init(jnp.asarray(lp.numpy()), jnp.zeros(2)),
                        jnp.asarray(lA.numpy()), jnp.full((2,), -jnp.inf))
    np.testing.assert_array_equal(st.log_alpha.numpy(), np.asarray(j.log_alpha))


# ---- forecasts ----

def test_predictive_state_logprobs_matches_jax():
    rng = np.random.default_rng(8)
    lp, lA, _ = _random_hmm(rng, 4, 2, 3)
    a = np.log(rng.dirichlet(np.ones(3), size=4)).astype(np.float32)
    got = ton.predictive_state_logprobs(*_t(a, lA))
    for i in range(4):
        _close(got[i], jon.predictive_state_logprobs(jnp.asarray(a[i]), jnp.asarray(lA[i])))


@pytest.mark.parametrize("weights", ["none", "mask", "fractional", "all_dead"])
def test_posterior_predictive_mean_matches_jax(weights):
    rng = np.random.default_rng(9)
    D, K = 5, 3
    a = np.log(rng.dirichlet(np.ones(K), size=D)).astype(np.float32)
    lA = np.log(rng.dirichlet(np.ones(K), size=(D, K))).astype(np.float32)
    mu = rng.normal(size=(D, K)).astype(np.float32)
    mu[3] = np.nan  # a quarantined draw's NaN parameters
    w = {"none": None, "mask": np.array([1, 1, 0, 0, 1], bool),
         "fractional": np.array([0.5, 0.2, 0.1, 0.0, 0.2], np.float32),
         "all_dead": np.zeros(D, bool)}[weights]
    if weights == "none":
        mu[3] = 0.0
    got = ton.posterior_predictive_mean(*_t(a, lA, mu), weights=None if w is None else torch.as_tensor(w))
    want = jon.posterior_predictive_mean(jnp.asarray(a), jnp.asarray(lA), jnp.asarray(mu),
                                         weights=None if w is None else jnp.asarray(w))
    _close(got, want)
    assert np.isfinite(float(got))


def test_posterior_predictive_mean_dmax_collapse():
    rng = np.random.default_rng(10)
    D, K, Dmax = 4, 2, 3
    a = np.log(rng.dirichlet(np.ones(K * Dmax), size=D)).astype(np.float32)
    lA = np.log(rng.dirichlet(np.ones(K * Dmax), size=(D, K * Dmax))).astype(np.float32)
    mu = rng.normal(size=(D, K)).astype(np.float32)
    got = ton.posterior_predictive_mean(*_t(a, lA, mu), dmax=Dmax)
    _close(got, jon.posterior_predictive_mean(jnp.asarray(a), jnp.asarray(lA), jnp.asarray(mu), dmax=Dmax))
    with pytest.raises(ValueError, match="dmax"):
        ton.posterior_predictive_mean(*_t(a, lA, mu))


# ---- detectors ----

def test_regime_detector_matches_jax():
    """A probability stream whose top-two gaps stay at least 0.1 away
    from the margin (0.2): both detectors commit and flip alike."""
    rng = np.random.default_rng(12)
    tops = rng.integers(0, 2, size=200)
    gaps = rng.choice([0.05, 0.4], size=200)  # indecisive or decisive, never near 0.2
    probs = np.stack([np.where(tops == 0, 0.5 + gaps / 2, 0.5 - gaps / 2),
                      np.where(tops == 0, 0.5 - gaps / 2, 0.5 + gaps / 2)], axis=-1)
    a, b = ton.RegimeDetector(hold=2, margin=0.2), jon.RegimeDetector(hold=2, margin=0.2)
    out_a = [a.update(p) for p in probs]
    out_b = [b.update(p) for p in probs]
    assert out_a == out_b
    assert sum(f for _, f in out_a) > 0


def test_loglik_cusum_matches_jax():
    rng = np.random.default_rng(13)
    inc = np.concatenate([rng.normal(-1.0, 0.1, size=80), rng.normal(-2.0, 0.1, size=60)])
    inc[90] = -np.inf
    inc[91] = np.inf
    a, b = ton.LoglikCUSUM(calibrate=20), jon.LoglikCUSUM(calibrate=20)
    out_a = [a.update(x) for x in inc]
    out_b = [b.update(x) for x in inc]
    assert [f for _, f in out_a] == [f for _, f in out_b]
    np.testing.assert_allclose([s for s, _ in out_a], [s for s, _ in out_b], rtol=1e-12)
    assert a.alarms == b.alarms > 0


def test_online_flip_detector_matches_jax():
    a, b = online_flip_detector(hold=2), j_online_flip_detector(hold=2)
    assert type(a).__module__ == "hhmm_tpu_torch.serve.online"
    stream = [[0.9, 0.1], [0.1, 0.9], [0.1, 0.9], [0.8, 0.2], [0.7, 0.3]]
    assert [a.update(p) for p in stream] == [b.update(p) for p in stream]


@pytest.mark.parametrize("kind", ["gaussian", "gaussian_hsmm"])
def test_online_forecast_mean_matches_jax(kind):
    """The served one-step forecast off both schedulers, given the same
    draws and ticks (one NaN draw among healthy ones: both quarantine it
    and leave it out)."""
    if kind == "gaussian":
        model, jmodel = tm.GaussianHMM(K=2), jm.GaussianHMM(K=2)
    else:
        model, jmodel = tm.GaussianHSMM(2, 3), jm.GaussianHSMM(2, 3)
    rng = np.random.default_rng(14)
    x = rng.normal(size=10).astype(np.float32)
    draws = (0.4 * rng.normal(size=(4, model.n_free))).astype(np.float32)
    draws[2] = np.nan
    sched = MicroBatchScheduler(model, buckets=(2,), device="cpu")
    sched.attach("g", PosteriorSnapshot(spec=model_spec(model), draws=draws))
    jsched = JScheduler(jmodel, buckets=(2,))
    jsched.attach("g", JSnapshot(spec=j_model_spec(jmodel), draws=draws))
    for t in range(len(x)):
        r = sched.tick({"g": {"x": float(x[t])}})["g"]
        jr = jsched.tick({"g": {"x": float(x[t])}})["g"]
        assert r.healthy_draws == jr.healthy_draws == 3
    got, want = online_forecast_mean(sched, "g"), j_online_forecast_mean(jsched, "g")
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
