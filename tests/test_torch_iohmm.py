"""The port's input-output HMMs (`hhmm_tpu_torch/models/iohmm.py`) and
their simulator (`hhmm_tpu_torch/sim/iohmm.py`) against the JAX package,
on the same NumPy inputs, for all four classes in both transition modes.

Tolerances (float32 on both sides):

- terms (``unpack``, ``pack``, ``build``, ``build_vg``, ``log_prior``)
  rtol 1e-5 + atol 1e-5;
- ``make_logp`` and ``make_vg`` against the JAX package: value rtol
  1e-5, gradient rtol 1e-3 + atol 1e-3 (the JAX value-and-grad test's
  atol, ``tests/test_pallas.py:347-349``; the gradients reach a few
  hundred at T=120, and the two packages' float32 scans round apart);
- the port's ``make_vg`` against its own ``make_logp``: the JAX test's
  rtol 2e-5 and rtol 2e-3 + atol 1e-3, dense, ragged (mask at 87 of
  120) and T=1;
- ``generated``: probabilities atol 3e-5 (the smoothed rows of the two
  packages' float32 scans part by up to 1.4e-5 at T=120), loglik rtol
  1e-5, the Viterbi path exactly; ``oblik_t`` rtol 1e-5 + atol 1e-4;
- ``state_draws``: per-step state frequencies of 4000 Gumbel FFBS paths
  within 5 binomial sigma of the JAX ``gamma``;
- inits: the un-jittered parts within rtol 1e-5 of the JAX init on the
  same data, the jittered ones within 5 jitter sigma of it;
- ``iohmm_sim``: state frequencies and per-state moments within 5 sigma.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import betaln as sp_betaln

from hhmm_tpu.apps.hassan.wf import DEFAULT_HYPERPARAMS as J_HP
from hhmm_tpu.infer import sample_gibbs as j_sample_gibbs
from hhmm_tpu.models import iohmm as j_iohmm
from hhmm_tpu_torch.apps.hassan import DEFAULT_HYPERPARAMS
from hhmm_tpu_torch.convert import model_from_jax, params_from_jax
from hhmm_tpu_torch.infer import GibbsConfig, sample_gibbs
from hhmm_tpu_torch.models import IOHMMHMix, IOHMMReg
from hhmm_tpu_torch.models.iohmm import betaln
from hhmm_tpu_torch.sim import iohmm_sim, obsmodel_mix, obsmodel_reg

torch.set_num_threads(1)

K, M, L, T = 3, 4, 3, 120
T_RAGGED = 87
TERM_TOL = dict(rtol=1e-5, atol=1e-5)
CLASSES = ("IOHMMReg", "IOHMMMix", "IOHMMHMix", "IOHMMHMixLite")
MODES = ("stan", "gen")


def _jax_model(name, mode):
    cls = getattr(j_iohmm, name)
    if name == "IOHMMReg":
        return cls(K=K, M=M, trans_mode=mode)
    if name == "IOHMMMix":
        return cls(K=K, M=M, L=L, trans_mode=mode)
    return cls(K=K, M=M, L=L, hyperparams=J_HP, trans_mode=mode)


def _models(name, mode):
    jm = _jax_model(name, mode)
    return model_from_jax(jm), jm


def _data(seed=0, T=T, ragged=False):
    """``u`` with an intercept column, ``x`` from a K-state regression
    with destination-indexed input-driven states (NumPy, float32)."""
    rng = np.random.default_rng(seed)
    u = np.column_stack([np.ones(T), rng.normal(size=(T, M - 1))])
    w = rng.normal(size=(K, M))
    b = rng.normal(size=(K, M)) * 1.5
    logits = u @ w.T
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    z = np.array([rng.choice(K, p=pt) for pt in p])
    x = (u * b[z]).sum(1) + 0.4 * rng.normal(size=T)
    d = {"x": x.astype(np.float32), "u": u.astype(np.float32)}
    if ragged:
        d["mask"] = (np.arange(T) < T_RAGGED).astype(np.float32)
    return d


def _t(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _theta(jm, data, seed=1):
    """A JAX init on the data, moved off it by a small NumPy step, so the
    terms are checked away from the init's own structure."""
    th = np.asarray(jm.init_unconstrained(jax.random.PRNGKey(seed), _j(data)))
    rng = np.random.default_rng(seed)
    return (th + 0.1 * rng.normal(size=th.shape)).astype(np.float32)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CLASSES)
def test_terms_match_jax(name, mode, ragged):
    model, jm = _models(name, mode)
    data = _data(ragged=ragged)
    theta = _theta(jm, data)
    params, ldj = model.unpack(params_from_jax(model, theta, device="cpu"))
    jparams, jldj = jm.unpack(jnp.asarray(theta))
    assert set(params) == set(jparams)
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), **TERM_TOL, err_msg=k)
    np.testing.assert_allclose(float(ldj), float(jldj), rtol=1e-5)
    np.testing.assert_allclose(model.pack(params).numpy(), theta, rtol=1e-4, atol=1e-4)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    np.testing.assert_allclose(float(model.log_prior(params)), float(jm.log_prior(jp)), rtol=1e-5)
    for build in ("build", "build_vg"):
        got = getattr(model, build)(params, _t(data))
        want = getattr(jm, build)(jp, _j(data))
        for term, a, b in zip(("log_pi", "log_A", "log_obs"), got, want):
            assert tuple(a.shape) == tuple(np.shape(b)), (build, term)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TERM_TOL, err_msg=f"{build} {term}")
        if ragged:
            np.testing.assert_array_equal(got[3].numpy(), data["mask"])
        else:
            assert got[3] is None and want[3] is None


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CLASSES)
def test_logp_and_vg_match_jax(name, mode, ragged):
    """``make_logp`` (value and autograd gradient) and ``make_vg`` against
    ``jax.value_and_grad(make_logp)`` and the JAX ``make_vg``; then the
    port's ``make_vg`` against its own ``make_logp``."""
    model, jm = _models(name, mode)
    data = _data(ragged=ragged)
    theta = _theta(jm, data)
    jv, jg = jax.value_and_grad(jm.make_logp(_j(data)))(jnp.asarray(theta))
    jvv, jgv = jm.make_vg(_j(data))(jnp.asarray(theta))
    th = torch.as_tensor(theta).requires_grad_(True)
    v = model.make_logp(_t(data))(th)
    (g,) = torch.autograd.grad(v, th)
    v = v.detach()
    vv, gv = model.make_vg(_t(data))(torch.as_tensor(theta))
    for val, grad, want_v, want_g in ((v, g, jv, jg), (vv, gv, jvv, jgv)):
        np.testing.assert_allclose(float(val), float(want_v), rtol=1e-5)
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(vv), float(v), rtol=2e-5)
    np.testing.assert_allclose(gv.numpy(), g.numpy(), rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ("IOHMMReg", "IOHMMHMix"))
def test_vg_matches_logp_on_a_batch_of_ragged_series(name, mode):
    """``u [B, T, M]`` against lanes ``[B, C]``: each series its own
    data and tail mask, the fold's mask factor dropping the padded
    transitions; equal to the per-series unpadded calls."""
    model, jm = _models(name, mode)
    B, C, lens = 3, 2, (120, 87, 40)
    per = [_data(seed=s, T=n) for s, n in zip((3, 4, 5), lens)]
    data = {
        "x": np.zeros((B, T), np.float32),
        "u": np.zeros((B, T, M), np.float32),
        "mask": np.zeros((B, T), np.float32),
    }
    for i, (d, n) in enumerate(zip(per, lens)):
        data["x"][i, :n], data["u"][i, :n], data["mask"][i, :n] = d["x"], d["u"], 1.0
    rng = np.random.default_rng(6)
    theta = np.stack([
        np.stack([_theta(jm, d, seed=10 + c) for c in range(C)]) for d in per
    ]) + 0.05 * rng.normal(size=(B, C, model.n_free)).astype(np.float32)
    theta = torch.as_tensor(theta, dtype=torch.float32)
    vv, gv = model.make_vg(_t(data))(theta)
    th = theta.clone().requires_grad_(True)
    v = model.make_logp(_t(data))(th)
    (g,) = torch.autograd.grad(v.sum(), th)
    assert tuple(vv.shape) == (B, C) and tuple(gv.shape) == (B, C, model.n_free)
    np.testing.assert_allclose(vv.numpy(), v.detach().numpy(), rtol=2e-5)
    np.testing.assert_allclose(gv.numpy(), g.numpy(), rtol=2e-3, atol=1e-3)
    for i, d in enumerate(per):
        vi, gi = model.make_vg(_t(d))(theta[i])
        np.testing.assert_allclose(vv[i].numpy(), vi.numpy(), rtol=2e-5)
        np.testing.assert_allclose(gv[i].numpy(), gi.numpy(), rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("mode", MODES)
def test_single_step_series(mode):
    """T=1: no transitions to fold (``tests/test_pallas.py:352-365``)."""
    model, jm = _models("IOHMMReg", mode)
    rng = np.random.default_rng(7)
    data = {"u": rng.normal(size=(1, M)).astype(np.float32),
            "x": rng.normal(size=(1,)).astype(np.float32)}
    theta = rng.normal(size=model.n_free).astype(np.float32)
    jv, jg = jm.make_vg(_j(data))(jnp.asarray(theta))
    v, g = model.make_vg(_t(data))(torch.as_tensor(theta))
    th = torch.as_tensor(theta).requires_grad_(True)
    lv = model.make_logp(_t(data))(th)
    (lg,) = torch.autograd.grad(lv, th)
    lv = lv.detach()
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(v), float(lv), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), lg.numpy(), rtol=1e-3, atol=1e-4)


def _draws(jm, data, n=4, seed=8):
    base = _theta(jm, data, seed=seed)
    rng = np.random.default_rng(seed)
    return (base + 0.05 * rng.normal(size=(n, base.shape[0]))).astype(np.float32)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_generated_matches_jax(mode, ragged):
    model, jm = _models("IOHMMReg", mode)
    data = _data(seed=9, ragged=ragged)
    theta = _draws(jm, data)
    got = model.generated(torch.as_tensor(theta), _t(data), device="cpu")
    want = jm.generated(jnp.asarray(theta), _j(data))
    for k in ("alpha", "gamma"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=3e-5, err_msg=k)
    np.testing.assert_allclose(got["loglik"].numpy(), np.asarray(want["loglik"]), rtol=1e-5)
    # the Viterbi path exactly, on a fixture whose max-plus margins are
    # far from float32 rounding (checked: the runner-up is >1e-3 behind)
    np.testing.assert_array_equal(got["zstar"].numpy(), np.asarray(want["zstar"]))
    np.testing.assert_allclose(got["logp_zstar"].numpy(), np.asarray(want["logp_zstar"]), rtol=1e-5)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_hmix_lite_oblik_matches_jax(mode, ragged):
    model, jm = _models("IOHMMHMixLite", mode)
    data = _data(seed=10, ragged=ragged)
    theta = _draws(jm, data).reshape(2, 2, -1)
    got = model.generated(torch.as_tensor(theta), _t(data), device="cpu")["oblik_t"]
    want = jm.generated(jnp.asarray(theta), _j(data))["oblik_t"]
    assert tuple(got.shape) == (2, 2, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_state_draws_follow_the_jax_gamma(mode):
    """4000 Gumbel FFBS paths of one draw (the time-varying route): the
    per-step state frequencies within 5 binomial sigma of the JAX
    smoothed probabilities."""
    model, jm = _models("IOHMMReg", mode)
    data = _data(seed=11, T=60)
    theta = _theta(jm, data)
    gamma = np.asarray(jm.generated(jnp.asarray(theta)[None], _j(data))["gamma"])[0]
    n = 4000
    gen = torch.Generator().manual_seed(0)
    z = model.state_draws(gen, torch.as_tensor(theta).expand(n, -1), _t(data), device="cpu")
    assert tuple(z.shape) == (n, 60)
    freq = torch.nn.functional.one_hot(z, K).float().mean(0).numpy()
    sd = np.sqrt(np.clip(gamma * (1 - gamma), 1e-4, None) / n)
    assert np.abs(freq - gamma).max() / sd[np.unravel_index(np.abs(freq - gamma).argmax(), sd.shape)] < 5
    assert (np.abs(freq - gamma) < 5 * sd + 1e-3).all()


def test_betaln_matches_scipy():
    a = torch.tensor([0.5, 1.0, 1.0, 2.5, 7.0, 30.0], dtype=torch.float64)
    b = torch.tensor([0.5, 1.0, 3.0, 0.7, 2.0, 45.0], dtype=torch.float64)
    np.testing.assert_allclose(betaln(a, b).numpy(), sp_betaln(a.numpy(), b.numpy()), rtol=1e-12)
    np.testing.assert_allclose(betaln(a.float(), b.float()).numpy(),
                               sp_betaln(a.numpy(), b.numpy()), rtol=1e-5, atol=1e-6)


def test_hyperparams_arity_enforced():
    with pytest.raises(ValueError, match="9 elements"):
        IOHMMHMix(K=2, M=2, L=2, hyperparams=[0, 5, 1, 0, 3, 1, 1])
    np.testing.assert_array_equal(DEFAULT_HYPERPARAMS, J_HP)
    assert IOHMMHMix(2, 2, 2, DEFAULT_HYPERPARAMS).hyperparams.dtype == np.float64


def test_sample_gibbs_refuses_iohmm():
    data = {"x": np.zeros(10, np.float32), "u": np.zeros((10, 2), np.float32)}
    with pytest.raises(ValueError, match="gibbs_update") as port:
        sample_gibbs(IOHMMReg(K=2, M=2), _t({k: v[None] for k, v in data.items()}),
                     torch.zeros(1, 1, IOHMMReg(2, 2).n_free), GibbsConfig(1, 1), device="cpu")
    with pytest.raises(ValueError, match="gibbs_update") as ref:
        j_sample_gibbs(j_iohmm.IOHMMReg(K=2, M=2), data, jax.random.PRNGKey(0))
    assert str(port.value) == str(ref.value)


def test_model_from_jax_carries_the_configuration():
    for name in CLASSES:
        for mode in MODES:
            model, jm = _models(name, mode)
            assert type(model).__name__ == name and model.trans_mode == mode
            assert model.n_free == jm.n_free
            assert [n for n, _ in model.specs()] == [n for n, _ in jm.specs()]
            if hasattr(jm, "hyperparams"):
                np.testing.assert_array_equal(model.hyperparams, np.asarray(jm.hyperparams))


@pytest.mark.parametrize("name", ("IOHMMReg", "IOHMMHMix"))
def test_inits_match_jax(name):
    """The same k-means (``seed=0``) on the same data: the un-jittered
    parts equal JAX's, the jittered parts within 5 jitter sigma."""
    model, jm = _models(name, "stan")
    data = _data(seed=12)
    gen = torch.Generator().manual_seed(3)
    got, _ = model.unpack(model.init_unconstrained(gen, _t(data))[None])
    want, _ = jm.unpack(jm.init_unconstrained(jax.random.PRNGKey(3), _j(data)))
    got = {k: v[0].numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    r2 = np.sqrt(2.0)  # two independent jitters
    if name == "IOHMMReg":
        for k in ("p_1k", "s_k"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        s = want["s_k"][:, None]
        assert (np.abs(got["b_km"] - want["b_km"]) < 5 * r2 * 0.2 * s).all()
        assert (np.abs(got["w_km"] - want["w_km"]) < 5 * r2 * 0.1).all()
    else:
        for k in ("p_1k", "s_kl", "lambda_kl"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["w_km"], want["w_km"], atol=1e-6)
        bound = 5 * r2 * 0.05 * want["s_kl"].max(1, keepdims=True) + 1e-3
        assert (np.abs(got["mu_kl"] - want["mu_kl"]) < bound).all()
        assert (np.abs(got["hypermu_k"] - want["hypermu_k"]) < bound[:, 0]).all()


def test_iohmm_sim_reg_moments():
    """``z`` frequencies against ``p_mat``, and the regression residuals'
    per-state mean and sd, within 5 sigma."""
    rng = np.random.default_rng(13)
    n = 6000
    u = np.column_stack([np.ones(n), rng.normal(size=(n, M - 1))])
    w = rng.normal(size=(K, M))
    b = rng.normal(size=(K, M))
    sigma = np.array([0.3, 0.5, 0.8])
    out = iohmm_sim(torch.Generator().manual_seed(1), u, w, obsmodel_reg(b, sigma))
    assert set(out) == {"u", "z", "x", "p_mat"}
    z, x, p = out["z"].numpy(), out["x"].numpy(), out["p_mat"].numpy()
    assert out["z"].dtype == torch.int64 and z.shape == (n,) and p.shape == (n, K)
    np.testing.assert_allclose(p.sum(1), 1.0, rtol=1e-5)
    for k in range(K):
        hit = (z == k).astype(np.float64)
        assert abs(hit.mean() - p[:, k].mean()) < 5 * np.sqrt((p[:, k] * (1 - p[:, k])).sum()) / n
        r = (x - (out["u"].numpy() * b[z]).sum(1))[z == k]
        assert abs(r.mean()) < 5 * sigma[k] / np.sqrt(r.size)
        assert abs(r.std() / sigma[k] - 1) < 5 / np.sqrt(2 * r.size)


def test_iohmm_sim_mix_moments():
    rng = np.random.default_rng(14)
    n = 6000
    u = np.column_stack([np.ones(n), rng.normal(size=n)])
    w = rng.normal(size=(2, 2))
    lam = np.array([[0.2, 0.8], [0.6, 0.4]])
    mu = np.array([[-3.0, -1.0], [1.0, 4.0]])
    sd = np.full((2, 2), 0.5)
    out = iohmm_sim(torch.Generator().manual_seed(2), u, w, obsmodel_mix(lam, mu, sd))
    z, x = out["z"].numpy(), out["x"].numpy()
    for k in range(2):
        xk = x[z == k]
        mean = (lam[k] * mu[k]).sum()
        var = (lam[k] * (sd[k] ** 2 + mu[k] ** 2)).sum() - mean**2
        assert abs(xk.mean() - mean) < 5 * np.sqrt(var / xk.size)


def test_iohmm_sim_validates():
    g = torch.Generator()
    with pytest.raises(ValueError, match=r"u must be \[T, M\]"):
        iohmm_sim(g, np.zeros(5), np.zeros((2, 1)), obsmodel_reg(np.zeros((2, 1)), np.ones(2)))
    with pytest.raises(ValueError, match="w must be"):
        iohmm_sim(g, np.zeros((5, 2)), np.zeros((2, 3)), obsmodel_reg(np.zeros((2, 2)), np.ones(2)))


@pytest.mark.slow
def test_iohmm_reg_recovery_through_fit_batched():
    """``tests/test_models.py::test_iohmm_reg_recovery`` (gen mode, T=300,
    K=2, M=3) on the port's ``fit_batched`` NUTS arm, which runs the
    folded value-and-grad: the same bounds on ``b`` and ``s``."""
    from hhmm_tpu_torch.batch import fit_batched
    from hhmm_tpu_torch.infer import SamplerConfig

    rng = np.random.default_rng(3)
    Tr, Kr, Mr = 300, 2, 3
    u = np.column_stack([np.ones(Tr), rng.normal(size=(Tr, Mr - 1))])
    w = np.array([[1.5, 0.5, -0.5], [-1.5, -0.5, 0.5]])
    b = np.array([[2.0, 1.0, 0.0], [-2.0, 0.0, 1.0]])
    s = np.array([0.4, 0.4])
    out = iohmm_sim(torch.Generator().manual_seed(5), u, w, obsmodel_reg(b, s))
    model = IOHMMReg(K=Kr, M=Mr, trans_mode="gen")
    data = {"x": out["x"][None], "u": out["u"][None]}
    qs, stats = fit_batched(model, data, SamplerConfig(100, 100, 2, max_treedepth=5),
                            seed=4, device="cpu")
    post = model.constrained_draws(qs[0])
    b_hat = post["b_km"].mean((0, 1)).numpy()
    s_hat = post["s_k"].mean((0, 1)).numpy()
    perm = [int(np.argmin(np.abs(b_hat[:, 0] - b[k, 0]))) for k in range(Kr)]
    assert sorted(perm) == list(range(Kr))
    np.testing.assert_allclose(b_hat[perm], b, atol=0.25)
    np.testing.assert_allclose(s_hat[perm], s, atol=0.15)


def test_batch_helpers_take_an_event_axis_key(tmp_path):
    """``default_init`` (padding dropped from ``u [B, T, M]`` too),
    ``fit_batched``'s chunk slicing with a ragged last chunk, and its
    digest cache (a rerun reads every chunk back bitwise) on a key with
    two event axes."""
    from hhmm_tpu_torch.batch import default_init, fit_batched
    from hhmm_tpu_torch.infer import SamplerConfig

    model = IOHMMReg(K=2, M=2, trans_mode="gen")
    lens = (16, 11, 13)
    B, Tm = len(lens), max(lens)
    rng = np.random.default_rng(15)
    data = {"x": np.zeros((B, Tm), np.float32), "u": np.zeros((B, Tm, 2), np.float32),
            "mask": np.zeros((B, Tm), np.float32)}
    for i, n in enumerate(lens):
        data["u"][i, :n] = np.column_stack([np.ones(n), rng.normal(size=n)])
        data["x"][i, :n] = rng.normal(size=n)
        data["mask"][i, :n] = 1.0
    init = default_init(model, _t(data), B, 1, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(5)
    want = torch.stack([
        model.init_unconstrained(gen, {"x": torch.as_tensor(data["x"][i, :n]),
                                       "u": torch.as_tensor(data["u"][i, :n])})[None]
        for i, n in enumerate(lens)
    ])
    assert torch.equal(init, want)
    kw = dict(init=init, chunk_size=2, cache_dir=str(tmp_path), seed=1, device="cpu")
    cfg = SamplerConfig(3, 3, 1, max_treedepth=2)
    qs, stats = fit_batched(model, data, cfg, **kw)
    assert tuple(qs.shape) == (B, 1, 3, model.n_free)
    assert bool(torch.isfinite(qs).all()) and bool(stats["chain_healthy"].all())
    again, _ = fit_batched(model, data, cfg, **kw)
    assert torch.equal(again, qs)
