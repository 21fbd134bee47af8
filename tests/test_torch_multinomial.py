"""The port's multinomial HMMs (`hhmm_tpu_torch/models/multinomial_hmm.py`)
and ``models/base.py::semisup_gate`` against the JAX package.

- ``build``, ``loglik`` and ``make_vg`` of ``MultinomialHMM`` and of
  ``SemisupMultinomialHMM`` under both gates, with and without a tail
  mask, and ``gibbs_update``'s Dirichlet concentrations (the count
  parameters: the draws themselves differ by the random streams), rtol
  1e-6 + atol 1e-5; ``semisup_gate`` itself; the JAX parameters carried
  across by ``convert``;
- the stan gates' conjugacy on the port's own conditionals
  (``tests/test_gibbs.py``'s ``TestStanGateConjugacy``): for a fixed
  path, the joint's log ratio between two parameter draws equals the
  log ratio of the Beta/Dirichlet conditionals that the port's
  ``gibbs_update`` draws from, for the semisup multinomial and the
  Tayal model (its path from the port's Gumbel FFBS);
- ``sample_gibbs`` on a time-varying ``log_A`` without gate keys (the
  scan filter and the Gumbel-max draw) against the gated kernels' route
  in distribution;
- ``slow``: ``tests/test_models.py::test_multinomial_hmm_recovery`` on
  the port's NUTS.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import beta as sp_beta
from scipy.stats import dirichlet as sp_dir

from hhmm_tpu.models import MultinomialHMM as JMultinomialHMM
from hhmm_tpu.models import SemisupMultinomialHMM as JSemisupMultinomialHMM
from hhmm_tpu.models.base import semisup_gate as j_semisup_gate
from hhmm_tpu_torch.convert import constrained_from_jax, model_from_jax, params_from_jax
from hhmm_tpu_torch.infer import SamplerConfig, greedy_relabel, init_chains, sample_nuts
from hhmm_tpu_torch.kernels.ffbs import backward_sample
from hhmm_tpu_torch.kernels.filtering import forward_filter
from hhmm_tpu_torch.models import MultinomialHMM, SemisupMultinomialHMM, TayalHHMM, semisup_gate
from hhmm_tpu_torch.models import multinomial_hmm as mh_module
from hhmm_tpu_torch.models import tayal as tayal_module
from hhmm_tpu_torch.models.tayal import UP, _UP_STATES
from hhmm_tpu_torch.sim import hmm_sim, obsmodel_categorical

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-5)
GROUPS = (0, 1, 1, 0)

CASES = {
    "multinom": (lambda m: m.MultinomialHMM(K=3, L=5), 3, 5),
    "semisup_stan": (lambda m: m.SemisupMultinomialHMM(K=4, L=9, groups=GROUPS), 4, 9),
    "semisup_hard": (lambda m: m.SemisupMultinomialHMM(K=4, L=9, groups=GROUPS,
                                                       gate_mode="hard"), 4, 9),
}


class _Port:
    MultinomialHMM, SemisupMultinomialHMM = MultinomialHMM, SemisupMultinomialHMM


class _Jax:
    MultinomialHMM, SemisupMultinomialHMM = JMultinomialHMM, JSemisupMultinomialHMM


def _models(case):
    make = CASES[case][0]
    return make(_Port), make(_Jax)


def _data(case, T=40, seed=0, masked=False):
    _, K, L = CASES[case]
    rng = np.random.default_rng(seed)
    d = {"x": rng.integers(0, L, T).astype(np.int32), "g": rng.integers(0, 2, T).astype(np.int32)}
    if masked:
        d["mask"] = (np.arange(T) < T - 7).astype(np.float32)
    return d


def _rand_params(rng, K, L):
    return {
        "p_1k": rng.dirichlet(np.ones(K)).astype(np.float32),
        "A_ij": rng.dirichlet(np.ones(K), size=K).astype(np.float32),
        "phi_k": rng.dirichlet(np.ones(L), size=K).astype(np.float32),
    }


def _t(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_build_and_loglik_match_jax(case, masked):
    model, jmodel = _models(case)
    _, K, L = CASES[case]
    data = _data(case, masked=masked)
    params = _rand_params(np.random.default_rng(1), K, L)
    got = model.build(_t(params), _t(data))
    want = jmodel.build(_j(params), _j(data))
    for name, a, b in zip(("log_pi", "log_A", "log_obs"), got, want):
        assert tuple(a.shape) == tuple(np.shape(b)), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=name)
    if masked:
        np.testing.assert_array_equal(got[3].numpy(), data["mask"])
    np.testing.assert_allclose(float(model.loglik(_t(params), _t(data))),
                               float(jmodel.loglik(_j(params), _j(data))), rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_vg_matches_jax(case):
    model, jmodel = _models(case)
    data = _data(case, T=48, masked=True)
    theta = np.random.default_rng(2).normal(size=(3, model.n_free)).astype(np.float32)
    lp, g = model.make_vg(_t(data))(torch.as_tensor(theta))
    jlp, jg = jax.vmap(jmodel.make_vg(_j(data)))(jnp.asarray(theta))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4)
    # and the autograd target through build (the scans), which the
    # gate keys must not change
    lp2 = model.make_logp(_t(data))(torch.as_tensor(theta))
    np.testing.assert_allclose(lp.numpy(), lp2.numpy(), rtol=1e-5, atol=1e-4)


def _capture_conc(monkeypatch, module, names=("dirichlet",)):
    """Replace the Beta/Dirichlet draws in ``module`` by their parameters."""
    for n in names:
        if n == "dirichlet":
            monkeypatch.setattr(module, "dirichlet", lambda gen, alpha: alpha)
        else:
            monkeypatch.setattr(module, "beta", lambda gen, a, b: torch.stack([a, b], -1))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gibbs_update_counts_match_jax(case, masked, monkeypatch):
    model, jmodel = _models(case)
    _, K, _ = CASES[case]
    data = _data(case, T=50, seed=4, masked=masked)
    z = np.random.default_rng(5).integers(0, K, 50)
    _capture_conc(monkeypatch, mh_module)
    monkeypatch.setattr(jax.random, "dirichlet", lambda key, alpha: alpha)
    got = model.gibbs_update(None, torch.as_tensor(z), _t(data))
    want = jmodel.gibbs_update(jax.random.PRNGKey(0), jnp.asarray(z, jnp.int32), _j(data))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("mode", ["stan", "hard"])
def test_semisup_gate_matches_jax(mode):
    rng = np.random.default_rng(6)
    T, K = 12, 4
    log_pi = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    log_A = np.log(rng.dirichlet(np.ones(K), size=K)).astype(np.float32)
    log_obs = rng.normal(size=(T, K)).astype(np.float32)
    cons = rng.random((T, K)) < 0.5
    got = semisup_gate(*map(torch.as_tensor, (log_pi, log_A, log_obs, cons)), mode)
    want = j_semisup_gate(*map(jnp.asarray, (log_pi, log_A, log_obs, cons)), mode)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # batch-native: two series at once give each series' gate
    two = semisup_gate(*(torch.as_tensor(np.stack([v, v])) for v in (log_pi, log_A, log_obs, cons)),
                       mode)
    for a, b in zip(two, got):
        assert torch.equal(a[1], b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_parameters_carry_across(case):
    _, jmodel = _models(case)
    model = model_from_jax(jmodel)
    assert type(model).__name__ == type(jmodel).__name__ and model.n_free == jmodel.n_free
    assert getattr(model, "gate_mode", None) == getattr(jmodel, "gate_mode", None)
    _, K, L = CASES[case]
    params = _rand_params(np.random.default_rng(7), K, L)
    theta = np.asarray(jmodel.pack(_j(params)))
    port_theta = params_from_jax(model, theta, device="cpu")
    back = model.unpack(port_theta)[0]
    want = constrained_from_jax(model, {k: np.asarray(v) for k, v in
                                        jmodel.unpack(jnp.asarray(theta))[0].items()}, device="cpu")
    for k in back:
        np.testing.assert_allclose(back[k].numpy(), want[k].numpy(), **TOL)
    with pytest.raises(ValueError, match="groups"):
        SemisupMultinomialHMM(K=4, L=9, groups=(0, 1))


# ------------------------------------------------- stan-gate conjugacy


def _logjoint(model, params, z, data):
    """log of the augmented joint of ``model.build`` (flat priors)."""
    log_pi, log_A, log_obs, _ = (np.asarray(v, np.float64) if v is not None else None
                                 for v in model.build(_t(params), _t(data)))
    lp = log_pi[z[0]] + log_obs[0, z[0]]
    for t in range(1, len(z)):
        A_t = log_A[t - 1] if log_A.ndim == 3 else log_A
        lp += A_t[z[t - 1], z[t]] + log_obs[t, z[t]]
    return float(lp)


def _simplex64(v):
    v = np.asarray(v, np.float64)
    return v / v.sum()


def test_semisup_stan_theta_conditional_density_ratio(monkeypatch):
    """`tests/test_gibbs.py::test_semisup_stan_theta_conditional_density_
    ratio` on the port: the conditional is the one ``gibbs_update``
    draws from (its Dirichlet concentrations, captured)."""
    rng = np.random.default_rng(21)
    K, L, T = 4, 5, 150
    model = SemisupMultinomialHMM(K=K, L=L, groups=GROUPS)
    data = {"x": rng.integers(0, L, T), "g": rng.integers(0, 2, T)}
    _capture_conc(monkeypatch, mh_module)

    for _ in range(3):
        z = rng.integers(0, K, T)  # full support: any path is valid
        conc = {k: v.numpy().astype(np.float64)
                for k, v in model.gibbs_update(None, torch.as_tensor(z), _t(data)).items()}

        def log_q(p):
            lq = sp_dir.logpdf(_simplex64(p["p_1k"]), conc["p_1k"])
            for k in range(K):
                lq += sp_dir.logpdf(_simplex64(p["A_ij"][k]), conc["A_ij"][k])
                lq += sp_dir.logpdf(_simplex64(p["phi_k"][k]), conc["phi_k"][k])
            return lq

        t1, t2 = _rand_params(rng, K, L), _rand_params(rng, K, L)
        lhs = _logjoint(model, t1, z, data) - _logjoint(model, t2, z, data)
        rhs = log_q(t1) - log_q(t2)
        assert abs(lhs - rhs) < 5e-2, (lhs, rhs)


def _nonalternating_tayal_data(rng, T=240, frac_same=0.3):
    """``tests/test_gibbs.py``'s (x, sign) with about ``frac_same``
    same-sign adjacent legs, where the stan gate differs from the hard
    one."""
    model = TayalHHMM(gate_mode="hard")
    phi = np.array([rng.dirichlet(np.ones(9) * 0.4) for _ in range(4)])
    params = {"p_11": torch.tensor(0.6), "A_row": torch.as_tensor(rng.dirichlet(np.ones(2), size=2)),
              "phi_k": torch.as_tensor(phi)}
    pi, A = model.assemble(params)
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    z, x = hmm_sim(gen, T, A.numpy(), pi.numpy(), obsmodel_categorical(phi), validate=False)
    sign = np.where(np.asarray(_UP_STATES)[z.numpy()], UP, 1 - UP)
    flip = rng.random(T) < frac_same
    flip[0] = False
    for t in np.flatnonzero(flip):
        sign[t] = sign[t - 1]
    assert (sign[1:] == sign[:-1]).mean() > 0.15
    return x.numpy(), sign


def test_tayal_stan_theta_conditional_density_ratio(monkeypatch):
    """`tests/test_gibbs.py::TestStanGateConjugacy::test_tayal_stan_theta_
    conditional_density_ratio` on the port: paths from the port's Gumbel
    FFBS on the stan gate's time-varying ``log_A``, the conditional the
    one the port's ``gibbs_update`` draws from."""
    rng = np.random.default_rng(22)
    model = TayalHHMM(gate_mode="stan")
    x, sign = _nonalternating_tayal_data(rng)
    data = {"x": x, "sign": sign}
    _capture_conc(monkeypatch, tayal_module, ("dirichlet", "beta"))

    def rand_params():
        return {"p_11": np.float32(rng.uniform(0.1, 0.9)),
                "A_row": rng.dirichlet(np.ones(2), size=2).astype(np.float32),
                "phi_k": rng.dirichlet(np.ones(9), size=4).astype(np.float32)}

    p0 = rand_params()
    log_pi, log_A_t, log_obs, _ = model.build(_t(p0), _t(data))
    assert log_A_t.ndim == 3
    log_alpha, _ = forward_filter(log_pi, log_A_t, log_obs)
    for i in range(3):
        z = backward_sample(torch.Generator().manual_seed(i), log_alpha, log_A_t)
        conc = model.gibbs_update(None, z, _t(data))

        def log_q(p):
            a, b = conc["p_11"].numpy().astype(np.float64)
            lq = sp_beta.logpdf(float(p["p_11"]), a, b)
            ar = conc["A_row"].numpy().astype(np.float64)
            # A_row's free rows: 0 -> {1, 2}, 2 -> {0, 3}
            lq += sp_dir.logpdf(_simplex64(p["A_row"][0]), ar[0])
            lq += sp_dir.logpdf(_simplex64(p["A_row"][1]), ar[1])
            phi_c = conc["phi_k"].numpy().astype(np.float64)
            for k in range(4):
                lq += sp_dir.logpdf(_simplex64(p["phi_k"][k]), phi_c[k])
            return lq

        t1, t2 = rand_params(), rand_params()
        zz = z.numpy()
        lhs = _logjoint(model, t1, zz, data) - _logjoint(model, t2, zz, data)
        rhs = log_q(t1) - log_q(t2)
        assert np.isfinite(lhs) and abs(lhs - rhs) < 5e-2, (i, lhs, rhs)


@pytest.mark.slow
def test_multinomial_hmm_recovery():
    """`tests/test_models.py::test_multinomial_hmm_recovery` on the
    port's NUTS (2 chains, 300 + 300, T=600), the labels undone by
    ``greedy_relabel`` against the simulated path, chain by chain (the
    JAX test relabels the pooled draws; here the chains can settle in
    the two label modes)."""
    A = np.array([[0.85, 0.15], [0.25, 0.75]])
    p1 = np.array([0.5, 0.5])
    phi = np.array([[0.7, 0.2, 0.1], [0.1, 0.15, 0.75]])
    z, x = hmm_sim(torch.Generator().manual_seed(7), 600, A, p1, obsmodel_categorical(phi))
    model = MultinomialHMM(K=2, L=3)
    data = {"x": x}
    init = init_chains(model, data, 2, seed=1, device="cpu")
    qs, _ = sample_nuts(None, init, SamplerConfig(300, 300, 2), seed=2, device="cpu",
                        vg_fn=model.make_vg(data))
    post = model.constrained_draws(qs)
    # undo label switching chain by chain (the two chains may settle in
    # the two label modes), then pool
    phis, As = [], []
    for c in range(qs.shape[0]):
        gen = model.generated(qs[c, ::100], data, device="cpu")
        z_hat = np.median(gen["zstar"].numpy(), axis=0).astype(int)
        inv = np.argsort(greedy_relabel(z.numpy(), z_hat, 2))
        phis.append(post["phi_k"][c].mean(0).numpy()[inv])
        As.append(post["A_ij"][c].mean(0).numpy()[np.ix_(inv, inv)])
    np.testing.assert_allclose(np.mean(phis, 0), phi, atol=0.12)
    np.testing.assert_allclose(np.mean(As, 0), A, atol=0.15)


class _Unkeyed(SemisupMultinomialHMM):
    """The stan gate without gate keys: the Gibbs sweep gets ``build``'s
    time-varying ``log_A``."""

    def gate_keys(self, data):
        return None


def test_gibbs_time_varying_route_targets_the_keyed_posterior(monkeypatch):
    """A time-varying ``log_A`` without gate keys takes the scan filter
    and the Gumbel-max draw in ``sample_gibbs`` (the JAX sweep's route;
    ``ffbs_dispatch`` is not called), and targets the same posterior as
    the gated kernels' route: posterior-mean emission rows within 4
    MCSE, two series, 4 chains, 40 + 160 sweeps."""
    from hhmm_tpu_torch.batch import default_init
    from hhmm_tpu_torch.infer import GibbsConfig, ess, sample_gibbs
    from hhmm_tpu_torch.infer import gibbs as gibbs_module

    rng = np.random.default_rng(31)
    T, B = 60, 2
    z = np.zeros((B, T), np.int64)
    for t in range(1, T):
        z[:, t] = np.where(rng.random(B) < 0.8, z[:, t - 1], rng.integers(0, 4, B))
    phi = rng.dirichlet(np.ones(5) * 0.5, size=4)
    x = np.array([[rng.choice(5, p=phi[k]) for k in row] for row in z])
    data = {"x": torch.as_tensor(x), "g": torch.as_tensor(np.asarray(GROUPS)[z])}
    cfg = GibbsConfig(num_warmup=40, num_samples=160, num_chains=4)
    keyed, unkeyed = SemisupMultinomialHMM(4, 5, GROUPS), _Unkeyed(4, 5, GROUPS)
    init = default_init(keyed, data, B, 4, seed=0, device="cpu")
    qk, _ = sample_gibbs(keyed, data, init, cfg, seed=1, device="cpu")
    monkeypatch.setattr(gibbs_module, "ffbs_dispatch", lambda *a: pytest.fail("kernel route"))
    qu, st = sample_gibbs(unkeyed, data, init, cfg, seed=2, device="cpu")
    assert st["chain_healthy"].all() and torch.isfinite(st["logp"]).all()
    pk = keyed.constrained_draws(qk)["phi_k"].numpy()  # [B, C, S, K, L]
    pu = unkeyed.constrained_draws(qu)["phi_k"].numpy()
    for b in range(B):
        g, w = pu[b].reshape(4, 160, -1), pk[b].reshape(4, 160, -1)
        for j in range(g.shape[-1]):
            mcse = np.hypot(g[..., j].std() / np.sqrt(max(ess(g[..., j]), 1.0)),
                            w[..., j].std() / np.sqrt(max(ess(w[..., j]), 1.0)))
            assert abs(g[..., j].mean() - w[..., j].mean()) < 4 * mcse + 1e-3, (b, j)
