"""The PyTorch port's Tayal model, Gibbs sampler, decode, simulator and
weight conversion against the JAX package on the same inputs.

Tolerances: constrained parameters and model terms within 1e-5
(absolute and relative, f32); counts and Viterbi paths exactly; filtered
probabilities within 1e-5; posterior means of the two Gibbs samplers
within 4·sqrt(mcse_port² + mcse_jax²) per constrained scalar, with each
mcse from its own chain's ESS.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tayal_batch
from hhmm_tpu.batch import default_init as j_default_init
from hhmm_tpu.infer import GibbsConfig as JGibbsConfig
from hhmm_tpu.infer import sample_gibbs as j_sample_gibbs
from hhmm_tpu.infer.diagnostics import ess as j_ess
from hhmm_tpu.infer.gibbs import emission_counts as j_emission_counts
from hhmm_tpu.infer.gibbs import transition_counts as j_transition_counts
from hhmm_tpu.models import TayalHHMM as JTayal
from hhmm_tpu.models import TayalHHMMLite as JTayalLite
from hhmm_tpu_torch.batch import default_init
from hhmm_tpu_torch.convert import constrained_from_jax, model_from_jax, params_from_jax
from hhmm_tpu_torch.infer import (
    GibbsConfig,
    emission_counts,
    ess,
    sample_gibbs,
    transition_counts,
)
from hhmm_tpu_torch.models import TayalHHMM, TayalHHMMLite
from hhmm_tpu_torch.sim.tayal import tayal_batch, tayal_phi

torch.set_num_threads(1)

TOL = 1e-5
GATES = ["hard", "stan"]


def _theta(rng, n, D=35):
    return (rng.normal(size=(n, D)) * 0.8).astype(np.float32)


def _data(B, T, seed=0):
    x, sign = _tayal_batch(B, T, seed=seed)
    return np.array(x), np.array(sign)  # writable copies for torch.from_numpy


class TestParams:
    def test_params_from_jax_then_unpack(self, rng):
        jm, tm = JTayal(), TayalHHMM()
        theta = _theta(rng, 6)
        params, ldj = tm.unpack(params_from_jax(tm, theta, device="cpu"))
        for i in range(6):
            jp, jldj = jm.unpack(jnp.asarray(theta[i]))
            for k in jp:
                np.testing.assert_allclose(params[k][i].numpy(), np.asarray(jp[k]), rtol=TOL, atol=TOL)
            np.testing.assert_allclose(float(ldj[i]), float(jldj), rtol=TOL, atol=TOL)

    def test_pack_matches_jax(self, rng):
        jm, tm = JTayal(), TayalHHMM()
        jp, _ = jm.unpack(jnp.asarray(_theta(rng, 1)[0]))
        tp = constrained_from_jax(tm, {k: np.asarray(v) for k, v in jp.items()}, device="cpu")
        np.testing.assert_allclose(tm.pack(tp).numpy(), np.asarray(jm.pack(jp)), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("cls", ["TayalHHMM", "TayalHHMMLite"])
    @pytest.mark.parametrize("L,gate", [(9, "stan"), (5, "hard")])
    def test_model_from_jax(self, rng, cls, L, gate):
        """``convert.model_from_jax`` gives the port's class of the same
        name with the JAX model's fields, and the same unconstrained layout
        (a draw unpacks to the same parameters)."""
        jm = {"TayalHHMM": JTayal, "TayalHHMMLite": JTayalLite}[cls](L=L, gate_mode=gate)
        tm = model_from_jax(jm)
        assert type(tm).__name__ == cls and type(tm).__module__.startswith("hhmm_tpu_torch")
        assert (tm.K, tm.L, tm.gate_mode, tm.n_free) == (jm.K, jm.L, jm.gate_mode, jm.n_free)
        assert [(n, tuple(b.shape)) for n, b in tm.specs()] == [
            (n, tuple(b.shape)) for n, b in jm.specs()]
        theta = (rng.normal(size=(2, jm.n_free)) * 0.8).astype(np.float32)
        params, _ = tm.unpack(params_from_jax(tm, theta, device="cpu"))
        for i in range(2):
            jp, _ = jm.unpack(jnp.asarray(theta[i]))
            for k in jp:
                np.testing.assert_allclose(params[k][i].numpy(), np.asarray(jp[k]), rtol=TOL,
                                           atol=TOL)

    def test_conversion_checks_shapes(self, rng):
        tm = TayalHHMM()
        with pytest.raises(ValueError):
            params_from_jax(tm, _theta(rng, 2, D=34), device="cpu")
        with pytest.raises(ValueError):
            constrained_from_jax(
                tm, {"p_11": np.zeros(()), "A_row": np.zeros((2, 3)), "phi_k": np.zeros((4, 9))},
                device="cpu",
            )


@pytest.mark.parametrize("gate", GATES)
class TestBuild:
    def _setup(self, rng, gate):
        jm, tm = JTayal(gate_mode=gate), TayalHHMM(gate_mode=gate)
        theta = _theta(rng, 2)
        x, sign = _data(2, 40, seed=int(rng.integers(1000)))
        tparams, _ = tm.unpack(torch.from_numpy(theta))
        tdata = {"x": torch.from_numpy(x), "sign": torch.from_numpy(sign)}
        return jm, tm, theta, x, sign, tparams, tdata

    def test_build_and_build_vg(self, rng, gate):
        jm, tm, theta, x, sign, tparams, tdata = self._setup(rng, gate)
        for method in ("build", "build_vg"):
            got = getattr(tm, method)(tparams, tdata)
            for i in range(2):
                jp, _ = jm.unpack(jnp.asarray(theta[i]))
                ref = getattr(jm, method)(jp, {"x": jnp.asarray(x[i]), "sign": jnp.asarray(sign[i])})
                for a, b in zip(got[:3], ref[:3]):
                    np.testing.assert_allclose(a[i].numpy(), np.asarray(b), rtol=TOL, atol=TOL)

    def test_gate_keys(self, rng, gate):
        jm, tm, theta, x, sign, tparams, tdata = self._setup(rng, gate)
        got = tm.gate_keys(tdata)
        ref = jm.gate_keys({"x": jnp.asarray(x[0]), "sign": jnp.asarray(sign[0])})
        if gate == "hard":
            assert got is None and ref is None
            return
        np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(ref[1]))


class TestCounts:
    @pytest.mark.parametrize("weighted", [False, True])
    def test_counts_exact(self, rng, weighted):
        z = rng.integers(0, 4, size=(5, 50))
        x = rng.integers(0, 9, size=(5, 50))
        w = (rng.random((5, 50)) < 0.7).astype(np.float32) if weighted else None
        n = transition_counts(torch.from_numpy(z), 4, None if w is None else torch.from_numpy(w))
        c = emission_counts(torch.from_numpy(z), torch.from_numpy(x), 4, 9,
                            None if w is None else torch.from_numpy(w))
        for b in range(5):
            wb = None if w is None else jnp.asarray(w[b])
            np.testing.assert_array_equal(n[b].numpy(), np.asarray(j_transition_counts(jnp.asarray(z[b]), 4, wb)))
            np.testing.assert_array_equal(c[b].numpy(), np.asarray(j_emission_counts(jnp.asarray(z[b]), jnp.asarray(x[b]), 4, 9, wb)))

    @pytest.mark.parametrize("gate", GATES)
    def test_conditional_means(self, rng, gate):
        """Many lanes of one conjugate update given the same path: the
        draw means match the Beta/Dirichlet means (1 + counts) / total
        within 5 standard errors."""
        x, sign = _data(1, 60, seed=3)
        z = np.asarray(jax.random.categorical(jax.random.PRNGKey(0), jnp.zeros(4), shape=(60,)))
        n_lanes = 4000
        tm = TayalHHMM(gate_mode=gate)
        lanes = {
            "x": torch.from_numpy(x).expand(n_lanes, 60),
            "sign": torch.from_numpy(sign).expand(n_lanes, 60),
        }
        new = tm.gibbs_update(torch.Generator().manual_seed(1),
                              torch.from_numpy(z).expand(n_lanes, 60), lanes)
        c = np.asarray(j_emission_counts(jnp.asarray(z), jnp.asarray(x[0]), 4, 9, None)) + 1.0
        mean = c / c.sum(-1, keepdims=True)
        sd = np.sqrt(mean * (1 - mean) / (c.sum(-1, keepdims=True) + 1))
        got = new["phi_k"].mean(0).numpy()
        assert np.all(np.abs(got - mean) <= 5 * sd / np.sqrt(n_lanes) + 1e-6)


@pytest.mark.parametrize("gate", GATES)
def test_generated_matches_jax(rng, gate):
    x, sign = _data(1, 96, seed=11)
    data = {"x": x[0, :72], "sign": sign[0, :72], "x_oos": x[0, 72:], "sign_oos": sign[0, 72:]}
    theta = _theta(rng, 5)
    got = TayalHHMMLite(gate_mode=gate).generated(
        torch.from_numpy(theta), {k: torch.from_numpy(v) for k, v in data.items()}, device="cpu"
    )
    jlite = JTayalLite(gate_mode=gate)
    ref = jax.jit(lambda th, d: jlite.generated(th, d))(
        jnp.asarray(theta), {k: jnp.asarray(v) for k, v in data.items()}
    )
    np.testing.assert_allclose(got["alpha"].numpy(), np.asarray(ref["alpha"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["alpha_oos"].numpy(), np.asarray(ref["alpha_oos"]), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["zstar_oos"].numpy(), np.asarray(ref["zstar_oos"]))


def test_generated_batched_series_lanes(rng):
    """``[B, S, D]`` draws with ``[B, T]`` data equal B single-series calls."""
    x, sign = _data(2, 40, seed=5)
    theta = torch.from_numpy(_theta(rng, 6).reshape(2, 3, 35))
    lite = TayalHHMMLite()
    full = {"x": x[:, :30], "sign": sign[:, :30], "x_oos": x[:, 30:], "sign_oos": sign[:, 30:]}
    got = lite.generated(theta, {k: torch.from_numpy(v) for k, v in full.items()}, device="cpu")
    for b in range(2):
        one = lite.generated(theta[b], {k: torch.from_numpy(v[b]) for k, v in full.items()}, device="cpu")
        for k in one:
            np.testing.assert_array_equal(got[k][b].numpy(), one[k].numpy())


def test_tayal_batch_shapes_and_sign_rule():
    x, sign = tayal_batch(3, 200, seed=4, device="cpu")
    assert x.shape == sign.shape == (3, 200)
    assert int(x.min()) >= 0 and int(x.max()) <= 8
    # the sparse A alternates sign groups at every step
    assert bool((sign[:, 1:] == 1 - sign[:, :-1]).all())
    rng = np.random.default_rng(4)
    np.testing.assert_array_equal(tayal_phi(4), rng.dirichlet(np.ones(9) * 2.0, size=4))


def test_default_init_is_informed():
    x, sign = tayal_batch(2, 300, seed=6, device="cpu")
    tm = TayalHHMM(gate_mode="hard")
    init = default_init(tm, {"x": x, "sign": sign}, 2, 3, seed=1, device="cpu")
    assert init.shape == (2, 3, 35)
    phi = tm.unpack(init)[0]["phi_k"]
    for b in range(2):
        up = np.bincount(x[b][sign[b] == 0].numpy(), minlength=9) + 1.0
        up /= up.sum()
        # 0.7 * empirical + 0.3 * Dirichlet noise
        assert np.all(np.abs(phi[b, :, 1].numpy() - 0.7 * up) <= 0.3 + 1e-6)


def _mcse(draws):
    """Posterior mean and its Monte Carlo standard error per scalar from
    one chain ``[S, P]``."""
    mean = draws.mean(0)
    se = np.array([
        draws[:, p].std(ddof=1) / np.sqrt(max(j_ess(draws[None, :, p]), 1.0))
        for p in range(draws.shape[1])
    ])
    return mean, se


def test_gibbs_posterior_agrees_with_jax():
    """The whole slice: the port's batch-native Gibbs and the JAX
    package's Gibbs on the same data and inits (hard gate, 1 chain)."""
    B, T, warmup, samples = 4, 100, 30, 250
    x, sign = _data(B, T, seed=0)
    jm, tm = JTayal(gate_mode="hard"), TayalHHMM(gate_mode="hard")
    init = np.asarray(j_default_init(jm, {"x": jnp.asarray(x), "sign": jnp.asarray(sign)},
                                     B, 1, jax.random.PRNGKey(100)))
    qs_t, st_t = sample_gibbs(
        tm, {"x": torch.from_numpy(x), "sign": torch.from_numpy(sign)},
        params_from_jax(tm, init, device="cpu"),
        GibbsConfig(num_warmup=warmup, num_samples=samples), seed=0, device="cpu",
    )
    assert bool(st_t["chain_healthy"].all()) and bool(torch.isfinite(st_t["logp"]).all())
    cfg = JGibbsConfig(num_warmup=warmup, num_samples=samples, num_chains=1)
    run = jax.jit(jax.vmap(
        lambda xi, si, qi, ki: j_sample_gibbs(jm, {"x": xi, "sign": si}, ki, cfg, init_q=qi, jit=False)[0]
    ))
    qs_j = np.asarray(run(jnp.asarray(x), jnp.asarray(sign), jnp.asarray(init),
                          jax.random.split(jax.random.PRNGKey(0), B)))
    cons_t = tm.constrained_draws(qs_t)
    cons_j = jax.jit(jax.vmap(lambda q: jm.unpack(q)[0]))(jnp.asarray(qs_j.reshape(-1, 35)))
    for b in range(B):
        mt = np.concatenate([cons_t[k][b, 0].reshape(samples, -1).numpy() for k in ("p_11", "A_row", "phi_k")], 1)
        mj = np.concatenate([np.asarray(cons_j[k]).reshape(B, samples, -1)[b] for k in ("p_11", "A_row", "phi_k")], 1)
        mean_t, se_t = _mcse(mt)
        mean_j, se_j = _mcse(mj)
        bound = 4 * np.sqrt(se_t ** 2 + se_j ** 2)
        assert np.all(np.abs(mean_t - mean_j) <= bound), (b, np.abs(mean_t - mean_j) / bound)
