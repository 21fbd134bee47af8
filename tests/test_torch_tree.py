"""The port's tree HHMM (`hhmm_tpu_torch/models/tree.py::TreeHMM`)
against the JAX package's (`hhmm_tpu/models/tree.py`), on the same NumPy
inputs; the port's model built by ``convert.model_from_jax``.

Tolerances (float32 on both sides unless stated):

- the parameter layout (``specs``, ``n_free``, ``spec_params``) exactly;
  ``unpack`` rtol 1e-5 + atol 1e-6, log|J| rtol 1e-5; ``pack`` round trip
  atol 1e-4;
- ``assemble`` against the JAX ``assemble`` and against the port's own
  ``compile_params`` (float64: atol 1e-12; float32: atol 2e-6);
- ``build`` / ``build_vg`` terms rtol 1e-5 + atol 1e-5; ``log_prior``
  rtol 1e-5;
- ``make_logp`` and ``make_vg`` against ``jax.value_and_grad`` and the
  JAX ``make_vg``: value rtol 1e-5, gradient rtol 3e-4 + atol 3e-5 (the
  JAX test's, ``tests/test_tree_model.py:116-119``); the port's
  ``make_vg`` against its own ``make_logp`` the same;
- ``generated``: probabilities atol 3e-5, loglik rtol 1e-5, the Viterbi
  path exactly (inputs away from ties);
- ``gibbs_update``: the deterministic pieces (event counts, Dirichlet
  concentrations, emission sufficient statistics) exactly against the
  JAX pieces; the draws in distribution, each statistic within 5 Monte
  Carlo sigma (route frequencies against ``softmax(step_lr)``; slot rows
  against the Dirichlet means; μ against its normal conditional; σ after
  a long run at fixed counts against the quadrature moments of its
  marginal conditional);
- the init: un-jittered parts rtol 1e-5 of the JAX init on the same
  data, the jittered ones within 5 jitter sigma.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hhmm_tpu.hhmm import examples as j_examples
from hhmm_tpu.hhmm.simulate import hhmm_sim as j_hhmm_sim
from hhmm_tpu.hhmm.structure import leaf_groups as j_leaf_groups
from hhmm_tpu.models import TreeHMM as JTreeHMM
from hhmm_tpu_torch.convert import model_from_jax, params_from_jax
from hhmm_tpu_torch.hhmm import End, Internal, Production, compile_hhmm, finalize
from hhmm_tpu_torch.hhmm import examples as t_examples
from hhmm_tpu_torch.hhmm.compile import compile_params
from hhmm_tpu_torch.hhmm.routes import RouteTable
from hhmm_tpu_torch.models import TreeHMM
from hhmm_tpu_torch.models.base import BaseHMMModel
from hhmm_tpu_torch.models.tree import _internal_nodes

torch.set_num_threads(1)

TERM_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
KWS = {
    "unsup": {},
    "semisup-hard": {"semisup": True, "gate_mode": "hard"},
    "semisup-stan": {"semisup": True},
}
TAYAL_PHI = np.random.default_rng(3).dirichlet(np.ones(6), size=4)


def _trees(name):
    args = (0.4, 0.3, 0.7, TAYAL_PHI) if name == "tayal_tree" else ()
    return getattr(j_examples, name)(*args), getattr(t_examples, name)(*args)


def _models(name="hier2x2_tree", **kw):
    jm = JTreeHMM(_trees(name)[0], **kw)
    return model_from_jax(jm), jm


def _data(name="hier2x2_tree", T=100, seed=0, ragged=None):
    tree = _trees(name)[0]
    z, x = j_hhmm_sim(tree, T, np.random.default_rng(seed))
    d = {"x": np.asarray(x, np.float32 if np.asarray(x).dtype.kind == "f" else np.int32),
         "g": j_leaf_groups(tree)[z].astype(np.int32)}
    if ragged is not None:
        d["mask"] = (np.arange(T) < ragged).astype(np.float32)
    return d, z


def _t(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _theta(jm, data, seed=1, n=None):
    """A JAX init on the data, moved off it by a small NumPy step."""
    th = np.asarray(jm.init_unconstrained(jax.random.PRNGKey(seed), _j(data)))
    rng = np.random.default_rng(seed)
    shape = th.shape if n is None else (n,) + th.shape
    return (th + 0.1 * rng.normal(size=shape)).astype(np.float32)


def _two_end_tree():
    def leaf(mu):
        return Production(obs=("gaussian", {"mu": mu, "sigma": 1.0}))

    regime = Internal(
        pi=[0.5, 0.5, 0.0, 0.0],
        A=[[0.7, 0.1, 0.1, 0.1], [0.2, 0.6, 0.1, 0.1], [0, 0, 1, 0], [0, 0, 0, 1]],
        children=[leaf(-1.0), leaf(1.0), End(), End()],
    )
    other = Internal(pi=[1.0, 0.0], A=[[0.5, 0.5], [0.0, 1.0]], children=[leaf(4.0), End()])
    return finalize(Internal(pi=[0.6, 0.4], A=[[0.3, 0.7], [0.8, 0.2]], children=[regime, other]))


def _compiled(model, params):
    """The port's ``compile_params`` of the model's free slots (the
    readable definition ``assemble`` is held to)."""
    ids = {id(n): d for d, n in enumerate(model._inodes)}
    slot = {(d, kind, i): name for name, kind, d, i, _ in model._slots}
    lead = params["sigma"].shape[:-1]
    dt = params["sigma"].dtype

    def pi_of(node):
        name = slot.get((ids[id(node)], "pi", -1))
        return params[name] if name else torch.as_tensor(node.pi, dtype=dt)

    def A_of(node):
        d = ids[id(node)]
        return torch.stack([
            params[slot[(d, "A", i)]] if (d, "A", i) in slot
            else torch.as_tensor(node.A[i], dtype=dt).expand(lead + (len(node.children),))
            for i in range(len(node.children))], dim=-2)

    return compile_params(model.root, pi_of, A_of)


# ---- parameters ----


LAYOUTS = [("hmix_tree", {}), ("hier2x2_tree", {}), ("hier2x2_tree", {"semisup": True}),
           ("hier2x2_tree", {"order_mu": "none"}), ("fine1998_tree", {}),
           ("tayal_tree", {}), ("jangmin2004_tree", {"semisup": True})]


@pytest.mark.parametrize("name,kw", LAYOUTS, ids=[f"{n}-{'-'.join(k) or 'default'}"
                                                  for n, k in LAYOUTS])
def test_parameter_layout_matches_jax(name, kw):
    model, jm = _models(name, **kw)
    assert model.n_free == jm.n_free and model.K == jm.K
    assert model.family == jm.family and model.order_mu == jm.order_mu
    got, want = model.specs(), jm.specs()
    assert [(n, type(b).__name__, tuple(b.shape), b.n_free) for n, b in got] == [
        (n, type(b).__name__, tuple(b.shape), b.n_free) for n, b in want]
    gp, wp = model.spec_params(), jm.spec_params()
    assert list(gp) == list(wp)
    for k in gp:
        np.testing.assert_array_equal(gp[k], wp[k], err_msg=k)
    np.testing.assert_array_equal(model.groups, np.asarray(jm.groups))


@pytest.mark.parametrize("name", ["hier2x2_tree", "fine1998_tree", "tayal_tree"])
def test_unpack_and_pack_match_jax(name):
    model, jm = _models(name)
    theta = np.random.default_rng(2).normal(size=(3, model.n_free)).astype(np.float32)
    params, ldj = model.unpack(params_from_jax(model, theta, device="cpu"))
    base, base_ldj = BaseHMMModel.unpack(model, torch.as_tensor(theta))
    for b in range(3):
        jparams, jldj = jm.unpack(jnp.asarray(theta[b]))
        assert list(params) == list(jparams)
        for k in params:
            np.testing.assert_allclose(params[k][b].numpy(), np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(ldj[b]), float(jldj), rtol=1e-5)
    # the padded stick-breaking block equals the per-slot bijectors
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), base[k].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ldj.numpy(), base_ldj.numpy(), rtol=1e-5)
    np.testing.assert_allclose(model.pack(params).numpy(), theta, atol=1e-4)


# ---- assembly ----


@pytest.mark.parametrize("name", ["hmix_tree", "hier2x2_tree", "fine1998_tree", "jangmin2004_tree"])
def test_assemble_matches_compile_params_and_jax(name):
    model, jm = _models(name, order_mu="none")
    rng = np.random.default_rng(5)
    theta = rng.normal(size=(2, model.n_free))
    for dtype, atol in ((torch.float64, 1e-12), (torch.float32, 2e-6)):
        params, _ = model.unpack(torch.as_tensor(theta, dtype=dtype))
        pi, A = model.assemble(params)
        pi_c, A_c = _compiled(model, params)
        np.testing.assert_allclose(pi.numpy(), pi_c.numpy(), rtol=0, atol=atol)
        np.testing.assert_allclose(A.numpy(), A_c.numpy(), rtol=0, atol=atol)
        # a plain dict (no packed slot rows) takes the same plan
        pi_d, A_d = model.assemble(dict(params))
        assert torch.equal(pi_d, pi) and torch.equal(A_d, A)
    flat = compile_hhmm(model.root)
    pi0, A0 = model.assemble({k: torch.as_tensor(v) for k, v in model.spec_params().items()})
    np.testing.assert_allclose(pi0.numpy(), flat.pi, atol=1e-12)
    np.testing.assert_allclose(A0.numpy(), flat.A, atol=1e-12)
    if name != "jangmin2004_tree":  # the JAX eager expansion is seconds at K=63
        params, _ = model.unpack(torch.as_tensor(theta, dtype=torch.float32))
        jpi, jA = jm.assemble({k: jnp.asarray(v[0].numpy()) for k, v in params.items()})
        pi, A = model.assemble(params)
        np.testing.assert_allclose(pi[0].numpy(), np.asarray(jpi), rtol=0, atol=2e-6)
        np.testing.assert_allclose(A[0].numpy(), np.asarray(jA), rtol=0, atol=2e-6)


def test_assemble_with_two_end_columns_and_its_gradient():
    """A row exiting through two End children: the route tables refuse
    it, the plan multiplies the exit sum out into more terms; value and
    gradient equal the symbolic ``compile_params`` (float64)."""
    model = TreeHMM(_two_end_tree(), order_mu="none")
    theta = torch.as_tensor(np.random.default_rng(6).normal(size=(3, model.n_free)))
    w = torch.as_tensor(np.random.default_rng(7).normal(size=(model.K, model.K)))
    grads = []
    for assemble in (model.assemble, lambda p: _compiled(model, p)):
        th = theta.clone().requires_grad_(True)
        params, _ = model.unpack(th)
        pi, A = assemble(params)
        (g,) = torch.autograd.grad(pi.sum() + (A * w).sum(), th)
        grads.append((pi.detach(), A.detach(), g))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(grads[0][1].sum(-1).numpy(), 1.0, atol=1e-12)
    with pytest.raises(NotImplementedError, match="End children"):
        model.routes


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["hmix_tree", "fine1998_tree", "jangmin2004_tree"])
def test_assemble_runs_a_fixed_number_of_ops(name):
    """``assemble`` is a fixed handful of batched ops whatever K is: 13
    (views included) plus one product a factor beyond the first (the
    plan's ``M``), the
    same at K=2, 5 and 63 for 1 or 64 lanes (after the first call, which
    also moves the plan's tables to the device)."""
    model = TreeHMM(getattr(t_examples, name)(), order_mu="none")
    counts = set()
    for lanes in (1, 64):
        params, _ = model.unpack(torch.zeros(lanes, model.n_free))
        model.assemble(params)
        with _Ops() as ops:
            model.assemble(params)
        counts.add(ops.n - (model._expansion.M - 1))
    assert counts == {13}


# ---- terms ----


@pytest.mark.parametrize("ragged", [None, 61])
@pytest.mark.parametrize("kw", sorted(KWS))
def test_terms_match_jax(kw, ragged):
    model, jm = _models(**KWS[kw])
    data, _ = _data(ragged=ragged)
    theta = _theta(jm, data)
    params, _ = model.unpack(torch.as_tensor(theta))
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    np.testing.assert_allclose(float(model.log_prior(params)), float(jm.log_prior(jp)), rtol=1e-5)
    for build in ("build", "build_vg"):
        got = getattr(model, build)(params, _t(data))
        want = getattr(jm, build)(jp, _j(data))
        for term, a, b in zip(("log_pi", "log_A", "log_obs"), got, want):
            assert tuple(a.shape) == tuple(np.shape(b)), (build, term)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TERM_TOL,
                                       err_msg=f"{build} {term}")
        if ragged:
            np.testing.assert_array_equal(got[3].numpy(), data["mask"])
        else:
            assert got[3] is None
    gk, jgk = model.gate_keys(_t(data)), jm.gate_keys(_j(data))
    if jgk is None:
        assert gk is None
    else:
        np.testing.assert_array_equal(gk[0].numpy(), np.asarray(jgk[0]))
        np.testing.assert_array_equal(gk[1].numpy(), np.broadcast_to(np.asarray(jgk[1]), (model.K,)))


def test_categorical_terms_match_jax():
    model, jm = _models("tayal_tree")
    data, _ = _data("tayal_tree", T=80)
    theta = _theta(jm, data)
    params, _ = model.unpack(torch.as_tensor(theta))
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    for a, b in zip(model.build(params, _t(data))[:3], jm.build(jp, _j(data))[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TERM_TOL)
    assert float(model.log_prior(params)) == float(jm.log_prior(jp)) == 0.0


def test_log_prior_value_and_flat_optout():
    model = TreeHMM(t_examples.hier2x2_tree(), order_mu="none")
    params = {k: torch.as_tensor(v) for k, v in model.spec_params().items()}

    def norm_logpdf(x, s):
        return -0.5 * (x / s) ** 2 - np.log(s) - 0.5 * np.log(2 * np.pi)

    want = norm_logpdf(params["mu"].numpy(), 10.0).sum() + norm_logpdf(
        params["sigma"].numpy(), 3.0).sum()
    np.testing.assert_allclose(float(model.log_prior(params)), want, rtol=1e-10)
    flat = TreeHMM(t_examples.hier2x2_tree(), order_mu="none", prior_mu_scale=None,
                   prior_sigma_scale=None)
    assert float(flat.log_prior(params)) == 0.0
    lanes = {k: v.expand((2, 3) + v.shape) for k, v in params.items()}
    assert model.log_prior(lanes).shape == (2, 3)


# ---- log density and value-and-grad ----


@pytest.mark.parametrize("kw,ragged", [("unsup", None), ("semisup-hard", None),
                                       ("semisup-hard", 47), ("semisup-stan", None),
                                       ("semisup-stan", 47)])
def test_logp_and_vg_match_jax(kw, ragged):
    """``make_logp`` (value and autograd gradient) and ``make_vg``
    against ``jax.value_and_grad(make_logp)`` and the JAX ``make_vg``,
    dense and with a ragged mask in both gates; then the port's
    ``make_vg`` against its own ``make_logp``."""
    model, jm = _models(**KWS[kw])
    data, _ = _data(T=60, seed=2, ragged=ragged)
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
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), **GRAD_TOL)
    np.testing.assert_allclose(float(vv), float(v), rtol=1e-5)
    np.testing.assert_allclose(gv.numpy(), g.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("kw", ["semisup-hard", "unsup"])
def test_jangmin_vg_matches_logp_over_lanes(kw):
    """The 63-leaf tree (K=63, the kernels' wide layout on the card):
    ``make_vg`` on lanes ``[2, 2]`` (two series, two chains) against the
    port's ``make_logp`` at T=32."""
    model, jm = _models("jangmin2004_tree", order_mu="none", **KWS[kw])
    data = {k: np.stack([_data("jangmin2004_tree", T=32, seed=s)[0][k] for s in (3, 4)])
            for k in ("x", "g")}
    theta = torch.as_tensor(np.random.default_rng(8).normal(size=(2, 2, model.n_free)),
                            dtype=torch.float32) * 0.3
    vv, gv = model.make_vg(_t(data))(theta)
    th = theta.clone().requires_grad_(True)
    v = model.make_logp(_t(data))(th)
    (g,) = torch.autograd.grad(v.sum(), th)
    assert vv.shape == (2, 2) and gv.shape == (2, 2, model.n_free)
    np.testing.assert_allclose(vv.numpy(), v.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(gv.numpy(), g.numpy(), **GRAD_TOL)
    assert torch.isfinite(gv).all()


@pytest.mark.slow
@pytest.mark.parametrize("kw", ["semisup-hard", "semisup-stan"])
def test_jangmin_vg_matches_jax(kw):
    model, jm = _models("jangmin2004_tree", order_mu="none", **KWS[kw])
    data, _ = _data("jangmin2004_tree", T=32, seed=1)
    theta = _theta(jm, data)
    jv, jg = jax.value_and_grad(jm.make_logp(_j(data)))(jnp.asarray(theta))
    vv, gv = model.make_vg(_t(data))(torch.as_tensor(theta))
    np.testing.assert_allclose(float(vv), float(jv), rtol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(jg), **GRAD_TOL)


# ---- generated quantities ----


def test_generated_matches_jax():
    model, jm = _models(order_mu="none")
    data, _ = _data(T=80, seed=9)
    theta = _theta(jm, data, n=3)
    x = {"x": data["x"]}
    got = model.generated(torch.as_tensor(theta), _t(x), device="cpu")
    want = jm.generated(jnp.asarray(theta), _j(x))
    for k in ("alpha", "gamma"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=3e-5, err_msg=k)
    np.testing.assert_allclose(got["loglik"].numpy(), np.asarray(want["loglik"]), rtol=1e-5)
    np.testing.assert_array_equal(got["zstar"].numpy(), np.asarray(want["zstar"]))
    np.testing.assert_allclose(got["logp_zstar"].numpy(), np.asarray(want["logp_zstar"]),
                               rtol=1e-5)


def _jangmin_decode_case():
    """The unsupervised Jangmin tree, one draw near the port's init on
    T=32 steps it simulated (K=63: the kernels' wide layout on the
    card)."""
    model, jm = _models("jangmin2004_tree", order_mu="none")
    data, _ = _data("jangmin2004_tree", T=32, seed=1)
    th = model.init_unconstrained(torch.Generator().manual_seed(2),
                                  {"x": torch.as_tensor(data["x"])}).numpy()
    th = th + 0.1 * np.random.default_rng(2).normal(size=th.shape)
    return model, jm, {"x": data["x"]}, th.astype(np.float32)


def _oracle(model, theta, x):
    """Float64 filtered and smoothed probabilities and Viterbi path of
    the port's terms (``tests/oracle.py``)."""
    import oracle

    params, _ = model.unpack(torch.as_tensor(theta, dtype=torch.float64))
    log_pi, log_A, log_obs, _ = model.build(params, {"x": torch.as_tensor(x, dtype=torch.float64)})
    terms = [t.numpy() for t in (log_pi, log_A, log_obs)]
    la, _ = oracle.forward_np(*terms)
    lg = la + oracle.backward_np(*terms[1:])
    norm = lambda a: np.exp(a - np.logaddexp.reduce(a, axis=1, keepdims=True))
    return {"alpha": norm(la), "gamma": norm(lg)}, oracle.viterbi_np(*terms)[0]


def test_jangmin_generated_is_near_the_float64_oracle():
    """At K=63 the port's float32 filtered and smoothed probabilities
    within 5e-4 of the float64 oracle on its own terms (either package is
    up to 2.1e-4 off it at K=64, ``tests/test_torch_decode.py``), and the
    Viterbi path the oracle's."""
    model, _, data, theta = _jangmin_decode_case()
    got = model.generated(torch.as_tensor(theta)[None], _t(data), device="cpu")
    truth, path = _oracle(model, theta, data["x"])
    for k in ("alpha", "gamma"):
        assert np.abs(got[k][0].numpy() - truth[k]).max() <= 5e-4, k
    np.testing.assert_array_equal(got["zstar"][0].numpy(), path)


@pytest.mark.slow
def test_jangmin_generated_matches_jax():
    """The same at K=63 against the JAX ``generated``: probabilities
    within 5e-4, the Viterbi path equal, and the port no farther from the
    float64 oracle than 1.5 times the JAX package's distance (+1e-6)."""
    model, jm, data, theta = _jangmin_decode_case()
    got = model.generated(torch.as_tensor(theta)[None], _t(data), device="cpu")
    want = jm.generated(jnp.asarray(theta)[None], _j(data))
    truth, _ = _oracle(model, theta, data["x"])
    np.testing.assert_array_equal(got["zstar"].numpy(), np.asarray(want["zstar"]))
    np.testing.assert_allclose(got["loglik"].numpy(), np.asarray(want["loglik"]), rtol=1e-5)
    for k in ("alpha", "gamma"):
        g, w = got[k][0].numpy(), np.asarray(want[k])[0]
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-4, err_msg=k)
        assert np.abs(g - truth[k]).max() <= 1.5 * np.abs(w - truth[k]).max() + 1e-6, k


# ---- the route-augmented Gibbs block ----


def _gibbs_fixture(gate="hard", T=40, seed=10):
    model, jm = _models(semisup=True, gate_mode=gate, order_mu="none")
    data, z = _data(T=T, seed=seed)
    params = {k: np.asarray(v, np.float32) for k, v in model.spec_params().items()}
    return model, jm, data, z, params


def test_gibbs_guards_match_jax():
    for kw in ({"order_mu": "global"}, {"order_mu": "none", "prior_mu_scale": None},
               {"order_mu": "none", "prior_sigma_scale": None}):
        model, jm = _models(**kw)
        data, z = _data(T=10)
        params = {k: torch.as_tensor(v) for k, v in model.spec_params().items()}
        with pytest.raises(ValueError) as got:
            model.gibbs_update(torch.Generator(), torch.as_tensor(z)[None], _t(data), params)
        with pytest.raises(ValueError) as want:
            jm.gibbs_update(jax.random.PRNGKey(0), jnp.asarray(z), _j(data),
                            {k: jnp.asarray(v) for k, v in jm.spec_params().items()})
        assert str(got.value) == str(want.value)
    assert model.gibbs_gate_modes == ("hard", "stan")


class _Capture:
    """Wraps ``RouteTable.counts`` to keep the routes and weights each
    call of ``gibbs_update`` drew and used."""

    def __init__(self, monkeypatch):
        self.calls = []
        counts = RouteTable.counts

        def kept(rt, z, routes, w, z0_w=1.0):
            self.calls.append((z, routes, w))
            return counts(rt, z, routes, w, z0_w)

        monkeypatch.setattr(RouteTable, "counts", kept)


@pytest.mark.parametrize("gate", ["hard", "stan"])
def test_gibbs_deterministic_pieces_match_jax(gate, monkeypatch):
    """Given the path, the routes and the weights: the event counts, the
    Dirichlet concentrations ``1 + counts[_dir_pos]`` and the emission
    sufficient statistics equal the JAX pieces; the stan gate's weights
    are the destination consistency of ``tests/test_routes.py``."""
    model, jm, data, z, params = _gibbs_fixture(gate, T=40)
    data["g"] = np.zeros_like(data["g"])  # every step labelled top state 0
    cap = _Capture(monkeypatch)
    tp = {k: torch.as_tensor(v)[None] for k, v in params.items()}
    model.gibbs_update(torch.Generator().manual_seed(0), torch.as_tensor(z)[None],
                       {k: torch.as_tensor(v)[None] for k, v in data.items()}, tp)
    (zt, routes, w), = cap.calls
    jr = jm.routes
    want_w = (data["g"][1:] == np.asarray(jm.groups)[z[1:]]).astype(np.float32) \
        if gate == "stan" else np.ones(len(z) - 1, np.float32)
    np.testing.assert_array_equal(w[0].numpy(), want_w)
    if gate == "stan":
        assert want_w.sum() < len(z) - 1  # some steps really dropped
    got = model.routes.counts(zt, routes, w)[0]
    want = jr.counts(jnp.asarray(z), jnp.asarray(routes[0].numpy()), jnp.asarray(want_w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(model._dir_pos, jm._dir_pos)
    np.testing.assert_array_equal(model._dir_seg, jm._dir_seg)
    np.testing.assert_array_equal((1.0 + got[torch.as_tensor(model._dir_pos, dtype=torch.long)]
                                   ).numpy(), np.asarray(1.0 + want[jnp.asarray(jm._dir_pos)]))
    # the chosen routes are valid for every step
    assert model.routes.valid[z[:-1], z[1:], routes[0].numpy()].all()


def _route_tree_fixture():
    """A path of hier2x2 whose steps have two routes each (exit the
    regime and re-enter it, or move within it)."""
    model = TreeHMM(t_examples.hier2x2_tree(), order_mu="none")
    rt = model.routes
    two = np.argwhere(rt.valid.sum(-1) == 2)
    z = np.concatenate([[two[0][0]], [two[0][1]]] * 3).astype(np.int64)
    z = z[: 2 * (len(z) // 2)]
    return model, rt, z


def test_gibbs_route_draws_follow_the_conditional(monkeypatch):
    """Route frequencies over 4000 lanes within 5 binomial sigma of
    ``softmax(step_lr)`` at each step."""
    model, rt, z = _route_tree_fixture()
    n = 4000
    cap = _Capture(monkeypatch)
    rng = np.random.default_rng(12)
    params = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in model.spec_params().items()}
    for name, *_r, support in model._slots:
        v = np.zeros(len(support))
        v[support] = rng.dirichlet(np.ones(int(support.sum())))
        params[name] = torch.as_tensor(v, dtype=torch.float32)
    lanes = {k: v.expand((n,) + v.shape) for k, v in params.items()}
    zt = torch.as_tensor(z).expand(n, -1)
    x = torch.zeros(n, len(z))
    model.gibbs_update(torch.Generator().manual_seed(1), zt, {"x": x}, lanes)
    (_, routes, _), = cap.calls
    p = torch.softmax(rt.route_logprobs(params)[z[:-1], z[1:]], -1).numpy()  # [T-1, R]
    for r in range(rt.R):
        freq = (routes == r).float().mean(0).numpy()
        sd = np.sqrt(p[:, r] * (1 - p[:, r]) / n) + 1e-12
        assert (np.abs(freq - p[:, r]) <= 5 * sd + 1e-9).all(), (r, freq, p[:, r])


def test_gibbs_slot_and_mu_draws_follow_their_conditionals(monkeypatch):
    """At a fixed path, over 4000 lanes: each slot row's mean within 5
    sigma of its Dirichlet(1 + counts) mean; μ's mean and variance within
    5 sigma of its normal conditional given σ."""
    model, jm, data, z, params = _gibbs_fixture("hard", T=60, seed=13)
    n = 4000
    cap = _Capture(monkeypatch)
    tp = {k: torch.as_tensor(v).expand((n,) + v.shape) for k, v in params.items()}
    lanes = {k: torch.as_tensor(v).expand(n, -1) for k, v in data.items()}
    new = model.gibbs_update(torch.Generator().manual_seed(2), torch.as_tensor(z).expand(n, -1),
                             lanes, tp)
    (zt, routes, w), = cap.calls
    counts = model.routes.counts(zt, routes, w)  # [n, S], the lanes' own routes
    for name, *_r, support in model._slots:
        pos = torch.as_tensor(model.routes.slot_count_pos[name], dtype=torch.long)
        a = 1.0 + counts[:, pos]
        mean = (a / a.sum(-1, keepdim=True)).mean(0).numpy()
        got = new[name][:, support].numpy()
        a0 = a.sum(-1, keepdim=True)
        var = (a * (a0 - a) / (a0**2 * (a0 + 1))).mean(0).numpy()
        assert np.allclose(new[name][:, ~support].numpy(), 0.0)
        assert (np.abs(got.mean(0) - mean) <= 5 * np.sqrt(var / n) + 1e-7).all(), name
    x, sigma = data["x"].astype(np.float64), params["sigma"].astype(np.float64)
    nk = np.bincount(z, minlength=model.K)
    s1 = np.bincount(z, weights=x, minlength=model.K)
    var = 1.0 / (nk / sigma**2 + 1.0 / model.prior_mu_scale**2)
    mean = s1 / sigma**2 * var
    mu = new["mu"].numpy().astype(np.float64)
    assert (np.abs(mu.mean(0) - mean) <= 5 * np.sqrt(var / n)).all()
    assert (np.abs(mu.var(0) - var) <= 5 * var * np.sqrt(2.0 / n)).all()


def _sigma_marginal_moments(n_k, s1, s2, s_mu, s_sig, lower=1e-4):
    """Mean and sd of σ under p(σ | x) ∝ ∫ N(x | μ, σ) N(μ | 0, s_mu) dμ
    · half-N(σ | 0, s_sig) on σ > lower, by quadrature (float64)."""
    sig = np.linspace(lower, 12.0, 400001)
    prec = n_k / sig**2 + 1.0 / s_mu**2
    logp = (-n_k * np.log(sig) - 0.5 * np.log(prec) + 0.5 * (s1 / sig**2) ** 2 / prec
            - 0.5 * s2 / sig**2 - 0.5 * (sig / s_sig) ** 2)
    p = np.exp(logp - logp.max())
    p /= p.sum()
    m = (p * sig).sum()
    return m, np.sqrt((p * (sig - m) ** 2).sum())


def test_gibbs_sigma_step_leaves_its_conditional_invariant():
    """Iterating the block at a fixed path (so fixed counts): after a
    burn-in, σ over 2000 independent lanes has the mean of its marginal
    conditional within 5 sigma, for an occupied leaf and an empty one
    (the prior's)."""
    model = TreeHMM(t_examples.hier2x2_tree(), order_mu="none")
    T, n = 20, 2000
    rng = np.random.default_rng(14)
    z = np.array([0] * 12 + [1] * 8)  # leaves 2 and 3 own no step
    x = np.where(z == 0, rng.normal(-3.0, 0.6, T), rng.normal(-1.0, 0.6, T)).astype(np.float32)
    params = {k: torch.as_tensor(v, dtype=torch.float32).expand((n,) + np.shape(v))
              for k, v in model.spec_params().items()}
    lanes = {"x": torch.as_tensor(x).expand(n, -1)}
    zt = torch.as_tensor(z).expand(n, -1)
    gen = torch.Generator().manual_seed(3)
    for _ in range(100):
        params = model.gibbs_update(gen, zt, lanes, params)
    sig = params["sigma"].numpy().astype(np.float64)
    for k in range(model.K):
        sel = z == k
        m, sd = _sigma_marginal_moments(sel.sum(), x[sel].astype(np.float64).sum(),
                                        (x[sel].astype(np.float64) ** 2).sum(),
                                        model.prior_mu_scale, model.prior_sigma_scale)
        assert abs(sig[:, k].mean() - m) <= 5 * sd / np.sqrt(n), (k, sig[:, k].mean(), m, sd)


def test_gibbs_categorical_emissions_follow_their_dirichlet():
    model, _ = _models("tayal_tree")
    data, z = _data("tayal_tree", T=200, seed=15)
    n = 4000
    params = {k: torch.as_tensor(v, dtype=torch.float32).expand((n,) + np.shape(v))
              for k, v in model.spec_params().items()}
    new = model.gibbs_update(torch.Generator().manual_seed(4), torch.as_tensor(z).expand(n, -1),
                             {"x": torch.as_tensor(data["x"]).expand(n, -1)}, params)
    c = np.zeros((model.K, model.L))
    np.add.at(c, (z, data["x"]), 1.0)
    a = 1.0 + c
    a0 = a.sum(-1, keepdims=True)
    mean, var = a / a0, a * (a0 - a) / (a0**2 * (a0 + 1))
    got = new["phi_k"].numpy()
    assert (np.abs(got.mean(0) - mean) <= 5 * np.sqrt(var / n)).all()


def test_gibbs_fit_runs_both_gates():
    """``sample_gibbs`` on two series of hier2x2 in both gates: finite
    logp, healthy chains, the recorded draws pack back to the sampled
    parameters."""
    from hhmm_tpu_torch.infer import GibbsConfig, sample_gibbs

    for gate in ("hard", "stan"):
        model, _ = _models(semisup=True, gate_mode=gate, order_mu="none")
        data = {k: np.stack([_data(T=50, seed=s)[0][k] for s in (16, 17)]) for k in ("x", "g")}
        init = torch.stack([torch.stack([model.init_unconstrained(
            torch.Generator().manual_seed(s), {"x": torch.as_tensor(data["x"][s])})])
            for s in range(2)])
        qs, stats = sample_gibbs(model, data, init, GibbsConfig(5, 10, 1), seed=0, device="cpu")
        assert qs.shape == (2, 1, 10, model.n_free)
        assert torch.isfinite(stats["logp"]).all() and stats["chain_healthy"].all()
        params, _ = model.unpack(qs)
        assert torch.allclose(model.pack(params), qs, atol=1e-4)


# ---- init ----


@pytest.mark.parametrize("name,kw", [("hier2x2_tree", {"semisup": True}),
                                     ("hier2x2_tree", {}), ("hier2x2_tree", {"order_mu": "none"}),
                                     ("tayal_tree", {})])
def test_init_matches_jax(name, kw):
    model, jm = _models(name, **kw)
    data, _ = _data(name, T=120, seed=18)
    got, _ = model.unpack(model.init_unconstrained(torch.Generator().manual_seed(0),
                                                   {"x": torch.as_tensor(data["x"])})[None])
    want, _ = jm.unpack(jm.init_unconstrained(jax.random.PRNGKey(0), _j({"x": data["x"]})))
    for k in got:
        g, w = got[k][0].numpy(), np.asarray(want[k])
        if k.startswith("mu"):  # 0.05 N(0, 1) jitter on each side
            assert np.abs(g - w).max() <= 5 * 0.05 * np.sqrt(2), k
        elif k == "phi_k":  # 0.2 Dirichlet(20) jitter on each side
            assert np.abs(g - w).max() <= 5 * 0.2 * 0.03 * np.sqrt(2)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=k)
