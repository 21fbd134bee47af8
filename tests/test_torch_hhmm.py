"""The port's HHMM structure package (`hhmm_tpu_torch/hhmm/`) against the
JAX package's (`hhmm_tpu/hhmm/`), on the same NumPy inputs.

Tolerances:

- ``finalize``: the same ``ValueError`` messages;
- ``compile_hhmm``: float64 on both sides, ``atol 1e-12`` (the same
  NumPy algebra); the Tayal tree against the port's ``TayalHHMM`` sparse
  (π, A) as ``tests/test_hhmm.py`` holds the JAX one;
- ``hhmm_sim``: bitwise (the same ``np.random.Generator`` calls);
- ``compile_params`` against the JAX ``compile_params`` at random
  admissible node values: float64 ``atol 1e-12``, float32 ``rtol 2e-6``
  (+ ``atol 1e-7`` for the structural zeros); lanes ``[2, 3]`` against a
  loop of single calls, float64, ``atol 1e-15``;
- ``RouteTable``: the NumPy tables equal array for array; the torch
  ``route_logprobs``, ``init_logprobs`` and ``counts`` against the JAX
  methods in float32 (``rtol 1e-5``; counts exactly), and the identity
  ``logsumexp_r(route_logprob) == log A_flat`` in the port itself
  (float64, ``atol 1e-12``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhmm_tpu.hhmm import compile as j_compile
from hhmm_tpu.hhmm import examples as j_examples
from hhmm_tpu.hhmm import simulate as j_simulate
from hhmm_tpu.hhmm import structure as j_structure
from hhmm_tpu.models import TreeHMM as JTreeHMM
from hhmm_tpu_torch.hhmm import (
    End,
    Internal,
    Production,
    compile_hhmm,
    finalize,
    gaussian_leaf_params,
    hhmm_sim,
    hier2x2_tree,
    leaf_groups,
)
from hhmm_tpu_torch.hhmm import examples as t_examples
from hhmm_tpu_torch.hhmm.compile import categorical_leaf_params, compile_params
from hhmm_tpu_torch.hhmm.routes import RouteTable
from hhmm_tpu_torch.models import TayalHHMM
from hhmm_tpu_torch.models.tree import TreeHMM, _internal_nodes

torch.set_num_threads(1)

TAYAL_PHI = np.random.default_rng(3).dirichlet(np.ones(9), size=4)
TAYAL_ARGS = (0.37, 0.62, 0.81, TAYAL_PHI)
TREES = ("hmix_tree", "hier2x2_tree", "fine1998_tree", "tayal_tree", "jangmin2004_tree")


def _trees(name):
    """``(jax tree, port tree)`` of the example tree function ``name``."""
    args = TAYAL_ARGS if name == "tayal_tree" else ()
    return getattr(j_examples, name)(*args), getattr(t_examples, name)(*args)


def _leaf(mu=0.0):
    return Production(obs=("gaussian", {"mu": mu, "sigma": 1.0}))


def _two_end_tree():
    """A regime row that exits through two End children (0.1 + 0.1): the
    route tables refuse it, the compiler does not."""
    regime = Internal(
        name="two_ends", pi=[0.5, 0.5, 0.0, 0.0],
        A=[[0.7, 0.1, 0.1, 0.1], [0.2, 0.6, 0.1, 0.1], [0, 0, 1, 0], [0, 0, 0, 1]],
        children=[_leaf(-1.0), _leaf(1.0), End(), End()],
    )
    other = Internal(pi=[1.0, 0.0], A=[[0.5, 0.5], [0.0, 1.0]], children=[_leaf(4.0), End()])
    return finalize(Internal(name="root", pi=[0.6, 0.4], A=[[0.3, 0.7], [0.8, 0.2]],
                             children=[regime, other]))


# ---- structure ----


VALIDATION = {
    "sum to 1": lambda: Internal(pi=[0.5, 0.2], A=np.eye(2), children=[_leaf(), _leaf()]),
    "End child": lambda: Internal(pi=[0.5, 0.5], A=[[0.0, 1.0], [0.0, 1.0]],
                                  children=[_leaf(), End()]),
    "sums to": lambda: Internal(pi=[1.0, 0.0], A=[[0.3, 0.3], [0.0, 1.0]],
                                children=[_leaf(), End()]),
    "no children": lambda: Internal(name="empty", pi=np.zeros(0), A=np.zeros((0, 0))),
    "pi shape": lambda: Internal(pi=[1.0], A=np.eye(2), children=[_leaf(), _leaf()]),
    "more than once": lambda: (lambda s: Internal(pi=[0.5, 0.5], A=[[0.5, 0.5], [0.5, 0.5]],
                                                  children=[s, s]))(
        Internal(pi=[1.0, 0.0], A=[[0.0, 1.0], [0.0, 1.0]], children=[_leaf(), End()])),
}


def _jax_copy(node):
    """The same tree as the JAX package's dataclasses (unfinalized)."""
    if isinstance(node, Production):
        return j_structure.Production(obs=node.obs, name=node.name)
    if isinstance(node, End):
        return j_structure.End(name=node.name)
    memo = {}

    def copy(n):
        if id(n) not in memo:
            memo[id(n)] = (_jax_copy(n) if not isinstance(n, Internal) else j_structure.Internal(
                pi=n.pi, A=n.A, name=n.name, children=[copy(c) for c in n.children]))
        return memo[id(n)]

    return copy(node)


@pytest.mark.parametrize("match", sorted(VALIDATION))
def test_finalize_errors_match_jax(match):
    bad = VALIDATION[match]()
    with pytest.raises(ValueError, match=match) as got:
        finalize(bad)
    with pytest.raises(ValueError) as want:
        j_structure.finalize(_jax_copy(VALIDATION[match]()))
    assert str(got.value) == str(want.value)


def test_finalize_wires_parents_and_leaf_ids():
    root = t_examples.fine1998_tree()
    for node in _internal_nodes(root):
        for j, child in enumerate(node.children):
            assert child.parent is node and child.index == j
    jroot = j_examples.fine1998_tree()
    got = [(leaf.name, leaf.leaf_id) for leaf in compile_hhmm(root).leaves]
    want = [(leaf.name, leaf.leaf_id) for leaf in j_compile.compile_hhmm(jroot).leaves]
    assert got == want


@pytest.mark.parametrize("name", TREES)
def test_compile_hhmm_matches_jax(name):
    jt, tt = _trees(name)
    want, got = j_compile.compile_hhmm(jt), compile_hhmm(tt)
    np.testing.assert_allclose(got.pi, want.pi, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.A, want.A, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.groups, want.groups)
    assert got.names == want.names
    if name == "tayal_tree":
        np.testing.assert_array_equal(categorical_leaf_params(got),
                                      j_compile.categorical_leaf_params(want))
    else:
        for a, b in zip(gaussian_leaf_params(got), j_compile.gaussian_leaf_params(want)):
            np.testing.assert_array_equal(a, b)


def test_tayal_tree_matches_the_port_sparse_model():
    """Compiled bull/bear tree == ``TayalHHMM``'s hand-derived sparse
    (π, A) (`tayal2009/main.Rmd:306-345`), as ``tests/test_hhmm.py``
    holds the JAX model."""
    p11, a_bear, a_bull, phi = TAYAL_ARGS
    flat = compile_hhmm(t_examples.tayal_tree(*TAYAL_ARGS))
    params = {
        "p_11": torch.tensor(p11, dtype=torch.float64),
        "A_row": torch.tensor([[a_bear, 1 - a_bear], [1 - a_bull, a_bull]], dtype=torch.float64),
        "phi_k": torch.as_tensor(phi),
    }
    pi_ref, A_ref = TayalHHMM().assemble(params)
    np.testing.assert_allclose(flat.pi, pi_ref.numpy(), atol=1e-12)
    np.testing.assert_allclose(flat.A, A_ref.numpy(), atol=1e-12)
    np.testing.assert_array_equal(flat.groups, [0, 0, 1, 1])


@pytest.mark.parametrize("name", TREES)
def test_hhmm_sim_bitwise(name):
    jt, tt = _trees(name)
    T = 300 if name == "jangmin2004_tree" else 200
    for seed in (0, 1, 7):
        zj, xj = j_simulate.hhmm_sim(jt, T, np.random.default_rng(seed))
        zt, xt = hhmm_sim(tt, T, np.random.default_rng(seed))
        np.testing.assert_array_equal(zt, zj)
        np.testing.assert_array_equal(xt, xj)
        assert zt.dtype == zj.dtype and xt.dtype == xj.dtype


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("name", ("fine1998_tree", "jangmin2004_tree"))
def test_leaf_groups_match_jax(name, depth):
    jt, tt = _trees(name)
    np.testing.assert_array_equal(leaf_groups(tt, depth), j_structure.leaf_groups(jt, depth))


def test_example_surface_exports_hier2x2():
    import hhmm_tpu_torch.hhmm as port

    assert "hier2x2_tree" in port.__all__
    assert compile_hhmm(hier2x2_tree()).K == 4


# ---- the differentiable compile ----


def _node_values(root, rng):
    """Random admissible per-node values: each supported row a Dirichlet
    draw on its support, zeros off it (float64)."""
    vals = {}
    for d, node in enumerate(_internal_nodes(root)):
        pi = np.zeros(len(node.children))
        s = np.asarray(node.pi) > 0
        pi[s] = rng.dirichlet(np.ones(s.sum()))
        A = np.zeros(np.shape(node.A))
        for i in range(A.shape[0]):
            s = np.asarray(node.A[i]) > 0
            if s.any():
                A[i, s] = rng.dirichlet(np.ones(s.sum()))
        vals[d] = (pi, A)
    return vals


def _inodes(root):
    """Internal nodes in DFS order, of either package's tree."""
    out = [root]
    for child in root.children:
        if hasattr(child, "children"):
            out += _inodes(child)
    return out


def _by_node(root, table, wrap):
    ids = {id(n): d for d, n in enumerate(_inodes(root))}
    return (lambda n: wrap(table[ids[id(n)]][0]), lambda n: wrap(table[ids[id(n)]][1]))


@pytest.mark.parametrize("name", TREES)
def test_compile_params_matches_jax(name):
    jt, tt = _trees(name)
    vals = _node_values(tt, np.random.default_rng(11))
    for dtype, tol in ((torch.float64, dict(rtol=0, atol=1e-12)),
                       (torch.float32, dict(rtol=2e-6, atol=1e-7))):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        with jax.enable_x64(dtype == torch.float64):
            want = j_compile.compile_params(jt, *_by_node(jt, vals, lambda v: jnp.asarray(v, jdt)))
            want = [np.asarray(w) for w in want]
        got = compile_params(tt, *_by_node(tt, vals, lambda v: torch.as_tensor(v, dtype=dtype)))
        for g, w in zip(got, want):
            assert g.dtype == dtype
            np.testing.assert_allclose(g.numpy(), w, **tol)


def test_compile_params_over_lanes_matches_single_calls():
    tt = t_examples.fine1998_tree()
    rng = np.random.default_rng(5)
    lanes = [[_node_values(tt, rng) for _ in range(3)] for _ in range(2)]
    stacked = {
        d: tuple(np.stack([np.stack([lanes[a][b][d][k] for b in range(3)]) for a in range(2)])
                 for k in (0, 1))
        for d in lanes[0][0]
    }
    pi, A = compile_params(tt, *_by_node(tt, stacked, torch.as_tensor))
    assert pi.shape == (2, 3, 5) and A.shape == (2, 3, 5, 5)
    for a in range(2):
        for b in range(3):
            pi1, A1 = compile_params(tt, *_by_node(tt, lanes[a][b], torch.as_tensor))
            np.testing.assert_allclose(pi[a, b].numpy(), pi1.numpy(), rtol=0, atol=1e-15)
            np.testing.assert_allclose(A[a, b].numpy(), A1.numpy(), rtol=0, atol=1e-15)


def test_compile_params_takes_two_end_columns():
    tree = _two_end_tree()
    flat = compile_hhmm(tree)
    vals = {d: (np.asarray(n.pi), np.asarray(n.A)) for d, n in enumerate(_internal_nodes(tree))}
    pi, A = compile_params(tree, *_by_node(tree, vals, torch.as_tensor))
    np.testing.assert_allclose(pi.numpy(), flat.pi, atol=1e-12)
    np.testing.assert_allclose(A.numpy(), flat.A, atol=1e-12)


# ---- route tables ----

TABLES = ("ev_idx", "valid", "init_idx", "init_valid", "const")


def _route_tables(name):
    jt, tt = _trees(name)
    jm = JTreeHMM(jt, order_mu="none")
    tm = TreeHMM(tt, order_mu="none")
    return jm, jm.routes, tm, RouteTable(tt, _internal_nodes(tt), tm._slots)


@pytest.mark.parametrize("name", ("hier2x2_tree", "fine1998_tree", "jangmin2004_tree"))
def test_route_tables_match_jax(name):
    _, jr, _, tr = _route_tables(name)
    for key in TABLES:
        a, b = getattr(tr, key), getattr(jr, key)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert (tr.K, tr.R, tr.S, tr.M) == (jr.K, jr.R, jr.S, jr.M)
    for key in ("slot_count_pos", "slot_cols"):
        got, want = getattr(tr, key), getattr(jr, key)
        assert list(got) == list(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    assert [(n, list(p), list(c)) for n, p, c in tr.free_plan] == [
        (n, list(p), list(c)) for n, p, c in jr.free_plan]


def _jittered(model, rng, n):
    """``n`` lanes of random free-slot rows on each slot's support, the
    other parameters at the spec (float64 NumPy)."""
    params = {k: np.stack([v] * n) for k, v in model.spec_params().items()}
    for name, *_rest, support in model._slots:
        v = np.zeros((n, len(support)))
        v[:, support] = rng.dirichlet(np.ones(int(support.sum())), size=n)
        params[name] = v
    return params


@pytest.mark.parametrize("name", ("hier2x2_tree", "fine1998_tree"))
def test_route_methods_match_jax(name):
    jm, jr, tm, tr = _route_tables(name)
    rng = np.random.default_rng(2)
    params = _jittered(tm, rng, 3)
    tp = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in params.items()}
    lr, ilp = tr.route_logprobs(tp), tr.init_logprobs(tp)
    assert lr.shape == (3, tr.K, tr.K, tr.R) and ilp.shape == (3, tr.K)
    for b in range(3):
        jp = {k: jnp.asarray(v[b], jnp.float32) for k, v in params.items()}
        np.testing.assert_allclose(tr.values(tp)[b].numpy(), np.asarray(jr.values(jp)), rtol=1e-6)
        np.testing.assert_allclose(lr[b].numpy(), np.asarray(jr.route_logprobs(jp)), rtol=1e-5)
        np.testing.assert_allclose(ilp[b].numpy(), np.asarray(jr.init_logprobs(jp)), rtol=1e-5)
    # counts on valid random paths and routes, weights 0/1
    T = 12
    z = np.zeros((3, T), np.int64)
    routes = np.zeros((3, T - 1), np.int64)
    for b in range(3):
        z[b, 0] = rng.choice(np.flatnonzero(tr.init_valid))
        for t in range(1, T):
            pairs = np.argwhere(tr.valid[z[b, t - 1]])
            z[b, t], routes[b, t - 1] = pairs[rng.integers(len(pairs))]
    w = (rng.random((3, T - 1)) < 0.8).astype(np.float32)
    got = tr.counts(torch.as_tensor(z), torch.as_tensor(routes), torch.as_tensor(w))
    assert got.shape == (3, tr.S)
    for b in range(3):
        want = jr.counts(jnp.asarray(z[b]), jnp.asarray(routes[b]), jnp.asarray(w[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ("hmix_tree", "hier2x2_tree", "fine1998_tree", "jangmin2004_tree"))
def test_routes_sum_to_compiled_flat(name):
    """``logsumexp_r(route_logprob) == log A_flat`` and the init events
    give ``log pi_flat``: the route decomposition is the compile algebra,
    route by route (float64, in the port alone)."""
    tt = getattr(t_examples, name)()
    tm = TreeHMM(tt, order_mu="none")
    tr = tm.routes
    tp = {k: torch.as_tensor(v) for k, v in _jittered(tm, np.random.default_rng(4), 2).items()}
    pi, A = tm.assemble(tp)
    A_r = torch.logsumexp(tr.route_logprobs(tp), dim=-1).exp()
    np.testing.assert_allclose(A_r.numpy(), A.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tr.init_logprobs(tp).exp().numpy(), pi.numpy(), rtol=0, atol=1e-12)


def test_two_end_columns_raise_not_implemented():
    tree = _two_end_tree()
    model = TreeHMM(tree, order_mu="none")
    with pytest.raises(NotImplementedError, match="2 End children"):
        RouteTable(tree, _internal_nodes(tree), model._slots)
    with pytest.raises(NotImplementedError, match="2 End children"):
        model.routes
