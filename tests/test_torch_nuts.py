"""The port's No-U-Turn sampler (`hhmm_tpu_torch.infer.nuts`,
`infer/run.py::sample_nuts`) against the JAX package.

- ``nuts_step`` against the JAX ``nuts_step`` with the JAX key splits
  replayed into the port's randomness source (:class:`Replay`): on a
  correlated 3-D Gaussian in float64 (trees to depth 6) and on
  ``GaussianHMM(K=2).make_vg`` at T=64 in float32 (to depth 5), several
  lanes with their own step sizes and inverse masses, six and eight
  seeds. Tree depth, leaf count, divergence and the chosen leaf are
  identical; ``q'``, ``logp'`` and ``grad'`` agree within 1e-6
  (float64) and 1e-4 (float32, relative to each lane's largest entry;
  the f32 ``grad'`` against the JAX gradient at the port's ``q'``, see
  :func:`check_against_jax`). The seeds were checked to put no U-turn
  or accept comparison within rounding of its threshold: a tie there
  could flip one way in either package, and that would say nothing of
  the port;
- one lockstep call over the lanes equals a loop of single-lane calls,
  bitwise;
- the batched ``find_reasonable_step_size`` equals the JAX function
  vmapped over lanes, given the same momentum draws;
- the checkpoint index ranges equal the JAX ``_ckpt_idxs``;
- divergence detection, the tree-depth bound and the finite-input guard
  (a diverged lane's non-finite endpoint never reaches the log density);
- standard-normal moments of ``sample_nuts``;
- ``sample_nuts_batched``'s warmup and sampling loop against the JAX
  ``sample_nuts`` with every chain's key flow replayed
  (:class:`ReplayChain`), in float32 on a scaled Gaussian (the JAX
  sampler's scan carries an int32 quarantine step that x64 mode turns
  into int64, so it runs only in float32): 20 warmup transitions with a
  mass window closing at the 18th, then a few draws. Every tree's
  discrete outcome is identical, and the adapted step size and inverse
  mass, every draw and its log density agree within 1e-4 (the f32
  tolerance of the ``nuts_step`` case), without a fault and with one
  chain's state poisoned mid-warmup (the JAX ``nan_state`` fault, the
  port's own in-scan hook, ``robust/faults.py``): that chain's
  quarantine step, its frozen dual averaging, Welford state and mass;
- the warmup's adapted inverse mass and step size on a badly scaled
  Gaussian against the JAX ``sample_nuts`` (``tests/test_nuts.py``'s
  tolerance, rtol 0.6 of the true variances; step sizes within a factor
  of 2 of each other).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhmm_tpu.infer import SamplerConfig as JSamplerConfig
from hhmm_tpu.infer import sample_nuts as j_sample_nuts
from hhmm_tpu.infer.nuts import _ckpt_idxs as j_ckpt_idxs
from hhmm_tpu.infer.nuts import find_reasonable_step_size as j_find_step
from hhmm_tpu.infer.nuts import nuts_step as j_nuts_step
from hhmm_tpu.models import GaussianHMM as JGaussianHMM
from hhmm_tpu.robust import faults as j_faults
from hhmm_tpu_torch.infer import (
    SamplerConfig,
    ess,
    find_reasonable_step_size_batched,
    nuts_step,
    sample_nuts,
    sample_nuts_batched,
    split_rhat,
    vg_from_logp,
)
from hhmm_tpu_torch.infer.nuts import _ckpt_idxs
from hhmm_tpu_torch.models import GaussianHMM
from hhmm_tpu_torch.robust import faults

torch.set_num_threads(1)

DEPTH = 6
# the two packages' f32 value-and-grads of the Gaussian HMM differ by
# about 1e-5 (relative) at one theta, and a trajectory amplifies it: 63
# leapfrogs reach 2.5e-4 in the gradient, 31 stay under 6e-5. The f32
# case stops at depth 5 so that 1e-4 holds the arithmetic, not the drift
DEPTH_F32 = 5


class Replay:
    """The port's randomness source fed with the draws of the JAX key
    splits: ``mom [N, dim]``, ``right [N, D]``, ``u_accept [N, D]``,
    ``u_leaf [N, D, 2^(D-1)]``."""

    def __init__(self, mom, right, u_accept, u_leaf):
        self.mom, self.right, self.u_accept, self.u_leaf = mom, right, u_accept, u_leaf

    def momentum(self, like):
        return torch.as_tensor(self.mom, dtype=like.dtype)

    def tree(self, depth, like):
        return (torch.as_tensor(self.right[:, depth]),
                torch.as_tensor(self.u_accept[:, depth], dtype=like.dtype))

    def leaf(self, depth, leaf, like):
        return torch.as_tensor(self.u_leaf[:, depth, leaf], dtype=like.dtype)

    def lane(self, i):
        s = slice(i, i + 1)
        return Replay(self.mom[s], self.right[s], self.u_accept[s], self.u_leaf[s])


class ReplayChain:
    """The key flow of the JAX ``sample_nuts``, lane by lane, as the
    randomness source of ``sample_nuts_batched``: ``split(key, C)`` over
    the chains; each chain splits off its step-size probe's key (the
    first ``momentum`` call), then every transition splits ``(key,
    sub)`` and one ``nuts_step`` draws from ``sub`` (:func:`replay`). A
    quarantined chain keeps its key in JAX; its lane's draws here go on,
    and its proposals are thrown away in both packages."""

    def __init__(self, key, n_chains, dim, depth, dtype):
        self.keys = list(jax.random.split(key, n_chains))
        self.dim, self.depth, self.dtype = dim, depth, dtype
        self.cur = None

    def _split(self):
        subs = []
        for i, k in enumerate(self.keys):
            self.keys[i], sub = jax.random.split(k)
            subs.append(sub)
        return subs

    def momentum(self, like):
        if self.cur is None:  # the step-size probe
            z = [np.asarray(jax.random.normal(k, (self.dim,), self.dtype)) for k in self._split()]
            self.cur = False
            return torch.as_tensor(np.stack(z), dtype=like.dtype)
        self.cur = replay(self._split(), self.dim, self.depth, self.dtype)
        return self.cur.momentum(like)

    def tree(self, depth, like):
        return self.cur.tree(depth, like)

    def leaf(self, depth, leaf, like):
        return self.cur.leaf(depth, leaf, like)


def replay(keys, dim, depth, dtype):
    """The draws one JAX ``nuts_step`` makes from each key (momentum
    split first, then four keys a doubling, then a key a leaf)."""
    mom, right, u_acc, u_leaf = [], [], [], []
    for key in keys:
        key, k_mom = jax.random.split(key)
        mom.append(np.asarray(jax.random.normal(k_mom, (dim,), dtype)))
        r, a, leaf = [], [], np.zeros((depth, 1 << (depth - 1)))
        for d in range(depth):
            key, k_dir, k_acc, k_sub = jax.random.split(key, 4)
            r.append(bool(jax.random.bernoulli(k_dir)))
            a.append(float(jax.random.uniform(k_acc, dtype=dtype)))
            for n in range(1 << d):
                k_sub, sub = jax.random.split(k_sub)
                leaf[d, n] = float(jax.random.uniform(sub, dtype=dtype))
        right.append(r)
        u_acc.append(a)
        u_leaf.append(leaf)
    return Replay(np.stack(mom), np.array(right), np.array(u_acc), np.stack(u_leaf))


@partial(jax.jit, static_argnums=(6,))
def _j_gauss_step(P, key, q, eps, inv_mass, _, depth):
    vg = jax.value_and_grad(lambda q: -0.5 * q @ P @ q)
    lp, g = vg(q)
    return j_nuts_step(vg, key, q, lp, g, eps, inv_mass, depth)


@partial(jax.jit, static_argnums=(6,))
def _j_hmm_step(x, key, q, eps, inv_mass, _, depth):
    vg = JGaussianHMM(2).make_vg({"x": x})
    lp, g = vg(q)
    return j_nuts_step(vg, key, q, lp, g, eps, inv_mass, depth)


@jax.jit
def _j_hmm_find_step(x, key, q, inv_mass, init_step):
    vg = JGaussianHMM(2).make_vg({"x": x})
    lp, g = vg(q)
    return j_find_step(vg, inv_mass, q, lp, g, key, init_step)


def correlated_gaussian(seed, dim=3):
    """``(precision matrix, port lanes value_and_grad)`` of a zero-mean
    Gaussian with a random dense covariance (the port's in per-row
    reductions, so a lane's bits do not depend on the batch)."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(dim, dim))
    P = np.linalg.inv(L @ L.T + 0.3 * np.eye(dim))
    tP = torch.as_tensor(P)

    def tvg(q):
        Pq = (q[:, None, :] * tP).sum(-1)
        return -0.5 * (q * Pq).sum(-1), -Pq

    return P, tvg


def gaussian_hmm_case(seed, N=6, T=64):
    """``GaussianHMM(K=2)`` at T=64: the f32 data, the port's
    ``make_vg`` on it and ``N`` lanes of theta near the simulator's
    parameters."""
    rng = np.random.default_rng(seed)
    z = (rng.random(T) < 0.4).astype(int)
    x = (np.where(z, 2.0, 1.0) + 0.3 * rng.normal(size=T)).astype(np.float32)
    model = GaussianHMM(2)
    base = model.pack({
        "p_1k": torch.tensor([0.6, 0.4]), "A_ij": torch.tensor([[0.8, 0.2], [0.3, 0.7]]),
        "mu_k": torch.tensor([1.0, 2.0]), "sigma_k": torch.tensor([0.3, 0.35]),
    }).numpy()
    theta = (base + 0.05 * rng.normal(size=(N, base.shape[0]))).astype(np.float32)
    return x, model.make_vg({"x": torch.as_tensor(x)}), theta, rng


def run_both(j_step, arg, tvg, theta, eps, inv_mass, key_seed, depth, dtype):
    """The port's ``nuts_step`` over every lane with the JAX draws
    replayed, and the JAX step (``j_step(arg, key, ...)``) lane by
    lane."""
    N, dim = theta.shape
    keys = jax.random.split(jax.random.PRNGKey(key_seed), N)
    src = replay(keys, dim, depth, dtype)
    tq = torch.as_tensor(theta)
    lp, g = tvg(tq)
    got = nuts_step(tvg, src, tq, lp, g, torch.as_tensor(eps), torch.as_tensor(inv_mass), depth)
    want = [j_step(jnp.asarray(arg), keys[i], jnp.asarray(theta[i]), jnp.asarray(eps[i]),
                   jnp.asarray(inv_mass[i]), None, depth) for i in range(N)]
    return got, want, src


@jax.jit
def _j_hmm_vg(x, q):
    return JGaussianHMM(2).make_vg({"x": x})(q)


def check_against_jax(got, want, tol, grad_at=None):
    """Discrete outcomes identical; ``q'``, ``logp'`` and ``grad'`` within
    ``tol`` relative to each lane's largest entry. ``grad_at(q)``, when
    given, is the JAX gradient the port's ``grad'`` is held against, at
    the port's own ``q'``: in f32 a trajectory's drift meets lanes where
    the gradient's conditioning lifts a 5e-5 difference in ``q'`` to
    2e-3 in the gradient (two of eight seeds of the Gaussian HMM case)."""
    q, lp, g, info = got
    for i, (jq, jlp, jg, jinfo) in enumerate(want):
        assert int(info.depth[i]) == int(jinfo.depth)
        assert int(info.num_leaves[i]) == int(jinfo.num_leaves)
        assert bool(info.diverging[i]) == bool(jinfo.diverging)
        if grad_at is not None:
            jg = grad_at(q[i].numpy())
        for a, b in ((q[i], jq), (lp[i], jlp), (g[i], jg)):
            b = np.asarray(b)
            scale = max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol * scale)
        np.testing.assert_allclose(float(info.accept_prob[i]), float(jinfo.accept_prob),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("seed", range(3, 9))
def test_nuts_step_matches_jax_f64(seed):
    with jax.enable_x64(True):
        P, tvg = correlated_gaussian(seed)
        rng = np.random.default_rng(seed)
        N = 8
        q0 = rng.normal(size=(N, 3))
        eps = rng.uniform(0.1, 0.6, size=N)
        inv_mass = rng.uniform(0.5, 2.0, size=(N, 3))
        got, want, _ = run_both(_j_gauss_step, P, tvg, q0, eps, inv_mass, 10 + seed, DEPTH,
                                jnp.float64)
        check_against_jax(got, want, 1e-6)
    # the draws reach trees of several depths, U-turns inside subtrees included
    assert len(set(got[3].depth.tolist())) >= 2


@pytest.mark.parametrize("seed", range(8))
def test_nuts_step_matches_jax_gaussian_hmm_f32(seed):
    x, tvg, theta, rng = gaussian_hmm_case(seed)
    N, dim = theta.shape
    eps = rng.uniform(0.02, 0.08, size=N).astype(np.float32)
    inv_mass = rng.uniform(0.5, 2.0, size=(N, dim)).astype(np.float32)
    got, want, _ = run_both(_j_hmm_step, x, tvg, theta, eps, inv_mass, 100 + seed, DEPTH_F32,
                            jnp.float32)
    check_against_jax(got, want, 1e-4,
                      grad_at=lambda q: np.asarray(_j_hmm_vg(jnp.asarray(x), jnp.asarray(q))[1]))


def test_lockstep_equals_single_lanes_bitwise():
    with jax.enable_x64(True):
        _, tvg = correlated_gaussian(3)
        rng = np.random.default_rng(7)
        N = 8
        q0 = rng.normal(size=(N, 3))
        eps = rng.uniform(0.1, 0.6, size=N)
        inv_mass = rng.uniform(0.5, 2.0, size=(N, 3))
        keys = jax.random.split(jax.random.PRNGKey(21), N)
        src = replay(keys, 3, DEPTH, jnp.float64)
    tq = torch.as_tensor(q0)
    lp, g = tvg(tq)
    eps_t, im_t = torch.as_tensor(eps), torch.as_tensor(inv_mass)
    batch = nuts_step(tvg, src, tq, lp, g, eps_t, im_t, DEPTH)
    assert batch[3].lockstep_leapfrogs >= int(batch[3].num_leaves.max())
    for i in range(N):
        s = slice(i, i + 1)
        one = nuts_step(tvg, src.lane(i), tq[s], lp[s], g[s], eps_t[s], im_t[s], DEPTH)
        for a, b in zip(batch[:3], one[:3]):
            assert torch.equal(a[s], b)
        for a, b in zip(batch[3][:5], one[3][:5]):
            assert torch.equal(a[s], b)
        # one lane: every lockstep leapfrog is its own
        assert one[3].lockstep_leapfrogs == int(one[3].num_leaves[0])


@pytest.mark.parametrize("init_step", [1.0, 1e-3])
def test_find_reasonable_step_size_batched_matches_jax(init_step):
    x, tvg, theta, rng = gaussian_hmm_case(5, N=5)
    N, dim = theta.shape
    inv_mass = rng.uniform(0.5, 2.0, size=(N, dim)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(33), N)
    z = np.stack([np.asarray(jax.random.normal(k, (dim,), jnp.float32)) for k in keys])
    tq = torch.as_tensor(theta)
    lp, g = tvg(tq)
    got = find_reasonable_step_size_batched(tvg, torch.as_tensor(inv_mass), tq, lp, g,
                                            torch.as_tensor(z), init_step)
    want = [float(_j_hmm_find_step(jnp.asarray(x), keys[i], jnp.asarray(theta[i]),
                                   jnp.asarray(inv_mass[i]), init_step)) for i in range(N)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    assert got.dtype == torch.float32


def test_ckpt_idxs_match_jax():
    ns = np.arange(1024, dtype=np.int32)
    j_min, j_max = jax.vmap(j_ckpt_idxs)(jnp.asarray(ns))
    for n in ns[1::2]:  # U-turn checks run on odd leaves
        assert _ckpt_idxs(int(n)) == (int(j_min[n]), int(j_max[n]))
    for n in ns[::2]:  # even leaves write checkpoint idx_max
        assert _ckpt_idxs(int(n))[1] == int(j_max[n])


def _lanes_vg(logp):
    def vg(q):
        with torch.enable_grad():
            th = q.detach().requires_grad_(True)
            lp = logp(th)
            (g,) = torch.autograd.grad(lp.sum(), th)
        return lp.detach(), g

    return vg


def test_divergence_detection():
    """A grossly too large step on a stiff Gaussian flags divergence
    (`tests/test_nuts.py::test_divergence_detection`)."""
    vg = _lanes_vg(lambda q: -0.5 * ((q / 0.01) ** 2).sum(-1))
    q = torch.full((2, 3), 0.05)
    lp, g = vg(q)
    gen = torch.Generator().manual_seed(0)
    from hhmm_tpu_torch.infer import GeneratorDraws

    _, _, _, info = nuts_step(vg, GeneratorDraws(gen), q, lp, g, torch.full((2,), 5.0),
                              torch.ones(2, 3), max_treedepth=6)
    assert bool(info.diverging.all())


def test_treedepth_bounded():
    """Nearly flat target: the trajectory stops at ``max_treedepth``
    (`tests/test_nuts.py::test_treedepth_bounded`)."""
    from hhmm_tpu_torch.infer import GeneratorDraws

    vg = _lanes_vg(lambda q: q.sum(-1) * 1e-6)
    q = torch.zeros(3, 2)
    lp, g = vg(q)
    _, _, _, info = nuts_step(vg, GeneratorDraws(torch.Generator().manual_seed(0)), q, lp, g,
                              torch.full((3,), 0.5), torch.ones(3, 2), max_treedepth=5)
    assert info.depth.tolist() == [5, 5, 5]
    assert int(info.num_leaves.max()) <= 2**5 - 1
    assert info.lockstep_leapfrogs == 2**5 - 1


def test_non_finite_endpoint_never_reaches_the_density():
    """A lane that diverges to a non-finite position is frozen; its
    position is replaced before the log density is called, as the card's
    value-and-grad kernels require finite inputs."""
    from hhmm_tpu_torch.infer import GeneratorDraws

    seen = []

    def vg(q):
        seen.append(bool(torch.isfinite(q).all()))
        lp = -0.5 * (q * q).sum(-1) - torch.where(q[:, 0] > 3.0, torch.inf, 0.0)
        return lp, -q

    q = torch.zeros(2, 2)
    lp, g = vg(q)
    # lane 0's huge step leaves the finite region at once; lane 1 runs on
    _, _, _, info = nuts_step(vg, GeneratorDraws(torch.Generator().manual_seed(1)), q, lp, g,
                              torch.tensor([1e30, 0.3]), torch.ones(2, 2), max_treedepth=4)
    assert all(seen)
    assert bool(info.diverging[0]) and int(info.num_leaves[0]) == 1
    assert int(info.num_leaves[1]) > 1


def test_standard_normal_moments():
    """`tests/test_nuts.py::test_standard_normal_moments` on the port."""
    dim = 4
    cfg = SamplerConfig(num_warmup=150, num_samples=400, num_chains=4)
    qs, stats = sample_nuts(lambda q: -0.5 * (q * q).sum(-1), torch.zeros(dim), cfg, seed=0,
                            device="cpu")
    qs = qs.numpy()
    assert qs.shape == (4, 400, dim)
    assert float(stats["diverging"].float().mean()) < 0.01
    np.testing.assert_allclose(qs.mean(axis=(0, 1)), 0.0, atol=0.1)
    np.testing.assert_allclose(qs.std(axis=(0, 1)), 1.0, atol=0.1)
    for d in range(dim):
        assert split_rhat(qs[:, :, d]) < 1.02
        assert ess(qs[:, :, d]) > 500
    assert bool(stats["chain_healthy"].all())


def test_stats_keys_and_shapes():
    """The JAX stats keys, each with its chain axis, and the lockstep's
    own counts."""
    cfg = SamplerConfig(num_warmup=12, num_samples=5, num_chains=3)
    qs, stats = sample_nuts(lambda q: -0.5 * (q * q).sum(-1), torch.zeros(3, 2), cfg,
                            seed=0, device="cpu")
    jax_keys = {"accept_prob", "num_leaves", "diverging", "energy", "depth", "logp",
                "step_size", "inv_mass", "warmup_diverging", "chain_healthy", "quarantine_step"}
    assert jax_keys <= set(stats)
    shapes = {k: tuple(v.shape) for k, v in stats.items()}
    for k in ("accept_prob", "num_leaves", "diverging", "energy", "depth", "logp"):
        assert shapes[k] == (3, 5)
    assert shapes["step_size"] == (3,) and shapes["inv_mass"] == (3, 2)
    assert shapes["warmup_diverging"] == (3, 12) and shapes["warmup_num_leaves"] == (3, 12)
    assert shapes["lockstep_leapfrogs"] == (17,) and shapes["host_syncs"] == (17,)
    lock = stats["lockstep_leapfrogs"][12:]
    assert bool((lock >= stats["num_leaves"].max(0).values).all())
    assert bool((stats["host_syncs"] > stats["lockstep_leapfrogs"]).all())
    assert qs.shape == (3, 5, 2)


SCALES_REPLAY = np.array([0.5, 1.0, 3.0])


@pytest.mark.parametrize("fault", [None, 8])
def test_sample_nuts_batched_replays_jax_chains(fault):
    """The warmup and sampling loop around ``nuts_step`` against the JAX
    ``sample_nuts`` with its key flow replayed (f32, 2 chains, 20 + 3,
    ``max_treedepth`` 6; the mass window closes at transition 17). With
    ``fault``, chain 1's state turns NaN after transition ``fault``."""
    depth, C, dim = 6, 2, 3
    cfg = dict(num_warmup=20, num_samples=3, num_chains=C, max_treedepth=depth)
    # the seed of the starts was checked to be a well-conditioned one: the
    # port's own f32 and f64 runs agree within 2e-6 in step size there.
    # On others the f32 runs of either package drift apart by 3e-4 and
    # more (the dual averaging multiplies an accept statistic's rounding
    # by about 2 at each window restart), which would say nothing of the
    # port
    init = np.random.default_rng(13).normal(size=(C, dim)).astype(np.float32)
    step = -1 if fault is None else fault
    plan = j_faults.FaultPlan(kind="nan_state", step=step, chain=1)
    scales = SCALES_REPLAY.astype(np.float32)
    with j_faults.inject(plan):
        jqs, jstats = j_sample_nuts(lambda q: -0.5 * jnp.sum((q / jnp.asarray(scales)) ** 2),
                                    jax.random.PRNGKey(4), jnp.asarray(init),
                                    JSamplerConfig(**cfg))
    src = ReplayChain(jax.random.PRNGKey(4), C, dim, depth, jnp.float32)
    vg = vg_from_logp(lambda q: -0.5 * ((q / torch.as_tensor(scales)) ** 2).sum(-1))
    with faults.inject(faults.FaultPlan(kind="nan_state", step=step, chain=1)):
        qs, stats = sample_nuts_batched(vg, torch.as_tensor(init)[None], SamplerConfig(**cfg),
                                        device="cpu", draws=src)
    qs, stats = qs[0], {k: v[0] for k, v in stats.items()}
    healthy = [True, fault is None]
    assert stats["chain_healthy"].tolist() == healthy == np.asarray(jstats["chain_healthy"]).tolist()
    assert stats["quarantine_step"].tolist() == np.asarray(jstats["quarantine_step"]).tolist()
    # a quarantined chain's trees after its fault grow from a frozen key
    # in JAX and from fresh draws here; both throw them away
    upto = {"warmup_diverging": slice(None, fault + 1 if fault is not None else None)}
    for k in ("num_leaves", "depth", "diverging", "warmup_diverging"):
        np.testing.assert_array_equal(stats[k].numpy()[0], np.asarray(jstats[k])[0], err_msg=k)
        lane1 = upto.get(k, slice(None) if fault is None else slice(0))
        np.testing.assert_array_equal(stats[k].numpy()[1, lane1], np.asarray(jstats[k])[1, lane1],
                                      err_msg=k)
    # 23 f32 transitions: the two packages' exp, log and gradient round
    # differently (7e-6 apart by the last draw on this seed)
    for a, b in ((stats["step_size"], jstats["step_size"]), (stats["inv_mass"], jstats["inv_mass"]),
                 (qs, jqs), (stats["logp"], jstats["logp"])):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(b).max()))
    # the window closed: the healthy chains left the unit metric
    assert not np.allclose(stats["inv_mass"][0].numpy(), 1.0)
    if fault is not None:  # the poisoned chain froze its mass before the window closed
        assert stats["inv_mass"][1].tolist() == [1.0] * dim


@pytest.mark.slow
def test_scaled_gaussian_warmup_matches_jax():
    """Mass-matrix adaptation on a badly scaled target
    (`tests/test_nuts.py::test_scaled_gaussian_mass_adaptation`): each
    package's adapted inverse mass within rtol 0.6 of the true
    variances, the port's within rtol 0.6 of the JAX package's, and the
    adapted step sizes within a factor of 2 of each other."""
    scales = np.array([0.1, 1.0, 10.0], np.float32)
    cfg = dict(num_warmup=400, num_samples=20, num_chains=2)
    _, jstats = j_sample_nuts(lambda q: -0.5 * jnp.sum((q / jnp.asarray(scales)) ** 2),
                              jax.random.PRNGKey(2), jnp.zeros(3), JSamplerConfig(**cfg))
    _, stats = sample_nuts(lambda q: -0.5 * ((q / torch.as_tensor(scales)) ** 2).sum(-1),
                           torch.zeros(3), SamplerConfig(**cfg), seed=2, device="cpu")
    j_im, im = np.asarray(jstats["inv_mass"]), stats["inv_mass"].numpy()
    np.testing.assert_allclose(j_im, np.broadcast_to(scales**2, j_im.shape), rtol=0.6)
    np.testing.assert_allclose(im, np.broadcast_to(scales**2, im.shape), rtol=0.6)
    np.testing.assert_allclose(im.mean(0), j_im.mean(0), rtol=0.6)
    ratio = stats["step_size"].numpy().mean() / np.asarray(jstats["step_size"]).mean()
    assert 0.5 < ratio < 2.0
