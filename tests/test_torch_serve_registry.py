"""The port's snapshot registry (`hhmm_tpu_torch/serve/registry.py`) and
``batch/fit.py::init_from_snapshot`` against the JAX package:

- the registry cases of the JAX ``TestRegistry`` (round trip and spec
  reconstruction, the NIG prior spec, torn / garbage / empty files as
  quarantined misses, a foreign version left in place, atomic saves,
  stranded temps, quarantined saves never displacing a healthy one,
  thinning past quarantined chains) and the quantized banks (bfloat16
  as a uint16 bit view, float16), each run on both registries with the
  same outcome;
- a snapshot written by ``hhmm_tpu.serve`` loads in the port, builds the
  port's model and serves the same responses as the JAX scheduler (f32
  within rtol 1e-6 + atol 1e-5), and the reverse;
- ``init_from_snapshot`` equal to the JAX one.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhmm_tpu import models as jm
from hhmm_tpu.batch.fit import init_from_snapshot as j_init_from_snapshot
from hhmm_tpu.serve import MicroBatchScheduler as JScheduler
from hhmm_tpu.serve import registry as jreg
from hhmm_tpu_torch import models as tm
from hhmm_tpu_torch.batch import init_from_snapshot
from hhmm_tpu_torch.robust import faults
from hhmm_tpu_torch.serve import MicroBatchScheduler
from hhmm_tpu_torch.serve import registry as treg

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-5
PKGS = {"port": (treg, tm), "jax": (jreg, jm)}


def _fake(reg_mod, model, n_draws=6, seed=0, healthy=True):
    rng = np.random.default_rng(seed)
    draws = (rng.normal(size=(n_draws, model.n_free)) * 0.3).astype(np.float32)
    return reg_mod.PosteriorSnapshot(spec=reg_mod.model_spec(model), draws=draws, healthy=healthy)


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def test_round_trip_and_spec_reconstruction(pkg, tmp_path):
    R, M = pkg
    model = M.TayalHHMM(gate_mode="hard")
    reg = R.SnapshotRegistry(str(tmp_path))
    snap = _fake(R, model, n_draws=5)
    reg.save("aapl", snap)
    back = reg.load("aapl")
    np.testing.assert_array_equal(back.draws, snap.draws)
    assert back.healthy and back.version == snap.version == "serve-snapshot-v1"
    m2 = R.build_model(back.spec)
    assert isinstance(m2, M.TayalHHMM) and m2.gate_mode == "hard" and m2.L == 9
    assert reg.names() == ["aapl"]


def test_nig_prior_spec_round_trips(pkg):
    R, M = pkg
    model = M.GaussianHMM(3, nig_prior=M.NIGPrior(m0=1.0, kappa0=0.5))
    m2 = R.build_model(R.model_spec(model))
    assert m2.K == 3 and m2.nig_prior == model.nig_prior


def test_specs_agree_across_packages():
    """The spec each package writes for the same constructor arguments is
    the same JSON, so the spec check at attach accepts the other's."""
    for make in (lambda M: M.TayalHHMM(gate_mode="hard"), lambda M: M.GaussianHMM(3),
                 lambda M: M.GaussianHSMM(2, 4), lambda M: M.MultinomialHMM(2, 3),
                 lambda M: M.GaussianHMM(2, nig_prior=M.NIGPrior(m0=1.0))):
        assert treg.model_spec(make(tm)) == jreg.model_spec(make(jm))


def test_torn_file_is_a_miss(pkg, tmp_path):
    R, M = pkg
    reg = R.SnapshotRegistry(str(tmp_path))
    snap = _fake(R, M.MultinomialHMM(2, 3))
    path = reg.save("t", snap)
    faults.tear_file(path, keep_bytes=16)
    assert reg.load("t") is None
    assert not os.path.exists(path) and os.path.exists(path + ".corrupt")
    reg.save("t", snap)
    np.testing.assert_array_equal(reg.load("t").draws, snap.draws)


def test_garbage_and_empty_are_misses(pkg, tmp_path):
    R, _ = pkg
    reg = R.SnapshotRegistry(str(tmp_path))
    for name, payload in [("g", b"not a zip"), ("e", b"")]:
        with open(os.path.join(str(tmp_path), f"{name}.npz"), "wb") as f:
            f.write(payload)
        assert reg.load(name) is None


def test_foreign_version_is_a_miss_but_not_corrupt(pkg, tmp_path):
    R, M = pkg
    reg = R.SnapshotRegistry(str(tmp_path))
    reg.save("v", dataclasses.replace(_fake(R, M.MultinomialHMM(2, 3)), version="serve-snapshot-v999"))
    assert reg.load("v") is None
    assert os.path.exists(os.path.join(str(tmp_path), "v.npz"))


def test_atomic_save_and_stranded_names(pkg, tmp_path):
    R, M = pkg
    reg = R.SnapshotRegistry(str(tmp_path))
    reg.save("real", _fake(R, M.MultinomialHMM(2, 3)))
    assert [p for p in os.listdir(str(tmp_path)) if ".tmp" in p] == []
    for stranded in ("real.npz.tmp.12345.npz", "old.npz.corrupt"):
        with open(os.path.join(str(tmp_path), stranded), "wb") as f:
            f.write(b"partial")
    assert reg.names() == ["real"]


def test_quarantined_save_never_displaces_healthy(pkg, tmp_path):
    R, M = pkg
    model = M.MultinomialHMM(2, 3)
    reg = R.SnapshotRegistry(str(tmp_path))
    good, bad = _fake(R, model, seed=1), _fake(R, model, seed=2, healthy=False)
    reg.save("s", good)
    reg.save("s", bad)  # refused
    back = reg.load("s")
    assert back.healthy
    np.testing.assert_array_equal(back.draws, good.draws)
    reg.save("fresh", bad)
    assert not reg.load("fresh").healthy


def test_from_fit_matches_jax_and_excludes_quarantined_chains():
    rng = np.random.default_rng(0)
    model = tm.MultinomialHMM(2, 3)
    samples = rng.normal(size=(2, 10, model.n_free)).astype(np.float32)
    samples[1] = 777.0
    for healthy in ([True, False], [False, False]):
        got = treg.snapshot_from_fit(model, torch.as_tensor(samples), chain_healthy=healthy, n_draws=8)
        want = jreg.snapshot_from_fit(jm.MultinomialHMM(2, 3), samples, chain_healthy=healthy, n_draws=8)
        np.testing.assert_array_equal(got.draws, want.draws)
        assert got.healthy == want.healthy == any(healthy)
    assert not (got.draws == 777.0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_quantized_banks_match_jax(dtype, tmp_path):
    rng = np.random.default_rng(1)
    draws = (rng.normal(size=(16, 37)) * 3.0).astype(np.float32)
    hostile = np.asarray([0x7F800001, 0xFFFFFFFF, 0x7F7FFFFF], np.uint32).view(np.float32)
    draws[0, :7] = np.concatenate([[np.nan, -np.nan, np.inf, -np.inf], hostile])
    packed = treg.quantize_draws(draws, dtype)
    want = jreg.quantize_draws(draws, dtype)
    assert packed.dtype == want.dtype
    np.testing.assert_array_equal(packed.view(np.uint8), want.view(np.uint8))
    back = treg.dequantize_draws(packed, dtype)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back.view(np.uint32), jreg.dequantize_draws(want, dtype).view(np.uint32))
    model = tm.MultinomialHMM(2, 3)
    samples = rng.normal(size=(2, 10, model.n_free)).astype(np.float32)
    snap = treg.snapshot_from_fit(model, samples, n_draws=8, dtype=dtype)
    reg = treg.SnapshotRegistry(str(tmp_path))
    reg.save("q", snap)
    jback = jreg.SnapshotRegistry(str(tmp_path)).load("q")
    assert jback.draws_dtype == dtype
    np.testing.assert_array_equal(jback.dequantized_draws(), snap.dequantized_draws())
    with pytest.raises(ValueError, match="dtype"):
        treg.quantize_draws(draws, "int8")


def _serve(sched, n_series, ticks):
    out = []
    for obs in ticks:
        r = sched.tick({f"s{i}": obs[i] for i in range(n_series)})
        out.append([r[f"s{i}"] for i in range(n_series)])
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_moves_between_packages_and_serves_alike(writer, tmp_path):
    """A snapshot written by one package is loaded by the other's
    registry, builds that package's model from its spec, and both
    schedulers serve the same responses on the same ticks."""
    W, R = (jreg, treg) if writer == "jax" else (treg, jreg)
    wmodel = (jm if writer == "jax" else tm).TayalHHMM(gate_mode="hard")
    rng = np.random.default_rng(2)
    n = 3
    W.SnapshotRegistry(str(tmp_path))
    for i in range(n):
        samples = (0.3 * rng.normal(size=(1, 8, wmodel.n_free))).astype(np.float32)
        W.SnapshotRegistry(str(tmp_path)).save(
            f"s{i}", W.snapshot_from_fit(wmodel, samples, n_draws=4, dtype="bfloat16"))
    ticks = [[{"x": int(rng.integers(0, 9)), "sign": int(t % 2)} for _ in range(n)] for t in range(6)]
    reg_t, reg_j = treg.SnapshotRegistry(str(tmp_path)), jreg.SnapshotRegistry(str(tmp_path))
    model_t = reg_t.load("s0").model()
    assert isinstance(model_t, tm.TayalHHMM) and model_t.gate_mode == "hard"
    st = MicroBatchScheduler(model_t, buckets=(4,), registry=reg_t, device="cpu")
    sj = JScheduler(reg_j.load("s0").model(), buckets=(4,), registry=reg_j)
    for i in range(n):
        st.attach(f"s{i}", reg_t.load(f"s{i}"))
        sj.attach(f"s{i}", reg_j.load(f"s{i}"))
    for rt, rj in zip(_serve(st, n, ticks), _serve(sj, n, ticks)):
        for a, b in zip(rt, rj):
            assert (a.shed, a.degraded, a.healthy_draws) == (b.shed, b.degraded, b.healthy_draws)
            np.testing.assert_allclose(a.probs, b.probs, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(a.loglik, b.loglik, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("D,C", [(8, 3), (2, 5), (4, 4)])
def test_init_from_snapshot_matches_jax(D, C):
    rng = np.random.default_rng(3)
    model = tm.GaussianHMM(2)
    samples = rng.normal(size=(1, D, model.n_free)).astype(np.float32)
    snap = treg.snapshot_from_fit(model, samples, n_draws=D, dtype="float16")
    got = init_from_snapshot(snap, C, device="cpu")
    jsnap = jreg.snapshot_from_fit(jm.GaussianHMM(2), samples, n_draws=D, dtype="float16")
    want = j_init_from_snapshot(jsnap, C)
    assert got.dtype == torch.float32 and got.shape == (C, model.n_free)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(init_from_snapshot(samples[0], C, device="cpu").numpy(),
                                  np.asarray(j_init_from_snapshot(jnp.asarray(samples[0]), C)))
    with pytest.raises(ValueError):
        init_from_snapshot(np.zeros((0, 3)), C, device="cpu")
