"""The PyTorch port's batch layer (``hhmm_tpu_torch/batch``: padding, the
result cache, ``fit_batched``) and its MCMC summaries against the JAX
package on the same inputs.

Tolerances: padding, digests of equal inputs and cached arrays exactly;
``split_rhat_many`` and ``summary`` within 1e-10 (both float64 NumPy);
``fit_batched`` with one chunk bitwise equal to ``sample_gibbs`` with
the derived seed; the Gibbs posterior means of the two packages'
``fit_batched`` within 4·sqrt(mcse_port² + mcse_jax²) per constrained
scalar (each mcse from its own chain's ESS; the random streams differ,
so parity is distributional).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tayal_batch
from hhmm_tpu.batch import ResultCache as JResultCache
from hhmm_tpu.batch import default_init as j_default_init
from hhmm_tpu.batch import digest_key as j_digest_key
from hhmm_tpu.batch import fit_batched as j_fit_batched
from hhmm_tpu.batch import pad_datasets as j_pad_datasets
from hhmm_tpu.batch import pad_ragged as j_pad_ragged
from hhmm_tpu.infer import GibbsConfig as JGibbsConfig
from hhmm_tpu.infer import SamplerConfig as JSamplerConfig
from hhmm_tpu.infer.diagnostics import split_rhat_many as j_split_rhat_many
from hhmm_tpu.infer.diagnostics import summary as j_summary
from hhmm_tpu.models import TayalHHMM as JTayal
from hhmm_tpu_torch.batch import (
    ResultCache,
    default_init,
    derive_seed,
    digest_key,
    fit_batched,
    pad_datasets,
    pad_ragged,
)
from hhmm_tpu_torch.batch import fit as fit_module
from hhmm_tpu_torch.infer import (
    ChEESConfig,
    GibbsConfig,
    ess,
    sample_chees_batched,
    sample_gibbs,
    split_rhat_many,
    summary,
)
from hhmm_tpu_torch.models import TayalHHMM

torch.set_num_threads(1)


def _ragged(rng, B=5, T_max=40):
    """Per-series ``x``/``sign`` of lengths in [T_max/2, T_max]."""
    out = []
    for _ in range(B):
        T = int(rng.integers(T_max // 2, T_max + 1))
        out.append({"x": rng.integers(0, 9, T).astype(np.int32),
                    "sign": rng.integers(0, 2, T).astype(np.int32)})
    return out


def _tayal_data(B, T, seed=0, ragged=False):
    x, sign = _tayal_batch(B, T, seed=seed)
    x, sign = np.array(x), np.array(sign)
    if not ragged:
        return {"x": x, "sign": sign}
    lengths = [T - 7 * b for b in range(B)]
    return pad_datasets(
        [{"x": x[b, :n], "sign": sign[b, :n]} for b, n in enumerate(lengths)], ["x", "sign"]
    )


# ---------------------------------------------------------------------------
# padding and the cache
# ---------------------------------------------------------------------------


class TestPad:
    @pytest.mark.parametrize("length", [None, 64])
    @pytest.mark.parametrize("pad_value", [0, 3.5])
    def test_pad_ragged_matches_jax(self, rng, length, pad_value):
        arrays = [rng.normal(size=(int(rng.integers(5, 40)), 3)).astype(np.float32)
                  for _ in range(6)]
        got = pad_ragged(arrays, pad_value=pad_value, length=length)
        want = j_pad_ragged(arrays, pad_value=pad_value, length=length)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)

    def test_pad_ragged_rejects_what_jax_rejects(self, rng):
        arrays = [np.zeros(10), np.zeros(20)]
        for fn in (pad_ragged, j_pad_ragged):
            with pytest.raises(ValueError, match="exceeds"):
                fn(arrays, length=15)
            with pytest.raises(ValueError, match="no arrays"):
                fn([])

    def test_pad_datasets_matches_jax(self, rng):
        ds = _ragged(rng)
        for d in ds:
            d["w"] = rng.normal(size=3)  # a non-time key is stacked
        got = pad_datasets(ds, ["x", "sign"], pad_values={"x": 8})
        want = j_pad_datasets(ds, ["x", "sign"], pad_values={"x": 8})
        assert set(got) == set(want) == {"x", "sign", "w", "mask"}
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])

    def test_pad_datasets_inconsistent_lengths_raise(self, rng):
        ds = [{"x": np.zeros(5), "sign": np.zeros(6)}, {"x": np.zeros(4), "sign": np.zeros(4)}]
        with pytest.raises(ValueError, match="inconsistent"):
            pad_datasets(ds, ["x", "sign"])


class TestCache:
    def test_round_trip_and_miss(self, tmp_path, rng):
        cache = ResultCache(str(tmp_path))
        value = {"samples": rng.normal(size=(2, 3, 4)).astype(np.float32),
                 "healthy": np.array([True, False])}
        key = digest_key({"a": 1}, value["samples"])
        assert cache.get(key) is None
        cache.put(key, value)
        hit = cache.get(key)
        assert set(hit) == set(value)
        for k in value:
            assert hit[k].dtype == value[k].dtype
            np.testing.assert_array_equal(hit[k], value[k])
        # the JAX package reads the same archive
        jhit = JResultCache(str(tmp_path)).get(key)
        np.testing.assert_array_equal(jhit["samples"], value["samples"])

    def test_no_dir_is_a_no_op(self):
        cache = ResultCache(None)
        cache.put("k", {"a": np.zeros(2)})
        assert cache.get("k") is None

    def test_corrupt_entry_is_a_miss(self, tmp_path):
        cache = ResultCache(str(tmp_path))
        (tmp_path / "bad.npz").write_bytes(b"not an archive")
        assert cache.get("bad") is None
        assert (tmp_path / "bad.npz.corrupt").exists()

    def test_digest_is_sensitive_to_what_it_keys(self, rng):
        a = rng.normal(size=(3, 4)).astype(np.float32)
        base = digest_key({"cfg": 1, "s": "x"}, a, 7)
        assert digest_key({"cfg": 1, "s": "x"}, a.copy(), 7) == base
        b = a.copy()
        b[1, 2] += 1e-6
        for other in (
            digest_key({"cfg": 2, "s": "x"}, a, 7),  # a config value
            digest_key({"cfg": 1, "s": "y"}, a, 7),  # a string
            digest_key({"cfg": 1, "s": "x"}, b, 7),  # one array element
            digest_key({"cfg": 1, "s": "x"}, a.astype(np.float64), 7),  # the dtype
            digest_key({"cfg": 1, "s": "x"}, a.reshape(4, 3), 7),  # the shape
            digest_key({"cfg": 1, "s": "x"}, a, 8),  # a scalar
        ):
            assert other != base
        # the same digest as the JAX package's on the same structure
        assert base == j_digest_key({"cfg": 1, "s": "x"}, a, 7)

    def test_derive_seed_is_stable_and_spreads(self):
        assert derive_seed(3, 64) == derive_seed(3, 64)
        seeds = {derive_seed(s, c) for s in range(4) for c in (0, 64, 128)}
        assert len(seeds) == 12
        assert all(0 <= s < 2**60 for s in seeds)


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


class TestDiagnostics:
    def test_split_rhat_many_matches_jax(self, rng):
        x = rng.normal(size=(7, 3, 40))
        x[1] += np.linspace(0, 3, 40)  # a trending row
        x[2] = 1.5  # a constant row: 1.0
        x[3, 0, 5] = np.nan  # a non-finite row: inf
        got, want = split_rhat_many(x), j_split_rhat_many(x)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
        assert got[2] == 1.0 and np.isinf(got[3])

    @pytest.mark.parametrize("health", [None, "one_bad", "all_bad"])
    @pytest.mark.parametrize("with_div", [False, True])
    def test_summary_matches_jax(self, rng, health, with_div):
        samples = {"mu": rng.normal(size=(3, 60, 2)), "sigma": rng.gamma(2.0, size=(3, 60)),
                   "P": rng.dirichlet(np.ones(3), size=(3, 60, 2))}
        h = {None: None, "one_bad": np.array([True, False, True]),
             "all_bad": np.zeros(3, bool)}[health]
        div = rng.random((3, 60)) < 0.05 if with_div else None
        got = summary(samples, health=h, diverging=div)
        want = j_summary(samples, health=h, diverging=div)
        assert set(got) == set(want)
        for name in want:
            assert set(got[name]) == set(want[name]), name
            for k, w in want[name].items():
                if k == "shape":
                    assert got[name][k] == w
                else:
                    np.testing.assert_allclose(got[name][k], w, rtol=1e-10, atol=1e-10,
                                               err_msg=f"{name}.{k}")


# ---------------------------------------------------------------------------
# fit_batched
# ---------------------------------------------------------------------------


GIBBS_SMALL = GibbsConfig(num_warmup=5, num_samples=8, num_chains=1)


class TestFitBatched:
    def test_one_chunk_is_sample_gibbs_with_the_derived_seed(self):
        B, T = 6, 96
        data = _tayal_data(B, T, ragged=True)
        model = TayalHHMM(gate_mode="hard")
        qs, stats = fit_batched(model, data, GIBBS_SMALL, chunk_size=B, seed=11, device="cpu")
        init = default_init(model, data, B, 1, seed=11, device="cpu")
        qs_d, stats_d = sample_gibbs(model, data, init, GIBBS_SMALL, seed=derive_seed(11, 0),
                                     device="cpu")
        assert torch.equal(qs, qs_d)
        assert set(stats) == set(stats_d)
        for k in stats:
            assert torch.equal(stats[k], stats_d[k]), k
        assert tuple(qs.shape) == (B, 1, 8, model.n_free)
        assert bool(stats["chain_healthy"].all())

    def test_ragged_final_chunk_returns_every_series_and_no_padding(self):
        B, T, chunk = 5, 64, 2
        data = _tayal_data(B, T, ragged=True)
        model = TayalHHMM(gate_mode="hard")
        qs, stats = fit_batched(model, data, GIBBS_SMALL, chunk_size=chunk, seed=3, device="cpu")
        assert tuple(qs.shape)[:2] == (B, 1)
        assert all(v.shape[0] == B for v in stats.values())
        # the last chunk holds series 4 and a repeat of it; only series 4 shows
        init = default_init(model, data, B, 1, seed=3, device="cpu")
        last = {k: torch.as_tensor(v[4:5]).repeat(2, *([1] * (v.ndim - 1)))
                for k, v in data.items()}
        qs_d, _ = sample_gibbs(model, last, init[4:5].repeat(2, 1, 1), GIBBS_SMALL,
                               seed=derive_seed(3, 4), device="cpu")
        assert torch.equal(qs[4], qs_d[0])
        # the first chunk is untouched by the others
        qs_0, _ = sample_gibbs(model, {k: torch.as_tensor(v[:2]) for k, v in data.items()},
                               init[:2], GIBBS_SMALL, seed=derive_seed(3, 0), device="cpu")
        assert torch.equal(qs[:2], qs_0)

    def test_cache_hit_returns_identical_arrays(self, tmp_path, capsys):
        B, T = 3, 48
        data = _tayal_data(B, T)
        model = TayalHHMM(gate_mode="hard")
        a = fit_batched(model, data, GIBBS_SMALL, chunk_size=2, cache_dir=str(tmp_path),
                        seed=5, device="cpu")
        n_files = len(list(tmp_path.glob("*.npz")))
        assert n_files == 3  # the inits and two chunks
        capsys.readouterr()
        b = fit_batched(model, data, GIBBS_SMALL, chunk_size=2, cache_dir=str(tmp_path),
                        seed=5, device="cpu")
        assert capsys.readouterr().err.count("cache hit") == 2
        assert len(list(tmp_path.glob("*.npz"))) == n_files
        assert torch.equal(a[0], b[0])
        for k in a[1]:
            assert a[1][k].dtype == b[1][k].dtype and torch.equal(a[1][k], b[1][k]), k
        # another seed is another entry
        fit_batched(model, data, GIBBS_SMALL, chunk_size=2, cache_dir=str(tmp_path),
                    seed=6, device="cpu")
        assert len(list(tmp_path.glob("*.npz"))) == 2 * n_files

    def test_nuts_config_raises(self):
        """The JAX package's NUTS config is not the port's: refused by type
        (the port's own ``SamplerConfig`` runs, `test_torch_nuts_models.py`)."""
        data = _tayal_data(2, 16)
        with pytest.raises(TypeError, match="runs SamplerConfig, GibbsConfig or ChEESConfig"):
            fit_batched(TayalHHMM(), data, JSamplerConfig(), device="cpu")

    def test_inconsistent_series_axis_raises(self):
        with pytest.raises(ValueError, match="inconsistent"):
            fit_batched(TayalHHMM(), {"x": np.zeros((2, 8), np.int32),
                                      "sign": np.zeros((3, 8), np.int32)},
                        GIBBS_SMALL, device="cpu")

    def test_chees_padding_weight_zero_and_repeatable(self, monkeypatch):
        B, T = 3, 40
        data = _tayal_data(B, T, ragged=True)
        model = TayalHHMM()
        cfg = ChEESConfig(num_warmup=4, num_samples=3, num_chains=2, max_leapfrogs=4)
        weights = []

        def spy(*args, series_weight=None, **kw):
            weights.append(series_weight.clone())
            return sample_chees_batched(*args, series_weight=series_weight, **kw)

        monkeypatch.setattr(fit_module, "sample_chees_batched", spy)
        qs, stats = fit_batched(model, data, cfg, chunk_size=2, seed=9, device="cpu")
        assert [w.tolist() for w in weights] == [[1.0, 1.0], [1.0, 0.0]]
        assert tuple(qs.shape) == (B, 2, 3, model.n_free)
        assert all(v.shape[0] == B for v in stats.values())
        qs2, stats2 = fit_batched(model, data, cfg, chunk_size=2, seed=9, device="cpu")
        assert torch.equal(qs, qs2)
        for k in stats:
            assert torch.equal(stats[k], stats2[k]), k


def _mcse(draws):
    """Posterior mean and its Monte Carlo standard error per scalar from
    one chain ``[S, P]``."""
    mean = draws.mean(0)
    se = np.array([draws[:, p].std(ddof=1) / np.sqrt(max(ess(draws[None, :, p]), 1.0))
                   for p in range(draws.shape[1])])
    return mean, se


def test_fit_batched_gibbs_posterior_agrees_with_jax():
    """Both packages' ``fit_batched`` (hard-gate Gibbs, one chain, chunks
    of two, ragged series) on the same data and inits: per-scalar
    posterior means agree within 4 combined MCSE."""
    B, T, warmup, samples = 4, 100, 30, 250
    data = _tayal_data(B, T, seed=1, ragged=True)
    jm, tm = JTayal(gate_mode="hard"), TayalHHMM(gate_mode="hard")
    init = np.asarray(j_default_init(jm, {k: jnp.asarray(v) for k, v in data.items()},
                                     B, 1, jax.random.PRNGKey(100)))
    qs_t, st_t = fit_batched(tm, data, GibbsConfig(warmup, samples, 1), init=init,
                             chunk_size=2, seed=0, device="cpu")
    qs_j, st_j = j_fit_batched(jm, data, jax.random.PRNGKey(0),
                               JGibbsConfig(warmup, samples, 1), init=init, chunk_size=2)
    assert bool(st_t["chain_healthy"].all()) and bool(np.asarray(st_j["chain_healthy"]).all())
    cons_t = tm.constrained_draws(qs_t)
    cons_j = jax.vmap(lambda q: jm.unpack(q)[0])(jnp.asarray(qs_j).reshape(-1, tm.n_free))
    keys = ("p_11", "A_row", "phi_k")
    for b in range(B):
        mt = np.concatenate([cons_t[k][b, 0].reshape(samples, -1).numpy() for k in keys], 1)
        mj = np.concatenate([np.asarray(cons_j[k]).reshape(B, samples, -1)[b] for k in keys], 1)
        mean_t, se_t = _mcse(mt)
        mean_j, se_j = _mcse(mj)
        bound = 4 * np.sqrt(se_t ** 2 + se_j ** 2)
        assert np.all(np.abs(mean_t - mean_j) <= bound), (b, np.abs(mean_t - mean_j) / bound)


# ---------------------------------------------------------------------------
# the walk-forward padding: 1024-multiple buckets past 2048 steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gate", ["hard", "stan"])
def test_padded_ffbs_counts_equal_the_truncated_series(gate):
    """A Gibbs sweep on series padded (``x = sign = 0``, mask 0) to a
    bucket past 2048 steps: the FFBS draw repeats the last valid state
    over the tail, and the conjugate counts and loglik equal those of the
    valid prefix alone."""
    from hhmm_tpu_torch.infer.gibbs import emission_counts, transition_counts
    from hhmm_tpu_torch.kernels import ffbs_dispatch

    lengths, T = (150, 97), 2112
    x, sign = _tayal_batch(2, max(lengths), seed=4)
    x, sign = np.array(x), np.array(sign)
    padded = pad_datasets([{"x": x[b, :n], "sign": sign[b, :n]} for b, n in enumerate(lengths)],
                          ["x", "sign"])
    padded = {k: torch.as_tensor(np.pad(v, ((0, 0), (0, T - v.shape[1])))) for k, v in padded.items()}
    model = TayalHHMM(gate_mode=gate)
    theta = torch.as_tensor(np.random.default_rng(2).normal(size=(2, model.n_free)) * 0.5,
                            dtype=torch.float32)
    params, _ = model.unpack(theta)
    gk = model.gate_keys(padded)
    build = model.build_vg if gk is not None else model.build
    log_pi, log_A, log_obs, mask = build(params, padded)
    z, ll = ffbs_dispatch(torch.Generator().manual_seed(0), log_pi, log_A, log_obs, mask,
                          *(gk if gk is not None else ()))
    for b, n in enumerate(lengths):
        assert bool((z[b, n:] == z[b, n - 1]).all())
        one = {"x": torch.as_tensor(x[b : b + 1, :n]), "sign": torch.as_tensor(sign[b : b + 1, :n])}
        p1 = {k: v[b : b + 1] for k, v in params.items()}
        gk1 = model.gate_keys(one)
        lp1, lA1, lo1, m1 = build(p1, one)
        _, ll1 = ffbs_dispatch(torch.Generator().manual_seed(0), lp1, lA1, lo1, m1,
                               *(gk1 if gk1 is not None else ()))
        np.testing.assert_allclose(ll[b].item(), ll1.item(), rtol=1e-6)
        upd = model.gibbs_update(torch.Generator().manual_seed(1), z[b : b + 1],
                                 {k: v[b : b + 1] for k, v in padded.items()})
        upd1 = model.gibbs_update(torch.Generator().manual_seed(1), z[b : b + 1, :n], one)
        for k in upd:
            assert torch.equal(upd[k], upd1[k]), k  # same counts, same conjugate draws
        assert torch.equal(
            transition_counts(z[b, :], 4, padded["mask"][b]), transition_counts(z[b, :n], 4)
        )
        assert torch.equal(
            emission_counts(z[b], padded["x"][b].long(), 4, 9, padded["mask"][b]),
            emission_counts(z[b, :n], torch.as_tensor(x[b, :n]).long(), 4, 9),
        )


@pytest.mark.parametrize("gate", ["hard", "stan"])
def test_padded_decode_alpha_equals_the_unpadded_prefix(gate):
    """Padded ``sign = 0`` steps pass through the stan gate's keys: the
    filtered probabilities of the valid prefix equal the unpadded
    series' (both segments, bitwise on the CPU)."""
    from hhmm_tpu_torch.models import TayalHHMMLite

    n, n_oos, T, T_oos = 130, 41, 2048, 1024
    x, sign = _tayal_batch(1, n + n_oos, seed=6)
    x, sign = np.array(x)[0], np.array(sign)[0]
    model = TayalHHMMLite(gate_mode=gate)
    theta = torch.as_tensor(np.random.default_rng(3).normal(size=(1, 5, model.n_free)) * 0.5,
                            dtype=torch.float32)

    def pad(a, L):
        return torch.as_tensor(np.pad(a, (0, L - len(a))))[None]

    padded = {"x": pad(x[:n], T), "sign": pad(sign[:n], T),
              "mask": (torch.arange(T) < n).float()[None],
              "x_oos": pad(x[n:], T_oos), "sign_oos": pad(sign[n:], T_oos),
              "mask_oos": (torch.arange(T_oos) < n_oos).float()[None]}
    plain = {"x": torch.as_tensor(x[None, :n]), "sign": torch.as_tensor(sign[None, :n]),
             "x_oos": torch.as_tensor(x[None, n:]), "sign_oos": torch.as_tensor(sign[None, n:])}
    got = model.filtered(theta, padded, device="cpu")
    want = model.filtered(theta, plain, device="cpu")
    assert torch.equal(got["alpha"][..., :n, :], want["alpha"])
    assert torch.equal(got["alpha_oos"][..., :n_oos, :], want["alpha_oos"])
