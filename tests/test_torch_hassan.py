"""The port's Hassan (2005) application (`hhmm_tpu_torch/apps/hassan`)
against the JAX package.

- ``make_dataset``, ``simulate_ohlc``, ``neighbouring_forecast`` and
  ``forecast_errors`` (NumPy copies) bitwise equal to the JAX package's
  on the same ``np.random.default_rng`` seeds, with the hand-oracle,
  fallback and weight-quirk cases of ``tests/test_hassan_app.py``;
- the padded step data equal to the JAX ``wf_forecast``'s;
- the forecast step given the same draws: fixed NumPy draws ``[S, 1, n,
  dim]`` through the port's batched ``step_forecasts`` against the JAX
  loop of ``wf.py`` (``IOHMMHMixLite.generated`` per step, then
  ``neighbouring_forecast``): ``oblik_t`` within rtol 1e-5 + atol 1e-4
  of JAX's; the forecasts within rtol 1e-9 of the port's own per-step
  calls' (the batched lanes equal the per-step form) and rtol 1e-6 of
  JAX's (a neighbour selection flips only within float32
  rounding of the band edge; none does on this fixture);
- a tiny ``wf_forecast`` on the CPU: shapes, finiteness, strictly
  out-of-sample ``actual``, a bitwise repeat under the same seed;
- ``slow``: the port's ``wf_forecast`` against the JAX ``wf_forecast``
  on ``tests/test_hassan_app.py``'s trending series and config, the
  point forecasts within 5 Monte Carlo standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhmm_tpu.apps.hassan import data as j_data
from hhmm_tpu.apps.hassan import forecast as j_forecast
from hhmm_tpu.models import IOHMMHMixLite as JLite
from hhmm_tpu_torch.apps.hassan import (
    DEFAULT_HYPERPARAMS,
    forecast_errors,
    make_dataset,
    neighbouring_forecast,
    simulate_ohlc,
    wf_forecast,
)
from hhmm_tpu_torch.apps.hassan.wf import pad_steps, step_datasets, step_forecasts
from hhmm_tpu_torch.infer import SamplerConfig
from hhmm_tpu_torch.models import IOHMMHMixLite

torch.set_num_threads(1)


def _same_dataset(a, b):
    for f in ("x", "u", "x_unscaled", "u_unscaled", "u_center", "u_scale"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.x_center, a.x_scale) == (b.x_center, b.x_scale)


@pytest.mark.parametrize("kw", [
    dict(T=100), dict(T=50, regimes=1, vol=0.008, drift_spread=-0.02),
    dict(T=180, vol=0.02, regimes=2, drift_spread=0.01), dict(T=60, regimes=3, p_stay=0.8),
])
@pytest.mark.parametrize("seed", [0, 2005])
def test_simulate_ohlc_and_make_dataset_bitwise(seed, kw):
    ohlc = simulate_ohlc(np.random.default_rng(seed), **kw)
    np.testing.assert_array_equal(ohlc, j_data.simulate_ohlc(np.random.default_rng(seed), **kw))
    for scale in (True, False):
        _same_dataset(make_dataset(ohlc, scale=scale), j_data.make_dataset(ohlc, scale=scale))
    ds = make_dataset(ohlc)
    np.testing.assert_allclose(ds.unscale_x(ds.x), ds.x_unscaled)
    with pytest.raises(ValueError, match=r"\[T, 4\]"):
        make_dataset(ohlc[:, :3])


@pytest.mark.parametrize("weights", ["reference", "inverse"])
@pytest.mark.parametrize("h, threshold", [(1, 0.05), (1, 0.002), (2, 0.05), (3, 0.2)])
def test_neighbouring_forecast_bitwise(h, threshold, weights):
    rng = np.random.default_rng(17)
    x = 20 + np.cumsum(rng.normal(size=60))
    oblik = -1.0 - rng.gamma(2.0, 0.5, size=(30, 60))
    got = neighbouring_forecast(x, oblik, h=h, threshold=threshold, weights=weights)
    want = j_forecast.neighbouring_forecast(x, oblik, h=h, threshold=threshold, weights=weights)
    np.testing.assert_array_equal(got, want)


def test_forecaster_cases():
    """``tests/test_hassan_app.py``'s hand oracle, fallback and weight
    quirk, and the length and weights errors, on both packages."""
    for nf in (neighbouring_forecast, j_forecast.neighbouring_forecast):
        x = np.array([1.0, 2.0, 5.0, 3.0, 4.0])
        oblik = np.array([[-2.0, -0.99, -3.0, -2.5, -1.0]])
        np.testing.assert_allclose(nf(x, oblik, h=1, threshold=0.05), [4.0 + (5.0 - 2.0)])
        x = np.array([1.0, 2.0, 3.0, 4.0])
        oblik = np.array([[-9.0, -5.0, -8.0, -1.0]])
        np.testing.assert_allclose(nf(x, oblik, h=1, threshold=0.05), [4.0 + 1.0])
        x = np.array([0.0, 10.0, 0.0, -10.0, 0.0])
        oblik = np.array([[-100.0, -100.0, -100.04, -104.0, -100.01]])
        ref, inv = nf(x, oblik), nf(x, oblik, weights="inverse")
        assert ref[0] != inv[0]
        with pytest.raises(ValueError, match="length"):
            nf(np.arange(3.0), np.zeros((2, 4)))
        with pytest.raises(ValueError, match="weights"):
            nf(np.arange(4.0), np.zeros((2, 4)), weights="nearest")
    x = np.array([0.0, 10.0, 0.0, -10.0, 0.0])
    oblik = np.array([[-100.0, -100.0, -100.04, -104.0, -100.01]])
    for w in ("reference", "inverse"):
        np.testing.assert_array_equal(neighbouring_forecast(x, oblik, weights=w),
                                      j_forecast.neighbouring_forecast(x, oblik, weights=w))


def test_forecast_errors_bitwise():
    rng = np.random.default_rng(18)
    actual = 10 + rng.normal(size=40)
    pred = actual + 0.3 * rng.normal(size=40)
    got, want = forecast_errors(actual, pred), j_forecast.forecast_errors(actual, pred)
    assert got == want
    e = forecast_errors(np.array([10.0, 20.0, 30.0]), np.array([11.0, 19.0, 33.0]))
    np.testing.assert_allclose(e["mse"], 11 / 3)
    np.testing.assert_allclose(e["mape"], 100 * np.mean([1 / 10, 1 / 20, 3 / 30]))


def _jax_padded(ohlc, train_len):
    """The JAX ``wf_forecast``'s per-step datasets and padding
    (`hhmm_tpu/apps/hassan/wf.py`), inline there."""
    S = ohlc.shape[0] - train_len
    datasets = [j_data.make_dataset(ohlc[: train_len + s], scale=True) for s in range(S)]
    T_max = len(datasets[-1].x)
    x_pad, u_pad = np.zeros((S, T_max)), np.zeros((S, T_max, 4))
    mask = np.zeros((S, T_max), dtype=np.float32)
    for i, ds in enumerate(datasets):
        T_i = len(ds.x)
        x_pad[i, :T_i], u_pad[i, :T_i], mask[i, :T_i] = ds.x, ds.u, 1.0
    return datasets, x_pad, u_pad, mask


def test_padded_step_data_matches_jax():
    ohlc = simulate_ohlc(np.random.default_rng(19), T=60)
    datasets = step_datasets(ohlc, 50)
    jd, jx, ju, jm = _jax_padded(ohlc, 50)
    assert len(datasets) == 10
    for a, b in zip(datasets, jd):
        _same_dataset(a, b)
    for got, want in zip(pad_steps(datasets), (jx, ju, jm)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="no walk-forward steps"):
        step_datasets(ohlc, 60)


def test_forecast_step_given_the_same_draws():
    """Fixed draws ``[S, 1, n, dim]`` through the port's batched forecast
    step, against the JAX loop and the port's own per-step calls."""
    K, L, train_len, S, n = 3, 2, 40, 3, 12
    ohlc = simulate_ohlc(np.random.default_rng(20), T=train_len + S, vol=0.01)
    datasets = step_datasets(ohlc, train_len)
    model = IOHMMHMixLite(K=K, M=4, L=L, hyperparams=DEFAULT_HYPERPARAMS)
    jm = JLite(K=K, M=4, L=L, hyperparams=DEFAULT_HYPERPARAMS)
    rng = np.random.default_rng(21)
    base = np.asarray(jm.init_unconstrained(
        jax.random.PRNGKey(0), {"x": jnp.asarray(datasets[0].x), "u": jnp.asarray(datasets[0].u)}))
    qs = (base + 0.1 * rng.normal(size=(S, 1, n, base.size))).astype(np.float32)

    got = step_forecasts(model, torch.as_tensor(qs), datasets, device="cpu")
    assert got.shape == (S, n)
    for i, ds in enumerate(datasets):
        flat = qs[i].reshape(-1, qs.shape[-1])
        thin = flat[:: max(1, len(flat) // 100)]
        per_step = {"x": ds.x, "u": ds.u}
        j_ob = np.asarray(jm.generated(jnp.asarray(thin), {k: jnp.asarray(v) for k, v in per_step.items()})["oblik_t"])
        p_ob = model.generated(torch.as_tensor(thin), {k: torch.as_tensor(v, dtype=torch.float32)
                                                      for k, v in per_step.items()}, device="cpu")["oblik_t"].numpy()
        np.testing.assert_allclose(p_ob, j_ob, rtol=1e-5, atol=1e-4)
        j_fc = j_forecast.neighbouring_forecast(ds.x_unscaled, j_ob[:, : len(ds.x)])
        p_fc = neighbouring_forecast(ds.x_unscaled, p_ob)
        np.testing.assert_allclose(got[i], p_fc, rtol=1e-9)
        np.testing.assert_allclose(got[i], j_fc, rtol=1e-6)


def test_tiny_wf_forecast_on_the_cpu():
    ohlc = simulate_ohlc(np.random.default_rng(22), T=40, vol=0.01, regimes=1, drift_spread=-0.01)
    kw = dict(K=2, L=2, config=SamplerConfig(20, 20, 1, max_treedepth=4), seed=3, chunk_size=8,
              device="cpu")
    res = wf_forecast(ohlc, 34, **kw)
    S = 6
    assert res.forecasts.shape == (S, 20) and res.point.shape == (S,)
    assert res.actual.shape == (S,) and res.diverged.shape == (S,)
    assert np.isfinite(res.forecasts).all() and np.isfinite(res.diverged).all()
    assert set(res.errors) == {"mse", "mape", "r2"}
    # strictly out of sample: actual[s] is close[train_len + s]
    np.testing.assert_array_equal(res.actual, ohlc[34:40, 3])
    assert not np.allclose(res.actual, ohlc[33:39, 3])
    again = wf_forecast(ohlc, 34, **kw)
    np.testing.assert_array_equal(again.forecasts, res.forecasts)
    np.testing.assert_array_equal(again.diverged, res.diverged)


@pytest.mark.slow
def test_wf_forecast_agrees_with_jax():
    """``tests/test_hassan_app.py::test_wf_forecast_end_to_end``'s series
    and config on both packages: the point forecasts within 5 Monte
    Carlo standard errors (the two samplers draw different streams)."""
    from hhmm_tpu.apps.hassan import wf_forecast as j_wf_forecast
    from hhmm_tpu.infer import SamplerConfig as JConfig

    ohlc = simulate_ohlc(np.random.default_rng(5), T=120, vol=0.008, regimes=1,
                         drift_spread=-0.02)
    cfg = dict(num_warmup=150, num_samples=150, num_chains=1, max_treedepth=6)
    res = wf_forecast(ohlc, 110, K=2, L=2, config=SamplerConfig(**cfg), chunk_size=16,
                      device="cpu")
    jres = j_wf_forecast(ohlc, 110, K=2, L=2, config=JConfig(**cfg), chunk_size=16)
    assert res.forecasts.shape == jres.forecasts.shape
    assert res.diverged.mean() < 0.2 and res.errors["mape"] < 10.0 and res.errors["r2"] > 0.5
    n = res.forecasts.shape[1]
    mc_se = np.maximum(res.forecasts.std(axis=1), jres.forecasts.std(axis=1)) / np.sqrt(n)
    gap = np.abs(res.point - jres.point)
    assert (gap <= 5.0 * mc_se + 1e-3).all(), (gap, mc_se)
