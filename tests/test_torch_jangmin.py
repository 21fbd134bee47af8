"""The port's Jangmin (2004) application (`hhmm_tpu_torch/apps/jangmin.py`)
against the JAX package's (`hhmm_tpu/apps/jangmin.py`).

- ``simulate_market`` and ``ma_gradient_labels``: bitwise on the same
  seeds (NumPy + scipy copies);
- ``fit_market`` on the CPU (the plain kernel versions) at T=60, 5 + 5,
  depth 3: finite samples and a ``JangminFit`` with the JAX fields;
- the JAX recovery test's gate (``tests/test_jangmin_app.py::
  test_semisup_fit_recovers_regimes``) on the port's ``fit_market``,
  ``slow`` like its JAX twin.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hhmm_tpu.apps import jangmin as j_app
from hhmm_tpu_torch.apps import jangmin as t_app
from hhmm_tpu_torch.infer import SamplerConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_market_bitwise(seed):
    got = t_app.simulate_market(200, np.random.default_rng(seed))
    want = j_app.simulate_market(200, np.random.default_rng(seed))
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("window,n_labels", [(5, 5), (3, 4)])
def test_ma_gradient_labels_bitwise(window, n_labels):
    price = j_app.simulate_market(400, np.random.default_rng(9))["price"]
    for seed in (0, 3):
        got = t_app.ma_gradient_labels(price, window=window, n_labels=n_labels, seed=seed)
        want = j_app.ma_gradient_labels(price, window=window, n_labels=n_labels, seed=seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_short_series_raises():
    with pytest.raises(ValueError, match="window") as got:
        t_app.ma_gradient_labels(np.ones(4))
    with pytest.raises(ValueError) as want:
        j_app.ma_gradient_labels(np.ones(4))
    assert str(got.value) == str(want.value)
    assert t_app.N_REGIMES == j_app.N_REGIMES == 5


def test_fit_market_small_on_the_cpu():
    m = t_app.simulate_market(60, np.random.default_rng(4))
    cfg = SamplerConfig(num_warmup=5, num_samples=5, num_chains=1, max_treedepth=3)
    fit = t_app.fit_market(m["x"], m["regime"], cfg, seed=3, regime_true=m["regime"],
                           device="cpu")
    assert [f.name for f in dataclasses.fields(fit)] == [
        f.name for f in dataclasses.fields(j_app.JangminFit)]
    assert fit.samples.shape == (1, 5, fit.model.n_free) == (1, 5, 202)
    assert torch.isfinite(fit.samples).all()
    assert fit.model.semisup and fit.model.gate_mode == "hard" and fit.model.order_mu == "none"
    assert fit.regime_hat.shape == (60,) and set(np.unique(fit.regime_hat)) <= set(range(5))
    assert fit.accuracy == float((fit.regime_hat == m["regime"]).mean())
    assert fit.stats["diverging"].shape == (1, 5)


@pytest.mark.slow
def test_semisup_fit_recovers_regimes():
    """The JAX test's gate (`tests/test_jangmin_app.py:57-98`) on the
    port: a healthy sampler on the 202-parameter tree posterior whose
    unsupervised decode beats the majority-class rate and is not
    materially below the true-parameter oracle."""
    from hhmm_tpu_torch.hhmm import jangmin2004_tree
    from hhmm_tpu_torch.models import TreeHMM

    m = t_app.simulate_market(250, np.random.default_rng(0))
    cfg = SamplerConfig(num_warmup=100, num_samples=100, num_chains=1, max_treedepth=5)
    fit = t_app.fit_market(m["x"], m["regime"], cfg, seed=3, regime_true=m["regime"],
                           device="cpu")
    assert float(fit.stats["diverging"].float().mean()) < 0.15
    assert torch.isfinite(fit.samples).all()
    oracle = TreeHMM(jangmin2004_tree(), semisup=False, order_mu="none")
    theta = oracle.pack({k: torch.as_tensor(v, dtype=torch.float32)
                         for k, v in oracle.spec_params().items()})
    gamma = oracle.generated(theta[None, None], {"x": torch.as_tensor(m["x"], dtype=torch.float32)},
                             device="cpu")["gamma"][0, 0].numpy()
    groups = np.asarray(oracle.groups)
    rp = np.stack([gamma[:, groups == r].sum(1) for r in range(t_app.N_REGIMES)], 1)
    oracle_acc = float((rp.argmax(1) == m["regime"]).mean())
    majority = np.bincount(m["regime"]).max() / len(m["regime"])
    assert fit.accuracy > majority, (fit.accuracy, majority)
    assert fit.accuracy > oracle_acc - 0.05, (fit.accuracy, oracle_acc)
