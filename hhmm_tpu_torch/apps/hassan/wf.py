"""Walk-forward forecast harness on the card (counterpart of
``hhmm_tpu/apps/hassan/wf.py``), the batched equivalent of
`hassan2005/R/wf-forecast.R:16-112`.

The reference refits `iohmm-hmix-lite.stan` from scratch for every
walk-forward step (S ≈ 80 per symbol) on a socket cluster, noting that
Stan cannot warm-start (`hassan2005/main.Rmd:795`). Here all S steps
are one padded batched fit:

- step s trains on the prefix ``ohlc[: train_len + s]``, re-scaled on
  that prefix alone (`make_dataset(prices[1:T+s], TRUE)`);
- the prefixes are padded to the longest step and masked, and
  ``fit_batched`` fits them as lanes of one value-and-grad call a
  leapfrog (``IOHMMHMixLite.make_vg``: the ``FWD`` + ``VG_BWD`` kernel
  pair on the card);
- warm start: one short pilot fit on the first step's data, through the
  same value-and-grad, seeds every step's chains;
- each step's ``oblik_t`` drives the likelihood-neighbour forecaster;
  every step's thinned draws run as one batch of lanes of
  ``IOHMMHMixLite.generated`` (each lane with its own step's padded,
  masked data), and MSE / MAPE / R² are taken against the realized
  closes (`hassan2005/main.Rmd:920-933`).

The JAX signature's ``key`` is ``seed`` here, and its ``mesh`` is
``device`` (None: CUDA).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.apps.hassan.data import Dataset, make_dataset
from hhmm_tpu_torch.apps.hassan.forecast import forecast_errors, neighbouring_forecast
from hhmm_tpu_torch.batch import derive_seed, fit_batched
from hhmm_tpu_torch.infer import SamplerConfig, init_chains, sample
from hhmm_tpu_torch.models import IOHMMHMixLite

__all__ = [
    "WFForecastResult",
    "wf_forecast",
    "DEFAULT_HYPERPARAMS",
    "step_datasets",
    "pad_steps",
    "step_forecasts",
]

DEFAULT_HYPERPARAMS = np.array([0.0, 5.0, 1.0, 0.0, 3.0, 1.0, 1.0, 0.0, 10.0])


@dataclass
class WFForecastResult:
    forecasts: np.ndarray  # [S, draws] per-step forecast distribution
    point: np.ndarray  # [S] posterior-mean forecasts
    actual: np.ndarray  # [S] realized closes
    errors: Dict[str, float]  # mse/mape/r2
    diverged: np.ndarray  # [S]


def step_datasets(ohlc: np.ndarray, train_len: int) -> List[Dataset]:
    """Step s's dataset, ``make_dataset(ohlc[: train_len + s])``, for s =
    0..S-1 with S = ``len(ohlc) - train_len``."""
    S = ohlc.shape[0] - train_len
    if S < 1:
        raise ValueError("no walk-forward steps: ohlc not longer than train_len")
    return [make_dataset(ohlc[: train_len + s], scale=True) for s in range(S)]


def pad_steps(datasets: List[Dataset]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The steps' scaled data padded to the last (longest) step: ``(x
    [S, T_max], u [S, T_max, 4], mask [S, T_max])``, float64, float64,
    float32."""
    S, T_max = len(datasets), len(datasets[-1].x)
    x_pad = np.zeros((S, T_max))
    u_pad = np.zeros((S, T_max, 4))
    mask = np.zeros((S, T_max), dtype=np.float32)
    for i, ds in enumerate(datasets):
        T_i = len(ds.x)
        x_pad[i, :T_i] = ds.x
        u_pad[i, :T_i] = ds.u
        mask[i, :T_i] = 1.0
    return x_pad, u_pad, mask


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v), dtype=torch.float32, device=device)


def step_forecasts(
    model: IOHMMHMixLite,
    qs: torch.Tensor,
    datasets: List[Dataset],
    h: int = 1,
    threshold: float = 0.05,
    device: DeviceLike = None,
) -> np.ndarray:
    """``forecasts [S, draws]`` from each step's posterior draws ``qs [S,
    chains, samples, dim]``: the draws thinned to about 100 (``flat[::
    max(1, len(flat) // 100)]``, the JAX package's rule), ``oblik_t`` of
    every step's thinned draws as one batch of lanes (each lane on its
    own step's scaled data, padded and masked), then
    :func:`neighbouring_forecast` on the step's unscaled closes."""
    device = resolve_device(device)
    x_pad, u_pad, mask = pad_steps(datasets)
    qs = torch.as_tensor(qs, device=device)
    flat = qs.reshape(qs.shape[0], -1, qs.shape[-1])
    thin = flat[:, :: max(1, flat.shape[1] // 100)]
    data = {"x": _f32(x_pad, device), "u": _f32(u_pad, device), "mask": _f32(mask, device)}
    oblik = model.generated(thin, data, device=device)["oblik_t"].cpu().numpy()
    return np.stack([
        neighbouring_forecast(ds.x_unscaled, oblik[i, :, : len(ds.x)], h=h, threshold=threshold)
        for i, ds in enumerate(datasets)
    ])


def wf_forecast(
    ohlc: np.ndarray,
    train_len: int,
    K: int = 4,
    L: int = 3,
    hyperparams: np.ndarray = DEFAULT_HYPERPARAMS,
    config=SamplerConfig(num_warmup=400, num_samples=400, num_chains=1),
    h: int = 1,
    threshold: float = 0.05,
    seed: int = 0,
    warm_start: bool = True,
    chunk_size: int = 64,
    device: DeviceLike = None,
    cache_dir: Optional[str] = None,
) -> WFForecastResult:
    """``ohlc`` [T_total, 4]; steps s = 0..S−1 with S = T_total − train_len.
    Step s trains on the prefix ``ohlc[: train_len + s]`` (last observed
    close = day ``train_len + s − 1``) and forecasts day ``train_len + s``
    (h=1), so ``actual[s] = close[train_len + s]`` is strictly out of
    sample for every step.

    ``config`` may be a :class:`~hhmm_tpu_torch.infer.SamplerConfig`
    (NUTS) or a :class:`~hhmm_tpu_torch.infer.ChEESConfig` (``num_chains
    >= 2``): the batched fit and the warm-start pilot both follow it.
    The pilot runs ``replace(config, num_samples=max(50, num_samples //
    4))`` on step 0's data; the mean of its draws, ``[chains, dim]``, is
    every step's chain init."""
    device = resolve_device(device)
    ohlc = np.asarray(ohlc, dtype=np.float64)
    datasets = step_datasets(ohlc, train_len)
    S = len(datasets)
    model = IOHMMHMixLite(K=K, M=4, L=L, hyperparams=hyperparams)

    init = None
    if warm_start:
        pilot = {"x": _f32(datasets[0].x, device), "u": _f32(datasets[0].u, device)}
        # same config, smaller draw budget: replace() keeps every other
        # adaptation knob the caller set; sample() dispatches on type
        pilot_cfg = replace(config, num_samples=max(50, config.num_samples // 4))
        pilot_init = init_chains(
            model, pilot, config.num_chains, seed=derive_seed(seed, 99), device=device
        )
        pilot_qs, _ = sample(
            None, pilot_init, pilot_cfg, seed=derive_seed(seed, 98), device=device,
            vg_fn=model.make_vg(pilot),
        )
        seed_theta = pilot_qs.mean(dim=1)  # [chains, dim]
        init = seed_theta[None].expand((S,) + tuple(seed_theta.shape))

    x_pad, u_pad, mask = pad_steps(datasets)
    data = {"x": _f32(x_pad, device), "u": _f32(u_pad, device), "mask": _f32(mask, device)}
    qs, stats = fit_batched(
        model, data, config, init=init, chunk_size=chunk_size, cache_dir=cache_dir,
        seed=seed, device=device,
    )
    forecasts = step_forecasts(model, qs, datasets, h=h, threshold=threshold, device=device)
    point = forecasts.mean(axis=1)
    actual = ohlc[train_len : train_len + S, 3]
    return WFForecastResult(
        forecasts=forecasts,
        point=point,
        actual=actual,
        errors=forecast_errors(actual, point),
        diverged=stats["diverging"].float().mean(dim=(1, 2)).cpu().numpy(),
    )
