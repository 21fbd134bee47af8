"""Hassan (2005) application (counterpart of ``hhmm_tpu/apps/hassan``):
IOHMM stock-close forecasting, the dataset construction with its scaling
bookkeeping, the likelihood-neighbour forecaster, the served one-step
forecast ``online_forecast_mean`` and the batched walk-forward harness
on the card.
"""

from hhmm_tpu_torch.apps.hassan.data import Dataset, make_dataset, simulate_ohlc
from hhmm_tpu_torch.apps.hassan.forecast import (
    forecast_errors,
    neighbouring_forecast,
    online_forecast_mean,
)
from hhmm_tpu_torch.apps.hassan.wf import DEFAULT_HYPERPARAMS, WFForecastResult, wf_forecast

__all__ = [
    "Dataset",
    "make_dataset",
    "simulate_ohlc",
    "forecast_errors",
    "neighbouring_forecast",
    "online_forecast_mean",
    "WFForecastResult",
    "wf_forecast",
    "DEFAULT_HYPERPARAMS",
]
