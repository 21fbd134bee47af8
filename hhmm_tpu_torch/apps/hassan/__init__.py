"""Hassan (2005) application (counterpart of ``hhmm_tpu/apps/hassan``):
IOHMM stock-close forecasting, the dataset construction with its scaling
bookkeeping, the likelihood-neighbour forecaster and the batched
walk-forward harness on the card.

Not ported yet: ``online_forecast_mean`` (it reads the serving
scheduler, ``ROADMAP.md`` A10).
"""

from hhmm_tpu_torch.apps.hassan.data import Dataset, make_dataset, simulate_ohlc
from hhmm_tpu_torch.apps.hassan.forecast import forecast_errors, neighbouring_forecast
from hhmm_tpu_torch.apps.hassan.wf import DEFAULT_HYPERPARAMS, WFForecastResult, wf_forecast

__all__ = [
    "Dataset",
    "make_dataset",
    "simulate_ohlc",
    "forecast_errors",
    "neighbouring_forecast",
    "WFForecastResult",
    "wf_forecast",
    "DEFAULT_HYPERPARAMS",
]
