"""Batch layer: ragged padding, the digest-keyed result cache, per-series
chain inits and chunked batched fitting on one card (counterpart of
``hhmm_tpu/batch``)."""

from hhmm_tpu_torch.batch.cache import ResultCache, digest_key
from hhmm_tpu_torch.batch.fit import derive_seed, fit_batched
from hhmm_tpu_torch.batch.init import default_init
from hhmm_tpu_torch.batch.pad import pad_datasets, pad_ragged

__all__ = [
    "pad_ragged",
    "pad_datasets",
    "digest_key",
    "ResultCache",
    "default_init",
    "derive_seed",
    "fit_batched",
]
