"""Batch-native blocked Gibbs, ChEES-HMC and MCMC diagnostics."""

from hhmm_tpu_torch.infer.chees import (
    ChEESConfig,
    halton_base2,
    make_lp_bc,
    sample_chees,
    sample_chees_batched,
)
from hhmm_tpu_torch.infer.diagnostics import ess, ess_many, split_rhat
from hhmm_tpu_torch.infer.gibbs import (
    GibbsConfig,
    emission_counts,
    sample_gibbs,
    transition_counts,
)
from hhmm_tpu_torch.infer.nuts import find_reasonable_step_size
from hhmm_tpu_torch.infer.run import warmup_schedule

__all__ = [
    "ChEESConfig",
    "halton_base2",
    "make_lp_bc",
    "sample_chees",
    "sample_chees_batched",
    "find_reasonable_step_size",
    "warmup_schedule",
    "GibbsConfig",
    "emission_counts",
    "sample_gibbs",
    "transition_counts",
    "ess",
    "ess_many",
    "split_rhat",
]
