"""Batch-native blocked Gibbs, NUTS, ChEES-HMC, the sampler-agnostic
``sample``, MCMC diagnostics and label-switching utilities."""

from hhmm_tpu_torch.infer.api import init_chains, sample
from hhmm_tpu_torch.infer.chees import (
    ChEESConfig,
    halton_base2,
    make_lp_bc,
    sample_chees,
    sample_chees_batched,
)
from hhmm_tpu_torch.infer.diagnostics import ess, ess_many, split_rhat, split_rhat_many, summary
from hhmm_tpu_torch.infer.gibbs import (
    GibbsConfig,
    emission_counts,
    sample_gibbs,
    transition_counts,
)
from hhmm_tpu_torch.infer.nuts import (
    GeneratorDraws,
    NUTSInfo,
    find_reasonable_step_size,
    find_reasonable_step_size_batched,
    nuts_step,
)
from hhmm_tpu_torch.infer.relabel import apply_relabel, confusion_matrix, greedy_relabel
from hhmm_tpu_torch.infer.run import (
    SamplerConfig,
    sample_nuts,
    sample_nuts_batched,
    vg_from_logp,
    warmup_schedule,
)

__all__ = [
    "init_chains",
    "sample",
    "SamplerConfig",
    "sample_nuts",
    "sample_nuts_batched",
    "vg_from_logp",
    "NUTSInfo",
    "GeneratorDraws",
    "nuts_step",
    "find_reasonable_step_size_batched",
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
    "split_rhat_many",
    "summary",
    "apply_relabel",
    "confusion_matrix",
    "greedy_relabel",
]
