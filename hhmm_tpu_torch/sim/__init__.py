"""Simulators on torch.Generator streams."""

from hhmm_tpu_torch.sim.hmm import (
    hmm_sim,
    markov_chain_sim,
    obsmodel_categorical,
    obsmodel_gaussian,
)
from hhmm_tpu_torch.sim.tayal import tayal_batch

__all__ = [
    "hmm_sim",
    "markov_chain_sim",
    "obsmodel_categorical",
    "obsmodel_gaussian",
    "tayal_batch",
]
