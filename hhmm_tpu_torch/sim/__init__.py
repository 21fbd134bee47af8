"""Simulators on torch.Generator streams."""

from hhmm_tpu_torch.sim.hmm import (
    hmm_sim,
    hsmm_sim,
    markov_chain_sim,
    obsmodel_categorical,
    obsmodel_gaussian,
)
from hhmm_tpu_torch.sim.iohmm import iohmm_sim, obsmodel_mix, obsmodel_reg
from hhmm_tpu_torch.sim.tayal import tayal_batch

__all__ = [
    "hmm_sim",
    "hsmm_sim",
    "iohmm_sim",
    "markov_chain_sim",
    "obsmodel_categorical",
    "obsmodel_gaussian",
    "obsmodel_mix",
    "obsmodel_reg",
    "tayal_batch",
]
