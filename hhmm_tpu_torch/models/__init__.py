"""The model parameter contract (with generated quantities), the Tayal
(2009) HHMM, the Gaussian HMM, the multinomial HMMs, the input-output
HMMs, the tree HHMM and the explicit-duration HSMMs."""

from hhmm_tpu_torch.models.base import BaseHMMModel, semisup_gate
from hhmm_tpu_torch.models.gaussian_hmm import GaussianHMM, NIGPrior, nig_emission_draw
from hhmm_tpu_torch.models.hsmm import GaussianHSMM, MultinomialHSMM
from hhmm_tpu_torch.models.iohmm import IOHMMHMix, IOHMMHMixLite, IOHMMMix, IOHMMReg
from hhmm_tpu_torch.models.multinomial_hmm import MultinomialHMM, SemisupMultinomialHMM
from hhmm_tpu_torch.models.tayal import TayalHHMM, TayalHHMMLite
from hhmm_tpu_torch.models.tree import TreeHMM

__all__ = [
    "BaseHMMModel",
    "GaussianHMM",
    "GaussianHSMM",
    "IOHMMHMix",
    "IOHMMHMixLite",
    "IOHMMMix",
    "IOHMMReg",
    "MultinomialHMM",
    "MultinomialHSMM",
    "NIGPrior",
    "SemisupMultinomialHMM",
    "nig_emission_draw",
    "semisup_gate",
    "TayalHHMM",
    "TayalHHMMLite",
    "TreeHMM",
]
