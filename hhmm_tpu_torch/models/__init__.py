"""The model parameter contract (with generated quantities), the Tayal
(2009) HHMM, the Gaussian HMM, the multinomial HMMs and the
input-output HMMs."""

from hhmm_tpu_torch.models.base import BaseHMMModel, semisup_gate
from hhmm_tpu_torch.models.gaussian_hmm import GaussianHMM, NIGPrior, nig_emission_draw
from hhmm_tpu_torch.models.iohmm import IOHMMHMix, IOHMMHMixLite, IOHMMMix, IOHMMReg
from hhmm_tpu_torch.models.multinomial_hmm import MultinomialHMM, SemisupMultinomialHMM
from hhmm_tpu_torch.models.tayal import TayalHHMM, TayalHHMMLite

__all__ = [
    "BaseHMMModel",
    "GaussianHMM",
    "IOHMMHMix",
    "IOHMMHMixLite",
    "IOHMMMix",
    "IOHMMReg",
    "MultinomialHMM",
    "NIGPrior",
    "SemisupMultinomialHMM",
    "nig_emission_draw",
    "semisup_gate",
    "TayalHHMM",
    "TayalHHMMLite",
]
