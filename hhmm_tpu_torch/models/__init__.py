"""The model parameter contract (with generated quantities), the Tayal
(2009) HHMM and the Gaussian HMM."""

from hhmm_tpu_torch.models.base import BaseHMMModel
from hhmm_tpu_torch.models.gaussian_hmm import GaussianHMM, NIGPrior, nig_emission_draw
from hhmm_tpu_torch.models.tayal import TayalHHMM, TayalHHMMLite

__all__ = [
    "BaseHMMModel",
    "GaussianHMM",
    "NIGPrior",
    "nig_emission_draw",
    "TayalHHMM",
    "TayalHHMMLite",
]
