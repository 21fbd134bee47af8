"""Plain scans, the FFBS, value-and-grad and trajectory entries, and
the hand-written CUDA kernels.

``cuda_semiring`` (FFBS and value-and-grad) and ``cuda_traj`` (the
fused Tayal trajectory) hold the CUDA kernels (sources in ``csrc/``),
their plain PyTorch versions and their launch counts; ``cuda_build``
builds and binds them at first use. Importing this package touches no
CUDA.
"""

from hhmm_tpu_torch.kernels.alpha_fused import forward_alpha
from hhmm_tpu_torch.kernels.dispatch import (
    ffbs_dispatch,
    make_tayal_trajectory,
    tayal_trajectory,
    viterbi_dispatch,
)
from hhmm_tpu_torch.kernels.ffbs import ffbs_fused, ffbs_invcdf_reference
from hhmm_tpu_torch.kernels.filtering import forward_filter
from hhmm_tpu_torch.kernels.vg import ForwardLoglik, forward_value_and_grad
from hhmm_tpu_torch.kernels.viterbi import viterbi

__all__ = [
    "forward_alpha",
    "ffbs_dispatch",
    "viterbi_dispatch",
    "ffbs_fused",
    "ffbs_invcdf_reference",
    "forward_filter",
    "forward_value_and_grad",
    "ForwardLoglik",
    "make_tayal_trajectory",
    "tayal_trajectory",
    "viterbi",
]
