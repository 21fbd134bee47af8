"""Plain scans, the decode, FFBS, value-and-grad and trajectory entries,
and the hand-written CUDA kernels.

``cuda_semiring`` (FFBS, value-and-grad, guarded filter, beta, Viterbi
and backtrack) and ``cuda_traj`` (the fused Tayal trajectory) hold the
CUDA kernels (sources in ``csrc/``),
their plain PyTorch versions and their launch counts; ``cuda_build``
builds and binds them at first use. Importing this package touches no
CUDA.
"""

from hhmm_tpu_torch.kernels.alpha_fused import forward_alpha
from hhmm_tpu_torch.kernels.dispatch import (
    backward_dispatch,
    ffbs_dispatch,
    forward_filter_dispatch,
    make_tayal_trajectory,
    smooth_dispatch,
    tayal_trajectory,
    viterbi_dispatch,
)
from hhmm_tpu_torch.kernels.ffbs import ffbs_fused, ffbs_invcdf_reference
from hhmm_tpu_torch.kernels.filtering import (
    backward_pass,
    filter_step,
    forward_backward,
    forward_filter,
    smooth,
)
from hhmm_tpu_torch.kernels.vg import ForwardLoglik, forward_value_and_grad
from hhmm_tpu_torch.kernels.viterbi import viterbi

__all__ = [
    "forward_alpha",
    "backward_dispatch",
    "ffbs_dispatch",
    "forward_filter_dispatch",
    "smooth_dispatch",
    "viterbi_dispatch",
    "backward_pass",
    "filter_step",
    "forward_backward",
    "smooth",
    "ffbs_fused",
    "ffbs_invcdf_reference",
    "forward_filter",
    "forward_value_and_grad",
    "ForwardLoglik",
    "make_tayal_trajectory",
    "tayal_trajectory",
    "viterbi",
]
