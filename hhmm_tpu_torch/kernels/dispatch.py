"""Minimal decode/sampling dispatch (counterpart of
``hhmm_tpu/kernels/dispatch.py``).

The JAX package routes among measured ``{seq, assoc, pallas}``
branches. The port has one rule, by device:

- ``ffbs_dispatch``: homogeneous ``log_A`` only. A CUDA operand goes to
  the FFBS kernels and must be float32; a CPU operand goes to their plain
  versions. Anything else raises — no kernel ever falls back to its
  plain version.
- ``viterbi_dispatch``: a time-varying ``[N, T-1, K, K]`` ``log_A`` (the
  Tayal stan gate) runs the scan on either device, as in the JAX package,
  whose Pallas Viterbi never takes that signature. A homogeneous
  ``log_A`` runs the scan on the CPU and raises on CUDA: the Viterbi
  kernel (``_semiring_fwd_kernel`` mode "viterbi" + ``_backtrack_kernel``)
  is not ported yet. The stan-gate Tayal OOS Viterbi passes a
  time-varying ``log_A`` and so stays on the scan in both packages
  (``hhmm_tpu/kernels/dispatch.py::_pallas_decode_ok`` refuses it).
- ``make_tayal_trajectory`` / ``tayal_trajectory``: the sanctioned
  entries of the fused trajectory kernel (``kernels/cuda_traj.py``),
  re-exported here as the JAX module re-exports ``pallas_traj``'s.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hhmm_tpu_torch.kernels.cuda_traj import make_tayal_trajectory, tayal_trajectory
from hhmm_tpu_torch.kernels.ffbs import ffbs_fused
from hhmm_tpu_torch.kernels.filtering import time_varying
from hhmm_tpu_torch.kernels.viterbi import viterbi

__all__ = ["ffbs_dispatch", "viterbi_dispatch", "make_tayal_trajectory", "tayal_trajectory"]


def _device_type(*tensors) -> str:
    types = {t.device.type for t in tensors if t is not None}
    if len(types) != 1:
        raise ValueError(f"operands must share one device type, got {sorted(types)}")
    return types.pop()


def ffbs_dispatch(
    generator: torch.Generator,
    log_pi: torch.Tensor,  # [N, K]
    log_A: torch.Tensor,  # [N, K, K]
    log_obs: torch.Tensor,  # [N, T, K]
    mask: Optional[torch.Tensor] = None,
    gate_key: Optional[torch.Tensor] = None,
    state_key: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FFBS draw ``(z [N, T] int64, loglik [N])`` for a flat batch."""
    if (gate_key is None) != (state_key is None):
        raise ValueError("gate_key and state_key must be given together")
    if log_A.ndim != 3:
        raise ValueError(
            f"ffbs_dispatch needs homogeneous log_A [N, K, K], got {tuple(log_A.shape)}"
        )
    kind = _device_type(log_pi, log_A, log_obs, mask, gate_key, state_key)
    if kind == "cuda":
        floats = [t for t in (log_pi, log_A, log_obs) if t is not None]
        if any(t.dtype != torch.float32 for t in floats):
            raise TypeError("the CUDA FFBS kernels take float32 log_pi/log_A/log_obs")
    elif kind != "cpu":
        raise ValueError(f"no FFBS path for device type {kind!r}")
    return ffbs_fused(generator, log_pi, log_A, log_obs, mask, gate_key, state_key)


def viterbi_dispatch(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(path [N, T] int64, log_prob [N])`` — see the module docstring
    for which signatures run where."""
    kind = _device_type(log_pi, log_A, log_obs, mask)
    if time_varying(log_A, log_obs) or kind == "cpu":
        return viterbi(log_pi, log_A, log_obs, mask)
    raise NotImplementedError(
        "homogeneous-log_A Viterbi on CUDA needs the Viterbi kernel, which "
        "is not ported yet (pallas_semiring.py _semiring_fwd_kernel mode "
        "'viterbi' + _backtrack_kernel)"
    )
