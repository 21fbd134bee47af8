"""Decode and sampling dispatch (counterpart of
``hhmm_tpu/kernels/dispatch.py``).

The JAX package routes among measured ``{seq, assoc, pallas}``
branches. The port has one rule, by device, over a flat batch of ``N``
series (``log_pi [N, K]``, ``log_obs [N, T, K]``, ``mask [N, T]``):

- a homogeneous ``[N, K, K]`` ``log_A`` on CUDA goes to the kernels and
  must be float32 (any other dtype raises); on the CPU it goes to their
  plain versions (any float dtype); both take any K >= 1
  (``K_RANGE``). ``forward_filter_dispatch`` runs
  ``FILTER``, ``backward_dispatch`` ``BETA``, ``smooth_dispatch`` both
  on one lane-layout copy of the operands (the guarded normalisation
  ``filtering.smooth`` applied as plain ops outside the kernels, as the
  JAX pallas branch does), and ``viterbi_dispatch`` ``VITERBI`` then
  ``BACKTRACK``;
- a time-varying ``[N, T-1, K, K]`` ``log_A`` (the Tayal stan gate) runs
  the plain scans of ``kernels/filtering.py`` and ``kernels/viterbi.py``
  on either device, as in the JAX package, whose Pallas kernels never
  take that signature (``_pallas_decode_ok`` refuses it) — so the
  stan-gate OOS Viterbi stays on the scan in both packages;
- ``ffbs_dispatch``: homogeneous ``log_A`` only, the FFBS kernels
  (``FWD`` + ``BWD_SAMPLE``) on CUDA in float32, their plain versions on
  the CPU; any K >= 1 as well.

Operands on other devices, or on mixed devices, raise: no kernel ever
falls back to its plain version. Each call is one span of the obs plane
(``obs/trace.py``, a shared no-op while tracing is off) named with the
branch that ran, as in the JAX module: ``kernels.dispatch.<entry>[cuda]``
for the kernels, ``[plain]`` for their plain versions on the CPU,
``[seq]`` for the time-varying scans. ``make_tayal_trajectory`` /
``tayal_trajectory`` are the sanctioned entries of the fused trajectory
kernel (``kernels/cuda_traj.py``), re-exported here as the JAX module
re-exports ``pallas_traj``'s.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hhmm_tpu_torch.kernels.cuda_semiring import (
    beta_lanes,
    filter_lanes,
    semiring_beta,
    semiring_filter,
    semiring_viterbi,
    to_lanes,
)
from hhmm_tpu_torch.kernels.cuda_traj import make_tayal_trajectory, tayal_trajectory
from hhmm_tpu_torch.kernels.ffbs import ffbs_fused
from hhmm_tpu_torch.kernels.filtering import (
    backward_pass,
    forward_backward,
    forward_filter,
    smooth,
    time_varying,
)
from hhmm_tpu_torch.kernels.viterbi import viterbi
from hhmm_tpu_torch.obs.trace import span

__all__ = [
    "ffbs_dispatch",
    "forward_filter_dispatch",
    "backward_dispatch",
    "smooth_dispatch",
    "viterbi_dispatch",
    "make_tayal_trajectory",
    "tayal_trajectory",
]


def _device_type(*tensors) -> str:
    types = {t.device.type for t in tensors if t is not None}
    if len(types) != 1:
        raise ValueError(f"operands must share one device type, got {sorted(types)}")
    return types.pop()


def _branch_span(name: str, branch: str, K: int, T: int):
    """One span a dispatch with the branch that ran in its name —
    ``kernels.dispatch.ffbs[cuda]`` — annotated with (K, T); the shared
    no-op singleton while tracing is off (the JAX ``_branch_span``)."""
    sp = span(f"kernels.dispatch.{name}[{branch}]")
    sp.annotate(K=K, T=T)
    return sp


def _kernel_branch(log_obs: torch.Tensor) -> str:
    return "cuda" if log_obs.device.type == "cuda" else "plain"


def _kernel_route(log_pi, log_A, log_obs, mask) -> bool:
    """True: the homogeneous kernels (or their plain versions on the
    CPU; any K >= 1); False: the
    scans, for a time-varying ``log_A``. Raises for a device with no
    path and for a non-float32 operand on CUDA (``log_pi`` is None for
    the beta pass)."""
    kind = _device_type(log_pi, log_A, log_obs, mask)
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no decode path for device type {kind!r}")
    if time_varying(log_A, log_obs):
        return False
    if log_A.ndim != 3 or log_obs.ndim != 3:
        raise ValueError(
            "the decode dispatch takes a flat batch: log_obs [N, T, K] with "
            f"log_A [N, K, K] or [N, T-1, K, K], got {tuple(log_obs.shape)} "
            f"and {tuple(log_A.shape)}"
        )
    if kind == "cuda":
        floats = [t for t in (log_pi, log_A, log_obs) if t is not None]
        if any(t.dtype != torch.float32 for t in floats):
            raise TypeError("the CUDA decode kernels take float32 log_pi/log_A/log_obs")
    return True


def _ones_mask(log_obs: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is not None:
        return mask
    return torch.ones(log_obs.shape[:-1], dtype=log_obs.dtype, device=log_obs.device)


def forward_filter_dispatch(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(log_alpha [N, T, K], loglik [N])``, the
    ``filtering.forward_filter`` contract."""
    T, K = log_obs.shape[-2:]
    if _kernel_route(log_pi, log_A, log_obs, mask):
        with _branch_span("forward_filter", _kernel_branch(log_obs), K, T):
            return semiring_filter(log_pi, log_A, log_obs, _ones_mask(log_obs, mask))
    with _branch_span("forward_filter", "seq", K, T):
        return forward_filter(log_pi, log_A, log_obs, mask)


def backward_dispatch(
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``log_beta [N, T, K]``, the ``filtering.backward_pass``
    contract."""
    T, K = log_obs.shape[-2:]
    if _kernel_route(None, log_A, log_obs, mask):
        with _branch_span("backward", _kernel_branch(log_obs), K, T):
            return semiring_beta(log_A, log_obs, _ones_mask(log_obs, mask))
    with _branch_span("backward", "seq", K, T):
        return backward_pass(log_A, log_obs, mask)


def smooth_dispatch(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
):
    """``(log_alpha, log_beta, log_gamma, loglik)``, the
    ``filtering.forward_backward`` contract; both passes take the same
    route, and on the kernels' one the two passes share one lane-layout
    copy of the operands."""
    T, K = log_obs.shape[-2:]
    if _kernel_route(log_pi, log_A, log_obs, mask):
        with _branch_span("smooth", _kernel_branch(log_obs), K, T):
            m = _ones_mask(log_obs, mask)
            pi_t, A_t, obs_t, mask_t, _, _ = to_lanes(log_pi, log_A, log_obs, m)
            ll, alpha_t = filter_lanes(pi_t, A_t, obs_t, mask_t)
            beta_t = beta_lanes(A_t, obs_t, mask_t)
            del pi_t, A_t, obs_t, mask_t
            log_alpha, log_beta = alpha_t.permute(2, 0, 1), beta_t.permute(2, 0, 1)
            return log_alpha, log_beta, smooth(log_alpha, log_beta), ll
    with _branch_span("smooth", "seq", K, T):
        return forward_backward(log_pi, log_A, log_obs, mask)


def viterbi_dispatch(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(path [N, T] int64, log_prob [N])``, the ``viterbi.viterbi``
    contract and tie-breaking."""
    T, K = log_obs.shape[-2:]
    if _kernel_route(log_pi, log_A, log_obs, mask):
        with _branch_span("viterbi", _kernel_branch(log_obs), K, T):
            return semiring_viterbi(log_pi, log_A, log_obs, _ones_mask(log_obs, mask))
    with _branch_span("viterbi", "seq", K, T):
        return viterbi(log_pi, log_A, log_obs, mask)


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
    T, K = log_obs.shape[-2:]
    with _branch_span("ffbs", _kernel_branch(log_obs), K, T):
        return ffbs_fused(generator, log_pi, log_A, log_obs, mask, gate_key, state_key)
