"""Viterbi (max-plus) decoding as a plain scan with backtrace
(counterpart of ``hhmm_tpu/kernels/viterbi.py``), batch-native over
leading axes. Argmax ties go to the lowest index, as in the JAX scan."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hhmm_tpu_torch.kernels.filtering import time_varying

__all__ = ["viterbi"]


def viterbi(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Most-likely state path: ``(path [..., T] int64, log_prob [...])``.
    Every state is initialized, ``delta_0 = log_pi + log_obs_0``; a
    masked step copies the previous delta and emits the identity
    backpointer map."""
    T, K = log_obs.shape[-2:]
    tv = time_varying(log_A, log_obs)
    delta = log_pi + log_obs[..., 0, :]
    identity = torch.arange(K, dtype=torch.long, device=log_obs.device)
    backs = []
    for t in range(1, T):
        lA = log_A[..., t - 1, :, :] if tv else log_A
        scores = delta[..., :, None] + lA  # [..., K(i), K(j)]
        back = torch.argmax(scores, dim=-2)  # first max
        new = scores.amax(dim=-2) + log_obs[..., t, :]
        if mask is not None:
            valid = mask[..., t, None] > 0
            new = torch.where(valid, new, delta)
            back = torch.where(valid, back, identity)
        delta = new
        backs.append(back)
    z = torch.argmax(delta, dim=-1)
    path = [z]
    for back in reversed(backs):
        z = back.gather(-1, z[..., None])[..., 0]
        path.append(z)
    path.reverse()
    return torch.stack(path, dim=-1), delta.amax(dim=-1)
