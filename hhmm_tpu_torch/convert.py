"""Carry the JAX package's draws and parameters across.

Both packages lay out the unconstrained vector the same way (each
bijector's free slice, in ``specs()`` order) and share constrained
shapes, so conversion is a checked copy of numpy arrays into tensors.
:func:`model_from_jax` builds the port's counterpart of a JAX
multinomial or input-output HMM from its public attributes (read by
name: nothing of the JAX package is imported), so its parameters carry
across to a model of the same configuration.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device

__all__ = ["params_from_jax", "constrained_from_jax", "model_from_jax"]


def model_from_jax(jax_model):
    """The port's model of the same class and configuration as the JAX
    model instance ``jax_model``: ``MultinomialHMM`` (K, L),
    ``SemisupMultinomialHMM`` (K, L, groups, gate_mode), ``IOHMMReg``
    (K, M, trans_mode), ``IOHMMMix`` (K, M, L, trans_mode), ``IOHMMHMix``
    or ``IOHMMHMixLite`` (K, M, L, hyperparams, trans_mode)."""
    from hhmm_tpu_torch import models

    name = type(jax_model).__name__
    m = jax_model
    if name == "MultinomialHMM":
        return models.MultinomialHMM(int(m.K), int(m.L))
    if name == "SemisupMultinomialHMM":
        return models.SemisupMultinomialHMM(int(m.K), int(m.L), np.asarray(m.groups), m.gate_mode)
    if name == "IOHMMReg":
        return models.IOHMMReg(int(m.K), int(m.M), m.trans_mode)
    if name == "IOHMMMix":
        return models.IOHMMMix(int(m.K), int(m.M), int(m.L), m.trans_mode)
    if name in ("IOHMMHMix", "IOHMMHMixLite"):
        cls = getattr(models, name)
        return cls(int(m.K), int(m.M), int(m.L), np.asarray(m.hyperparams), m.trans_mode)
    raise ValueError(f"no port counterpart for the model class {name!r}")


def params_from_jax(
    model, theta_np, device: DeviceLike = None, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Unconstrained draws or inits ``[..., D]`` (numpy, e.g.
    ``np.asarray`` of the JAX package's ``qs`` or ``default_init``) as a
    tensor, after checking ``D == model.n_free``."""
    arr = np.asarray(theta_np)
    if arr.ndim < 1 or arr.shape[-1] != model.n_free:
        raise ValueError(
            f"expected [..., {model.n_free}] unconstrained values for "
            f"{type(model).__name__}, got shape {arr.shape}"
        )
    return torch.as_tensor(np.array(arr), dtype=dtype, device=resolve_device(device))


def constrained_from_jax(
    model,
    params_np: Dict[str, np.ndarray],
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """A constrained parameter dict (numpy arrays with any common leading
    axes) as tensors, after checking its names and trailing shapes
    against ``model.specs()``."""
    device = resolve_device(device)
    specs = dict(model.specs())
    if set(params_np) != set(specs):
        raise ValueError(f"expected parameters {sorted(specs)}, got {sorted(params_np)}")
    out = {}
    for name, bij in specs.items():
        arr = np.asarray(params_np[name])
        nd = len(bij.shape)
        if arr.ndim < nd or tuple(arr.shape[arr.ndim - nd :]) != tuple(bij.shape):
            raise ValueError(
                f"{name}: expected trailing shape {tuple(bij.shape)}, got {arr.shape}"
            )
        out[name] = torch.as_tensor(np.array(arr), dtype=dtype, device=device)
    return out
