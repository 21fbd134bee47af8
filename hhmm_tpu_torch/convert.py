"""Carry the JAX package's draws and parameters across.

Both packages lay out the unconstrained vector the same way (each
bijector's free slice, in ``specs()`` order) and share constrained
shapes, so conversion is a checked copy of numpy arrays into tensors.
:func:`model_from_jax` builds the port's counterpart of a JAX Gaussian,
multinomial, input-output, Tayal or tree HMM or explicit-duration HSMM from its
public attributes (read by name: nothing of the JAX package is
imported), so its parameters carry across to a model of the same
configuration.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.hhmm.structure import End, Internal, Production, finalize

__all__ = ["params_from_jax", "constrained_from_jax", "model_from_jax"]


def model_from_jax(jax_model):
    """The port's model of the same class and configuration as the JAX
    model instance ``jax_model``: ``GaussianHMM`` (K, nig_prior field by
    field, sticky_kappa), ``GaussianHSMM`` (K, Dmax, nig_prior,
    sticky_kappa), ``MultinomialHSMM`` (K, Dmax, L, sticky_kappa),
    ``MultinomialHMM`` (K, L),
    ``SemisupMultinomialHMM`` (K, L, groups, gate_mode), ``IOHMMReg``
    (K, M, trans_mode), ``IOHMMMix`` (K, M, L, trans_mode), ``IOHMMHMix``
    or ``IOHMMHMixLite`` (K, M, L, hyperparams, trans_mode), ``TayalHHMM``
    or ``TayalHHMMLite`` (L, gate_mode), ``TreeHMM``
    (the tree rebuilt node by node, semisup, gate_mode, order_mu and the
    two prior scales)."""
    from hhmm_tpu_torch import models

    name = type(jax_model).__name__
    m = jax_model
    if name == "GaussianHMM":
        return models.GaussianHMM(int(m.K), _nig_from_jax(m.nig_prior), float(m.sticky_kappa))
    if name == "GaussianHSMM":
        return models.GaussianHSMM(int(m.K), int(m.Dmax), _nig_from_jax(m.nig_prior),
                                   float(m.sticky_kappa))
    if name == "MultinomialHSMM":
        return models.MultinomialHSMM(int(m.K), int(m.Dmax), int(m.L), float(m.sticky_kappa))
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
    if name in ("TayalHHMM", "TayalHHMMLite"):
        return getattr(models, name)(int(m.L), m.gate_mode)
    if name == "TreeHMM":
        return models.TreeHMM(
            finalize(_tree_from_jax(m.root)), semisup=bool(m.semisup), gate_mode=m.gate_mode,
            order_mu=m.order_mu, prior_mu_scale=m.prior_mu_scale,
            prior_sigma_scale=m.prior_sigma_scale,
        )
    raise ValueError(f"no port counterpart for the model class {name!r}")


def _nig_from_jax(prior):
    """The port's ``NIGPrior`` with a JAX ``NIGPrior``'s four fields, or
    None."""
    from hhmm_tpu_torch.models import NIGPrior

    if prior is None:
        return None
    return NIGPrior(m0=float(prior.m0), kappa0=float(prior.kappa0), a0=float(prior.a0),
                    b0=float(prior.b0))


def _tree_from_jax(node):
    """The port's copy of a JAX HHMM node and its subtree, from the
    fields of each node class by name (``obs``/``name`` of a
    ``Production``, ``name`` of an ``End``, ``pi``/``A``/``children``/
    ``name`` of an ``Internal``); :func:`finalize` then assigns the
    parents, indices and leaf ids."""
    kind = type(node).__name__
    if kind == "Production":
        obs = node.obs
        if isinstance(obs, tuple):
            obs = (obs[0], {k: np.array(v) if np.ndim(v) else v for k, v in obs[1].items()})
        return Production(obs=obs, name=node.name)
    if kind == "End":
        return End(name=node.name)
    if kind == "Internal":
        return Internal(pi=np.array(node.pi), A=np.array(node.A), name=node.name,
                        children=[_tree_from_jax(c) for c in node.children])
    raise ValueError(f"no port counterpart for the HHMM node class {kind!r}")


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
