"""Sampler-agnostic entry points (counterpart of
``hhmm_tpu/infer/api.py``).

Two density-based samplers exist, NUTS (``infer/run.py``) and ChEES-HMC
(``infer/chees.py``), chosen by the config's type, the convention
``batch/fit.py::fit_batched`` also follows. A consumer that takes "a
sampler config" calls :func:`sample` rather than ``sample_nuts``, so a
:class:`ChEESConfig` works wherever a :class:`SamplerConfig` does. The
JAX signature's ``key`` is ``seed`` here and its ``jit`` has no
counterpart; ``device`` picks the card (the default) or the CPU.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.infer.chees import ChEESConfig, sample_chees
from hhmm_tpu_torch.infer.gibbs import GibbsConfig
from hhmm_tpu_torch.infer.run import sample_nuts

__all__ = ["init_chains", "sample"]


def sample(
    logp_fn: Optional[Callable],
    init_q: torch.Tensor,
    config,
    seed: int = 0,
    device: DeviceLike = None,
    vg_fn: Optional[Callable] = None,
):
    """Run the sampler selected by ``type(config)`` (SamplerConfig →
    NUTS, ChEESConfig → ChEES): ``(samples [chains, draws, dim],
    stats)``, as :func:`~hhmm_tpu_torch.infer.sample_nuts`.

    A :class:`~hhmm_tpu_torch.infer.GibbsConfig` is refused: the Gibbs
    sampler needs the model and data (its parameter block draws from
    count posteriors), not a density; call ``sample_gibbs`` or
    ``fit_batched``, which both take it."""
    if isinstance(config, GibbsConfig):
        raise TypeError(
            "sample() is density-based; GibbsConfig needs the model and "
            "data — call sample_gibbs(model, data, ...) or fit_batched"
        )
    sampler = sample_chees if isinstance(config, ChEESConfig) else sample_nuts
    return sampler(logp_fn, init_q, config, seed=seed, device=device, vg_fn=vg_fn)


def init_chains(
    model, data: Dict[str, torch.Tensor], n_chains: int, seed: int = 0, device: DeviceLike = None
) -> torch.Tensor:
    """``[n_chains, n_free]`` dispersed ``model.init_unconstrained`` draws
    for one series, from one generator seeded with ``seed`` on
    ``device`` (ChEES also relies on dispersed starts for its
    cross-chain criterion)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    data = {k: torch.as_tensor(v, device=device) for k, v in data.items() if v is not None}
    return torch.stack([model.init_unconstrained(gen, data) for _ in range(n_chains)])
