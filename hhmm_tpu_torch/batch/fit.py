"""Batched fitting over independent series on one CUDA card
(counterpart of ``hhmm_tpu/batch/fit.py::fit_batched``).

The JAX package vmaps a per-series sampler over a chunk of series
inside one jitted program. Here a chunk is one batch of lanes: the
Gibbs sampler (``infer/gibbs.py``) and the shared-adaptation ChEES
sampler (``infer/chees.py``) are batch-native, so a chunk of ``n``
series × ``C`` chains runs as ``n·C`` lanes of each kernel launch.

- **Chunks.** Series are fitted ``chunk_size`` at a time. A ragged final
  chunk is padded by repeating its last series with weight 0 in the
  pooled ChEES adaptation, and the padding never shows in the result.
- **Cache.** With ``cache_dir``, each chunk (and the chain inits) is
  stored in the digest-keyed :class:`~hhmm_tpu_torch.batch.cache.
  ResultCache`; a rerun reads finished chunks back, the reference's
  RDS memoization (`tayal2009/R/wf-trade.R:86-109`). The stage strings
  name the port's own sampling paths and the device type, so an entry
  written by the JAX package, or by the port on another device, is
  never read as this run's.
- **Health.** Every sampler reports ``stats["chain_healthy"]``. Series
  whose chains were quarantined come back with that mask down, as the
  JAX package returns them once its healing ladder is used up; the
  ladder itself (re-dispatch with re-jittered keys and escalated
  configs), the placement planner and device-fault retries are not
  ported yet.
- **Seeds.** The JAX package splits one PRNG key per series. The port's
  samplers draw a whole chunk from one ``torch.Generator``, seeded with
  :func:`derive_seed` of ``(seed, first series index of the chunk)``:
  a series' draws depend on the chunk layout, and parity with the JAX
  package is distributional.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.batch.cache import ResultCache, digest_key
from hhmm_tpu_torch.batch.init import default_init
from hhmm_tpu_torch.infer.chees import ChEESConfig, make_lp_bc, sample_chees_batched
from hhmm_tpu_torch.infer.gibbs import GibbsConfig, sample_gibbs

__all__ = ["derive_seed", "fit_batched"]


def derive_seed(*parts: Any) -> int:
    """A 60-bit generator seed from a tuple of ints (a digest, so nearby
    tuples give unrelated streams)."""
    return int(digest_key(*[int(p) for p in parts])[:15], 16)


def _model_fingerprint(model) -> Dict[str, Any]:
    """Stable identity of a model instance for cache keys: its class and
    its scalar and array attributes, by value."""
    attrs = {}
    for k, v in sorted(vars(model).items()):
        if isinstance(v, (int, float, str, bool, tuple, list)):
            attrs[k] = v
        elif isinstance(v, (np.ndarray, torch.Tensor)):
            attrs[k] = _host(v)
    return {"class": type(model).__name__, **attrs}


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def fit_batched(
    model,
    data: Dict[str, Any],
    config,
    init: Optional[Any] = None,
    chunk_size: int = 64,
    cache_dir: Optional[str] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fit ``model`` independently to every series in ``data``.

    ``data``: arrays with a leading series axis ``[B, ...]`` (numpy or
    torch; build ragged series with :func:`hhmm_tpu_torch.batch.
    pad_datasets`). ``config`` selects the sampler: a
    :class:`~hhmm_tpu_torch.infer.GibbsConfig` runs blocked conjugate
    Gibbs (the model implements ``gibbs_update``); a
    :class:`~hhmm_tpu_torch.infer.ChEESConfig` runs ChEES-HMC with its
    step size and trajectory length shared over the chunk
    (``make_lp_bc`` over the chunk, the first series' ``make_vg`` for
    the step-size probe, and no fused trajectory, as the JAX
    ``fit_batched`` runs it). NUTS is not ported (``ROADMAP.md`` A5).
    ``init``: ``[B, C, n_free]`` chain inits, else
    :func:`~hhmm_tpu_torch.batch.default_init` seeded from ``seed``.

    Returns ``(samples [B, C, S, n_free], stats)`` on ``device``, every
    stats entry with a leading series axis."""
    if not isinstance(config, (GibbsConfig, ChEESConfig)):
        raise TypeError(
            f"fit_batched runs GibbsConfig or ChEESConfig, got {type(config).__name__}: "
            "the NUTS sampler is not ported yet (ROADMAP.md A5)"
        )
    device = resolve_device(device)
    data = {k: torch.as_tensor(v, device=device) for k, v in data.items() if v is not None}
    sizes = {v.shape[0] for v in data.values()}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent series-axis sizes: {sizes}")
    B = sizes.pop()
    C = config.num_chains
    chees = isinstance(config, ChEESConfig)
    stage = f"{'chees-vg' if chees else 'gibbs'}-torch-v1-{device.type}"
    cache = ResultCache(cache_dir)
    host_data = {k: _host(v) for k, v in data.items()} if cache_dir else None
    if init is None:
        ik = None
        if cache_dir:
            ik = digest_key(_model_fingerprint(model), host_data, {"B": B, "C": C}, seed,
                            f"stage=init-torch-v1-{device.type}")
            hit = cache.get(ik)
            init = None if hit is None else hit["init"]
        if init is None:
            init = default_init(model, data, B, C, seed=seed, device=device)
            if ik is not None:
                cache.put(ik, {"init": _host(init)})
    if not isinstance(init, torch.Tensor):
        init = np.array(init, dtype=np.float32)  # a writable copy (JAX arrays are read-only)
    init = torch.as_tensor(init, dtype=torch.float32, device=device)
    if tuple(init.shape[:2]) != (B, C):
        raise ValueError(f"init must be [B={B}, chains={C}, dim], got {tuple(init.shape)}")

    chunk = max(1, min(int(chunk_size), B))  # as the JAX planner clamps it
    n_chunks = -(-B // chunk)
    qs_parts, stats_parts = [], []
    for s in range(0, B, chunk):
        n = min(chunk, B - s)
        chunk_data = {k: v[s : s + n] for k, v in data.items()}
        chunk_init = init[s : s + n]
        chunk_w = torch.ones((chunk,), dtype=torch.float32, device=device)
        if n < chunk:  # ragged final chunk: repeat the last series, weight 0
            reps = chunk - n
            chunk_data = {
                k: torch.cat([v, v[-1:].expand((reps,) + v.shape[1:])]) for k, v in chunk_data.items()
            }
            chunk_init = torch.cat([chunk_init, chunk_init[-1:].expand((reps,) + chunk_init.shape[1:])])
            chunk_w[n:] = 0.0
        cseed = derive_seed(seed, s)
        label = f"chunk {s // chunk + 1}/{n_chunks}"
        ck = None
        if cache_dir:
            ck = digest_key(
                _model_fingerprint(model),
                {k: _host(v) for k, v in chunk_data.items()},
                vars(config),
                cseed,
                _host(chunk_init),
                f"sampler={stage}",
            )
        hit = cache.get(ck) if ck is not None else None
        if hit is not None:
            qs = torch.as_tensor(hit.pop("samples"), device=device)
            stats = {k: torch.as_tensor(v, device=device) for k, v in hit.items()}
            print(f"# fit_batched {label}: cache hit", file=sys.stderr, flush=True)
        else:
            if chees:
                qs, stats = sample_chees_batched(
                    make_lp_bc(model, chunk_data, device=device),
                    chunk_init,
                    config,
                    seed=cseed,
                    device=device,
                    series_weight=chunk_w,
                    probe_vg=model.make_vg({k: v[0] for k, v in chunk_data.items()}),
                )
            else:
                qs, stats = sample_gibbs(
                    model, chunk_data, chunk_init, config, seed=cseed, device=device
                )
            if ck is not None:
                cache.put(ck, {"samples": _host(qs), **{k: _host(v) for k, v in stats.items()}})
        sick = ~stats["chain_healthy"][:n].reshape(n, -1).all(dim=1)
        if bool(sick.any()):
            print(
                f"# fit_batched {label}: {int(sick.sum())} series quarantined "
                "(returned with chain_healthy=False)",
                file=sys.stderr,
                flush=True,
            )
        qs_parts.append(qs[:n])
        stats_parts.append({k: v[:n] for k, v in stats.items()})

    samples = torch.cat(qs_parts)
    stats = {k: torch.cat([p[k] for p in stats_parts]) for k in stats_parts[0]}
    return samples, stats
