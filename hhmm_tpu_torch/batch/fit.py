"""Batched fitting over independent series on one CUDA card
(counterpart of ``hhmm_tpu/batch/fit.py::fit_batched``).

The JAX package vmaps a per-series sampler over a chunk of series
inside one jitted program. Here a chunk is one batch of lanes: NUTS
(``infer/run.py``, every chain adapted on its own, the trees in
lockstep), the Gibbs sampler (``infer/gibbs.py``) and the
shared-adaptation ChEES sampler (``infer/chees.py``) are batch-native,
so a chunk of ``n`` series × ``C`` chains runs as ``n·C`` lanes of each
kernel launch.

- **Chunks.** Series are fitted ``chunk_size`` at a time. A ragged final
  chunk is padded by repeating its last series with weight 0 in the
  ChEES adaptation (NUTS and Gibbs pool nothing), and the padding never
  shows in the result.
- **ChEES.** ``ChEESConfig(shared_adaptation=True)`` (the default) pools
  one step size and trajectory length over the chunk; with ``False``
  each series adapts its own, the chunk still one batch of lanes (the
  JAX package vmaps ``sample_chees`` over series for this).
- **Cache.** With ``cache_dir``, each chunk (and the chain inits) is
  stored in the digest-keyed :class:`~hhmm_tpu_torch.batch.cache.
  ResultCache`; a rerun reads finished chunks back, the reference's
  RDS memoization (`tayal2009/R/wf-trade.R:86-109`). The stage strings
  name the port's own sampling paths and the device type, so an entry
  written by the JAX package, or by the port on another device, is
  never read as this run's.
- **Healing.** Every sampler reports ``stats["chain_healthy"]``. A chunk
  whose real series had a chain quarantined is dispatched again, up to
  ``retry.max_heal_attempts`` times, with the escalated config of
  :func:`~hhmm_tpu_torch.robust.retry.escalate`, fresh inits for the
  sick series (:func:`default_init` at ``derive_seed(seed, series,
  attempt)``) and the re-jittered chunk seed
  :func:`~hhmm_tpu_torch.robust.retry.rejitter`. Only the healed series
  are merged: a healthy series keeps its first dispatch's draws bit for
  bit. A series still quarantined after the ladder comes back with its
  mask down. Each dispatch runs once: a CUDA error raises (see
  ``robust/retry.py``).
- **Placement.** ``plan=`` (``hhmm_tpu_torch.plan.make_plan``) or
  ``mesh=`` (a sequence of devices, a 1-D ``series`` mesh through
  ``plan.plan_for_mesh``) sets the chunk (a multiple of the plan's
  series ways) and splits each chunk into ``series_ways`` shards, one a
  device (``Plan.place``), run one after another; without either, a
  one-device plan on ``device`` is recorded. A shard is dispatched,
  seeded, cached and healed as a chunk of its own, so a planned fit
  equals, bit for bit, the unplanned fit at ``chunk_size`` equal to the
  shard size. The plan's branch scopes ``"auto"`` kernel dispatch
  (``Plan.dispatch_scope``). Results come back on ``device``.
- **Seeds.** The JAX package splits one PRNG key per series. The port's
  samplers draw a whole chunk (a shard under a plan) from one
  ``torch.Generator``, seeded with :func:`derive_seed` of ``(seed,
  first series index of the shard)``: a series' draws depend on the
  chunk layout, and parity with the JAX package is distributional.
"""

from __future__ import annotations

import functools
import sys
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.batch.cache import ResultCache, digest_key
from hhmm_tpu_torch.batch.init import default_init
from hhmm_tpu_torch.infer.chees import ChEESConfig, make_lp_bc, sample_chees_batched
from hhmm_tpu_torch.infer.gibbs import GibbsConfig, sample_gibbs
from hhmm_tpu_torch.infer.diagnostics import ess_many, split_rhat_many
from hhmm_tpu_torch.infer.run import SamplerConfig, sample_nuts_batched
from hhmm_tpu_torch.obs import metrics as obs_metrics
from hhmm_tpu_torch.obs.trace import span
from hhmm_tpu_torch.plan import Plan, WorkloadShape, make_plan, plan_for_mesh
from hhmm_tpu_torch.robust import faults
from hhmm_tpu_torch.robust.retry import RetryPolicy, derive_seed, escalate, rejitter

__all__ = ["derive_seed", "fit_batched", "init_from_snapshot"]


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


# one stderr line a process for each (requested, rounded) chunk pair
_CHUNK_ROUND_WARNED: set = set()
_WARN_LOCK = threading.Lock()

# bound on the (series x parameter) rows fed to the interim per-chunk
# convergence estimators; rows beyond it are stride-decimated
# deterministically (the obs/trace.py sample discipline)
_INTERIM_MAX_ROWS = 4096


def _record_chunk_health(chunk_idx: int, n_chunks: int, qs, stats, n: int) -> None:
    """Interim statistical health of one completed chunk, onto the
    metrics plane (`obs/metrics.py`), as the JAX ``fit_batched`` records
    it: the worst split-R̂ and ESS over (series x parameter) rows, the
    chunk's divergence rate and count, and its quarantined series, each
    per-chunk gauge labeled ``chunk=<i>``; and one stderr line. While
    the plane is disabled it returns before touching a tensor; enabled,
    the chunk's draws and stats come to the host once."""
    if not obs_metrics.registry.enabled():
        return
    label = str(chunk_idx + 1)
    arr = _host(qs)[:n]  # [n, C, S, dim], padding dropped
    C, S = arr.shape[1], arr.shape[2]
    rhat_max = ess_min = float("nan")
    if S >= 4:  # the split-chain estimators need >= 2 draws per half
        rows = np.moveaxis(arr, -1, 1).reshape(-1, C, S)  # [n * dim, C, S]
        if rows.shape[0] > _INTERIM_MAX_ROWS:
            step = -(-rows.shape[0] // _INTERIM_MAX_ROWS)
            rows = rows[::step]
        rhat_max = float(np.max(split_rhat_many(rows)))
        ess_min = float(np.min(ess_many(rows)))
        obs_metrics.gauge("fit.interim.rhat_max", chunk=label).set(rhat_max)
        obs_metrics.gauge("fit.interim.ess_min", chunk=label).set(ess_min)
    div = stats.get("diverging")
    n_div = 0
    div_rate = 0.0
    if div is not None:
        div = _host(div)[:n]
        n_div = int(div.sum())
        div_rate = float(div.mean()) if div.size else 0.0
        obs_metrics.gauge("fit.interim.divergence_rate", chunk=label).set(div_rate)
        obs_metrics.counter("fit.divergences").inc(n_div)
    n_quar = 0
    ch = stats.get("chain_healthy")
    if ch is not None:
        ch = _host(ch)[:n]
        n_quar = int((~ch.reshape(ch.shape[0], -1).all(axis=1)).sum())
        obs_metrics.gauge("fit.interim.quarantined_series", chunk=label).set(n_quar)
        obs_metrics.counter("fit.quarantined_series").inc(n_quar)
    obs_metrics.counter("fit.chunks").inc()
    print(
        f"# fit_batched chunk {label}/{n_chunks} health: "
        f"rhat_max={rhat_max:.3f} ess_min={ess_min:.1f} "
        f"divergences={n_div} ({div_rate:.4f}) quarantined={n_quar}",
        file=sys.stderr,
        flush=True,
    )


def init_from_snapshot(snap, num_chains: int, device: DeviceLike = None) -> torch.Tensor:
    """``[num_chains, dim]`` float32 warm-start chain inits from a serving
    snapshot's draw bank, on ``device`` (None: CUDA) — the ``init=`` a
    drift-triggered refit passes so it starts from the posterior it
    refreshes.

    ``snap`` is anything with ``dequantized_draws()`` (a
    ``serve.registry.PosteriorSnapshot``: a quantized bank dequantizes to
    float32 first) or a raw ``[D, dim]`` array. A bank larger than the
    chain count is thinned evenly spaced (distinct modes land in
    distinct chains); a smaller one tiles."""
    device = resolve_device(device)
    if hasattr(snap, "dequantized_draws"):
        draws = np.asarray(snap.dequantized_draws())
    else:
        draws = _host(snap)
    if draws.ndim != 2 or draws.shape[0] == 0:
        raise ValueError(
            f"snapshot draws must be a non-empty [D, dim] bank, got shape {draws.shape}"
        )
    C = int(num_chains)
    if C <= 0:
        raise ValueError(f"num_chains must be positive, got {num_chains}")
    D = draws.shape[0]
    if D >= C:
        out = draws[np.linspace(0, D - 1, C).astype(int)]
    else:
        out = draws[np.arange(C) % D]
    return torch.as_tensor(np.asarray(out, np.float32), device=device)


def fit_batched(
    model,
    data: Dict[str, Any],
    config=SamplerConfig(),
    init: Optional[Any] = None,
    chunk_size: int = 64,
    cache_dir: Optional[str] = None,
    seed: int = 0,
    device: DeviceLike = None,
    retry: Optional[RetryPolicy] = None,
    mesh: Optional[Sequence[Any]] = None,
    plan: Optional[Plan] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fit ``model`` independently to every series in ``data``.

    ``data``: arrays with a leading series axis ``[B, ...]`` (numpy or
    torch; build ragged series with :func:`hhmm_tpu_torch.batch.
    pad_datasets`). ``config`` selects the sampler: a
    :class:`~hhmm_tpu_torch.infer.SamplerConfig` (the default) runs NUTS
    with every chain adapted on its own (``sample_nuts_batched`` on the
    chunk's ``model.make_vg``: one value-and-grad call over the chunk's
    lanes a leapfrog); a :class:`~hhmm_tpu_torch.infer.GibbsConfig`
    runs blocked conjugate Gibbs (the model implements
    ``gibbs_update``); a :class:`~hhmm_tpu_torch.infer.ChEESConfig` runs
    ChEES-HMC over the chunk's ``make_lp_bc``, with no fused trajectory,
    as the JAX ``fit_batched`` runs it: with its step size and
    trajectory length shared over the chunk (the first series'
    ``make_vg`` for the step-size probe), or, with
    ``shared_adaptation=False``, adapted per series (the chunk's
    ``make_vg`` for the probes).
    ``init``: ``[B, C, n_free]`` chain inits, else
    :func:`~hhmm_tpu_torch.batch.default_init` seeded from ``seed``.
    ``retry``: the healing policy (default ``RetryPolicy()``; see the
    module docstring). ``plan`` / ``mesh``: the placement (module
    docstring; not both). An explicit plan governs chunking
    (``chunk_size`` is then unused) and must divide the chains when it
    has a chain axis.

    Returns ``(samples [B, C, S, n_free], stats)`` on ``device``, every
    stats entry with a leading series axis."""
    if not isinstance(config, (SamplerConfig, GibbsConfig, ChEESConfig)):
        raise TypeError(
            "fit_batched runs SamplerConfig, GibbsConfig or ChEESConfig, got "
            f"{type(config).__name__}"
        )
    if plan is not None and mesh is not None:
        raise ValueError("pass plan= or mesh=, not both")
    device = resolve_device(device)
    policy = retry if retry is not None else RetryPolicy()
    data = {k: torch.as_tensor(v, device=device) for k, v in data.items() if v is not None}
    sizes = {v.shape[0] for v in data.values()}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent series-axis sizes: {sizes}")
    B = sizes.pop()
    C = config.num_chains
    chees = isinstance(config, ChEESConfig)
    nuts = isinstance(config, SamplerConfig)
    # v2: a chunk's draws include its healed series
    stage = f"{'chees-vg' if chees else 'nuts-vg' if nuts else 'gibbs'}-torch-v2-{device.type}"
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

    # ---- placement (hhmm_tpu_torch/plan): chunk, shards and branch ----
    if plan is None:
        T_guess = max([int(v.shape[1]) for v in data.values() if v.ndim >= 2] or [1])
        shape_w = WorkloadShape(B=B, T=T_guess, C=C, K=int(getattr(model, "K", 0) or 0))
        if mesh is not None:
            plan = plan_for_mesh(mesh, shape_w, chunk_size=chunk_size)
        else:
            plan = make_plan(shape_w, devices=[device], chunk_size=chunk_size)
    else:
        cw = plan.ways("chain")
        if cw > 1 and C % cw != 0:
            raise ValueError(
                f"plan shards chains {cw}-ways but config.num_chains={C} is not divisible "
                f"by it — build the plan with WorkloadShape(C={C}) (got plan for "
                f"{plan.shape.as_dict()})"
            )
        if int(plan.shape.B) != B:
            print(
                f"# fit_batched: plan was built for B={plan.shape.B} series, fitting B={B} "
                f"(the plan's chunk {plan.chunk} governs; chunk_size= is ignored when plan= "
                "is given)",
                file=sys.stderr,
                flush=True,
            )
        plan.note()
    chunk, ways = plan.chunk, plan.series_ways
    if chunk != plan.chunk_requested:
        with _WARN_LOCK:
            first = (plan.chunk_requested, chunk) not in _CHUNK_ROUND_WARNED
            _CHUNK_ROUND_WARNED.add((plan.chunk_requested, chunk))
        if first:
            print(
                f"# fit_batched: chunk_size {plan.chunk_requested} rounded up to {chunk} "
                f"(multiple of mesh series axis {ways}; ragged tails pad by lane repeat "
                "with weight 0)",
                file=sys.stderr,
                flush=True,
            )

    def run(cfg, chunk_data, chunk_init, chunk_w, cseed, dev):
        """One dispatch of a shard on ``dev``, under the plan's branch."""
        with plan.dispatch_scope():
            if chees:
                # the step-size probe: the first series (shared) or each series
                probe = (
                    {k: v[0] for k, v in chunk_data.items()} if cfg.shared_adaptation else chunk_data
                )
                return sample_chees_batched(
                    make_lp_bc(model, chunk_data, device=dev),
                    chunk_init,
                    cfg,
                    seed=cseed,
                    device=dev,
                    series_weight=chunk_w,
                    probe_vg=model.make_vg(probe),
                )
            if nuts:
                return sample_nuts_batched(
                    model.make_vg(chunk_data), chunk_init, cfg, seed=cseed, device=dev
                )
            return sample_gibbs(model, chunk_data, chunk_init, cfg, seed=cseed, device=dev)

    # a chunk is `ways` shards of `shard` series, shard d on the plan's
    # device d: the units, in their order, of an unplanned fit at
    # chunk_size=shard
    shard = chunk // ways
    n_chunks = -(-B // shard)
    qs_parts, stats_parts = [], []
    for s in range(0, B, shard):
        d = (s // shard) % ways
        n = min(shard, B - s)
        chunk_data = {k: v[s : s + n] for k, v in data.items()}
        chunk_init = init[s : s + n]
        chunk_w = torch.ones((shard,), dtype=torch.float32, device=device)
        if n < shard:  # ragged final shard: repeat the last series, weight 0
            reps = shard - n
            chunk_data = {
                k: torch.cat([v, v[-1:].expand((reps,) + v.shape[1:])]) for k, v in chunk_data.items()
            }
            chunk_init = torch.cat([chunk_init, chunk_init[-1:].expand((reps,) + chunk_init.shape[1:])])
            chunk_w[n:] = 0.0
        chunk_data = {k: plan.place(v, d) for k, v in chunk_data.items()}
        chunk_init, chunk_w = plan.place(chunk_init, d), plan.place(chunk_w, d)
        run_d = functools.partial(run, dev=chunk_init.device)
        cseed = derive_seed(seed, s)
        label = f"chunk {s // shard + 1}/{n_chunks}" + (f" (device {d + 1}/{ways})" if ways > 1 else "")
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
            # span boundary (obs/trace.py): synced, so it covers the
            # chunk's work on the card
            with span("batch.fit.chunk") as sp_c:
                sp_c.annotate(chunk=label, series=n)
                qs, stats = sp_c.sync(run_d(config, chunk_data, chunk_init, chunk_w, cseed))
            qs, stats = faults.corrupt_chunk_result(qs, stats, s, n, attempt=0)
            qs, stats = _heal(run_d, policy, config, model, chunk_data, chunk_init, chunk_w,
                              cseed, seed, s, n, qs, stats, label)
            qs, stats = qs.to(device), {k: v.to(device) for k, v in stats.items()}
            if ck is not None:
                cache.put(ck, {"samples": _host(qs), **{k: _host(v) for k, v in stats.items()}})
            print(f"# fit_batched {label}: computed + cached", file=sys.stderr, flush=True)
            # fault injection: a simulated crash between chunks (the
            # cached chunks above make the rerun resume)
            faults.note_chunk_complete()
        # interim convergence trajectory (metrics plane), cache hits
        # included, so a resumed sweep still covers every chunk
        _record_chunk_health(s // shard, n_chunks, qs, stats, n)
        qs_parts.append(qs[:n])
        stats_parts.append({k: v[:n] for k, v in stats.items()})

    samples = torch.cat(qs_parts)
    stats = {k: torch.cat([p[k] for p in stats_parts]) for k in stats_parts[0]}
    return samples, stats


def _sick_series(stats, chunk_w: torch.Tensor) -> np.ndarray:
    """Host bool ``[chunk]``: the real series (weight > 0) with a
    quarantined chain."""
    ch = stats["chain_healthy"]
    bad = ~ch.reshape(ch.shape[0], -1).all(dim=1)
    return _host(bad & (chunk_w > 0))


def _heal(run, policy, config, model, chunk_data, chunk_init, chunk_w, cseed, seed, s, n,
          qs, stats, label):
    """The healing ladder of one chunk (the JAX ``fit_batched`` loop):
    re-dispatch the whole chunk while real series are quarantined, and
    merge only the healed series."""
    sick = _sick_series(stats, chunk_w)
    C = chunk_init.shape[1]
    for attempt in range(1, policy.max_heal_attempts + 1):
        if not sick.any():
            break
        cfg = escalate(config, attempt, policy)
        init_r = chunk_init.clone()
        for i in np.flatnonzero(sick):
            one = {k: v[i : i + 1] for k, v in chunk_data.items()}
            init_r[i] = default_init(model, one, 1, C, seed=derive_seed(seed, s + int(i), attempt),
                                     device=chunk_init.device)[0]
        print(
            f"# fit_batched {label}: healing attempt {attempt}/{policy.max_heal_attempts} for "
            f"{int(sick.sum())} quarantined series" + ("" if cfg == config else " (escalated config)"),
            file=sys.stderr,
            flush=True,
        )
        with span("batch.fit.heal") as sp_h:
            sp_h.annotate(chunk=label, attempt=attempt)
            qs2, stats2 = sp_h.sync(run(cfg, chunk_data, init_r, chunk_w, rejitter(cseed, attempt)))
        qs2, stats2 = faults.corrupt_chunk_result(qs2, stats2, s, n, attempt=attempt)
        obs_metrics.counter("fit.heal_attempts").inc()
        healed = sick & ~_sick_series(stats2, chunk_w)
        obs_metrics.counter("fit.healed_series").inc(int(healed.sum()))
        if healed.any():
            hm = torch.as_tensor(healed, device=qs.device)

            def merge(a, b):
                return torch.where(hm.reshape((-1,) + (1,) * (a.ndim - 1)), b, a)

            qs = merge(qs, qs2)
            stats = {k: merge(v, stats2[k]) for k, v in stats.items()}
            sick = sick & ~healed
    if sick.any():
        obs_metrics.counter("fit.unhealed_series").inc(int(sick.sum()))
        print(
            f"# fit_batched {label}: {int(sick.sum())} series still quarantined after "
            f"{policy.max_heal_attempts} healing attempts (returned with chain_healthy=False)",
            file=sys.stderr,
            flush=True,
        )
    return qs, stats
