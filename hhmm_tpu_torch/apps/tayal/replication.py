"""The pre-registered emission-replication protocol (Tayal §3.6.2;
counterpart of ``hhmm_tpu/apps/tayal/replication.py``).

The published spot-checks φ̂₄₅ = 0.88, φ̂₂₅ = 0.80 (`tayal2009/
main.Rmd:560`) come from one Stan chain; the real-data posterior is
rugged, so a pooled headline depends on the pooling rule. The two arms
of the protocol registered in `docs/phi_protocol.md`:

1. :func:`ml_weighted_pool`: chains pooled with weights ∝ exp(per-chain
   mean marginal log-likelihood, :func:`chain_marginal_ll`).
2. :func:`per_draw_relabel_stats`: Tayal's ex-post bear/bull rule
   (`tayal2009/main.R:176-184`) applied per draw on a fresh FFBS path,
   every draw one lane of one batch.

:func:`degenerate_mode_probe` is the evidence block of the soft gate's
emission-only mode. The FFBS paths come from the Gumbel-max
:func:`~hhmm_tpu_torch.kernels.ffbs.backward_sample` on the model's own
``build`` (the stan gate's time-varying ``log_A``); its noise is an
optional input, so a test can replay the JAX draws.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.kernels.ffbs import backward_sample
from hhmm_tpu_torch.kernels.filtering import forward_filter
from hhmm_tpu_torch.models.base import draw_lanes
from hhmm_tpu_torch.models.tayal import _UP_STATES

__all__ = [
    "chain_marginal_ll",
    "degenerate_mode_probe",
    "ml_weighted_pool",
    "per_draw_relabel_stats",
]

# bear/bull pair swap, keeping up/down roles: pair {0,1} = bear (0 down
# leg, 1 up), {2,3} = bull (2 up, 3 down). An empirical mode fold, not a
# symmetry of the likelihood (the sparse A is asymmetric under it).
_PAIR_SWAP = [3, 2, 1, 0]


def chain_marginal_ll(model, samples, data, n_draws: int = 64, device: DeviceLike = None) -> np.ndarray:
    """Per-chain mean marginal log-likelihood p(x|θ) over ``n_draws``
    evenly thinned draws of ``samples [C, D, dim]``: ``model.loglik`` on
    the constrained parameters (not the HMC target, whose log-Jacobian
    would reorder chains), every kept draw one lane."""
    samples = np.asarray(samples)
    C, D, dim = samples.shape
    sel = np.linspace(0, D - 1, min(n_draws, D)).astype(int)
    _, flat, lanes = draw_lanes(samples[:, sel].reshape(-1, dim), data, device)
    params, _ = model.unpack(flat)
    lls = model.loglik(params, lanes).detach().cpu().numpy()
    return lls.reshape(C, len(sel)).mean(axis=1)


def ml_weighted_pool(per_chain: Dict[str, np.ndarray], mll: np.ndarray) -> Dict:
    """The registered primary estimator: φ̂ = Σ_c w_c φ̄_c with
    w_c ∝ exp(mll_c − max_c mll_c). ``per_chain``: per-chain statistics
    (chain means, relabelled chain-wise); ``mll``: ``[C]`` from
    :func:`chain_marginal_ll`. Returns the weighted estimates and the
    weights' diagnostics (effective chain count 1/Σw², top-chain share)."""
    mll = np.asarray(mll, np.float64)
    w = np.exp(mll - mll.max())
    w = w / w.sum()
    out = {k: float(np.sum(w * np.asarray(v, np.float64))) for k, v in per_chain.items()}
    out["weights"] = w.round(6).tolist()
    out["eff_chains"] = float(1.0 / np.sum(w**2))
    out["top_chain_share"] = float(w.max())
    out["top_chain"] = int(w.argmax())
    return out


def _paths(model, theta, data, generator, noise, device):
    """``(params, log|J|, z [n, T], loglik [n])`` for draws ``theta [n,
    dim]``: the scan filter on ``build``'s terms, then the Gumbel-max
    backward draw."""
    _, flat, lanes = draw_lanes(theta, data, device)
    params, ldj = model.unpack(flat)
    log_pi, log_A, log_obs, _ = model.build(params, lanes)
    log_alpha, ll = forward_filter(log_pi, log_A, log_obs, None)
    z = backward_sample(generator, log_alpha, log_A, None, noise)
    return params, ldj, z, ll


def degenerate_mode_probe(
    model,
    theta,
    data,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> Dict:
    """Evidence for the soft gate's emission-only degenerate mode
    (reference defect #8) at one draw ``theta [dim]``: the share of the
    FFBS path's steps that are sign-consistent (intended mode ≈ 1, the
    degenerate one ≪ 0.5), the state occupancy, the marginal loglik and
    the log-Jacobian. ``noise [T, K]``: the backward draw's Gumbel
    noise, else drawn from ``generator``."""
    device = resolve_device(device)
    theta = torch.as_tensor(theta, dtype=torch.float32, device=device)[None]
    noise = None if noise is None else torch.as_tensor(noise, device=device)[None]
    _, ldj, z, ll = _paths(model, theta, data, generator, noise, device)
    z = z[0].cpu().numpy()
    sign = np.asarray(torch.as_tensor(data["sign"]).cpu())
    consistent = (sign == 0) == np.asarray(_UP_STATES)[z]
    return {
        "path_sign_consistency": round(float(consistent.mean()), 4),
        "state_occupancy": np.round(np.bincount(z, minlength=4) / len(z), 4).tolist(),
        "pure_loglik": round(float(ll[0]), 1),
        "log_jacobian": round(float(ldj[0]), 1),
    }


def per_draw_relabel_stats(
    model,
    draws,
    data: Dict,
    leg_start,
    leg_end,
    price,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    chunk: int = 256,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Per-draw ex-post relabelling for mode-hopping chains.

    For each draw θ of ``draws [N, dim]``: a fresh in-sample path z ~
    p(z | θ, x), its top-state runs (consecutive same-pair legs,
    `tayal2009/main.R:165-174`), the mean run return of each pair, and
    the pair swap when the bear pair out-earns the bull pair
    (`:176-184`). A chunk of ``chunk`` draws is one batch of lanes.
    Returns per-draw ``phi_45``, ``phi_25``, ``swapped`` and ``ll``.

    ``data``: the in-sample ``x`` / ``sign`` ``[T]`` the draws were fit
    on; ``leg_start`` / ``leg_end``: the legs' tick spans, indexing
    ``price``. ``noise [N, T, K]``: the backward draws' Gumbel noise,
    else drawn from ``generator``."""
    device = resolve_device(device)
    draws = torch.as_tensor(draws, dtype=torch.float32, device=device)
    N = draws.shape[0]
    T = int(np.asarray(torch.as_tensor(data["x"]).cpu()).shape[0])
    price_d = torch.as_tensor(np.asarray(price, np.float32), device=device)
    start = torch.as_tensor(np.asarray(leg_start, np.int64), device=device)
    last_end = int(np.asarray(leg_end)[-1])
    pos = torch.arange(T, device=device)
    swap = torch.as_tensor(_PAIR_SWAP, device=device)
    out = {"phi_45": [], "phi_25": [], "swapped": [], "ll": []}
    for i in range(0, N, chunk):
        q = draws[i : i + chunk]
        nz = None if noise is None else torch.as_tensor(noise[i : i + chunk], device=device)
        params, _, z, ll = _paths(model, q, data, generator, nz, device)
        top = (z >= 2).long()  # 0 = bear pair {0,1}, 1 = bull {2,3}
        chg = torch.cat([torch.ones_like(top[:, :1], dtype=torch.bool), top[:, 1:] != top[:, :-1]], 1)
        # the next run-start leg of each leg: a suffix minimum
        m = torch.where(chg, pos, T)
        ahead = torch.cat([m[:, 1:], torch.full_like(m[:, :1], T)], 1)
        nxt = torch.flip(torch.cummin(torch.flip(ahead, [1]), dim=1).values, [1])
        # a run's ticks: its first leg's start to the tick before the next
        # run's first leg (the last run ends at the last leg's end tick)
        e_tick = torch.where(nxt < T, start[torch.clamp(nxt, 0, T - 1)] - 1, last_end)
        r = (price_d[e_tick] - price_d[start]) / price_d[start]
        valid = chg.to(torch.float32)
        bear = valid * (top == 0)
        bull = valid * (top == 1)
        n_bear, n_bull = bear.sum(1), bull.sum(1)
        bear_mean = (r * bear).sum(1) / torch.clamp_min(n_bear, 1.0)
        bull_mean = (r * bull).sum(1) / torch.clamp_min(n_bull, 1.0)
        # a pair with no runs: missing bear -inf, missing bull +inf (no swap)
        bear_mean = torch.where(n_bear > 0, bear_mean, float("-inf"))
        bull_mean = torch.where(n_bull > 0, bull_mean, float("inf"))
        swapped = bear_mean > bull_mean
        phi = params["phi_k"]
        phi = torch.where(swapped[:, None, None], phi[:, swap, :], phi)
        for k, v in (("phi_45", phi[:, 3, 4]), ("phi_25", phi[:, 1, 4]), ("swapped", swapped),
                     ("ll", ll)):
            out[k].append(v.detach().cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}
