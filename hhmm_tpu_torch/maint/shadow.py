"""Shadow evaluation: a candidate snapshot must beat the serving one on
held-out data before it may serve (counterpart of
``hhmm_tpu/maint/shadow.py``).

The champion/challenger gate: the refit (``maint/refit.py``) fitted the
history window less an evaluation tail; here both snapshots filter that
tail and are scored on one-step posterior-predictive log-likelihood,
``log p(x_t | x_{<t})`` under each snapshot's mixture of draws (the
quantity :class:`~hhmm_tpu_torch.serve.online.LoglikCUSUM` watches, so
the gate judges on the axis the alarm fired on).

The comparison is paired per tick: both see the same observations.
The challenger's mean per-tick predictive must exceed the champion's by
strictly more than ``margin`` (ties lose). A candidate with non-finite
evidence never wins; a champion with non-finite evidence loses to any
finite challenger.

The JAX package caches one jitted ``vmap`` of the per-draw filter a
model. The port has nothing to compile: the model's batch-native
``unpack`` / ``build`` run over the ``[D]`` draws at once, then
:func:`~hhmm_tpu_torch.serve.online.filter_scan` (the fold the
scheduler's replay uses), on the given device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.core.lmath import safe_logsumexp
from hhmm_tpu_torch.serve.online import filter_scan

__all__ = ["ShadowVerdict", "predictive_logliks", "shadow_evaluate"]


@dataclass(frozen=True)
class ShadowVerdict:
    """One champion/challenger comparison, JSON-ready through
    :meth:`stanza`. ``mean_delta``: the challenger-minus-champion mean
    per-tick predictive loglik (``±inf`` when exactly one side is
    non-finite); ``win_rate``: the share of ticks the challenger led."""

    series_id: str
    ticks: int
    champion_loglik: float
    challenger_loglik: float
    mean_delta: float
    win_rate: float
    margin: float
    accepted: bool

    def stanza(self) -> Dict[str, Any]:
        def _f(v: float):
            return round(v, 4) if np.isfinite(v) else str(v)

        return {
            "series": self.series_id,
            "ticks": self.ticks,
            "champion_per_tick": _f(self.champion_loglik),
            "challenger_per_tick": _f(self.challenger_loglik),
            "mean_delta": _f(self.mean_delta),
            "win_rate": round(self.win_rate, 4),
            "margin": self.margin,
            "accepted": self.accepted,
        }


def _evidence(model, draws: np.ndarray, eval_data: Dict[str, Any], device) -> np.ndarray:
    """Each draw's running filter evidence ``[D, T]`` over ``eval_data``."""
    theta = torch.as_tensor(draws, device=device)
    data = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in eval_data.items()}
    params = model.unpack(theta)[0]
    log_pi, log_A, log_obs, mask = model.build(params, data)
    _, lls = filter_scan(log_pi, log_A, log_obs, mask)
    return lls.cpu()


def predictive_logliks(
    model,
    snap,
    eval_data: Dict[str, Any],
    weights=None,
    *,
    device: DeviceLike = None,
) -> np.ndarray:
    """Per-tick one-step posterior-predictive loglik ``[T]`` of
    ``snap``'s mixture over ``eval_data``, the filters on ``device``
    (None: the card).

    Draw ``d``'s running evidence ``L_d[t] = log p(x_{1:t} | θ_d)`` comes
    from :func:`filter_scan`; the mixture evidence is ``M[t] =
    lse_d(L_d[t]) − log D`` and the per-tick predictive its increment
    (``M[0]`` the first tick's own evidence). ``weights`` (optional
    ``[D]`` log-weights, the adaptation plane's state) gives the
    weighted mixture ``M[t] = lse_d(log ŵ_d + L_d[t])``, renormalised
    over the finite draws. Draws whose final evidence is non-finite are
    left out; with no finite draw every tick reads ``-inf``."""
    device = resolve_device(device)
    draws = snap.dequantized_draws() if hasattr(snap, "dequantized_draws") else np.asarray(snap)
    lls = _evidence(model, np.asarray(draws, np.float32), eval_data, device)  # [D, T]
    finite = torch.isfinite(lls[:, -1])
    if weights is not None:
        lw = torch.as_tensor(np.asarray(weights, np.float64).reshape(-1))
        finite = finite & torch.isfinite(lw)
    if not bool(finite.any()):
        return np.full(lls.shape[1], -np.inf)
    kept = torch.where(finite[:, None], lls, float("-inf"))
    if weights is None:
        mix = safe_logsumexp(kept, dim=0).numpy() - np.log(int(finite.sum()))
    else:
        # renormalise the weights over the surviving draws
        lw_kept = torch.where(finite, lw, float("-inf")).to(torch.float32)
        lw_norm = lw_kept - safe_logsumexp(lw_kept, dim=-1)
        mix = safe_logsumexp(lw_norm[:, None] + kept, dim=0).numpy()
    out = np.empty_like(mix)
    out[0] = mix[0]
    out[1:] = np.diff(mix)
    return out


def shadow_evaluate(
    model,
    champion,
    challenger,
    eval_data: Dict[str, Any],
    *,
    margin: float = 0.0,
    series_id: str = "",
    champion_weights=None,
    device: DeviceLike = None,
) -> ShadowVerdict:
    """Judge ``challenger`` against ``champion`` on the held-out tail
    (the acceptance rule in the module docstring). ``champion_weights``
    (optional ``[D]`` log-weights) scores the champion under its current
    adapted mixture, the tilt the responses serve; the challenger is
    always uniform (a fresh refit has no weight history)."""
    sizes = {int(np.asarray(v).shape[0]) for v in eval_data.values()}
    if len(sizes) != 1 or 0 in sizes:
        raise ValueError(
            f"eval_data must be non-empty per-tick arrays of one length, "
            f"got lengths {sorted(sizes)}"
        )
    T = sizes.pop()
    d_champ = predictive_logliks(model, champion, eval_data, weights=champion_weights,
                                 device=device)
    d_chall = predictive_logliks(model, challenger, eval_data, device=device)
    mean_champ = float(np.mean(d_champ))
    mean_chall = float(np.mean(d_chall))
    if not np.isfinite(mean_chall):
        mean_delta = float("-inf")  # an unservable candidate never wins
    elif not np.isfinite(mean_champ):
        mean_delta = float("inf")  # any finite candidate beats a dead champion
    else:
        mean_delta = mean_chall - mean_champ
    win_rate = float(np.mean(d_chall > d_champ))
    healthy = bool(getattr(challenger, "healthy", True))
    return ShadowVerdict(
        series_id=series_id,
        ticks=T,
        champion_loglik=mean_champ,
        challenger_loglik=mean_chall,
        mean_delta=mean_delta,
        win_rate=win_rate,
        margin=float(margin),
        accepted=bool(healthy and mean_delta > float(margin)),
    )
