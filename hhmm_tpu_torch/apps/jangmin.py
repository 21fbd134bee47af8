"""Jangmin O et al. (2004) market-regime HHMM (counterpart of
``hhmm_tpu/apps/jangmin.py``) — the replication the reference abandoned,
completed.

The reference builds the 5-regime (strong-bear / weak-bear / random /
weak-bull / strong-bull) depth-5 market tree and its simulator
(`hhmm/sim-jangmin2004.R:21-1866`), derives level-1 regime labels from a
moving-average gradient + k-means (`:1906-1920`), and then calls a
semi-supervised Stan model that does not exist in the repository
(`:1963-2010`; README calls the replication abandoned). Here the whole
loop runs: simulate from the tree → price path → MA-gradient k-means
labels → semi-supervised :class:`~hhmm_tpu_torch.models.TreeHMM` fit of
the 63-leaf hierarchy itself, by NUTS on the card (every leapfrog one
``make_vg`` call: the ``FWD`` + ``VG_BWD`` pair at K=63) → regime
recovery diagnostics through the decode kernels.

``simulate_market`` and ``ma_gradient_labels`` are NumPy + scipy copies
of the JAX package's: a seed gives the same series bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.hhmm.examples import jangmin2004_tree
from hhmm_tpu_torch.hhmm.simulate import hhmm_sim
from hhmm_tpu_torch.hhmm.structure import leaf_groups
from hhmm_tpu_torch.infer import SamplerConfig, init_chains, sample
from hhmm_tpu_torch.models.tree import TreeHMM

__all__ = [
    "N_REGIMES",
    "simulate_market",
    "ma_gradient_labels",
    "fit_market",
    "JangminFit",
]

N_REGIMES = 5


def simulate_market(
    T: int, rng: np.random.Generator, price0: float = 100.0
) -> Dict[str, np.ndarray]:
    """Simulate daily returns from the market tree and integrate the
    price path ``price_t = price0 * prod(1 + x)`` (the reference's
    ``cumprod(1+x)`` preprocessing, `sim-jangmin2004.R:1906`). Returns
    ``x`` [T], ``price`` [T], true ``leaf`` ids and ``regime`` labels."""
    tree = jangmin2004_tree()
    leaf_ids, x = hhmm_sim(tree, T=T, rng=rng)
    groups = leaf_groups(tree)
    return {
        "x": np.asarray(x, dtype=np.float64),
        "price": price0 * np.cumprod(1.0 + np.asarray(x)),
        "leaf": leaf_ids,
        "regime": groups[leaf_ids],
    }


def ma_gradient_labels(
    price: np.ndarray, window: int = 5, n_labels: int = N_REGIMES, seed: int = 0
) -> np.ndarray:
    """Level-1 regime labels from the smoothed price gradient
    (`sim-jangmin2004.R:1908-1920`): moving-average the price, take its
    per-step gradient, k-means the gradients into ``n_labels`` clusters,
    and order clusters by center so label 0 = most negative drift
    (strong bear) … ``n_labels−1`` = most positive (strong bull)."""
    from scipy.cluster.vq import kmeans2

    price = np.asarray(price, dtype=np.float64)
    T = price.shape[0]
    if T < window + 1:
        raise ValueError(f"need more than window={window} prices, got {T}")
    kernel = np.ones(window) / window
    ma = np.convolve(price, kernel, mode="valid")  # [T - window + 1]
    grad = np.diff(ma)  # [T - window]
    centers, labels = kmeans2(grad.reshape(-1, 1), n_labels, minit="++", seed=seed)
    order = np.argsort(centers[:, 0])
    remap = np.empty(n_labels, dtype=np.int64)
    remap[order] = np.arange(n_labels)
    g_core = remap[labels]
    # pad the MA/diff boundary so labels align 1:1 with ticks: the first
    # window steps take the first computed label
    pad = T - g_core.shape[0]
    return np.concatenate([np.full(pad, g_core[0], dtype=np.int64), g_core])


@dataclass
class JangminFit:
    model: TreeHMM
    samples: torch.Tensor  # [chains, draws, dim]
    stats: Dict[str, torch.Tensor]
    regime_hat: np.ndarray  # [T] posterior-decoded regime labels
    accuracy: Optional[float]  # vs true regimes when given


def _regime_decode(gamma: np.ndarray, groups: np.ndarray) -> np.ndarray:
    """``[..., T]`` argmax regime of smoothed leaf marginals ``gamma
    [..., T, K]``, each regime's leaves summed."""
    prob = np.stack([gamma[..., groups == r].sum(-1) for r in range(N_REGIMES)], axis=-1)
    return prob.argmax(-1)


def fit_market(
    x: np.ndarray,
    g: np.ndarray,
    config: SamplerConfig = SamplerConfig(num_warmup=200, num_samples=200, num_chains=1, max_treedepth=6),
    seed: int = 0,
    regime_true: Optional[np.ndarray] = None,
    gate_mode: str = "hard",
    device: DeviceLike = None,
) -> JangminFit:
    """Semi-supervised fit of the full 63-leaf market hierarchy on
    returns ``x`` with observed (or k-means-derived) regime labels
    ``g`` — the fit the reference's script attempted with the missing
    `hhmm/stan/hhmm-semisup.stan`. NUTS through ``sample(None, ...,
    vg_fn=model.make_vg(data))`` on ``device`` (None: the card); the
    chain inits from a generator seeded with ``seed``, the sampler from
    ``seed`` too (the JAX signature's ``key``).

    The posterior regime decode is deliberately **unsupervised**: the
    fitted parameters drive an ungated twin of the model (labels
    dropped), smoothed leaf marginals are averaged over thinned draws
    (a posterior-mean decode; one ``generated`` call) and summed within
    each regime, and the argmax regime per step is returned. Decoding
    through the gated model would reproduce ``g`` by construction and
    measure nothing.
    """
    device = resolve_device(device)
    model = TreeHMM(jangmin2004_tree(), semisup=True, gate_mode=gate_mode, order_mu="none")
    data = {
        "x": torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float32, device=device),
        "g": torch.as_tensor(np.asarray(g), dtype=torch.long, device=device),
    }
    theta0 = init_chains(model, data, config.num_chains, seed=seed, device=device)
    qs, stats = sample(None, theta0, config, seed=seed, device=device, vg_fn=model.make_vg(data))

    # unsupervised decode: same parameter space (specs are independent
    # of the semisup flag), no label gating
    decode_model = TreeHMM(jangmin2004_tree(), semisup=False, order_mu="none")
    thin = max(1, config.num_samples // 50)
    gen = decode_model.generated(qs[:, ::thin], {"x": data["x"]}, device=device)
    gamma = gen["gamma"].mean(dim=(0, 1)).cpu().numpy()  # [T, K]
    regime_hat = _regime_decode(gamma, np.asarray(decode_model.groups))
    acc = None
    if regime_true is not None:
        acc = float((regime_hat == np.asarray(regime_true)).mean())
    return JangminFit(
        model=model, samples=qs, stats=stats, regime_hat=regime_hat, accuracy=acc
    )
