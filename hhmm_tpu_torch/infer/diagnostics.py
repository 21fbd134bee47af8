"""MCMC diagnostics: split-R-hat, effective sample size and posterior
summaries (a copy of the numpy-only estimators in
``hhmm_tpu/infer/diagnostics.py``, so the port needs nothing from the JAX
package).

Stan's estimators (BDA3 / Stan reference): split-chain R-hat; bulk ESS
via FFT autocovariance with Geyer's initial monotone positive sequence.
Host-side numpy: diagnostics are not on the hot path.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["split_rhat", "split_rhat_many", "ess", "ess_many", "summary"]


def _split_chains(x: np.ndarray) -> np.ndarray:
    """[chains, draws] → [2*chains, draws//2]."""
    c, n = x.shape
    half = n // 2
    return np.concatenate([x[:, :half], x[:, n - half :]], axis=0)


def split_rhat(x: np.ndarray) -> float:
    """Potential scale reduction on split chains. ``x`` is [chains, draws].

    Robustness contract (`docs/robustness.md`): non-finite draws (a
    quarantined chain's NaN tail, an overflowed parameter) yield
    ``inf`` — "definitely not converged" — never NaN or an exception;
    zero-variance chains yield 1.0 (a constant is trivially converged).
    """
    x = _split_chains(np.asarray(x, dtype=np.float64))
    if not np.isfinite(x).all():
        return float("inf")
    m, n = x.shape
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    W = chain_vars.mean()
    B = n * chain_means.var(ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * W + B / n
    if W <= 0:
        return 1.0
    return float(np.sqrt(var_plus / W))


def _split_chains_batched(x: np.ndarray) -> np.ndarray:
    """[N, chains, draws] → [N, 2*chains, draws//2] (the batched analog
    of :func:`_split_chains` — single source of the split semantics for
    the vectorized estimators)."""
    n0 = x.shape[-1]
    half = n0 // 2
    return np.concatenate([x[:, :, :half], x[:, :, n0 - half :]], axis=1)


def split_rhat_many(x: np.ndarray) -> np.ndarray:
    """Vectorized :func:`split_rhat` over a leading batch axis:
    ``x`` [N, chains, draws] → [N], identical to the scalar per row
    (including the robustness contract: non-finite rows → ``inf``,
    zero-variance rows → 1.0)."""
    xs = _split_chains_batched(np.asarray(x, dtype=np.float64))
    bad = ~np.isfinite(xs).all(axis=(1, 2))  # [N]
    xs = np.where(bad[:, None, None], 0.0, xs)
    n = xs.shape[-1]
    chain_means = xs.mean(axis=-1)  # [N, m]  (m = 2*chains >= 2)
    chain_vars = xs.var(axis=-1, ddof=1)
    W = chain_vars.mean(axis=-1)  # [N]
    B = n * chain_means.var(axis=-1, ddof=1)
    var_plus = (n - 1) / n * W + B / n
    safe_W = np.where(W > 0, W, 1.0)
    out = np.where(W <= 0, 1.0, np.sqrt(var_plus / safe_W))
    return np.where(bad, np.inf, out)


def _autocovariance_fft(x: np.ndarray) -> np.ndarray:
    """Biased autocovariance per chain via FFT. x: [chains, draws]."""
    m, n = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    pad = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, pad, axis=1)
    acov = np.fft.irfft(f * np.conj(f), pad, axis=1)[:, :n].real
    return acov / n


def ess(x: np.ndarray) -> float:
    """Bulk effective sample size (Stan's estimator, Geyer truncation).

    Robustness contract (`docs/robustness.md`): non-finite draws yield
    0.0 — "no usable information" — never NaN or an exception;
    zero-variance chains yield the nominal draw count.
    """
    x = np.asarray(x, dtype=np.float64)
    if not np.isfinite(x).all():
        return 0.0
    x = _split_chains(x)
    m, n = x.shape
    if n < 4:
        return float(m * n)
    acov = _autocovariance_fft(x)
    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = chain_var.mean()
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    if var_plus <= 0:
        return float(m * n)

    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus  # rho[0] = 1
    # Geyer initial positive monotone sequence on paired sums
    max_pairs = (n - 1) // 2
    rho_even = rho[0 : 2 * max_pairs : 2]
    rho_odd = rho[1 : 2 * max_pairs + 1 : 2]
    paired = rho_even + rho_odd
    # initial positive
    positive = paired > 0
    if not positive[0]:
        tau = 1.0
    else:
        first_neg = np.argmax(~positive) if np.any(~positive) else len(paired)
        p = paired[:first_neg]
        # monotone decreasing
        p = np.minimum.accumulate(p)
        tau = -1.0 + 2.0 * np.sum(p)
    tau = max(tau, 1.0 / np.log10(m * n + 10))
    return float(min(m * n / tau, m * n * np.log10(m * n)))


def ess_many(x: np.ndarray, chunk: int = 512) -> np.ndarray:
    """Vectorized :func:`ess` over a leading batch axis.

    ``x``: [N, chains, draws] → [N] bulk ESS, identical to calling
    ``ess`` per row (same split-chain, FFT autocovariance, and Geyer
    initial-positive-monotone truncation). The bench's worst-parameter
    gate evaluates ~10k (series × parameter) rows of 16k draws — one
    batched FFT per chunk instead of 10k Python calls. ``chunk`` bounds
    the FFT workspace (complex128 [chunk, 2·chains, 2^ceil(log2(2n))]).
    """
    x = np.asarray(x, dtype=np.float64)
    N, c, n0 = x.shape
    half = n0 // 2
    m, n = 2 * c, half
    bad_rows = ~np.isfinite(x).all(axis=(1, 2))  # robustness: see ess()
    if n < 4:
        return np.where(bad_rows, 0.0, float(m * n))
    out = np.empty(N)
    for s in range(0, N, chunk):
        split = _split_chains_batched(
            np.where(bad_rows[s : s + chunk, None, None], 0.0, x[s : s + chunk])
        )
        xc = split - split.mean(axis=-1, keepdims=True)
        pad = int(2 ** np.ceil(np.log2(2 * n)))
        f = np.fft.rfft(xc, pad, axis=-1)
        acov = np.fft.irfft(f * np.conj(f), pad, axis=-1)[..., :n].real / n
        chain_var = acov[..., 0] * n / (n - 1.0)  # [b, m]
        mean_var = chain_var.mean(axis=-1)  # [b]
        var_plus = mean_var * (n - 1.0) / n
        if m > 1:
            var_plus = var_plus + split.mean(axis=-1).var(axis=-1, ddof=1)
        safe_vp = np.where(var_plus > 0, var_plus, 1.0)
        rho = 1.0 - (mean_var[:, None] - acov.mean(axis=1)) / safe_vp[:, None]
        max_pairs = (n - 1) // 2
        paired = (
            rho[:, 0 : 2 * max_pairs : 2] + rho[:, 1 : 2 * max_pairs + 1 : 2]
        )  # [b, P]
        positive = paired > 0
        has_neg = ~positive
        first_neg = np.where(
            has_neg.any(axis=1), has_neg.argmax(axis=1), paired.shape[1]
        )
        pmin = np.minimum.accumulate(paired, axis=1)
        valid = np.arange(paired.shape[1])[None, :] < first_neg[:, None]
        tau = -1.0 + 2.0 * np.sum(np.where(valid, pmin, 0.0), axis=1)
        tau = np.where(positive[:, 0], tau, 1.0)
        tau = np.maximum(tau, 1.0 / np.log10(m * n + 10))
        vals = np.minimum(m * n / tau, m * n * np.log10(m * n))
        out[s : s + chunk] = np.where(var_plus <= 0, float(m * n), vals)
    return np.where(bad_rows, 0.0, out)


def summary(
    samples: Dict[str, np.ndarray],
    probs=(0.025, 0.25, 0.5, 0.75, 0.975),
    health: Optional[np.ndarray] = None,
    diverging: Optional[np.ndarray] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-parameter posterior summary table.

    ``samples[name]`` is [chains, draws, ...]; returns mean/sd/quantiles/
    n_eff/Rhat per scalar component — the equivalent of the reference's
    ``summary(stan.fit)`` block in every R script (`hmm/main.R:59-62`).

    ``health``: optional [chains] bool mask (the samplers'
    ``stats["chain_healthy"]`` — see `robust/guards.py`). Quarantined
    chains are excluded from every statistic, and each parameter's entry
    reports ``chains_used`` / ``chains_quarantined``. If *every* chain
    is quarantined nothing is dropped (``chains_used = 0`` flags that the
    numbers are computed from quarantined chains and are not trustworthy).

    ``diverging``: optional [chains, draws] bool — the samplers'
    ``stats["diverging"]`` (Stan's ΔH > 1000 rule, computed at
    `infer/nuts.py`; ChEES's analog; all-False for Gibbs). Every entry
    then reports ``divergences`` / ``divergence_rate`` alongside R̂/ESS
    — Stan's own summary pairs them for the same reason: a clean R̂
    over divergent transitions is not convergence, it is the sampler
    failing to explore the region that would have broken R̂. Counted
    over the same chains as the statistics (quarantined chains' draws
    are excluded from both).
    """
    keep = None
    n_bad = 0
    if health is not None:
        health = np.asarray(health, dtype=bool).reshape(-1)
        n_bad = int((~health).sum())
        if health.any() and n_bad:
            keep = health
    n_div = div_rate = None
    if diverging is not None:
        div = np.asarray(diverging).astype(bool)
        if div.ndim != 2:
            raise ValueError(f"diverging must be [chains, draws], got {div.shape}")
        if health is not None and div.shape[0] != health.shape[0]:
            raise ValueError(
                f"health mask has {health.shape[0]} chains, "
                f"diverging has {div.shape[0]}"
            )
        if keep is not None:
            div = div[keep]
        n_div = int(div.sum())
        div_rate = float(div.mean()) if div.size else 0.0
    out = {}
    for name, arr in samples.items():
        arr = np.asarray(arr)
        if health is not None and arr.shape[0] != health.shape[0]:
            raise ValueError(
                f"health mask has {health.shape[0]} chains, "
                f"samples[{name!r}] has {arr.shape[0]}"
            )
        if keep is not None:
            arr = arr[keep]
        c, n = arr.shape[:2]
        flatdim = int(np.prod(arr.shape[2:], dtype=np.int64)) if arr.ndim > 2 else 1
        flat = arr.reshape(c, n, flatdim)
        stats = {
            "mean": flat.mean(axis=(0, 1)),
            "sd": flat.std(axis=(0, 1), ddof=1),
            "n_eff": ess_many(np.moveaxis(flat, -1, 0)),
            "rhat": split_rhat_many(np.moveaxis(flat, -1, 0)),
        }
        for p in probs:
            stats[f"q{int(p * 100)}" if p not in (0.025, 0.975) else f"q{p * 100:g}"] = (
                np.quantile(flat, p, axis=(0, 1))
            )
        stats["shape"] = arr.shape[2:]
        if health is not None:
            stats["chains_used"] = c if keep is not None or n_bad == 0 else 0
            stats["chains_quarantined"] = n_bad
        if n_div is not None:
            stats["divergences"] = n_div
            stats["divergence_rate"] = div_rate
        out[name] = stats
    return out
