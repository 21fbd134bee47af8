"""Shared helpers of the port's example drivers (counterpart of
``examples/_common.py``; the reference's `main.R` "Set up" and
diagnostics blocks, `hmm/main.R:7-18,59-87`).

Every driver runs on the CUDA card and raises on a host without one;
``--cpu`` runs it on the CPU (the kernels' plain versions). ``--quick``
gives small budgets (30 + 30 transitions, one chain, trees to depth 4)
unless a budget is given explicitly. ``--sampler`` picks NUTS or ChEES
for the density drivers (:func:`run_sampler` dispatches on the config
type). The drivers print their tables; the four with diagnostic plots
(``hmm_main``, ``iohmm_main``, ``hassan_main``, ``tayal_main``) also
take ``--plots-dir DIR`` and write their PNGs there
(``hhmm_tpu_torch.viz``). ``--plots-dir`` needs matplotlib: on a host
without it (the card's machine has none) the driver raises before it
fits anything, and never quietly draws nothing. A driver writes a file
only where its ``--out`` or ``--plots-dir`` asks.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# run from anywhere: the repo root precedes the examples dir on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

QUICK = {"warmup": 30, "samples": 30, "chains": 1, "max_treedepth": 4}
FULL = {"warmup": 300, "samples": 300, "chains": 2, "max_treedepth": 6}


def standard_parser(description: str, plots: bool = False) -> argparse.ArgumentParser:
    """The drivers' shared options; ``plots`` adds ``--plots-dir`` (the
    drivers that draw)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--warmup", type=int, default=None, help="default 300 (--quick: 30)")
    ap.add_argument("--samples", type=int, default=None, help="default 300 (--quick: 30)")
    ap.add_argument("--chains", type=int, default=None, help="default 2 (--quick: 1)")
    ap.add_argument("--max-treedepth", type=int, default=None, help="default 6 (--quick: 4)")
    ap.add_argument(
        "--sampler",
        choices=["nuts", "chees"],
        default="nuts",
        help="nuts (default; Stan semantics) or chees — cross-chain "
        "adaptive HMC (hhmm_tpu_torch/infer/chees.py), needs chains >= 2",
    )
    ap.add_argument("--max-leapfrogs", type=int, default=32, help="ChEES leapfrog cap")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); default the CUDA card")
    ap.add_argument("--quick", action="store_true", help="small budgets for smoke runs")
    if plots:
        ap.add_argument(
            "--plots-dir",
            default=None,
            help="write diagnostic PNGs here (needs matplotlib; default: no plots)",
        )
    return ap


def configure(args):
    """Check that ``--plots-dir`` can draw (matplotlib, the Agg backend;
    ``ModuleNotFoundError`` without it), resolve the budgets (explicit
    values, else ``--quick``'s, else the full ones), set ``args.device`` (``"cpu"`` with ``--cpu``, else None:
    the card) and return a SamplerConfig or ChEESConfig (per
    ``--sampler``; ``fit_batched`` and :func:`run_sampler` dispatch on
    the type)."""
    from hhmm_tpu_torch.infer import ChEESConfig, SamplerConfig

    if getattr(args, "plots_dir", None):
        # fail before the fit, not after it: no matplotlib means no plots
        import matplotlib

        matplotlib.use("Agg")
    base = QUICK if args.quick else FULL
    for k, v in base.items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    args.device = "cpu" if args.cpu else None
    if getattr(args, "sampler", "nuts") == "chees":
        return ChEESConfig(
            num_warmup=args.warmup,
            num_samples=args.samples,
            num_chains=max(2, args.chains),  # cross-chain adaptation
            max_leapfrogs=args.max_leapfrogs,
        )
    return SamplerConfig(
        num_warmup=args.warmup,
        num_samples=args.samples,
        num_chains=args.chains,
        max_treedepth=args.max_treedepth,
    )


def run_sampler(logp_fn, init_q, config, seed, device, vg_fn=None):
    """:func:`hhmm_tpu_torch.infer.sample` (config-type dispatch)."""
    from hhmm_tpu_torch.infer import sample

    return sample(logp_fn, init_q, config, seed=seed, device=device, vg_fn=vg_fn)


def host(x) -> np.ndarray:
    """A tensor (or anything array-like) as a host array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def print_summary(samples: dict, top: int = 12) -> None:
    """The drivers' `summary(stan.fit)` table."""
    from hhmm_tpu_torch.infer import summary

    table = summary({k: host(v) for k, v in samples.items()})
    print(f"{'param':<18}{'mean':>9}{'sd':>9}{'2.5%':>9}{'50%':>9}{'97.5%':>9}{'n_eff':>8}{'Rhat':>7}")
    shown = 0
    for name, st in table.items():
        means = np.atleast_1d(st["mean"])
        for i in range(means.shape[0]):
            if shown >= top:
                print(f"... ({sum(np.atleast_1d(s['mean']).size for s in table.values())} scalars total)")
                return
            label = name if means.shape[0] == 1 else f"{name}[{i}]"
            print(
                f"{label:<18}"
                f"{np.atleast_1d(st['mean'])[i]:>9.3f}{np.atleast_1d(st['sd'])[i]:>9.3f}"
                f"{np.atleast_1d(st['q2.5'])[i]:>9.3f}{np.atleast_1d(st['q50'])[i]:>9.3f}"
                f"{np.atleast_1d(st['q97.5'])[i]:>9.3f}"
                f"{np.atleast_1d(st['n_eff'])[i]:>8.0f}{np.atleast_1d(st['rhat'])[i]:>7.3f}"
            )
            shown += 1


def save_figure(fig, plots_dir: str | None, name: str) -> None:
    """Write ``fig`` to ``plots_dir/name`` (a PNG) and close it."""
    if plots_dir is None:
        return
    import matplotlib.pyplot as plt

    os.makedirs(plots_dir, exist_ok=True)
    path = os.path.join(plots_dir, name)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {path}")
