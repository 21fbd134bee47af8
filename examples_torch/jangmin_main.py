"""Jangmin (2004) driver (the port's ``examples/jangmin_main.py``) — the
replication the reference abandoned (`hhmm/sim-jangmin2004.R`),
completed: simulate the 5-regime market tree, derive MA-gradient
k-means labels from the price path, fit the 63-leaf hierarchy
semi-supervised, and report regime decode quality against the honest
baselines (majority class, true-parameter oracle).

  python examples_torch/jangmin_main.py --quick
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _common import configure, host, standard_parser


def main() -> None:
    ap = standard_parser(__doc__)
    ap.add_argument("--T", type=int, default=300)
    ap.add_argument("--true-labels", action="store_true",
                    help="supervise with the simulated truth instead of k-means")
    args = ap.parse_args()
    cfg = configure(args)

    from hhmm_tpu_torch.apps.jangmin import fit_market, ma_gradient_labels, simulate_market

    rng = np.random.default_rng(args.seed)
    m = simulate_market(args.T, rng)
    g = m["regime"] if args.true_labels else ma_gradient_labels(m["price"])
    agree = (g == m["regime"]).mean()
    print(f"T={args.T}; label-vs-truth agreement {agree:.3f} "
          f"({'truth' if args.true_labels else 'MA-gradient k-means'})")

    fit = fit_market(m["x"], g, config=cfg, seed=args.seed, regime_true=m["regime"],
                     device=args.device)
    div = float(host(fit.stats["diverging"]).mean())
    maj = np.bincount(m["regime"]).max() / len(m["regime"])
    print(f"divergence rate: {div:.4f}")
    print(f"unsupervised regime decode accuracy: {fit.accuracy:.3f} "
          f"(majority-class baseline {maj:.3f})")
    print("decoded regime counts:", np.bincount(host(fit.regime_hat), minlength=5))
    print("true regime counts:   ", np.bincount(m["regime"], minlength=5))


if __name__ == "__main__":
    main()
