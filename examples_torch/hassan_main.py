"""Hassan (2005) driver (the port's ``examples/hassan_main.py``) — the
reference's `hassan2005/main.R`: build the OHLC dataset, run the
warm-started walk-forward forecast, and report the out-of-sample error
table (MSE / MAPE / R²).

  python examples_torch/hassan_main.py                       # simulated OHLC
  python examples_torch/hassan_main.py --csv prices.csv      # your own data
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _common import configure, save_figure, standard_parser


def main() -> None:
    ap = standard_parser(__doc__, plots=True)
    ap.add_argument("--csv", default=None, help="OHLC CSV (open/high/low/close columns)")
    ap.add_argument("--T", type=int, default=160, help="simulated days when no --csv")
    ap.add_argument("--train-frac", type=float, default=0.75)
    ap.add_argument("--K", type=int, default=4)
    ap.add_argument("--L", type=int, default=3)
    args = ap.parse_args()
    cfg = configure(args)

    from hhmm_tpu_torch.apps.data_io import load_ohlc_csv
    from hhmm_tpu_torch.apps.hassan import simulate_ohlc, wf_forecast

    if args.csv:
        ohlc = load_ohlc_csv(args.csv)
    else:
        ohlc = simulate_ohlc(np.random.default_rng(args.seed), args.T)
    train_len = int(len(ohlc) * args.train_frac)
    print(f"{len(ohlc)} days, training on first {train_len}, "
          f"{len(ohlc) - train_len} walk-forward steps")

    res = wf_forecast(ohlc, train_len=train_len, K=args.K, L=args.L, config=cfg,
                      seed=args.seed, device=args.device)
    print(f"mean divergence rate: {float(np.mean(res.diverged)):.4f}")
    print("out-of-sample errors (the `hassan2005/main.Rmd:920-933` table):")
    for k, v in res.errors.items():
        print(f"  {k:>5}: {v:.5g}")

    if args.plots_dir:
        from hhmm_tpu_torch.viz.plots import plot_seqforecast

        bands = np.quantile(res.forecasts, [0.1, 0.5, 0.9], axis=1)  # [3, S]
        fig = plot_seqforecast(np.asarray(ohlc[:train_len, 3]), bands)
        save_figure(fig, args.plots_dir, "hassan_forecast.png")


if __name__ == "__main__":
    main()
