"""Batch backtest (the port's ``examples/tayal_strategy.py``) — the
reference's `tayal2009/test-strategy.R`: build rolling (train, trade)
windows across symbols, fit every window in one batched NUTS program,
trade each with several lags, and aggregate.

  python examples_torch/tayal_strategy.py                       # simulated
  python examples_torch/tayal_strategy.py --ticks-dir DIR       # DIR/<symbol>/<day>.csv
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _common import configure, standard_parser


def main() -> None:
    ap = standard_parser(__doc__)
    ap.add_argument("--ticks-dir", default=None,
                    help="directory of per-day CSVs; subdirectories = symbols")
    ap.add_argument("--symbols", type=int, default=3, help="simulated symbols")
    ap.add_argument("--days", type=int, default=7, help="simulated days per symbol")
    ap.add_argument("--train-days", type=int, default=5)
    ap.add_argument("--legs-per-day", type=int, default=200)
    ap.add_argument("--lags", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--cache-dir", default=None, help="fit cache (nothing cached without it)")
    args = ap.parse_args()
    cfg = configure(args)

    from hhmm_tpu_torch.apps.tayal import build_tasks, simulate_ticks, wf_trade

    if args.ticks_dir:
        from hhmm_tpu_torch.apps.data_io import load_tick_days

        days = {
            name: load_tick_days(os.path.join(args.ticks_dir, name))
            for name in sorted(os.listdir(args.ticks_dir))
            if os.path.isdir(os.path.join(args.ticks_dir, name))
        }
        if not days:
            raise SystemExit(
                f"{args.ticks_dir}: no per-symbol subdirectories found "
                "(this script expects DIR/<symbol>/<day>.csv; for a flat "
                "directory of day CSVs use examples_torch/tayal_main.py)"
            )
    else:
        days = {}
        for s in range(args.symbols):
            rng = np.random.default_rng(1000 * s + args.seed)
            sym_days = []
            for _ in range(args.days):
                price, size, tsec, _ = simulate_ticks(rng, n_legs=args.legs_per_day)
                sym_days.append({"price": price, "size": size, "t_seconds": tsec})
            days[f"SYM{s}"] = sym_days

    tasks = build_tasks(days, train_days=args.train_days, trade_days=1)
    print(f"{len(tasks)} (symbol, window) tasks")
    results = wf_trade(tasks, config=cfg, lags=args.lags, cache_dir=args.cache_dir,
                       seed=args.seed, device=args.device)

    # aggregate daily returns per strategy (`tayal2009/main.Rmd:800`)
    print(f"{'symbol':<8}{'window':>7}{'div':>7}" + "".join(f"{f'lag{l}':>9}" for l in args.lags) + f"{'b&h':>9}")
    totals = {lag: [] for lag in args.lags}
    bnh_all = []
    for r in results:
        day_ret = {lag: 100 * np.sum(r.trades[lag].ret) for lag in args.lags}
        bnh = 100 * np.sum(r.bnh)
        for lag in args.lags:
            totals[lag].append(day_ret[lag])
        bnh_all.append(bnh)
        print(
            f"{r.symbol:<8}{r.window:>7}{r.diverged:>7.3f}"
            + "".join(f"{day_ret[lag]:>9.3f}" for lag in args.lags)
            + f"{bnh:>9.3f}"
        )
    print("-" * (22 + 9 * (len(args.lags) + 1)))
    print(
        f"{'mean':<22}" + "".join(f"{np.mean(totals[lag]):>9.3f}" for lag in args.lags)
        + f"{np.mean(bnh_all):>9.3f}"
    )


if __name__ == "__main__":
    main()
