"""Tayal (2009) driver (the port's ``examples/tayal_main.py``) — the
reference's `tayal2009/main.R`: ticks → zig-zag features → lite-model
fit with an out-of-sample day → top-state labeling → per-regime
analytics → trading vs buy-and-hold.

  python examples_torch/tayal_main.py                    # simulated tick days
  python examples_torch/tayal_main.py --ticks-dir DIR    # per-day CSVs (see
                                                         # hhmm_tpu_torch.apps.data_io)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _common import configure, host, save_figure, standard_parser


def main() -> None:
    ap = standard_parser(__doc__, plots=True)
    ap.add_argument("--ticks-dir", default=None)
    ap.add_argument("--symbol", default=None, help="file-name filter for --ticks-dir")
    ap.add_argument("--train-days", type=int, default=5)
    ap.add_argument("--legs-per-day", type=int, default=300, help="simulation size")
    ap.add_argument("--lag", type=int, default=1)
    args = ap.parse_args()
    cfg = configure(args)

    from hhmm_tpu_torch.apps.tayal import run_window, simulate_ticks

    if args.ticks_dir:
        from hhmm_tpu_torch.apps.data_io import load_tick_days

        days = load_tick_days(args.ticks_dir, symbol=args.symbol)
    else:
        rng = np.random.default_rng(args.seed)
        days = []
        for _ in range(args.train_days + 1):
            price, size, tsec, _ = simulate_ticks(rng, n_legs=args.legs_per_day)
            days.append({"price": price, "size": size, "t_seconds": tsec})
    if len(days) < args.train_days + 1:
        raise SystemExit(f"need {args.train_days + 1} days, have {len(days)}")
    days = days[: args.train_days + 1]

    price = np.concatenate([d["price"] for d in days])
    size = np.concatenate([d["size"] for d in days])
    tsec = np.concatenate([d["t_seconds"] for d in days])
    ins_end = sum(len(d["price"]) for d in days[: args.train_days]) - 1
    print(f"{len(days)} days, {len(price)} ticks, in-sample through tick {ins_end}")

    res = run_window(price, size, tsec, ins_end, config=cfg, seed=args.seed,
                     lags=(args.lag,), device=args.device)
    div = float(host(res.stats["diverging"]).mean())
    print(f"divergence rate: {div:.4f}; "
          f"{res.n_ins_legs} in-sample legs, swapped={res.swapped}")
    print("per-regime summary over the full window (`topstate_summary`):")
    for label, stats in res.summary.items():
        row = ", ".join(f"{k}={v:.4g}" for k, v in stats.items())
        print(f"  {label}: {row}")
    tr = res.trades[args.lag]
    oos_price = price[ins_end + 1 :]
    print(f"out-of-sample trading (lag={args.lag}): {len(tr)} trades, "
          f"total {100 * np.sum(tr.ret):.3f}% vs buy&hold {100 * np.sum(res.bnh):.3f}%")

    if args.plots_dir:
        from hhmm_tpu_torch.apps.tayal.features import expand_to_ticks
        from hhmm_tpu_torch.viz.state_plots import plot_topstate_seq, plot_topstate_trading

        tick_top = expand_to_ticks(res.leg_topstate, res.zig, len(price))
        fig = plot_topstate_seq(oos_price, tick_top[ins_end + 1 :])
        save_figure(fig, args.plots_dir, "tayal_topstate_seq.png")
        fig = plot_topstate_trading(
            oos_price, tick_top[ins_end + 1 :], {f"lag {args.lag}": tr}
        )
        save_figure(fig, args.plots_dir, "tayal_trading.png")


if __name__ == "__main__":
    main()
