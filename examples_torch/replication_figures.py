"""Figures from the committed real-data replication artifacts (the
port's ``examples/replication_figures.py``).

Reads ``results/tayal_replication.json`` (no card needed) and renders,
under the ``--out`` directory its caller names and nowhere else:

- ``figures/tayal_phi_posterior.png`` — the G.TO 4x9 emission
  posterior (mean ± sd per state) with the published spot-checks
  marked, the equivalent of the reference's per-state parameter panels
  (`tayal2009/main.Rmd:540-558`);
- ``figures/tayal_wf_lags.png`` — mean daily return and hit rate per
  strategy (buy-and-hold + lags 0..5) over the 204-window backtest, the
  summary view of the reference's 1,428-return appendix table
  (`tayal2009/Rmd/appendix-wf.Rmd`);
- ``appendix-wf.md`` + ``figures/appendix_equity_<SYM>.png`` — the
  per-stock appendix layer (`tayal2009/Rmd/appendix-wf.Rmd`, main.pdf
  §5.2): per-day compound-return tables and equity lines for all 12
  tickers, with the published per-stock Total row for comparison. The
  markdown is the text the JAX driver writes into ``docs/``.

Run: ``python examples_torch/replication_figures.py --out DIR`` (needs
matplotlib).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "results", "tayal_replication.json")

# the trading days of the published G.TO Table 5 (`tayal2009/main.pdf`),
# one a walk-forward window: a full calendar's window w trades day w
PUBLISHED_T5_DAYS = [
    "2007-05-08", "2007-05-09", "2007-05-10", "2007-05-11", "2007-05-14",
    "2007-05-15", "2007-05-16", "2007-05-17", "2007-05-18", "2007-05-22",
    "2007-05-23", "2007-05-24", "2007-05-25", "2007-05-28", "2007-05-29",
    "2007-05-30", "2007-05-31",
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="directory to write into (figures/ and appendix-wf.md under it)")
    ap.add_argument("--results", default=RESULTS,
                    help="the replication artifact (default: results/tayal_replication.json)")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(args.results) as f:
        rep = json.load(f)
    fig_dir = os.path.join(args.out, "figures")
    os.makedirs(fig_dir, exist_ok=True)

    # --- emission posterior panels ---
    single = rep["single"]
    mean = np.asarray(single["phi_mean"])  # [4, 9]
    sd = np.asarray(single["phi_sd"])
    titles = [
        "state 1 (bear, down legs)",
        "state 2 (bear, up legs)",
        "state 3 (bull, up legs)",
        "state 4 (bull, down legs)",
    ]
    fig, axes = plt.subplots(1, 4, figsize=(13, 3.2), sharey=True)
    for k, ax in enumerate(axes):
        ax.bar(np.arange(1, 10), mean[k], yerr=sd[k], color="#4878b0", capsize=2)
        ax.set_title(titles[k], fontsize=9)
        ax.set_xlabel("symbol")
        ax.set_xticks(range(1, 10))
    axes[0].set_ylabel("posterior probability")
    axes[0].set_ylim(0, 1.0)
    # published spot checks (main.Rmd:560): phi_45 on panel 4, phi_25 on 2
    axes[3].axhline(0.88, ls="--", color="#b04848", lw=1)
    axes[3].annotate("published 0.88", (0.6, 0.92), fontsize=8, color="#b04848")
    axes[1].axhline(0.80, ls="--", color="#b04848", lw=1)
    axes[1].annotate("published 0.80", (0.6, 0.84), fontsize=8, color="#b04848")
    fam = single["replicated"].get("mode_family")
    fam_note = (
        f"; chain-level mode family phi_45 = {fam['phi_45_mean']:.2f} ± "
        f"{fam['phi_45_sd']:.2f} (q90 {fam['phi_45_q10_q90'][1]:.2f}) — "
        "the published value is ONE Stan chain from this family"
        if fam
        else ""
    )
    fig.suptitle(
        "G.TO emission posterior (real TSX ticks, Rmd window) — "
        f"dominant-basin pool phi_45 = {single['replicated']['phi_45']:.3f}, "
        f"phi_25 = {single['replicated']['phi_25']:.3f}{fam_note}",
        fontsize=9,
    )
    fig.tight_layout()
    path = os.path.join(fig_dir, "tayal_phi_posterior.png")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print("wrote", path)

    # --- walk-forward strategy summary ---
    agg = rep["wf"]["aggregate"]
    names = ["bnh"] + [f"lag{i}" for i in range(6)]
    means = [agg[n]["mean_daily_pct"] for n in names]
    hits = [agg[n]["hit_rate"] for n in names]
    fig, ax1 = plt.subplots(figsize=(7, 3.6))
    xs = np.arange(len(names))
    ax1.bar(xs, means, color=["#777777"] + ["#4878b0"] * 6)
    ax1.set_xticks(xs)
    ax1.set_xticklabels(["buy&hold"] + [f"lag {i}" for i in range(6)])
    ax1.set_ylabel("mean daily return (%)")
    ax1.axhline(0, color="black", lw=0.8)
    ax2 = ax1.twinx()
    ax2.plot(xs, hits, "o-", color="#b04848", ms=4)
    ax2.set_ylabel("hit rate", color="#b04848")
    ax2.set_ylim(0, 1)
    n = rep["wf"]["config"]["n_tasks"]
    ax1.set_title(
        f"Walk-forward backtest, 12 TSX tickers x {n // 12} windows "
        f"({n} trading days; signal at a zig-zag extremum, so lag 0 fills "
        "at the locally worst price)",
        fontsize=9,
    )
    fig.tight_layout()
    path = os.path.join(fig_dir, "tayal_wf_lags.png")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print("wrote", path)

    appendix(rep, plt, args.out)
    return 0


def appendix(rep, plt, out: str) -> str:
    """Per-stock appendix (`tayal2009/Rmd/appendix-wf.Rmd`, main.pdf
    §5.2): one per-day return table + one equity-line figure per
    ticker, generated from the committed ``wf.per_window`` artifact.
    Writes ``out/appendix-wf.md`` (the same text the JAX driver writes)
    and ``out/figures/appendix_equity_<SYM>.png``; returns the text."""
    fig_dir = os.path.join(out, "figures")
    os.makedirs(fig_dir, exist_ok=True)
    wf = rep["wf"]
    rows = wf["per_window"]
    lags = sorted(
        int(k[3:-4]) for k in rows[0] if k.startswith("lag") and k.endswith("_pct")
        and "_sum" not in k and "_trades" not in k
    )
    names = ["bnh"] + [f"lag{lag}" for lag in lags]
    labels = ["buy&hold"] + [f"lag {lag}" for lag in lags]
    stock_pub = wf.get("stock_totals_vs_published", {})
    symbols = sorted({r["symbol"] for r in rows})

    md = [
        "# Appendix — per-stock walk-forward results",
        "",
        "Analog of the reference's `tayal2009/Rmd/appendix-wf.Rmd` "
        "(rendered as main.pdf §5.2): per-day compound returns (%) of "
        "buy-and-hold and the lag-0..5 top-state strategies, one table "
        "and equity line per ticker, from the committed "
        "`results/tayal_replication.json` `wf.per_window` record "
        f"({len(rows)} windows, {wf['config']['n_returns']} returns). "
        "`Total` compounds the daily returns; `Published total` is the "
        "reference's per-stock Total row (main.pdf Tables 9-20, as "
        "fractions). Generated by `examples/replication_figures.py`.",
        "",
    ]
    for sym in symbols:
        srows = sorted((r for r in rows if r["symbol"] == sym), key=lambda r: r["window"])
        full_cal = len(srows) == len(PUBLISHED_T5_DAYS)
        md += [f"## {sym}", ""]
        md.append("| day | " + " | ".join(labels) + " |")
        md.append("|---|" + "---|" * len(labels))
        series = {n: [] for n in names}
        for r in srows:
            day = PUBLISHED_T5_DAYS[r["window"]] if full_cal else f"w{r['window']}"
            vals = [r["bnh_pct"]] + [r[f"lag{lag}_pct"] for lag in lags]
            for n, v in zip(names, vals):
                series[n].append(v)
            md.append(
                f"| {day} | " + " | ".join(f"{v:.2f}" for v in vals) + " |"
            )
        totals = [
            float(np.prod(1 + np.array(series[n]) / 100) - 1) for n in names
        ]
        md.append(
            "| **Total %** | "
            + " | ".join(f"{v * 100:.1f}" for v in totals) + " |"
        )
        pub = stock_pub.get(sym, {}).get("published_total")
        if pub:  # published rows are fractions — render in % too
            md.append(
                "| **Published total %** | "
                + " | ".join(f"{v * 100:.1f}" for v in pub) + " |"
            )
        md += ["", f"![{sym} equity](figures/appendix_equity_{sym}.png)", ""]

        fig, ax = plt.subplots(figsize=(7, 3.2))
        xs = np.arange(len(srows) + 1)
        for n, lab in zip(names, labels):
            eq = np.concatenate([[1.0], np.cumprod(1 + np.array(series[n]) / 100)])
            kw = {"color": "#777777", "lw": 2} if n == "bnh" else {"lw": 1}
            ax.plot(xs, eq, label=lab, **kw)
        ax.set_title(f"{sym} — walk-forward equity (per-day compounding)", fontsize=9)
        ax.set_xlabel("trading day")
        ax.set_ylabel("equity (x initial)")
        ax.axhline(1.0, color="black", lw=0.6)
        ax.legend(fontsize=7, ncol=4)
        fig.tight_layout()
        path = os.path.join(fig_dir, f"appendix_equity_{sym}.png")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        print("wrote", path)

    text = "\n".join(md)
    apx = os.path.join(out, "appendix-wf.md")
    with open(apx, "w") as f:
        f.write(text)
    print("wrote", apx)
    return text


if __name__ == "__main__":
    sys.exit(main())
