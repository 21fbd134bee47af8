"""CLI for the port's static analyzer (counterpart of
``python -m hhmm_tpu.analysis``).

Usage::

    python -m hhmm_tpu_torch.analysis [paths...] [--root DIR]
                                      [--format text|json] [--rules a,b,c]
                                      [--allowlist FILE | --no-allowlist]
                                      [--baseline FILE [--update-baseline]]
                                      [--list-rules]

Paths default to the port's scan set (hhmm_tpu_torch/, lint_torch.py,
obs_report_torch.py). Exit codes: 0 = no unsuppressed error-severity
findings (warnings report but do not fail), 1 = findings OR a ratchet
regression, 2 = usage/config error (unknown rule, malformed
allowlist/baseline). ``lint_torch.py`` wraps this entry point for
pre-commit use.

The findings ratchet (``--baseline FILE``) holds per-(rule, file)
finding counts to a checked-in baseline: they may only SHRINK. A new
finding fails the run even at warning severity; a fixed finding reports
the baseline as stale — tighten it with ``--update-baseline``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
from typing import List

from .engine import (
    AllowlistError,
    DEFAULT_TARGETS,
    RULES,
    baseline_from_report,
    diff_baseline,
    load_baseline,
    run_analysis,
)


def _write_baseline(path: pathlib.Path, doc) -> None:
    """Temp+replace write. The analysis package imports only the stdlib
    and cannot import `obs.trace.atomic_write_text`; this mirrors its
    discipline locally (same-directory temp, atomic rename)."""
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:  # lint: ok atomic-write -- layering forbids the obs import; local temp+replace mirrors trace.atomic_write_text
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hhmm_tpu_torch.analysis",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help=f"files/dirs to scan (default: {', '.join(DEFAULT_TARGETS)})",
    )
    ap.add_argument(
        "--root",
        default=".",
        help="repo root paths are resolved against (default: cwd)",
    )
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument(
        "--rules",
        default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    ap.add_argument(
        "--allowlist",
        default=None,
        help="allowlist file (default: <root>/hhmm_tpu_torch/analysis/allowlist.txt)",
    )
    ap.add_argument(
        "--no-allowlist",
        action="store_true",
        help="ignore the checked-in allowlist (audit mode)",
    )
    ap.add_argument(
        "--baseline",
        default=None,
        metavar="FILE",
        help="findings-ratchet baseline: per-(rule, file) counts may "
        "only shrink; growth fails even at warning severity",
    )
    ap.add_argument(
        "--update-baseline",
        action="store_true",
        help="rewrite --baseline from this scan's findings and exit 0 "
        "(requires --baseline)",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog and exit"
    )
    args = ap.parse_args(argv[1:])
    if args.update_baseline and not args.baseline:
        print(
            "hhmm_tpu_torch.analysis: --update-baseline requires --baseline",
            file=sys.stderr,
        )
        return 2

    if args.list_rules:
        for rid, rule in RULES.items():
            print(f"{rid:20s} {rule.severity:8s} {rule.title}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    try:
        report = run_analysis(
            root=pathlib.Path(args.root),
            paths=args.paths or None,
            rules=rules,
            allowlist_path=(
                pathlib.Path(args.allowlist) if args.allowlist else None
            ),
            use_allowlist=not args.no_allowlist,
        )
    except (AllowlistError, KeyError) as e:
        print(f"hhmm_tpu_torch.analysis: {e}", file=sys.stderr)
        return 2

    ratchet_failed = False
    ratchet_lines: List[str] = []
    if args.baseline:
        bpath = pathlib.Path(args.baseline)
        if not bpath.is_absolute():
            bpath = pathlib.Path(args.root) / bpath
        if args.update_baseline:
            _write_baseline(bpath, baseline_from_report(report))
            ratchet_lines.append(f"ratchet: baseline updated ({bpath})")
        else:
            try:
                baseline = load_baseline(bpath)
            except AllowlistError as e:
                print(f"hhmm_tpu_torch.analysis: {e}", file=sys.stderr)
                return 2
            grown, shrunk = diff_baseline(report, baseline)
            if grown:
                ratchet_failed = True
                ratchet_lines.append(
                    f"ratchet: {len(grown)} NEW finding group(s) vs baseline "
                    f"{bpath.name} — fix them (preferred) or re-baseline "
                    "deliberately with --update-baseline:"
                )
                ratchet_lines.extend(f"  {g}" for g in grown)
            if shrunk:
                ratchet_lines.append(
                    f"ratchet: {len(shrunk)} finding group(s) improved on the "
                    "baseline — tighten it with --update-baseline:"
                )
                ratchet_lines.extend(f"  {s}" for s in shrunk)
            if not grown and not shrunk:
                ratchet_lines.append("ratchet: findings match the baseline")

    if args.format == "json":
        doc = report.to_json()
        if args.baseline:
            doc["ratchet"] = {
                "baseline": str(args.baseline),
                "failed": ratchet_failed,
                "lines": ratchet_lines,
            }
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        print(report.render_text())
        for line in ratchet_lines:
            print(line)
    return 0 if report.ok and not ratchet_failed else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
