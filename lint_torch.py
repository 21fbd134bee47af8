#!/usr/bin/env python
"""Pre-commit lint entry point for the port — `hhmm_tpu_torch.analysis`
over its full default scan set (counterpart of ``scripts/lint.py``).

Exactly `python -m hhmm_tpu_torch.analysis` with the repo root pinned (so
it works from any cwd and from a `.git/hooks/pre-commit` one-liner),
plus `--changed` to scan only files the working tree touches::

    python lint_torch.py                 # full scan, text report
    python lint_torch.py --changed       # staged+unstaged .py files only
    python lint_torch.py --format json   # machine-readable

Exit codes are the analyzer's: 0 clean, 1 findings, 2 config error.
Pure `ast` — no torch import, safe on any host.

`--changed` reads `git diff --name-status HEAD` (staged + unstaged in
one view) plus untracked files, so renames contribute their NEW path
and deletions contribute nothing — a renamed or deleted file must
never reach the engine as a dead path. `--repo DIR` overrides the
repo root.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
from typing import List

_REPO = pathlib.Path(__file__).resolve().parent
if str(_REPO) not in sys.path:
    sys.path.insert(0, str(_REPO))

from hhmm_tpu_torch.analysis.__main__ import main as analysis_main  # noqa: E402


def _changed_py_files(repo: pathlib.Path) -> List[str]:
    """Tracked .py files the working tree modifies relative to HEAD
    (staged + unstaged) plus untracked ones — the pre-commit scan set.

    `git diff --name-status HEAD` one-lines each change as
    `<status>\\t<path>` — or `R<score>\\t<old>\\t<new>` for renames and
    `C<score>\\t<src>\\t<dst>` for copies, where only the LAST path
    exists in the working tree. `D` (deleted) entries are dropped
    entirely; anything that no longer exists on disk (e.g. deleted
    after staging) is dropped too."""
    files: List[str] = []

    def add(path: str) -> None:
        path = path.strip().strip('"')
        if path.endswith(".py") and (repo / path).is_file():
            files.append(path)

    diff = subprocess.run(
        ["git", "-C", str(repo), "diff", "--name-status", "HEAD"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout
    for line in diff.splitlines():
        parts = line.split("\t")
        if len(parts) < 2:
            continue
        status = parts[0]
        if status.startswith("D"):
            continue  # deleted: no working-tree path to scan
        # renames/copies carry (old, new): the new path is the live one
        add(parts[-1])

    untracked = subprocess.run(
        ["git", "-C", str(repo), "ls-files", "--others", "--exclude-standard"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout
    for line in untracked.splitlines():
        add(line)
    return sorted(set(files))


def main(argv: List[str]) -> int:
    args = list(argv[1:])
    repo = _REPO
    if "--repo" in args:
        i = args.index("--repo")
        repo = pathlib.Path(args[i + 1]).resolve()
        del args[i : i + 2]
    if "--changed" in args:
        args.remove("--changed")
        changed = _changed_py_files(repo)
        if not changed:
            print("lint: no changed .py files")
            return 0
        args.extend(changed)
    return analysis_main(["lint", "--root", str(repo), *args])


if __name__ == "__main__":
    sys.exit(main(sys.argv))
