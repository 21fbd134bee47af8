"""Rule engine for the `hhmm_tpu_torch.analysis` static analyzer
(counterpart of ``hhmm_tpu/analysis/engine.py``, the same engine).

Pure stdlib (``ast`` + ``re``) — importing this package pulls in
neither torch nor numpy (asserted by ``tests/test_torch_analysis.py``):
the analyzer runs on hosts without the port's stack, on the card's
host beside a run, and inside tier-1 under a <10 s budget.

Pieces:

- :class:`Finding` — one defect: ``(file, line, rule_id, severity,
  message)``. ``line == 0`` means module-level (no single line).
- :class:`Rule` — subclass, set ``id``/``title``/``severity``/``doc``,
  implement :meth:`Rule.check` over a :class:`Project`; decorate with
  :func:`register` to add it to the global registry. Rules scope
  themselves by repo-relative path (see :meth:`Project.iter_modules`).
- :class:`Module` / :class:`Project` — parsed source files keyed by
  repo-relative path, with on-demand loading for rules that pin
  specific files (the legacy guard invariants).
- suppression — inline ``# lint: ok <rule-id>`` pragmas (same line or
  the line directly above; multiple ids comma/space-separated; an
  optional ``-- rationale`` tail is encouraged) plus a checked-in
  allowlist file (:func:`load_allowlist`) for module-level findings
  and sites where an inline comment cannot live.
- :func:`run_analysis` — collect files, run rules, apply suppression,
  return a :class:`Report` with text and JSON renderers.
"""

from __future__ import annotations

import ast
import json
import pathlib
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

__all__ = [
    "AllowlistEntry",
    "AllowlistError",
    "BASELINE_VERSION",
    "DEFAULT_TARGETS",
    "Finding",
    "Module",
    "Project",
    "Report",
    "Rule",
    "RULES",
    "baseline_from_report",
    "diff_baseline",
    "load_allowlist",
    "load_baseline",
    "register",
    "run_analysis",
]

# default scan set relative to the repo root: the package plus its root
# tools. The harnesses that hold kernels directly (chip_smoke.py,
# bench_kernel_pair.py) stay out, as the JAX package's examples do.
DEFAULT_TARGETS: Tuple[str, ...] = (
    "hhmm_tpu_torch",
    "lint_torch.py",
    "obs_report_torch.py",
)

# `# lint: ok rule-a, rule-b -- why this is fine`
_PRAGMA_RE = re.compile(
    r"#\s*lint:\s*ok\s+(?P<ids>[A-Za-z0-9_,\s-]+?)\s*(?:--(?P<why>.*))?$"
)


@dataclass(frozen=True)
class Finding:
    """One defect at one location. ``line == 0`` = module-level."""

    file: str
    line: int
    rule_id: str
    message: str
    severity: str = "error"

    def location(self) -> str:
        return f"{self.file}:{self.line}" if self.line else self.file

    def format(self) -> str:
        return f"{self.location()}: [{self.rule_id}] {self.message}"

    def to_json(self) -> Dict[str, object]:
        return {
            "file": self.file,
            "line": self.line,
            "rule_id": self.rule_id,
            "severity": self.severity,
            "message": self.message,
        }


class Module:
    """One parsed source file: tree, source lines, suppression pragmas."""

    def __init__(self, rel: str, path: pathlib.Path, source: str):
        self.rel = rel.replace("\\", "/")
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        self.pragmas = _parse_pragmas(source)
        # statement-anchor map, built LAZILY on the first suppression
        # probe of a pragma-carrying module — eagerly walking every
        # tree cost more than the whole concurrency pass (profiled
        # ~1.3 s/scan across 113 files, ~5 of which carry pragmas)
        self._stmt_first: Optional[Dict[int, int]] = None

    def suppressed(self, rule_id: str, line: int) -> bool:
        """True when the finding's line carries a ``# lint: ok`` pragma
        naming ``rule_id`` — on the line itself, the line directly
        above, or (for a finding anchored to a CONTINUATION line of a
        multi-line statement) the statement's first line or the line
        above that. Without the statement anchor, a pragma written
        where humans write it (on the statement) silently fails to
        suppress a finding whose AST node starts lines later."""
        if not self.pragmas:
            return False
        for ln in (line, line - 1):
            if rule_id in self.pragmas.get(ln, ()):
                return True
        if self._stmt_first is None:
            self._stmt_first = _statement_first_lines(self.tree)
        first = self._stmt_first.get(line)
        if first is None or first == line:
            return False
        for ln in (first, first - 1):
            if rule_id in self.pragmas.get(ln, ()):
                return True
        return False


def _statement_first_lines(tree: ast.AST) -> Dict[int, int]:
    """line → first line of the INNERMOST statement covering it, for
    every line inside a multi-line statement. ``ast.walk`` is BFS —
    parents before children — so later (inner) statements overwrite
    outer ones and the innermost anchor wins."""
    out: Dict[int, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt):
            continue
        end = getattr(node, "end_lineno", None) or node.lineno
        # single-line statements map to themselves so an enclosing
        # compound statement (a whole function body is one multi-line
        # stmt) can never hijack their anchor — a pragma on a `def`
        # line must not suppress findings across the body
        for ln in range(node.lineno, end + 1):
            out[ln] = node.lineno
    return out


def _parse_pragmas(source: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, raw in enumerate(source.splitlines(), 1):
        m = _PRAGMA_RE.search(raw)
        if m is None:
            continue
        ids = {t for t in re.split(r"[,\s]+", m.group("ids").strip()) if t}
        if ids:
            out[i] = ids
    return out


class Project:
    """The scanned file set plus on-demand access to pinned files.

    ``modules`` holds everything collected from the CLI paths; rules
    that must inspect a FIXED file (the sampler-guard family) use
    :meth:`module` which falls back to parsing from disk, so their
    verdict does not depend on which paths the caller selected.
    """

    def __init__(self, root: pathlib.Path, modules: Dict[str, Module]):
        self.root = pathlib.Path(root)
        self.modules = modules
        self._extra: Dict[str, Optional[Module]] = {}
        # structured side-channel for rules that compute a whole-project
        # artifact beyond findings (the lock-order DAG) — copied into
        # Report.extras / the JSON report under "extras"
        self.extras: Dict[str, object] = {}
        # per-project analysis caches keyed by rule family (the
        # concurrency rules share one package-wide index)
        self.caches: Dict[str, object] = {}

    def iter_modules(self) -> Iterator[Module]:
        for rel in sorted(self.modules):
            yield self.modules[rel]

    def module(self, rel: str) -> Optional[Module]:
        """The module at repo-relative ``rel`` — scanned, cached, or
        parsed from disk on demand; ``None`` when the file is absent."""
        rel = rel.replace("\\", "/")
        if rel in self.modules:
            return self.modules[rel]
        if rel not in self._extra:
            path = self.root / rel
            if path.is_file():
                self._extra[rel] = Module(rel, path, path.read_text())
            else:
                self._extra[rel] = None
        return self._extra[rel]


class Rule:
    """One invariant. Subclass, set the class attributes, implement
    :meth:`check`, and decorate with :func:`register`.

    - ``id``       — kebab-case pragma/allowlist key (``# lint: ok <id>``)
    - ``severity`` — ``"error"`` (drives exit code) or ``"warning"``
    - ``title``    — one-line summary for ``--list-rules``
    - ``doc``      — catalog paragraph (``--list-rules`` prints the
      titles; the docs live here)
    - ``family``   — rule-group key for per-family report counts;
      defaults to the defining module's basename (``legacy``,
      ``purity``, ``prng``, ``dtype``, ``layering``, ``concurrency``)
    """

    id: str = ""
    severity: str = "error"
    title: str = ""
    doc: str = ""
    family: str = ""

    def check(self, project: Project) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, file: str, line: int, message: str) -> Finding:
        return Finding(file, line, self.id, message, self.severity)


RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator adding a Rule to the global registry (import
    order = deterministic run order)."""
    if not cls.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if cls.id in RULES:
        raise ValueError(f"duplicate rule id {cls.id!r}")
    if not cls.family:
        cls.family = cls.__module__.rsplit(".", 1)[-1]
    RULES[cls.id] = cls()
    return cls


# ---------------------------------------------------------------------------
# allowlist


class AllowlistError(ValueError):
    """Malformed allowlist file — CLI exits 2, never silently ignores."""


@dataclass
class AllowlistEntry:
    rule_id: str
    file: str
    line: Optional[int]  # None = any line in the file
    rationale: str
    used: bool = field(default=False, compare=False)

    def matches(self, f: Finding) -> bool:
        return (
            f.rule_id == self.rule_id
            and f.file == self.file
            and (self.line is None or self.line == f.line)
        )


def load_allowlist(path: pathlib.Path) -> List[AllowlistEntry]:
    """Parse the checked-in allowlist: one ``<rule-id> <path>[:<line>]
    -- <rationale>`` entry per line, ``#`` comments and blanks ignored.
    The rationale is REQUIRED — an allowlist entry without a why is a
    suppression nobody can audit."""
    entries: List[AllowlistEntry] = []
    for n, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if "--" not in line:
            raise AllowlistError(
                f"{path}:{n}: allowlist entry has no ` -- rationale` tail"
            )
        head, rationale = line.split("--", 1)
        parts = head.split()
        if len(parts) != 2:
            raise AllowlistError(
                f"{path}:{n}: expected `<rule-id> <path>[:<line>] -- why`, "
                f"got {line!r}"
            )
        rule_id, target = parts
        lineno: Optional[int] = None
        if ":" in target:
            target, _, tail = target.rpartition(":")
            try:
                lineno = int(tail)
            except ValueError as e:
                raise AllowlistError(f"{path}:{n}: bad line number {tail!r}") from e
        if not rationale.strip():
            raise AllowlistError(f"{path}:{n}: empty rationale")
        entries.append(
            AllowlistEntry(rule_id, target.replace("\\", "/"), lineno, rationale.strip())
        )
    return entries


# ---------------------------------------------------------------------------
# runner + report

# the package-shipped allowlist, looked up root-relative so toy trees
# (tests) get none unless they check one in
ALLOWLIST_REL = "hhmm_tpu_torch/analysis/allowlist.txt"

_EXCLUDE_DIRS = {"__pycache__"}


def _collect(root: pathlib.Path, paths: Sequence[str]) -> Dict[str, pathlib.Path]:
    files: Dict[str, pathlib.Path] = {}

    def add(p: pathlib.Path) -> None:
        try:
            rel = str(p.resolve().relative_to(root.resolve())).replace("\\", "/")
        except ValueError:
            rel = str(p).replace("\\", "/")
        files[rel] = p

    for target in paths:
        p = pathlib.Path(target)
        if not p.is_absolute():
            p = root / target
        if p.is_dir():
            for py in sorted(p.rglob("*.py")):
                if not _EXCLUDE_DIRS.intersection(py.parts):
                    add(py)
        elif p.is_file():
            add(p)
    return files


@dataclass
class Report:
    root: str
    files_scanned: int
    findings: List[Finding]  # unsuppressed, sorted
    suppressed: List[Finding]  # pragma- or allowlist-suppressed
    allowlist: List[AllowlistEntry]
    rules_run: List[str]
    extras: Dict[str, object] = field(default_factory=dict)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def rule_table(self) -> Dict[str, Dict[str, object]]:
        def fresh(rid: str, severity: str) -> Dict[str, object]:
            rule = RULES.get(rid)
            return {
                "severity": rule.severity if rule else severity,
                "family": rule.family if rule else "unknown",
                "findings": 0,
                "suppressed": 0,
            }

        table: Dict[str, Dict[str, object]] = {}
        for rid in self.rules_run:
            table[rid] = fresh(rid, "error")
        for f in self.findings:
            table.setdefault(f.rule_id, fresh(f.rule_id, f.severity))["findings"] += 1
        for f in self.suppressed:
            table.setdefault(f.rule_id, fresh(f.rule_id, f.severity))[
                "suppressed"
            ] += 1
        return table

    def to_json(self) -> Dict[str, object]:
        return {
            "version": 1,
            "root": self.root,
            "files_scanned": self.files_scanned,
            "rules": self.rule_table(),
            "findings": [f.to_json() for f in self.findings],
            "suppressed_count": len(self.suppressed),
            "allowlist_entries": len(self.allowlist),
            "allowlist_unused": [
                f"{e.rule_id} {e.file}" for e in self.allowlist if not e.used
            ],
            "extras": self.extras,
            "ok": self.ok,
        }

    def render_text(self) -> str:
        lines = [f.format() for f in self.findings]
        n_err = len(self.errors)
        n_warn = len(self.findings) - n_err
        tail = (
            f"hhmm_tpu_torch.analysis: {self.files_scanned} file(s), "
            f"{len(self.rules_run)} rule(s): "
        )
        if self.findings:
            tail += f"{n_err} error(s), {n_warn} warning(s)"
        else:
            tail += "clean"
        if self.suppressed:
            tail += f" ({len(self.suppressed)} suppressed)"
        unused = [e for e in self.allowlist if not e.used]
        if unused:
            tail += f" [{len(unused)} unused allowlist entr(y/ies)]"
        lines.append(tail)
        return "\n".join(lines)


def run_analysis(
    root,
    paths: Optional[Sequence[str]] = None,
    rules: Optional[Sequence[str]] = None,
    allowlist_path: Optional[pathlib.Path] = None,
    use_allowlist: bool = True,
) -> Report:
    """Collect files under ``root``, run ``rules`` (default: all
    registered), apply pragma + allowlist suppression, return a
    :class:`Report`. Unparseable files become ``parse-error`` findings
    rather than crashing the run."""
    root = pathlib.Path(root)
    if paths is None:
        paths = [t for t in DEFAULT_TARGETS if (root / t).exists()]
    files = _collect(root, paths)
    modules: Dict[str, Module] = {}
    parse_failures: List[Finding] = []
    for rel, path in files.items():
        try:
            modules[rel] = Module(rel, path, path.read_text())
        except SyntaxError as e:
            parse_failures.append(
                Finding(rel, e.lineno or 0, "parse-error", f"syntax error: {e.msg}")
            )
    project = Project(root, modules)

    if rules is None:
        selected = list(RULES)
    else:
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            raise KeyError(f"unknown rule id(s): {unknown}")
        selected = list(rules)

    entries: List[AllowlistEntry] = []
    if use_allowlist:
        ap = allowlist_path if allowlist_path is not None else root / ALLOWLIST_REL
        if pathlib.Path(ap).is_file():
            entries = load_allowlist(pathlib.Path(ap))

    raw: List[Finding] = list(parse_failures)
    for rid in selected:
        raw.extend(RULES[rid].check(project))
    extras = dict(project.extras)
    # dedupe (a rule walking overlapping scopes may re-derive a site)
    raw = sorted(set(raw), key=lambda f: (f.file, f.line, f.rule_id, f.message))

    findings: List[Finding] = []
    suppressed: List[Finding] = []
    for f in raw:
        mod = modules.get(f.file)
        if mod is not None and f.line and mod.suppressed(f.rule_id, f.line):
            suppressed.append(f)
            continue
        hit = next((e for e in entries if e.matches(f)), None)
        if hit is not None:
            hit.used = True
            suppressed.append(f)
            continue
        findings.append(f)
    return Report(
        root=str(root),
        files_scanned=len(files),
        findings=findings,
        suppressed=suppressed,
        allowlist=entries,
        rules_run=selected,
        extras=extras,
    )


# ---------------------------------------------------------------------------
# findings ratchet (a benchmark-diff discipline applied to lint):
# a checked-in baseline records the accepted finding counts per
# (rule, file); a scan may only ever SHRINK them. New findings fail,
# fixed findings invite a baseline update — warnings can't silently
# re-accumulate between PRs.

BASELINE_VERSION = 1


def baseline_from_report(report: Report) -> Dict[str, object]:
    """JSON-ready baseline doc: per ``<rule-id> <file>`` unsuppressed
    finding counts (warnings included — errors fail the scan anyway,
    but a baseline taken mid-cleanup must round-trip)."""
    counts: Dict[str, int] = {}
    for f in report.findings:
        key = f"{f.rule_id} {f.file}"
        counts[key] = counts.get(key, 0) + 1
    return {
        "version": BASELINE_VERSION,
        "counts": {k: counts[k] for k in sorted(counts)},
    }


def load_baseline(path: pathlib.Path) -> Dict[str, int]:
    """The baseline's ``{key: count}`` table. Missing file → empty
    (first run ratchets against zero); malformed → AllowlistError-class
    config failure (exit 2 — a torn baseline must not fail open)."""
    p = pathlib.Path(path)
    if not p.is_file():
        return {}
    try:
        doc = json.loads(p.read_text())
        counts = doc["counts"]
        return {str(k): int(v) for k, v in counts.items()}
    except (ValueError, KeyError, TypeError) as e:
        raise AllowlistError(f"{path}: malformed findings baseline ({e})") from e


def diff_baseline(
    report: Report, baseline: Dict[str, int]
) -> Tuple[List[str], List[str]]:
    """``(grown, shrunk)`` — human-readable lines for keys whose count
    exceeds the baseline (ratchet FAILURE) and keys the scan improved
    on (the baseline is stale; tighten it)."""
    current = baseline_from_report(report)["counts"]
    grown: List[str] = []
    shrunk: List[str] = []
    for key in sorted(set(current) | set(baseline)):
        now = current.get(key, 0)  # type: ignore[union-attr]
        then = baseline.get(key, 0)
        if now > then:
            grown.append(f"{key}: {then} -> {now}")
        elif now < then:
            shrunk.append(f"{key}: {then} -> {now}")
    return grown, shrunk
