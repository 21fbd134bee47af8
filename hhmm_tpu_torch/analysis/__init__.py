"""hhmm_tpu_torch.analysis — the port's static analyzer (pure ``ast``;
counterpart of ``hhmm_tpu.analysis``).

One rule engine, a registry of per-invariant rules with
ids/severities/docs, per-finding locations, inline ``# lint: ok
<rule-id> -- why`` pragmas, a checked-in allowlist
(``allowlist.txt``, each entry with its rationale), a findings ratchet,
and text/JSON reporters behind a CLI::

    python -m hhmm_tpu_torch.analysis                  # full default scan
    python -m hhmm_tpu_torch.analysis --format json hhmm_tpu_torch/
    python -m hhmm_tpu_torch.analysis --list-rules
    python lint_torch.py --changed                     # pre-commit scan

Six rule families: the guard invariants (:mod:`.legacy`, with
``kernel-build`` for the JAX package's ``jit-telemetry``), hot-path
purity from autograd functions and kernel launch wrappers
(:mod:`.purity`), the torch random-stream discipline (:mod:`.prng`:
``torch-generator``, ``generator-dead``), dtype discipline
(:mod:`.dtype`), the import-layering DAG and ``cuda-import``
(:mod:`.layering`), and the lock rules (:mod:`.concurrency`).

This package imports NOTHING outside the stdlib (asserted by
tests/test_torch_analysis.py): it runs on hosts without torch, beside a
run on the card's host, and inside tier-1 under a <10 s budget.
"""

from .engine import (
    DEFAULT_TARGETS,
    AllowlistEntry,
    AllowlistError,
    Finding,
    Module,
    Project,
    Report,
    Rule,
    RULES,
    load_allowlist,
    register,
    run_analysis,
)

# importing the rule modules populates the registry (deterministic
# order: the guard invariants first, then the families)
from . import legacy as _legacy  # noqa: F401
from . import purity as _purity  # noqa: F401
from . import prng as _prng  # noqa: F401
from . import dtype as _dtype  # noqa: F401
from . import layering as _layering  # noqa: F401
from . import concurrency as _concurrency  # noqa: F401

__all__ = [
    "AllowlistEntry",
    "AllowlistError",
    "DEFAULT_TARGETS",
    "Finding",
    "Module",
    "Project",
    "Report",
    "Rule",
    "RULES",
    "load_allowlist",
    "register",
    "run_analysis",
]
