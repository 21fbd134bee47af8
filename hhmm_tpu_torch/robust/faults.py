"""Fault injection for the samplers and ``fit_batched`` (counterpart of
the chain and dispatch half of ``hhmm_tpu/robust/faults.py``): in-scan
corruption of one chain's state, dispatch-level poisoning of a chunk's
result, and a simulated crash between chunks, for proving the guard and
healing paths.

- **No cost without a plan.** A sampler asks :func:`batch_fault_arrays`
  once, before its loop; with no active in-scan plan it gets ``None``
  and runs exactly the ops it runs without this module. With a plan,
  the fault arrays are host numpy and :func:`corrupt` compares the
  transition index on the host: it adds a ``torch.where`` only at the
  transition where some chain fires. A never-firing plan (``step=-1``
  or ``chain=-1``) is therefore bitwise the plan-free run.
- **Targets.** The port's samplers take a whole ``[B, C]`` batch of
  series x chains, so an in-scan plan hits chain ``chain`` of series
  ``series`` of the batch the sampler was given (under ``fit_batched``,
  of each chunk: the chunk-local index, as the JAX shared-ChEES path
  has it). A single-posterior sampler is the batch of one, series 0,
  as the JAX ``chain_fault_arrays`` has it. Dispatch-level plans
  (``kind="unhealthy_result"``) name a global series of the fit.
- **Plans are thread-scoped**: the active-plan stack is thread-local, so
  a plan injected on one thread never reaches another thread's fit.

The traffic, regime-shift, snapshot, dispatch and torn-file faults of
the JAX module belong to the serving plane and are not ported here.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "FaultPlan",
    "SimulatedCrash",
    "inject",
    "active",
    "chain_fault_arrays",
    "batch_fault_arrays",
    "corrupt",
    "corrupt_tree",
    "note_chunk_complete",
    "corrupt_chunk_result",
]

# in-scan fault kinds (the JAX module's int codes)
KIND_NONE = 0
KIND_NAN_GRAD = 1
KIND_NAN_LOGP = 2
KIND_INF_LOGP = 3
KIND_NAN_STATE = 4
_IN_SCAN_KINDS: Dict[str, int] = {
    "nan_grad": KIND_NAN_GRAD,
    "nan_logp": KIND_NAN_LOGP,
    "inf_logp": KIND_INF_LOGP,
    "nan_state": KIND_NAN_STATE,
}


class SimulatedCrash(RuntimeError):
    """Raised by :func:`note_chunk_complete` to simulate a process dying
    between dispatch chunks. Completed chunks are already cached, so a
    rerun resumes from the cache."""


@dataclass(frozen=True)
class FaultPlan:
    """One fault to inject. ``kind`` selects the mechanism:

    - ``"nan_grad" | "nan_logp" | "inf_logp" | "nan_state"``: in-scan —
      corrupt the post-transition gradient / log density / position of
      chain ``chain`` of series ``series`` at transition ``step``
      (warmup transitions count first). ``step=-1`` or ``chain=-1``
      makes a plan that never fires (the bitwise control run).
    - ``"unhealthy_result"``: dispatch-level — after a ``fit_batched``
      chunk runs, poison chain ``chain`` of global series ``series``
      with NaN draws and an unhealthy mask, on dispatch attempt 0 only
      (on every attempt with ``sticky=True``).
    - ``"none"``: carries only ``crash_after_chunks``.

    ``crash_after_chunks=N`` makes ``fit_batched`` raise
    :class:`SimulatedCrash` after N chunks have completed (with any
    kind)."""

    kind: str = "none"
    step: int = -1
    chain: int = -1
    series: int = 0
    sticky: bool = False
    crash_after_chunks: Optional[int] = None

    def __post_init__(self):
        if self.kind not in ("none", "unhealthy_result", *_IN_SCAN_KINDS):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class _ActiveEntry:
    """One injection-stack frame: the plan and its chunk counter."""

    __slots__ = ("plan", "chunks_done")

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.chunks_done = 0


_TLS = threading.local()


def _stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


@contextmanager
def inject(plan: FaultPlan):
    """Activate ``plan`` for the block on THIS thread (re-entrant; the
    innermost plan wins)."""
    if not isinstance(plan, FaultPlan):
        raise TypeError(f"inject() takes a FaultPlan, got {type(plan).__name__}")
    stack = _stack()
    stack.append(_ActiveEntry(plan))
    try:
        yield plan
    finally:
        stack.pop()


def _innermost() -> Optional[_ActiveEntry]:
    stack = _stack()
    return stack[-1] if stack else None


def active() -> Optional[FaultPlan]:
    """The innermost fault plan on this thread, or None."""
    entry = _innermost()
    return entry.plan if entry is not None else None


# ---------------------------------------------------------------- in-scan


def batch_fault_arrays(n_series: int, n_chains: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``[B, C]`` host ``(fault_step, fault_kind)`` int arrays for the
    active in-scan plan, or None when no in-scan plan is active (the
    production path: the sampler adds nothing)."""
    plan = active()
    if plan is None or plan.kind not in _IN_SCAN_KINDS:
        return None
    step = np.full((n_series, n_chains), -1, np.int64)
    kind = np.zeros((n_series, n_chains), np.int64)
    if 0 <= plan.series < n_series and 0 <= plan.chain < n_chains:
        step[plan.series, plan.chain] = plan.step
        kind[plan.series, plan.chain] = _IN_SCAN_KINDS[plan.kind]
    return step, kind


def chain_fault_arrays(n_chains: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``[C]`` arrays for a single-posterior sampler: only ``series ==
    0`` plans target it."""
    fault = batch_fault_arrays(1, n_chains)
    return None if fault is None else (fault[0][0], fault[1][0])


def _fire_mask(fire: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """The host ``fire`` mask as a tensor on ``x``'s device, broadcast
    over ``x``'s trailing axes."""
    m = torch.as_tensor(fire, device=x.device)
    return m.reshape(m.shape + (1,) * (x.ndim - m.ndim))


def corrupt(t: int, fault_step, fault_kind, logp=None, grad=None, q=None):
    """Apply the in-scan corruption at transition ``t`` (a host int).

    ``fault_step`` / ``fault_kind`` are host arrays over the state's
    leading lane axes. Returns ``(logp, grad, q)``, None passed through;
    the tensors come back untouched (no op at all) unless some chain
    fires at ``t``."""
    fire = (int(t) == np.asarray(fault_step)) & (np.asarray(fault_kind) != KIND_NONE)
    if not fire.any():
        return logp, grad, q
    kind = np.asarray(fault_kind)
    if logp is not None:
        for code, val in ((KIND_NAN_LOGP, float("nan")), (KIND_INF_LOGP, float("inf"))):
            f = fire & (kind == code)
            if f.any():
                logp = torch.where(_fire_mask(f, logp), torch.full_like(logp, val), logp)
    if grad is not None and (fire & (kind == KIND_NAN_GRAD)).any():
        m = _fire_mask(fire & (kind == KIND_NAN_GRAD), grad)
        grad = torch.where(m, torch.full_like(grad, float("nan")), grad)
    if q is not None and (fire & (kind == KIND_NAN_STATE)).any():
        m = _fire_mask(fire & (kind == KIND_NAN_STATE), q)
        q = torch.where(m, torch.full_like(q, float("nan")), q)
    return logp, grad, q


def corrupt_tree(t: int, fault_step, fault_kind, tree: Dict[str, torch.Tensor]):
    """``kind="nan_state"`` corruption of every float leaf of a dict of
    tensors (the Gibbs parameter block, which has no gradient)."""
    fire = (
        (int(t) == np.asarray(fault_step))
        & (np.asarray(fault_kind) == KIND_NAN_STATE)
    )
    if not fire.any():
        return tree
    out = {}
    for k, x in tree.items():
        if x.is_floating_point():
            x = torch.where(_fire_mask(fire, x), torch.full_like(x, float("nan")), x)
        out[k] = x
    return out


# ----------------------------------------------------------- dispatch-level


def note_chunk_complete() -> None:
    """Called by ``fit_batched`` after each chunk is computed *and*
    cached; raises :class:`SimulatedCrash` when the active plan's
    ``crash_after_chunks`` budget is used up."""
    entry = _innermost()
    if entry is None or entry.plan.crash_after_chunks is None:
        return
    entry.chunks_done += 1
    if entry.chunks_done >= entry.plan.crash_after_chunks:
        raise SimulatedCrash(f"simulated crash after {entry.chunks_done} completed chunk(s)")


def corrupt_chunk_result(qs, stats, chunk_start: int, chunk_len: int, attempt: int):
    """Dispatch-level fault of the healing tests: poison one chain's
    chunk result as a quarantine in the scan would surface it (NaN draws,
    unhealthy mask, quarantine step). Fires on dispatch attempt 0 only
    unless the plan is ``sticky``. Returns the inputs when inactive."""
    plan = active()
    if plan is None or plan.kind != "unhealthy_result":
        return qs, stats
    if attempt > 0 and not plan.sticky:
        return qs, stats
    s = plan.series - chunk_start
    if not (0 <= s < chunk_len) or "chain_healthy" not in stats:
        return qs, stats
    qs = qs.clone()
    qs[s, plan.chain] = float("nan")
    stats = dict(stats)
    stats["chain_healthy"] = stats["chain_healthy"].clone()
    stats["chain_healthy"][s, plan.chain] = False
    if "quarantine_step" in stats:
        stats["quarantine_step"] = stats["quarantine_step"].clone()
        stats["quarantine_step"][s, plan.chain] = plan.step
    return qs, stats
