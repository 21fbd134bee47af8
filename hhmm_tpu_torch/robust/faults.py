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

- **Serving faults.** :class:`TrafficFaultPlan` (bursts, slow and torn
  snapshot loads, a simulated device loss at the Nth dispatch) and
  :class:`RegimeShiftPlan` (a data-plane regime shift the traffic
  generator consults) stack beside a :class:`FaultPlan`; the innermost
  plan of each type wins. The serving plane calls
  :func:`snapshot_load_fault` before every pager load and
  :func:`dispatch_fault` at the head of every tick dispatch.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "FaultPlan",
    "TrafficFaultPlan",
    "RegimeShiftPlan",
    "SimulatedCrash",
    "SimulatedDeviceLoss",
    "inject",
    "active",
    "chain_fault_arrays",
    "batch_fault_arrays",
    "corrupt",
    "corrupt_tree",
    "note_chunk_complete",
    "corrupt_chunk_result",
    "traffic_active",
    "regime_shift_active",
    "snapshot_load_fault",
    "dispatch_fault",
    "tear_file",
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


class SimulatedDeviceLoss(RuntimeError):
    """Raised by :func:`dispatch_fault` to simulate the card vanishing
    mid-replay. The serving flush path must catch it and degrade the
    affected ticks into shed responses, never let it escape."""


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


@dataclass(frozen=True)
class TrafficFaultPlan:
    """Traffic-shaped serving faults. Every mechanism is deterministic —
    its counters live on the injection-stack entry, so the Nth load or
    dispatch under a plan always fires the same fault:

    - ``burst_factor`` / ``burst_every``: every ``burst_every``-th load
      round the generator submits ``burst_factor`` times the nominal
      ticks (:meth:`burst_multiplier`; arrivals, not scheduler work).
    - ``slow_load_s`` / ``slow_load_every``: every
      ``slow_load_every``-th snapshot load through
      :func:`snapshot_load_fault` sleeps ``slow_load_s`` first.
    - ``tear_load_every``: every ``tear_load_every``-th load first
      truncates the snapshot file (:func:`tear_file`); the reader must
      see a quarantined miss.
    - ``device_loss_at_dispatch`` / ``device_loss_count``: dispatches
      ``[at, at + count)`` through :func:`dispatch_fault` raise
      :class:`SimulatedDeviceLoss` (``-1`` = never)."""

    burst_factor: int = 1
    burst_every: int = 0
    slow_load_s: float = 0.0
    slow_load_every: int = 0
    tear_load_every: int = 0
    device_loss_at_dispatch: int = -1
    device_loss_count: int = 1

    def burst_multiplier(self, round_idx: int) -> int:
        """Arrival multiplier of load round ``round_idx`` (0-based):
        ``burst_factor`` on every ``burst_every``-th round, else 1."""
        if self.burst_every > 0 and (round_idx + 1) % self.burst_every == 0:
            return max(1, int(self.burst_factor))
        return 1


@dataclass(frozen=True)
class RegimeShiftPlan:
    """Data-plane drift: from stream tick ``at_tick`` on, the traffic
    generator swaps to an alternate regime (:func:`regime_shift_active`
    is its per-tick question). Nothing fires inside the serving or fit
    paths."""

    at_tick: int = 0

    def __post_init__(self):
        if int(self.at_tick) < 0:
            raise ValueError(f"at_tick must be >= 0, got {self.at_tick}")


class _ActiveEntry:
    """One injection-stack frame: the plan and its counters (chunks for
    a :class:`FaultPlan`, loads and dispatches for a
    :class:`TrafficFaultPlan`)."""

    __slots__ = ("plan", "chunks_done", "loads", "dispatches")

    def __init__(self, plan):
        self.plan = plan
        self.chunks_done = 0
        self.loads = 0
        self.dispatches = 0


_TLS = threading.local()


def _stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


@contextmanager
def inject(plan):
    """Activate ``plan`` (a :class:`FaultPlan`, :class:`TrafficFaultPlan`
    or :class:`RegimeShiftPlan`) for the block on THIS thread
    (re-entrant; the innermost plan of each type wins)."""
    if not isinstance(plan, (FaultPlan, TrafficFaultPlan, RegimeShiftPlan)):
        raise TypeError(
            "inject() takes a FaultPlan, TrafficFaultPlan, or RegimeShiftPlan, "
            f"got {type(plan).__name__}"
        )
    stack = _stack()
    stack.append(_ActiveEntry(plan))
    try:
        yield plan
    finally:
        stack.pop()


def _innermost(cls=FaultPlan) -> Optional[_ActiveEntry]:
    for entry in reversed(_stack()):
        if isinstance(entry.plan, cls):
            return entry
    return None


def active() -> Optional[FaultPlan]:
    """The innermost chain/dispatch fault plan on this thread, or None."""
    entry = _innermost(FaultPlan)
    return entry.plan if entry is not None else None


def traffic_active() -> Optional[TrafficFaultPlan]:
    """The innermost traffic-shaped fault plan on this thread."""
    entry = _innermost(TrafficFaultPlan)
    return entry.plan if entry is not None else None


def regime_shift_active(tick: int) -> bool:
    """Whether the innermost :class:`RegimeShiftPlan` (if any) has the
    shifted regime active at stream tick ``tick``."""
    entry = _innermost(RegimeShiftPlan)
    return entry is not None and int(tick) >= entry.plan.at_tick


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


# -------------------------------------------------------------- traffic


def snapshot_load_fault(path: str) -> None:
    """Serving-side load hook (the pager calls it before every registry
    load): under an active :class:`TrafficFaultPlan` it counts the load
    and fires the torn-file and slow-load faults deterministically. One
    thread-local read without a plan."""
    entry = _innermost(TrafficFaultPlan)
    if entry is None:
        return
    plan = entry.plan
    entry.loads += 1
    if plan.tear_load_every > 0 and entry.loads % plan.tear_load_every == 0 and os.path.exists(path):
        tear_file(path)
    if plan.slow_load_every > 0 and plan.slow_load_s > 0 and entry.loads % plan.slow_load_every == 0:
        time.sleep(plan.slow_load_s)


def dispatch_fault() -> None:
    """Serving-side dispatch hook (the scheduler calls it at the head of
    every micro-batch dispatch): raises :class:`SimulatedDeviceLoss` in
    the active plan's dispatch window. The flush path degrades the
    affected ticks."""
    entry = _innermost(TrafficFaultPlan)
    if entry is None:
        return
    plan = entry.plan
    if plan.device_loss_at_dispatch < 0:
        return
    idx = entry.dispatches
    entry.dispatches += 1
    lo = plan.device_loss_at_dispatch
    if lo <= idx < lo + max(1, plan.device_loss_count):
        raise SimulatedDeviceLoss(
            f"simulated device loss at dispatch {idx} (window "
            f"[{lo}, {lo + max(1, plan.device_loss_count)}))"
        )


def tear_file(path: str, keep_bytes: int = 16) -> None:
    """Truncate ``path`` to its first ``keep_bytes`` bytes — a torn
    mid-write file (what atomic writes prevent and readers tolerate)."""
    with open(path, "rb") as f:
        head = f.read(keep_bytes)
    with open(path, "wb") as f:
        f.write(head)
