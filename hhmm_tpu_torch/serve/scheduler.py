"""Micro-batching tick scheduler (counterpart of
``hhmm_tpu/serve/scheduler.py``): queue per-series updates and dispatch
them in a small fixed set of padded batch shapes.

The serving workload is thousands of independent series each advancing
one tick at a time. Pending ticks are grouped into the smallest
**bucket** that fits (default 8 / 32 / 128; oversize flushes split into
max-bucket chunks), lanes are padded by repeating the last request, and
one tick function serves every bucket: the draws of N series x D draws
go through the model's batch-native ``unpack`` / ``build`` as one batch
of lanes ``[N, D]``. The port has no jit; ``compile_count``
(``serve/metrics.py``) counts the distinct dispatch signatures (kernel,
bucket, observation dtypes; the replay's padded length), which stay
flat after warmup exactly as the JAX package's jit caches do.

Robustness (the ``robust/`` discipline applied to serving):

- every update goes through ``robust.guards.guard_update``: a draw
  whose filter goes non-finite is frozen at its last healthy state,
  permanently, and left out of the response average; a series with no
  healthy draw keeps serving its last healthy state with
  ``degraded=True``;
- a quarantined fit (``healthy=False`` snapshot) never replaces a
  healthy serving state: ``attach`` keeps the attached posterior, else
  the registry's last healthy snapshot, and serves the degraded draws
  (flagged) only when there is no healthy fallback.

Overload and failure: an explicit capacity model
(:class:`AdmissionPolicy`: queue depth, per-tenant quota, attached
series, per-flush budget, weighted deficit round-robin across tenants)
sheds — every shed is a counted ``shed=True`` :class:`TickResponse`,
never an exception. Errors inside a dispatch (a malformed observation,
a simulated or real device loss) degrade that group's ticks into shed
responses while the rest of the flush proceeds. A CUDA error is sticky
to its context, so a real one keeps failing every later dispatch in the
process; the scheduler still sheds and counts each, as its contract
says. With a pager (``serve/pager.py``) snapshot residency is an LRU
cache under a byte budget: an evicted series is detached and re-attached
(warm, from its retained history tail) on its next ``submit``.

Three ways to run a tick, bitwise equal to each other:

- **staged** (default): every flush stacks the series' carry tensors
  into fresh ``[B, D, K]`` inputs;
- **resident** (``resident=True``, ``serve/lanes.py``): the carry stays
  in the last dispatch's output tensors; a flush with the same lane
  membership reuses them, churn regroups with ``index_select``;
- **pipelined** (``pipeline=True``, ``hhmm_tpu_torch/pipeline``):
  :meth:`dispatch_async` launches a flush's ticks on the card's stream,
  copies the response rows non-blocking into pinned host memory and
  records a CUDA event; :meth:`harvest` waits on the event and commits.
  Nothing on the dispatch side waits on the card (no ``.item()``, no
  ``.cpu()``, host inputs go up from pinned memory non-blocking).

Request plane (``obs/request.py``): every tick can carry a
:class:`~hhmm_tpu_torch.obs.request.TickTrace` stamped at enqueue →
admit → bucket → dispatch → [harvest →] device → respond, attributed
per tenant. Every clock read of this module goes through
``obs_request.now``.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.batch.pad import pad_ragged
from hhmm_tpu_torch.core.lmath import safe_log_normalize
from hhmm_tpu_torch.kernels.duration import collapse_probs
from hhmm_tpu_torch.obs import metrics as obs_metrics
from hhmm_tpu_torch.obs import profile as obs_profile
from hhmm_tpu_torch.obs import request as obs_request
from hhmm_tpu_torch.obs.trace import enabled as trace_enabled
from hhmm_tpu_torch.obs.trace import span, traced
from hhmm_tpu_torch.pipeline import DevicePlacement, Flight, InFlightTable, placement_for_plan
from hhmm_tpu_torch.robust import faults
from hhmm_tpu_torch.robust.guards import finite_mask, guard_update
from hhmm_tpu_torch.serve.lanes import CarryBank, LaneTable
from hhmm_tpu_torch.serve.metrics import ServeMetrics
from hhmm_tpu_torch.serve.online import StreamState, _fold, stream_init, stream_step
from hhmm_tpu_torch.serve.registry import PosteriorSnapshot, SnapshotRegistry, model_spec

__all__ = ["TickResponse", "AdmissionPolicy", "MicroBatchScheduler"]

# explicit series->tenant bindings kept (LRU): they survive pager
# eviction, but a fleet of ephemeral series ids must not grow the map
TENANT_BINDINGS_CAP = 65536

# deficit-round-robin credit table bound (coldest entry dropped)
CREDIT_TABLE_CAP = 4096

# host-byte cap on retained history tails when none is given
DEFAULT_TAIL_BUDGET_BYTES = 32 << 20  # 32 MiB

# sentinel in a series record's alpha/ll/ok fields while its carry lives
# in a resident CarryBank (serve/lanes.py): distinct from None (fresh,
# needs the init tick); every read goes through _carry_of
_RESIDENT = object()


def _obs_nbytes(obs: Dict[str, Any]) -> int:
    """Host-byte estimate of one retained tail observation: the values'
    bytes plus a flat per-entry overhead (an accounting convention)."""
    n = 64
    for v in obs.values():
        n += int(np.asarray(v).nbytes) + 16
    return n


def _canon_dtype(dt) -> np.dtype:
    """The serving dtype of an observation key: floats go to float32
    (float16 stays), integers to int64, bool stays."""
    dt = np.dtype(dt)
    if dt.kind == "f":
        return np.dtype(np.float16) if dt == np.float16 else np.dtype(np.float32)
    if dt.kind in "iu":
        return np.dtype(np.int64)
    return dt


def _promote(a: np.dtype, b: np.dtype) -> np.dtype:
    """Widening-only promotion of two serving dtypes: a float wins over an
    integer or bool (the widest float), an integer over a bool."""
    if a == b:
        return a
    floats = [d for d in (a, b) if d.kind == "f"]
    if floats:
        return max(floats, key=lambda d: d.itemsize)
    if a.kind == "b":
        return b
    if b.kind == "b":
        return a
    return np.dtype(np.int64)


def _h2d(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to a card from pinned memory,
    non-blocking, so staging never waits on the stream's queued work."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@dataclass(frozen=True)
class TickResponse:
    """One served tick: draw-averaged filtered state and health. A
    ``shed=True`` response means the observation was NOT folded into the
    filter (admission pressure, dispatch failure, detached series —
    ``error`` says which)."""

    series_id: str
    probs: np.ndarray  # [K] posterior-mean filtered state probabilities
    loglik: float  # running log-likelihood, mean over healthy draws
    healthy_draws: int
    degraded: bool
    latency_s: float
    shed: bool = False
    error: Optional[str] = None
    # per-draw one-step predictive log-likelihood increments [D] and the
    # per-draw health mask [D] of this tick (the adaptation plane's
    # reweighting inputs; a frozen draw contributes 0.0 with ok=False).
    # None on shed responses: a shed tick folded nothing.
    per_draw_loglik: Optional[np.ndarray] = None
    draw_ok: Optional[np.ndarray] = None


@dataclass(frozen=True)
class AdmissionPolicy:
    """Explicit serving capacity; every ``None`` cap is unbounded.
    Pressure beyond a cap sheds (counted in ``serve.shed_ticks`` /
    ``serve.rejected_attaches``, surfaced as ``shed=True`` responses);
    it never raises.

    - ``max_series``: attached series; attach items beyond it are
      rejected.
    - ``max_queue_depth``: pending ticks; a submit into a full queue
      sheds the OLDEST pending tick.
    - ``max_pending_per_series``: per-**tenant** quota (request-plane
      tenant, default tenant = series); an over-quota submit sheds that
      tenant's oldest queued tick.
    - ``max_ticks_per_flush``: dispatch budget a flush; the rest stays
      queued.

    ``flush_order``: ``"drr"`` (default) splits a budget that cannot
    drain every pending tick by weighted deficit round-robin across
    tenants (``tenant_shares``, unlisted tenants weigh 1.0; stranded or
    pressure-shed tenants bank unused entitlement as credit capped by
    ``credit_cap_ticks``, else the flush budget, else the largest
    bucket; leftover budget is work-conserving; a tick never overtakes
    an earlier queued tick of its own series). ``"fifo"`` drains in
    arrival order."""

    max_series: Optional[int] = None
    max_queue_depth: Optional[int] = None
    max_pending_per_series: Optional[int] = None
    max_ticks_per_flush: Optional[int] = None
    tenant_shares: Optional[Mapping[str, float]] = None
    credit_cap_ticks: Optional[int] = None
    flush_order: str = "drr"

    def __post_init__(self):
        for f in (
            "max_series",
            "max_queue_depth",
            "max_pending_per_series",
            "max_ticks_per_flush",
            "credit_cap_ticks",
        ):
            v = getattr(self, f)
            if v is not None and int(v) <= 0:
                raise ValueError(f"{f} must be positive or None, got {v}")
        if self.flush_order not in ("fifo", "drr"):
            raise ValueError(f"flush_order must be 'fifo' or 'drr', got {self.flush_order!r}")
        if self.tenant_shares is not None:
            for t, w in self.tenant_shares.items():
                if not (float(w) > 0):
                    raise ValueError(f"tenant_shares[{t!r}] must be positive, got {w}")

    @classmethod
    def from_plan(cls, plan, *, max_series: Optional[int] = None, **kw):
        """Caps from the planner's bucket ladder
        (:meth:`hhmm_tpu_torch.plan.Plan.admission_caps`), so a
        capacity-bounded flush and a starved tenant's credit burst drain
        in bucket shapes. ``tenant_shares`` / ``flush_order`` pass
        through; the adaptation and carry caps ``admission_caps`` also
        derives are dropped here."""
        shares = kw.pop("tenant_shares", None)
        order = kw.pop("flush_order", "drr")
        caps = dict(plan.admission_caps(**kw))
        for other_key in ("ess_floor_frac", "max_rejuv_per_flush", "carry_slots_cap"):
            caps.pop(other_key, None)
        return cls(max_series=max_series, tenant_shares=shares, flush_order=order, **caps)


_DEVICE_LOSS_TEXT = (
    "UNAVAILABLE",
    "DEVICE LOST",
    "CUDA ERROR",
    "CUDA_ERROR",
    "CUDAERROR",
    "ILLEGAL ADDRESS",
    "UNSPECIFIED LAUNCH FAILURE",
)


def _looks_like_device_loss(e: Exception) -> bool:
    """A dispatch failure that means the card went away (simulated by
    ``robust/faults.py``, or a CUDA error) rather than a malformed
    input."""
    if isinstance(e, faults.SimulatedDeviceLoss):
        return True
    msg = str(e).upper()
    return any(t in msg for t in _DEVICE_LOSS_TEXT)


class MicroBatchScheduler:
    """See module docstring. One instance serves one model family; all
    attached series share the snapshot draw count ``D``."""

    def __init__(
        self,
        model,
        buckets: Optional[Sequence[int]] = None,
        registry: Optional[SnapshotRegistry] = None,
        metrics: Optional[ServeMetrics] = None,
        history_pad: int = 64,
        plan=None,
        admission: Optional[AdmissionPolicy] = None,
        pager=None,
        profile_every: int = 0,
        recorder: Optional[obs_request.RequestRecorder] = None,
        history_tail: int = 0,
        tail_budget_bytes: Optional[int] = None,
        pipeline: bool = False,
        placement: Optional[DevicePlacement] = None,
        resident: bool = False,
        carry_slots_cap: Optional[int] = None,
        events=None,
        device: DeviceLike = None,
    ):
        """``device``: where the ticks run (None: the card, raising
        without one; ``"cpu"`` for the plain PyTorch ops).

        ``plan``: an optional :class:`hhmm_tpu_torch.plan.Plan`; its
        bucket ladder is the default, and with ``pipeline=True`` its
        ``device_list()`` is the fan-out's device list. ``admission``:
        an :class:`AdmissionPolicy` (``"auto"`` derives the caps from the
        plan). ``pager``: a :class:`hhmm_tpu_torch.serve.pager.
        SnapshotPager` (evictions detach; ``submit`` pages registered
        series in). ``profile_every``: with the tracer on, every Nth
        flush re-times its last dispatch through
        ``obs.profile.device_time`` on the same inputs. ``recorder``: the
        request-plane recorder (default: one that follows the tracer).
        ``history_tail``: a per-series ring of the last folded
        observations (the warm page-in and swap replay source), host
        bytes capped by ``tail_budget_bytes`` (default 32 MiB).
        ``pipeline`` / ``placement``: the async pipeline (an explicit
        placement implies it). ``resident`` / ``carry_slots_cap``: the
        resident carry plane and its slot budget (default: the plan's
        ``admission_caps()['carry_slots_cap']``). ``events``: a
        :class:`~hhmm_tpu_torch.serve.events.RegimeEventFeed` fed every
        committed response."""
        self.device = resolve_device(device)
        if buckets is None:
            buckets = plan.buckets if plan is not None else (8, 32, 128)
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets}")
        self.model = model
        self.plan = plan
        if plan is not None:
            plan.note()  # record the serving layout in run manifests
        self.events = events
        self._event_dmax = max(
            1,
            (int(getattr(model, "n_states", 0) or 0) // max(1, int(getattr(model, "K", 1) or 1))),
        )
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.registry = registry
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.history_pad = int(history_pad)
        if admission == "auto":
            if plan is None:
                raise ValueError("admission='auto' needs a plan (its caps "
                                 "derive from the planner bucket ladder)")
            admission = AdmissionPolicy.from_plan(plan)
        self.admission = admission
        self.pager = pager
        self.recorder = recorder if recorder is not None else obs_request.RequestRecorder()
        self.profile_every = int(profile_every or 0)
        if self.profile_every < 0:
            raise ValueError(f"profile_every must be >= 0, got {profile_every}")
        self._profile_seq = 0
        # (kernel name, bucket, fn, args) of the newest successful
        # dispatch — what a sampled profile re-times
        self._last_dispatch: Optional[Tuple[str, int, Any, tuple]] = None
        if pager is not None:
            pager.set_evict_listener(self.detach)
        self.history_tail = int(history_tail or 0)
        if self.history_tail < 0:
            raise ValueError(f"history_tail must be >= 0, got {history_tail}")
        if tail_budget_bytes is None:
            tail_budget_bytes = DEFAULT_TAIL_BUDGET_BYTES
        if int(tail_budget_bytes) <= 0:
            raise ValueError(f"tail_budget_bytes must be positive, got {tail_budget_bytes}")
        self.tail_budget_bytes = int(tail_budget_bytes)
        # per-series deque of (folded observation dict, nbytes), LRU by
        # fold; survives detach, released by unregister or the byte cap
        self._tail: "OrderedDict[str, Any]" = OrderedDict()
        self._tail_bytes = 0
        self._tail_evictions = 0
        # DRR carry-over credit per tenant (bounded LRU)
        self._credit: "OrderedDict[str, float]" = OrderedDict()
        self.n_draws: Optional[int] = None
        self._series: Dict[str, Dict[str, Any]] = {}
        # staleness: host clock at each series' last committed attach
        self._attach_t: Dict[str, float] = {}
        # monotone per-series count of committed attaches
        self._attach_gen: Dict[str, int] = {}
        self._oldest_attach_t: Optional[float] = None
        # pending entries: (series_id, obs, t_submit, tenant, trace)
        self._pending: List[Tuple[str, Dict[str, Any], float, str, Any]] = []
        self._pending_count: Dict[str, int] = {}
        # per-TENANT pending occupancy (the quota key)
        self._pending_tenant_count: Dict[str, int] = {}
        # series -> explicit tenant (absent: tenant = series); survives
        # detach, LRU-bounded at TENANT_BINDINGS_CAP
        self._tenant_of: "OrderedDict[str, str]" = OrderedDict()
        # adaptation-plane weight state per series, opaque here
        self._weights: "OrderedDict[str, Any]" = OrderedDict()
        self._undelivered: List[TickResponse] = []
        # lane membership -> (stacked draws [B, D, dim], unpacked params
        # [B, D, ...]) on the dispatch device: the draw bank is immutable
        # between attaches, so a tick ships only what changes
        self._draws_cache: Dict[Tuple[str, ...], Tuple[torch.Tensor, Dict[str, torch.Tensor]]] = {}
        self._obs_dtypes: Dict[str, np.dtype] = {}
        # the locked observation keyset (set by the first successful
        # dispatch); later ticks with foreign keys shed
        self._obs_keys_lock: Optional[Tuple[str, ...]] = None
        try:
            self._model_spec = model_spec(model)
        except ValueError:
            self._model_spec = None
        self._signatures: set = set()
        # ---- async flush pipeline ----
        if placement is not None:
            pipeline = True
        self._inflight: Optional[InFlightTable] = None
        self._placement: Optional[DevicePlacement] = None
        self._pipe_devices: list = []
        self._dev_served: Dict[int, int] = {}
        self._deferred_inflight = 0
        if pipeline:
            if placement is None:
                placement = placement_for_plan(plan)
            devs = plan.device_list() if plan is not None else [self.device]
            if placement.n_devices > len(devs):
                raise ValueError(
                    f"placement spans {placement.n_devices} devices but the "
                    f"plan/backend exposes only {len(devs)}"
                )
            self._placement = placement
            self._pipe_devices = [torch.device(d) for d in devs[: placement.n_devices]]
            self._inflight = InFlightTable()
            if plan is not None:
                placement.record(plan)
            if pager is not None:
                pager.set_placement(placement)
        # ---- resident carry plane ----
        self.resident = bool(resident)
        self._lanes: Optional[LaneTable] = None
        self._carry_slots_cap: Optional[int] = None
        self._carry_spills = 0
        if self.resident:
            self._lanes = LaneTable()
            if carry_slots_cap is None and plan is not None:
                carry_slots_cap = plan.admission_caps()["carry_slots_cap"]
            if carry_slots_cap is not None:
                if int(carry_slots_cap) <= 0:
                    raise ValueError(f"carry_slots_cap must be positive or None, got {carry_slots_cap}")
                self._carry_slots_cap = int(carry_slots_cap)

    # ---- the tick functions (one signature per bucket shape) ----

    def _unpack_params(self, draws: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.model.unpack(draws)[0]

    def _guarded(self, st: StreamState, prev: StreamState, prev_ok):
        """Per-draw chain-health guard and the draw-averaged response:
        a draw keeps the update only while it was healthy AND the update
        is finite; otherwise it freezes at its last healthy state. A
        fully dead series averages its frozen states. Arrays ``[N, D,
        ...]``."""
        kept, okd = guard_update(prev_ok, st, prev, batch_ndim=2)
        dt = kept.log_alpha.dtype
        w = torch.where(okd.any(-1, keepdim=True), okd, torch.ones_like(okd)).to(dt)
        denom = w.sum(-1)
        probs = (torch.exp(kept.log_alpha) * w[..., None]).sum(-2) / denom[..., None]
        mean_ll = (kept.loglik * w).sum(-1) / denom
        # per-draw one-step predictive increment (0.0 for a frozen draw)
        inc = kept.loglik - prev.loglik
        return kept.log_alpha, kept.loglik, okd, probs, mean_ll, inc

    def _init_impl(self, params, obs):
        """First tick of a batch of fresh series: α₀ from the model's own
        (π, obs₀). ``params`` ``[N, D, ...]``; ``obs`` dict of ``[N]``."""
        log_pi, log_obs0 = self.model.tick_init(params, obs)
        st = stream_init(log_pi, log_obs0)
        # fallback for draws dead on arrival: the prior filter
        prior = StreamState(safe_log_normalize(log_pi), torch.zeros_like(st.loglik))
        ok0 = torch.ones(st.loglik.shape, dtype=torch.bool, device=st.loglik.device)
        return self._guarded(st, prior, ok0)

    def _update_impl(self, params, alpha, ll, ok, obs):
        """One tick for a batch of live series: ``alpha [N, D, K]``, ``ll
        [N, D]``, ``ok [N, D]`` bool, ``obs`` dict of ``[N]``."""
        prev = StreamState(alpha, ll)
        log_A, log_obs_t = self.model.tick_terms(params, obs)
        st = stream_step(prev, log_A, log_obs_t)
        return self._guarded(st, prev, ok)

    def _replay_impl(self, params, data_b):
        """Warm start of a batch of series from padded history: the fold
        of :func:`~hhmm_tpu_torch.serve.online.stream_step` over each
        series' window (the last state of ``filter_scan``). ``data_b``
        dict of ``[N, T]`` plus ``mask``."""
        log_pi, log_A, log_obs, mask = self.model.build(params, data_b)
        st = _fold(log_pi, log_A, log_obs, mask, keep_all=False)
        okd = finite_mask(st, batch_ndim=2)
        return st.log_alpha, st.loglik, okd

    # ---- device-resident carry plane (serve/lanes.py) ----

    def _carry_of(self, series_id: str):
        """``(alpha [D, K], ll [D], ok [D])`` of one attached, ticked
        series, sliced from its resident bank row when the record holds
        the ``_RESIDENT`` sentinel; None for a never-ticked or unattached
        series. Slicing happens outside the lane-table lock."""
        rec = self._series.get(series_id)
        if rec is None or rec["alpha"] is None:
            return None
        if rec["alpha"] is not _RESIDENT:
            return rec["alpha"], rec["ll"], rec["ok"]
        ref = self._lanes.lookup(series_id) if self._lanes else None
        if ref is None:
            return None
        bank, slot = ref
        return bank.alpha[slot], bank.ll[slot], bank.ok[slot]

    def _lane_drop(self, series_id: str) -> None:
        if self._lanes is not None and self._lanes.drop(series_id):
            self.metrics.note_carry_bytes(self._lanes.resident_bytes())

    def _commit_carry(self, alpha, ll, okd, lane_key: Tuple[str, ...], group,
                      device_index: int = 0) -> None:
        """Adopt one successful dispatch's padded outputs as the resident
        bank of its real lanes (padded duplicate slots are never mapped),
        then enforce the slot budget (oldest bank first)."""
        bank = CarryBank(alpha, ll, okd, lane_key, device_index)
        mapping: Dict[str, int] = {}
        for i, p in enumerate(group):
            sid = p[0]
            if sid not in mapping and sid in self._series:
                mapping[sid] = i
        self._lanes.commit(bank, mapping)
        for sid in mapping:
            rec = self._series[sid]
            rec["alpha"] = rec["ll"] = rec["ok"] = _RESIDENT
        if self._carry_slots_cap is not None:
            self._enforce_carry_budget(bank)
        self.metrics.note_carry_bytes(self._lanes.resident_bytes())

    def _enforce_carry_budget(self, protect: CarryBank) -> None:
        """Spill the oldest banks' rows back to their records until the
        resident slots fit ``carry_slots_cap`` (the bank just committed
        is protected)."""
        victims = self._lanes.spill_candidates(self._carry_slots_cap, protect=protect)
        for bank, rows in victims:
            staged = []
            for sid, slot in rows:
                rec = self._series.get(sid)
                if rec is None or rec["alpha"] is not _RESIDENT:
                    continue
                staged.append((sid, (bank.alpha[slot], bank.ll[slot], bank.ok[slot])))
            dropped = set(self._lanes.release(bank, [sid for sid, _ in staged]))
            for sid, (a, l, o) in staged:
                if sid in dropped:
                    rec = self._series[sid]
                    rec["alpha"], rec["ll"], rec["ok"] = a, l, o
            if dropped:
                self._carry_spills += 1

    def _form_carry(self, lanes, device: torch.device):
        """Resident-mode carry of one update dispatch: ``(alpha_b, ll_b,
        ok_b, staged_bytes)``. A bank hit (stable membership) passes the
        live bank's tensors through (nothing staged); a single-source
        regroup is one ``index_select`` a tensor into fresh ones; mixed
        sources stack the rows on the card."""
        lane_key = tuple(p[0] for p in lanes)
        bank = self._lanes.bank_for(lane_key)
        if bank is not None:
            return bank.alpha, bank.ll, bank.ok, 0
        refs = self._lanes.lookup_many(lane_key)
        src = {r[0].seq: r[0] for r in refs if r is not None}
        if len(src) == 1 and all(r is not None for r in refs):
            (bank,) = src.values()
            idx = _h2d(np.asarray([r[1] for r in refs], dtype=np.int64), bank.alpha.device)
            alpha_b = bank.alpha.index_select(0, idx)
            ll_b = bank.ll.index_select(0, idx)
            ok_b = bank.ok.index_select(0, idx)
            self._note_signature("lane_gather", len(lanes), ())
        else:
            rows = [self._carry_of(sid) for sid in lane_key]
            alpha_b = torch.stack([r[0] for r in rows]).to(device, non_blocking=True)
            ll_b = torch.stack([r[1] for r in rows]).to(device, non_blocking=True)
            ok_b = torch.stack([r[2] for r in rows]).to(device, non_blocking=True)
        staged = int(alpha_b.nbytes + ll_b.nbytes + ok_b.nbytes)
        return alpha_b, ll_b, ok_b, staged

    # ---- attach ----

    def _resolve_snapshot(self, series_id: str, snap: PosteriorSnapshot):
        """Quarantine fallback: ``(snapshot_to_serve, degraded,
        keep_current_state)``."""
        if snap.healthy:
            return snap, False, False
        cur = self._series.get(series_id)
        if cur is not None and not cur["degraded_attach"]:
            return snap, True, True  # keep serving the attached healthy posterior
        if self.registry is not None:
            # alias-resolved: the fallback is the snapshot SERVING under
            # this name (a promoted series must not revert)
            prev = self.registry.load_serving(series_id)
            if prev is not None and prev.healthy:
                return prev, False, False
        return snap, True, False  # no healthy fallback: serve it, flagged

    def attach(self, series_id: str, snapshot: PosteriorSnapshot, history=None,
               tenant: Optional[str] = None):
        """Attach (or re-attach) one series; ``history``: optional dict of
        per-tick arrays ``[T_h]`` to warm-start the filter from.
        ``tenant``: the request-plane key (None: tenant = series). A
        rejected item raises."""
        rejected = self.attach_many([(series_id, snapshot, history, tenant)])
        if rejected:
            raise ValueError(rejected[0][1])

    @traced("serve.attach")
    def attach_many(self, items) -> List[Tuple[str, str]]:
        """Attach a batch of series in padded replay dispatches.
        ``items``: ``(series_id, snapshot, history_or_None[,
        tenant_or_None])``. A bad item — invalid snapshot, admission
        capacity, a failing warm-replay chunk — is REJECTED (returned as
        ``(series_id, reason)``, counted in ``serve.rejected_attaches``)
        without failing the rest; committed items commit atomically per
        item, and the draw-count lock moves only with a committed
        attach."""
        items = [
            (it[0], it[1], it[2], it[3] if len(it) > 3 else None)
            for it in (tuple(it) for it in items)
        ]
        rejected: List[Tuple[str, str]] = []
        n_draws = self.n_draws
        resolved, keeps = [], []
        n_degraded_fits = 0
        tenant_by_sid = {sid: tenant for sid, _, _, tenant in items if tenant is not None}
        cap = None if self.admission is None else self.admission.max_series
        projected = set(self._series)
        for series_id, snap, hist, _ in items:
            if snap is None:
                rejected.append((
                    series_id,
                    f"no snapshot for series {series_id!r} (registry miss / "
                    "corrupt entry?) — nothing to attach",
                ))
                continue
            use, degraded, keep = self._resolve_snapshot(series_id, snap)
            if keep:
                n_degraded_fits += 1
                keeps.append(series_id)
                continue
            reason = self._snapshot_reject_reason(series_id, use, n_draws)
            if reason is not None:
                rejected.append((series_id, reason))
                continue
            if cap is not None and series_id not in projected and len(projected) >= cap:
                rejected.append((series_id, f"admission: max_series={cap} in-flight series reached"))
                continue
            projected.add(series_id)
            # a quantized snapshot stays packed at rest; the card serves f32
            draws = np.asarray(use.dequantized_draws(), dtype=np.float32)
            if n_draws is None:
                n_draws = draws.shape[0]
            resolved.append((
                series_id, torch.as_tensor(draws, device=self.device), degraded, hist, use,
                not snap.healthy,
            ))

        fresh = [(s, d, g) for s, d, g, h, _, _ in resolved if h is None]
        warm = [(s, d, g, h) for s, d, g, h, _, _ in resolved if h is not None]
        new_recs: Dict[str, Dict[str, Any]] = {}
        for series_id, draws, degraded in fresh:
            new_recs[series_id] = {
                "draws": draws,
                "alpha": None,  # set by the first tick
                "ll": None,
                "ok": None,
                "degraded_attach": degraded,
                "rejected_fits": 0,
            }
        if warm:
            recs, warm_rejected = self._warm_records(warm)
            new_recs.update(recs)
            rejected.extend(warm_rejected)
        committed = set(new_recs)
        if committed:
            first = new_recs[next(iter(committed))]["draws"]
            # the per-series unpack state() runs (its signature lands in
            # the attach window, like the JAX package's pre-warm)
            self._note_signature("unpack", tuple(first.shape), str(first.dtype))

        # ---- commit ----
        if committed:
            self.n_draws = n_draws
        n_degraded_fits += sum(
            1 for sid, _, _, _, _, unhealthy in resolved if unhealthy and sid in committed
        )
        for _ in range(n_degraded_fits):
            self.metrics.note_degraded_attach()
        if rejected:
            self.metrics.note_rejected_attach(len(rejected))
        if committed:
            self._draws_cache = {
                k: v for k, v in self._draws_cache.items() if not committed.intersection(k)
            }
        for series_id in keeps:
            rec = self._series[series_id]
            rec["rejected_fits"] = rec.get("rejected_fits", 0) + 1
        self._series.update(new_recs)
        if self._lanes is not None and new_recs:
            # a committed attach replaces filter state: stale mappings
            # die, warm replays' stashed banks become the resident carry
            by_bank: Dict[int, Tuple[CarryBank, Dict[str, int]]] = {}
            for series_id, rec in new_recs.items():
                self._lanes.drop(series_id)
                stash = rec.pop("_bank", None)
                if stash is not None:
                    bank, slot = stash
                    ent = by_bank.setdefault(id(bank), (bank, {}))
                    ent[1][series_id] = slot
            for bank, mapping in by_bank.values():
                self._lanes.commit(bank, mapping)
                if self._carry_slots_cap is not None:
                    self._enforce_carry_budget(bank)
            self.metrics.note_carry_bytes(self._lanes.resident_bytes())
        for series_id in list(committed) + keeps:
            t = tenant_by_sid.get(series_id)
            if t is not None:
                self._tenant_of[series_id] = str(t)
                self._tenant_of.move_to_end(series_id)
        while len(self._tenant_of) > TENANT_BINDINGS_CAP:
            self._tenant_of.popitem(last=False)
        now = obs_request.now()
        for series_id in new_recs:
            self._attach_t[series_id] = now
            self._attach_gen[series_id] = self._attach_gen.get(series_id, 0) + 1
            # a new draw bank resets adaptation weights (submit's warm
            # page-in restores them around this)
            self._weights.pop(series_id, None)
        for series_id in keeps:
            self._attach_t.setdefault(series_id, now)
        if self._attach_t:
            self._oldest_attach_t = min(self._attach_t.values())
        if self.pager is not None:
            for series_id, _, _, _, use, _ in resolved:
                if series_id in committed:
                    self.pager.admit(series_id, use)
        if committed:
            self._refresh_compile_count()
        return rejected

    def _snapshot_reject_reason(self, series_id: str, use: PosteriorSnapshot,
                                n_draws: Optional[int]) -> Optional[str]:
        """Why this snapshot cannot serve here, or None if it can."""
        if self._model_spec is not None and use.spec != self._model_spec:
            return (
                f"snapshot for {series_id!r} was fitted with {use.spec}, "
                f"but this scheduler serves {self._model_spec}"
            )
        draws = np.asarray(use.draws)
        if draws.ndim != 2:
            return f"snapshot draws must be [D, dim], got {draws.shape}"
        if draws.shape[1] != self.model.n_free:
            return (
                f"snapshot for {series_id!r} has dim {draws.shape[1]}; "
                f"the serving model has n_free={self.model.n_free}"
            )
        if n_draws is not None and draws.shape[0] != n_draws:
            return (
                f"snapshot for {series_id!r} carries {draws.shape[0]} draws; "
                f"this scheduler serves {n_draws} (fixed for compile "
                "stability — thin with snapshot_from_fit(n_draws=...))"
            )
        return None

    def _warm_records(self, warm):
        """The padded history replays, grouped by history keyset:
        ``(records, rejected)``; a chunk whose replay raises rejects its
        own items only."""
        out: Dict[str, Dict[str, Any]] = {}
        rejected: List[Tuple[str, str]] = []
        groups: Dict[Tuple[str, ...], list] = {}
        for series_id, draws, degraded, h in warm:
            keys = tuple(sorted(h.keys()))
            lengths = {k: np.asarray(h[k]).shape[0] for k in keys}
            if len(set(lengths.values())) != 1:
                rejected.append((
                    series_id,
                    f"history for {series_id!r} has inconsistent lengths across keys: {lengths}",
                ))
                continue
            groups.setdefault(keys, []).append((series_id, draws, degraded, h))
        for keys, group in groups.items():
            max_t = max(np.asarray(h[keys[0]]).shape[0] for _, _, _, h in group)
            T_pad = -(-max_t // self.history_pad) * self.history_pad
            for c0 in range(0, len(group), self.buckets[-1]):
                chunk = group[c0 : c0 + self.buckets[-1]]
                try:
                    out.update(self._replay_chunk(chunk, list(keys), T_pad))
                except Exception as e:  # degrade the chunk, not the batch
                    reason = f"warm replay failed: {type(e).__name__}: {e}"
                    rejected.extend((s, reason) for s, _, _, _ in chunk)
        return out, rejected

    def _replay_chunk(self, chunk, keys, T_pad) -> Dict[str, Dict[str, Any]]:
        lanes = self._pad_lanes(chunk)
        bn = len(lanes)
        data_b: Dict[str, torch.Tensor] = {}
        mask = None
        for k in keys:
            padded, m = pad_ragged([np.asarray(h[k]) for _, _, _, h in lanes], length=T_pad)
            data_b[k] = torch.as_tensor(padded.astype(_canon_dtype(padded.dtype)), device=self.device)
            mask = m
        data_b["mask"] = torch.as_tensor(mask, device=self.device)
        draws_b = torch.stack([d for _, d, _, _ in lanes])
        with span("serve.replay") as sp:
            sp.annotate(bucket=bn, T_pad=T_pad, sharded=False)
            alpha, ll, okd = self._replay_impl(self._unpack_params(draws_b), data_b)
            _sync(self.device)
        self._note_signature("replay", bn, (T_pad,) + tuple(str(data_b[k].dtype) for k in keys))
        out: Dict[str, Dict[str, Any]] = {}
        bank = None
        if self._lanes is not None:
            # the replay's padded outputs are the carry this attach warms;
            # attach_many's commit maps them into the lane table
            bank = CarryBank(alpha, ll, okd, tuple(s for s, _, _, _ in lanes))
        for i, (series_id, draws, degraded, _) in enumerate(chunk):
            rec = {
                "draws": draws,
                "alpha": alpha[i],
                "ll": ll[i],
                "ok": okd[i],
                "degraded_attach": degraded,
                "rejected_fits": 0,
            }
            if bank is not None:
                rec["alpha"] = rec["ll"] = rec["ok"] = _RESIDENT
                rec["_bank"] = (bank, i)
            out[series_id] = rec
        return out

    # ---- detach / paging ----

    def detach(self, series_id: str) -> bool:
        """Release the series' holdings on the card: its record (draw
        bank, stream state), staleness entry, cached lane stacks, queued
        ticks (shed, counted) and pager residency. The history tail, the
        tenant binding and the adaptation weights survive (the warm
        page-in source). False when the series was not attached."""
        rec = self._series.pop(series_id, None)
        self._pending_count.pop(series_id, None)
        if self.pager is not None:
            self.pager.discard(series_id)
        if rec is None:
            return False
        self._lane_drop(series_id)
        if rec.get("rejuvenated"):
            # a page-in restores the ORIGINAL draws: weights learned on
            # the rejuvenated cloud would not match them
            self._weights.pop(series_id, None)
        self._attach_t.pop(series_id, None)
        self._oldest_attach_t = min(self._attach_t.values()) if self._attach_t else None
        self._draws_cache = {k: v for k, v in self._draws_cache.items() if series_id not in k}
        if any(p[0] == series_id for p in self._pending):
            keep = []
            for p in self._pending:
                if p[0] == series_id:
                    self._dec_tenant(p[3])
                    self._shed_now(p[0], p[2], "series detached", tenant=p[3], trace=p[4])
                else:
                    keep.append(p)
            self._pending = keep
        if self.events is not None:
            self.events.forget(series_id)
        return True

    def unregister(self, series_id: str) -> bool:
        """:meth:`detach` plus everything detach keeps: the history tail,
        the tenant binding, the attach generation and the adaptation
        weights. True if anything was released."""
        released = self.detach(series_id)
        released = self._drop_tail(series_id) or released
        self.metrics.note_tail_bytes(self._tail_bytes)
        released = (self._tenant_of.pop(series_id, None) is not None) or released
        released = (self._attach_gen.pop(series_id, None) is not None) or released
        released = (self._weights.pop(series_id, None) is not None) or released
        return released

    def _drop_tail(self, series_id: str) -> bool:
        tail = self._tail.pop(series_id, None)
        if tail is None:
            return False
        self._tail_bytes -= sum(nb for _, nb in tail)
        return True

    def _tail_append(self, series_id: str, obs_i: Dict[str, Any]) -> None:
        """Fold one observation into the series' tail ring (``history_tail``
        entries); total bytes over ``tail_budget_bytes`` evict the
        least-recently-folded series' whole tail first."""
        tail = self._tail.get(series_id)
        if tail is None:
            tail = self._tail[series_id] = deque(maxlen=self.history_tail)
        entry = dict(obs_i)
        nb = _obs_nbytes(entry)
        if tail.maxlen is not None and len(tail) == tail.maxlen and tail:
            self._tail_bytes -= tail[0][1]
        tail.append((entry, nb))
        self._tail_bytes += nb
        self._tail.move_to_end(series_id)
        while self._tail_bytes > self.tail_budget_bytes and len(self._tail) > 1:
            victim = next(iter(self._tail))
            if victim == series_id:
                break
            self._drop_tail(victim)
            self._tail_evictions += 1
            self.metrics.note_tail_eviction()
        self.metrics.note_tail_bytes(self._tail_bytes)

    def tail_stats(self) -> Dict[str, int]:
        """Host-byte accounting of the retained history tails."""
        return {
            "series": len(self._tail),
            "bytes": int(self._tail_bytes),
            "budget_bytes": int(self.tail_budget_bytes),
            "evictions": int(self._tail_evictions),
        }

    # ---- ticking ----

    def _resp_K(self) -> int:
        """Width of a synthesised (shed) response: the served filter width
        (``n_states = K * Dmax`` for an expanded-state model)."""
        K = getattr(self.model, "n_states", None) or getattr(self.model, "K", None)
        if K:
            return int(K)
        for sid, rec in self._series.items():
            if rec["alpha"] is not None:
                carry = self._carry_of(sid)
                if carry is not None:
                    return int(carry[0].shape[-1])
        return 1

    def _make_shed(self, series_id: str, t_submit: float, error: str) -> TickResponse:
        """A degraded-not-raised outcome: the observation was NOT folded;
        ``probs`` are NaN."""
        return TickResponse(
            series_id=series_id,
            probs=np.full(self._resp_K(), np.nan),
            loglik=float("nan"),
            healthy_draws=0,
            degraded=True,
            latency_s=obs_request.now() - t_submit,
            shed=True,
            error=error,
        )

    def _note_event(self, series_id: str, tenant: str, resp) -> None:
        """Feed one committed, non-degraded response to the event feed
        (expanded-state probabilities collapsed to regimes first); any
        failure is counted and swallowed."""
        if self.events is None or resp.degraded:
            return
        try:
            probs = np.asarray(resp.probs, dtype=np.float64)
            if self._event_dmax > 1 and probs.shape[-1] % self._event_dmax == 0:
                probs = collapse_probs(probs, self._event_dmax)
            evs = self.events.observe(
                series_id, tenant, probs, resp.loglik,
                generation=self._attach_gen.get(series_id, 0),
            )
            if evs and self.recorder.enabled():
                for ev in evs:
                    self.recorder.note_event(ev.tenant, ev.kind)
        except Exception:
            obs_metrics.counter("serve.events_errors").inc()

    def _shed_now(self, series_id: str, t_submit: float, error: str,
                  tenant: Optional[str] = None, trace=None) -> None:
        label = trace.tenant if trace is not None else tenant
        self.metrics.note_shed_tick(tenant=label)
        self.recorder.shed(trace, error)
        self._undelivered.append(self._make_shed(series_id, t_submit, error))
        # the parked-response buffer is capacity-bounded too
        pol = self.admission
        if pol is not None and pol.max_queue_depth is not None:
            cap = 4 * pol.max_queue_depth
            while len(self._undelivered) > cap:
                self._undelivered.pop(0)
                self.metrics.note_superseded_response()

    def _shed_oldest(self, tenant: Optional[str], reason: str) -> None:
        """Shed the oldest pending tick (of ``tenant``, or overall): for a
        filter the newest observation is the valuable one."""
        for i, p in enumerate(self._pending):
            if tenant is None or p[3] == tenant:
                del self._pending[i]
                self._dec_pending(p[0])
                self._dec_tenant(p[3])
                # a pressure-shed tick earns the tenant DRR credit
                self._credit_accrue(p[3], 1.0)
                self._shed_now(p[0], p[2], f"shed under pressure ({reason})",
                               tenant=p[3], trace=p[4])
                return

    # ---- tenant-fair flush order (weighted deficit round-robin) ----

    def _credit_cap(self, pol: AdmissionPolicy) -> float:
        cap = pol.credit_cap_ticks
        if cap is None:
            cap = pol.max_ticks_per_flush
        if cap is None:
            cap = self.buckets[-1]
        return float(cap)

    def _credit_accrue(self, tenant: str, amount: float = 1.0) -> None:
        pol = self.admission
        if pol is None or pol.flush_order != "drr":
            return
        cap = self._credit_cap(pol)
        self._credit[tenant] = min(cap, self._credit.get(tenant, 0.0) + amount)
        self._credit.move_to_end(tenant)
        while len(self._credit) > CREDIT_TABLE_CAP:
            self._credit.popitem(last=False)

    def _drr_drain(self, budget: int, pol: AdmissionPolicy):
        """Select ``budget`` pending ticks by weighted deficit round-robin;
        the drained list keeps arrival order."""
        pend = self._pending
        selected = self._drr_select(pend, budget, pol)
        drained = [p for i, p in enumerate(pend) if selected[i]]
        self._pending = [p for i, p in enumerate(pend) if not selected[i]]
        return drained

    def _drr_select(self, pend, budget: int, pol: AdmissionPolicy) -> List[bool]:
        """DRR selection over an explicit pending list: entitlement a
        tenant = budget * share / total share + banked credit (capped);
        phase 1 serves entitlements round-robin, phase 2 drains the
        earliest eligible ticks (work-conserving). A tick is eligible
        only as its series' earliest unselected tick. Banks the credit
        and records the flush plan."""
        shares = pol.tenant_shares or {}
        by_tenant: "OrderedDict[str, deque]" = OrderedDict()
        series_next: Dict[str, deque] = {}
        for i, p in enumerate(pend):
            by_tenant.setdefault(p[3], deque()).append(i)
            series_next.setdefault(p[0], deque()).append(i)
        total_w = sum(max(1e-9, float(shares.get(t, 1.0))) for t in by_tenant)
        cap = self._credit_cap(pol)
        ent: Dict[str, float] = {}
        for t in by_tenant:
            w = max(1e-9, float(shares.get(t, 1.0)))
            ent[t] = budget * w / total_w + min(cap, self._credit.get(t, 0.0))
        selected = [False] * len(pend)
        served: Dict[str, int] = {}
        n_taken = 0

        def take_one(t: str) -> bool:
            q = by_tenant[t]
            for i in q:
                if series_next[pend[i][0]][0] == i:
                    q.remove(i)
                    series_next[pend[i][0]].popleft()
                    selected[i] = True
                    ent[t] -= 1.0
                    served[t] = served.get(t, 0) + 1
                    return True
            return False

        progress = True
        while n_taken < budget and progress:
            progress = False
            for t in list(by_tenant):
                if n_taken >= budget:
                    break
                if ent[t] >= 1.0 and by_tenant[t] and take_one(t):
                    n_taken += 1
                    progress = True
        while n_taken < budget:
            best: Optional[str] = None
            for t in by_tenant:
                q = by_tenant[t]
                if q and (best is None or q[0] < by_tenant[best][0]):
                    best = t
            if best is None or not take_one(best):
                break
            n_taken += 1
        stranded = {t: len(q) for t, q in by_tenant.items() if q}
        for t in by_tenant:
            if t in stranded:
                self._credit[t] = min(cap, max(0.0, ent[t]))
                self._credit.move_to_end(t)
            else:
                self._credit.pop(t, None)
        while len(self._credit) > CREDIT_TABLE_CAP:
            self._credit.popitem(last=False)
        if self.recorder.enabled():
            served_ord: "OrderedDict[str, int]" = OrderedDict()
            for t in by_tenant:
                if served.get(t):
                    served_ord[t] = served[t]
            self._record_flush_plan(pol, "drr", served_ord, stranded)
        return selected

    def _record_flush_plan(self, pol: Optional[AdmissionPolicy], order: str,
                           served: Mapping[str, int], stranded: Mapping[str, int]) -> None:
        """Hand the flush's scheduling decision to the request plane."""
        if not self.recorder.enabled():
            return
        shares = (pol.tenant_shares if pol is not None else None) or {}
        entries = []
        for t in served:
            entries.append({
                "tenant": t,
                "share": float(shares.get(t, 1.0)),
                "served": int(served[t]),
                "stranded": int(stranded.get(t, 0)),
                "credit": float(self._credit.get(t, 0.0)),
            })
        for t in stranded:
            if t not in served:
                entries.append({
                    "tenant": t,
                    "share": float(shares.get(t, 1.0)),
                    "served": 0,
                    "stranded": int(stranded[t]),
                    "credit": float(self._credit.get(t, 0.0)),
                })
        cap = self._credit_cap(pol) if pol is not None else 0.0
        self.recorder.note_flush_plan(order, entries, credit_cap=cap)

    def _dec_pending(self, series_id: str) -> None:
        n = self._pending_count.get(series_id, 0) - 1
        if n <= 0:
            self._pending_count.pop(series_id, None)
            if self.pager is not None:
                self.pager.unpin(series_id)
        else:
            self._pending_count[series_id] = n

    def _dec_tenant(self, tenant: str) -> None:
        n = self._pending_tenant_count.get(tenant, 0) - 1
        if n <= 0:
            self._pending_tenant_count.pop(tenant, None)
        else:
            self._pending_tenant_count[tenant] = n

    def submit(self, series_id: str, obs: Dict[str, Any], tenant: Optional[str] = None) -> None:
        """Queue one tick for ``series_id`` (runs at the next flush).
        ``obs``: the model's data keys for one tick (``{"x": 4, "sign":
        1}`` for Tayal). ``tenant``: the request-plane key (None: the
        attach-time tenant, else the series id). An unknown series sheds
        — or, with a pager and a registered snapshot, pages in (warm from
        its retained tail when there is one); admission pressure sheds
        oldest-first. Never raises."""
        now = obs_request.now()
        if tenant is None:
            bound = self._tenant_of.get(series_id)
            if bound is None:
                tenant = series_id
            else:
                tenant = bound
                self._tenant_of.move_to_end(series_id)
        trace = self.recorder.enqueue(series_id, tenant)
        if series_id not in self._series:
            if self.pager is None:
                self._shed_now(series_id, now, "series not attached", tenant=tenant, trace=trace)
                return
            cap = None if self.admission is None else self.admission.max_series
            if cap is not None and len(self._series) >= cap:
                # shed BEFORE loading: an over-cap page-in must not pay
                # the registry read or evict an attached series
                self._shed_now(series_id, now,
                               f"admission: max_series={cap} in-flight series reached",
                               tenant=tenant, trace=trace)
                return
            snap = self.pager.load(series_id)
            if snap is None:
                self._shed_now(series_id, now, "no servable snapshot to page in",
                               tenant=tenant, trace=trace)
                return
            hist = self.history_tail_of(series_id)
            wstate = self._weights.get(series_id)
            rej = self.attach_many([(series_id, snap, hist)])
            if rej:
                self._shed_now(series_id, now, f"page-in attach rejected: {rej[0][1]}",
                               tenant=tenant, trace=trace)
                return
            if wstate is not None:
                self._weights[series_id] = wstate
                self._weights.move_to_end(series_id)
            if hist is not None:
                self.metrics.note_warm_page_in()
        pol = self.admission
        if pol is not None:
            q = pol.max_pending_per_series
            if q is not None and self._pending_tenant_count.get(tenant, 0) >= q:
                self._shed_oldest(tenant, f"per-tenant quota {q} (tenant={tenant!r})")
            d = pol.max_queue_depth
            if d is not None and len(self._pending) >= d:
                self._shed_oldest(None, f"queue depth {d}")
        self._pending.append((series_id, obs, now, tenant, trace))
        self._pending_count[series_id] = self._pending_count.get(series_id, 0) + 1
        self._pending_tenant_count[tenant] = self._pending_tenant_count.get(tenant, 0) + 1
        if self.pager is not None:
            self.pager.pin(series_id)

    def tick(self, obs_by_series: Dict[str, Dict[str, Any]]) -> Dict[str, TickResponse]:
        """Submit every (series, obs) pair and flush; returns the LATEST
        response a series (older ones for the same series are counted in
        ``metrics.superseded_responses``)."""
        for series_id, obs in obs_by_series.items():
            self.submit(series_id, obs)
        out: Dict[str, TickResponse] = {}
        for r in self.flush():
            if r.series_id in out:
                self.metrics.note_superseded_response()
            out[r.series_id] = r
        return out

    def _keyset_ref(self, entries) -> Tuple[str, ...]:
        """The locked observation keyset, or before the first successful
        dispatch the majority keyset of ``entries`` (first-seen
        tiebreak)."""
        if self._obs_keys_lock is not None:
            return self._obs_keys_lock
        counts: Dict[Tuple[str, ...], int] = {}
        for p in entries:
            k = tuple(sorted(p[1].keys()))
            counts[k] = counts.get(k, 0) + 1
        return max(counts, key=counts.get)

    def _screen(self, entries, sink: list) -> list:
        """Shed (into ``sink``) the ticks whose keys do not match the
        keyset and those of series detached since submit; returns the
        rest."""
        ref = self._keyset_ref(entries)
        ok = []
        for p in entries:
            keys = tuple(sorted(p[1].keys()))
            tenant = p[4].tenant if p[4] is not None else p[3]
            if keys != ref:
                err = (f"observation keys {list(keys)} do not match "
                       f"this scheduler's locked keys {list(ref)}")
                self.metrics.note_shed_tick(tenant=tenant)
                self.recorder.shed(p[4], err)
                sink.append(self._make_shed(p[0], p[2], err))
            elif p[0] not in self._series:
                self.metrics.note_shed_tick(tenant=tenant)
                self.recorder.shed(p[4], "series detached")
                sink.append(self._make_shed(p[0], p[2], "series detached"))
            else:
                ok.append(p)
        return ok

    def _shed_failed(self, chunk, e: Exception, what: str, sink: list) -> None:
        """A group whose dispatch failed committed no state: its ticks
        become shed responses (counted; device loss noted)."""
        if _looks_like_device_loss(e):
            self.metrics.note_device_loss()
        self.metrics.note_dispatch_error(
            len(chunk), tenants=[p[4].tenant if p[4] is not None else p[3] for p in chunk])
        err = f"{type(e).__name__}: {e}"
        for p in chunk:
            self.recorder.shed(p[4], f"{what} failed ({err})")
        sink.extend(self._make_shed(s, ts, f"{what} failed ({err})") for s, _, ts, _, _ in chunk)

    @traced("serve.flush")
    def flush(self) -> List[TickResponse]:
        """Dispatch pending ticks in bucketed micro-batches, up to the
        admission policy's per-flush budget. Queued repeats of a series
        run as successive waves (submission order). Nothing that goes
        wrong per series or per group escapes: foreign keys, a failing
        dispatch, a series detached since submit — each becomes a
        ``shed=True`` response and the rest of the flush proceeds; a
        failed group's series keep their pre-tick state."""
        if self._inflight is not None:
            return self._flush_pipelined()
        carried, self._undelivered = self._undelivered, []
        if not self._pending:
            return carried
        t0 = obs_request.now()
        pol = self.admission
        budget = (len(self._pending) if pol is None or pol.max_ticks_per_flush is None
                  else int(pol.max_ticks_per_flush))
        drr = pol is not None and pol.flush_order == "drr"
        if drr and budget < len(self._pending):
            pending = self._drr_drain(budget, pol)
        else:
            pending, self._pending = self._pending[:budget], self._pending[budget:]
            if drr:
                for p in pending:
                    self._credit.pop(p[3], None)
            if self.recorder.enabled():
                served: "OrderedDict[str, int]" = OrderedDict()
                for p in pending:
                    served[p[3]] = served.get(p[3], 0) + 1
                stranded: Dict[str, int] = {}
                for p in self._pending:
                    stranded[p[3]] = stranded.get(p[3], 0) + 1
                self._record_flush_plan(pol, "drr" if drr else "fifo", served, stranded)
        for p in pending:
            self._dec_pending(p[0])
            self._dec_tenant(p[3])
        self.recorder.admit([p[4] for p in pending])
        waves: List[list] = []
        wave, seen = [], set()
        for p in pending:
            if p[0] in seen:
                waves.append(wave)
                wave, seen = [], set()
            wave.append(p)
            seen.add(p[0])
        waves.append(wave)
        responses: List[TickResponse] = []
        folded: list = []
        for wave in waves:
            ok_wave = self._screen(wave, responses)
            # a first-ever tick in wave k makes its series live for k+1
            fresh = [p for p in ok_wave if self._series[p[0]]["alpha"] is None]
            live = [p for p in ok_wave if self._series[p[0]]["alpha"] is not None]
            for group, kernel in ((fresh, "init"), (live, "update")):
                for c0 in range(0, len(group), self.buckets[-1]):
                    chunk = group[c0 : c0 + self.buckets[-1]]
                    try:
                        responses.extend(self._dispatch(chunk, kernel))
                        folded.extend(chunk)
                        if self._obs_keys_lock is None:
                            self._obs_keys_lock = tuple(sorted(chunk[0][1].keys()))
                    except Exception as e:
                        self._shed_failed(chunk, e, "dispatch", responses)
        done = obs_request.now()
        for p in folded:
            self.metrics.observe_latency(done - p[2])
        self.metrics.observe_flush(len(folded), done - t0)
        if self._oldest_attach_t is not None:
            self.metrics.observe_staleness(done - self._oldest_attach_t)
        if self.pager is not None:
            self.pager.shrink_to_budget()
        self._maybe_profile_flush()
        self.recorder.flush_done()
        self._refresh_compile_count()
        return carried + responses

    # ---- async flush pipeline ----

    def _flush_pipelined(self) -> List[TickResponse]:
        """Pipelined :meth:`flush` with synchronous semantics: each
        admissible generation dispatches and harvests at once; queued
        repeats of a series become successive generations."""
        out: List[TickResponse] = []
        pol = self.admission
        budget = (None if pol is None or pol.max_ticks_per_flush is None
                  else int(pol.max_ticks_per_flush))
        while True:
            n_flights, n_drained, n_deferred = self._dispatch_generation(budget)
            out.extend(self.harvest())
            if budget is not None:
                budget -= n_drained
                if budget <= 0:
                    break
            if n_flights == 0 or not n_deferred:
                break
        return out

    @traced("serve.dispatch_async")
    def dispatch_async(self) -> int:
        """Non-blocking dispatch of one admissible generation of pending
        ticks into per-device :class:`Flight`\\ s; returns the flights now
        in the air (0: nothing dispatchable). Pair with :meth:`harvest`;
        while a flight is in the air the host is free to submit the next
        flush's ticks."""
        if self._inflight is None:
            raise ValueError("dispatch_async() requires pipeline=True")
        n_flights, _, _ = self._dispatch_generation()
        return n_flights

    @traced("serve.harvest")
    def harvest(self, max_flights: Optional[int] = None) -> List[TickResponse]:
        """Wait for and commit the flights in the air, oldest first, plus
        any parked shed responses. The request plane's harvest stamp
        lands BEFORE the wait (dispatch → harvest is device time hidden
        behind host work, harvest → device the stall). A flight that
        fails at its wait sheds its whole group with no torn state.
        ``max_flights`` bounds the flights reaped (None: all)."""
        if self._inflight is None:
            raise ValueError("harvest() requires pipeline=True")
        carried, self._undelivered = self._undelivered, []
        t0 = obs_request.now()
        responses: List[TickResponse] = []
        folded: list = []
        n = 0
        while max_flights is None or n < max_flights:
            flight = self._inflight.pop_oldest()
            if flight is None:
                break
            n += 1
            self.recorder.note_harvest(flight.flush_id)
            try:
                if flight.event is not None:
                    flight.event.synchronize()
            except Exception as e:
                self._shed_failed(flight.group, e, "flight", responses)
                continue
            resp, committed = self._commit_flight(flight)
            responses.extend(resp)
            folded.extend(committed)
        if n:
            done = obs_request.now()
            for p in folded:
                self.metrics.observe_latency(done - p[2])
            self.metrics.observe_flush(len(folded), done - t0)
            if self._oldest_attach_t is not None:
                self.metrics.observe_staleness(done - self._oldest_attach_t)
            if self.pager is not None:
                self.pager.shrink_to_budget()
            self.recorder.flush_done()
            self._refresh_compile_count()
        return carried + responses

    def _dispatch_generation(self, budget: Optional[int] = None) -> Tuple[int, int, int]:
        """One async generation: drain admissible pending ticks — one per
        series; a series with an unharvested flight, and later ticks of a
        series, wait — fan them out per placement device and launch one
        flight per bucket chunk. Returns ``(n_flights, n_drained,
        n_deferred)``."""
        pend = self._pending
        if not pend:
            return (0, 0, 0)
        pol = self.admission
        guard = self._inflight.series_in_flight()
        eligible, emap = [], []
        seen: set = set()
        for i, p in enumerate(pend):
            if p[0] in guard or p[0] in seen:
                continue
            seen.add(p[0])
            eligible.append(p)
            emap.append(i)
        n_deferred = len(pend) - len(eligible)
        if n_deferred:
            self._deferred_inflight += n_deferred
            self.metrics.note_inflight_deferred(n_deferred)
        if not eligible:
            return (0, 0, n_deferred)
        if budget is None:
            budget = (len(eligible) if pol is None or pol.max_ticks_per_flush is None
                      else int(pol.max_ticks_per_flush))
        budget = max(0, min(int(budget), len(eligible)))
        if budget == 0:
            return (0, 0, n_deferred)
        drr = pol is not None and pol.flush_order == "drr"
        split = self._placement.split(eligible, key=lambda p: p[0])
        order = sorted(split)
        # work-conserving budget split across devices
        shares: Dict[int, int] = {d: 0 for d in order}
        hungry = {d: len(split[d]) for d in order}
        remaining = budget
        while remaining > 0:
            active = [d for d in order if hungry[d] > 0]
            if not active:
                break
            per = max(1, remaining // len(active))
            for d in active:
                take = min(per, hungry[d], remaining)
                shares[d] += take
                hungry[d] -= take
                remaining -= take
                if remaining <= 0:
                    break
        taken_pend: set = set()
        drained_by_dev: Dict[int, list] = {}
        n_drained = 0
        for d in order:
            pairs = split[d]
            share = shares[d]
            if share <= 0:
                continue
            entries = [p for _, p in pairs]
            if drr and share < len(entries):
                sel = self._drr_select(entries, share, pol)
            else:
                sel = [i < share for i in range(len(entries))]
                if drr:
                    for p in entries[:share]:
                        self._credit.pop(p[3], None)
                if self.recorder.enabled():
                    served: "OrderedDict[str, int]" = OrderedDict()
                    for p in entries[:share]:
                        served[p[3]] = served.get(p[3], 0) + 1
                    stranded: Dict[str, int] = {}
                    for p in entries[share:]:
                        stranded[p[3]] = stranded.get(p[3], 0) + 1
                    self._record_flush_plan(pol, "drr" if drr else "fifo", served, stranded)
            dev_list = []
            for (ei, p), s in zip(pairs, sel):
                if s:
                    taken_pend.add(emap[ei])
                    dev_list.append(p)
            if dev_list:
                drained_by_dev[d] = dev_list
                n_drained += len(dev_list)
        if not n_drained:
            return (0, 0, n_deferred)
        self._pending = [p for i, p in enumerate(pend) if i not in taken_pend]
        drained_all = [p for d in order for p in drained_by_dev.get(d, ())]
        for p in drained_all:
            self._dec_pending(p[0])
            self._dec_tenant(p[3])
        self.recorder.admit([p[4] for p in drained_all])
        n_flights = 0
        for d in order:
            group_d = drained_by_dev.get(d)
            if group_d:
                n_flights += self._launch_device(d, group_d)
        return (n_flights, n_drained, n_deferred)

    def _launch_device(self, device_index: int, drained: list) -> int:
        """Screen one device's drained ticks, split fresh / live, and
        launch one flight a bucket chunk; a chunk whose launch fails
        sheds at once (nothing committed)."""
        ok_list = self._screen(drained, self._undelivered)
        fresh = [p for p in ok_list if self._series[p[0]]["alpha"] is None]
        live = [p for p in ok_list if self._series[p[0]]["alpha"] is not None]
        n_flights = 0
        for group, kernel in ((fresh, "init"), (live, "update")):
            for c0 in range(0, len(group), self.buckets[-1]):
                chunk = group[c0 : c0 + self.buckets[-1]]
                try:
                    flight = self._dispatch_begin(chunk, kernel, device_index)
                except Exception as e:
                    self._shed_failed(chunk, e, "dispatch", self._undelivered)
                    continue
                self._inflight.add(flight)
                self.recorder.begin_flight(flight.flush_id, flight.traces)
                n_flights += 1
        return n_flights

    def _stage(self, group, kernel: str, device: torch.device):
        """Form one bucket micro-batch on ``device``: ``(lanes, obs_b,
        dtype_locks, fn, fargs, lane_key, h2d_bytes)``. The dtype locks
        commit only after the dispatch succeeds."""
        lanes = self._pad_lanes(group)
        traces = [p[4] for p in group]
        self.recorder.stage(traces, "bucket")
        obs_keys = sorted(group[0][1].keys())
        obs_b: Dict[str, torch.Tensor] = {}
        dtype_locks: Dict[str, np.dtype] = {}
        h2d = 0
        for k in obs_keys:
            host = np.stack([np.asarray(p[1][k]) for p in lanes])
            dt = _canon_dtype(host.dtype)
            # one dtype a key: numpy and Python scalars of the same
            # domain share a signature; a widening drift (int ticks,
            # then float) promotes once, visibly; never narrows
            locked = self._obs_dtypes.get(k)
            if locked is None:
                dtype_locks[k] = dt
            else:
                promoted = _promote(locked, dt)
                if promoted != locked:
                    dtype_locks[k] = promoted
                dt = dtype_locks.get(k, locked)
            if host.dtype != dt:
                host = host.astype(dt)
            h2d += host.nbytes
            obs_b[k] = _h2d(host, device)
        lane_key = tuple(p[0] for p in lanes)
        cached = self._draws_cache.get(lane_key)
        if cached is None:
            if len(self._draws_cache) >= 64:  # bound churny memberships
                self._draws_cache.clear()
            draws_b = torch.stack([self._series[s]["draws"] for s in lane_key])
            draws_b = draws_b.to(device, non_blocking=True)
            cached = (draws_b, self._unpack_params(draws_b))
            self._draws_cache[lane_key] = cached
        params_b = cached[1]
        # the traffic fault surface: a simulated device loss fires here,
        # inside the dispatch the flush path degrades
        faults.dispatch_fault()
        if kernel == "init":
            fn, fargs = self._init_impl, (params_b, obs_b)
        elif self._lanes is not None:
            alpha_b, ll_b, ok_b, staged = self._form_carry(lanes, device)
            h2d += staged
            fn, fargs = self._update_impl, (params_b, alpha_b, ll_b, ok_b, obs_b)
        else:
            alpha_b = torch.stack([self._series[p[0]]["alpha"] for p in lanes]).to(device, non_blocking=True)
            ll_b = torch.stack([self._series[p[0]]["ll"] for p in lanes]).to(device, non_blocking=True)
            ok_b = torch.stack([self._series[p[0]]["ok"] for p in lanes]).to(device, non_blocking=True)
            h2d += int(alpha_b.nbytes + ll_b.nbytes + ok_b.nbytes)
            fn, fargs = self._update_impl, (params_b, alpha_b, ll_b, ok_b, obs_b)
        return lanes, obs_b, dtype_locks, fn, fargs, lane_key, h2d

    def _dispatch_begin(self, group, kernel: str, device_index: int) -> Flight:
        """Form one device's micro-batch and LAUNCH the tick without
        waiting: the response rows go to fresh pinned host tensors by a
        non-blocking copy, and a CUDA event recorded after it is what
        :meth:`harvest` waits on (fresh buffers a flight, so no buffer
        is reused before its copy completed)."""
        device = (self._pipe_devices[device_index]
                  if device_index < len(self._pipe_devices) else self.device)
        traces = [p[4] for p in group]
        with span(f"serve.dispatch.{kernel}") as sp:
            sp.annotate(bucket=self._bucket_for(len(group)), device=device_index, pipelined=True)
            lanes, obs_b, dtype_locks, fn, fargs, lane_key, h2d = self._stage(group, kernel, device)
            self.recorder.stage(traces, "dispatch")
            outputs = fn(*fargs)
            n = len(group)
            rows = (outputs[3][:n], outputs[4][:n], outputs[5][:n], outputs[2][:n])
            if device.type == "cuda":
                host = tuple(torch.empty(r.shape, dtype=r.dtype, pin_memory=True) for r in rows)
                for h, r in zip(host, rows):
                    h.copy_(r, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(device))
            else:
                host, event = rows, None
        return Flight(
            flush_id=self._inflight.next_id(),
            kernel=kernel,
            bucket=len(lanes),
            device_index=device_index,
            group=list(group),
            traces=traces,
            outputs=outputs,
            dtype_locks=dtype_locks,
            fn=fn,
            fargs=fargs,
            t_dispatch=obs_request.now(),
            lane_key=lane_key,
            h2d_bytes=h2d,
            event=event,
            host=host,
        )

    def _commit_flight(self, flight: Flight) -> Tuple[List[TickResponse], list]:
        """Commit one waited-for flight — dtype locks, keyset lock, filter
        state, history tails, responses — the commit the sync path runs
        inline. A series detached between dispatch and harvest sheds its
        lane."""
        alpha, ll, okd = flight.outputs[:3]
        self._obs_dtypes.update(flight.dtype_locks)
        if self._obs_keys_lock is None and flight.group:
            self._obs_keys_lock = tuple(sorted(flight.group[0][1].keys()))
        obs_b = flight.fargs[-1]
        self._note_signature(flight.kernel, flight.bucket,
                             tuple(str(obs_b[k].dtype) for k in sorted(obs_b)))
        done = obs_request.now()
        self.recorder.stage(flight.traces, "device", t=done)
        probs_h, mean_ll_h, inc_h, okd_h = (h.numpy() for h in flight.host)
        d2h = int(probs_h.nbytes + mean_ll_h.nbytes + inc_h.nbytes + okd_h.nbytes)
        if self._lanes is not None:
            self._commit_carry(alpha, ll, okd, flight.lane_key, flight.group,
                               device_index=flight.device_index)
        responses: List[TickResponse] = []
        committed: list = []
        committed_traces: list = []
        for i, (series_id, obs_i, t_submit, tenant, trace) in enumerate(flight.group):
            rec = self._series.get(series_id)
            if rec is None:
                self.metrics.note_shed_tick(tenant=trace.tenant if trace is not None else tenant)
                self.recorder.shed(trace, "series detached in flight")
                responses.append(self._make_shed(series_id, t_submit, "series detached in flight"))
                continue
            if self._lanes is None:
                rec["alpha"], rec["ll"], rec["ok"] = alpha[i], ll[i], okd[i]
            responses.append(self._respond(series_id, obs_i, t_submit, tenant, rec, done,
                                           probs_h[i], mean_ll_h[i], inc_h[i], okd_h[i]))
            committed.append(flight.group[i])
            committed_traces.append(trace)
        self.metrics.note_h2d_bytes(flight.h2d_bytes)
        self.metrics.note_d2h_bytes(d2h)
        self.recorder.note_transfers(flight.h2d_bytes, d2h)
        self._dev_served[flight.device_index] = (
            self._dev_served.get(flight.device_index, 0) + len(committed))
        self.recorder.complete_group(committed_traces, kernel=flight.kernel, bucket=flight.bucket)
        return responses, committed

    def _respond(self, series_id, obs_i, t_submit, tenant, rec, done,
                 probs, mean_ll, inc, okd) -> TickResponse:
        """One committed lane's response (tail append, degraded count,
        event feed)."""
        if self.history_tail:
            self._tail_append(series_id, obs_i)
        n_ok = int(okd.sum())
        degraded = bool(rec["degraded_attach"]) or n_ok == 0
        if degraded:
            self.metrics.note_degraded_response()
        resp = TickResponse(
            series_id=series_id,
            probs=probs,
            loglik=float(mean_ll),
            healthy_draws=n_ok,
            degraded=degraded,
            latency_s=done - t_submit,
            per_draw_loglik=inc,
            draw_ok=okd,
        )
        self._note_event(series_id, tenant, resp)
        return resp

    def pipeline_stats(self) -> Optional[Dict[str, Any]]:
        """In-flight table counters, per-device served lanes, deferred
        ticks and the placement stanza (None without ``pipeline=True``)."""
        if self._inflight is None:
            return None
        st: Dict[str, Any] = dict(self._inflight.stats())
        st["n_devices"] = self._placement.n_devices
        st["per_device_served"] = {
            str(d): int(self._dev_served.get(d, 0)) for d in range(self._placement.n_devices)
        }
        st["deferred_ticks"] = int(self._deferred_inflight)
        st["placement"] = self._placement.stanza()
        return st

    def _maybe_profile_flush(self) -> None:
        """Sampled flush profiling: every ``profile_every``-th flush with
        a dispatch re-times it through ``obs.profile.device_time`` on the
        same inputs (CUDA events on the card). Only with the tracer on;
        never raises into the tick path."""
        if not self.profile_every or self._last_dispatch is None:
            return
        if not trace_enabled():
            self._last_dispatch = None
            return
        self._profile_seq += 1
        if self._profile_seq % self.profile_every:
            return
        kernel, bucket, fn, fargs = self._last_dispatch
        self._last_dispatch = None
        try:
            timing = obs_profile.device_time(fn, *fargs, reps=2, warmup=False)
        except Exception:
            return
        self.metrics.note_flush_profile(kernel, bucket, timing.p50_s)
        self.recorder.note_device_time(kernel, bucket, timing.p50_s)
        with span("serve.flush_profile") as sp:
            sp.annotate(kernel=kernel, bucket=bucket, p50_ms=round(timing.p50_s * 1e3, 4))

    def _dispatch(self, group, kernel: str) -> List[TickResponse]:
        """One synchronous bucket dispatch and its commit."""
        if not group:
            return []
        traces = [p[4] for p in group]
        with span(f"serve.dispatch.{kernel}") as sp:
            sp.annotate(bucket=self._bucket_for(len(group)), sharded=False)
            lanes, obs_b, dtype_locks, fn, fargs, lane_key, h2d = self._stage(
                group, kernel, self.device)
            self.recorder.stage(traces, "dispatch")
            alpha, ll, okd, probs, mean_ll, inc = fn(*fargs)
            _sync(self.device)
        bn = len(lanes)
        self._obs_dtypes.update(dtype_locks)  # the dispatch succeeded
        if self.profile_every and trace_enabled():
            self._last_dispatch = (kernel, bn, fn, fargs)
        self._note_signature(kernel, bn, tuple(str(obs_b[k].dtype) for k in sorted(obs_b)))
        done = obs_request.now()
        self.recorder.stage(traces, "device", t=done)
        n = len(group)
        # the response surface comes down batched: one copy a tensor
        probs_h = probs[:n].cpu().numpy()
        mean_ll_h = mean_ll[:n].cpu().numpy()
        inc_h = inc[:n].cpu().numpy()
        okd_h = okd[:n].cpu().numpy()
        d2h = int(probs_h.nbytes + mean_ll_h.nbytes + inc_h.nbytes + okd_h.nbytes)
        if self._lanes is not None:
            self._commit_carry(alpha, ll, okd, lane_key, group)
        responses = []
        for i, (series_id, obs_i, t_submit, tenant, _) in enumerate(group):
            rec = self._series[series_id]
            if self._lanes is None:
                rec["alpha"], rec["ll"], rec["ok"] = alpha[i], ll[i], okd[i]
            responses.append(self._respond(series_id, obs_i, t_submit, tenant, rec, done,
                                           probs_h[i], mean_ll_h[i], inc_h[i], okd_h[i]))
        self.metrics.note_h2d_bytes(h2d)
        self.metrics.note_d2h_bytes(d2h)
        self.recorder.note_transfers(h2d, d2h)
        self.recorder.complete_group(traces, kernel=kernel, bucket=bn)
        return responses

    # ---- maintenance surface ----

    def history_tail_of(self, series_id: str) -> Optional[Dict[str, Any]]:
        """The series' recent folded observations as a dict of stacked
        per-key arrays ``[L]`` (the ``attach(history=...)`` shape); None
        while the ring is off or empty."""
        tail = self._tail.get(series_id)
        if not tail:
            return None
        keys = sorted(tail[0][0].keys())
        return {k: np.asarray([o[k] for o, _ in tail]) for k in keys}

    def attach_generation(self, series_id: str) -> int:
        """How many times this series' filter state was replaced by a
        committed attach (0: never attached; not reset on detach)."""
        return self._attach_gen.get(series_id, 0)

    def staleness_of(self, series_id: str) -> float:
        """Seconds since the series' serving posterior was last attached
        (NaN when not attached)."""
        t = self._attach_t.get(series_id)
        return float("nan") if t is None else obs_request.now() - t

    def swap_snapshot(self, series_id: str, name: Optional[str] = None, history="auto",
                      snapshot: Optional[PosteriorSnapshot] = None) -> Optional[str]:
        """Swap one attached series onto the snapshot serving under
        ``name`` (alias-resolved; default: the series' own name), or onto
        ``snapshot``: an in-place re-attach warm-started from the series'
        tail (``history="auto"``). None on success, else the reason (a
        failed or quarantine-kept swap leaves the serving state
        untouched)."""
        if snapshot is not None:
            snap = snapshot
        else:
            if self.registry is None:
                return "no registry attached to swap from"
            nm = series_id if name is None else name
            snap = self.registry.load_serving(nm)
            if snap is None:
                return f"no servable snapshot under {nm!r} to swap in"
        if isinstance(history, str) and history == "auto":
            history = self.history_tail_of(series_id)
        gen0 = self.attach_generation(series_id)
        rejected = self.attach_many([(series_id, snap, history, None)])
        if rejected:
            return rejected[0][1]
        if self.attach_generation(series_id) == gen0:
            return (
                f"swap did not commit for {series_id!r}: the candidate "
                "is quarantined (healthy=False) and the serving state "
                "is healthy — kept, not swapped"
            )
        return None

    # ---- adaptation surface ----

    def weight_state_of(self, series_id: str):
        """The adaptation plane's stored weight state of a series, or
        None (opaque here)."""
        return self._weights.get(series_id)

    def set_weight_state(self, series_id: str, state) -> None:
        """Store (None: clear) one series' adaptation weight state."""
        if state is None:
            self._weights.pop(series_id, None)
            return
        self._weights[series_id] = state
        self._weights.move_to_end(series_id)
        while len(self._weights) > TENANT_BINDINGS_CAP:
            self._weights.popitem(last=False)

    def draw_bank_of(self, series_id: str):
        """The unconstrained draw bank ``[D, n_free]`` of an attached
        series (None when not attached); read-only by convention."""
        rec = self._series.get(series_id)
        return None if rec is None else rec["draws"]

    def filter_state_of(self, series_id: str):
        """``(log_alpha [D, K], loglik [D], ok [D])`` of an attached,
        ticked series, or None."""
        return self._carry_of(series_id)

    def replace_draw_bank(self, series_id: str, draws, alpha, ll, ok) -> Optional[str]:
        """Replace one series' draw bank and filter state in place (the
        rejuvenation commit). Shapes and dtypes must match the current
        bank. Bumps the attach generation; the staleness clock stays.
        None on success, else the reason."""
        rec = self._series.get(series_id)
        if rec is None:
            return f"series {series_id!r} is not attached"
        if rec["alpha"] is None:
            return f"series {series_id!r} has not received a tick yet"
        carry = self._carry_of(series_id)
        if carry is None:
            return f"series {series_id!r} has not received a tick yet"
        cur_alpha, cur_ll, cur_ok = carry
        cur = rec["draws"]
        draws = torch.as_tensor(draws, device=cur.device)
        if draws.shape != cur.shape or draws.dtype != cur.dtype:
            return (
                f"draw bank mismatch for {series_id!r}: got "
                f"{tuple(draws.shape)}/{draws.dtype}, serving "
                f"{tuple(cur.shape)}/{cur.dtype} (fixed-D contract)"
            )
        alpha = torch.as_tensor(alpha, dtype=cur_alpha.dtype, device=cur_alpha.device)
        ll = torch.as_tensor(ll, dtype=cur_ll.dtype, device=cur_ll.device)
        ok = torch.as_tensor(ok, dtype=cur_ok.dtype, device=cur_ok.device)
        if alpha.shape != cur_alpha.shape or ll.shape != cur_ll.shape or ok.shape != cur_ok.shape:
            return f"filter state shape mismatch for {series_id!r}"
        rec["draws"], rec["alpha"], rec["ll"], rec["ok"] = draws, alpha, ll, ok
        self._lane_drop(series_id)
        rec["params"] = None
        rec["rejuvenated"] = True
        self._draws_cache = {k: v for k, v in self._draws_cache.items() if series_id not in k}
        self._attach_gen[series_id] = self._attach_gen.get(series_id, 0) + 1
        return None

    # ---- introspection ----

    def state(self, series_id: str):
        """Serving state of one series for app consumers
        (``apps/hassan/forecast.py``, ``apps/tayal/analytics.py``):
        ``(log_alpha [D, K], loglik [D], ok [D], params)``, the params the
        per-draw constrained dict (unpacked once and cached on the
        record)."""
        rec = self._series[series_id]
        carry = self._carry_of(series_id)
        if carry is None:
            raise ValueError(f"series {series_id!r} has not received a tick yet")
        if rec.get("params") is None:
            rec["params"] = self._unpack_params(rec["draws"])
        return carry[0], carry[1], carry[2], rec["params"]

    def series_ids(self) -> List[str]:
        return sorted(self._series)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _pad_lanes(self, chunk: list) -> list:
        """Pad a chunk (at most the largest bucket) to its bucket by
        repeating the last entry (padded lanes' outputs are discarded)."""
        bn = self._bucket_for(len(chunk))
        return [chunk[min(i, len(chunk) - 1)] for i in range(bn)]

    def _note_signature(self, kernel: str, bucket, extra) -> None:
        self._signatures.add((kernel, bucket, extra))

    def _refresh_compile_count(self) -> None:
        """``compile_count``: the distinct dispatch signatures so far."""
        self.metrics.set_compile_count(len(self._signatures))
