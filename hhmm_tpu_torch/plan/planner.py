"""Topology-aware execution planner (counterpart of
``hhmm_tpu/plan/planner.py``): one placement decision for the batch fit
path (``batch/fit.py``) and, later, the serving scheduler.

Decision procedure (:func:`make_plan`), given a :class:`WorkloadShape`
``(B series, T steps, C chains, K states)`` and ``D`` devices — the JAX
planner's, field for field:

1. **chains first** — ``chain_ways = gcd(C, D)``: chains divide exactly,
   so they take devices before the series axis, which may need chunk
   rounding;
2. **series next** — the largest divisor of the remaining ways that is
   ``<= B`` becomes the ``series`` axis;
3. **sequence last** — ways still left go to an ``sp`` axis iff the time
   axis divides evenly and each chunk keeps at least ``MIN_SP_CHUNK``
   steps (``kernels/assoc.py::forward_filter_seqshard``); otherwise the
   leftover devices idle, and the reason says so.

A :class:`Plan` carries the axes, the chunk (rounded UP to a multiple of
the series ways), the serving bucket ladder, the resolved time-parallel
branch (``kernels/dispatch.py``: ``"cuda"`` — the kernels, the JAX
``"pallas"``; ``"assoc"``; ``"scan"``; ``"seqshard"``) and a reason
string, and notes its stanza into the manifest plane
(``obs/manifest.py`` ``note_stanza("plan", ...)``).

JAX builds ``Mesh`` / ``NamedSharding`` objects from a plan. The port
has no sharding objects: a plan gives its device list
(:meth:`Plan.device_list`) and :meth:`Plan.place`, which puts one shard
of a chunk on its device. ``fit_batched`` runs the ``series_ways``
shards of a chunk, one a device; a chain or ``sp`` axis is recorded but
not yet placed. A mesh is a sequence of devices, a 1-D ``series`` mesh
(:func:`plan_for_mesh`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from hhmm_tpu_torch.kernels.dispatch import plan_time_parallel, resolve_branch
from hhmm_tpu_torch.obs import manifest as obs_manifest

__all__ = [
    "MIN_SP_CHUNK",
    "WorkloadShape",
    "Plan",
    "make_plan",
    "plan_for_mesh",
]

# an sp (sequence-parallel) shard below this many steps pays more in
# gathers than the log-depth scan saves: leftover devices idle instead
MIN_SP_CHUNK = 8


@dataclass(frozen=True)
class WorkloadShape:
    """The numbers every placement decision is a function of.

    ``duration``: the explicit-duration expansion factor
    (``models/hsmm.py`` ``Dmax``; 1 for plain HMMs). The kernels run on
    the expanded chain, so width-sensitive decisions (the time-parallel
    branch, admission sizes) read :attr:`state_width` = ``K *
    duration``; it enters stanzas only when > 1."""

    B: int  # independent series
    T: int  # time steps per series
    C: int = 1  # chains per series
    K: int = 4  # hidden states (regimes)
    duration: int = 1  # duration-expansion factor (Dmax; 1 = plain HMM)

    @property
    def state_width(self) -> int:
        """The kernels' chain width: ``K * duration``."""
        return int(self.K) * int(self.duration)

    def as_dict(self) -> Dict[str, int]:
        d = {"B": int(self.B), "T": int(self.T), "C": int(self.C), "K": int(self.K)}
        if int(self.duration) > 1:
            d["duration"] = int(self.duration)
        return d


def _largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= cap (>= 1)."""
    best = 1
    for d in range(1, n + 1):
        if n % d == 0 and d <= cap:
            best = d
    return best


def _local_platform() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


@dataclass
class Plan:
    """An explicit, recordable placement decision.

    ``axes`` is the ordered layout ``((name, ways), ...)`` with only
    ways > 1 kept (``()``: one device); ``chunk`` the rounded series a
    dispatch; ``buckets`` the serving ladder; ``branch`` the resolved
    time-parallel branch; ``reason`` the rationale the manifest keeps;
    ``platform`` the device type the plan was made for."""

    shape: WorkloadShape
    platform: str
    n_devices: int  # topology offered to the planner
    axes: Tuple[Tuple[str, int], ...]
    chunk: int
    chunk_requested: int
    buckets: Tuple[int, ...]
    shard_min_bucket: int
    branch: str
    reason: str
    _devices: Optional[tuple] = field(default=None, repr=False, compare=False)

    # ---- derived topology ----

    def ways(self, name: str) -> int:
        for n, w in self.axes:
            if n == name:
                return w
        return 1

    @property
    def series_ways(self) -> int:
        return self.ways("series")

    @property
    def devices_used(self) -> int:
        return int(math.prod(w for _, w in self.axes)) if self.axes else 1

    @property
    def mesh_shape(self) -> Optional[Dict[str, int]]:
        return dict(self.axes) if self.axes else None

    def admission_caps(
        self,
        *,
        depth_factor: int = 8,
        flush_factor: int = 4,
        per_series: int = 2,
        credit_factor: int = 1,
        ess_floor_frac: float = 0.5,
        rejuv_factor: int = 1,
        carry_factor: int = 8,
    ) -> Dict[str, Any]:
        """Admission caps from the bucket ladder (the JAX method's
        numbers): queue depth, flush budget, deficit-round-robin credit,
        rejuvenations a flush and device carry slots as multiples of the
        largest bucket, so a capacity-bounded flush drains in bucket
        shapes; ``ess_floor_frac`` (in (0, 1]) rides along for the
        adaptation plane."""
        top = int(self.buckets[-1])
        if not (0.0 < float(ess_floor_frac) <= 1.0):
            raise ValueError(f"ess_floor_frac must be in (0, 1], got {ess_floor_frac}")
        return {
            "max_queue_depth": max(1, int(depth_factor)) * top,
            "max_ticks_per_flush": max(1, int(flush_factor)) * top,
            "max_pending_per_series": max(1, int(per_series)),
            "credit_cap_ticks": max(1, int(credit_factor)) * top,
            "ess_floor_frac": float(ess_floor_frac),
            "max_rejuv_per_flush": max(1, int(rejuv_factor)) * top,
            "carry_slots_cap": max(1, int(carry_factor)) * top,
        }

    # ---- placement ----

    def device_list(self) -> list:
        """The devices this plan was built over (the given devices; else
        this host's CUDA devices, or ``n_devices`` logical CPU devices on
        a CPU plan), cut to the plan's device count."""
        if self._devices is not None:
            devices = list(self._devices)
        elif self.platform == "cpu":
            devices = [torch.device("cpu")] * int(self.n_devices)
        elif torch.cuda.is_available():
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = []
        return devices[: max(1, min(int(self.n_devices), len(devices)))]

    def place(self, tensor: torch.Tensor, shard: int) -> torch.Tensor:
        """``tensor`` (one shard of a chunk) on the device of series
        shard ``shard`` (0 .. ``series_ways - 1``). Raises when the host
        has fewer devices than the plan's series ways."""
        devices = self.device_list()
        if len(devices) < self.series_ways:
            raise RuntimeError(
                f"plan needs {self.series_ways} devices ({dict(self.axes)}), "
                f"only {len(devices)} available"
            )
        return tensor.to(devices[int(shard) % max(1, self.series_ways)])

    def shard_bucket(self, bucket: int) -> bool:
        """Whether a serving flush of ``bucket`` lanes is worth sharding:
        the plan has a series axis, the bucket divides it, and it clears
        the minimum size."""
        sw = self.series_ways
        return sw > 1 and bucket >= self.shard_min_bucket and bucket % sw == 0

    # ---- dispatch coupling ----

    def dispatch_scope(self):
        """A context manager pinning this plan's branch as the
        ``"auto"`` answer of ``kernels/dispatch.py`` on this thread, so
        the stanza and what runs agree (``seqshard`` is called
        explicitly, so it pins nothing)."""
        return plan_time_parallel({"assoc": True, "cuda": "cuda", "scan": False}.get(self.branch))

    # ---- observability ----

    def stanza(self) -> Dict[str, Any]:
        """The manifest ``plan`` stanza: workload, axes, the specs of a
        fit's inputs, chunk, buckets, branch and reason, JSON-clean (the
        JAX stanza's keys)."""
        specs = None
        if self.axes:
            has_chain = self.ways("chain") > 1
            specs = {
                "data": ["series"],
                "init": ["series", "chain"] if has_chain else ["series"],
                "keys": ["series"],
                "weights": ["series"],
            }
        return {
            "workload": self.shape.as_dict(),
            "platform": self.platform,
            "devices": int(self.n_devices),
            "devices_used": int(self.devices_used),
            "mesh": self.mesh_shape,
            "specs": specs,
            "chunk": int(self.chunk),
            "chunk_requested": int(self.chunk_requested),
            "buckets": [int(b) for b in self.buckets],
            "shard_min_bucket": int(self.shard_min_bucket),
            "branch": self.branch,
            "reason": self.reason,
        }

    def note(self) -> "Plan":
        """Record this plan's stanza into the manifest plane."""
        obs_manifest.note_stanza("plan", self.stanza())
        return self


def _resolve_branch(shape: WorkloadShape, sp_ways: int, time_parallel, platform: str) -> str:
    """The plan's one branch, pinned over every kernel under
    :meth:`Plan.dispatch_scope`: ``assoc`` only when filter, Viterbi and
    FFBS all resolve to it (a one-family measurement must not route the
    others), ``scan`` when all resolve to the sequential scans (a
    force), else the kernels. The races are the homogeneous call's,
    ``cuda`` against ``assoc``."""
    if sp_ways > 1:
        return "seqshard"
    branches = {
        resolve_branch(shape.state_width, shape.T, time_parallel, platform, k, ("cuda", "assoc"))
        for k in ("filter", "viterbi", "ffbs")
    }
    if branches == {"assoc"}:
        return "assoc"
    if branches == {"seq"}:
        return "scan"
    return "cuda"


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _bucket_ladder(buckets: Sequence[int], series_ways: int) -> Tuple[Tuple[int, ...], int]:
    """Each serving bucket rounded up to a series-ways multiple, and the
    smallest bucket worth a sharded flush: 4 lanes a device, at least
    16."""
    ladder = tuple(sorted({max(_round_up(int(b), series_ways), series_ways) for b in buckets}))
    return ladder, max(4 * series_ways, 16)


def _decide(shape: WorkloadShape, D: int, layout: str):
    """The joint decision: ``(axes, reason_parts)``."""
    B, T, C = int(shape.B), int(shape.T), int(shape.C)
    parts = []
    if D <= 1 or layout == "single":
        return (), ["single device: no mesh"]
    if layout == "series":
        parts.append(f"forced single-axis layout: series={D}")
        return (("series", D),), parts
    rem = D
    chain_ways = math.gcd(max(C, 1), rem)
    if chain_ways > 1:
        rem //= chain_ways
        parts.append(f"chain={chain_ways} (chains divide the topology exactly — no padding)")
    series_ways = _largest_divisor_leq(rem, max(B, 1))
    if series_ways > 1:
        rem //= series_ways
        parts.append(f"series={series_ways} over B={B}")
    sp_ways = 1
    if rem > 1:
        if T % rem == 0 and T // rem >= MIN_SP_CHUNK:
            sp_ways = rem
            parts.append(
                f"sp={sp_ways}: leftover devices sequence-shard T={T} "
                f"({T // sp_ways} steps/shard)"
            )
        else:
            parts.append(
                f"{rem} devices idle: T={T} not divisible into >={MIN_SP_CHUNK}-step sp shards"
            )
    axes = tuple(
        (n, w)
        for n, w in (("series", series_ways), ("chain", chain_ways), ("sp", sp_ways))
        if w > 1
    )
    if not axes:
        parts.append("workload too small to shard: single-device plan")
    return axes, parts


def make_plan(
    shape: WorkloadShape,
    *,
    devices: Optional[Sequence[Any]] = None,
    n_devices: Optional[int] = None,
    chunk_size: int = 64,
    buckets: Sequence[int] = (8, 32, 128),
    time_parallel="auto",
    platform: Optional[str] = None,
    layout: str = "auto",
) -> Plan:
    """Choose axes, chunk, bucket ladder and time-parallel branch for
    ``shape`` on a topology, and note the plan in the manifest plane.

    ``devices``: the devices (``torch.device`` or strings; a list may
    repeat one device, as logical devices); ``n_devices``: decide for a
    topology size without devices (the golden tests); neither: this
    host's CUDA devices (raises without a card). ``platform`` defaults
    to the first device's type, else this host's (``cuda`` where a card
    is). ``layout``: ``"auto"`` (the joint decision), ``"series"`` (all
    devices on the series axis) or ``"single"``."""
    if devices is not None:
        devices = tuple(torch.device(d) for d in devices)
        D = len(devices)
    elif n_devices is not None:
        D = int(n_devices)
    else:
        from hhmm_tpu_torch._device import resolve_device

        resolve_device(None)
        D = torch.cuda.device_count()
    if platform is None:
        platform = devices[0].type if devices else _local_platform()
    if layout not in ("auto", "series", "single"):
        raise ValueError(f"layout must be auto/series/single, got {layout!r}")

    axes, parts = _decide(shape, D, layout)
    series_ways = dict(axes).get("series", 1)
    chunk_req = max(1, min(int(chunk_size), int(shape.B)))
    chunk = _round_up(chunk_req, series_ways)
    if chunk != chunk_req:
        parts.append(
            f"chunk {chunk_req} -> {chunk} (rounded up to series ways "
            f"{series_ways}; ragged tail pads by lane repeat, weight 0)"
        )
    ladder, shard_min = _bucket_ladder(buckets, series_ways)
    branch = _resolve_branch(shape, dict(axes).get("sp", 1), time_parallel, platform)
    parts.append(f"branch={branch}")
    plan = Plan(
        shape=shape,
        platform=platform,
        n_devices=D,
        axes=axes,
        chunk=chunk,
        chunk_requested=chunk_req,
        buckets=ladder,
        shard_min_bucket=shard_min,
        branch=branch,
        reason="; ".join(parts),
        _devices=devices,
    )
    return plan.note()


def plan_for_mesh(
    mesh: Sequence[Any],
    shape: WorkloadShape,
    *,
    chunk_size: int = 64,
    buckets: Sequence[int] = (8, 32, 128),
    time_parallel="auto",
    platform: Optional[str] = None,
) -> Plan:
    """A :class:`Plan` over a caller's mesh — a sequence of devices, a
    1-D ``series`` mesh (the ``fit_batched(mesh=)`` argument) — keeping
    it as given, with the planner's chunk rounding and branch."""
    devices = tuple(torch.device(d) for d in mesh)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if platform is None:
        platform = devices[0].type
    series_ways = len(devices)
    chunk_req = max(1, min(int(chunk_size), int(shape.B)))
    chunk = _round_up(chunk_req, series_ways)
    ladder, shard_min = _bucket_ladder(buckets, series_ways)
    branch = _resolve_branch(shape, 1, time_parallel, platform)
    parts = [f"caller-supplied mesh {{'series': {series_ways}}}"]
    if chunk != chunk_req:
        parts.append(f"chunk {chunk_req} -> {chunk} (rounded up to series ways {series_ways})")
    parts.append(f"branch={branch}")
    plan = Plan(
        shape=shape,
        platform=platform,
        n_devices=series_ways,
        axes=(("series", series_ways),),
        chunk=chunk,
        chunk_requested=chunk_req,
        buckets=ladder,
        shard_min_bucket=shard_min,
        branch=branch,
        reason="; ".join(parts),
        _devices=devices,
    )
    return plan.note()
