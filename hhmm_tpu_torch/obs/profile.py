"""Device-time profiling plane: one timing harness, counted kernel
costs with a roofline, and the persistent kernel cost database
(counterpart of ``hhmm_tpu/obs/profile.py``).

1. **One canonical timing harness** — :func:`device_time`: an explicit
   warmup/compile split (the warmup call is timed apart and never
   enters the statistics), fresh pre-staged inputs per rep
   (``arg_sets``), and exact-order-statistic p50/min over the per-rep
   durations (no interpolation). A callable whose arguments or warmup
   output hold a CUDA tensor is timed on the card: each rep is queued
   behind a short spin kernel and timed by a pair of CUDA events on the
   device's current stream, so the duration is the stream's work
   between them (the host's enqueue hides behind the spin) — the
   device time of the kernels the call launched. A CPU callable is
   timed on the host clock. :class:`PhaseClock` is the host-side phase
   accumulator of the app drivers (`apps/tayal/wf.py`).

2. **Counted kernel costs** — :func:`kernel_cost`: the bytes each port
   kernel must move (every input read once, every output written once)
   and the f32 operations of its arithmetic, for ``(kernel, K, T, N,
   gated)`` and the valid steps of the run's masks (a masked step only
   copies its carry). XLA's ``cost_analysis`` has no counterpart for a
   hand-written kernel, so the counts are written out here, once: the
   bound column of ``chip_smoke.py``'s kernels line and
   :func:`roofline` read the same count. :data:`PEAKS` holds
   spec-sheet peaks per device kind (the H100 SXM's HBM3 rate and its
   f32 rate outside the tensor cores); an unknown device kind yields no
   roofline rather than a made-up fraction.

3. **The kernel cost database** — :class:`KernelCostDB`, rows keyed
   ``(kernel, branch, K, T, B, dtype, device_kind, torch)``, written
   atomically and loaded corrupt-tolerantly (a torn file is
   quarantined aside as ``.corrupt`` and reads as empty). Its default
   file is the port's own (:func:`default_db_path`), never the JAX
   package's ``results/kernel_costs.json``. ``kernels/dispatch.py``
   reads it through :func:`dispatch_winner` for ``"auto"`` (a
   homogeneous call races ``cuda`` against ``assoc``, a time-varying
   one ``seq`` against ``assoc``).

Importing this module touches no CUDA; only :func:`device_time` (on a
CUDA callable), :func:`decode_kernel_fns`' entries and
:func:`dirichlet_hmm_inputs` (on the card) do.
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from hhmm_tpu_torch.obs.trace import _cuda_devices, atomic_write_text, perf_counter

__all__ = [
    "KERNEL_COSTS_VERSION",
    "DeviceTiming",
    "PhaseClock",
    "device_time",
    "kernel_cost",
    "PEAKS",
    "roofline",
    "bound_ms",
    "decode_kernel_fns",
    "dirichlet_hmm_inputs",
    "row_key",
    "KernelCostDB",
    "default_db_path",
    "active_db",
    "set_db",
    "refresh",
    "dispatch_winner",
]

KERNEL_COSTS_VERSION = 1

_ENV_DB_PATH = "HHMM_TPU_TORCH_KERNEL_COSTS"
# the spin queued ahead of a timed rep on the card: about 1 ms at an
# H100's 1.98 GHz, longer than a wrapper's enqueue of its kernels
_SPIN_CYCLES = 2_000_000


# ---------------------------------------------------------------------------
# 1. the canonical timing harness
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeviceTiming:
    """One :func:`device_time` measurement. ``compile_s`` is the
    warmup call (build + first run) when a warmup ran, else ``None`` —
    it is reported, never folded into the rep statistics."""

    reps: int
    mean_s: float
    p50_s: float
    min_s: float
    max_s: float
    compile_s: Optional[float]

    def to_json(self) -> Dict[str, Any]:
        return {
            "reps": self.reps,
            "mean_s": round(self.mean_s, 9),
            "p50_s": round(self.p50_s, 9),
            "min_s": round(self.min_s, 9),
            "max_s": round(self.max_s, 9),
            "compile_s": (
                None if self.compile_s is None else round(self.compile_s, 6)
            ),
        }


class PhaseClock:
    """Cumulative named phase attribution for host-side drivers (the
    ``t0 = perf_counter(); ...; sink[name] += perf_counter() - t0``
    pattern, in one place): one mutable sink of seconds by phase that
    lands in records verbatim.

    - :meth:`mark` — accumulate the time since the previous
      mark/restart into ``name`` and reset the marker (sequential
      phase splits).
    - :meth:`phase` — context manager accumulating its own region into
      ``name``; does NOT move the ``mark`` marker.
    - :meth:`elapsed` — seconds since the last mark/restart, without
      consuming it.
    """

    def __init__(self, sink: Optional[Dict[str, float]] = None, round_digits: Optional[int] = None):
        self.sink: Dict[str, float] = sink if sink is not None else {}
        self._round = round_digits
        self._last = perf_counter()

    def _acc(self, name: str, dt: float) -> None:
        total = self.sink.get(name, 0.0) + dt
        self.sink[name] = (
            round(total, self._round) if self._round is not None else total
        )

    def restart(self) -> None:
        self._last = perf_counter()

    def elapsed(self) -> float:
        return perf_counter() - self._last

    def mark(self, name: str) -> float:
        now = perf_counter()
        dt = now - self._last
        self._acc(name, dt)
        self._last = now
        return dt

    def phase(self, name: str):
        return _PhaseRegion(self, name)


class _PhaseRegion:
    __slots__ = ("_clock", "_name", "_t0")

    def __init__(self, clock: PhaseClock, name: str):
        self._clock = clock
        self._name = name

    def __enter__(self):
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._clock._acc(self._name, perf_counter() - self._t0)


def _host_call(fn, args) -> Tuple[Any, float]:
    t0 = perf_counter()
    out = fn(*args)
    return out, perf_counter() - t0


def _cuda_call(fn, args, dev) -> Tuple[Any, float]:
    """``fn(*args)`` between two CUDA events on ``dev``'s current
    stream, queued behind a spin; returns the output and the seconds
    between the events."""
    import torch

    with torch.cuda.device(dev):
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(_SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3


def device_time(
    fn,
    *args,
    reps: int = 5,
    arg_sets: Optional[Sequence[Tuple]] = None,
    warmup: bool = True,
) -> DeviceTiming:
    """Time ``fn``: the JAX harness's signature and statistics.

    ``arg_sets``: pre-staged argument tuples, one consumed per rep
    (cycled when shorter). When ``warmup`` and more than one set is
    given, the LAST set is the warmup set and the timed reps cycle the
    rest. Without ``arg_sets``, every call reuses ``args``.

    A call whose arguments (or, failing that, the warmup's output) hold
    a CUDA tensor is timed on that tensor's device with CUDA events
    (see the module docstring), and the warmup is synchronised before
    its host clock stops; any other call on the host clock. p50 is the
    exact order statistic ``sorted[ceil(0.5 n) - 1]``.
    """
    if reps <= 0:
        raise ValueError(f"reps must be positive, got {reps}")
    sets = list(arg_sets) if arg_sets is not None else None
    if sets is not None and not sets:
        raise ValueError("arg_sets must be non-empty when given")
    devs = _cuda_devices(list(sets) if sets is not None else list(args))
    compile_s: Optional[float] = None
    if warmup:
        wargs = sets[-1] if sets else args
        t0 = perf_counter()
        out = fn(*wargs)
        devs = devs or _cuda_devices(out)
        if devs:
            import torch

            torch.cuda.synchronize(devs[0])
        compile_s = perf_counter() - t0
    if sets is not None:
        timed_sets = sets[:-1] if (warmup and len(sets) > 1) else sets
    else:
        timed_sets = None
    durs: List[float] = []
    for r in range(reps):
        cargs = timed_sets[r % len(timed_sets)] if timed_sets else args
        if devs:
            _, dur = _cuda_call(fn, cargs, devs[0])
        else:
            _, dur = _host_call(fn, cargs)
        durs.append(dur)
    ordered = sorted(durs)
    p50 = ordered[max(0, math.ceil(0.5 * len(ordered)) - 1)]
    return DeviceTiming(
        reps=reps,
        mean_s=sum(durs) / len(durs),
        p50_s=p50,
        min_s=ordered[0],
        max_s=ordered[-1],
        compile_s=compile_s,
    )


# ---------------------------------------------------------------------------
# 2. counted kernel costs + roofline
# ---------------------------------------------------------------------------

KERNELS = ("FWD", "BWD_SAMPLE", "VG_BWD", "FILTER", "BETA", "VITERBI", "BACKTRACK", "TRAJ")
_TAYAL_DIM = 35  # TRAJ's coordinates (models/tayal.py: p_11, A_row, phi_k)


def kernel_cost(
    kernel: str,
    K: int,
    T: int,
    N: int,
    gated: bool = False,
    *,
    valid_steps: Optional[int] = None,
    series: Optional[int] = None,
    leapfrogs: int = 1,
) -> Dict[str, int]:
    """``{"bytes_accessed", "flops"}`` of one launch of the port kernel
    ``kernel`` (a name of :data:`KERNELS`) on ``N`` lanes of ``T`` steps
    at ``K`` states: the bytes of every input read once and every output
    written once (f32, int32 maps and paths), and the f32 operations of
    the arithmetic.

    ``valid_steps``: the lanes' valid steps after the first (the count of
    ``mask[1:] > 0`` over all lanes; a masked step copies its carry and
    does no arithmetic); by default every step, ``(T - 1) N``.
    ``BWD_SAMPLE`` draws at every step whatever the mask. ``TRAJ`` (the
    Tayal trajectory, K = 4, L = 9, 35 coordinates): ``N`` lanes of
    ``series`` series (chains = N / series; the data are per series),
    ``valid_steps`` over the lanes, ``leapfrogs`` leapfrogs a launch.
    """
    K, T, N = int(K), int(T), int(N)
    steps = (T - 1) * N if valid_steps is None else int(valid_steps)
    if kernel == "FWD":
        floats = K * N + K * K * N + T * K * N + T * N + N + T * K * N
        if gated:
            floats += T * N + K * N
        per_dest = 5 * K + 3 + (K if gated else 0)  # add(,mul), max, sub, exp, sum, log, 2 adds
        ops = steps * K * per_dest + N * (4 * K + 2)
    elif kernel == "BWD_SAMPLE":
        floats = K * K * N + T * N + T * K * N + T * N + T * N  # A, mask, alpha, u, z
        if gated:
            floats += T * N + K * N
        ops = T * N * (12 * K - 1)  # logits, lse0, p, running cum + count, every step
    elif kernel == "VG_BWD":
        floats = K * K * N + 2 * T * K * N + T * N + N + (T * N + K * N if gated else 0)
        floats += K * N + K * K * N + T * K * N
        # d_obs 4K; e K; per (i, j): add, add, sub, exp, mul m, add acc, add x
        # (+ 2 muls by c gated); per i the clamped lse: K max, K sub, K exp,
        # K-1 adds, log, add
        per_step = 5 * K + K * K * (7 + (2 if gated else 0)) + K * (4 * K + 1)
        ops = steps * per_step + N * 4 * K
    elif kernel == "FILTER":
        # per destination: K adds, K-1 max, the -inf test, K subtracts,
        # K exps, K adds, log, 2 adds
        floats = K * N + K * K * N + T * K * N + T * N + T * K * N + N
        ops = steps * K * (4 * K + 3) + N * (4 * K + 2)
    elif kernel == "BETA":
        floats = K * K * N + T * K * N + T * N + T * K * N
        ops = steps * (K + K * (4 * K + 2))
    elif kernel == "VITERBI":
        # per destination: K adds, K-1 compares and selects, 1 add
        floats = K * N + K * K * N + T * K * N + T * N + N + K * N + T * N
        ops = steps * K * (3 * K - 1) + N * K
    elif kernel == "BACKTRACK":
        # per step a shift and a mask on the map word
        floats = T * N + K * N + T * N
        ops = 2 * (T - 1) * N + N * K
    elif kernel == "TRAJ":
        B = N if series is None else int(series)
        D = _TAYAL_DIM
        floats = 3 * D * N + D * B + 3 * T * B + 2 + 3 * D * N + N
        # forward: 16 mul-adds, 4 emission muls, 3 adds, 4 divides, log, add;
        # backward: 4 gamma muls + 4 slab adds, e 4 muls + 4 divides, 4 dA
        # terms of 4 ops, 16 mul-adds for beta
        per_step = (32 + 4 + 3 + 4 + 2) + (8 + 8 + 16 + 32)
        # unpack: 35 sigmoid / log-sigmoid chains (~12 ops) and 36 exps;
        # chain rule ~10 ops a coordinate; leapfrog updates 6 a coordinate
        per_lane = 12 * D + 36 + 10 * D + 6 * D
        ops = int(leapfrogs) * (steps * per_step + N * per_lane)
    else:
        raise ValueError(f"no counted cost for kernel {kernel!r}; known: {KERNELS}")
    return {"bytes_accessed": 4 * floats, "flops": ops}


# Per-device-kind peaks for roofline fractions and bounds. Spec-sheet
# numbers, not measurements: the H100 SXM's HBM3 rate and its f32 rate
# outside the tensor cores (the port's kernels run f32 on the CUDA
# cores); the JAX package's TPU rows, kept so a record of either package
# reads against its own device; the cpu row a deliberate
# order-of-magnitude host figure. Unknown device kinds get NO roofline.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"flops_per_s": 67e12, "bytes_per_s": 3.35e12},
    "TPU v5 lite": {"flops_per_s": 98.5e12, "bytes_per_s": 819e9},
    "TPU v5e": {"flops_per_s": 98.5e12, "bytes_per_s": 819e9},
    "TPU v4": {"flops_per_s": 137.5e12, "bytes_per_s": 1228e9},
    "cpu": {"flops_per_s": 1e11, "bytes_per_s": 5e10},
}


def _peak(device_kind: Optional[str]) -> Optional[Dict[str, float]]:
    if not device_kind:
        return None
    return PEAKS.get(device_kind) or PEAKS.get(str(device_kind).lower())


def roofline(
    cost: Optional[Dict[str, Any]],
    seconds: Optional[float],
    device_kind: Optional[str],
) -> Optional[Dict[str, Any]]:
    """Achieved-over-peak fractions for one timed call of counted cost
    ``cost`` (:func:`kernel_cost`). None-tolerant end to end: no cost,
    no timing, or an unknown device kind all yield ``None``."""
    if not cost or not seconds or seconds <= 0:
        return None
    peak = _peak(device_kind)
    if peak is None:
        return None
    flops = cost.get("flops")
    bts = cost.get("bytes_accessed")
    out: Dict[str, Any] = {"peak_source": device_kind}
    out["flops_frac"] = (
        None if flops is None else round(flops / seconds / peak["flops_per_s"], 8)
    )
    out["bytes_frac"] = (
        None if bts is None else round(bts / seconds / peak["bytes_per_s"], 8)
    )
    if out["flops_frac"] is None and out["bytes_frac"] is None:
        return None
    return out


def bound_ms(cost: Dict[str, Any], device_kind: str) -> Tuple[float, str]:
    """The least time ``device_kind`` could take for the counted work:
    the larger of the bytes over its memory rate and the operations over
    its f32 rate, in ms, with which of the two (``"bytes"`` or
    ``"operations"``) bounds it. Raises ``KeyError`` for a device kind
    without peaks."""
    peak = _peak(device_kind)
    if peak is None:
        raise KeyError(f"no peaks for device kind {device_kind!r}")
    t_bytes = cost["bytes_accessed"] / peak["bytes_per_s"] * 1e3
    t_ops = cost["flops"] / peak["flops_per_s"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# the shared measurement surface for the DB writers
# ---------------------------------------------------------------------------


def _single(fn):
    """``fn`` over a flat batch, also taking one series' shapes (``log_obs
    [T, K]``): a leading axis of one is added, and taken off the
    output."""

    def call(lp, lA, lo, m):
        if lo.ndim == 2:
            return fn(lp[None], lA[None], lo[None], m[None])[0]
        return fn(lp, lA, lo, m)

    return call


def decode_kernel_fns() -> Dict[str, Dict[str, Any]]:
    """``{kernel_name: {branch: fn}}``: the decode entries every cost-DB
    writer times, defined once, each branch forced through
    `kernels/dispatch.py` (the sanctioned entries): ``cuda`` (the
    kernels; their plain versions answer the same call on CPU tensors),
    ``assoc`` (the time-parallel scans) and ``seq`` (the sequential
    scans). Each fn takes ``(log_pi, log_A, log_obs, mask)``, a flat
    batch or one series, and returns the output a writer blocks on: the
    log-likelihood of the filter, the Viterbi path, the FFBS draw (from
    a generator seeded 0 on the operands' device). Lazy kernel imports:
    this module sits below ``kernels/`` in the import graph."""
    import torch

    from hhmm_tpu_torch.kernels.dispatch import (  # lint: ok layer-import -- deliberate lazy cycle-breaker: obs sits below kernels (dispatch imports obs.trace/profile); this driver-only helper times the dispatch entries
        ffbs_dispatch,
        forward_filter_dispatch,
        viterbi_dispatch,
    )

    def filt(b):
        return lambda lp, lA, lo, m: forward_filter_dispatch(lp, lA, lo, m, time_parallel=b)[1]

    def vit(b):
        return lambda lp, lA, lo, m: viterbi_dispatch(lp, lA, lo, m, time_parallel=b)[0]

    def ffbs(b):
        def fn(lp, lA, lo, m):
            gen = torch.Generator(device=lo.device).manual_seed(0)
            return ffbs_dispatch(gen, lp, lA, lo, m, time_parallel=b)[0]

        return fn

    branches = ("cuda", "assoc", "seq")
    return {
        name: {b: _single(make(b)) for b in branches}
        for name, make in (("filter", filt), ("viterbi", vit), ("ffbs", ffbs))
    }


def dirichlet_hmm_inputs(rng, K: int, T: int, batch: Optional[int] = None, device=None):
    """One fresh f32 input set ``(log_pi, log_A, log_obs, mask)`` for the
    decode kernels, staged on ``device`` (default the card; the copy
    happens here, outside any timed window) — the shared input
    convention of the DB writers. ``batch=None`` gives one series'
    shapes."""
    import numpy as np
    import torch

    from hhmm_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    shp = () if batch is None else (int(batch),)
    f32 = dict(dtype=torch.float32, device=dev)
    log_pi = torch.as_tensor(np.log(rng.dirichlet(np.ones(K), shp or None)), **f32)
    log_A = torch.as_tensor(np.log(rng.dirichlet(np.ones(K), shp + (K,))), **f32)
    log_obs = torch.as_tensor(rng.normal(size=shp + (T, K)) - 1.0, **f32)
    mask = torch.ones(shp + (T,), **f32)
    return log_pi, log_A, log_obs, mask


# ---------------------------------------------------------------------------
# 3. the kernel cost database
# ---------------------------------------------------------------------------


def default_db_path() -> str:
    """``results_torch/kernel_costs.json`` at the repo root (the
    package's grandparent) — the port's own file, never the JAX
    package's — overridable with ``HHMM_TPU_TORCH_KERNEL_COSTS``."""
    env = os.environ.get(_ENV_DB_PATH, "").strip()
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "results_torch", "kernel_costs.json")


def row_key(
    kernel: str,
    branch: str,
    K: int,
    T: int,
    B: int,
    dtype: str,
    device_kind: Optional[str],
    jax_version: Optional[str],
) -> str:
    """The row identity: one measured (kernel, branch, shape, dtype,
    device, stack) point; the JAX key's ``jax_version`` slot holds the
    torch version here, so a row measured under another torch never
    silently overwrites this one's timing."""
    return "|".join(
        [
            str(kernel),
            str(branch),
            f"K{int(K)}",
            f"T{int(T)}",
            f"B{int(B)}",
            str(dtype),
            str(device_kind),
            str(jax_version),
        ]
    )


class KernelCostDB:
    """Persistent, atomic, manifest-stamped kernel cost store. One JSON
    file, ``{"version": 1, "rows": {key: row}}``; see module docstring
    for the writer/reader roster. Not thread-hot: writers are benches
    and probes, the dispatch read path goes through the module-level
    memoized :func:`dispatch_winner`."""

    def __init__(self, path: Optional[str] = None):
        self.path = str(path) if path else default_db_path()
        self._rows: Dict[str, Dict[str, Any]] = {}
        self._loaded = False

    # ---- persistence ----

    def load(self) -> "KernelCostDB":
        """Read the file (idempotent). Missing → empty; torn/garbage →
        quarantined aside as ``.corrupt`` with one stderr line and read
        as empty — a corrupt DB must never wedge a reader (the
        `obs/manifest.py` load rule)."""
        self._loaded = True
        if not os.path.exists(self.path):
            return self
        try:
            with open(self.path) as f:
                d = json.load(f)
            if (
                not isinstance(d, dict)
                or "version" not in d
                or not isinstance(d.get("rows"), dict)
            ):
                raise ValueError("not a kernel cost DB (no version/rows)")
        except (OSError, ValueError) as e:
            print(
                f"# kernel_costs: dropping corrupt DB "
                f"{os.path.basename(self.path)} ({type(e).__name__}: {e})",
                file=sys.stderr,
                flush=True,
            )
            try:
                os.replace(self.path, self.path + ".corrupt")
            except OSError:
                pass
            return self
        self._rows = {str(k): v for k, v in d["rows"].items() if isinstance(v, dict)}
        return self

    def save(self) -> None:
        """Atomic write (temp + fsync + replace via the shared
        `obs/trace.py` writer) so a reader — including a concurrently
        dispatching process — can never observe a half-written DB."""
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        doc = {
            "version": KERNEL_COSTS_VERSION,
            "updated": time.strftime("%F %T"),
            "rows": {k: self._rows[k] for k in sorted(self._rows)},
        }
        atomic_write_text(self.path, json.dumps(doc, indent=1, sort_keys=False) + "\n")
        _invalidate_winner_cache()

    # ---- rows ----

    def rows(self) -> Dict[str, Dict[str, Any]]:
        if not self._loaded:
            self.load()
        return dict(self._rows)

    def put_row(
        self,
        *,
        kernel: str,
        branch: str,
        K: int,
        T: int,
        B: int,
        dtype: str,
        timing: Optional[DeviceTiming] = None,
        cost: Optional[Dict[str, Any]] = None,
        roofline_frac: Optional[Dict[str, Any]] = None,
        device_kind: Optional[str] = None,
        source: str = "unknown",
        extra: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Insert/replace one measured row, stamped with the current
        stack identity (`obs/manifest.py` ``stack_versions`` /
        ``device_info``: the torch version, the device kind and the
        card's power limit). Returns the stored row (key included)."""
        from hhmm_tpu_torch.obs.manifest import device_info, stack_versions

        if not self._loaded:
            self.load()
        versions = stack_versions()
        dev = device_info()
        dk = device_kind if device_kind is not None else dev.get("device_kind")
        key = row_key(kernel, branch, K, T, B, dtype, dk, versions.get("torch"))
        row: Dict[str, Any] = {
            "key": key,
            "kernel": str(kernel),
            "branch": str(branch),
            "K": int(K),
            "T": int(T),
            "B": int(B),
            "dtype": str(dtype),
            "device_kind": dk,
            "backend": dev.get("backend"),
            "power_limit": dev.get("power_limit"),
            "torch": versions.get("torch"),
            "cuda_runtime": versions.get("cuda_runtime"),
            "timing": timing.to_json() if timing is not None else None,
            "cost": cost if cost else None,
            "roofline": roofline_frac if roofline_frac else None,
            "source": str(source),
            "ts": time.strftime("%F %T"),
        }
        if extra:
            row.update(extra)
        self._rows[key] = row
        _invalidate_winner_cache()
        return row

    # ---- dispatch-facing reads ----

    def matching(
        self, kernel: str, K: int, T: int, device_kind: Optional[str]
    ) -> List[Dict[str, Any]]:
        """Rows for one (kernel, K, T) on one device kind — the only
        match axes dispatch cares about; B/dtype/torch variants all
        qualify and :meth:`winner` arbitrates among them."""
        if not self._loaded:
            self.load()
        out = []
        for row in self._rows.values():
            if (
                row.get("kernel") == kernel
                and row.get("K") == int(K)
                and row.get("T") == int(T)
                and row.get("device_kind") == device_kind
            ):
                out.append(row)
        return out

    def winner(
        self,
        kernel: str,
        K: int,
        T: int,
        device_kind: Optional[str],
        allowed: Optional[Sequence[str]] = None,
    ) -> Optional[str]:
        """The measured branch winner (a branch NAME — ``"seq"`` /
        ``"assoc"`` / ``"cuda"`` / …) at one (kernel, K, T) point on
        ``device_kind``, or ``None`` (unmeasured); the JAX rule, whole.

        Branches are only compared within one (B, dtype, torch) stamp —
        a row timed at B=64 must not race one timed on a single series.
        Arbitration is **N-way**: a stamp group qualifies when it holds
        ≥ 2 measured branches (a lone branch has raced nothing), and
        the winner is the group's fastest branch by p50. Among
        qualifying groups the LARGEST batch wins, ties broken by the
        NEWEST measurement (row ``ts``; the "%F %T" stamp sorts in time
        order, where a version-string compare would rank "2.9" over
        "2.11"). Within a group, exact-p50 ties break toward seq (then
        assoc). ``allowed`` restricts the race to a branch subset.
        Timing-only rows need a finite ``p50_s``; anything less yields
        ``None``."""
        if device_kind is None:
            return None
        groups: Dict[Tuple[int, str, str], Dict[str, float]] = {}
        group_ts: Dict[Tuple[int, str, str], str] = {}
        for row in self.matching(kernel, K, T, device_kind):
            branch = str(row.get("branch"))
            if allowed is not None and branch not in allowed:
                continue
            t = row.get("timing") or {}
            p50 = t.get("p50_s")
            if not isinstance(p50, (int, float)) or not math.isfinite(p50) or p50 <= 0:
                continue
            base = (int(row.get("B") or 0), str(row.get("dtype")), str(row.get("torch")))
            groups.setdefault(base, {})[branch] = float(p50)
            ts = str(row.get("ts") or "")
            if ts > group_ts.get(base, ""):
                group_ts[base] = ts
        complete = [(base, d) for base, d in groups.items() if len(d) >= 2]
        if not complete:
            return None
        complete.sort(
            key=lambda it: (it[0][0], group_ts.get(it[0], ""), it[0][1], it[0][2])
        )
        _, best = complete[-1]
        # tie preference: the conservative ladder seq < assoc < anything
        pref = {"seq": 0, "assoc": 1}
        return min(
            best, key=lambda b: (best[b], pref.get(b, 2), b)
        )


# ---------------------------------------------------------------------------
# module-level DB binding (what kernels/dispatch.py reads)
# ---------------------------------------------------------------------------

_DB_LOCK = threading.Lock()
_ACTIVE_DB: Optional[KernelCostDB] = None
_WINNER_CACHE: Dict[Tuple[str, int, int, Optional[str]], Optional[str]] = {}
_MISSING = object()


def _invalidate_winner_cache() -> None:
    # under the same lock the miss path computes-and-stores under: an
    # invalidation can never interleave between a stale compute and its
    # cache write (the last-writer-clobber class the plan scope and
    # fault stack already guard against)
    with _DB_LOCK:
        _WINNER_CACHE.clear()


def active_db() -> KernelCostDB:
    """The process-wide DB the dispatch layer consults — loaded lazily
    from :func:`default_db_path` on first use. The disk read happens
    OUTSIDE ``_DB_LOCK`` (held-lock-escape: a dispatching thread must
    never stall on another thread's cold file read); a raced first
    touch loads twice and the first binder wins."""
    global _ACTIVE_DB
    with _DB_LOCK:
        db = _ACTIVE_DB
    if db is not None:
        return db
    fresh = KernelCostDB().load()
    with _DB_LOCK:
        if _ACTIVE_DB is None:
            _ACTIVE_DB = fresh
        return _ACTIVE_DB


def set_db(db) -> None:
    """Re-bind the active DB: a :class:`KernelCostDB`, a path, or
    ``None`` to restore the default-path binding. The injection point
    for tests (flip a winner with a scratch DB) and for the writers."""
    global _ACTIVE_DB
    loaded = (
        db
        if db is None or isinstance(db, KernelCostDB)
        else KernelCostDB(str(db)).load()
    )
    with _DB_LOCK:
        _ACTIVE_DB = loaded
        _WINNER_CACHE.clear()


def refresh() -> None:
    """Re-read the active DB from disk (a probe or bench in this or
    another process just wrote rows) and drop the memoized winners."""
    global _ACTIVE_DB
    with _DB_LOCK:
        path = None if _ACTIVE_DB is None else _ACTIVE_DB.path
        _WINNER_CACHE.clear()
    if path is not None:
        set_db(KernelCostDB(path).load())


def dispatch_winner(
    kernel: str,
    K: int,
    T: int,
    device_kind: Optional[str],
    allowed: Optional[Sequence[str]] = None,
) -> Optional[str]:
    """The dispatch-facing read: the measured winner's branch NAME when
    the DB holds a measured N-way race for this exact (kernel, K, T) on
    this host's device kind, else ``None``. ``allowed`` restricts the
    race to a branch subset (part of the memo key). Memoized — the
    answer cannot change between DB writes. The miss path computes AND stores under ``_DB_LOCK`` —
    the same lock every invalidation (:func:`set_db` / :func:`refresh`
    / row writes) clears under — so a concurrent rebind can never
    interleave between a stale compute and its cache write and pin the
    pre-refresh answer; the hit path stays lock-free, and the lazy
    first-touch disk read happens in :func:`active_db` BEFORE the lock
    is taken (held-lock-escape — the locked region re-reads
    ``_ACTIVE_DB`` so a rebind that won the race still governs)."""
    ck = (
        str(kernel),
        int(K),
        int(T),
        device_kind,
        None if allowed is None else tuple(allowed),
    )
    w = _WINNER_CACHE.get(ck, _MISSING)
    while w is _MISSING:
        db = active_db()
        with _DB_LOCK:
            w = _WINNER_CACHE.get(ck, _MISSING)
            if w is not _MISSING:
                break
            if _ACTIVE_DB is None:
                # a concurrent set_db(None) restored the default
                # binding between our active_db() read and this lock:
                # caching a winner computed from the pre-restore `db`
                # would be exactly the stale pin this path exists to
                # prevent — loop so active_db() re-binds and the
                # answer comes from the post-restore DB
                continue
            w = _ACTIVE_DB.winner(kernel, K, T, device_kind, allowed=allowed)
            _WINNER_CACHE[ck] = w
    return w
