"""``time_parallel=`` dispatch (counterpart of
``hhmm_tpu/kernels/dispatch.py``): one entry a decode primitive, over
three branches, for a flat batch of ``N`` series (``log_pi [N, K]``,
``log_obs [N, T, K]``, ``mask [N, T]``):

- **cuda** — the hand-written kernels (the JAX package's ``pallas``):
  ``forward_filter_dispatch`` runs ``FILTER``, ``backward_dispatch``
  ``BETA``, ``smooth_dispatch`` both on one lane-layout copy of the
  operands (the guarded normalisation ``filtering.smooth`` applied as
  plain ops outside the kernels, as the JAX pallas branch does),
  ``viterbi_dispatch`` ``VITERBI`` then ``BACKTRACK``, ``ffbs_dispatch``
  ``FWD`` + ``BWD_SAMPLE``. A homogeneous ``[N, K, K]`` ``log_A`` only,
  any K >= 1; on CUDA the operands must be float32 (any other dtype
  raises), on the CPU the same call runs the kernels' plain versions;
- **assoc** — the time-parallel scans of ``kernels/assoc.py`` (O(log T)
  depth, O(T·K³) work), homogeneous or time-varying, either device;
- **seq** — the plain sequential scans of ``kernels/filtering.py``,
  ``viterbi.py`` and ``ffbs.ffbs_invcdf_reference``, either device.

Every entry takes ``time_parallel=``: ``"auto"`` (the default), ``True``
/ ``"assoc"``, ``False`` / ``"seq"``, or ``"cuda"``. A force runs its
branch; ``"cuda"`` on a time-varying ``log_A``, which the kernels do not
take, raises, as an explicit ``"pallas"`` does in JAX. Any other value
(``"pallas"`` included) raises the JAX ``ValueError``, naming the
port's branches. ``"auto"`` resolves, in order (:func:`resolve_auto`):

1. an active plan scope (:func:`plan_time_parallel`, installed by
   ``hhmm_tpu_torch.plan.Plan.dispatch_scope``);
2. the kernel cost database (``obs/profile.py``: ``dispatch_winner``
   over the rows of this kernel, K and T measured on this device kind);
3. the checked-in ``ASSOC_CROSSOVER`` table (empty rows, as in JAX);
4. the default: the kernels for a homogeneous ``log_A``, the ``seq``
   scans for a time-varying one — the route the port took before the
   scans existed, so with nothing measured nothing moves.

A measured row races only the branches the call can take: a homogeneous
call ``cuda`` against ``assoc`` (no measurement puts a plain scan on the
main path in place of a kernel), a time-varying one ``seq`` against
``assoc``. Operands on other devices, or on mixed devices, raise: no
kernel falls back to its plain version. Each call is one span of the
obs plane (``obs/trace.py``, a shared no-op while tracing is off) named
with the branch that ran: ``kernels.dispatch.<entry>[cuda]`` for the
kernels, ``[plain]`` for their plain versions on the CPU, ``[assoc]``,
``[seq]``. ``make_tayal_trajectory`` / ``tayal_trajectory`` are the
sanctioned entries of the fused trajectory kernel
(``kernels/cuda_traj.py``), re-exported here as the JAX module
re-exports ``pallas_traj``'s.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple, Union

import torch

from hhmm_tpu_torch.kernels.assoc import (
    backward_assoc,
    ffbs_assoc_sample,
    forward_filter_assoc,
    smooth_assoc,
    viterbi_assoc,
)
from hhmm_tpu_torch.kernels.cuda_semiring import (
    beta_lanes,
    filter_lanes,
    semiring_beta,
    semiring_filter,
    semiring_viterbi,
    to_lanes,
)
from hhmm_tpu_torch.kernels.cuda_traj import make_tayal_trajectory, tayal_trajectory
from hhmm_tpu_torch.kernels.ffbs import ffbs_fused, ffbs_invcdf_reference
from hhmm_tpu_torch.kernels.filtering import (
    backward_pass,
    forward_backward,
    forward_filter,
    smooth,
    time_varying,
)
from hhmm_tpu_torch.kernels.viterbi import viterbi
from hhmm_tpu_torch.obs import profile as obs_profile
from hhmm_tpu_torch.obs.trace import span

__all__ = [
    "ASSOC_CROSSOVER",
    "BRANCHES",
    "TimeParallel",
    "plan_time_parallel",
    "use_assoc",
    "resolve_auto",
    "resolve_branch",
    "resolve_routed",
    "ffbs_dispatch",
    "forward_filter_dispatch",
    "backward_dispatch",
    "smooth_dispatch",
    "viterbi_dispatch",
    "make_tayal_trajectory",
    "tayal_trajectory",
]

TimeParallel = Union[bool, str]

# the dispatchable branches; every resolve returns one of these
BRANCHES = ("seq", "assoc", "cuda")

# Measured crossover table: ``device type -> ((K_max, T_min), ...)``; the
# assoc branch is taken when K <= K_max of some row and T >= that row's
# T_min (the first row whose K_max covers K decides; an empty tuple: the
# default everywhere). Empty on both devices until a measurement fills
# it, as in the JAX package: the kernel cost DB (obs/profile.py) answers
# before this table, so a probe run routes without a code change.
ASSOC_CROSSOVER = {
    "cpu": (),
    "cuda": (),
    "default": (),
}

# a Plan's dispatch_scope pins "auto" to the plan's branch on the
# installing thread only (a fit under one plan must not leak its pin
# into another thread's dispatch)
_PLAN_TLS = threading.local()

# device kind by device type: the DB keys its rows by the card's name
_DEVICE_KINDS: Dict[str, Optional[str]] = {}
_DEVICE_KINDS_LOCK = threading.Lock()


@contextlib.contextmanager
def plan_time_parallel(value):
    """Scope a plan's branch over ``"auto"`` dispatch on this thread:
    ``True`` / ``"assoc"`` pins the scans of ``kernels/assoc.py``,
    ``False`` / ``"seq"`` the sequential scans, ``"cuda"`` the kernels
    (a time-varying call, which they do not take, runs ``seq``), ``None``
    the measured lookup. Explicit ``time_parallel=`` values still win."""
    prev = getattr(_PLAN_TLS, "value", None)
    _PLAN_TLS.value = value
    try:
        yield
    finally:
        _PLAN_TLS.value = prev


def _coerce_branch(value) -> Optional[str]:
    """A force as a branch name: ``True`` → assoc, ``False`` → seq, a
    branch name as itself, anything else None."""
    if value is True:
        return "assoc"
    if value is False:
        return "seq"
    if isinstance(value, str) and value in BRANCHES:
        return value
    return None


def _forced(time_parallel) -> Optional[str]:
    forced = _coerce_branch(time_parallel)
    if forced is None and time_parallel != "auto":
        raise ValueError(
            "time_parallel must be True, False, 'auto', or one of "
            f"{BRANCHES}, got {time_parallel!r}"
        )
    return forced


def _local_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _device_kind(device_type: str) -> Optional[str]:
    """The DB's device kind for a device type: ``"cpu"``, or the card's
    name (``torch.cuda.get_device_name(0)``, as ``obs/manifest.py``
    stamps rows), None without a card. Cached per process (under a lock:
    serving threads resolve kinds concurrently)."""
    with _DEVICE_KINDS_LOCK:
        if device_type not in _DEVICE_KINDS:
            if device_type == "cpu":
                kind = "cpu"
            elif device_type == "cuda" and torch.cuda.is_available():
                kind = torch.cuda.get_device_name(0)
            else:
                kind = None
            _DEVICE_KINDS[device_type] = kind
        return _DEVICE_KINDS[device_type]


def _default(allowed) -> str:
    return "cuda" if allowed is None or "cuda" in allowed else "seq"


def resolve_auto(
    K: int,
    T: int,
    *,
    kernel: str = "filter",
    device_type: Optional[str] = None,
    allowed: Optional[Tuple[str, ...]] = None,
) -> Tuple[str, str]:
    """``(branch, source)`` for an ``"auto"`` dispatch at (K, T) on
    ``device_type`` (default: this host's, ``cuda`` where a card is):
    the branch and where it came from — ``"plan"`` (an active
    :func:`plan_time_parallel` scope; a pinned branch outside
    ``allowed`` runs ``seq``, as in JAX), ``"db"`` (a measured race of
    this kernel's own rows at (K, T) on this device kind, among
    ``allowed``), ``"table"`` (``ASSOC_CROSSOVER``) or ``"default"``
    (nothing measured: the kernels if ``allowed`` holds ``cuda``, else
    ``seq``). Backward and smoothing resolve under ``kernel="filter"``:
    the beta pass is the filter's combine in suffix order."""
    plan_value = getattr(_PLAN_TLS, "value", None)
    if plan_value is not None:
        branch = _coerce_branch(plan_value)
        if branch is not None:
            if allowed is not None and branch not in allowed:
                branch = "seq"
            return branch, "plan"
    dev = device_type or _local_device_type()
    hint = obs_profile.dispatch_winner(kernel, K, T, _device_kind(dev), allowed=allowed)
    if hint is not None:
        return hint, "db"
    for k_max, t_min in ASSOC_CROSSOVER.get(dev, ASSOC_CROSSOVER["default"]):
        if K <= k_max:
            return ("assoc" if T >= t_min else _default(allowed)), "table"
    return _default(allowed), "default"


def resolve_branch(
    K: int,
    T: int,
    time_parallel: TimeParallel = "auto",
    device_type: Optional[str] = None,
    kernel: str = "filter",
    allowed: Optional[Tuple[str, ...]] = None,
) -> str:
    """The branch one dispatch resolves to: a force passes through,
    ``"auto"`` goes through :func:`resolve_auto`. What the planner and
    the walk-forward decode stamp."""
    forced = _forced(time_parallel)
    if forced is not None:
        return forced
    return resolve_auto(K, T, kernel=kernel, device_type=device_type, allowed=allowed)[0]


def use_assoc(
    K: int,
    T: int,
    time_parallel: TimeParallel = "auto",
    device_type: Optional[str] = None,
    kernel: str = "filter",
) -> bool:
    """Whether the assoc branch is the resolved choice, for callers that
    fork only between the scans and their kernel route (the Tayal
    segment filter): a force other than assoc takes the kernel route."""
    return resolve_branch(K, T, time_parallel, device_type, kernel, ("cuda", "assoc")) == "assoc"


def resolve_routed(
    K: int,
    T: int,
    time_parallel: TimeParallel = "auto",
    *,
    kernel: str = "filter",
    cuda_ok: bool = True,
    device_type: Optional[str] = None,
) -> str:
    """The branch EXACTLY as the dispatch entries run it, for a call
    whose operands the kernels take (``cuda_ok``: a homogeneous
    ``log_A``) or not: forces pass through (``"cuda"`` with
    ``cuda_ok=False`` raises); ``"auto"`` races ``cuda`` against
    ``assoc``, or ``seq`` against ``assoc``."""
    forced = _forced(time_parallel)
    if forced == "cuda" and not cuda_ok:
        raise ValueError(
            "time_parallel='cuda' requires a homogeneous log_A [N, K, K] "
            "(the CUDA kernels take no time-varying transitions)"
        )
    if forced is not None:
        return forced
    allowed = ("cuda", "assoc") if cuda_ok else ("seq", "assoc")
    return resolve_auto(K, T, kernel=kernel, device_type=device_type, allowed=allowed)[0]


def _device_type(*tensors, what: str = "decode") -> str:
    types = {t.device.type for t in tensors if t is not None}
    if len(types) != 1:
        raise ValueError(f"operands must share one device type, got {sorted(types)}")
    kind = types.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no {what} path for device type {kind!r}")
    return kind


def _branch_span(name: str, branch: str, K: int, T: int):
    """One span a dispatch with the branch that ran in its name —
    ``kernels.dispatch.ffbs[cuda]`` — annotated with (K, T); the shared
    no-op singleton while tracing is off (the JAX ``_branch_span``)."""
    sp = span(f"kernels.dispatch.{name}[{branch}]")
    sp.annotate(K=K, T=T)
    return sp


def _span_name(branch: str, kind: str) -> str:
    """The kernels' branch is ``plain`` on the CPU: their plain versions."""
    return "plain" if branch == "cuda" and kind == "cpu" else branch


def _check_kernel_operands(kind, log_A, log_obs, *floats) -> None:
    """The kernels' route takes a flat batch, float32 on CUDA."""
    if log_A.ndim != 3 or log_obs.ndim != 3:
        raise ValueError(
            "the decode dispatch takes a flat batch: log_obs [N, T, K] with "
            f"log_A [N, K, K] or [N, T-1, K, K], got {tuple(log_obs.shape)} "
            f"and {tuple(log_A.shape)}"
        )
    if kind == "cuda" and any(t.dtype != torch.float32 for t in floats if t is not None):
        raise TypeError("the CUDA decode kernels take float32 log_pi/log_A/log_obs")


def _route(name, kernel, time_parallel, log_pi, log_A, log_obs, mask):
    """``(branch, span)`` of one decode call (``log_pi`` None for the
    beta pass)."""
    kind = _device_type(log_pi, log_A, log_obs, mask)
    T, K = log_obs.shape[-2:]
    tv = time_varying(log_A, log_obs)
    branch = resolve_routed(K, T, time_parallel, kernel=kernel, cuda_ok=not tv, device_type=kind)
    if branch == "cuda":
        _check_kernel_operands(kind, log_A, log_obs, log_pi, log_A, log_obs)
    return branch, _branch_span(name, _span_name(branch, kind), K, T)


def _ones_mask(log_obs: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is not None:
        return mask
    return torch.ones(log_obs.shape[:-1], dtype=log_obs.dtype, device=log_obs.device)


def forward_filter_dispatch(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    time_parallel: TimeParallel = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(log_alpha [N, T, K], loglik [N])``, the
    ``filtering.forward_filter`` contract."""
    branch, sp = _route("forward_filter", "filter", time_parallel, log_pi, log_A, log_obs, mask)
    with sp:
        if branch == "cuda":
            return semiring_filter(log_pi, log_A, log_obs, _ones_mask(log_obs, mask))
        if branch == "assoc":
            return forward_filter_assoc(log_pi, log_A, log_obs, mask)
        return forward_filter(log_pi, log_A, log_obs, mask)


def backward_dispatch(
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    time_parallel: TimeParallel = "auto",
) -> torch.Tensor:
    """``log_beta [N, T, K]``, the ``filtering.backward_pass``
    contract."""
    branch, sp = _route("backward", "filter", time_parallel, None, log_A, log_obs, mask)
    with sp:
        if branch == "cuda":
            return semiring_beta(log_A, log_obs, _ones_mask(log_obs, mask))
        if branch == "assoc":
            return backward_assoc(log_A, log_obs, mask)
        return backward_pass(log_A, log_obs, mask)


def smooth_dispatch(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    time_parallel: TimeParallel = "auto",
):
    """``(log_alpha, log_beta, log_gamma, loglik)``, the
    ``filtering.forward_backward`` contract; both passes take the same
    branch, and on the kernels' one they share one lane-layout copy of
    the operands."""
    branch, sp = _route("smooth", "filter", time_parallel, log_pi, log_A, log_obs, mask)
    with sp:
        if branch == "cuda":
            m = _ones_mask(log_obs, mask)
            pi_t, A_t, obs_t, mask_t, _, _ = to_lanes(log_pi, log_A, log_obs, m)
            ll, alpha_t = filter_lanes(pi_t, A_t, obs_t, mask_t)
            beta_t = beta_lanes(A_t, obs_t, mask_t)
            del pi_t, A_t, obs_t, mask_t
            log_alpha, log_beta = alpha_t.permute(2, 0, 1), beta_t.permute(2, 0, 1)
            return log_alpha, log_beta, smooth(log_alpha, log_beta), ll
        if branch == "assoc":
            return smooth_assoc(log_pi, log_A, log_obs, mask)
        return forward_backward(log_pi, log_A, log_obs, mask)


def viterbi_dispatch(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    time_parallel: TimeParallel = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(path [N, T] int64, log_prob [N])``, the ``viterbi.viterbi``
    contract and tie-breaking."""
    branch, sp = _route("viterbi", "viterbi", time_parallel, log_pi, log_A, log_obs, mask)
    with sp:
        if branch == "cuda":
            return semiring_viterbi(log_pi, log_A, log_obs, _ones_mask(log_obs, mask))
        if branch == "assoc":
            return viterbi_assoc(log_pi, log_A, log_obs, mask)
        return viterbi(log_pi, log_A, log_obs, mask)


def ffbs_dispatch(
    generator: torch.Generator,
    log_pi: torch.Tensor,  # [N, K]
    log_A: torch.Tensor,  # [N, K, K]
    log_obs: torch.Tensor,  # [N, T, K]
    mask: Optional[torch.Tensor] = None,
    gate_key: Optional[torch.Tensor] = None,
    state_key: Optional[torch.Tensor] = None,
    *,
    time_parallel: TimeParallel = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FFBS draw ``(z [N, T] int64, loglik [N])`` for a flat batch,
    homogeneous ``log_A`` only. Every branch draws the same ``u [N, T]``
    from ``generator`` and applies the same inverse-CDF rule (the
    kernels, ``ffbs_assoc``, ``ffbs_invcdf_reference``), so the routes
    give the same paths away from CDF bucket edges."""
    if (gate_key is None) != (state_key is None):
        raise ValueError("gate_key and state_key must be given together")
    if log_A.ndim != 3:
        raise ValueError(
            f"ffbs_dispatch needs homogeneous log_A [N, K, K], got {tuple(log_A.shape)}"
        )
    kind = _device_type(log_pi, log_A, log_obs, mask, gate_key, state_key, what="FFBS")
    N, T, K = log_obs.shape
    branch = resolve_routed(K, T, time_parallel, kernel="ffbs", device_type=kind)
    if branch == "cuda" and kind == "cuda":
        if any(t.dtype != torch.float32 for t in (log_pi, log_A, log_obs)):
            raise TypeError("the CUDA FFBS kernels take float32 log_pi/log_A/log_obs")
    with _branch_span("ffbs", _span_name(branch, kind), K, T):
        if branch == "cuda":
            return ffbs_fused(generator, log_pi, log_A, log_obs, mask, gate_key, state_key)
        if state_key is not None:
            state_key = state_key.expand(N, K)
        if branch == "assoc":
            return ffbs_assoc_sample(generator, log_pi, log_A, log_obs, mask, gate_key, state_key)
        u = torch.rand((N, T), generator=generator, dtype=log_obs.dtype, device=log_obs.device)
        return ffbs_invcdf_reference(
            log_pi, log_A, log_obs, _ones_mask(log_obs, mask), u, gate_key, state_key
        )
