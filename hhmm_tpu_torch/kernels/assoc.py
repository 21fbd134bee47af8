"""Time-parallel HMM scans (counterpart of ``hhmm_tpu/kernels/assoc.py``):
O(log T)-depth filtering, smoothing, Viterbi, FFBS, and the
sequence-sharded filter.

The sequential recursions (``kernels/filtering.py``, ``viterbi.py``,
``ffbs.py`` and the CUDA kernels) carry a T-step dependency chain. The
whole family is a prefix or suffix product in an associative semiring
(``kernels/semiring.py``; Särkkä & García-Fernández 2020), so an
associative scan evaluates it at O(log T) depth for O(K³ T) work:

- :func:`forward_filter_assoc` — prefix products of ``M_t = log_A_t +
  log_obs[t]`` in (logsumexp, +); the ``filtering.forward_filter``
  contract.
- :func:`backward_assoc` — suffix products of the same operators, then
  a row reduction; the ``filtering.backward_pass`` contract.
- :func:`smooth_assoc` — both, and the guarded normalisation; the
  ``filtering.forward_backward`` contract.
- :func:`viterbi_assoc` — the (max, +) prefix scan for delta, then the
  per-step argmax backpointer maps suffix-composed by a second scan (map
  composition is associative), so the backtrack is O(log T) too.
- :func:`ffbs_assoc` — every backward draw ``z_t = invcdf(alpha_t +
  log_A[:, z_{t+1}], u_t)`` precomputed for all K successors as a
  sampling map, the path the suffix composition of the maps; the draw
  rule of ``ffbs.ffbs_invcdf_reference`` (z = #{k < K−1 : u ≥ cum_k}),
  so given the same uniforms the routes agree draw for draw.
- :func:`forward_filter_seqshard` — the time axis cut into chunks, one
  a device of a list, in one process: each chunk prefix-scans its own
  operators, the chunk totals are gathered on the first device (the JAX
  ``all_gather``), and each chunk's prefixes are corrected by the
  exclusive product of the chunks before it.

PyTorch has no associative scan; :func:`_scan` is the odd/even
recursion of ``jax.lax.associative_scan`` (the same combine tree, so
the f32 sums come in the JAX order), and :func:`_suffix_scan` keeps the
JAX module's operand flip for a reversed scan of a non-commutative
combine. Every function takes any leading batch axes ``...`` (a
time-varying ``log_A`` carries all of them: ``[..., T-1, K, K]``) and
runs the lanes in blocks, so that a combine's ``[..., K, K, K]``
intermediate stays under ``_COMBINE_BYTES``; a block holds whole lanes
and a combine cuts only its rows, so blocking changes no result. Masked
steps are semiring identities, and every (logsumexp, +) reduction is
the guarded ``safe_logsumexp`` (an all-(−inf) row gives −inf, not NaN).
Plain PyTorch ops on either device: there is no CUDA kernel here.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from hhmm_tpu_torch.core.lmath import safe_log_normalize, safe_logsumexp
from hhmm_tpu_torch.kernels.semiring import (
    compose_maps,
    identity_map,
    logsumexp_matmul,
    maxplus_matmul,
    semiring_eye,
    step_operators,
)

__all__ = [
    "forward_filter_assoc",
    "backward_assoc",
    "smooth_assoc",
    "viterbi_assoc",
    "ffbs_assoc",
    "ffbs_assoc_sample",
    "forward_filter_seqshard",
]

# the most bytes a combine's [rows, K, K, K] intermediate may take; a
# lane block holds as many lanes as keep one level's combine under it
_COMBINE_BYTES = 1 << 28


def _time_varying(log_A: torch.Tensor, log_obs: torch.Tensor) -> bool:
    """Whether ``log_A`` is the per-step ``[..., T-1, K, K]`` form (the
    ``filtering.time_varying`` rule: one more axis than ``log_obs``);
    the step count is checked unless T = 1, where a time-varying caller
    legitimately has no transition to take (the JAX early return)."""
    if log_A.ndim != log_obs.ndim + 1:
        return False
    T = log_obs.shape[-2]
    if T > 1 and log_A.shape[-3] != T - 1:
        raise ValueError(f"time-varying log_A must have T-1={T - 1} slices, got {log_A.shape[-3]}")
    return True


def _sl(ndim: int, dim: int, s: slice):
    idx = [slice(None)] * ndim
    idx[dim] = s
    return tuple(idx)


def _rows(fn: Callable, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """``fn(P, Q)`` over ``[..., K, K]`` operands of one shape, cut into
    row chunks so that the ``[rows, K, K, K]`` intermediate stays under
    ``_COMBINE_BYTES`` (every row is computed alone: the cut changes no
    result)."""
    K = P.shape[-1]
    lead = P.shape[:-2]
    rows = math.prod(lead)
    per = max(1, _COMBINE_BYTES // (K ** 3 * P.element_size()))
    if rows <= per:
        return fn(P, Q)
    Pf, Qf = P.reshape(rows, K, K), Q.reshape(rows, K, K)
    out = torch.cat([fn(Pf[i : i + per], Qf[i : i + per]) for i in range(0, rows, per)])
    return out.reshape(lead + (K, K))


def _lsm(P, Q):
    return _rows(logsumexp_matmul, P, Q)


def _mpm(P, Q):
    return _rows(maxplus_matmul, P, Q)


def _scan(combine: Callable, elems: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Inclusive prefix products along ``dim``: ``out[t] = elems[0] ⊗ …
    ⊗ elems[t]``, by the odd/even recursion of ``jax.lax.
    associative_scan`` (pairs combined, the half-length scan recursed,
    the even outputs one combine from the odd ones, interleaved)."""
    n = elems.shape[dim]
    if n < 2:
        return elems
    nd = elems.ndim
    reduced = combine(elems[_sl(nd, dim, slice(0, -1, 2))], elems[_sl(nd, dim, slice(1, None, 2))])
    odd = _scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine(odd[_sl(nd, dim, slice(0, -1))], elems[_sl(nd, dim, slice(2, None, 2))])
    else:
        even = combine(odd, elems[_sl(nd, dim, slice(2, None, 2))])
    even = torch.cat([elems[_sl(nd, dim, slice(0, 1))], even], dim=dim)
    out = torch.empty_like(elems)
    out[_sl(nd, dim, slice(0, None, 2))] = even
    out[_sl(nd, dim, slice(1, None, 2))] = odd
    return out


def _suffix_scan(combine: Callable, elems: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Suffix products ``out[t] = elems[t] ⊗ … ⊗ elems[-1]`` in the
    original operand order: the sequence is flipped, so the combine is
    flipped too (``combine`` itself would evaluate ``elems[-1] ⊗ … ⊗
    elems[t]``, wrong for matrices and maps)."""
    rev = _scan(lambda a, b: combine(b, a), torch.flip(elems, (dim,)), dim)
    return torch.flip(rev, (dim,))


def _log_vecmat(log_x: torch.Tensor, log_M: torch.Tensor) -> torch.Tensor:
    """Guarded row vector × matrix ``out[..., j] = lse_i(x[..., i] +
    M[..., i, j])``: prefix products of identity operators leave
    all-(−inf) columns, which the sequential filter never meets."""
    return safe_logsumexp(log_x[..., :, None] + log_M, dim=-2)


def _alpha0(log_pi, log_obs0, mask0):
    a0 = log_pi + log_obs0
    if mask0 is not None:
        a0 = torch.where(mask0[..., None] > 0, a0, log_pi)
    return a0


def _flat(lead, x: Optional[torch.Tensor], event_ndim: int) -> Optional[torch.Tensor]:
    """``x`` broadcast to the leading axes ``lead`` and flattened to one
    lane axis."""
    if x is None:
        return None
    event = tuple(x.shape[x.ndim - event_ndim :])
    return x.expand(tuple(lead) + event).reshape((-1,) + event)


def _blocked(core: Callable, lead, T: int, K: int, itemsize: int, *args):
    """``core`` over lane blocks of the flat lane axis, outputs joined
    and given back the leading axes ``lead``. A block holds at most as
    many lanes as keep a first-level combine (``T/2`` rows a lane) under
    ``_COMBINE_BYTES``."""
    N = math.prod(lead)
    per = max(1, _COMBINE_BYTES // (max(1, T // 2) * K ** 3 * itemsize))
    if N <= per:
        outs = core(*args)
    else:
        parts = [core(*[None if a is None else a[s : s + per] for a in args]) for s in range(0, N, per)]
        outs = tuple(torch.cat(p) for p in zip(*parts))
    return tuple(o.reshape(tuple(lead) + o.shape[1:]) for o in outs)


def _lanes(log_pi, log_A, log_obs, mask):
    """Leading axes, T, K, and the four operands flat over lanes
    (``log_pi`` may be None; ``log_A`` keeps its time axis if it has
    one)."""
    T, K = log_obs.shape[-2:]
    lead = log_obs.shape[:-2]
    tv = _time_varying(log_A, log_obs)
    return lead, T, K, (
        _flat(lead, log_pi, 1),
        _flat(lead, log_A, 3 if tv else 2),
        _flat(lead, log_obs, 2),
        _flat(lead, mask, 1),
    )


# ---- cores over one flat lane axis (time on dim 1) ----


def _filter_core(log_pi, log_A, log_obs, mask):
    T = log_obs.shape[1]
    a0 = _alpha0(log_pi, log_obs[:, 0], None if mask is None else mask[:, 0])
    if T == 1:
        return a0[:, None], safe_logsumexp(a0, dim=-1)
    prefix = _scan(_lsm, step_operators(log_A, log_obs, mask))  # [n, T-1, K, K]
    log_alpha = torch.cat([a0[:, None], _log_vecmat(a0[:, None], prefix)], dim=1)
    return log_alpha, safe_logsumexp(log_alpha[:, -1], dim=-1)


def _beta_core(log_A, log_obs, mask):
    n, T, K = log_obs.shape
    zero = torch.zeros((n, 1, K), dtype=log_obs.dtype, device=log_obs.device)
    if T == 1:
        return (zero,)
    suffix = _suffix_scan(_lsm, step_operators(log_A, log_obs, mask))
    return (torch.cat([safe_logsumexp(suffix, dim=-1), zero], dim=1),)


def _last_state(comp: torch.Tensor, z_last: torch.Tensor) -> torch.Tensor:
    """``comp[:, t, z_last]`` for every t: the composed maps at the
    final state."""
    return comp.gather(-1, z_last[:, None, None].expand(comp.shape[:2] + (1,)))[..., 0]


def _viterbi_core(log_pi, log_A, log_obs, mask):
    n, T, K = log_obs.shape
    delta0 = log_pi + log_obs[:, 0]
    if T == 1:
        return torch.argmax(delta0, dim=-1)[:, None], delta0.amax(dim=-1)
    lA = log_A if log_A.ndim == 4 else log_A[:, None]
    prefix = _scan(_mpm, step_operators(log_A, log_obs, mask))  # [n, T-1, K, K]
    delta_rest = (delta0[:, None, :, None] + prefix).amax(dim=2)  # [n, T-1, K]
    delta = torch.cat([delta0[:, None], delta_rest], dim=1)
    # backpointers of steps 1..T-1 at once (first max: the lowest index);
    # a masked step's map is the identity, as in the sequential scan
    back = torch.argmax(delta[:, :-1, :, None] + lA, dim=2)  # [n, T-1, K]
    if mask is not None:
        back = torch.where(mask[:, 1:, None] > 0, back, identity_map(K, log_obs.device))
    z_last = torch.argmax(delta[:, -1], dim=-1)
    path = torch.cat([_last_state(_suffix_scan(compose_maps, back), z_last), z_last[:, None]], 1)
    return path, delta[:, -1].amax(dim=-1)


def _invcdf_cols(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draws along the state axis −2, a column each:
    ``out[..., j] = #{i < K-1 : u >= cum_i}`` over the normalised
    ``exp(logits[..., :, j])`` (``ffbs._invcdf`` applied per column)."""
    p = torch.softmax(logits, dim=-2)
    cum = torch.cumsum(p[..., :-1, :], dim=-2)
    return (u[..., None, None] >= cum).sum(dim=-2)


def _ffbs_core(log_pi, log_A, log_obs, mask, u, gate_key, state_key):
    n, T, K = log_obs.shape
    if gate_key is None:
        log_alpha, ll = _filter_core(log_pi, log_A, log_obs, mask)
    else:
        # the gate on each destination, materialised [n, T-1, K, K] (the
        # reference's construction: a gate-inconsistent successor is a
        # unit pairwise factor)
        c = gate_key[:, :, None] == state_key[:, None, :]  # [n, T, K]
        log_A_t = torch.where(c[:, 1:, None, :], log_A[:, None], 0.0)
        log_alpha, ll = _filter_core(log_pi, log_A_t, log_obs, mask)
    z_last = _invcdf_cols(log_alpha[:, T - 1, :, None], u[:, T - 1])[:, 0]
    if T == 1:
        return z_last[:, None], ll
    # sampling maps S[t][j]: the state drawn at t given z_{t+1} = j; a
    # masked or gate-inconsistent successor draws from the filter alone
    g = (mask[:, 1:] > 0)[:, :, None]
    if gate_key is not None:
        g = g & (gate_key[:, 1:, None] == state_key[:, None, :])  # [n, T-1, K]
    else:
        g = g.expand(n, T - 1, K)
    alpha = log_alpha[:, :-1, :, None]
    logits = torch.where(g[:, :, None, :], alpha + log_A[:, None], alpha)  # [n, T-1, K(i), K(j)]
    S = _invcdf_cols(logits, u[:, :-1])  # [n, T-1, K]
    z = torch.cat([_last_state(_suffix_scan(compose_maps, S), z_last), z_last[:, None]], dim=1)
    # the padded tail repeats the last valid state
    t_last = mask.sum(-1).long() - 1
    last = z.gather(1, torch.remainder(t_last, T)[:, None])
    return torch.where(torch.arange(T, dtype=torch.long, device=z.device) <= t_last[:, None], z, last), ll


# ---- public entries ----


def forward_filter_assoc(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(log_alpha [..., T, K], loglik [...])``, the
    ``filtering.forward_filter`` contract (homogeneous or time-varying
    ``log_A``, optional mask), by an associative prefix scan."""
    lead, T, K, args = _lanes(log_pi, log_A, log_obs, mask)
    return _blocked(_filter_core, lead, T, K, log_obs.element_size(), *args)


def backward_assoc(
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``log_beta [..., T, K]``, the ``filtering.backward_pass``
    contract: ``beta[t][i] = lse_j (M_{t+1} ⊗ … ⊗ M_{T-1})[i, j]``, one
    reversed scan and a row reduction."""
    lead, T, K, (_, lA, lo, m) = _lanes(None, log_A, log_obs, mask)
    return _blocked(_beta_core, lead, T, K, log_obs.element_size(), lA, lo, m)[0]


def smooth_assoc(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
):
    """``(log_alpha, log_beta, log_gamma, loglik)``, the
    ``filtering.forward_backward`` contract: both scans and the guarded
    normalisation."""
    log_alpha, loglik = forward_filter_assoc(log_pi, log_A, log_obs, mask)
    log_beta = backward_assoc(log_A, log_obs, mask)
    return log_alpha, log_beta, safe_log_normalize(log_alpha + log_beta, dim=-1), loglik


def viterbi_assoc(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(path [..., T] int64, log_prob [...])``, the ``viterbi.viterbi``
    contract (argmax ties to the lowest index), both phases
    time-parallel: delta by a (max, +) prefix scan, the backtrack by
    the suffix composition of the backpointer maps."""
    lead, T, K, args = _lanes(log_pi, log_A, log_obs, mask)
    return _blocked(_viterbi_core, lead, T, K, log_obs.element_size(), *args)


def ffbs_assoc(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: torch.Tensor,
    u: torch.Tensor,
    gate_key: Optional[torch.Tensor] = None,
    state_key: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(z [..., T] int64, loglik [...])`` with the draw rule of
    ``ffbs.ffbs_invcdf_reference`` from the uniforms ``u [..., T]``:
    homogeneous ``log_A [..., K, K]``, optional ``gate_key [..., T]`` /
    ``state_key [..., K]`` gating. Both passes are scans: the filter,
    and the suffix composition of the per-step sampling maps."""
    if (gate_key is None) != (state_key is None):
        raise ValueError("gate_key and state_key must be given together")
    if _time_varying(log_A, log_obs):
        raise ValueError(
            f"ffbs_assoc needs homogeneous log_A [..., K, K], got shape {tuple(log_A.shape)}; "
            "use ffbs_sample for time-varying transitions"
        )
    lead, T, K, args = _lanes(log_pi, log_A, log_obs, mask)
    gate = (_flat(lead, gate_key, 1), _flat(lead, state_key, 1))
    return _blocked(_ffbs_core, lead, T, K, log_obs.element_size(), *args, _flat(lead, u, 1), *gate)


def ffbs_assoc_sample(
    generator: torch.Generator,
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    gate_key: Optional[torch.Tensor] = None,
    state_key: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ffbs_assoc` with ``ffbs.ffbs_fused``'s uniform convention
    (``u`` of ``log_obs.shape[:-1]`` drawn from ``generator``), so the
    two routes draw the same paths from the same generator state."""
    if mask is None:
        mask = torch.ones(log_obs.shape[:-1], dtype=log_obs.dtype, device=log_obs.device)
    u = torch.rand(log_obs.shape[:-1], generator=generator, dtype=log_obs.dtype, device=log_obs.device)
    return ffbs_assoc(log_pi, log_A, log_obs, mask, u, gate_key, state_key)


# ---- sequence sharding: the time axis over a list of devices ----


def forward_filter_seqshard(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    devices: Sequence,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-parallel forward filter in one process: the time axis of
    ``log_obs`` / ``mask`` cut into ``len(devices)`` chunks, chunk d on
    ``devices[d]``. Returns ``(log_alpha, loglik)`` on ``devices[0]``.

    Homogeneous ``log_A`` only, and T divisible by the shard count, as
    in the JAX function. ``log_obs [T, K]`` with ``log_pi [K]``,
    ``log_A [K, K]``; or, the JAX ``batch_axis_name`` form, a leading
    series axis on all four (``[B, T, K]``, ``[B, K]``, ``[B, K, K]``,
    ``[B, T]``).

    The chunk algebra is the JAX body's: ``alpha_t = a0 ⊗ M_1 ⊗ … ⊗
    M_t``; chunk 0's first operator (the global M_0, which does not
    exist) is the identity; each chunk prefix-scans its operators, the
    chunk totals come to the first device, and chunk d's carry-in is
    ``a0 ⊗ (total_0 ⊗ … ⊗ total_{d-1})``, folded in that order."""
    batched = log_obs.ndim == 3
    if log_obs.ndim not in (2, 3):
        raise ValueError(f"log_obs must be [T, K] or [B, T, K], got shape {tuple(log_obs.shape)}")
    if log_A.ndim != log_obs.ndim:
        raise ValueError(
            "forward_filter_seqshard supports homogeneous (per-series) log_A only: expected "
            + ("[B, K, K]" if batched else "[K, K]") + f", got shape {tuple(log_A.shape)}"
        )
    devices = [torch.device(d) for d in devices]
    D = len(devices)
    T, K = log_obs.shape[-2:]
    if D < 1 or T % D != 0:
        raise ValueError(f"T={T} must be divisible by the shard count {D}")
    if mask is None:
        mask = torch.ones(log_obs.shape[:-1], dtype=log_obs.dtype, device=log_obs.device)
    if not batched:  # one series: a leading axis of one
        log_pi, log_A, log_obs, mask = log_pi[None], log_A[None], log_obs[None], mask[None]
    Tl = T // D
    dev0 = devices[0]
    eye0 = semiring_eye(K, log_obs.dtype, dev0)
    prefixes, totals = [], []
    for d, dev in enumerate(devices):
        obs_d = log_obs[:, d * Tl : (d + 1) * Tl].to(dev)
        mask_d = mask[:, d * Tl : (d + 1) * Tl].to(dev)
        eye = semiring_eye(K, log_obs.dtype, dev)
        M = log_A.to(dev)[:, None] + obs_d[:, :, None, :]  # [B, Tl, K, K]
        M = torch.where(mask_d[:, :, None, None] > 0, M, eye)
        if d == 0:
            M = torch.cat([eye.expand(M.shape[0], 1, K, K), M[:, 1:]], dim=1)
        prefix = _scan(_lsm, M)
        prefixes.append(prefix)
        totals.append(prefix[:, -1].to(dev0))
    a0 = _alpha0(log_pi.to(dev0), log_obs[:, 0].to(dev0), mask[:, 0].to(dev0))
    alphas = []
    excl = eye0.expand(a0.shape[0], K, K)
    for d, dev in enumerate(devices):
        carry_in = _log_vecmat(a0, excl).to(dev)
        alphas.append(_log_vecmat(carry_in[:, None], prefixes[d]).to(dev0))
        excl = logsumexp_matmul(excl, totals[d])
    log_alpha = torch.cat(alphas, dim=1)
    ll = safe_logsumexp(log_alpha[:, -1], dim=-1)
    return (log_alpha, ll) if batched else (log_alpha[0], ll[0])
