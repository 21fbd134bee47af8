"""The semiring kernels for Hopper (counterpart of
``hhmm_tpu/kernels/pallas_semiring.py``) and their plain PyTorch
versions.

Seven CUDA kernels (sources in ``kernels/csrc``), one for each Pallas
kernel of that module:

- ``FWD`` (``ffbs_fwd.cu``) replaces ``_fwd_kernel``: the clamped forward
  filter, optionally sign-gated, that writes every step's alpha to a
  residual and returns ``ll = lse0(alpha_last)``;
- ``BWD_SAMPLE`` (``ffbs_bwd_sample.cu``) replaces ``_bwd_sample_kernel``:
  inverse-CDF backward sampling against pre-drawn uniforms, as every
  candidate draw of every step packed into one map word a step, then a
  pointer chase through the maps;
- ``VG_BWD`` (``vg_bwd.cu``) replaces ``_bwd_kernel``: the clamped
  backward recursion with the Baum-Welch gradients ``(d_pi, d_A,
  d_obs)`` of the forward log-likelihood;
- ``FILTER`` (``semiring_filter.cu``) replaces ``_semiring_fwd_kernel``
  in mode "filter": the guarded forward filter of the decode (an
  all-(−inf) row stays −inf, never NaN);
- ``BETA`` (``semiring_beta.cu``) replaces ``_beta_kernel``: the guarded
  backward recursion;
- ``VITERBI`` and ``BACKTRACK`` (``semiring_viterbi.cu``) replace
  ``_semiring_fwd_kernel`` in mode "viterbi" and ``_backtrack_kernel``:
  the max-plus pass writing one first-argmax backpointer map per step
  (packed four bits a state into an int32 word), and the walk back
  through the maps.

All work on the batch-minor lane layout (``[T, K, N]`` residual, lane
fastest); :func:`to_lanes` makes it from the JAX package's ``[N, T, K]``
layout, which the public entries :func:`semiring_ffbs`,
:func:`semiring_vg`, :func:`forward_chunked`, :func:`semiring_filter`,
:func:`semiring_beta` and :func:`semiring_viterbi` keep.

Routing is by the tensors' device and nothing else: a CPU tensor runs
the plain version (``*_plain`` — Python loops over t with the kernels'
exact arithmetic), a CUDA tensor launches the kernel or raises. There is
no fallback from a kernel to its plain version. ``kernel.launches``
counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from hhmm_tpu_torch.kernels.cuda_build import CudaKernel, build_and_load

__all__ = [
    "FWD",
    "BWD_SAMPLE",
    "VG_BWD",
    "FILTER",
    "BETA",
    "VITERBI",
    "BACKTRACK",
    "KERNELS",
    "build_kernels",
    "reset_launches",
    "to_lanes",
    "fwd_lanes",
    "bwd_sample_lanes",
    "vg_bwd_lanes",
    "filter_lanes",
    "beta_lanes",
    "viterbi_lanes",
    "backtrack_lanes",
    "fwd_plain",
    "bwd_sample_plain",
    "vg_bwd_plain",
    "filter_plain",
    "beta_plain",
    "viterbi_plain",
    "backtrack_plain",
    "unpack_back",
    "forward_chunked",
    "semiring_ffbs",
    "semiring_vg",
    "semiring_filter",
    "semiring_beta",
    "semiring_viterbi",
]

_CLAMP = -1.0e30
CUDA_KS = (2, 3, 4, 8)
# BWD_SAMPLE keeps its packed candidate maps in shared memory up to this T
# (kSmemMaxT in ffbs_bwd_sample.cu), beyond it in an int32 scratch of T
# rounded up to a multiple of 32 words a lane (map_words)
_BWD_SMEM_MAX_T = 2048

_P = ctypes.c_void_p
_I = ctypes.c_int
FWD = CudaKernel(
    "ffbs_fwd",
    "ffbs_fwd.cu",
    "hhmm_ffbs_fwd",
    # K, gated, pi, A, obs, mask, gate, sk, ll, alpha, T, N, stream
    [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "hhmm_tpu/kernels/pallas_semiring.py:287",
)
BWD_SAMPLE = CudaKernel(
    "ffbs_bwd_sample",
    "ffbs_bwd_sample.cu",
    "hhmm_ffbs_bwd_sample",
    # K, gated, A, mask, alpha, u, gate, sk, z, scratch, T, N, stream
    [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "hhmm_tpu/kernels/pallas_semiring.py:584",
)
VG_BWD = CudaKernel(
    "vg_bwd",
    "vg_bwd.cu",
    "hhmm_vg_bwd",
    # K, gated, A, obs, mask, alpha, ll, gate, sk, d_pi, d_A, d_obs, T, N, stream
    [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "hhmm_tpu/kernels/pallas_semiring.py:435",
)
FILTER = CudaKernel(
    "semiring_filter",
    "semiring_filter.cu",
    "hhmm_semiring_filter",
    # K, pi, A, obs, mask, ll, alpha, T, N, stream
    [_I, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "hhmm_tpu/kernels/pallas_semiring.py:361",
)
BETA = CudaKernel(
    "semiring_beta",
    "semiring_beta.cu",
    "hhmm_semiring_beta",
    # K, A, obs, mask, beta, T, N, stream
    [_I, _P, _P, _P, _P, _I, _I, _P],
    "hhmm_tpu/kernels/pallas_semiring.py:510",
)
VITERBI = CudaKernel(
    "viterbi_fwd",
    "semiring_viterbi.cu",
    "hhmm_viterbi_fwd",
    # K, pi, A, obs, mask, score, dlast, back, T, N, stream
    [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "hhmm_tpu/kernels/pallas_semiring.py:361",
)
BACKTRACK = CudaKernel(
    "viterbi_backtrack",
    "semiring_viterbi.cu",
    "hhmm_viterbi_backtrack",
    # K, back, dlast, path, T, N, stream
    [_I, _P, _P, _P, _I, _I, _P],
    "hhmm_tpu/kernels/pallas_semiring.py:552",
)
KERNELS = (FWD, BWD_SAMPLE, VG_BWD, FILTER, BETA, VITERBI, BACKTRACK)


def build_kernels() -> dict:
    """Build every kernel of this module now, all sources in parallel
    (otherwise each builds at its first CUDA call)."""
    return build_and_load(KERNELS)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


def _check_same_device(*tensors) -> torch.device:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"operands must share one device, got {sorted(map(str, devs))}")
    return devs.pop()


def to_lanes(
    log_pi: Optional[torch.Tensor],  # [N, K], or None (the beta pass)
    log_A: torch.Tensor,  # [N, K, K] (homogeneous)
    log_obs: torch.Tensor,  # [N, T, K]
    mask: torch.Tensor,  # [N, T]
    gate_key: Optional[torch.Tensor] = None,  # [N, T]
    state_key: Optional[torch.Tensor] = None,  # [N, K] or [K]
):
    """JAX layout → the kernels' batch-minor lane layout, contiguous:
    ``pi [K, N]``, ``A [K, K, N]``, ``obs [T, K, N]``, ``mask [T, N]``,
    ``gate [T, N]``, ``sk [K, N]`` (the last two None when ungated;
    ``pi`` None when ``log_pi`` is). Mask and gate keys take
    ``log_obs``'s dtype."""
    if (gate_key is None) != (state_key is None):
        raise ValueError("gate_key and state_key must be given together")
    if log_obs.ndim != 3:
        raise ValueError(f"log_obs must be [N, T, K], got {tuple(log_obs.shape)}")
    N, T, K = log_obs.shape
    if log_pi is not None and tuple(log_pi.shape) != (N, K):
        raise ValueError(f"log_pi must be [N, K] = {(N, K)}, got {tuple(log_pi.shape)}")
    if tuple(log_A.shape) != (N, K, K):
        raise ValueError(
            f"log_A must be homogeneous [N, K, K] = {(N, K, K)}, got {tuple(log_A.shape)}"
        )
    if tuple(mask.shape) != (N, T):
        raise ValueError(f"mask must be [N, T] = {(N, T)}, got {tuple(mask.shape)}")
    _check_same_device(log_pi, log_A, log_obs, mask, gate_key, state_key)
    dt = log_obs.dtype
    pi_t = None if log_pi is None else log_pi.t().contiguous()
    A_t = log_A.permute(1, 2, 0).contiguous()
    obs_t = log_obs.permute(1, 2, 0).contiguous()
    mask_t = mask.to(dt).t().contiguous()
    gate_t = sk_t = None
    if gate_key is not None:
        if tuple(gate_key.shape) != (N, T):
            raise ValueError(f"gate_key must be [N, T], got {tuple(gate_key.shape)}")
        sk = state_key.expand(N, K) if state_key.ndim == 1 else state_key
        if tuple(sk.shape) != (N, K):
            raise ValueError(f"state_key must be [K] or [N, K], got {tuple(state_key.shape)}")
        gate_t = gate_key.to(dt).t().contiguous()
        sk_t = sk.to(dt).t().contiguous()
    return pi_t, A_t, obs_t, mask_t, gate_t, sk_t


def _check_lane_shapes(T: int, K: int, N: int, **named) -> None:
    """Every lane-layout operand has the shape its kernel indexes it
    with (the kernels read through raw pointers: a short operand would
    be read out of bounds), and the gate operands come together."""
    if (named.get("gate") is None) != (named.get("sk") is None):
        raise ValueError("gate and sk must be given together")
    want = {
        "pi": (K, N), "A": (K, K, N), "obs": (T, K, N), "alpha": (T, K, N),
        "mask": (T, N), "u": (T, N), "gate": (T, N), "sk": (K, N),
        "ll": (N,), "back": (T, N), "dlast": (K, N),
    }
    for name, t in named.items():
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(
                f"{name} must be {want[name]} in the lane layout, got {tuple(t.shape)}"
            )


def _check_cuda_operands(K: int, *tensors) -> None:
    if K not in CUDA_KS:
        raise ValueError(f"the CUDA kernels take K in {CUDA_KS}, got K={K}")
    for t in tensors:
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32 operands, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous lane-layout operands")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# plain versions (the kernels' exact arithmetic, as loops over t)
# ---------------------------------------------------------------------------


def _lse0(x: torch.Tensor) -> torch.Tensor:
    """Clamped logsumexp over axis 0 (`pallas_semiring._lse0`): the max
    is clamped at ``_CLAMP`` and the exponentials are summed in index
    order, as the kernels sum them."""
    m = x.amax(0).clamp_min(_CLAMP)
    e = torch.exp(x - m)
    s = e[0]
    for k in range(1, x.shape[0]):
        s = s + e[k]
    return m + torch.log(s)


def _lse1(x: torch.Tensor) -> torch.Tensor:
    """Clamped logsumexp over axis 1 of ``[K, K, N]``
    (`pallas_semiring._lse1`), exponentials summed in index order."""
    m = x.amax(1).clamp_min(_CLAMP)
    e = torch.exp(x - m[:, None])
    s = e[:, 0]
    for j in range(1, x.shape[1]):
        s = s + e[:, j]
    return m + torch.log(s)


def _invcdf(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw over axis 0 of ``logits [K, N]`` against ``u
    [N]`` (`pallas_semiring._sample_invcdf`): ``z = #{k < K-1 : u >=
    cum_k}`` with a running f32 ``cum``."""
    p = torch.exp(logits - _lse0(logits))
    cum = torch.zeros_like(u)
    z = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    for k in range(logits.shape[0] - 1):
        cum = cum + p[k]
        z += (u >= cum).to(torch.int32)
    return z


def fwd_plain(pi_t, A_t, obs_t, mask_t, gate_t=None, sk_t=None):
    """Plain version of the ``FWD`` kernel on the lane layout:
    ``(ll [N], alpha [T, K, N])``."""
    T = obs_t.shape[0]
    alpha = torch.where(mask_t[0] > 0, pi_t + obs_t[0], pi_t)
    out = torch.empty_like(obs_t)
    out[0] = alpha
    for t in range(1, T):
        A = A_t
        if gate_t is not None:
            c = (gate_t[t] == sk_t).to(A_t.dtype)  # [K(j), N]
            A = A_t * c[None]
        new = _lse0(alpha[:, None, :] + A) + obs_t[t]
        alpha = torch.where(mask_t[t] > 0, new, alpha)
        out[t] = alpha
    return _lse0(alpha), out


def bwd_sample_plain(A_t, mask_t, alpha_t, u_t, gate_t=None, sk_t=None):
    """Plain version of the ``BWD_SAMPLE`` kernel on the lane layout:
    ``z [T, N]`` int32 (no tail repeat; the wrapper applies it)."""
    T, K, N = alpha_t.shape
    lane = torch.arange(N, device=alpha_t.device)
    z = torch.empty((T, N), dtype=torch.int32, device=alpha_t.device)
    zn = _invcdf(alpha_t[T - 1], u_t[T - 1])
    z[T - 1] = zn
    for t in range(T - 2, -1, -1):
        zl = zn.long()
        g = (mask_t[t + 1] > 0).to(alpha_t.dtype)
        if gate_t is not None:
            g = g * (gate_t[t + 1] == sk_t[zl, lane]).to(alpha_t.dtype)
        logits = alpha_t[t] + g[None] * A_t[:, zl, lane]
        zn = _invcdf(logits, u_t[t])
        z[t] = zn
    return z


def vg_bwd_plain(A_t, obs_t, mask_t, alpha_t, ll, gate_t=None, sk_t=None):
    """Plain version of the ``VG_BWD`` kernel on the lane layout:
    ``(d_pi [K, N], d_A [K, K, N], d_obs [T, K, N])`` from the forward
    pass's ``alpha [T, K, N]`` and ``ll [N]``."""
    T, K, N = obs_t.shape
    beta = torch.zeros((K, N), dtype=obs_t.dtype, device=obs_t.device)
    dA = torch.zeros((K, K, N), dtype=obs_t.dtype, device=obs_t.device)
    d_obs = torch.empty_like(obs_t)
    for t in range(T - 1, 0, -1):
        m01 = (mask_t[t] > 0).to(obs_t.dtype)
        d_obs[t] = torch.exp(alpha_t[t] + beta - ll) * m01
        e = obs_t[t] + beta  # [K(j), N]
        Ag = A_t
        if gate_t is not None:
            c = (gate_t[t] == sk_t).to(A_t.dtype)  # [K(j), N]
            Ag = A_t * c[None]
        xi = torch.exp(alpha_t[t - 1][:, None, :] + Ag + e[None] - ll)
        if gate_t is not None:
            xi = xi * c[None]
        dA = dA + xi * m01
        beta = torch.where(mask_t[t] > 0, _lse1(Ag + e[None]), beta)
    gamma0 = torch.exp(alpha_t[0] + beta - ll)
    d_obs[0] = gamma0 * (mask_t[0] > 0).to(obs_t.dtype)
    return gamma0, dA, d_obs


def _safe_lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Guarded logsumexp over ``dim`` (`pallas_semiring._safe_lse0` /
    ``_safe_lse1``): an all-(−inf) fiber gives −inf, never NaN; any
    other is ``m + log(sum exp(x - m))`` with the exponentials summed in
    index order, as the kernels sum them."""
    m = x.amax(dim)
    live = m != float("-inf")
    ms = torch.where(live, m, torch.zeros_like(m))
    e = torch.exp(x - ms.unsqueeze(dim))
    s = e.select(dim, 0)
    for k in range(1, x.shape[dim]):
        s = s + e.select(dim, k)
    return torch.where(live, ms + torch.log(s), torch.full_like(m, float("-inf")))


def _argmax0(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-max ``(max, argmax)`` over axis 0 (`pallas_semiring.
    _argmax0`): strict ``>`` over ascending index, so the lowest index
    wins a tie and an all-(−inf) fiber gives 0."""
    best = x[0]
    arg = torch.zeros(best.shape, dtype=torch.int32, device=x.device)
    for i in range(1, x.shape[0]):
        gt = x[i] > best
        best = torch.where(gt, x[i], best)
        arg = torch.where(gt, torch.full_like(arg, i), arg)
    return best, arg


def _identity_map(K: int) -> int:
    """The packed identity backpointer map: nibble j holds j."""
    return sum(j << (4 * j) for j in range(K))


def unpack_back(back_t: torch.Tensor, K: int) -> torch.Tensor:
    """Packed maps ``[T, N]`` int32 → backpointers ``[T, K, N]`` int64
    (``[t, j, n]`` = the argmax predecessor of state j at step t)."""
    shifts = 4 * torch.arange(K, dtype=torch.int32, device=back_t.device)
    return ((back_t[:, None, :] >> shifts[None, :, None]) & 15).long()


def filter_plain(pi_t, A_t, obs_t, mask_t):
    """Plain version of the ``FILTER`` kernel on the lane layout: ``(ll
    [N], alpha [T, K, N])``, guarded logsumexps."""
    T = obs_t.shape[0]
    alpha = torch.where(mask_t[0] > 0, pi_t + obs_t[0], pi_t)
    out = torch.empty_like(obs_t)
    out[0] = alpha
    for t in range(1, T):
        new = _safe_lse(alpha[:, None, :] + A_t, 0) + obs_t[t]
        alpha = torch.where(mask_t[t] > 0, new, alpha)
        out[t] = alpha
    return _safe_lse(alpha, 0), out


def beta_plain(A_t, obs_t, mask_t):
    """Plain version of the ``BETA`` kernel on the lane layout: ``beta
    [T, K, N]`` with ``beta[T-1] = 0``; a step whose successor is masked
    copies the carry."""
    T = obs_t.shape[0]
    out = torch.empty_like(obs_t)
    beta = torch.zeros_like(obs_t[0])
    out[T - 1] = beta
    for t in range(T - 2, -1, -1):
        e = obs_t[t + 1] + beta  # [K(j), N]
        new = _safe_lse(A_t + e[None], 1)
        beta = torch.where(mask_t[t + 1] > 0, new, beta)
        out[t] = beta
    return out


def viterbi_plain(pi_t, A_t, obs_t, mask_t):
    """Plain version of the ``VITERBI`` kernel on the lane layout:
    ``(score [N], dlast [K, N], back [T, N] int32)``, one packed
    first-argmax map per step (the identity map at t = 0 and on masked
    steps); no mask case at t = 0."""
    T, K, N = obs_t.shape
    ident = _identity_map(K)
    shifts = 4 * torch.arange(K, dtype=torch.int32, device=obs_t.device)[:, None]
    back = torch.empty((T, N), dtype=torch.int32, device=obs_t.device)
    back[0] = ident
    delta = pi_t + obs_t[0]
    for t in range(1, T):
        best, arg = _argmax0(delta[:, None, :] + A_t)  # over i, [K(j), N]
        w = (arg << shifts).sum(0, dtype=torch.int32)
        valid = mask_t[t] > 0
        delta = torch.where(valid, best + obs_t[t], delta)
        back[t] = torch.where(valid, w, torch.full_like(w, ident))
    return _argmax0(delta)[0], delta, back


def backtrack_plain(back_t, dlast):
    """Plain version of the ``BACKTRACK`` kernel: ``path [T, N]`` int32,
    ``z_{T-1}`` the first argmax of ``dlast [K, N]`` and ``z_{t-1} =
    back_t[z_t]``."""
    T, N = back_t.shape
    path = torch.empty((T, N), dtype=torch.int32, device=back_t.device)
    z = _argmax0(dlast)[1]
    path[T - 1] = z
    for t in range(T - 1, 0, -1):
        z = (back_t[t] >> (4 * z)) & 15
        path[t - 1] = z
    return path


# ---------------------------------------------------------------------------
# kernel wrappers on the lane layout
# ---------------------------------------------------------------------------


def fwd_lanes(pi_t, A_t, obs_t, mask_t, gate_t=None, sk_t=None):
    """Forward filter on the lane layout: ``(ll [N], alpha [T, K, N])``.
    CPU tensors run :func:`fwd_plain`; CUDA tensors launch ``FWD``."""
    dev = _check_same_device(pi_t, A_t, obs_t, mask_t, gate_t, sk_t)
    T, K, N = obs_t.shape
    _check_lane_shapes(T, K, N, pi=pi_t, A=A_t, obs=obs_t, mask=mask_t, gate=gate_t, sk=sk_t)
    if dev.type == "cpu":
        return fwd_plain(pi_t, A_t, obs_t, mask_t, gate_t, sk_t)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_cuda_operands(K, pi_t, A_t, obs_t, mask_t, gate_t, sk_t)
    FWD.load()
    ll = torch.empty((N,), dtype=torch.float32, device=dev)
    alpha = torch.empty((T, K, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        FWD.launch(
            K, int(gate_t is not None),
            _ptr(pi_t), _ptr(A_t), _ptr(obs_t), _ptr(mask_t), _ptr(gate_t), _ptr(sk_t),
            _ptr(ll), _ptr(alpha), T, N,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return ll, alpha


def bwd_sample_lanes(A_t, mask_t, alpha_t, u_t, gate_t=None, sk_t=None):
    """Backward sampling on the lane layout: ``z [T, N]`` int32. CPU
    tensors run :func:`bwd_sample_plain`; CUDA tensors launch
    ``BWD_SAMPLE``."""
    dev = _check_same_device(A_t, mask_t, alpha_t, u_t, gate_t, sk_t)
    T, K, N = alpha_t.shape
    _check_lane_shapes(T, K, N, A=A_t, mask=mask_t, alpha=alpha_t, u=u_t, gate=gate_t, sk=sk_t)
    if dev.type == "cpu":
        return bwd_sample_plain(A_t, mask_t, alpha_t, u_t, gate_t, sk_t)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_cuda_operands(K, A_t, mask_t, alpha_t, u_t, gate_t, sk_t)
    BWD_SAMPLE.load()
    z = torch.empty((T, N), dtype=torch.int32, device=dev)
    scratch = None
    if T > _BWD_SMEM_MAX_T:
        scratch = torch.empty((N, -(-T // 32) * 32), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        BWD_SAMPLE.launch(
            K, int(gate_t is not None),
            _ptr(A_t), _ptr(mask_t), _ptr(alpha_t), _ptr(u_t), _ptr(gate_t), _ptr(sk_t),
            _ptr(z), _ptr(scratch), T, N,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return z


def vg_bwd_lanes(A_t, obs_t, mask_t, alpha_t, ll, gate_t=None, sk_t=None):
    """Value-and-grad pass 2 on the lane layout: ``(d_pi [K, N], d_A [K,
    K, N], d_obs [T, K, N])``. CPU tensors run :func:`vg_bwd_plain`;
    CUDA tensors launch ``VG_BWD``."""
    dev = _check_same_device(A_t, obs_t, mask_t, alpha_t, ll, gate_t, sk_t)
    T, K, N = obs_t.shape
    _check_lane_shapes(
        T, K, N, A=A_t, obs=obs_t, mask=mask_t, alpha=alpha_t, ll=ll, gate=gate_t, sk=sk_t
    )
    if dev.type == "cpu":
        return vg_bwd_plain(A_t, obs_t, mask_t, alpha_t, ll, gate_t, sk_t)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_cuda_operands(K, A_t, obs_t, mask_t, alpha_t, ll, gate_t, sk_t)
    VG_BWD.load()
    f32 = dict(dtype=torch.float32, device=dev)
    d_pi = torch.empty((K, N), **f32)
    d_A = torch.empty((K, K, N), **f32)
    d_obs = torch.empty((T, K, N), **f32)
    with torch.cuda.device(dev):
        VG_BWD.launch(
            K, int(gate_t is not None),
            _ptr(A_t), _ptr(obs_t), _ptr(mask_t), _ptr(alpha_t), _ptr(ll),
            _ptr(gate_t), _ptr(sk_t), _ptr(d_pi), _ptr(d_A), _ptr(d_obs), T, N,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return d_pi, d_A, d_obs


def filter_lanes(pi_t, A_t, obs_t, mask_t):
    """Guarded forward filter on the lane layout: ``(ll [N], alpha [T,
    K, N])``. CPU tensors run :func:`filter_plain`; CUDA tensors launch
    ``FILTER``."""
    dev = _check_same_device(pi_t, A_t, obs_t, mask_t)
    T, K, N = obs_t.shape
    _check_lane_shapes(T, K, N, pi=pi_t, A=A_t, obs=obs_t, mask=mask_t)
    if dev.type == "cpu":
        return filter_plain(pi_t, A_t, obs_t, mask_t)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_cuda_operands(K, pi_t, A_t, obs_t, mask_t)
    FILTER.load()
    ll = torch.empty((N,), dtype=torch.float32, device=dev)
    alpha = torch.empty((T, K, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        FILTER.launch(
            K, _ptr(pi_t), _ptr(A_t), _ptr(obs_t), _ptr(mask_t), _ptr(ll), _ptr(alpha),
            T, N, torch.cuda.current_stream(dev).cuda_stream,
        )
    return ll, alpha


def beta_lanes(A_t, obs_t, mask_t):
    """Guarded backward recursion on the lane layout: ``beta [T, K,
    N]``. CPU tensors run :func:`beta_plain`; CUDA tensors launch
    ``BETA``."""
    dev = _check_same_device(A_t, obs_t, mask_t)
    T, K, N = obs_t.shape
    _check_lane_shapes(T, K, N, A=A_t, obs=obs_t, mask=mask_t)
    if dev.type == "cpu":
        return beta_plain(A_t, obs_t, mask_t)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_cuda_operands(K, A_t, obs_t, mask_t)
    BETA.load()
    beta = torch.empty((T, K, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        BETA.launch(
            K, _ptr(A_t), _ptr(obs_t), _ptr(mask_t), _ptr(beta), T, N,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return beta


def viterbi_lanes(pi_t, A_t, obs_t, mask_t):
    """Max-plus pass on the lane layout: ``(score [N], dlast [K, N],
    back [T, N] int32)``. CPU tensors run :func:`viterbi_plain`; CUDA
    tensors launch ``VITERBI``."""
    dev = _check_same_device(pi_t, A_t, obs_t, mask_t)
    T, K, N = obs_t.shape
    _check_lane_shapes(T, K, N, pi=pi_t, A=A_t, obs=obs_t, mask=mask_t)
    if dev.type == "cpu":
        return viterbi_plain(pi_t, A_t, obs_t, mask_t)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_cuda_operands(K, pi_t, A_t, obs_t, mask_t)
    VITERBI.load()
    score = torch.empty((N,), dtype=torch.float32, device=dev)
    dlast = torch.empty((K, N), dtype=torch.float32, device=dev)
    back = torch.empty((T, N), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        VITERBI.launch(
            K, _ptr(pi_t), _ptr(A_t), _ptr(obs_t), _ptr(mask_t), _ptr(score), _ptr(dlast),
            _ptr(back), T, N, torch.cuda.current_stream(dev).cuda_stream,
        )
    return score, dlast, back


def backtrack_lanes(back_t, dlast):
    """Viterbi backtrack on the lane layout: ``path [T, N]`` int32 from
    the packed maps ``back_t [T, N]`` int32 and ``dlast [K, N]``. CPU
    tensors run :func:`backtrack_plain`; CUDA tensors launch
    ``BACKTRACK``."""
    dev = _check_same_device(back_t, dlast)
    if back_t.ndim != 2 or dlast.ndim != 2:
        raise ValueError("back must be [T, N] and dlast [K, N]")
    (T, N), K = back_t.shape, dlast.shape[0]
    _check_lane_shapes(T, K, N, back=back_t, dlast=dlast)
    if back_t.dtype != torch.int32:
        raise TypeError(f"back must be the packed int32 maps, got {back_t.dtype}")
    if dev.type == "cpu":
        return backtrack_plain(back_t, dlast)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_cuda_operands(K, dlast)
    if not back_t.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous lane-layout operands")
    BACKTRACK.load()
    path = torch.empty((T, N), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        BACKTRACK.launch(
            K, _ptr(back_t), _ptr(dlast), _ptr(path), T, N,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return path


# ---------------------------------------------------------------------------
# public entries (JAX layout)
# ---------------------------------------------------------------------------


def forward_chunked(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_obs: torch.Tensor,
    mask: torch.Tensor,
    gate_key: Optional[torch.Tensor] = None,
    state_key: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``_run_chunked_forward``: the clamped forward
    filter over a flat batch, ``(log_alpha [N, T, K], loglik [N])``.
    ``log_A`` is used as given (not clamped), as in the JAX package."""
    lanes = to_lanes(log_pi, log_A, log_obs, mask, gate_key, state_key)
    ll, alpha_t = fwd_lanes(*lanes)
    return alpha_t.permute(2, 0, 1), ll


def semiring_ffbs(
    log_pi: torch.Tensor,  # [N, K]
    log_A: torch.Tensor,  # [N, K, K]
    log_obs: torch.Tensor,  # [N, T, K]
    mask: torch.Tensor,  # [N, T]
    u: torch.Tensor,  # [N, T] uniforms in [0, 1)
    gate_key: Optional[torch.Tensor] = None,  # [N, T]
    state_key: Optional[torch.Tensor] = None,  # [N, K] or [K]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused FFBS over a flat batch: ``(z [N, T] int64, loglik [N])`` —
    one ``FWD`` and one ``BWD_SAMPLE`` launch on CUDA. ``log_A`` is
    clamped at ``_CLAMP`` on entry, and the padded tail repeats the last
    valid state, as in ``pallas_semiring.semiring_ffbs``."""
    N, T, _ = log_obs.shape
    if tuple(u.shape) != (N, T):
        raise ValueError(f"u must be [N, T] = {(N, T)}, got {tuple(u.shape)}")
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = to_lanes(
        log_pi, log_A.clamp_min(_CLAMP), log_obs, mask, gate_key, state_key
    )
    u_t = u.to(obs_t.dtype).t().contiguous()
    ll, alpha_t = fwd_lanes(pi_t, A_t, obs_t, mask_t, gate_t, sk_t)
    z = bwd_sample_lanes(A_t, mask_t, alpha_t, u_t, gate_t, sk_t).t().long()
    # padded tail: repeat the last valid state (the index wraps like
    # numpy's for an all-masked lane, as in the JAX package)
    t_last = mask.sum(-1).long() - 1
    last = z.gather(1, torch.remainder(t_last, T)[:, None])
    steps = torch.arange(T, device=z.device)
    z = torch.where(steps[None, :] <= t_last[:, None], z, last)
    return z, ll


def semiring_vg(
    log_pi: torch.Tensor,  # [N, K]
    log_A: torch.Tensor,  # [N, K, K]
    log_obs: torch.Tensor,  # [N, T, K]
    mask: torch.Tensor,  # [N, T]
    gate_key: Optional[torch.Tensor] = None,  # [N, T]
    state_key: Optional[torch.Tensor] = None,  # [N, K] or [K]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused value-and-grad over a flat batch: ``(loglik [N], d_pi [N,
    K], d_A [N, K, K], d_obs [N, T, K])``, the Baum-Welch identities of
    ``pallas_semiring.semiring_vg`` — one ``FWD`` and one ``VG_BWD``
    launch on CUDA. ``log_A`` is used as given (not clamped, unlike
    :func:`semiring_ffbs`); inputs must be finite, since the gate
    multiplies ``log_A`` and ``0 * -inf`` would be NaN."""
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = to_lanes(
        log_pi, log_A, log_obs, mask, gate_key, state_key
    )
    ll, alpha_t = fwd_lanes(pi_t, A_t, obs_t, mask_t, gate_t, sk_t)
    d_pi, d_A, d_obs = vg_bwd_lanes(A_t, obs_t, mask_t, alpha_t, ll, gate_t, sk_t)
    return ll, d_pi.t(), d_A.permute(2, 0, 1), d_obs.permute(2, 0, 1)


def semiring_filter(
    log_pi: torch.Tensor,  # [N, K]
    log_A: torch.Tensor,  # [N, K, K]
    log_obs: torch.Tensor,  # [N, T, K]
    mask: torch.Tensor,  # [N, T]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Guarded forward filter over a flat batch: ``(log_alpha [N, T, K],
    loglik [N])``, the ``kernels/filtering.py::forward_filter`` contract
    (−inf-tolerant) of ``pallas_semiring.semiring_filter`` — one
    ``FILTER`` launch on CUDA."""
    pi_t, A_t, obs_t, mask_t, _, _ = to_lanes(log_pi, log_A, log_obs, mask)
    ll, alpha_t = filter_lanes(pi_t, A_t, obs_t, mask_t)
    return alpha_t.permute(2, 0, 1), ll


def semiring_beta(
    log_A: torch.Tensor,  # [N, K, K]
    log_obs: torch.Tensor,  # [N, T, K]
    mask: torch.Tensor,  # [N, T]
) -> torch.Tensor:
    """Guarded backward recursion over a flat batch: ``log_beta [N, T,
    K]``, the ``kernels/filtering.py::backward_pass`` contract of
    ``pallas_semiring.semiring_beta`` — one ``BETA`` launch on CUDA."""
    _, A_t, obs_t, mask_t, _, _ = to_lanes(None, log_A, log_obs, mask)
    return beta_lanes(A_t, obs_t, mask_t).permute(2, 0, 1)


def semiring_viterbi(
    log_pi: torch.Tensor,  # [N, K]
    log_A: torch.Tensor,  # [N, K, K]
    log_obs: torch.Tensor,  # [N, T, K]
    mask: torch.Tensor,  # [N, T]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Viterbi over a flat batch: ``(path [N, T] int64, log_prob [N])``,
    the ``kernels/viterbi.py::viterbi`` contract and tie-breaking of
    ``pallas_semiring.semiring_viterbi`` — one ``VITERBI`` and one
    ``BACKTRACK`` launch on CUDA. A padded tail repeats the last valid
    state (identity maps)."""
    pi_t, A_t, obs_t, mask_t, _, _ = to_lanes(log_pi, log_A, log_obs, mask)
    score, dlast, back = viterbi_lanes(pi_t, A_t, obs_t, mask_t)
    del pi_t, A_t, obs_t, mask_t
    return backtrack_lanes(back, dlast).t().long(), score
