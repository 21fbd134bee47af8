"""The semiring kernels for Hopper (counterpart of
``hhmm_tpu/kernels/pallas_semiring.py``'s FFBS and value-and-grad
kernels) and their plain PyTorch versions.

Three CUDA kernels (sources in ``kernels/csrc``):

- ``FWD`` (``ffbs_fwd.cu``) replaces ``_fwd_kernel``: the clamped forward
  filter, optionally sign-gated, that writes every step's alpha to a
  residual and returns ``ll = lse0(alpha_last)``;
- ``BWD_SAMPLE`` (``ffbs_bwd_sample.cu``) replaces ``_bwd_sample_kernel``:
  inverse-CDF backward sampling against pre-drawn uniforms;
- ``VG_BWD`` (``vg_bwd.cu``) replaces ``_bwd_kernel``: the clamped
  backward recursion with the Baum-Welch gradients ``(d_pi, d_A,
  d_obs)`` of the forward log-likelihood.

All work on the batch-minor lane layout (``[T, K, N]`` residual, lane
fastest); :func:`to_lanes` makes it from the JAX package's ``[N, T, K]``
layout, which the public entries :func:`semiring_ffbs`,
:func:`semiring_vg` and :func:`forward_chunked` keep.

Routing is by the tensors' device and nothing else: a CPU tensor runs
the plain version (:func:`fwd_plain`, :func:`bwd_sample_plain`,
:func:`vg_bwd_plain` — Python loops over t with the kernels' exact
arithmetic), a CUDA tensor launches the kernel or raises. There is no
fallback from a kernel to its plain version. ``kernel.launches`` counts
each kernel's launches.
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
    "KERNELS",
    "build_kernels",
    "reset_launches",
    "to_lanes",
    "fwd_lanes",
    "bwd_sample_lanes",
    "vg_bwd_lanes",
    "fwd_plain",
    "bwd_sample_plain",
    "vg_bwd_plain",
    "forward_chunked",
    "semiring_ffbs",
    "semiring_vg",
]

_CLAMP = -1.0e30
CUDA_KS = (2, 4, 8)

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
    # K, gated, A, mask, alpha, u, gate, sk, z, T, N, stream
    [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
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
KERNELS = (FWD, BWD_SAMPLE, VG_BWD)


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
    log_pi: torch.Tensor,  # [N, K]
    log_A: torch.Tensor,  # [N, K, K] (homogeneous)
    log_obs: torch.Tensor,  # [N, T, K]
    mask: torch.Tensor,  # [N, T]
    gate_key: Optional[torch.Tensor] = None,  # [N, T]
    state_key: Optional[torch.Tensor] = None,  # [N, K] or [K]
):
    """JAX layout → the kernels' batch-minor lane layout, contiguous:
    ``pi [K, N]``, ``A [K, K, N]``, ``obs [T, K, N]``, ``mask [T, N]``,
    ``gate [T, N]``, ``sk [K, N]`` (the last two None when ungated).
    Mask and gate keys become the kernels' f32."""
    if (gate_key is None) != (state_key is None):
        raise ValueError("gate_key and state_key must be given together")
    if log_obs.ndim != 3:
        raise ValueError(f"log_obs must be [N, T, K], got {tuple(log_obs.shape)}")
    N, T, K = log_obs.shape
    if tuple(log_pi.shape) != (N, K):
        raise ValueError(f"log_pi must be [N, K] = {(N, K)}, got {tuple(log_pi.shape)}")
    if tuple(log_A.shape) != (N, K, K):
        raise ValueError(
            f"log_A must be homogeneous [N, K, K] = {(N, K, K)}, got {tuple(log_A.shape)}"
        )
    if tuple(mask.shape) != (N, T):
        raise ValueError(f"mask must be [N, T] = {(N, T)}, got {tuple(mask.shape)}")
    _check_same_device(log_pi, log_A, log_obs, mask, gate_key, state_key)
    dt = log_obs.dtype
    pi_t = log_pi.t().contiguous()
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
        "ll": (N,),
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
    with torch.cuda.device(dev):
        BWD_SAMPLE.launch(
            K, int(gate_t is not None),
            _ptr(A_t), _ptr(mask_t), _ptr(alpha_t), _ptr(u_t), _ptr(gate_t), _ptr(sk_t),
            _ptr(z), T, N,
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
