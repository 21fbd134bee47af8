"""The fused Tayal trajectory kernel for Hopper (counterpart of
``hhmm_tpu/kernels/pallas_traj.py``) and its plain PyTorch version.

``TRAJ`` (``csrc/tayal_traj.cu``) replaces ``_traj_kernel``: one launch
runs a whole HMC/ChEES trajectory — ``min(n_steps, cap)`` leapfrogs of
the stan-gate ``TayalHHMM`` (K=4, L=9, 35 unconstrained coordinates) —
for every lane (series x chain), with the sigmoid and stick-breaking
unpack and its log-Jacobian, the scaled linear-space forward filter and
backward pass with Baum-Welch accumulators, the hand-derived VJPs back
to the 35 coordinates and the leapfrog updates all inside the kernel.
The step size and the step count are read from device memory.

The kernel gives each lane a warp. q, p, grad and the inverse mass stay
in the warp's registers (a coordinate a thread) for the whole launch;
the lane's series is staged once into shared memory, a byte a step.
Only the alpha and beta recursions run serially, on one thread, each
storing its carry a step; the warp computes the normalisers and reduces
ll, the per-symbol gamma sums and the d_A terms from them in a fixed
order. Those per-step buffers take 37 bytes a step (T rounded up to
``T_PAD``) in shared memory: four lanes a block up to T=1536, fewer up
to T=6240. Past that the wrapper allocates a device scratch of 37 bytes
a step a lane (:func:`traj_scratch_bytes`) and the kernel keeps them
there.

The plain version :func:`traj_plain` does the same linear-space algebra
with Python loops over the leapfrogs and over t. Routing is by device
only: a CPU tensor runs :func:`traj_plain`, a CUDA tensor launches
``TRAJ`` or raises. The kernel sums in other orders than the plain
version, so the two agree within tolerances, not bitwise.

Layout (lane layout of the kernel): positions, momenta and gradients
``[35, N]`` with lane ``n = b * C + c``; the inverse mass ``[35, B]``
and the data ``x``, ``sign`` ``[T, B]`` int32 and ``mask`` ``[T, B]``
f32 per series (the kernel reads series ``n // C``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from hhmm_tpu_torch._device import DeviceLike, resolve_device
from hhmm_tpu_torch.kernels.cuda_build import CudaKernel

__all__ = [
    "TRAJ",
    "KERNELS",
    "DIM",
    "traj_plain",
    "traj_lanes",
    "traj_scratch_bytes",
    "tayal_trajectory",
    "make_tayal_trajectory",
]

K, L = 4, 9
DIM = 35  # 1 (p_11) + 2 (A_row frees) + 32 (phi frees)
# state sign groups: states {1, 2} emit up legs (0), {0, 3} down legs (1)
_STATE_SIGN = (1, 0, 0, 1)

_P = ctypes.c_void_p
_I = ctypes.c_int
TRAJ = CudaKernel(
    "tayal_traj",
    "tayal_traj.cu",
    "hhmm_tayal_traj",
    # q, p, g, inv_mass, x, sign, mask, eps, n_steps, q1, p1, g1, lp1,
    # scratch (or NULL), cap, C, T, N, B, stream
    [_P] * 14 + [_I] * 5 + [_P],
    "hhmm_tpu/kernels/pallas_traj.py:122",
)
KERNELS = (TRAJ,)

# the kernel's per-step buffers (csrc/tayal_traj.cu): the forward and the
# backward slot 16 bytes a step each, 1 / c_t 4, the series 1, T rounded up
# to T_PAD; a lane's small tables take SMALL_BYTES; a block may hold
# SMEM_MAX bytes of shared memory
STEP_BYTES, T_PAD, SMALL_BYTES, SMEM_MAX = 37, 32, 1024, 232448


# ---------------------------------------------------------------------------
# plain version (the kernel's arithmetic, as loops over leapfrogs and t)
# ---------------------------------------------------------------------------


def _logsig(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_max(x, 0.0) - torch.log1p(torch.exp(-x.abs()))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def _unpack(q: torch.Tensor):
    """``q [35, N]`` → ``(p11 [N], zA [2, N], phi [K, L, N], ldj [N])``."""
    q0 = q[0]
    p11 = _sigmoid(q0)
    ldj = _logsig(q0) + _logsig(-q0)
    zA = _sigmoid(q[1:3])
    ta = _logsig(q[1:3]) + _logsig(-q[1:3])
    ldj = ldj + (ta[0] + ta[1])
    off = torch.log(8.0 - torch.arange(L - 1, dtype=q.dtype, device=q.device))
    phi = torch.empty((K, L) + q.shape[1:], dtype=q.dtype, device=q.device)
    for k in range(K):
        acc = torch.zeros_like(q0)
        ldk = torch.zeros_like(q0)
        for d in range(L - 1):
            logit = q[3 + 8 * k + d] - off[d]
            lz, l1 = _logsig(logit), _logsig(-logit)
            phi[k, d] = torch.exp(lz + acc)
            ldk = ldk + ((lz + l1) + acc)
            acc = acc + l1
        phi[k, L - 1] = torch.exp(acc)
        ldj = ldj + ldk
    return p11, zA, phi, ldj


def _ordered_sum(terms):
    s = terms[0]
    for t in terms[1:]:
        s = s + t
    return s


def _logp_grad(q, x, gate, mask, onehot, ed, eu):
    """Log density and gradient at ``q [35, N]`` for lanes with per-lane
    data ``x [T, N]``, ``gate [T, K(j), N]`` (sign-consistent
    destinations), ``mask [T, N]`` and ``onehot [T, L, N]``."""
    T, N = x.shape
    p11, zA, phi, ldj = _unpack(q)
    one, zero = torch.ones_like(p11), torch.zeros_like(p11)
    A = [
        [zero, zA[0], 1.0 - zA[0], zero],
        [one, zero, zero, zero],
        [zA[1], zero, zero, 1.0 - zA[1]],
        [zero, zero, one, zero],
    ]
    pe = [ed * p11 + (1.0 - ed), one, eu * (1.0 - p11) + (1.0 - eu), one]
    lane = torch.arange(N, device=q.device)
    obs = phi[:, x, lane]  # [K, T, N]: phi[k, x_t, n]

    def Ae(t, i, j):
        return torch.where(gate[t, j], A[i][j], one)

    # scaled forward filter
    alpha = torch.empty((T, K, N), dtype=q.dtype, device=q.device)
    c_all = torch.empty((T, N), dtype=q.dtype, device=q.device)
    v0 = mask[0] > 0
    al = [torch.where(v0, pe[k] * obs[k, 0], pe[k]) for k in range(K)]
    c0 = _ordered_sum(al)
    al = [a / c0 for a in al]
    alpha[0] = torch.stack(al)
    c_all[0] = c0
    ll = torch.log(c0)
    for t in range(1, T):
        w = [_ordered_sum([al[i] * Ae(t, i, j) for i in range(K)]) * obs[j, t] for j in range(K)]
        c = _ordered_sum(w)
        valid = mask[t] > 0
        al = [torch.where(valid, w[k] / c, al[k]) for k in range(K)]
        c = torch.where(valid, c, one)
        alpha[t] = torch.stack(al)
        c_all[t] = c
        ll = ll + torch.log(c)

    # backward pass with the Baum-Welch accumulators
    be = [one] * K
    dA01 = dA02 = dA20 = dA23 = zero
    dem = torch.zeros((K, L, N), dtype=q.dtype, device=q.device)
    for t in range(T - 1, 0, -1):
        m01 = (mask[t] > 0).to(q.dtype)
        gam = torch.stack([(al[k] * be[k]) * m01 for k in range(K)])
        dem = dem + gam[:, None, :] * onehot[t][None]
        ap = list(alpha[t - 1])
        gt = gate[t].to(q.dtype)
        e = [(obs[j, t] * be[j]) / c_all[t] for j in range(K)]
        dA01 = dA01 + ap[0] * A[0][1] * e[1] * gt[1] * m01
        dA02 = dA02 + ap[0] * A[0][2] * e[2] * gt[2] * m01
        dA20 = dA20 + ap[2] * A[2][0] * e[0] * gt[0] * m01
        dA23 = dA23 + ap[2] * A[2][3] * e[3] * gt[3] * m01
        nb = [_ordered_sum([Ae(t, i, j) * e[j] for j in range(K)]) for i in range(K)]
        valid = mask[t] > 0
        be = [torch.where(valid, nb[k], be[k]) for k in range(K)]
        al = ap
    dpi = [al[k] * be[k] for k in range(K)]
    m0 = (mask[0] > 0).to(q.dtype)
    dem = dem + torch.stack(dpi)[:, None, :] * m0 * onehot[0][None]

    # chain rule to the 35 coordinates
    grad = torch.empty_like(q)
    grad[0] = dpi[0] * ed * (1.0 - p11) - dpi[2] * eu * p11 + (1.0 - 2.0 * p11)
    grad[1] = dA01 * (1.0 - zA[0]) - zA[0] * dA02 + (1.0 - 2.0 * zA[0])
    grad[2] = dA20 * (1.0 - zA[1]) - zA[1] * dA23 + (1.0 - 2.0 * zA[1])
    off = torch.log(8.0 - torch.arange(L - 1, dtype=q.dtype, device=q.device))
    for k in range(K):
        acc_s = dem[k, L - 1]
        for j in range(L - 2, -1, -1):
            gj = dem[k, j]
            row = 3 + 8 * k + j
            z = torch.exp(_logsig(q[row] - off[j]))
            dldj = (1.0 - 2.0 * z) - z * float(L - 2 - j)
            grad[row] = gj * (1.0 - z) - z * acc_s + dldj
            acc_s = acc_s + gj
    return ll + ldj, grad


def traj_plain(q_t, p_t, g_t, im_t, x_t, sign_t, mask_t, eps, n_steps, cap: int, C: int):
    """Plain version of the ``TRAJ`` kernel on the lane layout:
    ``(q1 [35, N], p1 [35, N], logp1 [N], g1 [35, N])`` after
    ``min(n_steps, cap)`` leapfrogs (``logp1`` is 0 after none)."""
    D, N = q_t.shape
    lane_b = torch.arange(N, device=q_t.device) // C
    x = x_t[:, lane_b].long()  # [T, N]
    sign = sign_t[:, lane_b]
    mask = mask_t[:, lane_b]
    ss = torch.tensor(_STATE_SIGN, dtype=sign.dtype, device=sign.device)
    gate = sign[:, None, :] == ss[None, :, None]  # [T, K(j), N]
    onehot = (x[:, None, :] == torch.arange(L, device=x.device)[None, :, None]).to(q_t.dtype)
    ed = (sign[0] == 1).to(q_t.dtype)
    eu = 1.0 - ed
    im = im_t[:, lane_b]
    eps = eps.reshape(()).to(q_t.dtype)
    hs = 0.5 * eps
    q, p, g = q_t.clone(), p_t.clone(), g_t.clone()
    logp = torch.zeros((N,), dtype=q_t.dtype, device=q_t.device)
    for _ in range(min(int(n_steps.reshape(())), cap)):
        p = p + hs * g
        q = q + (eps * im) * p
        logp, g = _logp_grad(q, x, gate, mask, onehot, ed, eu)
        p = p + hs * g
    return q, p, logp, g


# ---------------------------------------------------------------------------
# kernel wrapper on the lane layout
# ---------------------------------------------------------------------------


def _ptr(t: torch.Tensor):
    return t.data_ptr()


def traj_scratch_bytes(T: int, N: int) -> int:
    """Bytes of device scratch ``TRAJ`` needs for ``N`` lanes of ``T``
    steps: 0 while one lane's buffers fit in a block's shared memory,
    else ``STEP_BYTES`` a padded step a lane."""
    tp = -(-T // T_PAD) * T_PAD
    if SMALL_BYTES + STEP_BYTES * tp <= SMEM_MAX:
        return 0
    return N * STEP_BYTES * tp


def traj_lanes(q_t, p_t, g_t, im_t, x_t, sign_t, mask_t, eps, n_steps, cap: int, C: int):
    """One trajectory on the lane layout (see the module docstring):
    ``(q1, p1, logp1, g1)``. ``eps`` is a float32 and ``n_steps`` an
    int32 one-element tensor on the lanes' device. CPU tensors run
    :func:`traj_plain`; CUDA tensors launch ``TRAJ``."""
    devs = {t.device for t in (q_t, p_t, g_t, im_t, x_t, sign_t, mask_t, eps, n_steps)}
    if len(devs) != 1:
        raise ValueError(f"operands must share one device, got {sorted(map(str, devs))}")
    dev = devs.pop()
    D, N = q_t.shape
    T, B = x_t.shape
    if D != DIM:
        raise ValueError(f"the Tayal trajectory has {DIM} coordinates, got {D}")
    if C < 1 or B * C != N:
        raise ValueError(f"{N} lanes are not {B} series x {C} chains")
    want = {"p": (p_t, (DIM, N)), "grad": (g_t, (DIM, N)), "inv_mass": (im_t, (DIM, B)),
            "sign": (sign_t, (T, B)), "mask": (mask_t, (T, B)), "eps": (eps, (1,)),
            "n_steps": (n_steps, (1,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} in the lane layout, got {tuple(t.shape)}")
    if dev.type == "cpu":
        return traj_plain(q_t, p_t, g_t, im_t, x_t, sign_t, mask_t, eps, n_steps, cap, C)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for t in (q_t, p_t, g_t, im_t, mask_t, eps):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("the trajectory kernel takes contiguous float32 q, p, grad, "
                            "inv_mass, mask and eps")
    for t in (x_t, sign_t, n_steps):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError("the trajectory kernel takes contiguous int32 x, sign and n_steps")
    TRAJ.load()
    f32 = dict(dtype=torch.float32, device=dev)
    q1, p1, g1 = (torch.empty((DIM, N), **f32) for _ in range(3))
    lp1 = torch.empty((N,), **f32)
    nbytes = traj_scratch_bytes(T, N)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev) if nbytes else None
    with torch.cuda.device(dev):
        TRAJ.launch(
            _ptr(q_t), _ptr(p_t), _ptr(g_t), _ptr(im_t), _ptr(x_t), _ptr(sign_t),
            _ptr(mask_t), _ptr(eps), _ptr(n_steps), _ptr(q1), _ptr(p1), _ptr(g1),
            _ptr(lp1), None if scratch is None else _ptr(scratch), int(cap), C, T, N, B,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return q1, p1, lp1, g1


# ---------------------------------------------------------------------------
# public entries
# ---------------------------------------------------------------------------


def _data_lanes(x, sign, mask, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Series data ``[B, T]`` → the kernel's ``x``, ``sign`` ``[T, B]``
    int32 and ``mask`` ``[T, B]`` f32, checked once: symbols in
    ``0..8``, signs in ``{0, 1}`` (the kernel indexes its emission slab
    by symbol)."""
    x = torch.as_tensor(x, device=device)
    sign = torch.as_tensor(sign, device=device)
    if x.ndim != 2 or tuple(sign.shape) != tuple(x.shape):
        raise ValueError(f"x and sign must both be [B, T], got {tuple(x.shape)}, {tuple(sign.shape)}")
    if bool(((x < 0) | (x >= L)).any()) or bool(((sign != 0) & (sign != 1)).any()):
        raise ValueError(f"x must hold symbols 0..{L - 1} and sign 0 (up) / 1 (down)")
    x_t = x.t().to(torch.int32).contiguous()
    sign_t = sign.t().to(torch.int32).contiguous()
    if mask is None:
        mask_t = torch.ones(x_t.shape, dtype=torch.float32, device=device)
    else:
        mask = torch.as_tensor(mask, device=device)
        if tuple(mask.shape) != tuple(x.shape):
            raise ValueError(f"mask must be [B, T] = {tuple(x.shape)}, got {tuple(mask.shape)}")
        mask_t = mask.t().to(torch.float32).contiguous()
    return x_t, sign_t, mask_t


def _scalars(eps, n_steps, device):
    eps = torch.as_tensor(eps, dtype=torch.float32, device=device).reshape(1)
    n_steps = torch.as_tensor(n_steps, device=device).to(torch.int32).reshape(1)
    return eps, n_steps


def tayal_trajectory(
    q: torch.Tensor,  # [N, 35]
    p: torch.Tensor,  # [N, 35]
    grad: torch.Tensor,  # [N, 35]
    inv_mass: torch.Tensor,  # [B, 35]
    eps,  # scalar
    n_steps,  # scalar int (1..cap)
    x: torch.Tensor,  # [B, T] symbols 0..8
    sign: torch.Tensor,  # [B, T] 0 = up, 1 = down
    mask: Optional[torch.Tensor],  # [B, T] or None
    cap: int,
    chains: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused trajectory for ``N = B * chains`` lanes (lane ``b *
    chains + c`` runs series ``b``): ``(q1, p1, logp1 [N], grad1)``,
    the state after ``min(n_steps, cap)`` leapfrogs of the stan-gate
    Tayal density (loglik + log|Jacobian|), as the unfused leapfrog loop
    over ``TayalHHMM().make_vg`` computes it. With ``chains=1`` this is
    the JAX entry's signature (``inv_mass`` and the data per lane)."""
    dev = q.device
    x_t, sign_t, mask_t = _data_lanes(x, sign, mask, dev)
    eps_t, n_t = _scalars(eps, n_steps, dev)
    q1, p1, lp1, g1 = traj_lanes(
        q.t().contiguous(), p.t().contiguous(), grad.t().contiguous(),
        inv_mass.t().contiguous(), x_t, sign_t, mask_t, eps_t, n_t, cap, chains,
    )
    return q1.t(), p1.t(), lp1, g1.t()


def make_tayal_trajectory(
    data: Dict[str, torch.Tensor], cap: int, device: DeviceLike = None
):
    """A ``trajectory_fn`` for :func:`~hhmm_tpu_torch.infer.chees.
    sample_chees_batched`: ``(inv_mass [B, 35], eps, n_steps, q [B, C,
    35], p, logp, grad) -> (q, p, logp [B, C], grad)``, one ``TRAJ``
    launch per call on the card. ``data`` holds per-series ``x`` and
    ``sign`` ``[B, T]`` (and optionally ``mask``) for the stan-gate
    ``TayalHHMM``; they are laid out once, here. The closure carries
    ``.cap``, so the sampler can check that the kernel's step bound
    covers its ``max_leapfrogs`` (the kernel clamps ``n_steps`` to
    ``cap``)."""
    device = resolve_device(device)
    x_t, sign_t, mask_t = _data_lanes(data["x"], data["sign"], data.get("mask"), device)

    def trajectory(inv_mass, eps, n_steps, q, p, logp, grad):
        B, C, D = q.shape
        eps_t, n_t = _scalars(eps, n_steps, q.device)

        def lanes(a):
            return a.reshape(B * C, D).t().contiguous()

        q1, p1, lp1, g1 = traj_lanes(
            lanes(q), lanes(p), lanes(grad), inv_mass.t().contiguous(),
            x_t, sign_t, mask_t, eps_t, n_t, cap, C,
        )
        return (
            q1.t().reshape(B, C, D),
            p1.t().reshape(B, C, D),
            lp1.reshape(B, C),
            g1.t().reshape(B, C, D),
        )

    trajectory.cap = cap
    return trajectory

