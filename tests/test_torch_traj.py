"""The port's fused Tayal trajectory (`hhmm_tpu_torch.kernels.cuda_traj`)
against the JAX package's `pallas_traj.tayal_trajectory` in interpret
mode, and against the port's own unfused leapfrogs over `make_lp_bc`, on
the same numpy inputs.

Tolerances are those of `tests/test_pallas_traj.py`: q rtol/atol 2e-4,
p and grad 2e-3, logp rtol 1e-4 / atol 5e-3 (the fused path runs the
filter in scaled linear space, the unfused one in log space; f32
rounding differs along the trajectory).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhmm_tpu.kernels.dispatch import tayal_trajectory as j_tayal_trajectory
from hhmm_tpu_torch.infer import make_lp_bc
from hhmm_tpu_torch.kernels import cuda_traj as ct
from hhmm_tpu_torch.kernels import make_tayal_trajectory, tayal_trajectory
from hhmm_tpu_torch.models import TayalHHMM
from hhmm_tpu_torch.sim import tayal_batch

torch.set_num_threads(1)

B, C, T, D = 3, 2, 64, 35
EPS = 0.02
TOL = {"q": (2e-4, 2e-4), "p": (2e-3, 2e-3), "logp": (1e-4, 5e-3), "grad": (2e-3, 2e-3)}


def _assert_state_close(got, want):
    for name, a, b in zip(("q", "p", "logp", "grad"), got, want):
        rtol, atol = TOL[name]
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=name
        )


@pytest.fixture(scope="module")
def case():
    """Data, start state and its gradient (numpy), shared by the cases."""
    rng = np.random.default_rng(5)
    x, sign = tayal_batch(B, T, seed=5, device="cpu")
    q = (0.5 * rng.normal(size=(B, C, D))).astype(np.float32)
    p = (0.7 * rng.normal(size=(B, C, D))).astype(np.float32)
    inv_mass = np.exp(0.3 * rng.normal(size=(B, D))).astype(np.float32)
    _, g0 = make_lp_bc(TayalHHMM(), {"x": x, "sign": sign}, device="cpu")(torch.from_numpy(q))
    return {"x": x, "sign": sign, "q": q, "p": p, "inv_mass": inv_mass, "grad": g0.numpy()}


def _unfused(case, n_steps):
    lp_bc = make_lp_bc(TayalHHMM(), {"x": case["x"], "sign": case["sign"]}, device="cpu")
    q, p = torch.from_numpy(case["q"]), torch.from_numpy(case["p"])
    g, im = torch.from_numpy(case["grad"]), torch.from_numpy(case["inv_mass"])
    logp = None
    for _ in range(n_steps):
        p_half = p + 0.5 * EPS * g
        q = q + EPS * im[:, None, :] * p_half
        logp, g = lp_bc(q)
        p = p_half + 0.5 * EPS * g
    return q, p, logp, g


@pytest.mark.parametrize("n_steps", [1, 3, 8])
def test_plain_vs_pallas_interpret(case, n_steps):
    traj = make_tayal_trajectory({"x": case["x"], "sign": case["sign"]}, cap=8, device="cpu")
    got = traj(
        torch.from_numpy(case["inv_mass"]), EPS, n_steps, torch.from_numpy(case["q"]),
        torch.from_numpy(case["p"]), None, torch.from_numpy(case["grad"]),
    )
    rep = lambda a: jnp.asarray(np.repeat(np.asarray(a), C, axis=0))  # noqa: E731
    flat = lambda a: jnp.asarray(a.reshape(B * C, D))  # noqa: E731
    want = j_tayal_trajectory(
        flat(case["q"]), flat(case["p"]), flat(case["grad"]), rep(case["inv_mass"]),
        jnp.float32(EPS), jnp.int32(n_steps), rep(case["x"].numpy()), rep(case["sign"].numpy()),
        None, 8, interpret=True,
    )
    want = [np.asarray(w).reshape(g.shape) for w, g in zip(want, got)]
    _assert_state_close([g.numpy() for g in got], want)


@pytest.mark.parametrize("n_steps", [2, 8])
def test_plain_vs_unfused_leapfrogs(case, n_steps):
    traj = make_tayal_trajectory({"x": case["x"], "sign": case["sign"]}, cap=8, device="cpu")
    got = traj(
        torch.from_numpy(case["inv_mass"]), EPS, n_steps, torch.from_numpy(case["q"]),
        torch.from_numpy(case["p"]), None, torch.from_numpy(case["grad"]),
    )
    _assert_state_close([g.numpy() for g in got], [w.numpy() for w in _unfused(case, n_steps)])


def test_flat_entry_matches_closure(case):
    """``tayal_trajectory`` on N = B * C lanes (series index n // C)
    equals the closure, and with chains=1 takes per-lane data."""
    args = (torch.from_numpy(case["inv_mass"]), EPS, 3)
    traj = make_tayal_trajectory({"x": case["x"], "sign": case["sign"]}, cap=4, device="cpu")
    q, p, g = (torch.from_numpy(case[k]) for k in ("q", "p", "grad"))
    ref = traj(*args, q, p, None, g)
    flat = lambda a: a.reshape(B * C, D)  # noqa: E731
    out = tayal_trajectory(flat(q), flat(p), flat(g), args[0], EPS, 3, case["x"], case["sign"],
                           None, cap=4, chains=C)
    per_lane = tayal_trajectory(
        flat(q), flat(p), flat(g), args[0].repeat_interleave(C, 0), EPS, 3,
        case["x"].repeat_interleave(C, 0), case["sign"].repeat_interleave(C, 0), None, cap=4,
    )
    for r, a, b in zip(ref, out, per_lane):
        np.testing.assert_array_equal(r.reshape(a.shape).numpy(), a.numpy())
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_step_count_is_clamped_by_cap(case):
    data = {"x": case["x"], "sign": case["sign"]}
    args = (torch.from_numpy(case["inv_mass"]), EPS)
    q, p, g = (torch.from_numpy(case[k]) for k in ("q", "p", "grad"))
    a = make_tayal_trajectory(data, cap=2, device="cpu")(*args, 5, q, p, None, g)
    b = make_tayal_trajectory(data, cap=8, device="cpu")(*args, 2, q, p, None, g)
    for x_, y_ in zip(a, b):
        np.testing.assert_array_equal(x_.numpy(), y_.numpy())
    q0, p0, lp0, g0 = make_tayal_trajectory(data, cap=8, device="cpu")(*args, 0, q, p, None, g)
    np.testing.assert_array_equal(q0.numpy(), case["q"])
    np.testing.assert_array_equal(g0.numpy(), case["grad"])
    assert torch.all(lp0 == 0)


def test_masked_padding_matches_truncated(case):
    Tv = 40
    mask = np.zeros((B, T), np.float32)
    mask[:, :Tv] = 1.0
    short = {"x": case["x"][:, :Tv], "sign": case["sign"][:, :Tv]}
    _, g_short = make_lp_bc(TayalHHMM(), short, device="cpu")(torch.from_numpy(case["q"]))
    args = (torch.from_numpy(case["inv_mass"]), EPS, 3, torch.from_numpy(case["q"]),
            torch.from_numpy(case["p"]), None, g_short)
    full = make_tayal_trajectory(
        {"x": case["x"], "sign": case["sign"], "mask": torch.from_numpy(mask)}, cap=4, device="cpu"
    )(*args)
    trunc = make_tayal_trajectory(short, cap=4, device="cpu")(*args)
    for a, b in zip(full, trunc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)


def test_closure_carries_cap_and_checks_data(case):
    traj = make_tayal_trajectory({"x": case["x"], "sign": case["sign"]}, cap=16, device="cpu")
    assert traj.cap == 16
    bad = case["x"].clone()
    bad[0, 0] = 9
    with pytest.raises(ValueError, match="symbols"):
        make_tayal_trajectory({"x": bad, "sign": case["sign"]}, cap=4, device="cpu")
    with pytest.raises(ValueError, match="sign"):
        make_tayal_trajectory({"x": case["x"], "sign": case["sign"] + 1}, cap=4, device="cpu")


def test_lane_shapes_checked(case):
    x_t = case["x"].t().to(torch.int32).contiguous()
    s_t = case["sign"].t().to(torch.int32).contiguous()
    m_t = torch.ones(T, B)
    q = torch.zeros(D, B * C)
    eps, n = torch.tensor([EPS]), torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match="chains"):
        ct.traj_lanes(q, q, q, torch.ones(D, B), x_t, s_t, m_t, eps, n, 4, 3)
    with pytest.raises(ValueError, match="inv_mass"):
        ct.traj_lanes(q, q, q, torch.ones(D, B * C), x_t, s_t, m_t, eps, n, 4, C)
    with pytest.raises(ValueError, match="coordinates"):
        ct.traj_lanes(q[:34], q, q, torch.ones(D, B), x_t, s_t, m_t, eps, n, 4, C)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_traj_matches_plain(case, cuda_device):
    dev = cuda_device
    x_t, s_t, m_t = ct._data_lanes(case["x"], case["sign"], None, dev)
    lanes = [torch.from_numpy(case[k]).reshape(B * C, D).t().contiguous().to(dev)
             for k in ("q", "p", "grad")]
    im = torch.from_numpy(case["inv_mass"]).t().contiguous().to(dev)
    eps = torch.tensor([EPS], device=dev)
    n = torch.tensor([3], dtype=torch.int32, device=dev)
    before = ct.TRAJ.launches
    got = ct.traj_lanes(*lanes, im, x_t, s_t, m_t, eps, n, 8, C)
    assert ct.TRAJ.launches == before + 1
    want = ct.traj_plain(*lanes, im, x_t, s_t, m_t, eps, n, 8, C)
    torch.cuda.synchronize()
    _assert_state_close([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want])


# ---------------------------------------------------------------------------
# the kernel's schedule, re-expressed in torch (csrc/tayal_traj.cu). The
# forward recursion carries v_t, alpha_t up to a scale: each step takes the
# plain step's numerator w_j = u_j(v) o_j times sigma_t = 2^-E(sum v_{t-1})
# (an exact power of two) and stores v_t; pass A then gives r_t = 1 / c_t
# = sigma_t sum v_{t-1} / sum v_t, ll = -sum log r_t, f_t = o_t r_t and
# alpha_t = v_t / sum v_t; the backward recursion e = f_t beta, beta <- the
# closed sparse form of sum_j Ae_ij e_j, stores beta_t; pass B reduces the
# per-symbol gamma sums, the d_A terms and d_pi. Both passes have thread l
# of a warp take steps l, l + 32, ... in order, then a fixed xor-shuffle
# tree over the 32 partial sums
# ---------------------------------------------------------------------------

WARP = 32


def _warp_reduce(terms):
    """``terms [T, ...]`` summed as the kernel's warp does: 32 interleaved
    running sums, then the xor butterfly (every lane ends with the same
    value; lane 0's is returned)."""
    T = terms.shape[0]
    pad = -(-T // WARP) * WARP
    full = torch.zeros((pad,) + terms.shape[1:], dtype=terms.dtype)
    full[:T] = terms
    rows = full.reshape((pad // WARP, WARP) + terms.shape[1:])
    part = torch.zeros_like(rows[0])
    for r in rows:
        part = part + r
    idx = torch.arange(WARP)
    for o in (16, 8, 4, 2, 1):
        part = part + part[idx ^ o]
    return part[0]


def _sum4(v):
    """``v [4, ...]`` summed as the kernel's ``sum4``."""
    return (v[0] + v[1]) + (v[2] + v[3])


def _pow2_inv(x):
    """2^-E for x = m 2^E, m in [1, 2)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), 1 - e)


def _schedule_logp_grad(q, x, sign, mask):
    """The kernel's schedule for one log density and gradient at ``q [35,
    N]`` with per-lane data ``x``, ``sign`` ``[T, N]`` (int) and ``mask``
    ``[T, N]``; the unpack is the plain version's (the kernel computes
    the same per-coordinate expressions in parallel)."""
    T, N = x.shape
    p11, zA, phi, ldj = ct._unpack(q)
    z0, z1 = zA[0], zA[1]
    omz0, omz1 = 1.0 - z0, 1.0 - z1
    ed = (sign[0] == 1).to(q.dtype)
    eu = 1.0 - ed
    pe0 = ed * p11 + (1.0 - ed)
    pe2 = eu * (1.0 - p11) + (1.0 - eu)
    lane = torch.arange(N)
    obs = phi[:, x, lane].permute(1, 0, 2)  # [T, K, N]: o_t[j]
    valid = mask > 0
    down = sign == 1
    one = torch.ones_like(p11)

    # forward recursion: v_t
    V = torch.empty((T, 4, N), dtype=q.dtype)
    o = obs[0]
    v = [pe0 * o[0], o[1], pe2 * o[2], o[3]]
    v = [torch.where(valid[0], a, b) for a, b in zip(v, [pe0, one, pe2, one])]
    V[0] = torch.stack(v)
    for t in range(1, T):
        o = obs[t]
        S = (v[0] + v[1]) + (v[2] + v[3])
        sg = _pow2_inv(S)
        dn = down[t]
        u = [torch.where(dn, v[1] + v[2] * z1, S), torch.where(dn, S, v[0] * z0),
             torch.where(dn, S, v[0] * omz0 + v[3]), torch.where(dn, v[2] * omz1, S)]
        w = [u[j] * (o[j] * sg) for j in range(4)]
        v = [torch.where(valid[t], w[j], v[j]) for j in range(4)]
        V[t] = torch.stack(v)

    # pass A: r_t = 1 / c_t, ll and f_t = o_t r_t; alpha_t = v_t / sum v_t
    sv = _sum4(V.permute(1, 0, 2))  # [T, N]
    r_all = torch.empty((T, N), dtype=q.dtype)
    r_all[0] = 1.0 / sv[0]
    sp = sv[:-1]
    r_all[1:] = torch.where(valid[1:], (_pow2_inv(sp) * sp) / sv[1:], torch.ones_like(sp))
    ll = -_warp_reduce(torch.log(r_all))
    f = obs * r_all[:, None]
    alpha = V * (1.0 / sv)[:, None]

    # backward recursion: beta_t
    beta = torch.empty((T, 4, N), dtype=q.dtype)
    b = [one] * 4
    for t in range(T - 1, 0, -1):
        beta[t] = torch.stack(b)
        e = [f[t, j] * b[j] for j in range(4)]
        dn = down[t]
        nb = [torch.where(dn, e[1] + e[2], ((e[0] + z0 * e[1]) + omz0 * e[2]) + e[3]),
              torch.where(dn, (e[0] + e[1]) + e[2], e[0] + e[3]),
              torch.where(dn, ((z1 * e[0] + e[1]) + e[2]) + omz1 * e[3], e[0] + e[3]),
              torch.where(dn, e[1] + e[2], (e[0] + e[2]) + e[3])]
        b = [torch.where(valid[t], nb[k], b[k]) for k in range(4)]
    beta[0] = torch.stack(b)

    # pass B: the warp's reductions from the stored values
    m = valid.to(q.dtype)
    gam = alpha * beta * m[:, None]  # [T, K, N]
    onehot = (x[:, None, :] == torch.arange(9)[None, :, None]).to(q.dtype)  # [T, L, N]
    dem = _warp_reduce(gam[:, :, None, :] * onehot[:, None, :, :])  # [K, L, N]
    up = (~down).to(q.dtype) * m
    dn_m = down.to(q.dtype) * m
    ap = torch.cat([torch.zeros_like(alpha[:1]), alpha[:-1]])  # alpha_{t-1}; t = 0 adds nothing
    up[0] = 0.0
    dn_m[0] = 0.0
    e = (obs * beta) * r_all[:, None]  # [T, K(j), N]
    dA01 = _warp_reduce(ap[:, 0] * z0 * e[:, 1] * up)
    dA02 = _warp_reduce(ap[:, 0] * omz0 * e[:, 2] * up)
    dA20 = _warp_reduce(ap[:, 2] * z1 * e[:, 0] * dn_m)
    dA23 = _warp_reduce(ap[:, 2] * omz1 * e[:, 3] * dn_m)
    dpi0, dpi2 = alpha[0, 0] * beta[0, 0], alpha[0, 2] * beta[0, 2]

    grad = torch.empty_like(q)
    grad[0] = dpi0 * ed * (1.0 - p11) - dpi2 * eu * p11 + (1.0 - 2.0 * p11)
    grad[1] = dA01 * (1.0 - z0) - z0 * dA02 + (1.0 - 2.0 * z0)
    grad[2] = dA20 * (1.0 - z1) - z1 * dA23 + (1.0 - 2.0 * z1)
    off = torch.log(8.0 - torch.arange(8, dtype=q.dtype))
    for k in range(4):
        for j in range(8):
            acc_s = dem[k, 8]
            for mm in range(7, j, -1):
                acc_s = acc_s + dem[k, mm]
            z = torch.exp(ct._logsig(q[3 + 8 * k + j] - off[j]))
            dldj = (1.0 - 2.0 * z) - z * float(7 - j)
            grad[3 + 8 * k + j] = dem[k, j] * (1.0 - z) - z * acc_s + dldj
    return ll + ldj, grad


def _schedule_traj(q, p, g, im, x_t, sign_t, mask_t, eps, n_steps, C):
    """``traj_plain``'s leapfrog loop over the kernel's schedule."""
    N = q.shape[1]
    lane_b = torch.arange(N) // C
    x, sign, mask, im = x_t[:, lane_b].long(), sign_t[:, lane_b], mask_t[:, lane_b], im[:, lane_b]
    hs = 0.5 * eps
    logp = torch.zeros((N,), dtype=q.dtype)
    for _ in range(n_steps):
        p = p + hs * g
        q = q + (eps * im) * p
        logp, g = _schedule_logp_grad(q, x, sign, mask)
        p = p + hs * g
    return q, p, logp, g


@pytest.fixture(scope="module")
def ragged_case():
    """3 series x 3 chains at T=75 (not a multiple of a warp), each series
    with masked runs at both ends; lane-layout tensors (numpy-made)."""
    rng = np.random.default_rng(11)
    Bs, Cs, Ts = 3, 3, 75
    x, sign = tayal_batch(Bs, Ts, seed=11, device="cpu")
    valid = np.arange(Ts)[None] < rng.integers(Ts // 2, Ts, size=Bs)[:, None]
    valid &= np.arange(Ts)[None] >= rng.integers(1, Ts // 8 + 1, size=Bs)[:, None]
    x_t, s_t, m_t = ct._data_lanes(x, sign, torch.from_numpy(valid.astype(np.float32)), "cpu")
    N = Bs * Cs
    lanes = [torch.from_numpy((sc * rng.normal(size=(D, N))).astype(np.float32))
             for sc in (0.5, 0.7, 1.0)]
    im = torch.from_numpy(np.exp(0.3 * rng.normal(size=(D, Bs))).astype(np.float32))
    return dict(lanes=lanes, im=im, x=x_t, sign=s_t, mask=m_t, C=Cs)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_kernel_schedule_matches_plain_f32(ragged_case, n_steps):
    """The kernel's schedule in f32 within TRAJ_TOL of ``traj_plain``."""
    c = ragged_case
    args = (*c["lanes"], c["im"], c["x"], c["sign"], c["mask"])
    want = ct.traj_plain(*args, torch.tensor([EPS]), torch.tensor([n_steps]), 8, c["C"])
    got = _schedule_traj(*c["lanes"], c["im"], c["x"], c["sign"], c["mask"],
                         torch.tensor(EPS), n_steps, c["C"])
    _assert_state_close([g.numpy() for g in got], [w.numpy() for w in want])


def test_kernel_schedule_is_the_plain_algebra_f64(ragged_case):
    """In float64 the schedule and ``traj_plain`` are the same function to
    rounding (1e-9), and the f32 schedule is within TRAJ_TOL of it."""
    c = ragged_case
    f64 = [a.double() for a in c["lanes"]] + [c["im"].double()]
    m64 = c["mask"].double()
    want = ct.traj_plain(*f64, c["x"], c["sign"], m64, torch.tensor([EPS], dtype=torch.float64),
                         torch.tensor([3]), 8, c["C"])
    got64 = _schedule_traj(*f64, c["x"], c["sign"], m64, torch.tensor(EPS, dtype=torch.float64),
                           3, c["C"])
    for a, b in zip(got64, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-9)
    got32 = _schedule_traj(*c["lanes"], c["im"], c["x"], c["sign"], c["mask"],
                           torch.tensor(EPS), 3, c["C"])
    _assert_state_close([g.double().numpy() for g in got32], [w.numpy() for w in want])


def test_scratch_bytes_rule():
    """Shared memory holds a lane's buffers up to T=6240 (37 bytes a step,
    T rounded up to 32, plus 1 KB of tables); past that a scratch of 37
    bytes a padded step a lane."""
    assert ct.traj_scratch_bytes(1024, 512) == 0
    assert ct.traj_scratch_bytes(6240, 4) == 0
    assert ct.traj_scratch_bytes(6241, 4) == 4 * 37 * 6272
    assert ct.traj_scratch_bytes(1, 1) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_,C_,n_steps", [(5, 1, 2, 16), (5, 1000, 3, 20), (1, 1024, 1, 1),
                                             (3, 100, 2, 0), (2, 6500, 2, 1)])
def test_cuda_traj_odd_shapes(cuda_device, B, T_, C_, n_steps):
    """The kernel against ``traj_plain`` on the card at shapes off a warp,
    a chunk and a block, masked runs at both ends, n_steps 0 and past cap,
    and T=6500 (the scratch path)."""
    dev = cuda_device
    rng = np.random.default_rng(B * 1000 + T_)
    x, sign = tayal_batch(B, T_, seed=3, device="cpu")
    valid = np.arange(T_)[None] < rng.integers(max(T_ // 2, 1), T_ + 1, size=B)[:, None]
    valid &= np.arange(T_)[None] >= rng.integers(0, T_ // 8 + 1, size=B)[:, None]
    x_t, s_t, m_t = ct._data_lanes(x.to(dev), sign.to(dev),
                                   torch.from_numpy(valid.astype(np.float32)).to(dev), dev)
    N = B * C_
    lanes = [torch.from_numpy((sc * rng.normal(size=(D, N))).astype(np.float32)).to(dev)
             for sc in (0.5, 0.7, 1.0)]
    im = torch.from_numpy(np.exp(0.3 * rng.normal(size=(D, B))).astype(np.float32)).to(dev)
    eps = torch.tensor([EPS], device=dev)
    n = torch.tensor([n_steps], dtype=torch.int32, device=dev)
    got = ct.traj_lanes(*lanes, im, x_t, s_t, m_t, eps, n, 16, C_)
    want = ct.traj_plain(*lanes, im, x_t, s_t, m_t, eps, n, 16, C_)
    torch.cuda.synchronize()
    _assert_state_close([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want])
