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
