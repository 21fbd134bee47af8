"""The port's value-and-grad (`hhmm_tpu_torch.kernels.vg`,
`cuda_semiring.semiring_vg`, `models/base.py::make_vg`) against the JAX
package on the same numpy inputs.

- the plain ``FWD`` + ``VG_BWD`` pair against the Pallas ``semiring_vg``
  in interpret mode and against the JAX ``forward_value_and_grad`` (the
  vmapped scan ``_vg_core``), K in {2, 4, 8} (and 5, 12, 16, 17, 24, 33,
  64, 128 against the JAX entry), gated and not, ragged masks: loglik within 1e-5 relative, ``d_pi``/``d_obs`` within 1e-5
  absolute, ``d_A`` within 1e-4 relative (a sum over T terms taken in
  another order by each side);
- the plain pair against torch autograd through the port's plain
  forward in float64 (within 1e-9: same function, exact gradient);
- ``TayalHHMM().make_vg`` against the JAX ``make_vg`` at the same theta,
  both gates: logp within 1e-5 relative, gradient within 1e-4 absolute;
- data ``[B, T]`` against chains ``[B, C]`` lines up series by series
  (B == C, where a misaligned broadcast would pass silently);
- the ``VG_BWD`` kernel against its plain version, bitwise (marked
  ``cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhmm_tpu.infer import make_lp_bc as j_make_lp_bc
from hhmm_tpu.kernels.pallas_semiring import semiring_vg as j_semiring_vg
from hhmm_tpu.kernels.vg import forward_value_and_grad as j_fvg
from hhmm_tpu.models import TayalHHMM as JTayalHHMM
from hhmm_tpu_torch.kernels import ForwardLoglik, forward_value_and_grad
from hhmm_tpu_torch.kernels import cuda_semiring as cs
from hhmm_tpu_torch.models import TayalHHMM
from hhmm_tpu_torch.sim import tayal_batch

torch.set_num_threads(1)

LL_RTOL = 1e-5
D_ATOL = 1e-5
DA_RTOL = 1e-4

CASES = [(K, gated) for K in (2, 4, 8) for gated in (False, True)]
WIDE_CASES = [(5, True), (12, False), (16, True)]  # groups of 8 and 16 threads on the card
WIDEST_CASES = [(17, True), (24, False), (33, True), (64, False), (128, True)]


def _log_norm(a):
    return a - np.log(np.exp(a).sum(-1, keepdims=True))


def _batch(rng, B, T, K, gated=False):
    """Numpy f32 inputs: normalized (pi, A), N(-1, 1) emissions, prefix
    masks of lengths in [T/2, T], optional sign-gate keys."""
    out = {
        "log_pi": _log_norm(rng.normal(size=(B, K))),
        "log_A": _log_norm(rng.normal(size=(B, K, K))),
        "log_obs": rng.normal(size=(B, T, K)) - 1.0,
    }
    lengths = rng.integers(T // 2, T + 1, size=B)
    out["mask"] = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float64)
    if gated:
        out["gate_key"] = rng.integers(0, 2, size=(B, T)).astype(np.float64)
        out["state_key"] = np.tile(np.resize([1.0, 0.0, 0.0, 1.0], K), (B, 1))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _t(d, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in d.items()}


def _j_args(d):
    args = [jnp.asarray(d[k]) for k in ("log_pi", "log_A", "log_obs", "mask")]
    if "gate_key" in d:
        args += [jnp.asarray(d["gate_key"]), jnp.asarray(d["state_key"])]
    return args


def _assert_vg_close(out, ref):
    ll, d_pi, d_A, d_obs = (o.numpy() for o in out)
    rll, rpi, rA, robs = (np.asarray(r) for r in ref)
    np.testing.assert_allclose(ll, rll, rtol=LL_RTOL, atol=0)
    np.testing.assert_allclose(d_pi, rpi, rtol=0, atol=D_ATOL)
    np.testing.assert_allclose(d_obs, robs, rtol=0, atol=D_ATOL)
    np.testing.assert_allclose(d_A, rA, rtol=DA_RTOL, atol=D_ATOL)


class TestPlainPairVsJax:
    @pytest.mark.parametrize("K,gated", CASES)
    def test_vs_pallas_interpret(self, rng, K, gated):
        d = _batch(rng, 3, 48, K, gated)
        out = cs.semiring_vg(**_t(d))
        ref = j_semiring_vg(*_j_args(d), t_block=16, interpret=True)
        _assert_vg_close(out, ref)

    @pytest.mark.parametrize("K,gated", CASES + WIDE_CASES)
    def test_forward_value_and_grad_vs_vg_core(self, rng, K, gated):
        d = _batch(rng, 3, 64, K, gated)
        out = forward_value_and_grad(**_t(d))
        ref = jax.vmap(j_fvg)(*_j_args(d))
        _assert_vg_close(out, ref)

    @pytest.mark.parametrize("K,gated", WIDEST_CASES)
    def test_forward_value_and_grad_vs_jax_k_above_16(self, rng, K, gated):
        """K in 17..128 (on the card a warp a lane up to 32, a block a
        lane above): two series, T = 32, against the JAX entry (its
        fused kernel up to T K = 4096, the scan above)."""
        d = _batch(rng, 2, 32, K, gated)
        out = forward_value_and_grad(**_t(d))
        ref = jax.vmap(j_fvg)(*_j_args(d))
        _assert_vg_close(out, ref)


class TestPlainPairVsAutograd:
    @pytest.mark.parametrize("K,gated", [(2, False), (4, True), (8, False), (8, True)])
    def test_closed_form_is_the_gradient_f64(self, rng, K, gated):
        d = _t(_batch(rng, 3, 40, K, gated), torch.float64)
        leaves = [d[k].clone().requires_grad_(True) for k in ("log_pi", "log_A", "log_obs")]
        lanes = cs.to_lanes(*leaves, d["mask"], d.get("gate_key"), d.get("state_key"))
        ll_ref, _ = cs.fwd_plain(*lanes)
        grads = torch.autograd.grad(ll_ref.sum(), leaves)
        ll, d_pi, d_A, d_obs = forward_value_and_grad(**d)
        np.testing.assert_allclose(ll.numpy(), ll_ref.detach().numpy(), rtol=1e-12)
        for got, want in zip((d_pi, d_A, d_obs), grads):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-9)

    def test_autograd_function_scales_by_incoming_gradient(self, rng):
        d = _t(_batch(rng, 4, 32, 4, gated=True))
        leaves = [d[k].clone().requires_grad_(True) for k in ("log_pi", "log_A", "log_obs")]
        w = torch.tensor([1.0, -2.0, 0.5, 3.0])
        ll = ForwardLoglik.apply(*leaves, d["mask"], d["gate_key"], d["state_key"])
        (ll * w).sum().backward()
        _, d_pi, d_A, d_obs = forward_value_and_grad(**d)
        np.testing.assert_allclose(leaves[0].grad.numpy(), (w[:, None] * d_pi).numpy(), rtol=1e-6)
        np.testing.assert_allclose(leaves[1].grad.numpy(), (w[:, None, None] * d_A).numpy(), rtol=1e-6)
        np.testing.assert_allclose(leaves[2].grad.numpy(), (w[:, None, None] * d_obs).numpy(), rtol=1e-6)

    def test_masked_steps_have_zero_emission_gradient(self, rng):
        d = _t(_batch(rng, 3, 40, 4))
        _, _, _, d_obs = forward_value_and_grad(**d)
        assert torch.all(d_obs[d["mask"] == 0] == 0)
        # gamma sums to one on every valid step
        valid = d["mask"] > 0
        np.testing.assert_allclose(d_obs.sum(-1)[valid].numpy(), 1.0, atol=1e-5)

    def test_log_A_is_not_clamped(self, rng, monkeypatch):
        """Unlike the FFBS entry, the vg entry uses log_A as given."""
        d = _t(_batch(rng, 2, 16, 4))
        seen = []
        orig = cs.fwd_lanes

        def spy(pi_t, A_t, *rest):
            seen.append(A_t.clone())
            return orig(pi_t, A_t, *rest)

        d["log_A"][0, 0, 0] = -2e30
        monkeypatch.setattr(cs, "fwd_lanes", spy)
        cs.semiring_vg(**d)
        assert seen[0][0, 0, 0] == d["log_A"][0, 0, 0] < -1e30


def _tayal_theta(rng, B, C):
    return (0.5 * rng.normal(size=(B, C, 35))).astype(np.float32)


class TestMakeVg:
    @pytest.mark.parametrize("gate_mode", ["stan", "hard"])
    def test_tayal_make_vg_vs_jax(self, rng, gate_mode):
        B, C, T = 3, 2, 64
        x, sign = tayal_batch(B, T, seed=5, device="cpu")
        theta = _tayal_theta(rng, B, C)
        logp, grad = TayalHHMM(gate_mode=gate_mode).make_vg({"x": x, "sign": sign})(
            torch.from_numpy(theta)
        )
        jd = {"x": jnp.asarray(x.numpy()), "sign": jnp.asarray(sign.numpy())}
        jlp, jgrad = jax.jit(j_make_lp_bc(JTayalHHMM(gate_mode=gate_mode), jd))(jnp.asarray(theta))
        assert logp.shape == (B, C) and grad.shape == (B, C, 35)
        np.testing.assert_allclose(logp.numpy(), np.asarray(jlp), rtol=1e-5)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-4)

    def test_single_point_and_ragged_mask(self, rng):
        T = 40
        x, sign = tayal_batch(1, T, seed=2, device="cpu")
        mask = (np.arange(T) < 29).astype(np.float32)
        theta = _tayal_theta(rng, 1, 1)[0, 0]
        data = {"x": x[0], "sign": sign[0], "mask": torch.from_numpy(mask)}
        logp, grad = TayalHHMM().make_vg(data)(torch.from_numpy(theta))
        jd = {k: jnp.asarray(np.asarray(v)) for k, v in data.items()}
        jlp, jgrad = jax.jit(JTayalHHMM().make_vg(jd))(jnp.asarray(theta))
        assert logp.shape == () and grad.shape == (35,)
        np.testing.assert_allclose(float(logp), float(jlp), rtol=1e-5)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-4)
        # and equal to the truncated series
        tr = {"x": x[0, :29], "sign": sign[0, :29]}
        lp_t, g_t = TayalHHMM().make_vg(tr)(torch.from_numpy(theta))
        np.testing.assert_allclose(float(logp), float(lp_t), rtol=1e-6)
        np.testing.assert_allclose(grad.numpy(), g_t.numpy(), atol=1e-5)

    @pytest.mark.parametrize("gate_mode", ["stan", "hard"])
    def test_series_data_line_up_with_chain_lanes(self, rng, gate_mode):
        """Data [B, T] against theta [B, C] with B == C: each chain must
        see its own series (a right-aligned broadcast would pair chain c
        with series c instead)."""
        B = C = 3
        x, sign = tayal_batch(B, 32, seed=8, device="cpu")
        theta = torch.from_numpy(_tayal_theta(rng, B, C))
        model = TayalHHMM(gate_mode=gate_mode)
        logp, grad = model.make_vg({"x": x, "sign": sign})(theta)
        for b in range(B):
            lp_b, g_b = model.make_vg({"x": x[b], "sign": sign[b]})(theta[b])
            np.testing.assert_allclose(logp[b].numpy(), lp_b.numpy(), rtol=1e-6)
            np.testing.assert_allclose(grad[b].numpy(), g_b.numpy(), atol=1e-5)
        params, _ = model.unpack(theta)
        log_pi, log_A, log_obs, _ = model.build_vg(params, {"x": x, "sign": sign})
        p0, _ = model.unpack(theta[1])
        ref = model.build_vg(p0, {"x": x[1], "sign": sign[1]})
        for got, want in zip((log_pi, log_A, log_obs), ref[:3]):
            np.testing.assert_array_equal(got[1].detach().numpy(), want.detach().numpy())

    def test_log_prior_is_flat(self):
        model = TayalHHMM()
        params, _ = model.unpack(torch.zeros(2, 3, 35))
        assert float(model.log_prior(params)) == 0.0


class TestWrapperChecks:
    def test_gate_keys_come_in_pairs(self, rng):
        d = _t(_batch(rng, 2, 16, 4, gated=True))
        with pytest.raises(ValueError, match="together"):
            forward_value_and_grad(d["log_pi"], d["log_A"], d["log_obs"], d["mask"], d["gate_key"])

    def test_time_varying_A_raises(self, rng):
        """A time-varying ``log_A`` runs the scans (``test_torch_nuts_models.py``
        holds it against the JAX entry); one with the wrong number of
        slices raises."""
        d = _t(_batch(rng, 2, 16, 4))
        with pytest.raises(ValueError, match="T-1=15 slices"):
            forward_value_and_grad(d["log_pi"], d["log_A"][:, None].expand(2, 14, 4, 4),
                                   d["log_obs"], d["mask"])

    @pytest.mark.parametrize("bad", ["ll", "alpha", "gate_alone"])
    def test_lane_shapes_checked(self, rng, bad):
        d = _t(_batch(rng, 3, 16, 4, gated=True))
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = cs.to_lanes(**d)
        ll, alpha = cs.fwd_lanes(pi_t, A_t, obs_t, mask_t, gate_t, sk_t)
        if bad == "ll":
            ll = ll[:2]
        elif bad == "alpha":
            alpha = alpha[:8]
        else:
            sk_t = None
        with pytest.raises(ValueError):
            cs.vg_bwd_lanes(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K,gated", [(2, False), (4, True), (8, False), (8, True)] + WIDE_CASES
                         + WIDEST_CASES)
def test_cuda_vg_bwd_matches_plain(rng, cuda_device, K, gated):
    d = {k: v.to(cuda_device) for k, v in _t(_batch(rng, 300, 130, K, gated)).items()}
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = cs.to_lanes(**d)
    ll, alpha = cs.fwd_lanes(pi_t, A_t, obs_t, mask_t, gate_t, sk_t)
    before = cs.VG_BWD.launches
    got = cs.vg_bwd_lanes(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)
    assert cs.VG_BWD.launches == before + 1
    want = cs.vg_bwd_plain(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_emission_gradient_matches_gather_autograd(rng):
    """The Tayal emission lookup's deterministic backward equals the
    gradient autograd takes through ``torch.gather``."""
    from hhmm_tpu_torch.models.tayal import _Emissions

    log_phi = torch.from_numpy(rng.normal(size=(3, 2, 4, 9))).requires_grad_(True)
    x = torch.from_numpy(rng.integers(0, 9, size=(3, 2, 50)))
    w = torch.from_numpy(rng.normal(size=(3, 2, 50, 4)))
    (got,) = torch.autograd.grad((_Emissions.apply(log_phi, x) * w).sum(), log_phi)
    idx = x[..., None, :].expand(3, 2, 4, 50)
    ref_obs = torch.gather(log_phi, -1, idx).transpose(-1, -2)
    (want,) = torch.autograd.grad((ref_obs * w).sum(), log_phi)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(_Emissions.apply(log_phi, x).detach().numpy(), ref_obs.detach().numpy())
