"""The PyTorch port's kernels module (`hhmm_tpu_torch.kernels`) against
the JAX package on the same numpy inputs.

- the plain scans ``forward_filter`` (within 1e-5, absolute and
  relative: f32 exp/log implementations differ by an ulp per step) and
  ``viterbi`` (paths exactly, on tie-free inputs);
- the FFBS kernels' plain versions, draw for draw, against both
  ``ffbs_invcdf_reference`` and the Pallas ``semiring_ffbs`` run in
  interpret mode, gated and ungated, ragged masks, uniforms kept at least
  1e-4 from every CDF bucket edge;
- the forward kernel's plain version against the Pallas
  ``_run_chunked_forward`` in interpret mode (within 1e-5);
- the identity ``BWD_SAMPLE`` rests on: a chase through the packed map
  of every candidate draw (one int32 word a step up to K = 8, two above)
  equals the serial backward walk and the JAX reference, draw for draw,
  at K from 2 to 16;
- the same kernels on a CUDA device against their plain versions,
  bitwise (marked ``cuda``: skipped without a card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhmm_tpu.kernels import forward_filter as j_forward_filter
from hhmm_tpu.kernels import viterbi as j_viterbi
from hhmm_tpu.kernels.dispatch import semiring_ffbs as j_semiring_ffbs
from hhmm_tpu.kernels.ffbs import ffbs_invcdf_reference as j_ffbs_reference
from hhmm_tpu.kernels.pallas_semiring import _LANES, _pad_chunked, _run_chunked_forward
from hhmm_tpu_torch.kernels import (
    ffbs_dispatch,
    ffbs_invcdf_reference,
    forward_alpha,
    forward_filter,
    viterbi,
    viterbi_dispatch,
)
from hhmm_tpu_torch.kernels import cuda_semiring as cs

torch.set_num_threads(1)

SCAN_TOL = 1e-5
EDGE = 1e-4


def _log_norm(a):
    return a - np.log(np.exp(a).sum(-1, keepdims=True))


def _batch(rng, B, T, K, ragged=True, gated=False, tv=False):
    """Numpy f32 inputs: normalized (pi, A), N(-1, 1) emissions, prefix
    masks of lengths in [T/2, T], optional gate keys / time-varying A."""
    out = {
        "log_pi": _log_norm(rng.normal(size=(B, K))),
        "log_A": _log_norm(rng.normal(size=(B, T - 1, K, K) if tv else (B, K, K))),
        "log_obs": rng.normal(size=(B, T, K)) - 1.0,
    }
    lengths = rng.integers(T // 2, T + 1, size=B) if ragged else np.full(B, T)
    out["mask"] = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float64)
    if gated:
        out["gate_key"] = rng.integers(0, 2, size=(B, T)).astype(np.float64)
        out["state_key"] = np.tile(np.resize([1.0, 0.0, 0.0, 1.0], K), (B, 1))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


class TestScans:
    @pytest.mark.parametrize("K", [2, 4, 8])
    @pytest.mark.parametrize("ragged", [False, True])
    @pytest.mark.parametrize("tv", [False, True])
    def test_forward_filter(self, rng, K, ragged, tv):
        d = _batch(rng, 3, 40, K, ragged=ragged, tv=tv)
        la, ll = forward_filter(**_t(d))
        jla, jll = jax.vmap(j_forward_filter)(**_j(d))
        np.testing.assert_allclose(la.numpy(), np.asarray(jla), rtol=SCAN_TOL, atol=SCAN_TOL)
        np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=SCAN_TOL, atol=SCAN_TOL)

    def test_forward_filter_impossible_evidence(self, rng):
        d = _batch(rng, 2, 20, 4, ragged=False)
        d["log_obs"][:, 9] = -np.inf
        la, ll = forward_filter(**_t(d))
        jla, jll = jax.vmap(j_forward_filter)(**_j(d))
        np.testing.assert_array_equal(la.numpy()[:, 9:], np.asarray(jla)[:, 9:])
        assert np.all(ll.numpy() == -np.inf) and np.all(np.asarray(jll) == -np.inf)

    @pytest.mark.parametrize("K", [2, 4, 8])
    @pytest.mark.parametrize("ragged", [False, True])
    @pytest.mark.parametrize("tv", [False, True])
    def test_viterbi_paths_exact(self, rng, K, ragged, tv):
        d = _batch(rng, 3, 40, K, ragged=ragged, tv=tv)
        path, lp = viterbi(**_t(d))
        jpath, jlp = jax.vmap(j_viterbi)(**_j(d))
        np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=SCAN_TOL, atol=SCAN_TOL)

    def test_viterbi_ties_go_to_lowest_index(self):
        log_pi = torch.zeros(1, 3)
        log_A = torch.zeros(1, 3, 3)
        log_obs = torch.zeros(1, 5, 3)
        path, _ = viterbi(log_pi, log_A, log_obs)
        jpath, _ = j_viterbi(jnp.zeros(3), jnp.zeros((3, 3)), jnp.zeros((5, 3)))
        np.testing.assert_array_equal(path[0].numpy(), np.asarray(jpath))
        assert path.sum() == 0


# ---------------------------------------------------------------------------
# FFBS: plain versions of the CUDA kernels, draw for draw
# ---------------------------------------------------------------------------


def _edge_distance(d, z, u):
    """Per (lane, step) distance from ``u`` to the nearest CDF edge of
    the step's sampling distribution given the drawn successor, from the
    plain forward pass; +inf past each lane's last valid step."""
    t = _t(d)
    gk, sk = t.get("gate_key"), t.get("state_key")
    alpha, _ = forward_alpha(
        t["log_pi"], t["log_A"], t["log_obs"], t["mask"], gk, sk
    )
    B, T, K = alpha.shape
    z = torch.as_tensor(z)
    zn = z[:, 1:]  # successor of steps 0..T-2
    col = torch.gather(
        t["log_A"][:, None].expand(B, T - 1, K, K), 3,
        zn[..., None, None].expand(B, T - 1, K, 1),
    )[..., 0]
    g = t["mask"][:, 1:] > 0
    if gk is not None:
        g = g & (gk[:, 1:] == sk.gather(1, zn))
    logits = alpha.clone()
    logits[:, :-1] = torch.where(g[..., None], alpha[:, :-1] + col, alpha[:, :-1])
    p = torch.softmax(logits.double(), -1)
    cum = torch.cumsum(p[..., :-1], -1)
    dist = (cum - torch.as_tensor(u).double()[..., None]).abs().amin(-1)
    t_last = t["mask"].sum(-1).long() - 1
    valid = torch.arange(T)[None] <= t_last[:, None]
    return torch.where(valid, dist, torch.full_like(dist, np.inf)).numpy()


def _uniforms_off_edges(rng, d):
    """Uniforms ``u [B, T]`` redrawn until every valid step's uniform is
    at least ``EDGE`` from a CDF edge of the plain FFBS draw it feeds."""
    B, T, _ = d["log_obs"].shape
    u = rng.random((B, T)).astype(np.float32)
    for _ in range(100):
        z, _ = cs.semiring_ffbs(**_t(d), u=torch.from_numpy(u))
        near = _edge_distance(d, z, u) < EDGE
        if not near.any():
            return u
        u[near] = rng.random(int(near.sum())).astype(np.float32)
    raise AssertionError("could not draw uniforms away from the CDF edges")


FFBS_CASES = [(K, gated) for K in (2, 4, 8) for gated in (False, True) if not (gated and K == 2)]


class TestFFBSDrawForDraw:
    @pytest.mark.parametrize("K,gated", FFBS_CASES)
    def test_plain_vs_jax_reference(self, rng, K, gated):
        d = _batch(rng, 3, 64, K, gated=gated)
        u = _uniforms_off_edges(rng, d)
        z, ll = cs.semiring_ffbs(**_t(d), u=torch.from_numpy(u))
        jd = _j(d)
        jz, jll = jax.vmap(j_ffbs_reference)(
            jd["log_pi"], jd["log_A"], jd["log_obs"], jd["mask"], jnp.asarray(u),
            *((jd["gate_key"], jd["state_key"]) if gated else ()),
        )
        np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
        np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=SCAN_TOL, atol=SCAN_TOL)

    @pytest.mark.parametrize("K,gated", FFBS_CASES)
    def test_plain_vs_pallas_interpret(self, rng, K, gated):
        d = _batch(rng, 3, 64, K, gated=gated)
        u = _uniforms_off_edges(rng, d)
        z, ll = cs.semiring_ffbs(**_t(d), u=torch.from_numpy(u))
        jd = _j(d)
        jz, jll = j_semiring_ffbs(
            jd["log_pi"], jd["log_A"], jd["log_obs"], jd["mask"], jnp.asarray(u),
            *((jd["gate_key"], jd["state_key"]) if gated else ()),
            t_block=32, interpret=True,
        )
        np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
        np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=SCAN_TOL, atol=SCAN_TOL)

    @pytest.mark.parametrize("gated", [False, True])
    def test_port_reference_matches_plain_kernels(self, rng, gated):
        d = _batch(rng, 4, 64, 4, gated=gated)
        u = _uniforms_off_edges(rng, d)
        z, ll = cs.semiring_ffbs(**_t(d), u=torch.from_numpy(u))
        zr, llr = ffbs_invcdf_reference(**_t(d), u=torch.from_numpy(u))
        np.testing.assert_array_equal(z.numpy(), zr.numpy())
        np.testing.assert_allclose(ll.numpy(), llr.numpy(), rtol=SCAN_TOL, atol=SCAN_TOL)

    def test_padded_tail_repeats_last_valid_state(self, rng):
        d = _batch(rng, 5, 48, 4)
        z, _ = cs.semiring_ffbs(**_t(d), u=torch.from_numpy(rng.random((5, 48)).astype(np.float32)))
        for b in range(5):
            n = int(d["mask"][b].sum())
            assert np.all(z[b, n:].numpy() == int(z[b, n - 1]))

    def test_dispatch_draws_from_generator(self, rng):
        d = _t(_batch(rng, 3, 32, 4, gated=True))
        g1 = torch.Generator().manual_seed(5)
        g2 = torch.Generator().manual_seed(5)
        z1, ll1 = ffbs_dispatch(g1, d["log_pi"], d["log_A"], d["log_obs"], d["mask"],
                                d["gate_key"], d["state_key"])
        u = torch.rand((3, 32), generator=g2)
        z2, ll2 = cs.semiring_ffbs(**d, u=u)
        np.testing.assert_array_equal(z1.numpy(), z2.numpy())
        np.testing.assert_array_equal(ll1.numpy(), ll2.numpy())


def _both_ends(rng, mask):
    """The prefix masks of ``_batch`` with a masked run at the start too:
    each lane's first ``[0, T/8]`` steps masked."""
    T = mask.shape[1]
    lead = rng.integers(0, T // 8 + 1, size=mask.shape[0])
    return (mask * (np.arange(T)[None, :] >= lead[:, None])).astype(np.float32)


def _chase_plain(A_t, mask_t, alpha_t, u_t, gate_t=None, sk_t=None):
    """The ``BWD_SAMPLE`` kernel's design in plain torch: every candidate
    draw map_t[s] (the draw of step t given successor s, with the serial
    walk's arithmetic) in one pass over all steps, packed B = 4 bits a
    state into ceil(K / 8) int32 words a step up to K = 16, a byte into
    ceil(K / 4) above (``cs._pack``; the last step's map sends every
    state to z_{T-1}), then the pointer chase z = 0, z_t = (map_t[z // P]
    >> B (z % P)) & (2^B - 1) for t = T-1 .. 0, P = 32 / B. Returns ``z
    [T, N]`` int32."""
    T, K, N = alpha_t.shape
    cand = torch.empty((T, K, N), dtype=torch.int32)  # [t, s, n]
    if T > 1:
        g0 = (mask_t[1:] > 0).to(alpha_t.dtype)  # [T-1, N]
        for s in range(K):
            g = g0
            if gate_t is not None:
                g = g * (gate_t[1:] == sk_t[s]).to(alpha_t.dtype)
            logits = alpha_t[:-1] + g[:, None, :] * A_t[:, s][None]  # [T-1, K, N]
            cand[:-1, s] = cs._invcdf(
                logits.permute(1, 0, 2).reshape(K, -1), u_t[:-1].reshape(-1)
            ).reshape(T - 1, N)
    cand[-1] = cs._invcdf(alpha_t[-1], u_t[-1])[None]
    words = torch.stack([cs._pack(cand[t]) for t in range(T)])  # [T, W, N]
    z = torch.zeros(N, dtype=torch.int32)
    out = torch.empty((T, N), dtype=torch.int32)
    B = cs._map_bits(K)  # four bits a state up to K = 16, a byte above
    P = 32 // B
    for t in range(T - 1, -1, -1):
        w = words[t].gather(0, (z // P).long()[None])[0]
        z = (w >> (B * (z % P))) & (2**B - 1)
        out[t] = z
    return out


def _lane_uniforms_off_edges(rng, A_t, mask_t, alpha_t, gate_t, sk_t):
    """Uniforms ``u [T, N]`` redrawn until every step's uniform (masked
    steps too: both forms draw them) is at least ``EDGE`` from a CDF edge
    of the serial walk's draw at that step."""
    T, K, N = alpha_t.shape
    lane = torch.arange(N)
    u = torch.from_numpy(rng.random((T, N)).astype(np.float32))
    if K == 1:  # one state: the draw counts over no edge
        return u
    for _ in range(100):
        z = cs.bwd_sample_plain(A_t, mask_t, alpha_t, u, gate_t, sk_t).long()
        logits = alpha_t.double().clone()
        for t in range(T - 1):
            g = mask_t[t + 1] > 0
            if gate_t is not None:
                g = g & (gate_t[t + 1] == sk_t[z[t + 1], lane])
            col = A_t[:, z[t + 1], lane].double()
            logits[t] = torch.where(g, logits[t] + col, logits[t])
        cum = torch.cumsum(torch.softmax(logits, 1)[:, :-1], 1)  # [T, K-1, N]
        near = (cum - u.double()[:, None]).abs().amin(1) < EDGE
        if not near.any():
            return u
        u[near] = torch.from_numpy(rng.random(int(near.sum())).astype(np.float32))
    raise AssertionError("could not draw uniforms away from the CDF edges")


class TestBwdSampleChoiceMap:
    """The identity ``BWD_SAMPLE`` rests on: the serial backward walk
    equals a chase through the packed map of all candidate draws."""

    @pytest.mark.parametrize("masks", ["prefix", "both_ends"])
    @pytest.mark.parametrize("K,gated", [(K, g) for K in (2, 3, 4, 5, 8, 12, 16, 20, 33)
                                         for g in (False, True)])
    def test_chase_equals_serial_walk_and_jax_reference(self, rng, K, gated, masks):
        d = _batch(rng, 3, 64, K, gated=gated)
        if masks == "both_ends":
            d["mask"] = _both_ends(rng, d["mask"])
        t = _t(d)
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = cs.to_lanes(
            t["log_pi"], t["log_A"].clamp_min(-1e30), t["log_obs"], t["mask"],
            t.get("gate_key"), t.get("state_key"),
        )
        _, alpha_t = cs.fwd_plain(pi_t, A_t, obs_t, mask_t, gate_t, sk_t)
        u_t = _lane_uniforms_off_edges(rng, A_t, mask_t, alpha_t, gate_t, sk_t)
        z_chase = _chase_plain(A_t, mask_t, alpha_t, u_t, gate_t, sk_t)
        z_walk = cs.bwd_sample_plain(A_t, mask_t, alpha_t, u_t, gate_t, sk_t)
        assert torch.equal(z_chase, z_walk)
        if masks == "prefix":
            # the JAX reference, with semiring_ffbs's padded-tail repeat
            jd = _j(d)
            jz, _ = jax.vmap(j_ffbs_reference)(
                jd["log_pi"], jd["log_A"], jd["log_obs"], jd["mask"], jnp.asarray(u_t.t().numpy()),
                *((jd["gate_key"], jd["state_key"]) if gated else ()),
            )
            z = z_chase.t().long()
            t_last = t["mask"].sum(-1).long() - 1
            last = z.gather(1, t_last[:, None])
            z = torch.where(torch.arange(64)[None, :] <= t_last[:, None], z, last)
            np.testing.assert_array_equal(z.numpy(), np.asarray(jz))


class TestForwardChunkedVsPallas:
    @pytest.mark.parametrize("K,gated", [(4, True), (4, False), (8, True)])
    def test_alpha_residual(self, rng, K, gated):
        d = _batch(rng, 3, 80, K, gated=gated)
        la, ll = cs.forward_chunked(**_t(d))
        jd = _j(d)
        Tc = 32
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t, Bp, Tp, nc = _pad_chunked(
            jd["log_pi"], jd["log_A"], jd["log_obs"], jd["mask"],
            jd.get("gate_key"), jd.get("state_key"), Tc,
        )
        jll, jalpha = _run_chunked_forward(
            pi_t, A_t, obs_t, mask_t, gate_t, sk_t, (Bp // _LANES, nc), Tc, True
        )
        ref = np.asarray(jalpha).transpose(2, 0, 1)[:3, :80]
        np.testing.assert_allclose(la.numpy(), ref, rtol=SCAN_TOL, atol=SCAN_TOL)
        np.testing.assert_allclose(ll.numpy(), np.asarray(jll)[0, :3], rtol=SCAN_TOL, atol=SCAN_TOL)

    def test_forward_alpha_ungated_equals_guarded_filter(self, rng):
        d = _t(_batch(rng, 3, 50, 4))
        la, ll = forward_alpha(d["log_pi"], d["log_A"], d["log_obs"], d["mask"])
        fla, fll = forward_filter(d["log_pi"], d["log_A"], d["log_obs"], d["mask"])
        np.testing.assert_allclose(la.numpy(), fla.numpy(), rtol=SCAN_TOL, atol=SCAN_TOL)
        np.testing.assert_allclose(ll.numpy(), fll.numpy(), rtol=SCAN_TOL, atol=SCAN_TOL)


class TestWrapperChecks:
    def test_time_varying_A_rejected_by_ffbs(self, rng):
        d = _t(_batch(rng, 2, 16, 4, tv=True))
        with pytest.raises(ValueError, match="homogeneous"):
            ffbs_dispatch(torch.Generator(), d["log_pi"], d["log_A"], d["log_obs"], d["mask"])

    def test_gate_keys_come_in_pairs(self, rng):
        d = _t(_batch(rng, 2, 16, 4, gated=True))
        with pytest.raises(ValueError, match="together"):
            ffbs_dispatch(torch.Generator(), d["log_pi"], d["log_A"], d["log_obs"],
                          d["mask"], d["gate_key"], None)

    @pytest.mark.parametrize("bad", ["pi", "mask", "u", "state_key"])
    def test_shape_mismatch_raises(self, rng, bad):
        d = _t(_batch(rng, 3, 16, 4, gated=True))
        u = torch.rand(3, 16)
        if bad == "pi":
            d["log_pi"] = d["log_pi"][:, :3]
        elif bad == "mask":
            d["mask"] = d["mask"][:, :8]
        elif bad == "u":
            u = u[:2]
        else:
            d["state_key"] = d["state_key"][:, :2]
        with pytest.raises(ValueError):
            cs.semiring_ffbs(**d, u=u)

    @pytest.mark.parametrize("bad", ["A", "mask", "u", "sk_alone"])
    def test_lane_layout_shape_mismatch_raises(self, rng, bad):
        """The lane wrappers check every operand against the shape the
        kernel indexes, whatever the device."""
        d = _t(_batch(rng, 3, 16, 4, gated=True))
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = cs.to_lanes(**d)
        u_t = torch.rand(16, 3)
        if bad == "A":
            A_t = A_t[..., :2]
        elif bad == "mask":
            mask_t = mask_t[:8]
        elif bad == "u":
            u_t = u_t[:, :2]
        else:
            gate_t = None
        # obs_t stands in for the alpha residual: both are [T, K, N]
        calls = [lambda: cs.bwd_sample_lanes(A_t, mask_t, obs_t, u_t, gate_t, sk_t)]
        if bad != "u":
            calls.append(lambda: cs.fwd_lanes(pi_t, A_t, obs_t, mask_t, gate_t, sk_t))
        for call in calls:
            with pytest.raises(ValueError):
                call()

    def test_homogeneous_viterbi_runs_on_cpu(self, rng):
        d = _t(_batch(rng, 2, 16, 4))
        path, _ = viterbi_dispatch(d["log_pi"], d["log_A"], d["log_obs"], d["mask"])
        assert path.shape == (2, 16)


# ---------------------------------------------------------------------------
# the CUDA kernels themselves (skipped without a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,masks", [(300, 130, "prefix"), (250, 1000, "both_ends"),
                                       (1, 1024, "both_ends"), (256, 1, "both_ends"),
                                       (7, 2049, "both_ends")])
@pytest.mark.parametrize("K,gated", [(2, False), (3, True), (4, False), (4, True), (8, True),
                                     (5, True), (12, False), (16, True), (20, True), (33, False),
                                     (64, True)])
def test_cuda_kernels_match_plain(rng, cuda_device, K, gated, N, T, masks):
    """Bitwise: alpha, ll and every draw (T=2049 takes the maps' device
    scratch instead of shared memory, at K > 8 with two words a step)."""
    d = _batch(rng, N, T, K, gated=gated)
    if masks == "both_ends":
        d["mask"] = _both_ends(rng, d["mask"])
    d = {k: v.to(cuda_device) for k, v in _t(d).items()}
    lanes = cs.to_lanes(**d)
    u_t = torch.rand(T, N, device=cuda_device)
    before = (cs.FWD.launches, cs.BWD_SAMPLE.launches)
    ll_k, a_k = cs.fwd_lanes(*lanes)
    z_k = cs.bwd_sample_lanes(lanes[1], lanes[3], a_k, u_t, lanes[4], lanes[5])
    assert (cs.FWD.launches, cs.BWD_SAMPLE.launches) == (before[0] + 1, before[1] + 1)
    ll_p, a_p = cs.fwd_plain(*lanes)
    z_p = cs.bwd_sample_plain(lanes[1], lanes[3], a_p, u_t, lanes[4], lanes[5])
    torch.cuda.synchronize()
    assert torch.equal(a_k, a_p) and torch.equal(ll_k, ll_p)
    assert torch.equal(z_k, z_p)
