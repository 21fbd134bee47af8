"""K = 1 through the port's semiring entries against the JAX package on
the same numpy inputs, on the CPU (the kernels' plain versions).

A one-state chain has one path: the filters carry ``alpha_t =
alpha_{t-1} + A + obs_t`` over the valid steps, the Viterbi path and
every FFBS draw are 0, and the gradient of the log-likelihood is the
mask in ``d_obs`` and ``d_pi``. The port's plain versions hold the JAX
``forward_filter_dispatch``, ``viterbi_dispatch``, the FFBS reference and
``forward_value_and_grad`` within ``RTOL`` + ``ATOL``, paths and draws
exactly. On the card the same entries launch the kernels at K = 1
(``chip_smoke.py``'s ``kernels_k1`` holds them bitwise to these plain
versions); ``tests/test_torch_decode.py`` checks that a CUDA operand at
K = 1 reaches the kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhmm_tpu.kernels import dispatch as jd
from hhmm_tpu.kernels.ffbs import ffbs_invcdf_reference as j_ffbs_reference
from hhmm_tpu.kernels.vg import forward_value_and_grad as j_fvg
from hhmm_tpu_torch.kernels import cuda_semiring as cs
from hhmm_tpu_torch.kernels import dispatch as td
from hhmm_tpu_torch.kernels import forward_value_and_grad

RTOL, ATOL = 1e-6, 1e-5
B, T = 5, 48


def _batch(seed, gated=False):
    """f32 inputs at K = 1: log pi and log A 0 (the only normalised
    values), N(-1, 1) emissions, masks with a ragged tail and a masked
    first step on one series; gated: 0/1 gate keys against state key 1."""
    rng = np.random.default_rng(seed)
    mask = (np.arange(T)[None, :] < rng.integers(T // 2, T + 1, size=B)[:, None])
    mask[0, 0] = False
    d = {
        "log_pi": np.zeros((B, 1)),
        "log_A": np.zeros((B, 1, 1)),
        "log_obs": rng.normal(size=(B, T, 1)) - 1.0,
        "mask": mask.astype(np.float64),
    }
    if gated:
        d["gate_key"] = rng.integers(0, 2, size=(B, T)).astype(np.float64)
        d["state_key"] = np.ones((B, 1))
    return {k: v.astype(np.float32) for k, v in d.items()}


def _t(d, keys=("log_pi", "log_A", "log_obs", "mask")):
    return [torch.from_numpy(d[k]) for k in keys]


def _j(d, keys=("log_pi", "log_A", "log_obs", "mask")):
    return [jnp.asarray(d[k]) for k in keys]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_filter_and_smooth_match_jax(seed):
    d = _batch(seed)
    la, ll = td.forward_filter_dispatch(*_t(d))
    jla, jll = jax.vmap(jd.forward_filter_dispatch)(*_j(d))
    _close(la, jla)
    _close(ll, jll)
    # the one-state filter is the running sum of the valid steps' emissions
    want = np.cumsum(d["log_obs"][..., 0] * d["mask"], axis=1)
    np.testing.assert_allclose(ll.numpy(), want[:, -1], rtol=RTOL, atol=ATOL)
    lb = td.backward_dispatch(*_t(d)[1:])
    _close(lb, jax.vmap(jd.backward_dispatch)(*_j(d)[1:]))
    _, _, lg, _ = td.smooth_dispatch(*_t(d))
    assert torch.equal(lg, torch.zeros_like(lg))


@pytest.mark.parametrize("seed", [0, 1])
def test_viterbi_matches_jax(seed):
    d = _batch(seed)
    path, score = td.viterbi_dispatch(*_t(d))
    jpath, jscore = jax.vmap(jd.viterbi_dispatch)(*_j(d))
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    assert int(path.abs().sum()) == 0
    _close(score, jscore)


@pytest.mark.parametrize("gated", [False, True])
def test_ffbs_matches_jax_reference(gated):
    d = _batch(2, gated)
    u = np.random.default_rng(3).random((B, T)).astype(np.float32)
    keys = ("log_pi", "log_A", "log_obs", "mask") + (("gate_key", "state_key") if gated else ())
    z, ll = cs.semiring_ffbs(*_t(d, keys[:4]), u=torch.from_numpy(u),
                             **({"gate_key": _t(d, keys[4:5])[0],
                                 "state_key": _t(d, keys[5:])[0]} if gated else {}))
    jz, jll = jax.vmap(j_ffbs_reference)(*_j(d, keys[:4]), jnp.asarray(u), *_j(d, keys[4:]))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    assert int(z.abs().sum()) == 0
    _close(ll, jll)


@pytest.mark.parametrize("gated", [False, True])
def test_value_and_grad_matches_jax(gated):
    d = _batch(4, gated)
    keys = ("log_pi", "log_A", "log_obs", "mask") + (("gate_key", "state_key") if gated else ())
    out = forward_value_and_grad(*_t(d, keys))
    ref = jax.vmap(j_fvg)(*_j(d, keys))
    for got, want in zip(out, ref):
        _close(got, want)
    # one state: d_obs is the mask and d_pi is 1
    ll, d_pi, d_A, d_obs = out
    np.testing.assert_allclose(d_obs.numpy()[..., 0], d["mask"], atol=ATOL)
    np.testing.assert_allclose(d_pi.numpy(), 1.0, atol=ATOL)


def test_plain_versions_on_the_lane_layout_at_k_1():
    """Every plain version at K = 1 on the lane layout: the filters agree
    bitwise (no clamp or guard binds on finite inputs), maps are all
    zero, and ``BETA`` is the suffix sum of the valid emissions."""
    d = _batch(5)
    pi_t, A_t, obs_t, mask_t, _, _ = cs.to_lanes(*_t(d))
    ll, alpha = cs.fwd_plain(pi_t, A_t, obs_t, mask_t)
    fll, falpha = cs.filter_plain(pi_t, A_t, obs_t, mask_t)
    assert torch.equal(ll, fll) and torch.equal(alpha, falpha)
    score, dlast, back = cs.viterbi_plain(pi_t, A_t, obs_t, mask_t)
    # the max-plus pass has no mask case at t = 0 (series 0 masks its first step)
    want = ll + (mask_t[0] <= 0).to(ll.dtype) * obs_t[0, 0]
    np.testing.assert_allclose(score.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    assert int(back.abs().sum()) == 0
    assert int(cs.backtrack_plain(back, dlast).abs().sum()) == 0
    beta = cs.beta_plain(A_t, obs_t, mask_t)
    x = (obs_t[:, 0] * mask_t).numpy()
    want = np.concatenate([np.cumsum(x[::-1], 0)[::-1][1:], np.zeros((1, B))])
    np.testing.assert_allclose(beta[:, 0].numpy(), want, rtol=RTOL, atol=ATOL)
