"""The port's K range above 16 — every semiring plain version and the
zoo entries at K in {17, 24, 33, 64, 128} (T <= 32, two series from
K = 33) — against the JAX package on the same numpy inputs (the
helpers and tolerances of ``tests/test_torch_decode.py``):

- ``semiring_filter`` / ``semiring_beta`` / ``semiring_viterbi`` (and the
  decode dispatch's Viterbi) against the JAX ``semiring_*`` entries in
  interpret mode: log-values within rtol 1e-6 + atol 1e-5, -inf at the
  same places, paths and scores identical;
- ``GaussianHMM(K).generated`` at K in {24, 33, 64, 128} against the JAX
  ``generated`` on its pallas and seq routes (zstar identical, loglik
  within rtol 1e-5, probabilities within 7e-5, 5e-4 from K = 33, and no
  farther from the float64 oracle than 1.5 times the JAX package's
  distance);
- ``state_draws`` against the JAX FFBS reference on the JAX model's
  terms and the same uniforms, draw for draw;
- ``semiring_ffbs`` draw for draw against the JAX ``semiring_ffbs``
  (interpret mode) and ``ffbs_invcdf_reference``, given the same
  uniforms, redrawn off the inverse-CDF edges
  (``tests/test_torch_kernels.py``'s helper).

``forward_value_and_grad`` at these K is in ``tests/test_torch_vg.py``,
the Viterbi plain version against ``tests/oracle.py`` up to K = 128 in
``tests/test_torch_decode.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import _lane_uniforms_off_edges
from test_torch_decode import (
    LL_RTOL,
    _case,
    _check_generated_gaussian_k,
    _series,
    _t,
    check_plain_versions_match_jax,
    check_state_draws_gaussian_k,
)

from hhmm_tpu.kernels.ffbs import ffbs_invcdf_reference as j_ffbs_reference
from hhmm_tpu.kernels.pallas_semiring import semiring_ffbs as j_semiring_ffbs
from hhmm_tpu_torch.kernels import cuda_semiring as cs

torch.set_num_threads(1)

KS = [17, 24, 33, 64, 128]


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("case", ["sparse", "ties"])
def test_plain_versions_match_jax(rng, K, case):
    check_plain_versions_match_jax(rng, K, case)


@pytest.mark.parametrize("K", [24, 33, 64, 128])
@pytest.mark.parametrize("route", ["pallas", "seq"])
def test_generated_gaussian_matches_jax(rng, K, route):
    _check_generated_gaussian_k(rng, K, route)


@pytest.mark.parametrize("K", KS)
def test_state_draws_gaussian_match_jax_ffbs(rng, K):
    check_state_draws_gaussian_k(rng, K)


@pytest.mark.parametrize("K", KS)
def test_ffbs_draw_for_draw_matches_jax(rng, K):
    """``semiring_ffbs`` (the FFBS plain versions) against the JAX
    ``semiring_ffbs`` in interpret mode and the JAX
    ``ffbs_invcdf_reference``, given the same uniforms (redrawn off the
    inverse-CDF edges): every draw identical, loglik within ``LL_RTOL``;
    ragged masks, so the padded tail repeats the last valid state."""
    B, T = _series(K), 24
    args = _case(rng, B, T, K)
    log_pi, log_A, log_obs, mask = _t(args)
    pi_t, A_t, obs_t, mask_t, _, _ = cs.to_lanes(log_pi, log_A.clamp_min(-1e30), log_obs, mask)
    _, alpha_t = cs.fwd_plain(pi_t, A_t, obs_t, mask_t)
    u = _lane_uniforms_off_edges(rng, A_t, mask_t, alpha_t, None, None).t().contiguous().numpy()
    z, ll = cs.semiring_ffbs(*_t(args), torch.from_numpy(u))
    jz, jll = j_semiring_ffbs(*(jnp.asarray(a) for a in args), jnp.asarray(u), interpret=True)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=LL_RTOL)
    for b in range(B):
        rz, rll = j_ffbs_reference(*(jnp.asarray(a[b]) for a in args), jnp.asarray(u[b]))
        np.testing.assert_array_equal(z[b].numpy(), np.asarray(rz))
        np.testing.assert_allclose(float(ll[b]), float(rll), rtol=LL_RTOL)
