"""Tayal (2009) HHMM→HMM reduction (counterpart of
``hhmm_tpu/models/tayal.py``): the 2-top-state, 4-production-state HHMM
expanded to a sparse K=4 HMM with 3 free transition parameters and L=9
zig-zag symbols per state.

- initial: π = [π₁, 0, 1−π₁, 0]
- transitions (0-indexed): A[0,1]=a01, A[0,2]=1−a01, A[1,0]=1,
  A[2,0]=a20, A[2,3]=1−a20, A[3,2]=1
- observations (x ∈ 0..8, sign ∈ {0=up, 1=down}); states {1,2} emit up
  legs, {0,3} down legs.

``gate_mode="stan"`` is the reference's soft sign gate (the transition
factor applies only on sign-consistent destinations, and π only on the
sign-matching entry state); ``"hard"`` forbids inconsistent destinations
outright (``MASK_NEG`` emissions). See the JAX module for when each
applies.

Everything is batch-native: parameters carry leading lane axes and data
arrays are ``[..., T]`` whose leading axes are a prefix of them (``[B,
T]`` data against ``[B, C]`` chains, say; ``models/base.py::
broadcast_data`` aligns them).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from hhmm_tpu_torch._device import DeviceLike
from hhmm_tpu_torch.core.bijectors import Bijector, Simplex, UnitInterval
from hhmm_tpu_torch.core.lmath import MASK_NEG, safe_log
from hhmm_tpu_torch.infer.gibbs import beta, dirichlet, emission_counts, transition_counts
from hhmm_tpu_torch.kernels.alpha_fused import forward_alpha
from hhmm_tpu_torch.kernels.assoc import forward_filter_assoc
from hhmm_tpu_torch.kernels.dispatch import use_assoc, viterbi_dispatch
from hhmm_tpu_torch.models.base import BaseHMMModel, Params, draw_lanes, broadcast_data

__all__ = ["TayalHHMM", "TayalHHMMLite", "UP", "DOWN"]

UP, DOWN = 0, 1
# 0-indexed state sign groups: states {1,2} emit up legs, {0,3} down legs
_UP_STATES = (False, True, True, False)
# entry states receiving the pi factor at t=0
_ENTRY_UP, _ENTRY_DOWN = 2, 0


class _Emissions(torch.autograd.Function):
    """``log_obs[..., t, k] = log_phi[..., k, x_t]`` (a gather), with a
    backward that sums the gradient over t per symbol as plain
    reductions. The gather's own backward scatters with atomic adds on
    CUDA, whose order changes from run to run, and the HMC sampler turns
    those last-bit differences into different chains; this backward
    gives the same bits on every run."""

    @staticmethod
    def forward(ctx, log_phi, x):  # [..., K, L], [..., T] int64
        ctx.save_for_backward(x)
        ctx.L = log_phi.shape[-1]
        idx = x[..., None, :].expand(log_phi.shape[:-1] + x.shape[-1:])
        return torch.gather(log_phi, -1, idx).transpose(-1, -2)

    @staticmethod
    def backward(ctx, g):  # [..., T, K]
        (x,) = ctx.saved_tensors
        zero = g.new_zeros(())
        cols = [torch.where((x == l)[..., None], g, zero).sum(-2) for l in range(ctx.L)]
        return torch.stack(cols, dim=-1), None


class TayalHHMM(BaseHMMModel):
    K = 4
    # gibbs_update implements both gates
    gibbs_gate_modes = ("hard", "stan")

    def __init__(self, L: int = 9, gate_mode: str = "stan"):
        if gate_mode not in ("stan", "hard"):
            raise ValueError("gate_mode must be 'stan' or 'hard'")
        self.L = L
        self.gate_mode = gate_mode

    def specs(self) -> List[Tuple[str, Bijector]]:
        return [
            ("p_11", UnitInterval(())),
            ("A_row", Simplex((2, 2))),
            ("phi_k", Simplex((self.K, self.L))),
        ]

    def assemble(self, params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sparse ``(π [..., 4], A [..., 4, 4])`` from the 3 free
        parameters."""
        p11 = params["p_11"]
        Ar = params["A_row"]
        zero = torch.zeros_like(p11)
        pi = torch.stack([p11, zero, 1.0 - p11, zero], dim=-1)
        A = torch.zeros(p11.shape + (4, 4), dtype=p11.dtype, device=p11.device)
        A[..., 0, 1] = Ar[..., 0, 0]
        A[..., 0, 2] = Ar[..., 0, 1]
        A[..., 1, 0] = 1.0
        A[..., 2, 0] = Ar[..., 1, 0]
        A[..., 2, 3] = Ar[..., 1, 1]
        A[..., 3, 2] = 1.0
        return pi, A

    @staticmethod
    def _consistency(sign: torch.Tensor) -> torch.Tensor:
        """``[..., T, K]`` destination sign-consistency — the one source
        of the gate for the build and the Gibbs count weights."""
        up = torch.tensor(_UP_STATES, device=sign.device)
        return torch.where(sign[..., None] == UP, up, ~up)

    def _terms(self, params: Params, x: torch.Tensor, sign: torch.Tensor):
        pi, A = self.assemble(params)
        log_phi = safe_log(params["phi_k"])  # [..., K, L]
        log_obs = _Emissions.apply(log_phi, x.long())  # [..., T, K]
        return pi, A, log_obs, self._consistency(sign.long())

    @staticmethod
    def _stan_pi(pi: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
        """Stan-parity t=0 factor: log π only on the sign-matching entry
        state; unit factor elsewhere."""
        entry = torch.where(sign[..., 0] == UP, _ENTRY_UP, _ENTRY_DOWN)
        states = torch.arange(4, device=pi.device)
        return torch.where(states == entry[..., None], safe_log(pi), 0.0)

    @staticmethod
    def _aligned(params: Params, data: Dict[str, torch.Tensor]):
        """``x``, ``sign`` and ``mask`` (or None) aligned to the
        parameters' lane axes."""
        lead = tuple(params["p_11"].shape)
        return tuple(broadcast_data(data.get(k), lead) for k in ("x", "sign", "mask"))

    def _gated(self, params: Params, x: torch.Tensor, sign: torch.Tensor):
        """``(log_pi, log_A[_t], log_obs)`` with the selected gate."""
        x, sign, _ = self._aligned(params, {"x": x, "sign": sign})
        pi, A, log_obs, consistent = self._terms(params, x, sign)
        log_A = safe_log(A)
        if self.gate_mode == "hard":
            return safe_log(pi), log_A, torch.where(consistent, log_obs, MASK_NEG)
        log_A_t = torch.where(consistent[..., 1:, None, :], log_A[..., None, :, :], 0.0)
        return self._stan_pi(pi, sign), log_A_t, log_obs

    def build(self, params: Params, data: Dict[str, torch.Tensor]):
        log_pi, log_A, log_obs = self._gated(params, data["x"], data["sign"])
        return log_pi, log_A, log_obs, self._aligned(params, data)[2]

    def build_vg(self, params: Params, data: Dict[str, torch.Tensor]):
        """Hot-loop build: in stan mode the sign gate is left to the gate
        keys (:meth:`gate_keys`) so ``log_A`` stays homogeneous; only the
        t=0 entry restriction on π is applied here."""
        if self.gate_mode == "hard":
            return self.build(params, data)
        x, sign, mask = self._aligned(params, data)
        pi, A, log_obs, _ = self._terms(params, x, sign)
        return self._stan_pi(pi, sign), safe_log(A), log_obs, mask

    def gate_keys(self, data: Dict[str, torch.Tensor]):
        if self.gate_mode == "hard":
            return None
        sign = data["sign"].to(torch.float32)  # [..., T]: 0=up, 1=down
        state_sign = torch.tensor(
            [float(UP) if up else float(DOWN) for up in _UP_STATES],
            dtype=torch.float32,
            device=sign.device,
        )
        return sign, state_sign.expand(sign.shape[:-1] + (self.K,))

    def gibbs_update(
        self,
        generator: torch.Generator,
        z: torch.Tensor,
        data: Dict[str, torch.Tensor],
        params: Optional[Params] = None,
    ) -> Params:
        """Conjugate parameter block under the model's flat priors: every
        conditional is Beta/Dirichlet.

        ``"hard"``: p_11 | z_1 ~ Beta(1 + 1[z_1=0], 1 + 1[z_1=2]); the
        free transition rows ~ Dir(1 + counts) on their support
        (0 → {1,2}, 2 → {0,3}); phi rows ~ Dir(1 + emission counts).

        ``"stan"``: transition counts are weighted by destination sign
        consistency (an inconsistent step carries a unit factor and no
        information about A); p_11 ~ Beta(1 + 1[sign_0=down, z_0=0],
        1 + 1[sign_0=up, z_0=2])."""
        x = data["x"].long()
        mask = data.get("mask")
        z0 = z[..., 0]
        if self.gate_mode == "hard":
            w_trans = mask
            p11_a = 1.0 + (z0 == 0).to(torch.float32)
            p11_b = 1.0 + (z0 == 2).to(torch.float32)
        else:
            sign = data["sign"].long()
            cons = self._consistency(sign).gather(-1, z[..., None])[..., 0].to(torch.float32)
            w_trans = cons if mask is None else mask * cons
            p11_a = 1.0 + ((sign[..., 0] == DOWN) & (z0 == _ENTRY_DOWN)).to(torch.float32)
            p11_b = 1.0 + ((sign[..., 0] == UP) & (z0 == _ENTRY_UP)).to(torch.float32)
        n = transition_counts(z, self.K, w_trans)
        c_emis = emission_counts(z, x, self.K, self.L, mask)
        a0 = dirichlet(generator, 1.0 + torch.stack([n[..., 0, 1], n[..., 0, 2]], dim=-1))
        a2 = dirichlet(generator, 1.0 + torch.stack([n[..., 2, 0], n[..., 2, 3]], dim=-1))
        return {
            "p_11": beta(generator, p11_a, p11_b),
            "A_row": torch.stack([a0, a2], dim=-2),
            "phi_k": dirichlet(generator, 1.0 + c_emis),
        }

    def init_unconstrained(
        self, generator: torch.Generator, data: Dict[str, torch.Tensor]
    ) -> torch.Tensor:
        """Informed chain init for one series (``x``, ``sign`` ``[T]``):
        phi rows start at the empirical symbol frequencies of same-sign
        legs, mixed 0.7/0.3 with a Dirichlet(20) jitter; p_11 and the
        free transition rows start at 1/2. Returns ``theta [n_free]`` on
        the generator's device."""
        dev = generator.device
        x = torch.as_tensor(data["x"], device=dev).long()
        sign = torch.as_tensor(data["sign"], device=dev).long()
        L = self.L

        def freq(sel):
            f = torch.bincount(x[sel], minlength=L).to(torch.float32) + 1.0
            return f / f.sum()

        f_up, f_dn = freq(sign == UP), freq(sign == DOWN)
        phi = torch.stack([f_dn, f_up, f_up, f_dn])
        noise = dirichlet(generator, torch.full((4, L), 20.0, device=dev))
        phi = 0.7 * phi + 0.3 * noise
        params = {
            "p_11": torch.tensor(0.5, device=dev),
            "A_row": torch.full((2, 2), 0.5, device=dev),
            "phi_k": phi / phi.sum(1, keepdim=True),
        }
        return self.pack(params)


class TayalHHMMLite(TayalHHMM):
    """Same training posterior; generated quantities run filtering on
    the in-sample window and filtering + Viterbi on a held-out OOS
    segment restarted from π. ``data`` carries ``x``, ``sign`` and
    ``x_oos``, ``sign_oos`` (optionally ``mask``, ``mask_oos``)."""

    def seg_alpha_assoc(self, T: int, time_parallel, device_type: str) -> bool:
        """Whether a segment of ``T`` steps is filtered by the time-parallel
        scans: ``time_parallel`` resolved for the filter; ``"auto"`` on
        the card keeps ``forward_alpha``, as ``"auto"`` on the TPU keeps
        the fused forward in the JAX package."""
        if time_parallel == "auto" and device_type == "cuda":
            time_parallel = "cuda"
        return use_assoc(self.K, T, time_parallel, device_type)

    def _seg_alpha(self, params: Params, x, sign, mask, time_parallel="auto"):
        """Filtered log-alpha for one segment through the hot-loop
        contract (build_vg + gate_keys): one ``FWD`` kernel launch over
        every lane on the card; where :meth:`seg_alpha_assoc` says so, the
        associative filter on the materialised gate (:meth:`_gated`,
        ``[..., T-1, K, K]`` in the stan gate)."""
        if self.seg_alpha_assoc(int(x.shape[-1]), time_parallel, x.device.type):
            log_pi, log_A, log_obs = self._gated(params, x, sign)
            return forward_filter_assoc(log_pi, log_A, log_obs, mask)[0]
        seg = {"x": x, "sign": sign}
        log_pi, log_A, log_obs, _ = self.build_vg(params, seg)
        gk = self.gate_keys(seg)
        la, _ = forward_alpha(log_pi, log_A, log_obs, mask, *(gk if gk is not None else ()))
        return la

    def _filtered(self, params: Params, lanes: Dict[str, torch.Tensor], time_parallel="auto"):
        """Softmax-normalized filtered probabilities of both segments, one
        ``FWD`` launch each."""
        log_alpha = self._seg_alpha(
            params, lanes["x"], lanes["sign"], lanes.get("mask"), time_parallel
        )
        log_alpha_o = self._seg_alpha(
            params, lanes["x_oos"], lanes["sign_oos"], lanes.get("mask_oos"), time_parallel
        )
        return {
            "alpha": torch.softmax(log_alpha, dim=-1),
            "alpha_oos": torch.softmax(log_alpha_o, dim=-1),
        }

    def filtered(
        self,
        theta_draws: torch.Tensor,
        data: Dict[str, torch.Tensor],
        device: DeviceLike = None,
        time_parallel="auto",
    ) -> Dict[str, torch.Tensor]:
        """``alpha`` and ``alpha_oos`` of :meth:`generated` without the OOS
        Viterbi path: what the walk-forward median-alpha decode reads."""
        lead, flat, lanes = draw_lanes(theta_draws, data, device)
        params, _ = self.unpack(flat)
        out = self._filtered(params, lanes, time_parallel)
        return {k: v.reshape(lead + v.shape[1:]) for k, v in out.items()}

    def generated(
        self,
        theta_draws: torch.Tensor,
        data: Dict[str, torch.Tensor],
        device: DeviceLike = None,
        time_parallel="auto",
    ) -> Dict[str, torch.Tensor]:
        """Per-draw ``alpha [..., T, K]``, ``alpha_oos [..., T_oos, K]``
        (softmax-normalized filtered probabilities) and ``zstar_oos
        [..., T_oos]`` (the OOS Viterbi path) for ``theta_draws [...,
        n_free]``. Data arrays are ``[T]`` (one series, every draw) or
        ``[B, T]`` with ``theta_draws [B, ..., n_free]``.
        ``time_parallel`` routes both filters (:meth:`_seg_alpha`) and
        the Viterbi pass (``kernels/dispatch.py``: the stan gate's
        time-varying operators take the scans, ``seq`` by default)."""
        lead, flat, lanes = draw_lanes(theta_draws, data, device)
        params, _ = self.unpack(flat)
        out = self._filtered(params, lanes, time_parallel)
        log_pi_o, log_A_o, log_obs_o = self._gated(params, lanes["x_oos"], lanes["sign_oos"])
        out["zstar_oos"], _ = viterbi_dispatch(
            log_pi_o, log_A_o, log_obs_o, lanes.get("mask_oos"), time_parallel=time_parallel
        )
        return {k: v.reshape(lead + v.shape[1:]) for k, v in out.items()}
