"""Multinomial-emission HMMs (counterpart of
``hhmm_tpu/models/multinomial_hmm.py``), the behaviour of
`hmm/stan/hmm-multinom.stan` and `hmm/stan/hmm-multinom-semisup.stan`.

Discrete emissions: ``simplex[L] phi_k[K]`` per state, observations x in
0..L-1, flat priors; the target is the marginalized forward
log-likelihood.

The semi-supervised variant takes an observed group label ``g[t]`` per
step and a state → group map ``groups`` (the reference's K=4 config is
``(0, 1, 1, 0)``). ``gate_mode="stan"`` (the default) is the reference:
an inconsistent destination keeps its emission term with a unit
transition factor (a time-varying ``log_A`` from :meth:`build`; in the
hot loop the gate keys ``(g, groups)`` let the gated kernels apply it to
a homogeneous ``log_A``: their gate is an equality test, so labels 0/1
work as the Tayal model's signs do). ``gate_mode="hard"`` forbids
inconsistent destinations outright (``MASK_NEG`` on the emissions).

Batch-native: parameters carry leading lane axes, data ``x``, ``g``
``[..., T]`` a prefix of them (``models/base.py::broadcast_data``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hhmm_tpu_torch.core.bijectors import Bijector, Simplex
from hhmm_tpu_torch.core.lmath import safe_log
from hhmm_tpu_torch.infer.gibbs import dirichlet, emission_counts, transition_counts
from hhmm_tpu_torch.models.base import BaseHMMModel, Params, broadcast_data, semisup_gate
from hhmm_tpu_torch.models.tayal import _Emissions

__all__ = ["MultinomialHMM", "SemisupMultinomialHMM"]


class MultinomialHMM(BaseHMMModel):
    def __init__(self, K: int, L: int):
        self.K = K
        self.L = L

    def specs(self) -> List[Tuple[str, Bijector]]:
        K, L = self.K, self.L
        return [
            ("p_1k", Simplex((K,))),
            ("A_ij", Simplex((K, K))),
            ("phi_k", Simplex((K, L))),
        ]

    def _aligned(self, params: Params, data: Dict[str, torch.Tensor], key: str):
        lead = tuple(params["p_1k"].shape[:-1])
        return broadcast_data(data.get(key), lead)

    def _emissions(self, params: Params, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``log_obs[..., t, k] = log phi[..., k, x_t]`` (a gather with a
        run-to-run deterministic backward, ``models/tayal.py``)."""
        x = self._aligned(params, data, "x").long()
        return _Emissions.apply(safe_log(params["phi_k"]), x)

    def build(self, params: Params, data: Dict[str, torch.Tensor]):
        return (
            safe_log(params["p_1k"]),
            safe_log(params["A_ij"]),
            self._emissions(params, data),
            self._aligned(params, data, "mask"),
        )

    def gibbs_update(
        self,
        generator: torch.Generator,
        z: torch.Tensor,
        data: Dict[str, torch.Tensor],
        params: Optional[Params] = None,
        trans_weight: Optional[torch.Tensor] = None,
    ) -> Params:
        """Conjugate parameter block under the flat Dirichlet(1) priors:
        p_1k | z ~ Dir(1 + 1[z_1]), A rows ~ Dir(1 + transition counts),
        phi rows ~ Dir(1 + emission counts). ``trans_weight``: optional
        ``[..., T]`` weight of each step's transition count (default the
        mask), the hook of the gated subclass."""
        x = data["x"].long()
        mask = data.get("mask")
        if trans_weight is None:
            trans_weight = mask
        n_trans = transition_counts(z, self.K, trans_weight)
        c_emis = emission_counts(z, x, self.K, self.L, mask)
        first = torch.nn.functional.one_hot(z[..., 0], self.K).to(torch.float32)
        return {
            "p_1k": dirichlet(generator, 1.0 + first),
            "A_ij": dirichlet(generator, 1.0 + n_trans),
            "phi_k": dirichlet(generator, 1.0 + c_emis),
        }


class SemisupMultinomialHMM(MultinomialHMM):
    """Observed group evidence ``g[t]`` gating the transition term;
    ``groups``: length-K state → group map."""

    # both gates are conjugate (see gibbs_update)
    gibbs_gate_modes = ("hard", "stan")

    def __init__(self, K: int, L: int, groups, gate_mode: str = "stan"):
        super().__init__(K, L)
        self.groups = np.asarray(groups, dtype=np.int32)
        if self.groups.shape != (K,):
            raise ValueError(f"groups must have shape ({K},)")
        if gate_mode not in ("stan", "hard"):
            raise ValueError("gate_mode must be 'stan' or 'hard'")
        self.gate_mode = gate_mode

    def _consistency(self, g: torch.Tensor) -> torch.Tensor:
        """``[..., T, K]`` destination group consistency, the one source
        of the gate for the build and the Gibbs count weights."""
        groups = torch.as_tensor(self.groups, device=g.device)
        return g.long()[..., None] == groups

    def build(self, params: Params, data: Dict[str, torch.Tensor]):
        """The reference's terms: π ungated (`hmm-multinom-semisup.stan:
        33-35`), the transition factor for t >= 1 gated (`:42-44`)."""
        log_pi, log_A, log_obs, mask = MultinomialHMM.build(self, params, data)
        consistent = self._consistency(self._aligned(params, data, "g"))
        return (*semisup_gate(log_pi, log_A, log_obs, consistent, self.gate_mode), mask)

    def build_vg(self, params: Params, data: Dict[str, torch.Tensor]):
        """Hot-loop build: in stan mode the ungated homogeneous terms (the
        gate keys carry the gate); in hard mode :meth:`build`."""
        if self.gate_mode == "hard":
            return self.build(params, data)
        return MultinomialHMM.build(self, params, data)

    def gate_keys(self, data: Dict[str, torch.Tensor]):
        if self.gate_mode == "hard":
            return None
        g = data["g"].to(torch.float32)  # [..., T] observed group labels
        groups = torch.as_tensor(self.groups, dtype=torch.float32, device=g.device)
        return g, groups.expand(g.shape[:-1] + (self.K,))

    def gibbs_update(
        self,
        generator: torch.Generator,
        z: torch.Tensor,
        data: Dict[str, torch.Tensor],
        params: Optional[Params] = None,
    ) -> Params:
        """Conjugate block under either gate. Hard: an exact HMM, the
        inherited counts. Stan: the pairwise factor is ``A(z_{t-1},
        z_t)^{1[z_t group-consistent at t]}``, so each transition count is
        weighted by its destination's consistency; p_1k (ungated in the
        reference) and the emissions keep the standard conditionals."""
        if self.gate_mode == "hard":
            return super().gibbs_update(generator, z, data, params)
        mask = data.get("mask")
        cons = self._consistency(data["g"]).gather(-1, z[..., None])[..., 0].to(torch.float32)
        w_trans = cons if mask is None else mask * cons
        return super().gibbs_update(generator, z, data, params, trans_weight=w_trans)
