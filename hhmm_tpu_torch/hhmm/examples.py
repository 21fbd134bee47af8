"""Example HHMM trees — the reference's structure test-beds (the port's
copy of ``hhmm_tpu/hhmm/examples.py``).

- :func:`hmix_tree` — flat 2-component Gaussian mixture, the smallest
  tree exercising the engine (`hhmm/sim-hmix.R:4-49`).
- :func:`fine1998_tree` — the 4-level HHMM of Fine, Singer & Tishby
  (1998) Fig. 1 (`hhmm/sim-fine1998.R:4-153`).
- :func:`tayal_tree` — Tayal (2009) bull/bear 2×2 tree whose compiled
  flat form must equal the hand-derived sparse K=4 HMM of
  `tayal2009/main.Rmd:306-345` (pinned by ``tests/test_torch_hhmm.py``
  against :class:`~hhmm_tpu_torch.models.TayalHHMM`).
- :func:`jangmin2004_tree` — Jangmin O et al. (2004) 5-top-state market
  model: 5 regimes × (up to 5) mixture components × 3-production-leaf
  strings, 63 Gaussian leaves on a depth-5 tree
  (`hhmm/sim-jangmin2004.R:21-1866`).

The reference's matrices are written row-stochastic (``byrow = TRUE``)
and we read them that way; see the convention note in
:mod:`hhmm_tpu_torch.hhmm.structure` about the reference's column-sampling
defect, which we do not replicate.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from hhmm_tpu_torch.hhmm.structure import End, Internal, Production, finalize

__all__ = [
    "hmix_tree",
    "hier2x2_tree",
    "fine1998_tree",
    "tayal_tree",
    "jangmin2004_tree",
]


def _g(mu: float, sigma: float, name: str = "") -> Production:
    return Production(obs=("gaussian", {"mu": mu, "sigma": sigma}), name=name)


def hmix_tree() -> Internal:
    """2-component Gaussian mixture as a depth-3 tree
    (`hhmm/sim-hmix.R:4-45`: components N(5,1), N(-5,1); sticky 0.9
    self-transitions with 0.1 advance/exit)."""
    comp = Internal(
        name="q21",
        pi=[0.5, 0.5, 0.0],
        A=[[0.9, 0.1, 0.0], [0.0, 0.9, 0.1], [0.0, 0.0, 1.0]],
        children=[_g(5.0, 1.0, "q31"), _g(-5.0, 1.0, "q32"), End("q3e")],
    )
    root = Internal(
        name="root",
        pi=[1.0, 0.0],
        A=[[0.0, 1.0], [0.0, 1.0]],
        children=[comp, End("q2e")],
    )
    return finalize(root)


def hier2x2_tree() -> Internal:
    """2×2 hierarchical Gaussian mixture — the structure of the
    `hhmm/main.R:17-91` example: two sticky regimes, each a 2-component
    Gaussian mixture; a regime runs its mixture until the End exit
    fires, then the root alternates regimes. Means are separated by
    regime (negative vs positive) with overlap between components."""

    def regime(mus: Tuple[float, float], name: str) -> Internal:
        return Internal(
            name=name,
            pi=[0.5, 0.5, 0.0],
            A=[[0.80, 0.10, 0.10], [0.10, 0.80, 0.10], [0.0, 0.0, 1.0]],
            children=[_g(mus[0], 0.6, f"{name}_a"), _g(mus[1], 0.6, f"{name}_b"), End()],
        )

    root = Internal(
        name="root",
        pi=[0.5, 0.5],
        A=[[0.2, 0.8], [0.8, 0.2]],
        children=[regime((-3.0, -1.0), "lo"), regime((1.0, 3.0), "hi")],
    )
    return finalize(root)


def fine1998_tree() -> Internal:
    """Fine (1998) Fig. 1 structure (`hhmm/sim-fine1998.R`): root with
    two depth-2 states; the second expands through depth-3/4 internal
    states down to single-production strings. Leaf means encode their
    tree position (21, 32, 41, 42, 43)."""

    def string(mu: float, name: str) -> Internal:
        return Internal(
            name=f"q{name}",
            pi=[1.0, 0.0],
            A=[[0.0, 1.0], [0.0, 1.0]],
            children=[_g(mu, 1.0, f"p{name}"), End(f"p{name}e")],
        )

    q31 = Internal(
        name="q31",
        pi=[0.5, 0.3, 0.2, 0.0],
        A=[
            [0.0, 0.6, 0.4, 0.0],
            [0.0, 0.0, 0.8, 0.2],
            [0.0, 0.0, 0.0, 1.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        children=[string(41.0, "41"), string(42.0, "42"), string(43.0, "43"), End("q4e")],
    )
    q22 = Internal(
        name="q22",
        pi=[0.9, 0.1, 0.0],
        A=[[0.0, 1.0, 0.0], [0.0, 0.7, 0.3], [0.0, 0.0, 1.0]],
        children=[q31, string(32.0, "32"), End("q3e")],
    )
    root = Internal(
        name="root",
        pi=[0.5, 0.5, 0.0],
        A=[[0.0, 1.0, 0.0], [0.7, 0.0, 0.3], [0.0, 0.0, 1.0]],
        children=[string(21.0, "21"), q22, End("q2e")],
    )
    return finalize(root)


def tayal_tree(p_bear: float, a_bear: float, a_bull: float, phi: np.ndarray) -> Internal:
    """Tayal (2009) bull/bear tree. Each top state alternates an entry
    leg (down for bear, up for bull) with its opposite; leaving the top
    state happens from the entry leg and lands on the other regime's
    entry leg (`tayal2009/main.Rmd:306-345`).

    ``phi`` is [4, L]: per-leaf symbol emission rows in flat-state order
    (bear-down, bear-up, bull-up, bull-down). ``a_bear`` is
    P(bear-down → bear-up) (the flat A[0,1]); ``a_bull`` is
    P(bull-up → bull-down) (the flat A[2,3])."""

    def _c(row, name):
        return Production(obs=("categorical", {"phi": np.asarray(row)}), name=name)

    bear = Internal(
        name="bear",
        pi=[1.0, 0.0, 0.0],
        A=[[0.0, a_bear, 1.0 - a_bear], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
        children=[_c(phi[0], "bear_down"), _c(phi[1], "bear_up"), End("bear_end")],
    )
    bull = Internal(
        name="bull",
        pi=[1.0, 0.0, 0.0],
        A=[[0.0, a_bull, 1.0 - a_bull], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
        children=[_c(phi[2], "bull_up"), _c(phi[3], "bull_down"), End("bull_end")],
    )
    root = Internal(
        name="root",
        pi=[p_bear, 1.0 - p_bear],
        A=[[0.0, 1.0], [1.0, 0.0]],
        children=[bear, bull],
    )
    return finalize(root)


# (mu, sigma) per production leaf, before the global 0.2·mu / 1.5·sigma
# scaling — transcribed from `hhmm/sim-jangmin2004.R` (leaves at :72-352,
# :509-789, :946-1226, :1383-1663, :1807-1839; states are the README's
# strong-bear / weak-bear / random / weak-bull / strong-bull regimes).
_JANGMIN_SPEC: List[List[List[Tuple[float, float]]]] = [
    [  # strong bear
        [(0.00, 0.01), (0.00, 0.01), (0.00, 0.01)],
        [(-0.03, 0.02), (-0.04, 0.02), (-0.02, 0.02)],
        [(0.03, 0.02), (0.04, 0.02), (0.02, 0.02)],
        [(-0.05, 0.02), (-0.04, 0.02), (-0.06, 0.02)],
        [(-0.01, 0.01), (-0.00, 0.01), (-0.02, 0.01)],
    ],
    [  # weak bear
        [(0.02, 0.02), (0.03, 0.02), (0.01, 0.01)],
        [(-0.05, 0.02), (-0.04, 0.02), (-0.06, 0.02)],
        [(0.06, 0.02), (0.07, 0.02), (0.05, 0.02)],
        [(-0.00, 0.02), (-0.00, 0.02), (-0.00, 0.02)],
        [(-0.02, 0.01), (-0.02, 0.02), (-0.02, 0.01)],
    ],
    [  # random walk
        [(0.01, 0.01), (-0.08, 0.02), (-0.02, 0.01)],
        [(-0.07, 0.02), (-0.06, 0.02), (-0.08, 0.02)],
        [(-0.02, 0.02), (-0.02, 0.02), (-0.03, 0.02)],
        [(0.09, 0.03), (0.08, 0.03), (0.08, 0.03)],
        [(0.04, 0.01), (0.04, 0.02), (0.03, 0.01)],
    ],
    [  # weak bull
        [(0.06, 0.02), (0.07, 0.01), (0.06, 0.02)],
        [(0.03, 0.01), (0.02, 0.02), (0.03, 0.01)],
        [(0.02, 0.01), (0.02, 0.02), (0.02, 0.02)],
        [(0.09, 0.03), (0.08, 0.03), (0.09, 0.02)],
        [(-0.02, 0.01), (-0.02, 0.01), (0.01, 0.01)],
    ],
    [  # strong bull
        [(-0.04, 0.03), (0.00, 0.01), (0.04, 0.03)],
    ],
]

_JANGMIN_ROOT_PI = [0.1, 0.1, 0.5, 0.1, 0.2, 0.0]
_JANGMIN_ROOT_A = [
    [0.2, 0.4, 0.4, 0.0, 0.0, 0.0],
    [0.3, 0.2, 0.3, 0.2, 0.0, 0.0],
    [0.2, 0.2, 0.2, 0.2, 0.2, 0.0],
    [0.0, 0.2, 0.4, 0.3, 0.1, 0.0],
    [0.0, 0.0, 0.2, 0.3, 0.5, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
]


def jangmin2004_tree(
    spec: Sequence[Sequence[Sequence[Tuple[float, float]]]] = _JANGMIN_SPEC,
    mu_scale: float = 0.2,
    sigma_scale: float = 1.5,
) -> Internal:
    """Jangmin (2004) market tree. Architecture per state: uniform entry
    over mixture components; a component runs a string of up to three
    single-emission leaves, advancing or exiting with probability 0.5
    after each of the first two (`hhmm/sim-jangmin2004.R:50-104`), then
    exits the regime; regimes switch by the 5×5 top matrix
    (`hhmm/sim-jangmin2004.R:21-31`)."""
    state_names = ["sbear", "wbear", "rwalk", "wbull", "sbull"]
    states: List[Internal] = []
    for s, comps in enumerate(spec):
        comp_nodes: List[Internal] = []
        for c, strings in enumerate(comps):
            n = len(strings)
            string_nodes = [
                Internal(
                    name=f"{state_names[s]}_c{c}_s{k}",
                    pi=[1.0, 0.0],
                    A=[[0.0, 1.0], [0.0, 1.0]],
                    children=[
                        _g(mu_scale * mu, sigma_scale * sigma, f"{state_names[s]}_c{c}_p{k}"),
                        End(),
                    ],
                )
                for k, (mu, sigma) in enumerate(strings)
            ]
            # string k advances to k+1 or exits with prob 0.5; last exits
            A = np.zeros((n + 1, n + 1))
            for k in range(n):
                if k + 1 < n:
                    A[k, k + 1] = 0.5
                    A[k, n] = 0.5
                else:
                    A[k, n] = 1.0
            A[n, n] = 1.0
            pi = np.zeros(n + 1)
            pi[0] = 1.0
            comp_nodes.append(
                Internal(
                    name=f"{state_names[s]}_c{c}",
                    pi=pi,
                    A=A,
                    children=string_nodes + [End()],
                )
            )
        m = len(comp_nodes)
        A_state = np.zeros((m + 1, m + 1))
        A_state[:, m] = 1.0  # every component exits the regime when done
        pi_state = np.concatenate([np.full(m, 1.0 / m), [0.0]])
        states.append(
            Internal(
                name=state_names[s],
                pi=pi_state,
                A=A_state,
                children=comp_nodes + [End()],
            )
        )
    root = Internal(
        name="root",
        pi=_JANGMIN_ROOT_PI,
        A=_JANGMIN_ROOT_A,
        children=states + [End()],
    )
    return finalize(root)
