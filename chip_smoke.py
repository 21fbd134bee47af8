#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, and hold each of
its hand-written CUDA kernels against its plain PyTorch version there.

    python3 chip_smoke.py

Five main paths, each driven with the kernel counts set to 0 just
before it and read just after:

- the batched Tayal Gibbs fit that ``bench.py`` runs by default (256
  simulated zig-zag series, T=1024, K=4, L=9, hard gate, one chain)
  followed by the walk-forward decode (``TayalHHMMLite.generated``,
  stan gate) on thinned draws;
- the batched ChEES-HMC fit of ``bench.py --sampler chees`` (the stan-
  gate ``TayalHHMM`` on the same 256 x T=1024 batch, 2 chains, so 512
  lanes, at most 16 leapfrogs a transition, 150 warmup + 150 sampling
  transitions), every trajectory one launch of the fused trajectory
  kernel; and its unfused form, every leapfrog one value-and-grad call;
- the zoo's generated quantities (``BaseHMMModel.generated``: guarded
  smoothing and Viterbi): the hard-gate Tayal posterior of the Gibbs
  fit and of the ChEES fit, 32 draws x 256 series = 8192 lanes at
  T=1024, the Gaussian HMM of ``hmm/main.R`` (K=3, T=500, 256 series)
  fitted by Gibbs, decoded and path-sampled, the same model with K=5
  and K=12 states (the 12 of ``bench_zoo.py``'s expanded HSMM), and
  with K=20 decoded (a warp a lane, byte-wide Viterbi maps);
- the zoo above K=32: the same model at K=64 (a block a lane, the
  lane's A in shared memory) on 256 series x T=500 — a short Gibbs fit,
  ``state_draws``, ``generated`` and one value-and-grad call, so every
  semiring kernel in its widest layout;
- the Tayal walk-forward back-test (``apps/tayal/wf.py::wf_trade``, the
  reference's test-strategy.R protocol): 34 symbols x 11 days of
  simulated ticks, 5-day train + 1-day trade windows = 204 tasks of
  about 1,000 to 10,000 in-sample legs, through the native zig-zag
  extractor, length-sorted Gibbs fits in 1024-leg buckets (``FWD`` and
  ``BWD_SAMPLE`` once a sweep a group), the batched median-alpha decode
  (``FWD`` twice a dispatch) and the host trading; then its ChEES arm
  (stan gate, 16 of the tasks: ``FWD`` and ``VG_BWD`` once a
  value-and-grad call).

Phases, one JSON object per line:

1. device  — requires CUDA (exits non-zero without it); prints the
   card's ``nvidia-smi`` name and power limit on a line of its own.
2. build   — builds every kernel from ``hhmm_tpu_torch/kernels/csrc``
   with ``nvcc`` (all sources in parallel); ``ptxas`` reports each
   kernel instantiation's registers, spills and static shared memory
   (line ``ptxas``; line ``ptxas_fwd_core``: the forward core of
   ``FWD``, ``FILTER`` and ``VITERBI`` at K=4 and K=16, the last two
   also at K=32; line ``kernel_resources``: each semiring kernel's
   instantiation at K in {4, 16, 32, 64, 128} with its registers,
   spills, static and dynamic shared bytes).
3. kernels — each kernel against its plain version on the card: the
   FFBS pair bitwise (alpha, ll and every draw) at K in {2, 3, 4, 8},
   ungated and gated, at N=256, T=1024 with a ragged tail and at
   (N, T) = (250, 1000), (1, 1024), (256, 1) and (5, 2100) with masked
   runs at both ends, and at every other K in 2..16 at (64, 1024) and
   (3, 2100) (the maps' device scratch); the value-and-grad pair
   (``FWD`` + ``VG_BWD``) bitwise at N=512, K in {3, 4, 8}, and at every
   other K in 2..16 at N=64; the trajectory kernel at the ChEES shape with 2 leapfrogs,
   against its plain version in float64 with 8, against the unfused
   leapfrogs over ``make_lp_bc`` with 8, and at the odd shapes of
   ``TRAJ_ODD_CASES`` (masked runs at both ends, C in {1, 2, 3}, N=1,
   T in {1, 100, 1000, 6500}, the last on the scratch path, n_steps in
   {0, 1, 2, 16, CAP + 4}); then times each at its main-path shape (the
   FFBS pair also on one lane and at N in {1, 256, 512, 2048, 8192}, in
   ns a step; the trajectory at N in {1, 512, 2048}, in ms a leapfrog
   and ns a recursion step).
4. fit     — the Gibbs fit through the kernels; every chain healthy,
   every logp finite, each FFBS kernel launched exactly once per sweep.
5. decode  — ``generated`` on 8 thinned draws x 256 series (in-sample
   T=1024, out-of-sample T=256): the gated forward kernel over 2048
   lanes, compared with its plain version on the card.
6. chees   — the fused ChEES fit: every chain healthy, every logp
   finite, divergent sampling transitions reported with their count,
   the trajectory kernel launched once per transition, the
   value-and-grad kernel once per call of the log density,
   posterior-mean emission rows near the simulator's.
   chees_repeat — the fused fit again: bitwise the same draws; its
   first divergent sampling trajectories replayed on the CPU are
   unstable in float64 too.
   chees_seeds — the fused fit at three more sampler seeds: divergent
   sampling transitions at most ``DIV_SHARE_MAX`` of all over the four
   fits, emission rows near the simulator's in each.
7. chees_unfused — 10 + 10 transitions with no trajectory kernel: the
   value-and-grad kernel launched once per log-density call, which is
   once per leapfrog plus the initial and step-size-probe calls.
8. kernels_decode — ``FILTER``, ``BETA``, ``VITERBI`` and ``BACKTRACK``
   at N=8192, T=1024, K in {3, 4, 8} (every other K in 2..32 at N=256),
   ragged mask, ``MASK_NEG``-sparse A, tie lanes, with and without all
   -inf evidence rows: bitwise equal to their plain versions, ``FILTER``
   bitwise equal to ``FWD`` on finite inputs; then times each at
   N=8192, T=1024, K=4.
   kernels_wide — every semiring kernel bitwise equal to its plain
   version at K in {17, 24, 32, 33, 48, 64, 96, 128} (a warp a lane to
   32, a block a lane above), at (N, T) = (64, 256) and (9, 75): the FFBS
   and value-and-grad kernels ungated and gated with masked runs at both
   ends, the decode kernels on sparse A with tie lanes and -inf evidence
   rows; then each timed at K=64, N=256, T=500.
   decode_smooth — ``TayalHHMM(gate_mode="hard").generated`` on 32
   Gibbs draws x 256 series: shapes, probability rows, each decode
   kernel launched once, every output against the plain versions on
   the same lanes, and (after the path's counts are read) loglik
   identical to ``FWD``'s.
   generated_split — the same call again, warm, its stages timed with
   CUDA events and the host clock by wrapping the functions it calls
   (unpack + ``build``, the lane-layout copies, the four decode
   kernels, the smoothing in the dispatch, the outputs), each wrapped
   function called as often as the path calls it and the outputs
   bitwise the cold call's; beside the cold call's time, and, for both
   calls, the segments and bytes the caching allocator took from the
   device (cudaMalloc) during the call.
   agreement — the ChEES draws through the same decode; the folded
   posterior-mean bull-pair probability against the Gibbs one and the
   Gibbs split-half floor (reported, not gated).
   gaussian — the Gaussian HMM Gibbs fit (FFBS kernels at K=3, once a
   sweep), posterior-mean mu within ``G_MU_TOL``, ``generated`` (each
   decode kernel once, Viterbi accuracy above ``G_ACC_MIN``) and
   ``state_draws`` (one ``FWD`` and one ``BWD_SAMPLE``).
   gaussian_k — the same model at K=5 and K=12 (two map words a step):
   a short Gibbs fit on 256 simulated series (each FFBS kernel once a
   sweep), ``generated`` (each decode kernel once) and ``state_draws``
   (``FWD`` and ``BWD_SAMPLE`` once), every output against the plain
   versions on the same lanes and uniforms.
   decode_wide — ``GaussianHMM(K=20).generated`` on 256 lanes, T=500:
   each decode kernel launched once, every output against the plain
   versions on the same lanes and against the same call on the CPU
   (``WIDE_*`` tolerances).
   zoo_wide — the fourth main path: ``GaussianHMM(K=64)``, 256 series x
   T=500, a 10 + 10 Gibbs fit (``FWD`` and ``BWD_SAMPLE`` once a sweep),
   ``state_draws``, ``generated`` on 2 draws a series (each decode
   kernel once) and one ``forward_value_and_grad`` (``FWD`` and
   ``VG_BWD`` once): every output bitwise equal to the plain versions
   on the card, the decode and value-and-grad of 16 series against the
   CPU within ``WIDE_*``; each of the seven kernels launched.
   walk_forward — the fifth main path: ``wf_trade`` on the 204 tasks
   (their ticks simulated on a host thread during the build, and timed
   there; hard gate, one chain, 100 + 300 sweeps, 64 windows a group):
   the native extractor took every series; ``FWD`` and ``BWD_SAMPLE``
   launched once a sweep a group and ``FWD`` twice a decode dispatch,
   and nothing else; every chain healthy, every logp and buy-and-hold
   return finite, trades for every lag; the first decode dispatch and
   the first at the largest bucket pair again through ``fwd_plain`` on
   the same lanes (filtered probabilities bitwise, leg states
   identical); ``phase_timings``, legs, fit groups
   with their sweeps/s, decode dispatches and the mean OOS return a lag
   against buy-and-hold.
   walk_forward_chees — 16 of the tasks (every 13th) by ChEES (stan
   gate, 2 chains, 50 + 50 transitions, at most 16 leapfrogs, 8 windows
   a group, no fused trajectory): ``FWD`` and ``VG_BWD`` once a
   value-and-grad call (``FWD`` also twice a decode dispatch), every
   chain healthy, mean divergent share a task under ``WF_DIV_MAX``; its
   decode checked against ``fwd_plain`` as above.
   walk_forward_kernels — the first launch of ``FWD``, ``BWD_SAMPLE``
   and ``VG_BWD`` at each shape and gate of each Gibbs and ChEES fit
   group, its inputs kept as the path made them, bitwise equal to the
   plain version on the same inputs and timed on them; the ``FWD`` +
   ``BWD_SAMPLE`` pair as a share of a Gibbs group's sweep.
9. the kernels line (every kernel; the semiring kernels with their K
   range, their time at K=64 and their zoo_wide launches; ``FWD``,
   ``BWD_SAMPLE`` and ``VG_BWD`` with their walk_forward launches), then
   the last line ``{"ok": true, "device": ...}``.

Any failed check raises, so the script exits non-zero and prints no
result line. It imports nothing of JAX or of ``hhmm_tpu``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

from hhmm_tpu_torch.apps.tayal import build_tasks, simulate_ticks, wf_trade
from hhmm_tpu_torch.apps.tayal import wf as wf_module
from hhmm_tpu_torch.apps.tayal.trading import equity_curve
from hhmm_tpu_torch.apps.tayal.wf import D_DEC, G_DEC, median_states
from hhmm_tpu_torch.batch import default_init
from hhmm_tpu_torch.infer import (
    ChEESConfig,
    GibbsConfig,
    ess_many,
    make_lp_bc,
    sample_chees_batched,
    sample_gibbs,
)
from hhmm_tpu_torch.core.lmath import MASK_NEG
from hhmm_tpu_torch.kernels import cuda_semiring as cs
from hhmm_tpu_torch.kernels import cuda_traj as ct
from hhmm_tpu_torch.kernels import dispatch as td
from hhmm_tpu_torch.kernels import forward_value_and_grad
from hhmm_tpu_torch.kernels.cuda_build import build_and_load
from hhmm_tpu_torch.kernels.filtering import smooth
from hhmm_tpu_torch.models import GaussianHMM, NIGPrior, TayalHHMM, TayalHHMMLite
from hhmm_tpu_torch.models import base as zoo_base
from hhmm_tpu_torch.models.base import broadcast_data
from hhmm_tpu_torch.native import zigzag as native_zigzag
from hhmm_tpu_torch.sim import hmm_sim, obsmodel_gaussian
from hhmm_tpu_torch.sim.tayal import tayal_batch, tayal_phi

# main path: bench.py's default Gibbs workload
N_SERIES, T_FIT, K_TAYAL = 256, 1024, 4
WARMUP, SAMPLES = 100, 300
T_OOS, N_DRAWS = 256, 8
SEED_DATA, SEED_INIT, SEED_SAMPLER = 42, 100, 0
# second main path: bench.py --sampler chees (stan gate, 2 chains)
CHAINS, CAP = 2, 16
CHEES_WARMUP, CHEES_SAMPLES = 150, 150
UNFUSED_WARMUP, UNFUSED_SAMPLES = 10, 10
N_LANES = N_SERIES * CHAINS
T_SHORT = 64  # window of the fused-vs-unfused check (tests/test_pallas_traj.py's regime)
# third main path: the zoo's generated quantities, 32 draws a series
N_DECODE_DRAWS = 32
N_DEC = N_SERIES * N_DECODE_DRAWS  # 8192 lanes
# the Gaussian HMM of hmm/main.R at bench_zoo.py::bench_hmm's Gibbs arm
G_K, G_T = 3, 500
G_A = [[0.8, 0.1, 0.1], [0.1, 0.8, 0.1], [0.05, 0.15, 0.8]]
G_MU, G_SIGMA = [-2.0, 0.5, 3.0], [0.5, 0.8, 0.6]
G_PRIOR = dict(m0=0.0, kappa0=0.1, a0=2.0, b0=1.0)
G_WARMUP, G_SAMPLES = 100, 300
SEED_GAUSS = 7
# the same model with more states: K, sticky A, means 1.5 apart, 8 draws
# a series through the decode
GK_KS, GK_STAY, GK_SIGMA = (5, 12), 0.8, 0.5
GK_WARMUP, GK_SAMPLES, GK_DRAWS = 20, 20, 8
# above K=16 (a warp a lane, byte-wide Viterbi maps): the Gaussian HMM at
# K=20, decoded only, 32 series x 8 random draws = 256 lanes, T=500
K_WIDE, K_WIDE_SERIES, K_WIDE_DRAWS = 20, 32, 8
# above K=32 (a block a lane, the lane's A in shared memory): the same
# model at K=64 on 256 series, T=500, through the whole zoo path — a
# short Gibbs fit, state_draws, generated and one value-and-grad call —
# with 2 draws a series through the decode; the first 16 series also on
# the CPU
ZW_K, ZW_WARMUP, ZW_SAMPLES, ZW_DRAWS, ZW_CPU_SERIES = 64, 10, 10, 2, 16
# every semiring kernel against its plain version above K=16: a warp a
# lane (17..32) and a block a lane (33..128), at (N, T) = (64, 256) and
# at (9, 75), T off every ring's and chunk's length
WIDE_KS = (17, 24, 32, 33, 48, 64, 96, 128)
WIDE_SHAPES = ((64, 256), (9, 75))
# fifth main path: the Tayal walk-forward back-test (the reference's
# test-strategy.R protocol: 5-day train + 1-day trade windows), 34
# symbols x 11 days of simulated ticks = 204 tasks; legs a day spread
# evenly in log from 200 to 2000 over the symbols, so in-sample windows
# run from about 1,000 to 10,000 legs
WF_SYMBOLS, WF_DAYS, WF_TRAIN_DAYS, WF_TRADE_DAYS = 34, 11, 5, 1
WF_LEGS_PER_DAY = (200, 2000)
WF_TASKS = WF_SYMBOLS * (WF_DAYS - WF_TRAIN_DAYS - WF_TRADE_DAYS + 1)
WF_WARMUP, WF_SAMPLES, WF_CHUNK = 100, 300, 64
SEED_WF = 2009
# its ChEES arm: every 13th task (16 windows across the length range),
# stan gate, 2 chains, at most 16 leapfrogs, fitted 8 windows a group
WF_CHEES_STRIDE, WF_CHEES_TASKS, WF_CHEES_CHUNK = 13, 16, 8
WF_CHEES_WARMUP, WF_CHEES_SAMPLES = 50, 50
WF_DIV_MAX = 0.2  # mean divergent share a task (tests/test_chees.py's wf_trade gate)

# the FFBS checks (each bitwise against the plain versions): every K the
# kernels take, gated and not, at the main path's shape with a ragged
# tail, then (N, T) that are not a multiple of a lane group, a block or a
# ring stage, with masked runs at both ends of every lane; T=2100 puts
# BWD_SAMPLE's maps in its device scratch instead of shared memory
FFBS_KS = (2, 3, 4, 8)
FFBS_SHAPES = ((N_SERIES, T_FIT, False), (250, 1000, True), (1, T_FIT, True), (N_SERIES, 1, True),
               (5, 2100, True))
# every other K of four-bit maps (2..16: groups of 8 and 16 threads a
# lane, two map words a step above 8), at fewer lanes; K above 16 in
# phase_kernels_wide
EXTRA_KS = tuple(k for k in range(2, 17) if k not in FFBS_KS)
EXTRA_FFBS_SHAPES = ((64, T_FIT, True), (3, 2100, True))
EXTRA_VG_LANES = 64
EXTRA_DECODE_LANES = 256
FFBS_TIMING_LANES = (1, 256, 512, 2048, 8192)  # FWD / BWD_SAMPLE timed at T=1024, K=4

# tolerances (kernel vs plain version on the card)
DECODE_ATOL = 1e-5  # filtered probabilities, absolute
PHI_MAE_MAX = 0.05  # posterior-mean emission rows vs the simulator's
# divergent share of the ChEES sampling transitions (lanes x transitions):
# one shared step size meets a few genuinely unstable trajectories on
# this batch (they diverge in float64 and through the unfused path too);
# a wrong gradient diverges on a large share. One fit's count is
# heavy-tailed: a chain that settles where the shared step size is
# unstable diverges on about every other transition from then on, so
# the count swings by tens between sampler seeds with either trajectory
# kernel design, and the share is taken over the fits of CHEES_SEEDS
DIV_SHARE_MAX = 1e-3
CHEES_SEEDS = (SEED_SAMPLER, SEED_SAMPLER + 1, SEED_SAMPLER + 2, SEED_SAMPLER + 3)
REPLAY_DH_MIN = 100.0  # a replayed divergence's float64 energy error
PROB_ATOL = 1e-5  # decode probabilities: alpha rows sum to 1, kernels vs plain
# gamma = exp(log_alpha + log_beta - lse(...)) at T=1024: the f32 sum and
# its normaliser are each rounded at |loglik| ~ 1.6e3 (ulp 1.2e-4), so a
# row sums to 1 only within a few of those ulps (in the JAX package too)
GAMMA_SUM_TOL = 1e-3
G_MU_TOL = 0.35  # Gaussian posterior-mean mu, mean over series (tests/test_gibbs.py)
# the K=20 decode on the card against the same call on the CPU: torch's exp
# and log round differently on the two devices (in build and in the plain
# versions). At T=500 a log-alpha of about -1e3 has an f32 ulp of 6.1e-5;
# two runs read gamma 1.22e-4 off (two ulps, the same through the scans
# and through the kernels), alpha 4.5e-5, loglik and logp_zstar 9.9e-7
# relative, and identical paths (the inputs come from a seed, so the
# comparison is deterministic). The limits are twice the readings: four
# ulps, and no path may differ
WIDE_PROB_ATOL, WIDE_LL_RTOL, WIDE_PATH_MISMATCH_MAX = 2.5e-4, 2e-6, 0.0
# the K=64 value-and-grad call on the card against the same call on the
# CPU: d_A is a sum over T=500 steps, compared relative to its largest
# entry (a first run read 5.0e-8; d_pi and d_obs 1.2e-7 absolute, under
# WIDE_PROB_ATOL; loglik 0 relative, under WIDE_LL_RTOL)
WIDE_DA_RTOL = 1e-6
G_ACC_MIN = 0.9  # Gaussian Viterbi accuracy (tests/test_models.py)
# trajectory (tests/test_pallas_traj.py's tolerances): (rtol, atol)
TRAJ_TOL = {"q": (2e-4, 2e-4), "p": (2e-3, 2e-3), "logp": (1e-4, 5e-3), "grad": (2e-3, 2e-3)}
# the trajectory kernel against traj_plain at odd shapes, every lane's
# series with masked runs at both ends: (B, T, C, n_steps). T = 1000 and
# 100 are off the kernel's 16-step chunks, T = 6500 puts its per-step
# buffers in the device scratch, n_steps = CAP + 4 is clamped to CAP
TRAJ_ODD_CASES = ((N_SERIES, T_FIT, CHAINS, 2), (5, 1000, 3, 1), (5, 1000, 1, 0),
                  (1, T_FIT, 1, 1), (5, 1, 2, CAP + 4), (5, 100, 2, 16), (5, 6500, 2, 1))
TRAJ_TIMING_LANES = (1, N_LANES, 2048)  # TRAJ timed at T=1024, 16 leapfrogs
# the largest errors of the one-thread-a-lane kernel this design replaced,
# on the two full-T checks below (its own run of this script)
TRAJ_EARLIER_ERR = {"logp_vs_plain": 1.5e-3, "logp_vs_f64_plain": 1.1e-2}

SPIN_CYCLES = 20_000_000  # about 10 ms at the H100's 1.98 GHz (time_ms)

# H100 SXM published peaks: HBM bandwidth and
# f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around ``reps`` calls. The calls
    are queued behind a spin kernel, so that a kernel shorter than its
    wrapper's host time is timed on the card and not at the host's
    launch rate (a plain version, whose host loop outlasts the spin,
    is timed as it runs)."""
    for _ in range(warmup):
        fn()
    sync()
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def make_case(seed: int, N: int, T: int, K: int, gated: bool, device, both_ends: bool = False):
    """Random normalized (pi, A), N(-1, 1) emissions, ragged mask of
    lengths in [T/2, T] (with ``both_ends``, each lane's first [0, T/8]
    steps masked too), sign gate on a Tayal-like state key; returned in
    the kernels' lane layout with uniforms ``u [T, N]``."""
    rng = np.random.default_rng(seed)

    def log_norm(a):
        return a - np.log(np.exp(a).sum(-1, keepdims=True))

    f32 = dict(dtype=torch.float32, device=device)
    log_pi = torch.as_tensor(log_norm(rng.normal(size=(N, K))), **f32)
    log_A = torch.as_tensor(log_norm(rng.normal(size=(N, K, K))), **f32)
    log_obs = torch.as_tensor(rng.normal(size=(N, T, K)) - 1.0, **f32)
    lengths = rng.integers(T // 2, T + 1, size=N)
    valid = np.arange(T)[None, :] < lengths[:, None]
    if both_ends:
        valid &= np.arange(T)[None, :] >= rng.integers(0, T // 8 + 1, size=N)[:, None]
    mask = torch.as_tensor(valid, **f32)
    gk = sk = None
    if gated:
        gk = torch.as_tensor(rng.integers(0, 2, size=(N, T)), **f32)
        sk = torch.as_tensor(np.resize([1.0, 0.0, 0.0, 1.0], K), **f32)
    u = torch.as_tensor(rng.random((N, T)), **f32)
    lanes = cs.to_lanes(log_pi, log_A.clamp_min(-1e30), log_obs, mask, gk, sk)
    return lanes, u.t().contiguous()


def fwd_bytes_ops(lanes):
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    T, K, N = obs_t.shape
    gated = gate_t is not None
    floats = K * N + K * K * N + T * K * N + T * N + N + T * K * N
    if gated:
        floats += T * N + K * N
    steps = int((mask_t[1:] > 0).sum())  # masked steps copy the carry
    per_dest = 5 * K + 3 + (K if gated else 0)  # add(,mul), max, sub, exp, sum, log, 2 adds
    ops = steps * K * per_dest + N * (4 * K + 2)
    return 4 * floats, ops


def bwd_bytes_ops(lanes):
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    T, K, N = obs_t.shape
    floats = K * K * N + T * N + T * K * N + T * N + T * N  # A, mask, alpha, u, z
    if gate_t is not None:
        floats += T * N + K * N
    ops = T * N * (12 * K - 1)  # logits, lse0, p, running cum + count, every step
    return 4 * floats, ops


def bound(bytes_, ops):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def vg_bytes_ops(lanes):
    """Bytes and f32 operations of ``VG_BWD`` on these lanes: inputs
    (A, obs, mask, alpha, ll, gate keys) read once, outputs (d_pi, d_A,
    d_obs) written once; the arithmetic of the valid steps (a masked
    step only copies beta and writes a zero row)."""
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    T, K, N = obs_t.shape
    gated = gate_t is not None
    floats = K * K * N + 2 * T * K * N + T * N + N + (T * N + K * N if gated else 0)
    floats += K * N + K * K * N + T * K * N
    steps = int((mask_t[1:] > 0).sum())
    # d_obs 4K; e K; per (i, j): add, add, sub, exp, mul m, add acc, add x
    # (+ 2 muls by c gated); per i the clamped lse: K max, K sub, K exp,
    # K-1 adds, log, add
    per_step = 5 * K + K * K * (7 + (2 if gated else 0)) + K * (4 * K + 1)
    return 4 * floats, steps * per_step + N * 4 * K


def traj_bytes_ops(T: int, B: int, C: int, mask_t, n_steps: int):
    """Bytes and f32 operations of ``TRAJ`` for one trajectory of
    ``n_steps`` leapfrogs: inputs (q, p, grad per lane, inverse mass and
    data per series, eps, n) read once, outputs (q, p, grad, logp)
    written once; per leapfrog the unpack, the forward and backward
    passes over the valid steps, the chain rule and the updates."""
    N, D, K, L = B * C, ct.DIM, 4, 9
    floats = 3 * D * N + D * B + 3 * T * B + 2 + 3 * D * N + N
    valid = int((mask_t[1:] > 0).sum()) * C  # valid steps t >= 1, all lanes
    # forward: 16 mul-adds, 4 emission muls, 3 adds, 4 divides, log, add;
    # backward: 4 gamma muls + 4 slab adds, e 4 muls + 4 divides, 4 dA
    # terms of 4 ops, 16 mul-adds for beta
    per_step = (32 + 4 + 3 + 4 + 2) + (8 + 8 + 16 + 32)
    # unpack: 35 sigmoid / log-sigmoid chains (~12 ops) and 36 exps;
    # chain rule ~10 ops a coordinate; leapfrog updates 6 a coordinate
    per_lane = 12 * D + 36 + 10 * D + 6 * D
    ops = n_steps * (valid * per_step + N * per_lane)
    return 4 * floats, ops


def phase_kernels(device):
    """``FWD`` and ``BWD_SAMPLE`` bitwise equal to ``fwd_plain`` and
    ``bwd_sample_plain`` (alpha, ll and every draw) in every case of
    ``FFBS_KS`` x gated x ``FFBS_SHAPES`` and ``EXTRA_KS`` x gated x
    ``EXTRA_FFBS_SHAPES``; then timed at the main path's shape, on one
    lane, and at each of ``FFBS_TIMING_LANES`` lanes."""
    cases = []
    fwd_err = z_err = 0.0
    grid = [(K, g, shape) for K in FFBS_KS for g in (False, True) for shape in FFBS_SHAPES]
    grid += [(K, g, shape) for K in EXTRA_KS for g in (False, True) for shape in EXTRA_FFBS_SHAPES]
    for i, (K, gated, (N, T, both)) in enumerate(grid):
        lanes, u_t = make_case(1000 + i, N, T, K, gated, device, both_ends=both)
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
        ll_k, a_k = cs.fwd_lanes(*lanes)
        z_k = cs.bwd_sample_lanes(A_t, mask_t, a_k, u_t, gate_t, sk_t)
        ll_p, a_p = cs.fwd_plain(*lanes)
        z_p = cs.bwd_sample_plain(A_t, mask_t, a_p, u_t, gate_t, sk_t)
        sync()
        fwd_err = max(fwd_err, float((a_k - a_p).abs().max()), float((ll_k - ll_p).abs().max()))
        z_err = max(z_err, float((z_k - z_p).abs().max()))
        same = {"alpha": torch.equal(a_k, a_p), "ll": torch.equal(ll_k, ll_p),
                "z": torch.equal(z_k, z_p)}
        if not all(same.values()):
            raise AssertionError(
                f"FFBS K={K} gated={gated} N={N} T={T}: not bitwise equal to the plain "
                f"versions {same}, alpha err {float((a_k - a_p).abs().max()):.3g}, "
                f"{int((z_k != z_p).sum())} draws differ"
            )
        cases.append(dict(K=K, gated=gated, N=N, T=T, masked_both_ends=both,
                          masked_steps=int((mask_t == 0).sum())))
        emit("kernels_vs_plain", bitwise_equal=True, **cases[-1])

    # timing at the main-path shape: N=256, T=1024, K=4, ungated
    lanes, u_t = make_case(2000, N_SERIES, T_FIT, K_TAYAL, False, device)
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    _, alpha = cs.fwd_lanes(*lanes)
    t = {}
    t["fwd_ms"] = time_ms(lambda: cs.fwd_lanes(*lanes), reps=50)
    t["bwd_ms"] = time_ms(lambda: cs.bwd_sample_lanes(A_t, mask_t, alpha, u_t), reps=50)
    t["fwd_plain_ms"] = time_ms(lambda: cs.fwd_plain(*lanes), reps=3, warmup=1)
    t["bwd_plain_ms"] = time_ms(
        lambda: cs.bwd_sample_plain(A_t, mask_t, alpha, u_t), reps=3, warmup=1
    )
    # one lane alone: the serial T-step chain, which no batch size shortens
    one = tuple(None if x is None else x[..., :1].contiguous() for x in lanes)
    _, alpha1 = cs.fwd_lanes(*one)
    u1 = u_t[:, :1].contiguous()
    t["fwd_one_lane_ms"] = time_ms(lambda: cs.fwd_lanes(*one), reps=50)
    t["bwd_one_lane_ms"] = time_ms(
        lambda: cs.bwd_sample_lanes(one[1], one[3], alpha1, u1), reps=50
    )
    # the whole FFBS wrapper as the Gibbs sweep calls it (layout included)
    log_pi = pi_t.t().contiguous()
    log_A = A_t.permute(2, 0, 1).contiguous()
    log_obs = obs_t.permute(2, 0, 1).contiguous()
    mask, u = mask_t.t().contiguous(), u_t.t().contiguous()
    t["ffbs_wrapper_ms"] = time_ms(
        lambda: cs.semiring_ffbs(log_pi, log_A, log_obs, mask, u), reps=50
    )
    # the decode's shape: gated, 2048 lanes
    dlanes, _ = make_case(2001, N_SERIES * N_DRAWS, T_FIT, K_TAYAL, True, device)
    t["fwd_decode_gated_2048_ms"] = time_ms(lambda: cs.fwd_lanes(*dlanes), reps=20)
    del dlanes
    # both kernels across batch sizes, and ns a step (T=1024, dense mask)
    by_lanes = {}
    for N in FFBS_TIMING_LANES:
        nl, nu = make_case(2002, N, T_FIT, K_TAYAL, False, device)
        _, na = cs.fwd_lanes(*nl)
        f = time_ms(lambda: cs.fwd_lanes(*nl), reps=20)
        b = time_ms(lambda: cs.bwd_sample_lanes(nl[1], nl[3], na, nu), reps=20)
        by_lanes[N] = dict(fwd_ms=f, fwd_ns_per_step=f * 1e6 / T_FIT,
                           bwd_ms=b, bwd_ns_per_step=b * 1e6 / T_FIT)
        del nl, nu, na
    t["by_lanes"] = by_lanes
    emit("kernel_timing", shape=dict(N=N_SERIES, T=T_FIT, K=K_TAYAL), **t)
    fb, fo = fwd_bytes_ops(lanes)
    bb, bo = bwd_bytes_ops(lanes)
    return dict(cases=cases, fwd_err=fwd_err, z_err=z_err, timing=t,
                fwd_bound=bound(fb, fo), bwd_bound=bound(bb, bo),
                fwd_bytes=fb, fwd_ops=fo, bwd_bytes=bb, bwd_ops=bo)


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------


ALL_KERNELS = cs.KERNELS + ct.KERNELS

# the bear/bull pair-swap relabeling of the Tayal posterior: p_11 <-> 1-p_11,
# A_row rows swap, phi rows permute [3, 2, 1, 0]
MIRROR = [3, 2, 1, 0]


def canonical_draws(p):
    """Constrained draws ``[B, C, S, 41]`` (p_11, A_row, phi_k) with the
    mirror label modes folded per draw toward each series' first draw
    (the fold ``bench.py`` applies before its worst-parameter ESS), and
    the share of draws folded."""
    p11 = p["p_11"].cpu().numpy()
    B, C, S = p11.shape
    p11 = p11.reshape(B, C * S)
    A_row = p["A_row"].cpu().numpy().reshape(B, C * S, 2, 2)
    phi = p["phi_k"].cpu().numpy().reshape(B, C * S, 4, 9)
    anchor = phi[:, :1]
    swap = ((phi[:, :, MIRROR] - anchor) ** 2).sum(axis=(2, 3)) < (
        (phi - anchor) ** 2
    ).sum(axis=(2, 3))
    p11 = np.where(swap, 1.0 - p11, p11)
    A_row[swap] = A_row[swap][:, ::-1]
    phi[swap] = phi[swap][:, MIRROR]
    mats = np.concatenate(
        [p11[..., None], A_row.reshape(B, C * S, 4), phi.reshape(B, C * S, 36)], axis=-1
    )
    return mats.reshape(B, C, S, -1), float(swap.mean())


def phase_fit(device, kernel_ms_per_sweep):
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM(gate_mode="hard")
    init = default_init(model, data, N_SERIES, 1, seed=SEED_INIT, device=device)
    cfg = GibbsConfig(num_warmup=WARMUP, num_samples=SAMPLES, num_chains=1)
    sync()
    ffbs = (cs.FWD, cs.BWD_SAMPLE)
    before = {k.name: k.launches for k in ffbs}
    t0 = time.perf_counter()
    qs, stats = sample_gibbs(model, data, init, cfg, seed=SEED_SAMPLER, device=device)
    sync()
    wall = time.perf_counter() - t0
    sweeps = WARMUP + SAMPLES
    rose = {k.name: k.launches - before[k.name] for k in ffbs}
    if any(v != sweeps for v in rose.values()):
        raise AssertionError(f"fit: kernel launches {rose}, expected {sweeps} each")
    if not bool(stats["chain_healthy"].all()):
        raise AssertionError("fit: a chain was quarantined")
    if not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError("fit: non-finite logp")
    if tuple(qs.shape) != (N_SERIES, 1, SAMPLES, model.n_free):
        raise AssertionError(f"fit: qs shape {tuple(qs.shape)}")

    worst, swap_share, phi_mean, mae = fold_and_score(model, qs)
    if not mae.mean() <= PHI_MAE_MAX:
        raise AssertionError(f"fit: posterior-mean phi MAE {mae.mean():.3g} > {PHI_MAE_MAX}")
    emit(
        "fit",
        series=N_SERIES, T=T_FIT, chains=1, warmup=WARMUP, samples=SAMPLES,
        seconds=wall, sweeps_per_s=sweeps / wall, series_per_s=N_SERIES / wall,
        sweep_ms=wall / sweeps * 1e3,
        # the two kernels' own time (phase 3, same shape) as a share of a sweep
        kernel_share=kernel_ms_per_sweep / (wall / sweeps * 1e3),
        launches=rose, logp_mean=float(stats["logp"].mean()),
        ess_worst_param_min=float(worst.min()), ess_worst_param_mean=float(worst.mean()),
        mirror_fold_share=swap_share,
        phi_mae_mean=float(mae.mean()), phi_mae_max=float(mae.max()),
    )
    return qs, phi_mean


def fold_and_score(model, qs):
    """Fold the mirror label modes, then per series: the worst-parameter
    ESS, the share of draws folded, the posterior-mean emission rows
    ``[B, 4, 9]`` and their mean absolute error against the simulator's
    rows, up to the mirror relabeling the fold leaves open (each
    series' anchor is its own first draw)."""
    mats, swap_share = canonical_draws(model.constrained_draws(qs))  # [B, C, S, P]
    B, C, S, P = mats.shape
    per_param = ess_many(np.moveaxis(mats, -1, 1).reshape(B * P, C, S)).reshape(B, P)
    phi_true = tayal_phi(SEED_DATA)
    phi_mean = mats[..., 5:].reshape(B, C * S, 4, 9).mean(axis=1)
    mae = np.minimum(
        np.abs(phi_mean - phi_true).mean(axis=(1, 2)),
        np.abs(phi_mean[:, MIRROR] - phi_true).mean(axis=(1, 2)),
    )
    return per_param.min(axis=1), swap_share, phi_mean, mae


def phase_decode(device, qs):
    xs, ss = tayal_batch(N_SERIES, T_FIT + T_OOS, seed=SEED_DATA, device=device)
    data = {
        "x": xs[:, :T_FIT], "sign": ss[:, :T_FIT],
        "x_oos": xs[:, T_FIT:], "sign_oos": ss[:, T_FIT:],
    }
    draws = qs[:, 0, :: SAMPLES // N_DRAWS][:, :N_DRAWS]  # [B, 8, D]
    lite = TayalHHMMLite(gate_mode="stan")
    fwd_before = cs.FWD.launches
    sync()
    t0 = time.perf_counter()
    out = lite.generated(draws, data, device=device)
    sync()
    wall = time.perf_counter() - t0
    shapes = {
        "alpha": (N_SERIES, N_DRAWS, T_FIT, 4),
        "alpha_oos": (N_SERIES, N_DRAWS, T_OOS, 4),
        "zstar_oos": (N_SERIES, N_DRAWS, T_OOS),
    }
    for k, shp in shapes.items():
        if tuple(out[k].shape) != shp:
            raise AssertionError(f"decode: {k} shape {tuple(out[k].shape)} != {shp}")
    for k in ("alpha", "alpha_oos"):
        a = out[k]
        if not bool(torch.isfinite(a).all()) or float((a.sum(-1) - 1).abs().max()) > 1e-5:
            raise AssertionError(f"decode: {k} is not a finite probability vector per step")
    z = out["zstar_oos"]
    if not bool(((z >= 0) & (z < 4)).all()):
        raise AssertionError("decode: zstar_oos out of range")

    # the gated forward kernel against its plain version on the same lanes
    n = N_SERIES * N_DRAWS
    params, _ = lite.unpack(draws.reshape(n, -1))
    errs = {}
    for key, xk, sk_ in (("alpha", "x", "sign"), ("alpha_oos", "x_oos", "sign_oos")):
        seg = {"x": data[xk].repeat_interleave(N_DRAWS, 0),
               "sign": data[sk_].repeat_interleave(N_DRAWS, 0)}
        log_pi, log_A, log_obs, _ = lite.build_vg(params, seg)
        gk, skey = lite.gate_keys(seg)
        mask = torch.ones(seg["x"].shape, dtype=torch.float32, device=device)
        _, a_plain = cs.fwd_plain(*cs.to_lanes(log_pi, log_A, log_obs, mask, gk, skey))
        ref = torch.softmax(a_plain.permute(2, 0, 1), dim=-1).reshape(out[key].shape)
        errs[key] = float((out[key] - ref).abs().max())
    if max(errs.values()) > DECODE_ATOL:
        raise AssertionError(f"decode: kernel vs plain filtered probabilities {errs}")
    emit(
        "decode", lanes=n, T=T_FIT, T_oos=T_OOS, seconds=wall,
        fwd_launches=cs.FWD.launches - fwd_before, max_abs_err_vs_plain=errs,
    )


# ---------------------------------------------------------------------------
# phase 3 (cont.): the value-and-grad and trajectory kernels
# ---------------------------------------------------------------------------


def phase_kernels_vg(device):
    """``FWD`` + ``VG_BWD`` bitwise equal to ``fwd_plain`` +
    ``vg_bwd_plain`` at N=512, T=1024, K in {3, 4, 8}, and at N=64 at
    every other K in 2..16, gated and not, ragged mask."""
    errs = {"ll_rel": 0.0, "d_pi": 0.0, "d_obs": 0.0, "d_A_rel": 0.0, "d_A": 0.0}
    grid = [(N_LANES, K, g) for K, g in [(4, False), (4, True), (8, False), (8, True), (3, False)]]
    grid += [(EXTRA_VG_LANES, K, g) for K in range(2, 17)
             for g in (False, True) if (K, g) not in {(4, False), (4, True), (8, False),
                                                      (8, True), (3, False)}]
    for i, (N, K, gated) in enumerate(grid):
        lanes, _ = make_case(3000 + i, N, T_FIT, K, gated, device)
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
        ll_k, a_k = cs.fwd_lanes(*lanes)
        got = cs.vg_bwd_lanes(A_t, obs_t, mask_t, a_k, ll_k, gate_t, sk_t)
        ll_p, a_p = cs.fwd_plain(*lanes)
        want = cs.vg_bwd_plain(A_t, obs_t, mask_t, a_p, ll_p, gate_t, sk_t)
        sync()
        e = {
            "ll_rel": float(((ll_k - ll_p).abs() / ll_p.abs()).max()),
            "d_pi": float((got[0] - want[0]).abs().max()),
            "d_obs": float((got[2] - want[2]).abs().max()),
            "d_A_rel": float(((got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-30)).max()),
            "d_A": float((got[1] - want[1]).abs().max()),
        }
        same = torch.equal(ll_k, ll_p) and all(torch.equal(g, w) for g, w in zip(got, want))
        if not same:
            raise AssertionError(f"value-and-grad K={K} gated={gated} N={N}: not bitwise "
                                 f"equal to the plain versions, {e}")
        errs = {k: max(errs[k], v) for k, v in e.items()}
        emit("vg_vs_plain", N=N, T=T_FIT, K=K, gated=gated, bitwise_equal=True, **e)

    # timing on the main path's own lanes: the stan-gate Tayal terms of
    # the ChEES fit's inits (K=4, gated, dense)
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM()
    init = default_init(model, data, N_SERIES, CHAINS, seed=SEED_INIT, device=device)
    lanes = tayal_lanes(model, data, init)
    pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    ll, alpha = cs.fwd_lanes(*lanes)
    t = {}
    t["ms"] = time_ms(lambda: cs.vg_bwd_lanes(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t), reps=50)
    t["plain_ms"] = time_ms(
        lambda: cs.vg_bwd_plain(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t), reps=2, warmup=1
    )
    one = tuple(None if v is None else v[..., :1].contiguous() for v in lanes)
    ll1, alpha1 = cs.fwd_lanes(*one)
    t["one_lane_ms"] = time_ms(
        lambda: cs.vg_bwd_lanes(one[1], one[2], one[3], alpha1, ll1, one[4], one[5]), reps=50
    )
    t["fwd_ms"] = time_ms(lambda: cs.fwd_lanes(*lanes), reps=50)
    lp_bc = make_lp_bc(model, data, device=device)
    t["lp_bc_ms"] = time_ms(lambda: lp_bc(init), reps=20)
    emit("vg_timing", shape=dict(N=N_LANES, T=T_FIT, K=4, gated=True), **t)
    b, o = vg_bytes_ops(lanes)
    return dict(err=errs, timing=t, bound=bound(b, o), bytes=b, ops=o)


def tayal_lanes(model, data, q):
    """The stan-gate Tayal value-and-grad lanes at ``q [B, C, 35]``, as
    ``make_vg`` builds them (dense mask)."""
    B, C, _ = q.shape
    n = B * C
    params, _ = model.unpack(q)
    lanes = {k: broadcast_data(v, (B, C)) for k, v in data.items()}
    log_pi, log_A, log_obs, _ = model.build_vg(params, lanes)
    gk, sk = model.gate_keys(lanes)
    T = log_obs.shape[-2]
    mask = torch.ones((n, T), dtype=torch.float32, device=q.device)
    return cs.to_lanes(
        log_pi.reshape(n, 4), log_A.reshape(n, 4, 4), log_obs.reshape(n, T, 4), mask,
        gk.reshape(n, T), sk.reshape(n, 4),
    )


def state_errors(got, want):
    """Per quantity (q, p, logp, grad): max abs error and the largest
    excess over ``atol + rtol * |want|`` (positive = out of tolerance)."""
    out = {}
    for name, a, b in zip(("q", "p", "logp", "grad"), got, want):
        rtol, atol = TRAJ_TOL[name]
        d = (a - b).abs()
        out[name] = (float(d.max()), float((d - atol - rtol * b.abs()).max()))
    return out


def phase_kernels_traj(device):
    """``TRAJ`` against ``traj_plain`` (2 leapfrogs) and against the
    unfused leapfrogs over ``make_lp_bc`` (8) at the ChEES shape; then
    its time per leapfrog at 16, on one lane, and its plain version."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM()
    q = default_init(model, data, N_SERIES, CHAINS, seed=SEED_INIT, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    f32 = dict(dtype=torch.float32, device=device)
    p = torch.randn(q.shape, generator=gen, **f32)
    inv_mass = torch.exp(0.3 * torch.randn((N_SERIES, ct.DIM), generator=gen, **f32))
    eps = 0.02
    lp_bc = make_lp_bc(model, data, device=device)
    _, g0 = lp_bc(q)
    x_t, s_t, m_t = ct._data_lanes(x, sign, None, device)

    def lanes(a):
        return a.reshape(N_LANES, ct.DIM).t().contiguous()

    args = (lanes(q), lanes(p), lanes(g0), inv_mass.t().contiguous(), x_t, s_t, m_t)
    eps_t = torch.tensor([eps], **f32)

    def n_t(n):
        return torch.tensor([n], dtype=torch.int32, device=device)

    got = ct.traj_lanes(*args, eps_t, n_t(2), CAP, CHAINS)
    want = ct.traj_plain(*args, eps_t, n_t(2), CAP, CHAINS)
    sync()
    vs_plain = state_errors(got, want)
    # the fused trajectory in f32 against its plain version in f64, 8
    # leapfrogs: the f32 kernel is accurate at the full T
    got8 = ct.traj_lanes(*args, eps_t, n_t(8), CAP, CHAINS)
    f64 = [a.double() for a in args]
    f64[4], f64[5] = args[4], args[5]  # symbols and signs stay int32
    want8 = ct.traj_plain(*f64, eps_t.double(), n_t(8), CAP, CHAINS)
    sync()
    vs_f64 = state_errors([a.double() for a in got8], want8)

    def unfused(lp_fn, g, n):
        qu, pu, gu, lpu = q, p, g, None
        for _ in range(n):
            ph = pu + 0.5 * eps * gu
            qu = qu + eps * inv_mass[:, None, :] * ph
            lpu, gu = lp_fn(qu)
            pu = ph + 0.5 * eps * gu
        return qu, pu, lpu, gu

    # fused vs unfused (FWD + VG_BWD kernels), 8 leapfrogs, same inputs,
    # on the first T_SHORT legs of every series: the regime the
    # tolerances were set for. At T=1024 the unfused log-space path
    # itself carries an f32 gradient error of order T * ulp(|loglik|)
    # (every gamma is exp(alpha + beta - ll) with |ll| ~ 1.6e3), so
    # there the gap is reported, not gated.
    short = {"x": x[:, :T_SHORT], "sign": sign[:, :T_SHORT]}
    lp_short = make_lp_bc(model, short, device=device)
    _, g_short = lp_short(q)
    fused = ct.make_tayal_trajectory(short, cap=CAP, device=device)(
        inv_mass, eps, 8, q, p, None, g_short
    )
    vs_unfused = state_errors(fused, unfused(lp_short, g_short, 8))
    traj = ct.make_tayal_trajectory(data, cap=CAP, device=device)
    fused_full = traj(inv_mass, eps, 8, q, p, None, g0)
    gap_full = state_errors(fused_full, unfused(lp_bc, g0, 8))
    sync()
    for what, e in (("plain", vs_plain), ("f64 plain", vs_f64), ("unfused", vs_unfused)):
        bad = {k: v for k, v in e.items() if v[1] > 0}
        if bad:
            raise AssertionError(f"trajectory vs {what}: out of tolerance {bad}")
    emit("traj_vs_plain", B=N_SERIES, C=CHAINS, T=T_FIT, n_steps=2,
         max_abs_err={k: v[0] for k, v in vs_plain.items()},
         earlier_design_logp_err=TRAJ_EARLIER_ERR["logp_vs_plain"])
    emit("traj_vs_plain_f64", B=N_SERIES, C=CHAINS, T=T_FIT, n_steps=8,
         max_abs_err={k: v[0] for k, v in vs_f64.items()},
         earlier_design_logp_err=TRAJ_EARLIER_ERR["logp_vs_f64_plain"])
    odd = [traj_odd_case(device, 4000 + i, *c) for i, c in enumerate(TRAJ_ODD_CASES)]
    emit("traj_vs_unfused", B=N_SERIES, C=CHAINS, T=T_SHORT, n_steps=8,
         max_abs_err={k: v[0] for k, v in vs_unfused.items()})
    emit("traj_vs_unfused_full_T_reported", B=N_SERIES, C=CHAINS, T=T_FIT, n_steps=8,
         max_abs_err={k: v[0] for k, v in gap_full.items()})

    t = {}
    n16 = n_t(16)
    t["launch_ms_16"] = time_ms(lambda: ct.traj_lanes(*args, eps_t, n16, CAP, CHAINS), reps=10)
    t["ms"] = t["launch_ms_16"] / 16
    one = tuple(a[:, :1].contiguous() for a in args)  # lane 0, series 0
    t["one_lane_ms"] = time_ms(lambda: ct.traj_lanes(*one, eps_t, n16, CAP, 1), reps=10) / 16
    t["plain_ms"] = time_ms(
        lambda: ct.traj_plain(*args, eps_t, n_t(2), CAP, CHAINS), reps=1, warmup=0
    ) / 2
    t["closure_ms_16"] = time_ms(lambda: traj(inv_mass, eps, 16, q, p, None, g0), reps=10)
    # a leapfrog across batch sizes, and ns a recursion step (2T steps a
    # leapfrog: the forward and the backward recursion)
    by_lanes = {}
    for n_lanes in TRAJ_TIMING_LANES:
        bx, bs = tayal_batch(max(n_lanes // CHAINS, 1), T_FIT, seed=SEED_DATA, device=device)
        cb = CHAINS if n_lanes >= CHAINS else 1
        lx, ls, lm = ct._data_lanes(bx, bs, None, device)
        la = tuple(torch.randn((ct.DIM, n_lanes), generator=gen, **f32) * s_
                   for s_ in (0.5, 0.7, 1.0))
        lim = torch.ones((ct.DIM, bx.shape[0]), **f32)
        ms = time_ms(lambda: ct.traj_lanes(*la, lim, lx, ls, lm, eps_t, n16, CAP, cb), reps=10) / 16
        by_lanes[n_lanes] = dict(ms=ms, ns_per_step=ms * 1e6 / (2 * T_FIT))
    t["by_lanes"] = by_lanes
    t["ns_per_step"] = t["ms"] * 1e6 / (2 * T_FIT)
    emit("traj_timing", shape=dict(B=N_SERIES, C=CHAINS, T=T_FIT), per="leapfrog", **t)
    b, o = traj_bytes_ops(T_FIT, N_SERIES, CHAINS, m_t, 16)
    bms, by = bound(b, o)
    err = max([v[0] for v in vs_plain.values()] + [max(c["max_abs_err"].values()) for c in odd])
    return dict(err=err, vs_unfused={k: v[0] for k, v in vs_unfused.items()},
                vs_f64={k: v[0] for k, v in vs_f64.items()},
                gap_full={k: v[0] for k, v in gap_full.items()}, timing=t,
                bound=(bms / 16, by), bytes=b, ops=o, odd_cases=len(odd))


def traj_odd_case(device, seed: int, B: int, T: int, C: int, n_steps: int):
    """``TRAJ`` against ``traj_plain`` in f32 within ``TRAJ_TOL`` on a
    simulated batch of ``B`` series x ``C`` chains, each series with a
    ragged tail and a masked head (lengths in [T/2, T], first [0, T/8]
    steps masked), random start states."""
    rng = np.random.default_rng(seed)
    x, sign = tayal_batch(B, T, seed=seed, device=device)
    valid = np.arange(T)[None] < rng.integers(max(T // 2, 1), T + 1, size=B)[:, None]
    valid &= np.arange(T)[None] >= rng.integers(0, T // 8 + 1, size=B)[:, None]
    f32 = dict(dtype=torch.float32, device=device)
    x_t, s_t, m_t = ct._data_lanes(x, sign, torch.as_tensor(valid, **f32), device)
    N = B * C
    lanes = [torch.as_tensor(sc * rng.normal(size=(ct.DIM, N)), **f32) for sc in (0.5, 0.7, 1.0)]
    im = torch.as_tensor(np.exp(0.3 * rng.normal(size=(ct.DIM, B))), **f32)
    eps = torch.tensor([0.02], **f32)
    n = torch.tensor([n_steps], dtype=torch.int32, device=device)
    got = ct.traj_lanes(*lanes, im, x_t, s_t, m_t, eps, n, CAP, C)
    want = ct.traj_plain(*lanes, im, x_t, s_t, m_t, eps, n, CAP, C)
    sync()
    e = state_errors(got, want)
    bad = {k: v for k, v in e.items() if v[1] > 0}
    if bad:
        raise AssertionError(f"trajectory B={B} T={T} C={C} n={n_steps} vs plain: {bad}")
    row = dict(B=B, T=T, C=C, n_steps=n_steps, masked_steps=int((m_t == 0).sum()),
               scratch_path=ct.traj_scratch_bytes(T, N) > 0,
               max_abs_err={k: v[0] for k, v in e.items()})
    emit("traj_vs_plain_odd", **row)
    return row


# ---------------------------------------------------------------------------
# phases 6-7: the ChEES main path, fused and unfused
# ---------------------------------------------------------------------------


class Counted:
    """A log density that counts its calls (``lp_bc`` / ``probe_vg``)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, q):
        self.calls += 1
        return self.fn(q)


class DivergenceRecorder:
    """A ``trajectory_fn`` wrapper that keeps the inputs of the first few
    lanes whose sampling-phase trajectory diverges (energy error above
    1000, or NaN, as the sampler judges it). Its outputs are the wrapped
    trajectory's, untouched."""

    def __init__(self, traj, warmup: int, keep: int = 3):
        self.traj, self.cap, self.warmup, self.keep = traj, traj.cap, warmup, keep
        self.calls, self.cases = 0, []

    def __call__(self, inv_mass, eps, n_steps, q, p, logp, grad):
        out = self.traj(inv_mass, eps, n_steps, q, p, logp, grad)
        if self.calls >= self.warmup and len(self.cases) < self.keep:
            k0 = 0.5 * (inv_mass[:, None, :] * p * p).sum(-1)
            k1 = 0.5 * (inv_mass[:, None, :] * out[1] * out[1]).sum(-1)
            d = (-out[2] + k1) - (-logp + k0)
            for b, c in ((d > 1000.0) | torch.isnan(d)).nonzero().tolist()[: self.keep - len(self.cases)]:
                self.cases.append(dict(
                    t=self.calls, b=b, c=c, eps=float(eps), n=int(n_steps), dH=float(d[b, c]),
                    q=q[b, c].cpu(), p=p[b, c].cpu(), grad=grad[b, c].cpu(),
                    inv_mass=inv_mass[b].cpu(), logp=float(logp[b, c]),
                ))
        self.calls += 1
        return out


def replay_divergence(case, x, sign):
    """Energy error of one recorded divergent trajectory on the CPU: the
    plain trajectory in float64, and the unfused log-space leapfrogs in
    float32 (the start energy uses the sampler's f32 logp)."""
    b, eps, n = case["b"], case["eps"], case["n"]
    data = {"x": x[b : b + 1].cpu(), "sign": sign[b : b + 1].cpu()}
    im, p0 = case["inv_mass"].double(), case["p"].double()
    h0 = -case["logp"] + float(0.5 * (im * p0 * p0).sum())
    x_t, s_t, m_t = ct._data_lanes(data["x"], data["sign"], None, torch.device("cpu"))
    lane = [case[k].double()[:, None] for k in ("q", "p", "grad")]
    _, p1, lp1, _ = ct.traj_plain(
        *lane, im[:, None], x_t, s_t, m_t.double(), torch.tensor([eps], dtype=torch.float64),
        torch.tensor([n]), CAP, 1,
    )
    dh64 = -float(lp1[0]) + float(0.5 * (im * p1[:, 0] ** 2).sum()) - h0
    lp_bc = make_lp_bc(TayalHHMM(), data, device="cpu")
    q, p, g = (case[k][None, None] for k in ("q", "p", "grad"))
    im32 = case["inv_mass"][None]
    for _ in range(n):
        ph = p + 0.5 * eps * g
        q = q + eps * im32[:, None, :] * ph
        lp, g = lp_bc(q)
        p = ph + 0.5 * eps * g
    dh_unfused = -float(lp) + float(0.5 * (case["inv_mass"] * p[0, 0] ** 2).sum()) - h0
    return dict(t=case["t"], series=b, chain=case["c"], eps=eps, n_steps=n,
                dH_fused_f32=case["dH"], dH_plain_f64=dh64, dH_unfused_f32=dh_unfused)


def run_chees(device, warmup, samples, fused, recorder=False, seed=SEED_SAMPLER):
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    model = TayalHHMM()  # stan gate, as bench.py --sampler chees
    init = default_init(model, data, N_SERIES, CHAINS, seed=SEED_INIT, device=device)
    cfg = ChEESConfig(num_warmup=warmup, num_samples=samples, num_chains=CHAINS,
                      max_leapfrogs=CAP)
    lp_bc = Counted(make_lp_bc(model, data, device=device))
    probe = Counted(model.make_vg({"x": x[0], "sign": sign[0]}))
    traj = ct.make_tayal_trajectory(data, cap=CAP, device=device) if fused else None
    if recorder:
        traj = DivergenceRecorder(traj, warmup)
    sync()
    before = {k.name: k.launches for k in ALL_KERNELS}
    t0 = time.perf_counter()
    qs, stats = sample_chees_batched(lp_bc, init, cfg, seed=seed, device=device,
                                     probe_vg=probe, trajectory_fn=traj)
    sync()
    wall = time.perf_counter() - t0
    rose = {k.name: k.launches - before[k.name] for k in ALL_KERNELS}
    if not bool(stats["chain_healthy"].all()):
        raise AssertionError("chees: a chain was quarantined")
    if not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError("chees: non-finite logp")
    vg_calls = lp_bc.calls + probe.calls
    if rose[cs.VG_BWD.name] != vg_calls or rose[cs.FWD.name] != vg_calls:
        raise AssertionError(f"chees: launches {rose} vs {vg_calls} value-and-grad calls")
    return model, qs, stats, wall, rose, lp_bc.calls, probe.calls, traj


def phase_chees(device, gibbs_phi):
    model, qs, stats, wall, rose, lp_calls, probe_calls, _ = run_chees(
        device, CHEES_WARMUP, CHEES_SAMPLES, fused=True
    )
    transitions = CHEES_WARMUP + CHEES_SAMPLES
    if rose[ct.TRAJ.name] != transitions:
        raise AssertionError(f"chees: {rose[ct.TRAJ.name]} trajectory launches, expected {transitions}")
    if tuple(qs.shape) != (N_SERIES, CHAINS, CHEES_SAMPLES, model.n_free):
        raise AssertionError(f"chees: qs shape {tuple(qs.shape)}")
    n_div = int(stats["diverging"].sum())
    div_share = n_div / stats["diverging"].numel()
    worst, swap_share, phi_mean, mae = fold_and_score(model, qs)
    if not mae.mean() <= PHI_MAE_MAX:
        raise AssertionError(f"chees: posterior-mean phi MAE {mae.mean():.3g} > {PHI_MAE_MAX}")
    gap = np.minimum(
        np.abs(phi_mean - gibbs_phi).mean(axis=(1, 2)),
        np.abs(phi_mean[:, MIRROR] - gibbs_phi).mean(axis=(1, 2)),
    )
    leaves = torch.cat([stats["warmup_num_leaves"][0], stats["num_leaves"][0, 0]]).float()
    emit(
        "chees",
        series=N_SERIES, T=T_FIT, chains=CHAINS, warmup=CHEES_WARMUP, samples=CHEES_SAMPLES,
        cap=CAP, seconds=wall, transitions_per_s=transitions / wall,
        series_per_s=N_SERIES / wall, transition_ms=wall / transitions * 1e3,
        step_size=float(stats["step_size"][0, 0]), traj_length=float(stats["traj_length"][0, 0]),
        leapfrogs_mean=float(leaves.mean()), leapfrogs_total=int(leaves.sum()),
        leapfrogs_sampling=float(stats["num_leaves"][0, 0].float().mean()),
        accept_mean_sampling=float(stats["accept_prob"].mean()),
        divergent_sampling=n_div, divergent_share=div_share,
        divergent_chains=int(stats["diverging"].any(-1).sum()),
        divergent_warmup=int(stats["warmup_diverging"].sum()),
        launches=rose, lp_bc_calls=lp_calls, probe_calls=probe_calls,
        logp_mean=float(stats["logp"].mean()),
        ess_worst_param_min=float(worst.min()), ess_worst_param_mean=float(worst.mean()),
        mirror_fold_share=swap_share,
        phi_mae_mean=float(mae.mean()), phi_mae_max=float(mae.max()),
        phi_gap_vs_gibbs_mean=float(gap.mean()),
    )
    return qs, stats


def phase_chees_seeds(device, stats):
    """The fused fit at the other sampler seeds of ``CHEES_SEEDS`` (the
    main path's fit is the first): every chain healthy, the emission rows
    near the simulator's in each, and divergent sampling transitions at
    most ``DIV_SHARE_MAX`` of all, over the fits of every seed."""
    counts = {CHEES_SEEDS[0]: int(stats["diverging"].sum())}
    total = stats["diverging"].numel()
    maes = {}
    for seed in CHEES_SEEDS[1:]:
        model, qs, st, _, _, _, _, _ = run_chees(device, CHEES_WARMUP, CHEES_SAMPLES, fused=True,
                                                 seed=seed)
        counts[seed] = int(st["diverging"].sum())
        total += st["diverging"].numel()
        maes[seed] = float(fold_and_score(model, qs)[3].mean())
        if not maes[seed] <= PHI_MAE_MAX:
            raise AssertionError(f"chees seed {seed}: posterior-mean phi MAE {maes[seed]:.3g}")
    share = sum(counts.values()) / total
    emit("chees_seeds", seeds=list(CHEES_SEEDS), divergent_sampling=counts, divergent_share=share,
         phi_mae_mean=maes)
    if not share <= DIV_SHARE_MAX:
        raise AssertionError(f"chees: {counts} divergent transitions over seeds, share {share:.3g}")


def phase_chees_repeat(device, qs, stats):
    """The fused fit again: the draws must be bitwise the same (the
    sampler's randomness is one seeded generator and no step sums with
    atomics), and the first divergent trajectories of the sampling phase
    are replayed on the CPU, where each must be unstable in float64 too
    (energy error above ``REPLAY_DH_MIN``): a kernel fault would diverge
    in f32 alone."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    _, qs2, stats2, _, _, _, _, rec = run_chees(
        device, CHEES_WARMUP, CHEES_SAMPLES, fused=True, recorder=True
    )
    if not (torch.equal(qs, qs2) and torch.equal(stats["diverging"], stats2["diverging"])):
        raise AssertionError("chees: a repeated fit gave other draws")
    replays = [replay_divergence(c, x, sign) for c in rec.cases]
    for r in replays:
        if not r["dH_plain_f64"] > REPLAY_DH_MIN:
            raise AssertionError(f"chees: a divergence not unstable in float64: {r}")
    emit("chees_repeat", bitwise_equal=True, divergences_replayed=replays)


def phase_chees_unfused(device):
    _, _, stats, wall, rose, lp_calls, probe_calls, _ = run_chees(
        device, UNFUSED_WARMUP, UNFUSED_SAMPLES, fused=False
    )
    leapfrogs = int(stats["warmup_num_leaves"][0].sum()) + int(stats["num_leaves"][0, 0].sum())
    if lp_calls != 1 + leapfrogs:
        raise AssertionError(f"chees_unfused: {lp_calls} lp_bc calls for {leapfrogs} leapfrogs")
    if rose[ct.TRAJ.name] != 0:
        raise AssertionError("chees_unfused: the trajectory kernel ran")
    transitions = UNFUSED_WARMUP + UNFUSED_SAMPLES
    emit(
        "chees_unfused", series=N_SERIES, T=T_FIT, chains=CHAINS, warmup=UNFUSED_WARMUP,
        samples=UNFUSED_SAMPLES, seconds=wall, transitions_per_s=transitions / wall,
        leapfrogs=leapfrogs, leapfrog_ms=wall / max(leapfrogs, 1) * 1e3,
        divergent_sampling=int(stats["diverging"].sum()),
        launches=rose, lp_bc_calls=lp_calls, probe_calls=probe_calls,
    )
    return rose


# ---------------------------------------------------------------------------
# phase 3 (cont.): the decode kernels
# ---------------------------------------------------------------------------


DECODE_KERNELS = (cs.FILTER, cs.BETA, cs.VITERBI, cs.BACKTRACK)


def make_decode_case(seed: int, N: int, T: int, K: int, device, finite: bool):
    """Lane-layout ``(pi, A, obs, mask)`` for the decode kernels:
    normalized (pi, A) with about a fifth of the A entries at
    ``MASK_NEG``, N(-1, 1) emissions, ragged mask (lengths in [T/2,
    T]). Every seventh lane is a tie lane (uniform pi and A, emissions
    rounded to integers) where the max-plus scores tie exactly. Unless
    ``finite``, a few lanes get an all -inf evidence row at a valid
    step."""
    rng = np.random.default_rng(seed)

    def log_norm(a):
        return a - np.log(np.exp(a).sum(-1, keepdims=True))

    log_pi = log_norm(rng.normal(size=(N, K)))
    log_A = log_norm(rng.normal(size=(N, K, K)))
    log_A[rng.random((N, K, K)) < 0.2] = MASK_NEG
    log_obs = rng.normal(size=(N, T, K)) - 1.0
    ties = np.arange(N) % 7 == 0
    log_pi[ties] = -np.log(K)
    log_A[ties] = -np.log(K)
    log_obs[ties] = np.round(log_obs[ties])
    lengths = rng.integers(T // 2, T + 1, size=N)
    if not finite:
        for n in rng.choice(N, size=8, replace=False):
            log_obs[n, rng.integers(0, lengths[n])] = -np.inf
    f32 = dict(dtype=torch.float32, device=device)
    mask = np.arange(T)[None, :] < lengths[:, None]
    lanes = cs.to_lanes(*(torch.as_tensor(a, **f32) for a in (log_pi, log_A, log_obs, mask)))
    return lanes[:4]


def decode_bytes_ops(kernel, lanes):
    """Bytes (inputs read once, outputs written once) and f32 operations
    (of the valid steps) of one decode kernel on these lanes; the maps
    and the path are int32."""
    pi_t, A_t, obs_t, mask_t = lanes
    T, K, N = obs_t.shape
    steps = int((mask_t[1:] > 0).sum())
    if kernel is cs.FILTER:
        # per destination: K adds, K-1 max, the -inf test, K subtracts,
        # K exps, K adds, log, 2 adds
        floats = K * N + K * K * N + T * K * N + T * N + T * K * N + N
        return 4 * floats, steps * K * (4 * K + 3) + N * (4 * K + 2)
    if kernel is cs.BETA:
        floats = K * K * N + T * K * N + T * N + T * K * N
        return 4 * floats, steps * (K + K * (4 * K + 2))
    if kernel is cs.VITERBI:
        # per destination: K adds, K-1 compares and selects, 1 add
        floats = K * N + K * K * N + T * K * N + T * N + N + K * N + T * N
        return 4 * floats, steps * K * (3 * K - 1) + N * K
    # BACKTRACK: per step a shift and a mask on the map word
    floats = T * N + K * N + T * N
    return 4 * floats, 2 * (T - 1) * N + N * K


def phase_kernels_decode(device):
    """``FILTER``, ``BETA``, ``VITERBI`` and ``BACKTRACK`` against their
    plain versions at N=8192, T=1024, K in {3, 4, 8}, and at N=256 at
    every other K in 2..32: bitwise equal (log-values, -inf at the same
    places, no NaN; maps, paths and scores identical), and ``FILTER``
    bitwise equal to ``FWD`` on finite inputs; then each timed at the
    main shape (K=4, dense mask)."""
    cases = []
    grid = [(N_DEC, K) for K in (3, 4, 8)] + [(EXTRA_DECODE_LANES, K) for K in range(2, 33)
                                              if K not in (3, 4, 8)]
    for i, (N, K) in enumerate(grid):
        for finite in (True, False):
            lanes = make_decode_case(5000 + 2 * i + finite, N, T_FIT, K, device, finite)
            pi_t, A_t, obs_t, mask_t = lanes
            ll_k, a_k = cs.filter_lanes(*lanes)
            b_k = cs.beta_lanes(A_t, obs_t, mask_t)
            sc_k, dl_k, bk_k = cs.viterbi_lanes(*lanes)
            path_k = cs.backtrack_lanes(bk_k, dl_k)
            ll_p, a_p = cs.filter_plain(*lanes)
            b_p = cs.beta_plain(A_t, obs_t, mask_t)
            sc_p, dl_p, bk_p = cs.viterbi_plain(*lanes)
            path_p = cs.backtrack_plain(bk_p, dl_p)
            path_kp = cs.backtrack_plain(bk_k, dl_k)  # the backtrack alone, same maps
            sync()
            got = {"filter": (a_k, ll_k), "beta": (b_k,), "viterbi": (sc_k, dl_k, bk_k),
                   "backtrack": (path_k,)}
            want = {"filter": (a_p, ll_p), "beta": (b_p,), "viterbi": (sc_p, dl_p, bk_p),
                    "backtrack": (path_kp,)}
            bad = [k for k in got if not all(torch.equal(a, b) for a, b in zip(got[k], want[k]))]
            nan = [k for k in ("filter", "beta") if bool(torch.isnan(got[k][0]).any())]
            if bad or nan or not torch.equal(path_k, path_p):
                raise AssertionError(
                    f"decode kernels K={K} finite={finite}: not identical to the plain "
                    f"versions {bad}, NaN in {nan}"
                )
            row = dict(N=N, K=K, finite=finite, neg_inf_alpha=int(torch.isinf(a_k).sum()),
                       neg_inf_beta=int(torch.isinf(b_k).sum()),
                       masked_steps=int((mask_t == 0).sum()))
            if finite:
                ll_f, a_f = cs.fwd_lanes(*lanes)
                sync()
                if not (torch.equal(a_f, a_k) and torch.equal(ll_f, ll_k)):
                    raise AssertionError(f"FILTER K={K}: alpha differs from FWD on finite inputs")
                row["filter_equals_fwd"] = True
            cases.append(row)
            emit("decode_kernels_vs_plain", T=T_FIT, bitwise_equal=True, **row)
            del lanes, pi_t, A_t, obs_t, mask_t, a_k, a_p, b_k, b_p, got, want

    # timing at the main shape: N=8192 lanes, T=1024, K=4, dense mask
    rng = np.random.default_rng(6000)
    f32 = dict(dtype=torch.float32, device=device)
    log_A = rng.normal(size=(N_DEC, K_TAYAL, K_TAYAL))
    log_A -= np.log(np.exp(log_A).sum(-1, keepdims=True))
    lanes = cs.to_lanes(
        torch.as_tensor(np.full((N_DEC, K_TAYAL), -np.log(K_TAYAL)), **f32),
        torch.as_tensor(log_A, **f32),
        torch.as_tensor(rng.normal(size=(N_DEC, T_FIT, K_TAYAL)) - 1.0, **f32),
        torch.ones((N_DEC, T_FIT), **f32),
    )[:4]
    pi_t, A_t, obs_t, mask_t = lanes
    _, dl, bk = cs.viterbi_lanes(*lanes)
    one = tuple(v[..., :1].contiguous() for v in lanes)
    _, dl1, bk1 = cs.viterbi_lanes(*one)
    calls = {
        cs.FILTER: (lambda L: cs.filter_lanes(*L), cs.filter_plain),
        cs.BETA: (lambda L: cs.beta_lanes(*L[1:]), lambda *L: cs.beta_plain(*L[1:])),
        cs.VITERBI: (lambda L: cs.viterbi_lanes(*L), cs.viterbi_plain),
    }
    timing = {}
    for k, (run, plain) in calls.items():
        timing[k.name] = dict(
            ms=time_ms(lambda: run(lanes), reps=20),
            one_lane_ms=time_ms(lambda: run(one), reps=20),
            plain_ms=time_ms(lambda: plain(*lanes), reps=2, warmup=1),
        )
    timing[cs.BACKTRACK.name] = dict(
        ms=time_ms(lambda: cs.backtrack_lanes(bk, dl), reps=20),
        one_lane_ms=time_ms(lambda: cs.backtrack_lanes(bk1, dl1), reps=20),
        plain_ms=time_ms(lambda: cs.backtrack_plain(bk, dl), reps=2, warmup=1),
    )
    for k in DECODE_KERNELS:
        b, o = decode_bytes_ops(k, lanes)
        timing[k.name].update(bytes=b, ops=o, bound=bound(b, o))
    emit("decode_kernel_timing", shape=dict(N=N_DEC, T=T_FIT, K=K_TAYAL),
         **{k: {f: v for f, v in t.items() if f != "bound"} for k, t in timing.items()})
    return dict(cases=cases, timing=timing)


# ---------------------------------------------------------------------------
# main path 3: the zoo's generated quantities
# ---------------------------------------------------------------------------


def launch_counts():
    return {k.name: k.launches for k in ALL_KERNELS}


def rose_since(before):
    return {n: v - before[n] for n, v in launch_counts().items() if v != before[n]}


def thin(q, n):
    """``[B, S, D]`` draws → ``n`` evenly spaced draws per series."""
    idx = torch.as_tensor(np.linspace(0, q.shape[1] - 1, n).astype(np.int64), device=q.device)
    return q[:, idx]


def check_probabilities(name, out, key):
    """Finite rows summing to 1: ``alpha`` (a softmax) within
    ``PROB_ATOL``, ``gamma`` within ``GAMMA_SUM_TOL``. Returns the
    largest deviation."""
    p = out[key]
    dev = float((p.sum(-1) - 1).abs().max())
    tol = GAMMA_SUM_TOL if key == "gamma" else PROB_ATOL
    if not bool(torch.isfinite(p).all()) or dev > tol:
        raise AssertionError(
            f"{name}: {key} rows are not probability vectors (off by {dev:.3g}, tol {tol})"
        )
    return dev


def check_decode_once(name, rose):
    """Each decode kernel launched exactly once by one ``generated``."""
    if any(rose.get(k.name, 0) != 1 for k in DECODE_KERNELS):
        raise AssertionError(f"{name}: generated launched {rose}, expected each decode kernel once")


def allocator_growth(before):
    """Device memory segments the caching allocator took from the device
    (``cudaMalloc``) since the ``torch.cuda.memory_stats()`` snapshot
    ``before``, and the bytes they added to its reserve."""
    now = torch.cuda.memory_stats()
    key, res = "segment.all.allocated", "reserved_bytes.all.allocated"
    return {"segments": now.get(key, 0) - before.get(key, 0),
            "bytes": now.get(res, 0) - before.get(res, 0)}


def generated_split(model, draws, data, device, want):
    """One warm ``model.generated``, its stages timed with a CUDA event
    (device clock) and the host clock at each boundary, taken by
    wrapping the functions the call reaches: ``smooth_dispatch`` and
    ``viterbi_dispatch`` as ``models/base.py`` calls them, ``to_lanes``
    as ``smooth_dispatch`` and ``semiring_viterbi`` call it, and the four
    kernel wrappers. Stages: unpack + ``build`` (up to
    ``smooth_dispatch``), the lane-layout copies, the four decode
    kernels, the rest of the two dispatches (the smoothing, the path's
    transpose) and the outputs (after ``viterbi_dispatch``). Each
    wrapped function must be called as often as the path calls it, and
    the outputs must equal ``want`` (the cold call's) bit for bit, so the
    stages are the path's own."""
    marks = []  # (stage entered, event, host time)

    def mark(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev, time.perf_counter()))

    def timed(fn, stage):
        def run(*args, **kwargs):
            outer = marks[-1][0]
            mark(stage)
            out = fn(*args, **kwargs)
            mark(outer)
            return out
        return run

    wraps = [(zoo_base, "smooth_dispatch", "dispatch"), (zoo_base, "viterbi_dispatch", "dispatch"),
             (td, "to_lanes", "lane_copies"), (cs, "to_lanes", "lane_copies"),
             (td, "filter_lanes", "decode_kernels"), (td, "beta_lanes", "decode_kernels"),
             (cs, "viterbi_lanes", "decode_kernels"), (cs, "backtrack_lanes", "decode_kernels")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in wraps]
    sync()
    mem = torch.cuda.memory_stats()
    try:
        for mod, name, stage in wraps:
            setattr(mod, name, timed(getattr(mod, name), stage))
        mark("generated")
        out = model.generated(draws, data, device=device)
        mark("end")
        sync()
        end = time.perf_counter()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    entered = [st for st, _, _ in marks]
    # the path: unpack + build, then smooth_dispatch (a copy, FILTER, BETA),
    # then viterbi_dispatch (a copy in semiring_viterbi, VITERBI, BACKTRACK)
    one_dispatch = ["dispatch", "lane_copies", "dispatch", "decode_kernels", "dispatch",
                    "decode_kernels", "dispatch", "generated"]
    if entered != ["generated", *one_dispatch, *one_dispatch, "end"]:
        raise AssertionError(f"generated_split: the call took {entered}, not the split's path")
    if not all(torch.equal(out[k], want[k]) for k in want):
        raise AssertionError("generated_split: the timed call differs from the cold one")
    device_ms, host_ms = {}, {}
    for i, ((stage, ev, h), (_, ev2, h2)) in enumerate(zip(marks, marks[1:])):
        # in generated itself: unpack + build before the dispatches, the
        # outputs after them (and the nothing between them)
        if stage == "generated":
            stage = "unpack_build" if i == 0 else "outputs"
        device_ms[stage] = device_ms.get(stage, 0.0) + ev.elapsed_time(ev2)
        host_ms[stage] = host_ms.get(stage, 0.0) + (h2 - h) * 1e3
    return dict(device_ms=device_ms, host_enqueue_ms=host_ms,
                total_ms=(end - marks[0][2]) * 1e3,
                device_total_ms=marks[0][1].elapsed_time(marks[-1][1]),
                allocator_growth=allocator_growth(mem))


def phase_decode_smooth(device, qs):
    """``TayalHHMM(gate_mode="hard").generated`` on 32 thinned Gibbs
    draws x 256 series (8192 lanes, T=1024): shapes, probability rows,
    states in range, each decode kernel launched once, and every output
    against the plain versions on the same lanes."""
    x, sign = tayal_batch(N_SERIES, T_FIT, seed=SEED_DATA, device=device)
    data = {"x": x, "sign": sign}
    hard = TayalHHMM(gate_mode="hard")
    draws = thin(qs[:, 0], N_DECODE_DRAWS)  # [B, 32, D]
    before = launch_counts()
    sync()
    mem = torch.cuda.memory_stats()
    t0 = time.perf_counter()
    out = hard.generated(draws, data, device=device)
    sync()
    wall = time.perf_counter() - t0
    cold_alloc = allocator_growth(mem)
    rose = rose_since(before)
    check_decode_once("decode_smooth", rose)
    B, D, T = N_SERIES, N_DECODE_DRAWS, T_FIT
    shapes = {"alpha": (B, D, T, 4), "gamma": (B, D, T, 4), "zstar": (B, D, T),
              "logp_zstar": (B, D), "loglik": (B, D)}
    for k, shp in shapes.items():
        if tuple(out[k].shape) != shp:
            raise AssertionError(f"decode_smooth: {k} shape {tuple(out[k].shape)} != {shp}")
    row_dev = {k: check_probabilities("decode_smooth", out, k) for k in ("alpha", "gamma")}
    if not bool(((out["zstar"] >= 0) & (out["zstar"] < 4)).all()):
        raise AssertionError("decode_smooth: zstar out of range")

    # the plain versions on the same lanes
    params, _ = hard.unpack(draws.reshape(N_DEC, -1))
    lanes = {k: v.repeat_interleave(D, 0) for k, v in data.items()}
    log_pi, log_A, log_obs, _ = hard.build(params, lanes)
    ones = torch.ones((N_DEC, T), dtype=torch.float32, device=device)
    pi_t, A_t, obs_t, mask_t, _, _ = cs.to_lanes(log_pi, log_A, log_obs, ones)
    ll_p, a_p = cs.filter_plain(pi_t, A_t, obs_t, mask_t)
    b_p = cs.beta_plain(A_t, obs_t, mask_t)
    sc_p, dl_p, bk_p = cs.viterbi_plain(pi_t, A_t, obs_t, mask_t)
    path_p = cs.backtrack_plain(bk_p, dl_p)
    la_p, lb_p = a_p.permute(2, 0, 1), b_p.permute(2, 0, 1)
    ref = {
        "alpha": torch.softmax(la_p, dim=-1),
        "gamma": torch.exp(smooth(la_p, lb_p)),
    }
    errs = {k: float((out[k].reshape(ref[k].shape) - v).abs().max()) for k, v in ref.items()}
    same = {
        "zstar": torch.equal(out["zstar"].reshape(N_DEC, T), path_p.t().long()),
        "logp_zstar": torch.equal(out["logp_zstar"].reshape(-1), sc_p),
        "loglik": torch.equal(out["loglik"].reshape(-1), ll_p),
    }
    if max(errs.values()) > PROB_ATOL or not all(same.values()):
        raise AssertionError(f"decode_smooth: kernels vs plain {errs}, identical {same}")
    emit("decode_smooth", lanes=N_DEC, T=T, K=4, seconds=wall, launches=rose,
         max_abs_err_vs_plain=errs, identical_vs_plain=same, row_sum_max_dev=row_dev,
         loglik_mean=float(out["loglik"].mean()))
    # the same call again, warm, stage by stage
    split = generated_split(hard, draws, data, device, out)
    emit("generated_split", lanes=N_DEC, T=T, K=4, cold_seconds=wall,
         cold_allocator_growth=cold_alloc, **split)
    return dict(out=out, data=data, lanes=(log_pi, log_A, log_obs, ones))


def check_loglik_vs_fwd(dec):
    """The decode's loglik against the ``FWD`` kernel's on the same
    (finite) lanes: the guarded and the clamped filter agree bit for bit
    there. Run after the main path's counts are read."""
    _, ll_f = cs.forward_chunked(*dec["lanes"])
    sync()
    if not torch.equal(dec["out"]["loglik"].reshape(-1), ll_f):
        raise AssertionError("decode_smooth: loglik differs from FWD's")
    emit("decode_loglik_vs_fwd", lanes=N_DEC, identical=True)


def fold_pairs(p_bull, anchor):
    """Fold the pair swap (p -> 1 - p) per draw toward a per-series
    anchor path, as ``bench.py``'s ``top_state_mean`` does:
    ``p_bull [B, D, T]``, ``anchor [B, T]``."""
    d_id = ((p_bull - anchor[:, None]) ** 2).sum(-1)
    d_sw = ((1.0 - p_bull - anchor[:, None]) ** 2).sum(-1)
    return torch.where((d_sw < d_id)[..., None], 1.0 - p_bull, p_bull)


def phase_agreement(device, dec, chees_qs):
    """The ChEES draws through the same hard-gate ``generated`` (32 a
    series from the pooled chains): posterior-mean smoothed bull-pair
    probability per series, folded against the Gibbs decode's first
    draw, compared with the Gibbs one; and the Gibbs split-half floor.
    Reported, not gated: 300 draws cannot meet ``bench.py``'s absolute
    gate."""
    B = N_SERIES
    draws = thin(chees_qs.reshape(B, -1, chees_qs.shape[-1]), N_DECODE_DRAWS)
    hard = TayalHHMM(gate_mode="hard")
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    out = hard.generated(draws, dec["data"], device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    check_decode_once("agreement", rose)
    row_dev = check_probabilities("agreement", out, "gamma")
    g_gibbs, g_chees = dec["out"]["gamma"], out["gamma"]
    p_gibbs = g_gibbs[..., 2] + g_gibbs[..., 3]  # [B, D, T]
    p_chees = g_chees[..., 2] + g_chees[..., 3]
    anchor = p_gibbs[:, 0]
    f_gibbs, f_chees = fold_pairs(p_gibbs, anchor), fold_pairs(p_chees, anchor)
    gap = (f_gibbs.mean(1) - f_chees.mean(1)).abs().mean(-1)  # [B]
    floor = (f_gibbs[:, 0::2].mean(1) - f_gibbs[:, 1::2].mean(1)).abs().mean(-1)
    emit("agreement", series=B, draws_per_series=N_DECODE_DRAWS, T=T_FIT, seconds=wall,
         launches=rose, gamma_row_sum_max_dev=row_dev,
         gap_mean=float(gap.mean()), gap_worst_series=float(gap.max()),
         gibbs_split_half_floor_mean=float(floor.mean()),
         gibbs_split_half_floor_worst=float(floor.max()),
         chees_fold_share=float((f_chees != p_chees).any(-1).float().mean()))


def phase_gaussian(device):
    """The Gaussian HMM of ``hmm/main.R`` at ``bench_zoo.py::bench_hmm``'s
    Gibbs configuration, batched to 256 series: the fit (FFBS kernels
    at K=3, once a sweep), posterior-mean mu near the truth, then
    ``generated`` (each decode kernel once; Viterbi accuracy > 0.9) and
    ``state_draws`` (FWD and BWD_SAMPLE once each)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED_GAUSS)
    z_true, x = hmm_sim(gen, G_T, G_A, np.ones(G_K) / G_K, obsmodel_gaussian(G_MU, G_SIGMA),
                        batch=(N_SERIES,))
    data = {"x": x}
    model = GaussianHMM(K=G_K, nig_prior=NIGPrior(**G_PRIOR))
    init = default_init(model, data, N_SERIES, 1, seed=SEED_INIT, device=device)
    cfg = GibbsConfig(num_warmup=G_WARMUP, num_samples=G_SAMPLES, num_chains=1)
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    qs, stats = sample_gibbs(model, data, init, cfg, seed=SEED_SAMPLER, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    sweeps = G_WARMUP + G_SAMPLES
    if rose != {cs.FWD.name: sweeps, cs.BWD_SAMPLE.name: sweeps}:
        raise AssertionError(f"gaussian: fit launches {rose}, expected {sweeps} FWD and BWD_SAMPLE")
    if not bool(stats["chain_healthy"].all()) or not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError("gaussian: an unhealthy chain or a non-finite logp")
    mu_hat = model.constrained_draws(qs)["mu_k"].mean(2)[:, 0]  # [B, K]
    mu_err = (mu_hat - torch.tensor(G_MU, device=device)).abs().max(-1).values
    if not float(mu_err.mean()) <= G_MU_TOL:
        raise AssertionError(f"gaussian: posterior-mean mu off by {float(mu_err.mean()):.3g}")

    draws = thin(qs[:, 0], N_DECODE_DRAWS)
    before = launch_counts()
    sync()
    t1 = time.perf_counter()
    out = model.generated(draws, data, device=device)
    sync()
    gen_wall = time.perf_counter() - t1
    rose_gen = rose_since(before)
    check_decode_once("gaussian", rose_gen)
    row_dev = check_probabilities("gaussian", out, "gamma")
    acc = (out["zstar"] == z_true[:, None]).float().mean(-1)  # [B, D]
    if not float(acc.mean()) > G_ACC_MIN:
        raise AssertionError(f"gaussian: Viterbi accuracy {float(acc.mean()):.4g}")

    before = launch_counts()
    gen_z = torch.Generator(device=device)
    gen_z.manual_seed(SEED_GAUSS + 1)
    sync()
    t2 = time.perf_counter()
    z_draws = model.state_draws(gen_z, draws, data, device=device)
    sync()
    sd_wall = time.perf_counter() - t2
    rose_sd = rose_since(before)
    if rose_sd != {cs.FWD.name: 1, cs.BWD_SAMPLE.name: 1}:
        raise AssertionError(f"gaussian: state_draws launched {rose_sd}")
    sd_acc = (z_draws == z_true[:, None]).float().mean()
    emit("gaussian", series=N_SERIES, T=G_T, K=G_K, warmup=G_WARMUP, samples=G_SAMPLES,
         fit_seconds=wall, sweeps_per_s=sweeps / wall, fit_launches=rose,
         mu_abs_err_mean=float(mu_err.mean()), mu_abs_err_worst=float(mu_err.max()),
         mu_hat_mean=mu_hat.mean(0).tolist(), logp_mean=float(stats["logp"].mean()),
         generated_seconds=gen_wall, generated_launches=rose_gen, gamma_row_sum_max_dev=row_dev,
         viterbi_accuracy_mean=float(acc.mean()),
         viterbi_accuracy_worst_series=float(acc.mean(-1).min()),
         state_draws_seconds=sd_wall, state_draws_launches=rose_sd,
         state_draws_accuracy_mean=float(sd_acc))


def check_zoo_vs_plain(name, model, draws, data, out, z_draws=None, seed=None):
    """``generated`` and ``state_draws`` of ``model`` on ``draws [B, D,
    n_free]`` against the plain versions on the same lanes (dense mask):
    alpha and gamma within ``PROB_ATOL``, the Viterbi path, its score and
    the loglik identical, and the state draws (if given) identical given
    the uniforms ``state_draws`` took from a generator seeded ``seed``."""
    B, D = draws.shape[:2]
    params, _ = model.unpack(draws.reshape(B * D, -1))
    lanes = {k: v.repeat_interleave(D, 0) for k, v in data.items()}
    log_pi, log_A, log_obs, _ = model.build(params, lanes)
    N, T, _ = log_obs.shape
    ones = torch.ones((N, T), dtype=torch.float32, device=log_obs.device)
    pi_t, A_t, obs_t, mask_t, _, _ = cs.to_lanes(log_pi, log_A, log_obs, ones)
    ll_p, a_p = cs.filter_plain(pi_t, A_t, obs_t, mask_t)
    b_p = cs.beta_plain(A_t, obs_t, mask_t)
    sc_p, dl_p, bk_p = cs.viterbi_plain(pi_t, A_t, obs_t, mask_t)
    path_p = cs.backtrack_plain(bk_p, dl_p)
    la_p, lb_p = a_p.permute(2, 0, 1), b_p.permute(2, 0, 1)
    ref = {"alpha": torch.softmax(la_p, dim=-1), "gamma": torch.exp(smooth(la_p, lb_p))}
    errs = {k: float((out[k].reshape(ref[k].shape) - v).abs().max()) for k, v in ref.items()}
    same = {
        "zstar": torch.equal(out["zstar"].reshape(N, T), path_p.t().long()),
        "logp_zstar": torch.equal(out["logp_zstar"].reshape(-1), sc_p),
        "loglik": torch.equal(out["loglik"].reshape(-1), ll_p),
    }
    if z_draws is not None:
        gen = torch.Generator(device=log_obs.device)
        gen.manual_seed(seed)
        u = torch.rand((N, T), generator=gen, dtype=torch.float32, device=log_obs.device)
        _, A_c, _, _, _, _ = cs.to_lanes(log_pi, log_A.clamp_min(-1e30), log_obs, ones)
        _, alpha_p = cs.fwd_plain(pi_t, A_c, obs_t, mask_t)
        z_p = cs.bwd_sample_plain(A_c, mask_t, alpha_p, u.t().contiguous())
        same["state_draws"] = torch.equal(z_draws.reshape(N, T), z_p.t().long())
    if max(errs.values()) > PROB_ATOL or not all(same.values()):
        raise AssertionError(f"{name}: kernels vs plain {errs}, identical {same}")
    return errs, same


def phase_gaussian_k(device):
    """The Gaussian HMM at each K of ``GK_KS`` (256 simulated series,
    T=500, sticky A, means 1.5 apart): a short Gibbs fit (each FFBS kernel
    once a sweep, every chain healthy), ``generated`` on ``GK_DRAWS``
    draws a series (each decode kernel once) and ``state_draws`` (``FWD``
    and ``BWD_SAMPLE`` once), every output against the plain versions on
    the same lanes."""
    for K in GK_KS:
        A = np.full((K, K), (1 - GK_STAY) / (K - 1))
        np.fill_diagonal(A, GK_STAY)
        mu = (1.5 * (np.arange(K) - (K - 1) / 2)).tolist()
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED_GAUSS + K)
        z_true, x = hmm_sim(gen, G_T, A.tolist(), np.ones(K) / K,
                            obsmodel_gaussian(mu, [GK_SIGMA] * K), batch=(N_SERIES,))
        data = {"x": x}
        model = GaussianHMM(K=K, nig_prior=NIGPrior(**G_PRIOR))
        init = default_init(model, data, N_SERIES, 1, seed=SEED_INIT, device=device)
        cfg = GibbsConfig(num_warmup=GK_WARMUP, num_samples=GK_SAMPLES, num_chains=1)
        before = launch_counts()
        sync()
        t0 = time.perf_counter()
        qs, stats = sample_gibbs(model, data, init, cfg, seed=SEED_SAMPLER, device=device)
        sync()
        wall = time.perf_counter() - t0
        rose = rose_since(before)
        sweeps = GK_WARMUP + GK_SAMPLES
        if rose != {cs.FWD.name: sweeps, cs.BWD_SAMPLE.name: sweeps}:
            raise AssertionError(f"gaussian_k K={K}: fit launches {rose}, expected {sweeps} "
                                 "FWD and BWD_SAMPLE")
        if not bool(stats["chain_healthy"].all()) or not bool(torch.isfinite(stats["logp"]).all()):
            raise AssertionError(f"gaussian_k K={K}: an unhealthy chain or a non-finite logp")

        draws = thin(qs[:, 0], GK_DRAWS)
        before = launch_counts()
        sync()
        t1 = time.perf_counter()
        out = model.generated(draws, data, device=device)
        sync()
        gen_wall = time.perf_counter() - t1
        rose_gen = rose_since(before)
        check_decode_once(f"gaussian_k K={K}", rose_gen)
        row_dev = {k: check_probabilities(f"gaussian_k K={K}", out, k) for k in ("alpha", "gamma")}
        if not bool(((out["zstar"] >= 0) & (out["zstar"] < K)).all()):
            raise AssertionError(f"gaussian_k K={K}: zstar out of range")
        before = launch_counts()
        gen_z = torch.Generator(device=device)
        gen_z.manual_seed(SEED_GAUSS + 100 + K)
        z_draws = model.state_draws(gen_z, draws, data, device=device)
        sync()
        rose_sd = rose_since(before)
        if rose_sd != {cs.FWD.name: 1, cs.BWD_SAMPLE.name: 1}:
            raise AssertionError(f"gaussian_k K={K}: state_draws launched {rose_sd}")
        errs, same = check_zoo_vs_plain(f"gaussian_k K={K}", model, draws, data, out, z_draws,
                                        SEED_GAUSS + 100 + K)
        acc = (out["zstar"] == z_true[:, None]).float().mean()
        emit("gaussian_k", series=N_SERIES, T=G_T, K=K, warmup=GK_WARMUP, samples=GK_SAMPLES,
             fit_seconds=wall, sweeps_per_s=sweeps / wall, fit_launches=rose,
             generated_seconds=gen_wall, generated_launches=rose_gen,
             state_draws_launches=rose_sd, row_sum_max_dev=row_dev,
             max_abs_err_vs_plain=errs, identical_vs_plain=same,
             viterbi_accuracy_mean=float(acc))


def phase_decode_wide(device):
    """``GaussianHMM(K=20).generated`` on 32 simulated series x 8 draws
    (the true parameters plus noise from a seed: 256 lanes, T=500): a
    warp a lane and byte-wide Viterbi maps (K above 16). Each decode
    kernel launched once, every output against the plain versions on the
    same lanes (``check_zoo_vs_plain``), and against the same call on the
    CPU within ``WIDE_*``."""
    K, S, D = K_WIDE, K_WIDE_SERIES, K_WIDE_DRAWS
    A = np.full((K, K), (1 - GK_STAY) / (K - 1))
    np.fill_diagonal(A, GK_STAY)
    mu = 1.5 * (np.arange(K) - (K - 1) / 2)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED_GAUSS + K)
    z_true, x = hmm_sim(gen, G_T, A.tolist(), np.ones(K) / K,
                        obsmodel_gaussian(mu.tolist(), [GK_SIGMA] * K), batch=(S,))
    model = GaussianHMM(K=K, nig_prior=NIGPrior(**G_PRIOR))
    f32 = dict(dtype=torch.float32, device=device)
    truth = {"p_1k": torch.full((K,), 1.0 / K, **f32), "A_ij": torch.as_tensor(A, **f32),
             "mu_k": torch.as_tensor(mu, **f32), "sigma_k": torch.full((K,), GK_SIGMA, **f32)}
    rng = np.random.default_rng(SEED_GAUSS + K)
    noise = torch.as_tensor(0.05 * rng.normal(size=(S, D, model.n_free)), **f32)
    draws = model.pack(truth) + noise
    data = {"x": x}
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    out = model.generated(draws, data, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    check_decode_once(f"decode_wide K={K}", rose)
    errs_plain, same = check_zoo_vs_plain(f"decode_wide K={K}", model, draws, data, out)
    ref = model.generated(draws.cpu(), {"x": x.cpu()}, device="cpu")
    errs = {k: float((out[k].cpu() - ref[k]).abs().max()) for k in ("alpha", "gamma")}
    ll_rel = float(((out["loglik"].cpu() - ref["loglik"]) / ref["loglik"]).abs().max())
    lp_rel = float(((out["logp_zstar"].cpu() - ref["logp_zstar"]) / ref["logp_zstar"]).abs().max())
    path_mismatch = float((out["zstar"].cpu() != ref["zstar"]).float().mean())
    finite = all(bool(torch.isfinite(out[k]).all()) for k in ("alpha", "gamma", "loglik"))
    if (not finite or max(errs.values()) > WIDE_PROB_ATOL or max(ll_rel, lp_rel) > WIDE_LL_RTOL
            or path_mismatch > WIDE_PATH_MISMATCH_MAX):
        raise AssertionError(f"decode_wide: card vs CPU {errs}, loglik {ll_rel:.3g}, logp_zstar "
                             f"{lp_rel:.3g}, path mismatch {path_mismatch:.3g}, finite {finite}")
    acc = (out["zstar"] == z_true[:, None]).float().mean()
    emit("decode_wide", series=S, draws_per_series=D, lanes=S * D, T=G_T, K=K, seconds=wall,
         launches=rose, max_abs_err_vs_plain=errs_plain, identical_vs_plain=same,
         max_abs_err_vs_cpu=errs, loglik_max_rel_err_vs_cpu=ll_rel,
         logp_zstar_max_rel_err_vs_cpu=lp_rel, zstar_mismatch_share_vs_cpu=path_mismatch,
         row_sum_max_dev=check_probabilities("decode_wide", out, "gamma"),
         viterbi_accuracy_mean=float(acc))


def phase_kernels_wide(device):
    """Every semiring kernel bitwise equal to its plain version at each K
    of ``WIDE_KS`` and (N, T) of ``WIDE_SHAPES``: ``FWD``, ``BWD_SAMPLE``
    and ``VG_BWD`` ungated and gated, ragged masks with masked runs at
    both ends; ``FILTER``, ``BETA``, ``VITERBI`` and ``BACKTRACK`` on
    ``MASK_NEG``-sparse A with tie lanes, with and without all -inf
    evidence rows (``make_decode_case``). Then each kernel timed at K=64
    on the zoo_wide lanes' shape (N=256, T=500)."""
    cases = []
    for i, K in enumerate(WIDE_KS):
        for j, (N, T) in enumerate(WIDE_SHAPES):
            for gated in (False, True):
                lanes, u_t = make_case(7000 + 8 * i + 2 * j + gated, N, T, K, gated, device,
                                       both_ends=True)
                pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
                ll_k, a_k = cs.fwd_lanes(*lanes)
                z_k = cs.bwd_sample_lanes(A_t, mask_t, a_k, u_t, gate_t, sk_t)
                vg_k = cs.vg_bwd_lanes(A_t, obs_t, mask_t, a_k, ll_k, gate_t, sk_t)
                ll_p, a_p = cs.fwd_plain(*lanes)
                z_p = cs.bwd_sample_plain(A_t, mask_t, a_p, u_t, gate_t, sk_t)
                vg_p = cs.vg_bwd_plain(A_t, obs_t, mask_t, a_p, ll_p, gate_t, sk_t)
                sync()
                same = {cs.FWD.name: torch.equal(a_k, a_p) and torch.equal(ll_k, ll_p),
                        cs.BWD_SAMPLE.name: torch.equal(z_k, z_p),
                        cs.VG_BWD.name: all(torch.equal(g, w) for g, w in zip(vg_k, vg_p))}
                if not all(same.values()):
                    raise AssertionError(f"wide K={K} N={N} T={T} gated={gated}: not bitwise "
                                         f"equal to the plain versions {same}, "
                                         f"{int((z_k != z_p).sum())} draws differ")
                cases.append(dict(K=K, N=N, T=T, gated=gated, kernels=list(same)))
            for finite in (True, False):
                lanes = make_decode_case(7500 + 8 * i + 2 * j + finite, N, T, K, device, finite)
                pi_t, A_t, obs_t, mask_t = lanes
                vit = cs.VITERBI.name
                got = {cs.FILTER.name: cs.filter_lanes(*lanes),
                       cs.BETA.name: (cs.beta_lanes(A_t, obs_t, mask_t),),
                       vit: cs.viterbi_lanes(*lanes)}
                got[cs.BACKTRACK.name] = (cs.backtrack_lanes(got[vit][2], got[vit][1]),)
                want = {cs.FILTER.name: cs.filter_plain(*lanes),
                        cs.BETA.name: (cs.beta_plain(A_t, obs_t, mask_t),),
                        vit: cs.viterbi_plain(*lanes)}
                want[cs.BACKTRACK.name] = (cs.backtrack_plain(want[vit][2], want[vit][1]),)
                sync()
                bad = [k for k in got if not all(torch.equal(a, b) for a, b in zip(got[k], want[k]))]
                if bad:
                    raise AssertionError(f"wide decode K={K} N={N} T={T} finite={finite}: not "
                                         f"identical to the plain versions {bad}")
                cases.append(dict(K=K, N=N, T=T, finite=finite, kernels=list(got)))
            emit("wide_kernels_vs_plain", K=K, N=N, T=T, bitwise_equal=True,
                 layout="warp a lane" if K <= 32 else "block a lane")
            del lanes, got, want

    # each kernel at K=64, N=256, T=500 (the zoo_wide lanes), dense mask
    lanes, u_t = make_case(7900, N_SERIES, G_T, ZW_K, False, device)
    pi_t, A_t, obs_t, mask_t, _, _ = lanes
    mask_t.fill_(1.0)
    ll, alpha = cs.fwd_lanes(*lanes)
    _, dl, bk = cs.viterbi_lanes(pi_t, A_t, obs_t, mask_t)
    calls = {
        cs.FWD.name: lambda: cs.fwd_lanes(*lanes),
        cs.BWD_SAMPLE.name: lambda: cs.bwd_sample_lanes(A_t, mask_t, alpha, u_t),
        cs.VG_BWD.name: lambda: cs.vg_bwd_lanes(A_t, obs_t, mask_t, alpha, ll),
        cs.FILTER.name: lambda: cs.filter_lanes(pi_t, A_t, obs_t, mask_t),
        cs.BETA.name: lambda: cs.beta_lanes(A_t, obs_t, mask_t),
        cs.VITERBI.name: lambda: cs.viterbi_lanes(pi_t, A_t, obs_t, mask_t),
        cs.BACKTRACK.name: lambda: cs.backtrack_lanes(bk, dl),
    }
    timing = {name: time_ms(fn, reps=5) for name, fn in calls.items()}
    emit("wide_kernel_timing", shape=dict(N=N_SERIES, T=G_T, K=ZW_K), ms=timing)
    return dict(cases=cases, timing=timing)


def phase_zoo_wide(device):
    """The Gaussian HMM at K=64 (a block a lane on the card) on 256
    simulated series, T=500 (sticky A, means 1.5 apart, as
    ``phase_gaussian_k``): a 10 + 10 Gibbs fit (``FWD`` and
    ``BWD_SAMPLE`` once a sweep, every chain healthy), ``state_draws``
    (each once), ``generated`` (each decode kernel once) on 2 draws a
    series, and one ``forward_value_and_grad`` call on the same lanes
    (``FWD`` and ``VG_BWD`` once). Every output against the plain
    versions on the same lanes on the card (bitwise); the decode and the
    value-and-grad call on the first 16 series also against the same
    calls on the CPU, within ``WIDE_*``. Returns the launch counts."""
    K = ZW_K
    A = np.full((K, K), (1 - GK_STAY) / (K - 1))
    np.fill_diagonal(A, GK_STAY)
    mu = (1.5 * (np.arange(K) - (K - 1) / 2)).tolist()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED_GAUSS + K)
    z_true, x = hmm_sim(gen, G_T, A.tolist(), np.ones(K) / K,
                        obsmodel_gaussian(mu, [GK_SIGMA] * K), batch=(N_SERIES,))
    data = {"x": x}
    model = GaussianHMM(K=K, nig_prior=NIGPrior(**G_PRIOR))
    init = default_init(model, data, N_SERIES, 1, seed=SEED_INIT, device=device)
    cfg = GibbsConfig(num_warmup=ZW_WARMUP, num_samples=ZW_SAMPLES, num_chains=1)
    counts = {}
    sync()
    t0 = time.perf_counter()
    before = launch_counts()
    qs, stats = sample_gibbs(model, data, init, cfg, seed=SEED_SAMPLER, device=device)
    sync()
    fit_wall = time.perf_counter() - t0
    counts["fit"] = rose_since(before)
    sweeps = ZW_WARMUP + ZW_SAMPLES
    if counts["fit"] != {cs.FWD.name: sweeps, cs.BWD_SAMPLE.name: sweeps}:
        raise AssertionError(f"zoo_wide: fit launches {counts['fit']}, expected {sweeps} FWD "
                             "and BWD_SAMPLE")
    if not bool(stats["chain_healthy"].all()) or not bool(torch.isfinite(stats["logp"]).all()):
        raise AssertionError("zoo_wide: an unhealthy chain or a non-finite logp")

    draws = thin(qs[:, 0], ZW_DRAWS)
    before = launch_counts()
    gen_z = torch.Generator(device=device)
    gen_z.manual_seed(SEED_GAUSS + 100 + K)
    z_draws = model.state_draws(gen_z, draws, data, device=device)
    sync()
    counts["state_draws"] = rose_since(before)
    if counts["state_draws"] != {cs.FWD.name: 1, cs.BWD_SAMPLE.name: 1}:
        raise AssertionError(f"zoo_wide: state_draws launched {counts['state_draws']}")
    before = launch_counts()
    sync()
    t1 = time.perf_counter()
    out = model.generated(draws, data, device=device)
    sync()
    gen_wall = time.perf_counter() - t1
    counts["generated"] = rose_since(before)
    check_decode_once("zoo_wide", counts["generated"])
    row_dev = {k: check_probabilities("zoo_wide", out, k) for k in ("alpha", "gamma")}
    errs_plain, same = check_zoo_vs_plain("zoo_wide", model, draws, data, out, z_draws,
                                          SEED_GAUSS + 100 + K)

    # one value-and-grad call on the decode's lanes
    B, D = draws.shape[:2]
    params, _ = model.unpack(draws.reshape(B * D, -1))
    lanes = {k: v.repeat_interleave(D, 0) for k, v in data.items()}
    log_pi, log_A, log_obs, _ = model.build(params, lanes)
    ones = torch.ones(log_obs.shape[:2], dtype=torch.float32, device=device)
    before = launch_counts()
    vg = forward_value_and_grad(log_pi, log_A, log_obs, ones)
    sync()
    counts["value_and_grad"] = rose_since(before)
    if counts["value_and_grad"] != {cs.FWD.name: 1, cs.VG_BWD.name: 1}:
        raise AssertionError(f"zoo_wide: value-and-grad launched {counts['value_and_grad']}")
    pi_t, A_t, obs_t, mask_t, _, _ = cs.to_lanes(log_pi, log_A, log_obs, ones)
    ll_p, a_p = cs.fwd_plain(pi_t, A_t, obs_t, mask_t)
    vg_p = cs.vg_bwd_plain(A_t, obs_t, mask_t, a_p, ll_p)
    sync()
    vg_lanes = (vg[0], vg[1].t(), vg[2].permute(1, 2, 0), vg[3].permute(1, 2, 0))
    if not all(torch.equal(g, w) for g, w in zip(vg_lanes, (ll_p,) + tuple(vg_p))):
        raise AssertionError("zoo_wide: value-and-grad not bitwise equal to the plain versions")

    # the first ZW_CPU_SERIES series on the CPU: decode and value-and-grad
    S, n = ZW_CPU_SERIES, ZW_CPU_SERIES * D
    ref = model.generated(draws[:S].cpu(), {"x": x[:S].cpu()}, device="cpu")
    errs = {k: float((out[k][:S].cpu() - ref[k]).abs().max()) for k in ("alpha", "gamma")}
    ll_rel = float(((out["loglik"][:S].cpu() - ref["loglik"]) / ref["loglik"]).abs().max())
    path_mismatch = float((out["zstar"][:S].cpu() != ref["zstar"]).float().mean())
    vg_cpu = forward_value_and_grad(*(t[:n].cpu() for t in (log_pi, log_A, log_obs, ones)))
    vg_errs = {
        "loglik_rel": float(((vg[0][:n].cpu() - vg_cpu[0]) / vg_cpu[0]).abs().max()),
        "d_pi": float((vg[1][:n].cpu() - vg_cpu[1]).abs().max()),
        "d_obs": float((vg[3][:n].cpu() - vg_cpu[3]).abs().max()),
        "d_A_rel": float((vg[2][:n].cpu() - vg_cpu[2]).abs().max() / vg_cpu[2].abs().max()),
    }
    if (max(errs.values()) > WIDE_PROB_ATOL or ll_rel > WIDE_LL_RTOL
            or path_mismatch > WIDE_PATH_MISMATCH_MAX or vg_errs["loglik_rel"] > WIDE_LL_RTOL
            or max(vg_errs["d_pi"], vg_errs["d_obs"]) > WIDE_PROB_ATOL
            or vg_errs["d_A_rel"] > WIDE_DA_RTOL):
        raise AssertionError(f"zoo_wide: card vs CPU {errs}, loglik {ll_rel:.3g}, path mismatch "
                             f"{path_mismatch:.3g}, value-and-grad {vg_errs}")
    acc = (out["zstar"] == z_true[:, None]).float().mean()
    emit("zoo_wide", series=N_SERIES, T=G_T, K=K, warmup=ZW_WARMUP, samples=ZW_SAMPLES,
         draws_per_series=D, fit_seconds=fit_wall, sweeps_per_s=sweeps / fit_wall,
         generated_seconds=gen_wall, launches=counts, row_sum_max_dev=row_dev,
         max_abs_err_vs_plain=errs_plain, identical_vs_plain=same,
         value_and_grad_identical_vs_plain=True, cpu_series=S, max_abs_err_vs_cpu=errs,
         loglik_max_rel_err_vs_cpu=ll_rel, zstar_mismatch_share_vs_cpu=path_mismatch,
         value_and_grad_err_vs_cpu=vg_errs, viterbi_accuracy_mean=float(acc))
    return counts


# ---------------------------------------------------------------------------
# main path 5: the Tayal walk-forward back-test
# ---------------------------------------------------------------------------


class LaneRecorder:
    """Wraps the lane wrappers of ``FWD``, ``BWD_SAMPLE`` and ``VG_BWD``
    for a ``with`` block: keeps a copy of the inputs and outputs of the
    first launch at each shape and gate the path gives a kernel (the
    lanes, uniforms and gate keys the path made), for the check against
    the plain versions and the timing."""

    # kernel: (wrapper, plain version, position of the [T, K, N] input,
    # position of the gate keys)
    SPEC = {cs.FWD.name: ("fwd_lanes", cs.fwd_plain, 2, 4),
            cs.BWD_SAMPLE.name: ("bwd_sample_lanes", cs.bwd_sample_plain, 2, 4),
            cs.VG_BWD.name: ("vg_bwd_lanes", cs.vg_bwd_plain, 1, 5)}

    def __init__(self):
        self.calls, self.stack = {}, ExitStack()

    def wrap(self, name, fn):
        _, _, at, gate = self.SPEC[name]

        def recorded(*args):
            out = fn(*args)
            T, K, N = args[at].shape
            key = (name, int(N), int(T), int(K), len(args) > gate and args[gate] is not None)
            if key not in self.calls:
                self.calls[key] = (tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                                   tuple(o.clone() for o in as_tuple(out)))
            return out

        return recorded

    def __enter__(self):
        for name, (wrapper, _, _, _) in self.SPEC.items():
            self.stack.enter_context(
                mock.patch.object(cs, wrapper, self.wrap(name, getattr(cs, wrapper))))
        return self

    def __exit__(self, *exc):
        self.stack.close()


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


class FitRecorder:
    """Wraps ``wf.py``'s ``fit_batched``: each fit group's shape, its
    time on the host clock (synchronized) and its chains' health, and in
    ``lanes`` the kernel launches each group made (:class:`LaneRecorder`)."""

    def __init__(self, fit):
        self.fit, self.groups, self.lanes = fit, [], []

    def __call__(self, model, data, config, **kw):
        sync()
        t0 = time.perf_counter()
        with LaneRecorder() as rec:
            qs, stats = self.fit(model, data, config, **kw)
        sync()
        legs = data["mask"].sum(1)
        self.groups.append({
            "series": int(legs.shape[0]), "T": int(data["mask"].shape[1]),
            "legs_min": int(legs.min()), "legs_max": int(legs.max()),
            "seconds": time.perf_counter() - t0,
            "healthy": bool(stats["chain_healthy"].all()),
            "logp_finite": bool(torch.isfinite(stats["logp"]).all()),
        })
        self.lanes.append(rec.calls)
        return qs, stats


class KeptFiltered:
    """Side effect of ``TayalHHMMLite.filtered`` (the decode's two ``FWD``
    launches): counts the calls and keeps the inputs and outputs of the
    first call and of the first at the largest bucket pair, for the
    check against the plain versions."""

    def __init__(self, fn):
        self.fn, self.calls, self.first, self.largest = fn, 0, None, None

    def __call__(self, model, theta, data, device=None):
        out = self.fn(model, theta, data, device=device)
        self.calls += 1
        kept = (model, theta, dict(data), out)
        if self.first is None:
            self.first = kept
        if self.largest is None or buckets(data) > buckets(self.largest[2]):
            self.largest = kept
        return out

    def kept(self):
        """The first call, and the largest if it is another."""
        return [self.first] + ([self.largest] if self.largest is not self.first else [])


def buckets(data):
    return data["x"].shape[-1], data["x_oos"].shape[-1]


class VGCounter:
    """Side effect of ``make_vg``: every value-and-grad function it
    returns counts its calls (``make_lp_bc``'s and the step-size
    probe's)."""

    def __init__(self, make_vg):
        self.make_vg, self.calls = make_vg, 0

    def __call__(self, model, data):
        fn = self.make_vg(model, data)

        def counted(q):
            self.calls += 1
            return fn(q)

        return counted


def wf_tasks():
    """``(tasks, seconds)``: the walk-forward windows of ``WF_SYMBOLS`` x
    ``WF_DAYS`` days of ``simulate_ticks`` (legs a day spread evenly in
    log over ``WF_LEGS_PER_DAY`` by symbol, +-10 % a day), and the host
    time it took to simulate them."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED_WF)
    legs = np.geomspace(*WF_LEGS_PER_DAY, WF_SYMBOLS)
    days = {
        f"S{s:02d}": [
            dict(zip(("price", "size", "t_seconds"),
                     simulate_ticks(rng, n_legs=int(n * rng.uniform(0.9, 1.1)))[:3]))
            for _ in range(WF_DAYS)
        ]
        for s, n in enumerate(legs)
    }
    tasks = build_tasks(days, train_days=WF_TRAIN_DAYS, trade_days=WF_TRADE_DAYS)
    return tasks, time.perf_counter() - t0


def wf_decode_vs_plain(kept, arm):
    """A decode dispatch again through ``fwd_plain`` on the same lanes on
    the card, then the same median and argmax: the filtered
    probabilities bitwise and the leg states identical."""
    model, theta, data, out = kept
    gated = False
    lead, flat, lanes = zoo_base.draw_lanes(theta, data, theta.device)
    params, _ = model.unpack(flat)
    errs = {}
    for key, (xk, sk, mk) in (("alpha", ("x", "sign", "mask")),
                              ("alpha_oos", ("x_oos", "sign_oos", "mask_oos"))):
        seg = {"x": lanes[xk], "sign": lanes[sk]}
        log_pi, log_A, log_obs, _ = model.build_vg(params, seg)
        gk = model.gate_keys(seg)
        gated = gk is not None
        _, a_plain = cs.fwd_plain(*cs.to_lanes(log_pi, log_A, log_obs, lanes[mk],
                                               *(gk if gated else ())))
        probs = torch.softmax(a_plain.permute(2, 0, 1), dim=-1).reshape(out[key].shape)
        errs[key] = float((probs - out[key]).abs().max())
        if not torch.equal(median_states(probs), median_states(out[key])):
            raise AssertionError(f"{arm}: {key} leg states differ from the plain version's")
    if max(errs.values()) != 0.0:
        raise AssertionError(f"{arm}: decode not bitwise equal to fwd_plain: {errs}")
    return {"lanes": int(flat.shape[0]), "T": int(data["x"].shape[1]),
            "T_oos": int(data["x_oos"].shape[1]), "gated": gated,
            "max_abs_err": errs}


def wf_run(tasks, config, gate_mode, chunk, device):
    """``wf_trade`` with the recorders in place: ``(results,
    phase_timings, wall seconds, fit recorder, filtered calls and kept
    calls, value-and-grad calls, launches, native series)``."""
    rec = FitRecorder(wf_module.fit_batched)
    filt = KeptFiltered(TayalHHMMLite.filtered)
    vg = VGCounter(TayalHHMMLite.make_vg)
    phases = {}
    native0 = native_zigzag.series_extracted
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    with mock.patch.object(wf_module, "fit_batched", rec), \
            mock.patch.object(TayalHHMMLite, "filtered", autospec=True, side_effect=filt), \
            mock.patch.object(TayalHHMMLite, "make_vg", autospec=True, side_effect=vg):
        res = wf_trade(tasks, config, gate_mode=gate_mode, chunk_size=chunk,
                       phase_timings=phases, seed=SEED_WF, device=device)
    sync()
    wall = time.perf_counter() - t0
    rose = rose_since(before)
    return (res, phases, wall, rec, filt, vg.calls, rose,
            native_zigzag.series_extracted - native0)


def wf_returns(res, lags):
    """Mean over tasks of the compounded OOS return a lag, and of
    buy-and-hold, in percent."""
    out = {str(lag): float(np.mean([100 * (equity_curve(r.trades[lag].ret)[-1] - 1)
                                    if len(r.trades[lag]) else 0.0 for r in res]))
           for lag in lags}
    out["buy_and_hold"] = float(np.mean([100 * (equity_curve(r.bnh)[-1] - 1) for r in res]))
    return out


def phase_walk_forward(device, tasks, data_s):
    """The fifth main path: ``apps/tayal/wf.py::wf_trade`` on the
    ``WF_TASKS`` simulated windows of :func:`wf_tasks` at full width
    (K=4, L=9): native zig-zag features, length-sorted 1024-bucket Gibbs
    fits (hard gate, one chain, 100 + 300 sweeps, 64 windows a group),
    the batched median-alpha decode and the host trading. Then its ChEES
    arm (stan gate) on 16 of the tasks. Returns the fit groups for the
    kernels' check at the shapes they ran."""
    if len(tasks) != WF_TASKS:
        raise AssertionError(f"walk_forward: {len(tasks)} tasks, expected {WF_TASKS}")
    lags = (0, 1, 2, 3, 4, 5)
    cfg = GibbsConfig(num_warmup=WF_WARMUP, num_samples=WF_SAMPLES, num_chains=1)
    res, phases, wall, fits, filt, _, rose, native = wf_run(tasks, cfg, "hard", WF_CHUNK, device)
    groups = fits.groups
    if native != len(tasks):
        raise AssertionError(f"walk_forward: the native extractor took {native} of {len(tasks)} "
                             "series (the NumPy engine ran)")
    sweeps = WF_WARMUP + WF_SAMPLES
    n_groups = -(-len(tasks) // WF_CHUNK)
    dispatches = phases["decode.dispatches"]
    want = {cs.FWD.name: sweeps * n_groups + 2 * dispatches, cs.BWD_SAMPLE.name: sweeps * n_groups}
    if len(groups) != n_groups or rose != want or filt.calls != dispatches:
        raise AssertionError(f"walk_forward: launches {rose} over {len(groups)} fit groups and "
                             f"{filt.calls} filtered calls, expected {want}")
    if not all(g["healthy"] and g["logp_finite"] for g in groups):
        raise AssertionError(f"walk_forward: an unhealthy chain or a non-finite logp: {groups}")
    for r in res:
        if not np.isfinite(r.bnh).all() or set(r.trades) != set(lags) or r.chains_pooled != 1:
            raise AssertionError(f"walk_forward: task {r.symbol}/{r.window}: bnh finite "
                                 f"{np.isfinite(r.bnh).all()}, lags {sorted(r.trades)}")
        if len(r.leg_topstate) != r.n_ins_legs + r.n_oos_legs:
            raise AssertionError(f"walk_forward: task {r.symbol}/{r.window} leg states")
    plain = [wf_decode_vs_plain(k, "walk_forward") for k in filt.kept()]
    filt.first = filt.largest = None
    ins = np.array([r.n_ins_legs for r in res])
    oos = np.array([r.n_oos_legs for r in res])
    fit_s = sum(g["seconds"] for g in groups)
    emit("walk_forward", tasks=len(tasks), symbols=WF_SYMBOLS, days=WF_DAYS,
         train_days=WF_TRAIN_DAYS, trade_days=WF_TRADE_DAYS, gate_mode="hard",
         warmup=WF_WARMUP, samples=WF_SAMPLES, chunk=WF_CHUNK, data_seconds=data_s,
         seconds=wall, phase_timings=phases, native_series=native,
         legs_in_sample=dict(min=int(ins.min()), median=float(np.median(ins)), max=int(ins.max())),
         legs_oos=dict(min=int(oos.min()), median=float(np.median(oos)), max=int(oos.max())),
         fit_groups=[dict(g, sweeps_per_s=sweeps / g["seconds"]) for g in groups],
         fit_sweeps_per_s=sweeps * n_groups / fit_s,
         decode_dispatches=dispatches, decode_lanes_a_dispatch=G_DEC * D_DEC,
         decode_shapes=phases["decode.shapes_pending"], launches=rose,
         decode_vs_plain=plain, swapped=int(sum(r.swapped for r in res)),
         oos_leg_switches_mean=float(np.mean([r.oos_leg_switches for r in res])),
         oos_return_pct_mean=wf_returns(res, lags))

    # the ChEES arm (the Stan-parity model): one value-and-grad call a
    # leapfrog, no fused trajectory, as the JAX fit_batched runs it
    sub = tasks[::WF_CHEES_STRIDE][:WF_CHEES_TASKS]
    ccfg = ChEESConfig(num_warmup=WF_CHEES_WARMUP, num_samples=WF_CHEES_SAMPLES,
                       num_chains=CHAINS, max_leapfrogs=CAP)
    res_c, phases_c, wall_c, fits_c, filt_c, vg_calls, rose_c, _ = wf_run(
        sub, ccfg, "stan", WF_CHEES_CHUNK, device)
    groups_c = fits_c.groups
    want_c = {cs.FWD.name: vg_calls + 2 * phases_c["decode.dispatches"], cs.VG_BWD.name: vg_calls}
    # (a dispatch holding a task whose basin selection kept fewer than
    # D_DEC draws decodes through generated, also two FWD launches)
    if rose_c != want_c:
        raise AssertionError(f"walk_forward_chees: launches {rose_c}, expected {want_c}")
    if not all(g["healthy"] and g["logp_finite"] for g in groups_c):
        raise AssertionError(f"walk_forward_chees: an unhealthy chain: {groups_c}")
    div = float(np.mean([r.diverged for r in res_c]))
    if not div < WF_DIV_MAX or not all(np.isfinite(r.bnh).all() for r in res_c):
        raise AssertionError(f"walk_forward_chees: divergent share {div:.3g} (limit {WF_DIV_MAX})")
    plain_c = [wf_decode_vs_plain(k, "walk_forward_chees") for k in filt_c.kept()]
    filt_c.first = filt_c.largest = None
    emit("walk_forward_chees", tasks=len(sub), gate_mode="stan", chains=CHAINS, cap=CAP,
         warmup=WF_CHEES_WARMUP, samples=WF_CHEES_SAMPLES, chunk=WF_CHEES_CHUNK,
         seconds=wall_c, phase_timings=phases_c, fit_groups=groups_c,
         value_and_grad_calls=vg_calls, decode_dispatches=phases_c["decode.dispatches"],
         decode_dispatches_under_filled=phases_c["decode.dispatches"] - filt_c.calls,
         value_and_grad_ms=sum(g["seconds"] for g in groups_c) / max(vg_calls, 1) * 1e3,
         launches=rose_c, decode_vs_plain=plain_c, divergent_share=div,
         divergent_share_max_task=float(max(r.diverged for r in res_c)),
         chains_pooled_mean=float(np.mean([r.chains_pooled for r in res_c])),
         oos_return_pct_mean=wf_returns(res_c, lags))
    return fits, fits_c


def phase_walk_forward_kernels(fits, fits_c):
    """The kernels at the shapes and gates the walk-forward fits gave
    them: the first launch of ``FWD``, ``BWD_SAMPLE`` and ``VG_BWD`` at
    each shape of each Gibbs and ChEES fit group, its inputs as the path
    made them, held bitwise against the plain version on the same
    inputs (``BWD_SAMPLE`` on the same alpha and uniforms; past T=2048
    its device-scratch path) and timed on them; a Gibbs group's kernel
    pair as a share of its sweep."""
    out = {}
    for arm, rec in (("gibbs", fits), ("chees", fits_c)):
        rows = []
        for g, calls in zip(rec.groups, rec.lanes):
            kernels = []
            for (name, N, T, K, gated), (args, got) in calls.items():
                wrapper, plain, _, _ = LaneRecorder.SPEC[name]
                want = as_tuple(plain(*args))
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]
                    raise AssertionError(f"walk_forward_kernels: {name} N={N} T={T} K={K} "
                                         f"gated={gated} in a {arm} fit group not bitwise "
                                         f"equal to its plain version, max abs errs {errs}")
                fn = getattr(cs, wrapper)
                kernels.append(dict(kernel=name, N=N, T=T, K=K, gated=gated, bitwise_equal=True,
                                    ms=time_ms(lambda: fn(*args), reps=10)))
            row = dict(series=g["series"], T=g["T"], launches=kernels)
            if arm == "gibbs":  # a sweep: one FWD and one BWD_SAMPLE at the group's lanes
                pair = [k for k in kernels if k["N"] == g["series"] and k["T"] == g["T"]]
                if sorted(k["kernel"] for k in pair) != sorted((cs.FWD.name, cs.BWD_SAMPLE.name)):
                    raise AssertionError(f"walk_forward_kernels: a Gibbs group's launches {kernels}")
                row["sweep_ms"] = g["seconds"] / (WF_WARMUP + WF_SAMPLES) * 1e3
                row["kernel_share"] = sum(k["ms"] for k in pair) / row["sweep_ms"]
            rows.append(row)
        rec.lanes = []
        out[arm] = rows
    emit("walk_forward_kernels", **out)
    return out


def ptxas_usage(log: str) -> dict:
    """``{kernel<template args>: [registers, spill store bytes, spill load
    bytes, static shared bytes]}`` from an ``nvcc -Xptxas -v`` log (its
    entries named from the mangled symbols: ``Li16E`` is 16, ``Lb1E``
    true)."""
    usage, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?(?<=\d)([a-z_]+_kernel)I(\w*?)EEv", ln)
        if m:
            args = re.findall(r"L([ib])(\d+)E", m.group(2))
            vals = [str(int(v)) if t == "i" else ("true" if v == "1" else "false") for t, v in args]
            name = f"{m.group(1)}<{','.join(vals)}>"
            usage[name] = [None, 0, 0, 0]
        elif name and "spill" in ln:
            st = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if st:
                usage[name][1:3] = [int(st.group(1)), int(st.group(2))]
        elif name and "Used" in ln:
            r = re.search(r"Used (\d+) registers", ln)
            if r:
                usage[name][0] = int(r.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            if sm:
                usage[name][3] = int(sm.group(1))
    return usage


# the K of the kernel table's resource columns, and the main path's shape
# for the two kernels whose dynamic shared memory depends on it
TABLE_KS = (4, 16, 32, 64, 128)


def dynamic_smem(kernel, K: int, T: int = T_FIT, N: int = N_DEC) -> int:
    """Bytes of dynamic shared memory a block of ``kernel`` takes at K
    (the kernels' own formulas: wide_core.cuh's wide_smem_bytes,
    ffbs_bwd_sample.cu's smem_stride and wide_bwd_smem_bytes,
    semiring_viterbi.cu's bt_smem_bytes); the group kernels take none."""
    if kernel is cs.BWD_SAMPLE:
        if K <= 16:  # kLanes rows of W map_words(T) + 8 words, if they fit 2048 a lane
            W, words = -(-K // 8), -(-T // 32) * 32
            return 0 if W * words > 2048 else 4 * 4 * (W * words + 8)
        return 4 * (K * K + 32 * (K + 3)) + 32 * K
    if kernel is cs.BACKTRACK:  # up to 32 lanes a block, a block an SM, at most 100 KB
        W = 1 if K <= 8 else 2 if K <= 16 else -(-K // 4)
        chunk, stages = (64, 4) if K <= 16 else (32, 3)

        def ring(lanes):
            return 4 * (stages * lanes * (chunk * W + 4) + 2 * chunk * lanes)

        lanes = 32
        while lanes > 1 and (-(-N // lanes) < 132 or ring(lanes) > 100 * 1024):
            lanes //= 2
        return ring(lanes)
    if K <= 32:
        return 0
    return 4 * (2 * K * K + 3 * K) if kernel is cs.VG_BWD else 4 * (K * K + 2 * K)


def kernel_resources(usage) -> dict:
    """Per semiring kernel and K of ``TABLE_KS``: the instantiation that
    runs (ungated), its registers, spill bytes (stores, loads), static
    shared bytes and dynamic shared bytes."""
    def inst(k, K):
        if k is cs.BACKTRACK:
            return f"viterbi_backtrack_kernel<{1 if K <= 8 else 2 if K <= 16 else 0}>"
        if k is cs.BWD_SAMPLE:
            return (f"ffbs_bwd_sample_kernel<{K},false>" if K <= 16
                    else "ffbs_bwd_sample_wide_kernel<false>")
        mode = {cs.FWD: "0", cs.FILTER: "1", cs.VITERBI: "2"}.get(k)
        if mode is not None:
            return (f"forward_kernel<{K},{mode},false>" if K <= 32
                    else f"wide_forward_kernel<{mode},false>")
        vg = "true" if k is cs.VG_BWD else "false"
        return f"beta_kernel<{K},{vg},false>" if K <= 32 else f"wide_beta_kernel<{vg},false>"

    out = {}
    for k in cs.KERNELS:
        rows = {}
        for K in TABLE_KS:
            name = inst(k, K)
            regs, st, ld, static = usage.get(k.source.name, {}).get(name) or [None] * 4
            rows[K] = dict(instance=name, registers=regs, spill_stores=st, spill_loads=ld,
                           static_smem=static, dynamic_smem=dynamic_smem(k, K))
        out[k.name] = rows
    return out


def reset_all() -> None:
    for k in ALL_KERNELS:
        k.launches = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # the walk-forward ticks are simulated on a host thread while nvcc
    # builds (the build waits on its compilers, so the two overlap)
    sim_pool = ThreadPoolExecutor(max_workers=1)
    sim = sim_pool.submit(wf_tasks)
    sim_pool.shutdown(wait=False)
    t0 = time.perf_counter()
    report = build_and_load(ALL_KERNELS)
    per_source = {s: {"seconds": r["seconds"], "cached": r["cached"]} for s, r in report.items()}
    emit("build", seconds=time.perf_counter() - t0, per_source=per_source)
    usage = {src: ptxas_usage(r["log"]) for src, r in report.items()}
    emit("ptxas", **usage)
    # the forward core (fwd_core.cuh) in its three modes (0 clamped: FWD,
    # ungated and gated; 1 guarded: FILTER; 2 max-plus: VITERBI) at K=4,
    # 16 and, for the decode, 32: registers, spill store and load bytes
    # (None for a cached build)
    emit("ptxas_fwd_core", **{
        f"{mode}_K{K}": usage[k.source.name].get(f"forward_kernel<{K},{args}>")
        for mode, k, args, ks in (
            ("fwd", cs.FWD, "0,false", (4, 16)), ("fwd_gated", cs.FWD, "0,true", (4, 16)),
            ("filter", cs.FILTER, "1,false", (4, 16, 32)),
            ("viterbi", cs.VITERBI, "2,false", (4, 16, 32)))
        for K in ks})

    emit("kernel_resources", K=list(TABLE_KS), **kernel_resources(usage))

    kern = phase_kernels(device)
    vgk = phase_kernels_vg(device)
    trk = phase_kernels_traj(device)

    # main path 1, the Gibbs fit and its decode: counts from zero, read
    # after the decode
    reset_all()
    qs, gibbs_phi = phase_fit(device, kern["timing"]["fwd_ms"] + kern["timing"]["bwd_ms"])
    phase_decode(device, qs)
    gibbs = {k.name: k.launches for k in ALL_KERNELS}
    # main path 2, the fused ChEES fit
    reset_all()
    chees_qs, chees_stats = phase_chees(device, gibbs_phi)
    chees = {k.name: k.launches for k in ALL_KERNELS}
    phase_chees_repeat(device, chees_qs, chees_stats)
    phase_chees_seeds(device, chees_stats)
    # its unfused form
    reset_all()
    phase_chees_unfused(device)
    unfused = {k.name: k.launches for k in ALL_KERNELS}
    deck = phase_kernels_decode(device)
    widek = phase_kernels_wide(device)
    # main path 3, the zoo's generated quantities: the hard-gate Tayal
    # decode of the Gibbs draws, the same decode of the ChEES draws, and
    # the Gaussian HMM's fit, decode and state draws
    reset_all()
    dec = phase_decode_smooth(device, qs)
    phase_agreement(device, dec, chees_qs)
    phase_gaussian(device)
    phase_gaussian_k(device)
    phase_decode_wide(device)
    zoo = {k.name: k.launches for k in ALL_KERNELS}
    check_loglik_vs_fwd(dec)
    del dec
    # main path 4, the zoo above K=32: the K=64 Gaussian HMM's fit, state
    # draws, decode and value-and-grad, every semiring kernel a block a lane
    reset_all()
    phase_zoo_wide(device)
    zoo_wide = {k.name: k.launches for k in ALL_KERNELS}
    # main path 5, the walk-forward back-test: features, batched fits,
    # the median-alpha decode and the trades of 204 windows, then the
    # ChEES arm on 16 of them
    wf_task_list, wf_data_s = sim.result()
    reset_all()
    wf_fits = phase_walk_forward(device, wf_task_list, wf_data_s)
    walk = {k.name: k.launches for k in ALL_KERNELS}
    phase_walk_forward_kernels(*wf_fits)
    del wf_fits
    missing = [n for n in (cs.FWD.name, cs.BWD_SAMPLE.name) if gibbs[n] == 0]
    missing += [n for n in (cs.FWD.name, cs.VG_BWD.name, ct.TRAJ.name) if chees[n] == 0]
    missing += [n for n in (cs.FWD.name, cs.VG_BWD.name) if unfused[n] == 0]
    missing += [k.name for k in (cs.FWD, cs.BWD_SAMPLE) + DECODE_KERNELS if zoo[k.name] == 0]
    missing += [f"{k.name} (zoo_wide)" for k in cs.KERNELS if zoo_wide[k.name] == 0]
    missing += [f"{k.name} (walk_forward)" for k in (cs.FWD, cs.BWD_SAMPLE, cs.VG_BWD)
                if walk[k.name] == 0]
    if missing:
        raise AssertionError(f"a main path never launched {missing}")

    t = kern["timing"]
    vt, tt, dt = vgk["timing"], trk["timing"], deck["timing"]
    rows = []
    for k, launches, ms, plain, (bms, by), err, extra in (
        (cs.FWD, gibbs[cs.FWD.name], t["fwd_ms"], t["fwd_plain_ms"], kern["fwd_bound"],
         kern["fwd_err"],
         dict(ns_per_step=t["fwd_ms"] * 1e6 / T_FIT, one_lane_ms=t["fwd_one_lane_ms"],
              one_lane_ns_per_step=t["fwd_one_lane_ms"] * 1e6 / T_FIT,
              decode_gated_2048_ms=t["fwd_decode_gated_2048_ms"],
              by_lanes={n: {k: v for k, v in r.items() if k.startswith("fwd")}
                        for n, r in t["by_lanes"].items()},
              launches_chees=chees[cs.FWD.name], launches_chees_unfused=unfused[cs.FWD.name],
              bitwise_equal_cases=len(kern["cases"]),
              bytes=kern["fwd_bytes"], ops=kern["fwd_ops"])),
        (cs.BWD_SAMPLE, gibbs[cs.BWD_SAMPLE.name], t["bwd_ms"], t["bwd_plain_ms"],
         kern["bwd_bound"], kern["z_err"],
         dict(ns_per_step=t["bwd_ms"] * 1e6 / T_FIT, one_lane_ms=t["bwd_one_lane_ms"],
              one_lane_ns_per_step=t["bwd_one_lane_ms"] * 1e6 / T_FIT,
              by_lanes={n: {k: v for k, v in r.items() if k.startswith("bwd")}
                        for n, r in t["by_lanes"].items()},
              ffbs_wrapper_ms=t["ffbs_wrapper_ms"], bitwise_equal_cases=len(kern["cases"]),
              bytes=kern["bwd_bytes"], ops=kern["bwd_ops"])),
        (cs.VG_BWD, chees[cs.VG_BWD.name], vt["ms"], vt["plain_ms"], vgk["bound"],
         max(vgk["err"]["d_pi"], vgk["err"]["d_obs"], vgk["err"]["d_A"]),
         dict(one_lane_ms=vt["one_lane_ms"], launches_chees_unfused=unfused[cs.VG_BWD.name],
              max_errs=vgk["err"], fwd_ms_same_lanes=vt["fwd_ms"], lp_bc_ms=vt["lp_bc_ms"],
              bytes=vgk["bytes"], ops=vgk["ops"])),
        (ct.TRAJ, chees[ct.TRAJ.name], tt["ms"], tt["plain_ms"], trk["bound"], trk["err"],
         dict(per="leapfrog", one_lane_ms=tt["one_lane_ms"], launch_ms_16=tt["launch_ms_16"],
              ns_per_step=tt["ns_per_step"], by_lanes=tt["by_lanes"],
              odd_cases_vs_plain=trk["odd_cases"],
              closure_ms_16=tt["closure_ms_16"], max_abs_err_vs_f64_plain_8=trk["vs_f64"],
              max_abs_err_vs_unfused_T64=trk["vs_unfused"],
              max_abs_err_vs_unfused_T1024=trk["gap_full"],
              bytes_16=trk["bytes"], ops_16=trk["ops"])),
        *(
            (k, zoo[k.name], dt[k.name]["ms"], dt[k.name]["plain_ms"], dt[k.name]["bound"], 0.0,
             dict(one_lane_ms=dt[k.name]["one_lane_ms"], bytes=dt[k.name]["bytes"],
                  ops=dt[k.name]["ops"], bitwise_equal_cases=len(deck["cases"]),
                  shape=dict(N=N_DEC, T=T_FIT, K=K_TAYAL)))
            for k in DECODE_KERNELS
        ),
    ):
        rows.append({
            "name": k.name,
            "route": "cuda",
            "source": str(k.source.relative_to(k.source.parents[3])),
            "replaces": k.replaces,
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": None,
            **extra,
        })
        if k in cs.KERNELS:  # the semiring kernels' K range, and K=64 (a block a lane)
            rows[-1].update(k_range=list(cs.K_RANGE), ms_k64=widek["timing"][k.name],
                            shape_k64=dict(N=N_SERIES, T=G_T, K=ZW_K),
                            launches_zoo_wide=zoo_wide[k.name],
                            bitwise_equal_cases_above_16=sum(
                                k.name in c["kernels"] for c in widek["cases"]))
        if k in (cs.FWD, cs.BWD_SAMPLE, cs.VG_BWD):
            rows[-1]["launches_walk_forward"] = walk[k.name]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
