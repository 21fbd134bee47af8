#!/usr/bin/env python3
"""Time this checkout's hand-written kernels against the same kernels
built from another source directory, and against variants of this
checkout's constants, in turns on one CUDA card: the FFBS pair (``FWD``:
``ffbs_fwd.cu``, ``BWD_SAMPLE``: ``ffbs_bwd_sample.cu``), the fused
trajectory kernel (``TRAJ``: ``tayal_traj.cu``), the value-and-grad
backward pass (``VG_BWD``: ``vg_bwd.cu``), the guarded beta (``BETA``:
``semiring_beta.cu``) and the other decode kernels (``FILTER``:
``semiring_filter.cu``, ``VITERBI`` and ``BACKTRACK``:
``semiring_viterbi.cu``).

    python3 bench_kernel_pair.py --other DIR [--label NAME]
                                 [--only PART[,PART...]] [--seeds N] [--out FILE]
                                 [--no-variants]

PART is one of ffbs, traj, chees, vg, beta, decode, backtrack (all but
backtrack by default).

``DIR`` holds the other tree's sources (for example
``hhmm_tpu_torch/kernels/csrc`` of a ``git archive`` of an earlier
commit). Every library is built with ``nvcc`` into a temporary directory,
from a copy of its tree's sources and headers, with the flags of
``kernels/cuda_build.py`` (``-Xptxas -v``: registers, shared memory and
spills per kernel are reported). The variants: the forward core's
ring depth and block (``fwd_core.cuh``, timed for ``FWD`` and for
``FILTER`` and ``VITERBI``), ``BWD_SAMPLE``'s lanes a warp, ``TRAJ``'s
warps and chunk, and the β core's block and ring (``beta_core.cuh``,
``VG_BWD`` and ``BETA``). Before timing, each build is checked
against this checkout's: the FFBS pair bitwise (alpha, loglik and draws
at N=256, T=1024, K in {2, 3, 4, 8}, gated and not), the trajectory
within ``chip_smoke.TRAJ_TOL`` (2 leapfrogs at 256 series x 2 chains,
T=1024, and 3 at 5 series x 3 chains, T=1000, masked runs at both ends),
``VG_BWD`` bitwise (N=512, T=1024, K in {3, 4, 8}, gated and not;
``vg_no_sums``, which drops the Baum-Welch sums to time what they cost,
on d_pi and d_obs only), ``BETA`` and the decode kernels bitwise (N=2048,
T=1024, K in {3, 4, 8}, ``MASK_NEG``-sparse A, -inf evidence rows). Then
the FFBS builds are timed at N in {1, 256, 512, 2048, 8192} lanes
(T=1024, K=4, ungated), the trajectory builds at N in {1, 512, 2048}
lanes (T=1024, 16 leapfrogs a launch, ms a leapfrog and ns a recursion
step), ``VG_BWD`` at N in {1, 512, 2048} (T=1024, K=4, gated), ``BETA``
and the decode kernels at N in {1, 512, 8192} (T=1024, K=4, dense
mask), in the order other, this, variants, this, other. ``backtrack``:
``BACKTRACK`` of both trees and of this tree's variants (lanes a block,
ring layout and depth), bitwise equal to this checkout's and to ``backtrack_plain``
on random maps at K in {4, 16, 32, 64, 128} (the other tree where it
takes K), then timed at N in {1, 256, 8192} lanes, T=1024, at each K, in
the same order.
Last, the fused ChEES fit of ``chip_smoke.py`` runs with each tree's
``TRAJ`` at sampler seeds 0 .. N - 1 (the two in turns, which one first
alternating by seed): transition time, divergent sampling transitions,
adapted step size and trajectory length. One JSON object a line; the
card's ``nvidia-smi`` name and power limit first. Exits non-zero without
CUDA or when any build disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (CAP, CHAINS, CHEES_SAMPLES, CHEES_WARMUP, SEED_DATA, SEED_INIT,
                        make_decode_case, state_errors)
from hhmm_tpu_torch.batch import default_init
from hhmm_tpu_torch.infer import ChEESConfig, make_lp_bc, sample_chees_batched
from hhmm_tpu_torch.kernels import cuda_semiring as cs
from hhmm_tpu_torch.kernels import cuda_traj as ct
from hhmm_tpu_torch.kernels.cuda_build import CSRC_DIR, NVCC_FLAGS, _nvcc
from hhmm_tpu_torch.models import TayalHHMM
from hhmm_tpu_torch.sim import tayal_batch

T_BENCH, K_BENCH = 1024, 4
LANES = (1, 256, 512, 2048, 8192)
TRAJ_LANES = (1, 512, 2048)
TRAJ_STEPS, TRAJ_CAP = 16, 16
SPIN_CYCLES = 20_000_000  # about 10 ms at the H100's 1.98 GHz: longer than queuing the calls
VG_LANES = (1, 512, 2048)
BETA_LANES = (1, 512, 8192)
# variants of this checkout's constants: (source or header, name, {old: new})
VARIANTS = (
    ("fwd_core.cuh", "fwd_ring24", {"kFwdStages = 3;": "kFwdStages = 4;"}),
    ("fwd_core.cuh", "fwd_ring32", {"kFwdChunk = 8;": "kFwdChunk = 16;"}),
    ("fwd_core.cuh", "fwd_block128", {"kFwdBlock = 64;": "kFwdBlock = 128;"}),
    ("ffbs_bwd_sample.cu", "bwd_lanes2", {"kLanes = 4;": "kLanes = 2;"}),
    ("ffbs_bwd_sample.cu", "bwd_lanes8", {"kLanes = 4;": "kLanes = 8;"}),
)
TRAJ_VARIANTS = (
    ("traj_warps2", {"kWarps = 4;": "kWarps = 2;"}),
    ("traj_warps1", {"kWarps = 4;": "kWarps = 1;"}),
    ("traj_chunk32", {"kChunk = 16;": "kChunk = 32;"}),
)
# the shared beta core's constants (beta_core.cuh), for VG_BWD and BETA
BETA_VARIANTS = (
    ("beta_core.cuh", "block32", {"kBetaBlock = 64;": "kBetaBlock = 32;"}),
    ("beta_core.cuh", "ring4", {"kBetaStages = 3;": "kBetaStages = 4;"}),
)
# the shared forward core's constants (fwd_core.cuh), for FILTER and VITERBI
FWD_CORE_VARIANTS = (
    ("fwd_core.cuh", "core_ring4", {"kFwdStages = 3;": "kFwdStages = 4;"}),
    ("fwd_core.cuh", "core_block128", {"kFwdBlock = 64;": "kFwdBlock = 128;"}),
)
# BACKTRACK's lanes a block and ring depth (semiring_viterbi.cu)
BACKTRACK_VARIANTS = (
    ("semiring_viterbi.cu", "bt_lanemajor",
     {"kBtLaneFastestLanes = 16;": "kBtLaneFastestLanes = 64;"}),
    ("semiring_viterbi.cu", "bt_lanefastest",
     {"kBtLaneFastestLanes = 16;": "kBtLaneFastestLanes = 1;"}),
    ("semiring_viterbi.cu", "bt_lanes16", {"kBtMaxLanes = 32;": "kBtMaxLanes = 16;"}),
)
BACKTRACK_KS = (4, 16, 32, 64, 128)
BACKTRACK_LANES = (1, 256, 8192)
PARTS = ("ffbs", "traj", "chees", "vg", "beta", "decode", "backtrack")
# VG_BWD without the Baum-Welch sums: what keeping them in the
# recursion's threads costs (its d_A is not computed)
VG_NO_SUMS = ("beta_core.cuh", "vg_no_sums", {"dA[j] += xi * m01;": "(void)xi;"})
VG_VARIANTS = (*BETA_VARIANTS, VG_NO_SUMS)

_P, _I = ctypes.c_void_p, ctypes.c_int


def emit(records, **fields) -> None:
    records.append(fields)
    print(json.dumps(fields), flush=True)


def tree(directory: Path) -> dict:
    """A tree's kernel sources and headers, ``{file name: text}``."""
    return {p.name: p.read_text() for p in sorted(directory.glob("*.cu*"))}


def build(jobs, workdir: Path) -> dict:
    """Compile every ``(name, files, source)`` of ``jobs`` (``source`` of
    the tree ``files``, written to a directory of its own, so that its
    quoted includes find the tree's headers), eight ``nvcc`` at a time;
    returns ``{name: (library, ptxas register/spill lines)}``."""

    def one(job):
        name, files, source = job
        d = workdir / name
        d.mkdir()
        for fname, text in files.items():
            (d / fname).write_text(text)
        lib = d / f"{name}.so"
        out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(d / source)],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out.stdout}{out.stderr}")
        log = out.stdout + out.stderr
        return lib, [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]

    with ThreadPoolExecutor(max_workers=8) as pool:
        done = dict(zip((j[0] for j in jobs), pool.map(one, jobs)))
    return {name: (ctypes.CDLL(str(lib)), regs) for name, (lib, regs) in done.items()}


def substitute(files: dict, fname: str, subs: dict, name: str) -> dict:
    """A copy of the tree ``files`` with ``subs`` made in ``fname``."""
    text = files[fname]
    for old, new in subs.items():
        if old not in text:
            raise RuntimeError(f"variant {name}: '{old}' not in {fname}")
        text = text.replace(old, new)
    return {**files, fname: text}


def time_ms(fn, reps: int) -> float:
    """Mean ms a call on the card: the calls are queued behind a spin
    kernel, so the events time the card's work, not the host's launch
    rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# the FFBS pair
# ---------------------------------------------------------------------------


class Pair:
    """One build of the two FFBS kernels, called on lane-layout tensors."""

    def __init__(self, label, fwd_lib, bwd_lib, bwd_has_scratch, regs):
        self.label, self.regs = label, regs
        self.fwd = fwd_lib.hhmm_ffbs_fwd
        self.fwd.argtypes = [_I, _I] + [_P] * 8 + [_I, _I, _P]
        self.fwd.restype = _I
        self.bwd = bwd_lib.hhmm_ffbs_bwd_sample
        self.scratch = bwd_has_scratch
        self.bwd.argtypes = [_I, _I] + [_P] * (8 if bwd_has_scratch else 7) + [_I, _I, _P]
        self.bwd.restype = _I

    def run_fwd(self, lanes):
        pi_t, A_t, obs_t, mask_t, gate_t, sk_t = lanes
        T, K, N = obs_t.shape
        ll = torch.empty(N, device=obs_t.device)
        alpha = torch.empty_like(obs_t)
        p = [None if x is None else x.data_ptr() for x in (gate_t, sk_t)]
        rc = self.fwd(K, int(gate_t is not None), pi_t.data_ptr(), A_t.data_ptr(),
                      obs_t.data_ptr(), mask_t.data_ptr(), p[0], p[1], ll.data_ptr(),
                      alpha.data_ptr(), T, N, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.label}: FWD launch failed ({rc})")
        return ll, alpha

    def run_bwd(self, lanes, alpha, u_t):
        _, A_t, _, mask_t, gate_t, sk_t = lanes
        T, K, N = alpha.shape
        z = torch.empty((T, N), dtype=torch.int32, device=alpha.device)
        p = [None if x is None else x.data_ptr() for x in (gate_t, sk_t)]
        args = [K, int(gate_t is not None), A_t.data_ptr(), mask_t.data_ptr(),
                alpha.data_ptr(), u_t.data_ptr(), p[0], p[1], z.data_ptr()]
        if self.scratch:
            args.append(None)  # T <= 2048: the maps live in shared memory
        rc = self.bwd(*args, T, N, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.label}: BWD_SAMPLE launch failed ({rc})")
        return z


def make_lanes(seed: int, N: int, T: int, K: int, gated: bool):
    """Random normalized (pi, A), N(-1, 1) emissions, ragged mask, sign
    gate; the lane layout on the card, with uniforms ``u [T, N]``."""
    rng = np.random.default_rng(seed)

    def log_norm(a):
        return a - np.log(np.exp(a).sum(-1, keepdims=True))

    f32 = dict(dtype=torch.float32, device="cuda")
    lengths = rng.integers(T // 2, T + 1, size=N)
    mask = torch.as_tensor(np.arange(T)[None, :] < lengths[:, None], **f32)
    gk = sk = None
    if gated:
        gk = torch.as_tensor(rng.integers(0, 2, size=(N, T)), **f32)
        sk = torch.as_tensor(np.tile([1.0, 0.0, 0.0, 1.0], K // 4 or 1)[:K], **f32)
    lanes = cs.to_lanes(
        torch.as_tensor(log_norm(rng.normal(size=(N, K))), **f32),
        torch.as_tensor(log_norm(rng.normal(size=(N, K, K))), **f32),
        torch.as_tensor(rng.normal(size=(N, T, K)) - 1.0, **f32), mask, gk, sk,
    )
    return lanes, torch.as_tensor(rng.random((T, N)), **f32)


def bench_ffbs(label, other_dir: Path, work: Path, records) -> None:
    this_src, other_src = tree(CSRC_DIR), tree(other_dir)
    trees = [(label, other_src), ("this", this_src)]
    trees += [(name, substitute(this_src, source, subs, name)) for source, name, subs in VARIANTS]
    libs = build([(f"{name}_{part}", files, f"ffbs_{part}.cu")
                  for name, files in trees for part in ("fwd", "bwd_sample")], work)
    builds = {}
    for name, files in trees:
        (fl, fr), (bl, br) = libs[f"{name}_fwd"], libs[f"{name}_bwd_sample"]
        has_scratch = re.search(r"hhmm_ffbs_bwd_sample\([^)]*scratch", files["ffbs_bwd_sample.cu"],
                                re.S)
        builds[name] = Pair(name, fl, bl, bool(has_scratch), {"fwd": fr, "bwd": br})
    for name, b in builds.items():
        emit(records, phase="build", kernel="ffbs", label=name, ptxas=b.regs)

    # every build bitwise equal to this checkout's
    for K in (2, 3, 4, 8, 12, 16):
        for gated in (False, True):
            lanes, u_t = make_lanes(10 + K + gated, 256, T_BENCH, K, gated)
            ll0, a0 = builds["this"].run_fwd(lanes)
            z0 = builds["this"].run_bwd(lanes, a0, u_t)
            for name, b in builds.items():
                ll, a = b.run_fwd(lanes)
                z = b.run_bwd(lanes, a0, u_t)
                torch.cuda.synchronize()
                if not (torch.equal(a, a0) and torch.equal(ll, ll0) and torch.equal(z, z0)):
                    raise AssertionError(f"{name} differs from this checkout at K={K} gated={gated}")
    emit(records, phase="agree", kernel="ffbs", bitwise_equal=True, builds=list(builds))

    order = [label, "this"] + [v[1] for v in VARIANTS] + ["this", label]
    for N in LANES:
        lanes, u_t = make_lanes(7, N, T_BENCH, K_BENCH, False)
        _, alpha = builds["this"].run_fwd(lanes)
        reps = 50 if N <= 2048 else 20
        for turn, name in enumerate(order):
            b = builds[name]
            f = time_ms(lambda: b.run_fwd(lanes), reps)
            w = time_ms(lambda: b.run_bwd(lanes, alpha, u_t), reps)
            emit(records, phase="timing", kernel="ffbs", label=name, turn=turn, N=N, T=T_BENCH,
                 K=K_BENCH, fwd_ms=f, fwd_ns_per_step=f * 1e6 / T_BENCH,
                 bwd_ms=w, bwd_ns_per_step=w * 1e6 / T_BENCH)
        del lanes, u_t, alpha


# ---------------------------------------------------------------------------
# the trajectory kernel
# ---------------------------------------------------------------------------


class Traj:
    """One build of ``TRAJ``. The earlier C entry took an alpha [T, 4, N]
    and a normaliser [T, N] scratch; the current one a byte scratch, NULL
    while shared memory holds a lane's buffers."""

    def __init__(self, label, lib, two_scratches: bool, regs):
        self.label, self.regs, self.two = label, regs, two_scratches
        self.fn = lib.hhmm_tayal_traj
        self.fn.argtypes = [_P] * (15 if two_scratches else 14) + [_I] * 5 + [_P]
        self.fn.restype = _I

    def run(self, case, n_steps, eps=0.02):
        q, p, g, im, x_t, s_t, m_t, C = case
        D, N = q.shape
        T, B = x_t.shape
        f32 = dict(dtype=torch.float32, device=q.device)
        q1, p1, g1 = (torch.empty((D, N), **f32) for _ in range(3))
        lp1 = torch.empty((N,), **f32)
        eps = torch.as_tensor(eps, **f32).reshape(1)
        n = torch.as_tensor(n_steps, device=q.device).to(torch.int32).reshape(1)
        if self.two:
            scr = [torch.empty((T, 4, N), **f32), torch.empty((T, N), **f32)]
        else:
            nbytes = ct.traj_scratch_bytes(T, N)
            scr = [torch.empty((nbytes,), dtype=torch.uint8, device=q.device) if nbytes else None]
        ptrs = [a.data_ptr() for a in (q, p, g, im, x_t, s_t, m_t, eps, n, q1, p1, g1, lp1)]
        ptrs += [None if a is None else a.data_ptr() for a in scr]
        rc = self.fn(*ptrs, TRAJ_CAP, C, T, N, B, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.label}: TRAJ launch failed ({rc})")
        return q1, p1, lp1, g1

    def trajectory_fn(self, x_t, s_t, m_t):
        """This build as a ChEES ``trajectory_fn`` on fixed series data."""

        def trajectory(inv_mass, eps, n_steps, q, p, logp, grad):
            B, C, D = q.shape

            def lanes(a):
                return a.reshape(B * C, D).t().contiguous()

            case = (lanes(q), lanes(p), lanes(grad), inv_mass.t().contiguous(), x_t, s_t, m_t, C)
            q1, p1, lp1, g1 = self.run(case, n_steps, eps)
            back = lambda a: a.t().reshape(B, C, D)  # noqa: E731
            return back(q1), back(p1), lp1.reshape(B, C), back(g1)

        trajectory.cap = TRAJ_CAP
        return trajectory


def traj_case(seed: int, B: int, T: int, C: int, both_ends: bool):
    """Simulated series (``tayal_batch``) and random start states in the
    lane layout; with ``both_ends`` a ragged tail and a masked head."""
    rng = np.random.default_rng(seed)
    x, sign = tayal_batch(B, T, seed=seed, device="cuda")
    valid = np.ones((B, T), bool)
    if both_ends:
        valid &= np.arange(T)[None] < rng.integers(max(T // 2, 1), T + 1, size=B)[:, None]
        valid &= np.arange(T)[None] >= rng.integers(0, T // 8 + 1, size=B)[:, None]
    f32 = dict(dtype=torch.float32, device="cuda")
    x_t, s_t, m_t = ct._data_lanes(x, sign, torch.as_tensor(valid, **f32), "cuda")
    N = B * C
    q, p, g = (torch.as_tensor(sc * rng.normal(size=(ct.DIM, N)), **f32) for sc in (0.5, 0.7, 1.0))
    im = torch.as_tensor(np.exp(0.3 * rng.normal(size=(ct.DIM, B))), **f32)
    return q, p, g, im, x_t, s_t, m_t, C


def bench_traj(label, other_dir: Path, work: Path, records) -> None:
    this_src, other_src = tree(CSRC_DIR), tree(other_dir)
    trees = [(label, other_src), ("this", this_src)]
    trees += [(name, substitute(this_src, "tayal_traj.cu", subs, name))
              for name, subs in TRAJ_VARIANTS]
    libs = build([(name, files, "tayal_traj.cu") for name, files in trees], work)
    builds = {}
    for name, files in trees:
        two = re.search(r"hhmm_tayal_traj\([^)]*alpha_scr", files["tayal_traj.cu"], re.S)
        lib, regs = libs[name]
        builds[name] = Traj(name, lib, two is not None, regs)
    for name, b in builds.items():
        emit(records, phase="build", kernel="traj", label=name, ptxas=b.regs)

    # every build within TRAJ_TOL of this checkout's
    for seed, (B, T, C, both, n) in enumerate(((256, T_BENCH, 2, False, 2), (5, 1000, 3, True, 3))):
        case = traj_case(20 + seed, B, T, C, both)
        ref = builds["this"].run(case, n)
        for name, b in builds.items():
            e = state_errors(b.run(case, n), ref)
            torch.cuda.synchronize()
            if any(v[1] > 0 for v in e.values()):
                raise AssertionError(f"{name} TRAJ differs from this checkout at B={B} T={T}: {e}")
            emit(records, phase="agree", kernel="traj", label=name, B=B, T=T, C=C,
                 max_abs_err={k: v[0] for k, v in e.items()})

    order = [label, "this"] + [v[0] for v in TRAJ_VARIANTS] + ["this", label]
    for N in TRAJ_LANES:
        C = 2 if N >= 2 else 1
        case = traj_case(7, N // C, T_BENCH, C, False)
        for turn, name in enumerate(order):
            b = builds[name]
            ms = time_ms(lambda: b.run(case, TRAJ_STEPS), 10) / TRAJ_STEPS
            emit(records, phase="timing", kernel="traj", label=name, turn=turn, N=N, T=T_BENCH,
                 ms_per_leapfrog=ms, ns_per_step=ms * 1e6 / (2 * T_BENCH))
        del case


def bench_chees(label, other_dir: Path, work: Path, records, seeds: int) -> None:
    """The fused ChEES fit of ``chip_smoke.py`` (256 series x 2 chains,
    T=1024, 150 + 150 transitions, cap 16) with this checkout's ``TRAJ``
    and the other tree's, at sampler seeds 0 .. seeds - 1, in turns: the
    transition time and the divergent sampling transitions of each."""
    other_src = tree(other_dir)
    (lib, regs), = build([(f"{label}_chees_traj", other_src, "tayal_traj.cu")], work).values()
    two = re.search(r"hhmm_tayal_traj\([^)]*alpha_scr", other_src["tayal_traj.cu"], re.S)
    other = Traj(label, lib, two is not None, regs)
    x, sign = tayal_batch(256, T_BENCH, seed=SEED_DATA, device="cuda")
    data = {"x": x, "sign": sign}
    model = TayalHHMM()
    init = default_init(model, data, 256, CHAINS, seed=SEED_INIT, device="cuda")
    x_t, s_t, m_t = ct._data_lanes(x, sign, None, "cuda")
    trajs = {label: other.trajectory_fn(x_t, s_t, m_t),
             "this": ct.make_tayal_trajectory(data, cap=CAP, device="cuda")}
    cfg = ChEESConfig(num_warmup=CHEES_WARMUP, num_samples=CHEES_SAMPLES, num_chains=CHAINS,
                      max_leapfrogs=CAP)
    for seed in range(seeds):
        for name in ((label, "this") if seed % 2 == 0 else ("this", label)):
            lp_bc = make_lp_bc(model, data, device="cuda")
            probe = model.make_vg({"x": x[0], "sign": sign[0]})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, st = sample_chees_batched(lp_bc, init, cfg, seed=seed, device="cuda",
                                         probe_vg=probe, trajectory_fn=trajs[name])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            div = st["diverging"]
            n = CHEES_WARMUP + CHEES_SAMPLES
            emit(records, phase="chees", label=name, seed=seed, transition_ms=wall / n * 1e3,
                 transitions_per_s=n / wall, divergent_sampling=int(div.sum()),
                 divergent_share=int(div.sum()) / div.numel(),
                 divergent_chains=int(div.any(-1).sum()),
                 divergent_warmup=int(st["warmup_diverging"].sum()),
                 step_size=float(st["step_size"][0, 0]), traj_length=float(st["traj_length"][0, 0]),
                 leapfrogs_sampling=float(st["num_leaves"][0, 0].float().mean()),
                 accept_mean_sampling=float(st["accept_prob"].mean()))


# ---------------------------------------------------------------------------
# the backward recursions (VG_BWD, BETA) and the other decode kernels
# ---------------------------------------------------------------------------


def bind(lib, kernel):
    """``kernel``'s C entry in ``lib``, with the wrapper's argument types."""
    fn = getattr(lib, kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, _I
    return fn


def _ptrs(*ts):
    return [None if t is None else t.data_ptr() for t in ts]


def _stream():
    return torch.cuda.current_stream().cuda_stream


def run_vg(fn, lanes, alpha, ll):
    _, A_t, obs_t, mask_t, gate_t, sk_t = lanes
    T, K, N = obs_t.shape
    out = [torch.empty(s, device="cuda") for s in ((K, N), (K, K, N), (T, K, N))]
    rc = fn(K, int(gate_t is not None), *_ptrs(A_t, obs_t, mask_t, alpha, ll, gate_t, sk_t),
            *_ptrs(*out), T, N, _stream())
    if rc != 0:
        raise RuntimeError(f"VG_BWD launch failed ({rc})")
    return out


def run_decode(kernel, fn, lanes):
    """One launch of a decode kernel (``BACKTRACK`` on the maps this
    checkout's ``VITERBI`` makes of ``lanes``)."""
    pi_t, A_t, obs_t, mask_t = lanes[:4]
    T, K, N = obs_t.shape
    f32 = dict(dtype=torch.float32, device="cuda")
    if kernel is cs.BETA:
        out = [torch.empty((T, K, N), **f32)]
        rc = fn(K, *_ptrs(A_t, obs_t, mask_t, *out), T, N, _stream())
    elif kernel is cs.FILTER:
        out = [torch.empty((N,), **f32), torch.empty((T, K, N), **f32)]
        rc = fn(K, *_ptrs(pi_t, A_t, obs_t, mask_t, *out), T, N, _stream())
    elif kernel is cs.VITERBI:
        out = [torch.empty((N,), **f32), torch.empty((K, N), **f32),
               torch.empty(cs._map_shape(T, K, N), dtype=torch.int32, device="cuda")]
        rc = fn(K, *_ptrs(pi_t, A_t, obs_t, mask_t, *out), T, N, _stream())
    else:
        back, dlast = lanes[4], lanes[5]
        out = [torch.empty((T, N), dtype=torch.int32, device="cuda")]
        rc = fn(K, *_ptrs(back, dlast, *out), T, N, _stream())
    if rc != 0:
        raise RuntimeError(f"{kernel.name} launch failed ({rc})")
    return out


def _decode_lanes(seed, N, K, finite):
    """``make_decode_case`` lanes with this checkout's Viterbi maps and
    ``dlast`` appended (the backtrack's inputs)."""
    lanes = make_decode_case(seed, N, T_BENCH, K, "cuda", finite)
    _, dlast, back = cs.viterbi_lanes(*lanes)
    return (*lanes, back, dlast)


def _dense_decode_lanes(N):
    rng = np.random.default_rng(6000)
    f32 = dict(dtype=torch.float32, device="cuda")
    log_A = rng.normal(size=(N, K_BENCH, K_BENCH))
    log_A -= np.log(np.exp(log_A).sum(-1, keepdims=True))
    lanes = cs.to_lanes(
        torch.as_tensor(np.full((N, K_BENCH), -np.log(K_BENCH)), **f32),
        torch.as_tensor(log_A, **f32),
        torch.as_tensor(rng.normal(size=(N, T_BENCH, K_BENCH)) - 1.0, **f32),
        torch.ones((N, T_BENCH), **f32),
    )[:4]
    _, dlast, back = cs.viterbi_lanes(*lanes)
    return (*lanes, back, dlast)


def _timing_order(label, names):
    return [label, "this", *names, "this", label]


def bench_vg(label, other_dir: Path, work: Path, records) -> None:
    this_src, other_src = tree(CSRC_DIR), tree(other_dir)
    variants = [(name, substitute(this_src, f, subs, name)) for f, name, subs in VG_VARIANTS]
    trees = [(label, other_src), ("this", this_src), *variants]
    libs = build([(f"{name}_vg", files, "vg_bwd.cu") for name, files in trees], work)
    builds = {}
    for name, _ in trees:
        lib, regs = libs[f"{name}_vg"]
        builds[name] = bind(lib, cs.VG_BWD)
        emit(records, phase="build", kernel="vg_bwd", label=name, ptxas=regs)

    # bitwise equal to this checkout's (vg_no_sums on d_pi and d_obs only)
    for K in (3, 4, 8, 16):
        for gated in (False, True):
            lanes, _ = make_lanes(30 + K + gated, 512, T_BENCH, K, gated)
            ll, alpha = cs.fwd_lanes(*lanes)
            ref = run_vg(builds["this"], lanes, alpha, ll)
            for name, fn in builds.items():
                got = run_vg(fn, lanes, alpha, ll)
                torch.cuda.synchronize()
                keep = (0, 2) if name == VG_NO_SUMS[1] else (0, 1, 2)
                if not all(torch.equal(got[i], ref[i]) for i in keep):
                    raise AssertionError(f"{name} VG_BWD differs from this checkout at K={K} "
                                         f"gated={gated}")
    emit(records, phase="agree", kernel="vg_bwd", bitwise_equal=True, builds=list(builds))

    order = _timing_order(label, [v[0] for v in variants])
    for N in VG_LANES:
        lanes, _ = make_lanes(31, N, T_BENCH, K_BENCH, True)
        ll, alpha = cs.fwd_lanes(*lanes)
        for turn, name in enumerate(order):
            fn = builds[name]
            ms = time_ms(lambda: run_vg(fn, lanes, alpha, ll), 50)
            emit(records, phase="timing", kernel="vg_bwd", label=name, turn=turn, N=N, T=T_BENCH,
                 K=K_BENCH, gated=True, ms=ms, ns_per_step=ms * 1e6 / T_BENCH)
        del lanes, ll, alpha


def bench_decode_kernels(label, other_dir: Path, work: Path, records, kernels, variants) -> None:
    """``kernels`` (of ``cs``) of this tree, the other tree and this
    tree's ``variants``: bitwise equal to this checkout's, then timed."""
    this_src, other_src = tree(CSRC_DIR), tree(other_dir)
    trees = [(label, other_src), ("this", this_src)]
    trees += [(name, substitute(this_src, f, subs, name)) for f, name, subs in variants]
    libs = build([(f"{name}_{k.name}", files, k.source.name) for name, files in trees
                   for k in kernels], work)
    builds = {}
    for name, _ in trees:
        for k in kernels:
            lib, regs = libs[f"{name}_{k.name}"]
            builds[name, k.name] = bind(lib, k)
            emit(records, phase="build", kernel=k.name, label=name, ptxas=regs)

    for K in (3, 4, 8, 16, 20, 32):
        for finite in (True, False):
            lanes = _decode_lanes(40 + K + finite, 2048 if K <= 8 else 256, K, finite)
            for k in kernels:
                ref = run_decode(k, builds["this", k.name], lanes)
                for name, _ in trees:
                    got = run_decode(k, builds[name, k.name], lanes)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                        raise AssertionError(f"{name} {k.name} differs from this checkout at "
                                             f"K={K} finite={finite}")
    emit(records, phase="agree", kernels=[k.name for k in kernels], bitwise_equal=True,
         builds=[n for n, _ in trees])

    order = _timing_order(label, [v[1] for v in variants])
    for N in BETA_LANES:
        lanes = _dense_decode_lanes(N)
        for k in kernels:
            for turn, name in enumerate(order):
                fn = builds[name, k.name]
                ms = time_ms(lambda: run_decode(k, fn, lanes), 50 if N <= 2048 else 20)
                emit(records, phase="timing", kernel=k.name, label=name, turn=turn, N=N,
                     T=T_BENCH, K=K_BENCH, ms=ms, ns_per_step=ms * 1e6 / T_BENCH)
        del lanes


def random_maps(seed: int, N: int, T: int, K: int):
    """Packed maps ``[T, W, N]`` (``[T, N]`` up to K = 8) of uniform
    random pointers and a random ``dlast [K, N]``, made on the card a
    step at a time: the backtrack's work does not depend on the maps'
    content, only on their shape."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    back = torch.empty(cs._map_shape(T, K, N), dtype=torch.int32, device="cuda")
    for t in range(T):
        back[t] = cs._pack(torch.randint(0, K, (K, N), generator=g, device="cuda")).view(
            back.shape[1:])
    return back, torch.randn((K, N), generator=g, device="cuda")


def bench_backtrack(label, other_dir: Path, work: Path, records) -> None:
    this_src, other_src = tree(CSRC_DIR), tree(other_dir)
    trees = [(label, other_src), ("this", this_src)]
    trees += [(name, substitute(this_src, f, subs, name)) for f, name, subs in BACKTRACK_VARIANTS]
    libs = build([(f"{name}_bt", files, cs.BACKTRACK.source.name) for name, files in trees],
                 work)
    builds = {}
    for name, _ in trees:
        lib, regs = libs[f"{name}_bt"]
        builds[name] = bind(lib, cs.BACKTRACK)
        emit(records, phase="build", kernel=cs.BACKTRACK.name, label=name, ptxas=regs)

    def run(fn, back, dlast):
        T, N, K = back.shape[0], back.shape[-1], dlast.shape[0]
        path = torch.empty((T, N), dtype=torch.int32, device="cuda")
        rc = fn(K, *_ptrs(back, dlast, path), T, N, _stream())
        return path if rc == 0 else None  # the other tree may not take K

    takes = {}
    for K in BACKTRACK_KS:
        for N, T in ((300, T_BENCH), (9, 75), (1, 33)):
            back, dlast = random_maps(K + N + T, N, T, K)
            want = cs.backtrack_plain(back, dlast)
            for name, fn in builds.items():
                got = run(fn, back, dlast)
                torch.cuda.synchronize()
                takes[name, K] = got is not None
                if got is not None and not torch.equal(got, want):
                    raise AssertionError(f"{name} BACKTRACK differs from backtrack_plain at K={K} "
                                         f"N={N} T={T}")
    emit(records, phase="agree", kernel=cs.BACKTRACK.name, bitwise_equal_to_plain=True,
         takes={f"{n}:K{K}": v for (n, K), v in takes.items()})

    order = _timing_order(label, [v[1] for v in BACKTRACK_VARIANTS])
    for K in BACKTRACK_KS:
        for N in BACKTRACK_LANES:
            back, dlast = random_maps(7 + K, N, T_BENCH, K)
            for turn, name in enumerate(order):
                if not takes[name, K]:
                    continue
                fn = builds[name]
                ms = time_ms(lambda: run(fn, back, dlast), 50 if N <= 256 else 20)
                emit(records, phase="timing", kernel=cs.BACKTRACK.name, label=name, turn=turn,
                     N=N, T=T_BENCH, K=K, ms=ms, ns_per_step=ms * 1e6 / T_BENCH)
            del back, dlast


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="directory with the other tree's kernel sources (kernels/csrc)")
    ap.add_argument("--label", default="other", help="name of the other tree in the output")
    ap.add_argument("--only", type=lambda v: v.split(","), default=list(PARTS[:-1]),
                    help="comma-separated parts to run: " + ", ".join(PARTS))
    ap.add_argument("--seeds", type=int, default=4, help="sampler seeds of the ChEES comparison")
    ap.add_argument("--out", type=Path, help="also write every record to this JSON file")
    ap.add_argument("--no-variants", action="store_true",
                    help="build and time only the two trees, none of the constants' variants")
    args = ap.parse_args()
    if args.no_variants:
        global VARIANTS, TRAJ_VARIANTS, BETA_VARIANTS, FWD_CORE_VARIANTS, BACKTRACK_VARIANTS
        global VG_VARIANTS
        VARIANTS = TRAJ_VARIANTS = BETA_VARIANTS = FWD_CORE_VARIANTS = BACKTRACK_VARIANTS = ()
        VG_VARIANTS = ()
    if not set(args.only) <= set(PARTS):
        ap.error(f"--only takes parts of {PARTS}, got {args.only}")
    if not torch.cuda.is_available():
        print("bench_kernel_pair: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    records = []
    emit(records, phase="device", nvidia_smi=smi.splitlines()[0],
         kind=torch.cuda.get_device_name(0), torch=torch.__version__)
    with tempfile.TemporaryDirectory() as tmp:
        if "ffbs" in args.only:
            bench_ffbs(args.label, args.other, Path(tmp), records)
        if "traj" in args.only:
            bench_traj(args.label, args.other, Path(tmp), records)
        if "chees" in args.only:
            bench_chees(args.label, args.other, Path(tmp), records, args.seeds)
        if "vg" in args.only:
            bench_vg(args.label, args.other, Path(tmp), records)
        if "beta" in args.only:
            bench_decode_kernels(args.label, args.other, Path(tmp), records, (cs.BETA,),
                                 BETA_VARIANTS)
        if "decode" in args.only:
            bench_decode_kernels(args.label, args.other, Path(tmp), records,
                                 (cs.FILTER, cs.VITERBI, cs.BACKTRACK), FWD_CORE_VARIANTS)
        if "backtrack" in args.only:
            bench_backtrack(args.label, args.other, Path(tmp), records)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
