#!/usr/bin/env python3
"""Time this checkout's hand-written kernels against the same kernels
built from another source directory, and against variants of this
checkout's constants, in turns on one CUDA card: the FFBS pair (``FWD``:
``ffbs_fwd.cu``, ``BWD_SAMPLE``: ``ffbs_bwd_sample.cu``) and the fused
trajectory kernel (``TRAJ``: ``tayal_traj.cu``).

    python3 bench_kernel_pair.py --other DIR [--label NAME] [--only ffbs|traj|chees]
                                 [--seeds N] [--out FILE]

``DIR`` holds the other tree's sources (for example
``hhmm_tpu_torch/kernels/csrc`` of a ``git archive`` of an earlier
commit). Every library is built with ``nvcc`` into a temporary directory,
with the flags of ``kernels/cuda_build.py`` (``-Xptxas -v``: registers,
shared memory and spills per kernel are reported). Before timing, each
build is checked against this checkout's: the FFBS pair bitwise (alpha,
loglik and draws at N=256, T=1024, K in {3, 4}, gated and not), the
trajectory within ``chip_smoke.TRAJ_TOL`` (2 leapfrogs at 256 series x 2
chains, T=1024, and 3 at 5 series x 3 chains, T=1000, masked runs at
both ends). Then the FFBS builds are timed at N in {1, 256, 512, 2048,
8192} lanes (T=1024, K=4, ungated) and the trajectory builds at N in
{1, 512, 2048} lanes (T=1024, 16 leapfrogs a launch, ms a leapfrog and
ns a recursion step), in the order other, this, variants, this, other.
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
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (CAP, CHAINS, CHEES_SAMPLES, CHEES_WARMUP, SEED_DATA, SEED_INIT,
                        state_errors)
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
# variants of this checkout's constants: (kernel source, name, {old: new})
VARIANTS = (
    ("ffbs_fwd.cu", "fwd_ring24", {"kStages = 3;": "kStages = 4;"}),
    ("ffbs_fwd.cu", "fwd_ring32", {"kChunk = 8;": "kChunk = 16;"}),
    ("ffbs_fwd.cu", "fwd_block128", {"kBlock = 64;": "kBlock = 128;"}),
    ("ffbs_bwd_sample.cu", "bwd_lanes2", {"kLanes = 4;": "kLanes = 2;"}),
    ("ffbs_bwd_sample.cu", "bwd_lanes8", {"kLanes = 4;": "kLanes = 8;"}),
)
TRAJ_VARIANTS = (
    ("traj_warps2", {"kWarps = 4;": "kWarps = 2;"}),
    ("traj_warps1", {"kWarps = 4;": "kWarps = 1;"}),
    ("traj_chunk32", {"kChunk = 16;": "kChunk = 32;"}),
)

_P, _I = ctypes.c_void_p, ctypes.c_int


def emit(records, **fields) -> None:
    records.append(fields)
    print(json.dumps(fields), flush=True)


def build(src_text: str, name: str, workdir: Path):
    """Compile one source text into ``workdir``; returns (library, ptxas
    register/shared-memory lines)."""
    src = workdir / f"{name}.cu"
    src.write_text(src_text)
    lib = workdir / f"{name}.so"
    out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{out.stdout}{out.stderr}")
    log = out.stdout + out.stderr
    regs = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
    return ctypes.CDLL(str(lib)), regs


def substitute(text: str, subs: dict, name: str) -> str:
    for old, new in subs.items():
        if old not in text:
            raise RuntimeError(f"variant {name}: '{old}' not in the source")
        text = text.replace(old, new)
    return text


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
    this_src = {f: (CSRC_DIR / f).read_text() for f in ("ffbs_fwd.cu", "ffbs_bwd_sample.cu")}
    other_src = {f: (other_dir / f).read_text() for f in this_src}
    builds = {}

    def pair(name, fwd_text, bwd_text):
        fl, fr = build(fwd_text, f"{name}_fwd", work)
        bl, br = build(bwd_text, f"{name}_bwd", work)
        has_scratch = re.search(r"hhmm_ffbs_bwd_sample\([^)]*scratch", bwd_text, re.S)
        builds[name] = Pair(name, fl, bl, bool(has_scratch), {"fwd": fr, "bwd": br})

    pair(label, other_src["ffbs_fwd.cu"], other_src["ffbs_bwd_sample.cu"])
    pair("this", this_src["ffbs_fwd.cu"], this_src["ffbs_bwd_sample.cu"])
    for source, name, subs in VARIANTS:
        text = substitute(this_src[source], subs, name)
        fwd = text if source == "ffbs_fwd.cu" else this_src["ffbs_fwd.cu"]
        bwd = text if source == "ffbs_bwd_sample.cu" else this_src["ffbs_bwd_sample.cu"]
        pair(name, fwd, bwd)
    for name, b in builds.items():
        emit(records, phase="build", kernel="ffbs", label=name, ptxas=b.regs)

    # every build bitwise equal to this checkout's
    for K in (3, 4):
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
    this_src = (CSRC_DIR / "tayal_traj.cu").read_text()
    other_src = (other_dir / "tayal_traj.cu").read_text()
    builds = {}

    def one(name, text):
        lib, regs = build(text, f"{name}_traj", work)
        two = re.search(r"hhmm_tayal_traj\([^)]*alpha_scr", text, re.S) is not None
        builds[name] = Traj(name, lib, two, regs)

    one(label, other_src)
    one("this", this_src)
    for name, subs in TRAJ_VARIANTS:
        one(name, substitute(this_src, subs, name))
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
    lib, regs = build((other_dir / "tayal_traj.cu").read_text(), f"{label}_chees_traj", work)
    other = Traj(label, lib, True, regs)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="directory with the other tree's ffbs_fwd.cu, ffbs_bwd_sample.cu "
                         "and tayal_traj.cu")
    ap.add_argument("--label", default="other", help="name of the other tree in the output")
    ap.add_argument("--only", choices=("ffbs", "traj", "chees"), help="run one of the three")
    ap.add_argument("--seeds", type=int, default=4, help="sampler seeds of the ChEES comparison")
    ap.add_argument("--out", type=Path, help="also write every record to this JSON file")
    args = ap.parse_args()
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
        if args.only in (None, "ffbs"):
            bench_ffbs(args.label, args.other, Path(tmp), records)
        if args.only in (None, "traj"):
            bench_traj(args.label, args.other, Path(tmp), records)
        if args.only in (None, "chees"):
            bench_chees(args.label, args.other, Path(tmp), records, args.seeds)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
