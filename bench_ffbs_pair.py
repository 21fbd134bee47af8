#!/usr/bin/env python3
"""Time the FFBS kernel pair (``FWD``: ``ffbs_fwd.cu``, ``BWD_SAMPLE``:
``ffbs_bwd_sample.cu``) of this checkout against the same pair built
from another source directory, and against variants of this checkout's
ring and block constants, in turns on one CUDA card.

    python3 bench_ffbs_pair.py --other DIR [--out FILE]

``DIR`` holds the other tree's ``ffbs_fwd.cu`` and ``ffbs_bwd_sample.cu``
(for example ``hhmm_tpu_torch/kernels/csrc`` of a ``git archive`` of an
earlier commit). Every library is built with ``nvcc`` into a temporary
directory, with the flags of ``kernels/cuda_build.py`` (``-Xptxas -v``:
registers and shared memory per kernel are reported). Before timing,
every build's alpha, loglik and draws are checked bitwise equal to this
checkout's at N=256, T=1024, K in {3, 4}, gated and not. Then each build
is timed with CUDA events at N in {1, 256, 512, 2048, 8192} lanes, T=1024,
K=4, ungated, in the order other, this, variants, this, other. One JSON
object a line; the card's ``nvidia-smi`` name and power limit first.
Exits non-zero without CUDA or when any build disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from hhmm_tpu_torch.kernels import cuda_semiring as cs
from hhmm_tpu_torch.kernels.cuda_build import CSRC_DIR, NVCC_FLAGS, _nvcc

T_BENCH, K_BENCH = 1024, 4
LANES = (1, 256, 512, 2048, 8192)
SPIN_CYCLES = 20_000_000  # about 10 ms at the H100's 1.98 GHz: longer than queuing the calls
# variants of this checkout's constants: (kernel source, name, {old: new})
VARIANTS = (
    ("ffbs_fwd.cu", "fwd_ring24", {"kStages = 3;": "kStages = 4;"}),
    ("ffbs_fwd.cu", "fwd_ring32", {"kChunk = 8;": "kChunk = 16;"}),
    ("ffbs_fwd.cu", "fwd_block128", {"kBlock = 64;": "kBlock = 128;"}),
    ("ffbs_bwd_sample.cu", "bwd_lanes2", {"kLanes = 4;": "kLanes = 2;"}),
    ("ffbs_bwd_sample.cu", "bwd_lanes8", {"kLanes = 4;": "kLanes = 8;"}),
)

_P, _I = ctypes.c_void_p, ctypes.c_int


def emit(**fields) -> None:
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
    regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "Used" in ln]
    return ctypes.CDLL(str(lib)), regs


class Pair:
    """One build of the two kernels, called on lane-layout tensors."""

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="directory with the other tree's ffbs_fwd.cu and ffbs_bwd_sample.cu")
    ap.add_argument("--label", default="other", help="name of the other tree in the output")
    ap.add_argument("--out", type=Path, help="also write every record to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_ffbs_pair: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    records = [dict(phase="device", nvidia_smi=smi.splitlines()[0],
                    kind=torch.cuda.get_device_name(0), torch=torch.__version__)]
    emit(**records[-1])

    this_src = {f: (CSRC_DIR / f).read_text() for f in ("ffbs_fwd.cu", "ffbs_bwd_sample.cu")}
    other_src = {f: (args.other / f).read_text() for f in this_src}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        builds = {}

        def pair(label, fwd_text, bwd_text):
            fl, fr = build(fwd_text, f"{label}_fwd", work)
            bl, br = build(bwd_text, f"{label}_bwd", work)
            has_scratch = re.search(r"hhmm_ffbs_bwd_sample\([^)]*scratch", bwd_text, re.S)
            builds[label] = Pair(label, fl, bl, bool(has_scratch), {"fwd": fr, "bwd": br})

        pair(args.label, other_src["ffbs_fwd.cu"], other_src["ffbs_bwd_sample.cu"])
        pair("this", this_src["ffbs_fwd.cu"], this_src["ffbs_bwd_sample.cu"])
        for source, name, subs in VARIANTS:
            text = this_src[source]
            for old, new in subs.items():
                if old not in text:
                    raise RuntimeError(f"variant {name}: '{old}' not in {source}")
                text = text.replace(old, new)
            fwd = text if source == "ffbs_fwd.cu" else this_src["ffbs_fwd.cu"]
            bwd = text if source == "ffbs_bwd_sample.cu" else this_src["ffbs_bwd_sample.cu"]
            pair(name, fwd, bwd)
        for label, b in builds.items():
            records.append(dict(phase="build", label=label, ptxas=b.regs))
            emit(**records[-1])

        # every build bitwise equal to this checkout's
        for K in (3, 4):
            for gated in (False, True):
                lanes, u_t = make_lanes(10 + K + gated, 256, T_BENCH, K, gated)
                ll0, a0 = builds["this"].run_fwd(lanes)
                z0 = builds["this"].run_bwd(lanes, a0, u_t)
                for label, b in builds.items():
                    ll, a = b.run_fwd(lanes)
                    z = b.run_bwd(lanes, a0, u_t)
                    torch.cuda.synchronize()
                    if not (torch.equal(a, a0) and torch.equal(ll, ll0) and torch.equal(z, z0)):
                        raise AssertionError(f"{label} differs from this checkout at K={K} gated={gated}")
        records.append(dict(phase="agree", bitwise_equal=True, builds=list(builds)))
        emit(**records[-1])

        order = [args.label, "this"] + [v[1] for v in VARIANTS] + ["this", args.label]
        for N in LANES:
            lanes, u_t = make_lanes(7, N, T_BENCH, K_BENCH, False)
            _, alpha = builds["this"].run_fwd(lanes)
            reps = 50 if N <= 2048 else 20
            for turn, label in enumerate(order):
                b = builds[label]
                f = time_ms(lambda: b.run_fwd(lanes), reps)
                w = time_ms(lambda: b.run_bwd(lanes, alpha, u_t), reps)
                records.append(dict(phase="timing", label=label, turn=turn, N=N, T=T_BENCH,
                                    K=K_BENCH, fwd_ms=f, fwd_ns_per_step=f * 1e6 / T_BENCH,
                                    bwd_ms=w, bwd_ns_per_step=w * 1e6 / T_BENCH))
                emit(**records[-1])
            del lanes, u_t, alpha
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
