"""Isolation of the PyTorch port from the JAX package, and its device
rules:

- no module of ``hhmm_tpu_torch/``, not ``chip_smoke.py`` and not
  ``bench_kernel_pair.py`` imports ``jax`` or ``hhmm_tpu`` (an AST scan of
  every import statement);
- entry points default to CUDA and raise on a host without it, rather
  than running on the CPU;
- a CUDA kernel request on a host without CUDA raises and never falls
  back to the plain version; importing the package builds and loads
  nothing.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import hhmm_tpu_torch
from hhmm_tpu_torch.apps.tayal import decode_states, wf_trade
from hhmm_tpu_torch.batch import default_init, fit_batched
from hhmm_tpu_torch.convert import constrained_from_jax, params_from_jax
from hhmm_tpu_torch.infer import (
    ChEESConfig,
    GibbsConfig,
    make_lp_bc,
    sample_chees,
    sample_chees_batched,
    sample_gibbs,
)
from hhmm_tpu_torch.kernels import cuda_semiring as cs
from hhmm_tpu_torch.kernels import cuda_traj as ct
from hhmm_tpu_torch.kernels import (
    ffbs_dispatch,
    forward_value_and_grad,
    make_tayal_trajectory,
    viterbi_dispatch,
)
from hhmm_tpu_torch.kernels import dispatch as kernel_dispatch
from hhmm_tpu_torch.kernels.cuda_build import BUILD_DIR, build
from hhmm_tpu_torch.models import GaussianHMM, TayalHHMM, TayalHHMMLite
from hhmm_tpu_torch.sim import tayal_batch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "hhmm_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py",
    REPO / "bench_kernel_pair.py",
]
FORBIDDEN = {"jax", "jaxlib", "hhmm_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_file_list_is_complete():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for must in (
        "chip_smoke.py",
        "bench_kernel_pair.py",
        "hhmm_tpu_torch/kernels/cuda_semiring.py",
        "hhmm_tpu_torch/infer/gibbs.py",
        "hhmm_tpu_torch/models/tayal.py",
        "hhmm_tpu_torch/kernels/vg.py",
        "hhmm_tpu_torch/kernels/cuda_traj.py",
        "hhmm_tpu_torch/infer/chees.py",
        "hhmm_tpu_torch/infer/run.py",
        "hhmm_tpu_torch/infer/nuts.py",
        "hhmm_tpu_torch/models/gaussian_hmm.py",
        "hhmm_tpu_torch/core/dists.py",
        "hhmm_tpu_torch/infer/relabel.py",
        "hhmm_tpu_torch/batch/fit.py",
        "hhmm_tpu_torch/batch/pad.py",
        "hhmm_tpu_torch/batch/cache.py",
        "hhmm_tpu_torch/native/__init__.py",
        "hhmm_tpu_torch/native/zigzag.py",
        "hhmm_tpu_torch/apps/tayal/wf.py",
        "hhmm_tpu_torch/apps/tayal/pipeline.py",
        "hhmm_tpu_torch/apps/tayal/features.py",
        "hhmm_tpu_torch/apps/tayal/analytics.py",
    ):
        assert must in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny():
    x = torch.tensor([[1, 2, 3, 4, 5, 6]])
    sign = torch.tensor([[0, 1, 0, 1, 0, 1]])
    return x, sign


ENTRY_POINTS = {
    "tayal_batch": lambda: tayal_batch(2, 8, seed=0),
    "default_init": lambda: default_init(TayalHHMM(), dict(zip(("x", "sign"), _tiny())), 1, 1),
    "sample_gibbs": lambda: sample_gibbs(
        TayalHHMM(gate_mode="hard"), dict(zip(("x", "sign"), _tiny())),
        torch.zeros(1, 1, 35), GibbsConfig(1, 1),
    ),
    "generated": lambda: TayalHHMMLite().generated(
        torch.zeros(2, 35),
        {"x": _tiny()[0][0], "sign": _tiny()[1][0], "x_oos": _tiny()[0][0], "sign_oos": _tiny()[1][0]},
    ),
    "make_lp_bc": lambda: make_lp_bc(TayalHHMM(), dict(zip(("x", "sign"), _tiny()))),
    "make_tayal_trajectory": lambda: make_tayal_trajectory(dict(zip(("x", "sign"), _tiny())), 4),
    "sample_chees_batched": lambda: sample_chees_batched(
        lambda q: (q.sum(-1), q), torch.zeros(1, 2, 3), ChEESConfig(2, 2, num_chains=2)
    ),
    "sample_chees": lambda: sample_chees(
        lambda q: -(q * q).sum(-1), torch.zeros(2, 3), ChEESConfig(2, 2, num_chains=2)
    ),
    "params_from_jax": lambda: params_from_jax(TayalHHMM(), np.zeros((2, 35))),
    "base_generated": lambda: TayalHHMM(gate_mode="hard").generated(
        torch.zeros(2, 35), {"x": _tiny()[0][0], "sign": _tiny()[1][0]}
    ),
    "gaussian_generated": lambda: GaussianHMM(3).generated(
        torch.zeros(2, GaussianHMM(3).n_free), {"x": torch.zeros(6)}
    ),
    "state_draws": lambda: GaussianHMM(3).state_draws(
        torch.Generator(), torch.zeros(2, GaussianHMM(3).n_free), {"x": torch.zeros(6)}
    ),
    "fit_batched": lambda: fit_batched(
        TayalHHMM(gate_mode="hard"), dict(zip(("x", "sign"), _tiny())), GibbsConfig(1, 1)
    ),
    "wf_trade": lambda: wf_trade([]),
    "decode_states": lambda: decode_states(
        TayalHHMMLite(), np.zeros((2, 35)),
        {"x": _tiny()[0][0], "sign": _tiny()[1][0], "x_oos": _tiny()[0][0], "sign_oos": _tiny()[1][0]},
    ),
    "filtered": lambda: TayalHHMMLite().filtered(
        torch.zeros(2, 35),
        {"x": _tiny()[0][0], "sign": _tiny()[1][0], "x_oos": _tiny()[0][0], "sign_oos": _tiny()[1][0]},
    ),
    "constrained_from_jax": lambda: constrained_from_jax(
        TayalHHMM(), {"p_11": np.float32(0.5), "A_row": np.full((2, 2), 0.5),
                      "phi_k": np.full((4, 9), 1 / 9)},
    ),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name]()


def test_explicit_cpu_runs_the_plain_path(no_cuda):
    x, sign = tayal_batch(2, 8, seed=0, device="cpu")
    assert x.device.type == "cpu" and x.shape == (2, 8)


def test_kernel_build_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.build_kernels()
    with pytest.raises(RuntimeError, match="CUDA"):
        build([cs.FWD.source])
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.FWD.load()
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.TRAJ.load()
    assert all(k.launches == 0 for k in cs.KERNELS + ct.KERNELS)


def test_cuda_request_never_falls_back_to_plain(no_cuda, monkeypatch):
    """A CUDA operand reaches the kernel wrapper, which must raise (here:
    no CUDA to build for) instead of running the plain version."""
    called = []
    monkeypatch.setattr(cs, "fwd_plain", lambda *a: called.append("plain"))
    monkeypatch.setattr(cs, "bwd_sample_plain", lambda *a: called.append("plain"))

    class _CudaLike(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    def cudalike(t):
        return t.as_subclass(_CudaLike)

    monkeypatch.setattr(cs, "vg_bwd_plain", lambda *a: called.append("plain"))
    monkeypatch.setattr(ct, "traj_plain", lambda *a: called.append("plain"))
    K, N, T = 4, 3, 5
    lanes = [cudalike(torch.zeros(s)) for s in ((K, N), (K, K, N), (T, K, N), (T, N))]
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.fwd_lanes(*lanes)
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.bwd_sample_lanes(lanes[1], lanes[3], cudalike(torch.zeros(T, K, N)), lanes[3])
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.vg_bwd_lanes(lanes[1], lanes[2], lanes[3], cudalike(torch.zeros(T, K, N)),
                        cudalike(torch.zeros(N)))
    B, C, D = 3, 2, ct.DIM
    f32 = [cudalike(torch.zeros(s)) for s in ((D, B * C), (D, B * C), (D, B * C), (D, B))]
    data = [cudalike(torch.zeros((T, B), dtype=torch.int32)) for _ in range(2)]
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.traj_lanes(*f32, *data, cudalike(torch.ones(T, B)), cudalike(torch.ones(1)),
                      cudalike(torch.ones(1, dtype=torch.int32)), 4, C)
    assert called == []


def test_cuda_vg_rejects_what_the_kernels_do_not_take(monkeypatch):
    """On a CUDA operand the value-and-grad entry checks K and the dtype
    and raises, rather than running the plain pair."""
    monkeypatch.setattr(cs, "vg_bwd_plain", lambda *a: pytest.fail("plain version ran"))

    class _CudaLike(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    def args(K, dtype=torch.float32):
        shapes = ((2, K), (2, K, K), (2, 5, K), (2, 5))
        return [torch.zeros(s, dtype=dtype).as_subclass(_CudaLike) for s in shapes]

    with pytest.raises(ValueError, match="K in 2..128"):
        forward_value_and_grad(*args(129))
    with pytest.raises(TypeError, match="float32"):
        forward_value_and_grad(*args(4, torch.float64))


@pytest.mark.parametrize("which", ["fwd", "bwd", "dispatch", "vg", "traj"])
def test_other_devices_raise(which):
    meta = dict(device="meta")
    if which == "fwd":
        with pytest.raises(ValueError, match="no kernel"):
            cs.fwd_lanes(torch.zeros(4, 2, **meta), torch.zeros(4, 4, 2, **meta),
                         torch.zeros(3, 4, 2, **meta), torch.zeros(3, 2, **meta))
    elif which == "bwd":
        with pytest.raises(ValueError, match="no kernel"):
            cs.bwd_sample_lanes(torch.zeros(4, 4, 2, **meta), torch.zeros(3, 2, **meta),
                                torch.zeros(3, 4, 2, **meta), torch.zeros(3, 2, **meta))
    elif which == "vg":
        with pytest.raises(ValueError, match="no kernel"):
            forward_value_and_grad(torch.zeros(2, 4, **meta), torch.zeros(2, 4, 4, **meta),
                                   torch.zeros(2, 3, 4, **meta), torch.zeros(2, 3, **meta))
    elif which == "traj":
        i32 = dict(dtype=torch.int32, **meta)
        with pytest.raises(ValueError, match="no kernel"):
            ct.traj_lanes(*(torch.zeros(ct.DIM, 2, **meta) for _ in range(4)),
                          torch.zeros(3, 2, **i32), torch.zeros(3, 2, **i32),
                          torch.zeros(3, 2, **meta), torch.zeros(1, **meta),
                          torch.zeros(1, **i32), 4, 1)
    else:
        with pytest.raises(ValueError, match="no FFBS path"):
            ffbs_dispatch(None, torch.zeros(2, 4, **meta), torch.zeros(2, 4, 4, **meta),
                          torch.zeros(2, 3, 4, **meta))


def test_homogeneous_viterbi_on_cuda_is_not_silently_plain(no_cuda, monkeypatch):
    """A homogeneous ``log_A`` on CUDA goes to the Viterbi kernels (here:
    no card to build for, so the wrapper raises) and never to the scan
    or the plain versions."""
    monkeypatch.setattr(cs, "viterbi_plain", lambda *a: pytest.fail("plain version ran"))
    monkeypatch.setattr(cs, "backtrack_plain", lambda *a: pytest.fail("plain version ran"))
    monkeypatch.setattr(kernel_dispatch, "viterbi", lambda *a: pytest.fail("scan ran"))

    class _CudaLike(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    shapes = ((2, 4), (2, 4, 4), (2, 6, 4), (2, 6))
    args = [torch.ones(s).as_subclass(_CudaLike) for s in shapes]
    with pytest.raises(RuntimeError, match="CUDA"):
        viterbi_dispatch(*args)


def test_cuda_decode_request_never_falls_back_to_plain(no_cuda, monkeypatch):
    """The decode kernels' wrappers raise on a CUDA operand without a card
    to build for, and never run their plain versions."""
    for name in ("filter_plain", "beta_plain", "viterbi_plain", "backtrack_plain"):
        monkeypatch.setattr(cs, name, lambda *a: pytest.fail("plain version ran"))

    class _CudaLike(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    K, N, T = 3, 4, 5
    pi, A, obs, mask = (
        torch.zeros(s).as_subclass(_CudaLike) for s in ((K, N), (K, K, N), (T, K, N), (T, N))
    )
    back = torch.zeros((T, N), dtype=torch.int32).as_subclass(_CudaLike)
    for call in (
        lambda: cs.filter_lanes(pi, A, obs, mask),
        lambda: cs.beta_lanes(A, obs, mask),
        lambda: cs.viterbi_lanes(pi, A, obs, mask),
        lambda: cs.backtrack_lanes(back, pi),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert all(k.launches == 0 for k in (cs.FILTER, cs.BETA, cs.VITERBI, cs.BACKTRACK))


def test_import_builds_and_loads_nothing():
    assert hhmm_tpu_torch.resolve_device("cpu").type == "cpu"
    assert all(k._fn is None for k in cs.KERNELS) or torch.cuda.is_available()
    if not torch.cuda.is_available():
        assert not BUILD_DIR.exists() or not any(BUILD_DIR.glob("*.so"))


def test_import_builds_no_native_library():
    """Importing the port, its apps included, neither builds nor loads
    the native extractor (a fresh interpreter: other tests in this
    process may have built it)."""
    import subprocess
    import sys

    code = (
        "import hhmm_tpu_torch.apps.tayal, hhmm_tpu_torch.batch\n"
        "import hhmm_tpu_torch.native as n\n"
        "assert n._handle is None and not n._tried\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
