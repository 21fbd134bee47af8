"""HHMM structure DSL: node taxonomy, recursive simulator, and the
tree → flat-sparse-HMM compiler (counterpart of ``hhmm_tpu/hhmm``). The
hierarchy is the source of truth for model structure; the kernels only
ever see the compiled flat (π, A)."""

from hhmm_tpu_torch.hhmm.structure import (
    End,
    Internal,
    Production,
    finalize,
    iter_leaves,
    leaf_groups,
)
from hhmm_tpu_torch.hhmm.simulate import hhmm_sim, sample_emission
from hhmm_tpu_torch.hhmm.compile import (
    FlatHMM,
    compile_hhmm,
    gaussian_leaf_params,
    categorical_leaf_params,
)
from hhmm_tpu_torch.hhmm.examples import (
    hmix_tree,
    hier2x2_tree,
    fine1998_tree,
    tayal_tree,
    jangmin2004_tree,
)

__all__ = [
    "End",
    "Internal",
    "Production",
    "finalize",
    "iter_leaves",
    "leaf_groups",
    "hhmm_sim",
    "sample_emission",
    "FlatHMM",
    "compile_hhmm",
    "gaussian_leaf_params",
    "categorical_leaf_params",
    "hmix_tree",
    "hier2x2_tree",
    "fine1998_tree",
    "tayal_tree",
    "jangmin2004_tree",
]
