"""Log-space math, constraint bijectors and distributions."""

from hhmm_tpu_torch.core import dists
from hhmm_tpu_torch.core.bijectors import (
    Bijector,
    Identity,
    MaskedSimplex,
    Ordered,
    Positive,
    Simplex,
    UnitInterval,
)
from hhmm_tpu_torch.core.lmath import (
    MASK_NEG,
    log_matvec,
    log_normalize,
    log_vecmat,
    safe_log,
    safe_log_normalize,
    safe_logsumexp,
)

__all__ = [
    "Bijector",
    "Identity",
    "MaskedSimplex",
    "Ordered",
    "Positive",
    "Simplex",
    "UnitInterval",
    "MASK_NEG",
    "dists",
    "log_matvec",
    "log_normalize",
    "log_vecmat",
    "safe_log",
    "safe_log_normalize",
    "safe_logsumexp",
]
