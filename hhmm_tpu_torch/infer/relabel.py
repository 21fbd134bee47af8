"""Label-switching utilities: confusion matrices and greedy relabeling
(counterpart of ``hhmm_tpu/infer/relabel.py``; NumPy only).

The reference's greedy confusion-matrix relabeling
(`iohmm-reg/main.R:78-94`) and the confusion tables used as
state-recovery checks (`hmm/main.R:89-94`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["confusion_matrix", "greedy_relabel", "apply_relabel"]


def confusion_matrix(z_true: np.ndarray, z_hat: np.ndarray, K: int) -> np.ndarray:
    """``C[i, j]`` = # steps with true state i classified as j."""
    C = np.zeros((K, K), dtype=np.int64)
    np.add.at(C, (np.asarray(z_true).ravel(), np.asarray(z_hat).ravel()), 1)
    return C


def greedy_relabel(z_true: np.ndarray, z_hat: np.ndarray, K: int) -> np.ndarray:
    """Greedy assignment: repeatedly take the largest cell of the
    confusion matrix and map that estimated label to that true label.
    Returns ``perm`` with ``perm[estimated] = true``."""
    C = confusion_matrix(z_true, z_hat, K).astype(np.float64)
    perm = np.full(K, -1, dtype=np.int64)
    used_true = np.zeros(K, dtype=bool)
    used_est = np.zeros(K, dtype=bool)
    for _ in range(K):
        masked = C.copy()
        masked[used_true, :] = -1
        masked[:, used_est] = -1
        i, j = np.unravel_index(np.argmax(masked), C.shape)
        perm[j] = i
        used_true[i] = True
        used_est[j] = True
    return perm


def apply_relabel(z_hat: np.ndarray, perm: np.ndarray) -> np.ndarray:
    return np.asarray(perm)[np.asarray(z_hat)]
