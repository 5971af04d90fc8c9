"""Train/val splitting: random fraction or stratified k-fold, in numpy (port
of multimodal_supernovae_tpu/data/folds.py, which calls scikit-learn).

The reference's two split modes (script_wandb.py:44-52) are
``train_test_split(range(n), test_size=val_fraction, random_state=seed)``
and ``StratifiedKFold(n_splits=kfolds)`` on the class labels
(dataloader.py:893-903). Both are reproduced index for index: the split
manifests of a run directory name them.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np


def stratified_kfolds(labels: np.ndarray, kfolds: int = 5) -> List[Dict[str, np.ndarray]]:
    """List of {'train_indices', 'test_indices'} dicts, one per fold: those of
    scikit-learn's ``StratifiedKFold(n_splits=kfolds)`` (no shuffle).

    Its allocation: classes are numbered by first appearance; the sorted
    codes are dealt round robin, so fold i holds the class counts of every
    k-th code from position i; within each class the samples, in order, go
    to the folds in blocks of those counts."""
    y = np.asarray(labels)
    if y.ndim != 1:
        y = y.reshape(-1)
    k = int(kfolds)
    if k < 2:
        raise ValueError(f"k-fold cross-validation requires at least two folds, got {k}")
    if k > len(y):
        raise ValueError(f"Cannot have number of splits n_splits={k} greater than the "
                         f"number of samples: n_samples={len(y)}.")
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(k > y_counts):
        raise ValueError(f"n_splits={k} cannot be greater than the number of members in "
                         "each class.")
    if k > y_counts.min():
        warnings.warn(f"The least populated class in y has only {y_counts.min()} members, "
                      f"which is less than n_splits={k}.", UserWarning)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::k], minlength=n_classes)
                             for i in range(k)])
    test_folds = np.empty(len(y), dtype=np.int32)
    for c in range(n_classes):
        test_folds[y_encoded == c] = np.arange(k).repeat(allocation[:, c])
    indices = np.arange(len(y))
    return [{"train_indices": indices[test_folds != i], "test_indices": indices[test_folds == i]}
            for i in range(k)]


def random_split(n: int, val_fraction: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Random train/val index split: scikit-learn's ``train_test_split(
    np.arange(n), test_size=val_fraction, random_state=seed)``, that is the
    first ``ceil(val_fraction * n)`` of ``RandomState(seed).permutation(n)``
    for validation and the rest for training."""
    f = float(val_fraction)
    if not 0 < f < 1:
        raise ValueError(f"test_size={val_fraction} should be a float in the (0, 1) range")
    n_test = math.ceil(f * n)
    n_train = n - n_test
    if n_train <= 0:
        raise ValueError(f"With n_samples={n}, test_size={val_fraction}, the resulting "
                         "train set will be empty.")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:n_test + n_train], perm[:n_test]


def split_for_run(
    n: int,
    val_fraction: float,
    seed: int,
    folds: Optional[List[Dict[str, np.ndarray]]] = None,
    foldnumber: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The per-run split rule of train_sweep (script_wandb.py:44-52):
    fold indices when a stratified fold plan exists, else a random split."""
    if folds is not None and foldnumber is not None:
        f = folds[foldnumber]
        return np.asarray(f["train_indices"]), np.asarray(f["test_indices"])
    return random_split(n, val_fraction, seed)
