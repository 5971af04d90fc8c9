"""The batch contract and device-resident batching (port of
multimodal_supernovae_tpu/data/batching.py, without jax).

A batch is a dict that maps a subset of the 11 ``BATCH_FIELDS`` to tensors
with a shared leading dimension. For training, the whole dataset is moved
to the device once (``ArrayDataset.to_device``) and every batch is an
on-device ``index_select`` from an index plan (``take``), so no per-batch
host work sits in the loop. ``epoch_indices`` and ``tail_valid_mask`` are
copies of the JAX functions and draw the same numbers from the same
``np.random.Generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

# Shapes (B = batch, T = band-blocked LC length, S = spectrum length):
#   x_img (B, H, W, C) float NHWC; x_lc, t_lc, err_lc (B, T) float;
#   mask_lc (B, T) bool; x_sp, t_sp, err_sp (B, S) float; mask_sp (B, S)
#   bool; redshift (B,) float; label (B,) int32.
BATCH_FIELDS = (
    "x_img", "x_lc", "t_lc", "mask_lc", "err_lc",
    "x_sp", "t_sp", "mask_sp", "err_sp", "redshift", "label",
)


def take(batch: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Gather rows by index on the batch's device (``index_select``)."""
    return {k: v.index_select(0, idx) for k, v in batch.items()}


class ArrayDataset:
    """A dataset fully materialised as fixed-shape numpy arrays.

    ``arrays`` maps a subset of BATCH_FIELDS to arrays with a shared leading
    dimension; ``filenames`` keeps the per-row identifier."""

    def __init__(self, arrays: Dict[str, np.ndarray],
                 filenames: Optional[Sequence[str]] = None):
        unknown = set(arrays) - set(BATCH_FIELDS)
        if unknown:
            raise ValueError(f"unknown batch fields: {sorted(unknown)}")
        lengths = {k: len(v) for k, v in arrays.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"inconsistent lengths: {lengths}")
        self.arrays = dict(arrays)
        self.n = next(iter(lengths.values())) if lengths else 0
        self.filenames = None if filenames is None else list(filenames)
        if self.filenames is not None and len(self.filenames) != self.n:
            raise ValueError("filenames length mismatch")

    def __len__(self) -> int:
        return self.n

    def subset(self, indices) -> "ArrayDataset":
        indices = np.asarray(indices)
        names = (None if self.filenames is None
                 else [self.filenames[i] for i in indices])
        return ArrayDataset({k: v[indices] for k, v in self.arrays.items()}, names)

    def subset_by_filenames(self, names: Sequence[str]) -> "ArrayDataset":
        """The rows named in a split manifest, in the dataset's order; raises
        when a name is not in the dataset."""
        if self.filenames is None:
            raise ValueError("dataset has no filenames")
        wanted = set(names)
        missing = wanted - set(self.filenames)
        if missing:
            raise ValueError(f"{len(missing)} manifest filenames not in dataset")
        return self.subset(np.asarray(
            [i for i, f in enumerate(self.filenames) if f in wanted], dtype=np.int64))

    def to_device(self, device="cpu") -> Dict[str, torch.Tensor]:
        """The full dataset as a dict of tensors on ``device``."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in self.arrays.items()}


def epoch_indices(
    n: int,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
    pad: str = "wrap",
) -> np.ndarray:
    """Index plan for one epoch: shape (steps, batch_size) int32.

    Batch shapes are fixed, so the ragged tail is handled by ``pad``:
      * "wrap": tail positions reuse indices from the epoch start (training);
      * "repeat_last": tail positions repeat the final index; pair with
        ``tail_valid_mask`` to drop duplicates from metrics (evaluation);
      * "drop": drop the incomplete tail batch."""
    order = np.arange(n, dtype=np.int32)
    if shuffle:
        if rng is None:
            raise ValueError("shuffle requires a Generator")
        order = rng.permutation(n).astype(np.int32)
    if n == 0:
        return np.zeros((0, batch_size), dtype=np.int32)
    steps = n // batch_size if pad == "drop" else -(-n // batch_size)
    total = steps * batch_size
    if total <= n:
        flat = order[:total]
    elif pad == "wrap":
        # the pad may need more than one extra pass when batch_size > 2n
        flat = np.tile(order, -(-total // n))[:total]
    else:  # repeat_last
        flat = np.concatenate([order, np.full(total - n, order[-1], np.int32)])
    return flat.reshape(steps, batch_size)


def tail_valid_mask(n: int, batch_size: int) -> np.ndarray:
    """(steps, batch_size) bool marking the non-duplicated positions of a
    ``pad='repeat_last'`` plan."""
    steps = -(-n // batch_size)
    mask = np.zeros((steps * batch_size,), dtype=bool)
    mask[:n] = True
    return mask.reshape(steps, batch_size)
