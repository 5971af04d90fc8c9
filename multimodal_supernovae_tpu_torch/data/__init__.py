from .augment import augment_batch, noise_from_error
from .batching import (
    BATCH_FIELDS,
    ArrayDataset,
    epoch_indices,
    tail_valid_mask,
    take,
)
from .synthetic import make_synthetic_arrays, make_synthetic_dataset

__all__ = [
    "ArrayDataset",
    "BATCH_FIELDS",
    "augment_batch",
    "epoch_indices",
    "make_synthetic_arrays",
    "make_synthetic_dataset",
    "noise_from_error",
    "tail_valid_mask",
    "take",
]
