from .augment import (
    augment_batch,
    contiguous_span_mask,
    image_uniform_noise,
    noise_from_error,
    random_rot90,
    random_subset_mask,
)
from .batching import (
    BATCH_FIELDS,
    ArrayDataset,
    epoch_indices,
    tail_valid_mask,
    take,
)
from .simulation import (
    ingest_simulation,
    ingest_simulation_lightcurves,
    iter_simulation_chunks,
    stream_simulation_to_cache,
)
from .synthetic import make_synthetic_arrays, make_synthetic_dataset

__all__ = [
    "ArrayDataset",
    "BATCH_FIELDS",
    "augment_batch",
    "contiguous_span_mask",
    "epoch_indices",
    "image_uniform_noise",
    "ingest_simulation",
    "ingest_simulation_lightcurves",
    "iter_simulation_chunks",
    "make_synthetic_arrays",
    "make_synthetic_dataset",
    "noise_from_error",
    "random_rot90",
    "random_subset_mask",
    "stream_simulation_to_cache",
    "tail_valid_mask",
    "take",
]
