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
from .streaming import (
    ShardedDataset,
    ValHoldout,
    load_val_split,
    save_val_split,
    shard_epoch_schedule,
    write_sharded_cache,
)
from .synthetic import make_synthetic_arrays, make_synthetic_dataset

__all__ = [
    "ArrayDataset",
    "BATCH_FIELDS",
    "ShardedDataset",
    "ValHoldout",
    "augment_batch",
    "contiguous_span_mask",
    "epoch_indices",
    "image_uniform_noise",
    "ingest_simulation",
    "ingest_simulation_lightcurves",
    "iter_simulation_chunks",
    "load_val_split",
    "make_synthetic_arrays",
    "make_synthetic_dataset",
    "noise_from_error",
    "random_rot90",
    "random_subset_mask",
    "save_val_split",
    "shard_epoch_schedule",
    "stream_simulation_to_cache",
    "tail_valid_mask",
    "take",
    "write_sharded_cache",
]
