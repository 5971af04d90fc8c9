from .mesh import DATA_AXIS, MODEL_AXIS, DataMesh, batch_stats_over, make_mesh
from .distributed import (
    add_mesh_args,
    initialize as initialize_distributed,
    make_global_mesh,
    mesh_from_args,
)
from .sharding import gather_state_dict, shard_module, shard_state_dict, spec_for

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "DataMesh",
    "gather_state_dict",
    "add_mesh_args",
    "batch_stats_over",
    "initialize_distributed",
    "make_global_mesh",
    "make_mesh",
    "mesh_from_args",
    "shard_module",
    "shard_state_dict",
    "spec_for",
]
