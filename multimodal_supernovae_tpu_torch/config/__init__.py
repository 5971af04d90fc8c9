from .config import (
    SweepConfig,
    build_clip_config,
    build_trainer_config,
    expand_grid,
    load_sweep,
)
from .yaml_subset import YAMLSubsetError, safe_load

__all__ = ["SweepConfig", "YAMLSubsetError", "build_clip_config", "build_trainer_config",
           "expand_grid", "load_sweep", "safe_load"]
