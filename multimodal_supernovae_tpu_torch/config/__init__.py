from .config import (
    BayesSearch,
    SweepConfig,
    SweepScheduler,
    build_clip_config,
    build_trainer_config,
    expand_grid,
    load_sweep,
)
from .yaml_subset import YAMLSubsetError, safe_load

__all__ = ["BayesSearch", "SweepConfig", "SweepScheduler", "YAMLSubsetError",
           "build_clip_config", "build_trainer_config", "expand_grid", "load_sweep",
           "safe_load"]
