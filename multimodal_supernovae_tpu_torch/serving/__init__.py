from .batcher import BatcherStats, DynamicBatcher
from .server import EmbedServer, ServingModel, input_spec, load_artifact, load_live, serve

__all__ = ["BatcherStats", "DynamicBatcher", "EmbedServer", "ServingModel",
           "input_spec", "load_artifact", "load_live", "serve"]
