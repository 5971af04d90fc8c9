from multimodal_supernovae_tpu.serving.server import EmbedServer, ServingModel, serve

from .server import input_spec, load_live

__all__ = ["EmbedServer", "ServingModel", "input_spec", "load_live", "serve"]
