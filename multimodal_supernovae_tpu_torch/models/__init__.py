from .clip import CLIPConfig, CLIPModel
from .convert import (
    convmixer_state_dict,
    mlp_state_dict,
    seq_encoder_state_dict,
    state_dict_from_jax,
)
from .convmixer import ConvMixer
from .factory import (
    initialize_from_run_dir,
    load_model,
    load_run_config,
    pick_reference_ckpt,
    read_model_config,
    write_model_config,
)
from .mlp import MLP
from .transformer import (
    SelfAttention,
    SequenceEncoder,
    TorchStyleMHA,
    Transformer,
    TransformerBlock,
    init_weights,
    time_positional_encoding,
)

__all__ = [
    "CLIPConfig",
    "CLIPModel",
    "ConvMixer",
    "MLP",
    "SelfAttention",
    "SequenceEncoder",
    "TorchStyleMHA",
    "Transformer",
    "TransformerBlock",
    "init_weights",
    "convmixer_state_dict",
    "initialize_from_run_dir",
    "load_model",
    "load_run_config",
    "mlp_state_dict",
    "pick_reference_ckpt",
    "read_model_config",
    "seq_encoder_state_dict",
    "state_dict_from_jax",
    "time_positional_encoding",
    "write_model_config",
]
