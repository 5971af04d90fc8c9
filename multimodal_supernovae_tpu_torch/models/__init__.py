from .clip import CLIPConfig, CLIPModel
from .convert import seq_encoder_state_dict, state_dict_from_jax
from .factory import (
    initialize_from_run_dir,
    load_model,
    load_run_config,
    pick_reference_ckpt,
    read_model_config,
    write_model_config,
)
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
    "SelfAttention",
    "SequenceEncoder",
    "TorchStyleMHA",
    "Transformer",
    "TransformerBlock",
    "init_weights",
    "initialize_from_run_dir",
    "load_model",
    "load_run_config",
    "pick_reference_ckpt",
    "read_model_config",
    "seq_encoder_state_dict",
    "state_dict_from_jax",
    "time_positional_encoding",
    "write_model_config",
]
