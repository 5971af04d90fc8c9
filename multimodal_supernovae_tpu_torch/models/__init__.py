from .clip import CLIPConfig, CLIPModel
from .clip_mlp import ClipMLPConfig, ClipMLPHead
from .convert import (
    convmixer_state_dict,
    mlp_state_dict,
    seq_encoder_state_dict,
    state_dict_from_jax,
    vit_state_dict,
)
from .convmixer import ConvMixer
from .factory import (
    finetune_model_builder,
    initialize_from_run_dir,
    load_model,
    load_run_config,
    masked_model_builder,
    pick_reference_ckpt,
    read_model_config,
    write_model_config,
)
from .mlp import MLP
from .pretraining import MaskedEncoderConfig, MaskedLightCurveEncoder
from .transformer import (
    SelfAttention,
    SequenceEncoder,
    TorchStyleMHA,
    Transformer,
    TransformerBlock,
    init_weights,
    time_positional_encoding,
)
from .vit import ViT, ViTBlock

__all__ = [
    "CLIPConfig",
    "CLIPModel",
    "ClipMLPConfig",
    "ClipMLPHead",
    "ConvMixer",
    "MLP",
    "MaskedEncoderConfig",
    "MaskedLightCurveEncoder",
    "SelfAttention",
    "SequenceEncoder",
    "TorchStyleMHA",
    "Transformer",
    "TransformerBlock",
    "ViT",
    "ViTBlock",
    "init_weights",
    "convmixer_state_dict",
    "finetune_model_builder",
    "initialize_from_run_dir",
    "load_model",
    "load_run_config",
    "masked_model_builder",
    "mlp_state_dict",
    "pick_reference_ckpt",
    "read_model_config",
    "seq_encoder_state_dict",
    "state_dict_from_jax",
    "time_positional_encoding",
    "vit_state_dict",
    "write_model_config",
]
