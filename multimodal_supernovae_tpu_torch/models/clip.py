"""The multimodal CLIP model (port of multimodal_supernovae_tpu/models/clip.py).

Ported: the light-curve and spectral towers, their projections to the
shared ``enc_dim`` space, L2 normalisation and the learnable log
logit-scale and logit-bias; ``encode`` (the JAX ``__call__``: serving,
eval mode by default) and the contrastive ``loss_fn`` with the CLIP softmax
or SigLIP sigmoid loss, in train or eval mode. Dropout in train mode draws
from an explicit ``torch.Generator``. The image and meta towers and the
supervised heads are not ported yet (ROADMAP.md queue 1, item 11) and raise
``NotImplementedError``.

``CLIPConfig`` is a jax-free copy of the JAX dataclass, with the same fields
and defaults, so a ``model_config.json`` written by either side parses. Its
``transformer_kwargs`` / ``transformer_spectral_kwargs`` go to the towers'
``SequenceEncoder`` as they are, ``use_fused_block`` included (the fused
block path, models/transformer.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import losses as L
from .transformer import Dense, SequenceEncoder, init_weights

MODALITIES = ("host_galaxy", "lightcurve", "spectral", "meta")
PORTED_MODALITIES = ("lightcurve", "spectral")
_NOT_PORTED = "not ported yet (ROADMAP.md queue 1, item 11: image and meta towers)"


def _default_seq_kwargs() -> Dict[str, Any]:
    return {"n_out": 128, "emb": 256, "heads": 2, "depth": 8, "time_norm": 10000.0}


def _default_conv_kwargs() -> Dict[str, Any]:
    return {"dim": 32, "depth": 8, "channels": 3, "kernel_size": 5,
            "patch_size": 10, "n_out": 128}


def _default_meta_kwargs() -> Dict[str, Any]:
    return {"input_dim": 128, "hidden_dim": 128, "num_layers": 2}


def _default_vit_kwargs() -> Dict[str, Any]:
    return {"emb": 128, "depth": 6, "heads": 4, "patch_size": 10,
            "mlp_mult": 4, "n_out": 128}


def _tuplify(x):
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Static model configuration: the JAX ``CLIPConfig``'s fields and
    defaults. ``use_pallas`` is a TPU knob, kept for the schema and unused."""

    combinations: Tuple[str, ...] = ("host_galaxy", "spectral")
    enc_dim: int = 128
    logit_scale_init: float = 10.0
    logit_bias_init: float = -10.0
    nband: int = 1
    transformer_kwargs: Tuple[Tuple[str, Any], ...] = ()
    transformer_spectral_kwargs: Tuple[Tuple[str, Any], ...] = ()
    conv_kwargs: Tuple[Tuple[str, Any], ...] = ()
    meta_kwargs: Tuple[Tuple[str, Any], ...] = ()
    image_encoder: str = "convmixer"
    vit_kwargs: Tuple[Tuple[str, Any], ...] = ()
    loss: str = "sigmoid"  # 'sigmoid' | 'softmax'
    regression: bool = False
    classification: bool = False
    n_classes: int = 5
    use_pallas: Optional[bool] = None
    # 'bfloat16' runs the encoder layers in bf16 (params, LayerNorm
    # statistics, the final projections stay float32). None = float32.
    compute_dtype: Optional[str] = None

    @classmethod
    def create(
        cls,
        combinations: Sequence[str] = ("host_galaxy", "spectral"),
        transformer_kwargs: Optional[Dict[str, Any]] = None,
        transformer_spectral_kwargs: Optional[Dict[str, Any]] = None,
        conv_kwargs: Optional[Dict[str, Any]] = None,
        meta_kwargs: Optional[Dict[str, Any]] = None,
        vit_kwargs: Optional[Dict[str, Any]] = None,
        **kw,
    ) -> "CLIPConfig":
        def freeze(d, default):
            merged = dict(default)
            merged.update(d or {})
            return tuple(sorted(merged.items()))

        combos = tuple(m for m in MODALITIES if m in set(combinations))
        return cls(
            combinations=combos,
            transformer_kwargs=freeze(transformer_kwargs, _default_seq_kwargs()),
            transformer_spectral_kwargs=freeze(
                transformer_spectral_kwargs, _default_seq_kwargs()),
            conv_kwargs=freeze(conv_kwargs, _default_conv_kwargs()),
            meta_kwargs=freeze(meta_kwargs, _default_meta_kwargs()),
            vit_kwargs=freeze(vit_kwargs, _default_vit_kwargs()),
            **kw,
        )

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CLIPConfig":
        """The ``config`` entry of a ``model_config.json`` sidecar (JSON lists
        back to the dataclass's tuples)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: _tuplify(v) for k, v in d.items() if k in names})

    @property
    def dtype(self) -> Optional[torch.dtype]:
        if not self.compute_dtype:
            return None
        dt = getattr(torch, self.compute_dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        return dt

    def tk(self) -> Dict[str, Any]:
        return dict(self.transformer_kwargs)

    def tsk(self) -> Dict[str, Any]:
        return dict(self.transformer_spectral_kwargs)

    @property
    def supervised(self) -> bool:
        return self.regression or self.classification


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class CLIPModel(nn.Module):
    """Per enabled modality a sequence encoder plus a float32 projection to
    ``enc_dim``; ``encode`` returns the L2-normalised embeddings in the
    canonical modality order and ``loss_fn`` the contrastive loss over
    them. Parameters are drawn from ``generator``."""

    def __init__(self, cfg: CLIPConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        missing = sorted(set(cfg.combinations) - set(PORTED_MODALITIES))
        if missing:
            raise NotImplementedError(f"towers {missing} are {_NOT_PORTED}")
        if cfg.supervised:
            raise NotImplementedError(f"supervised heads are {_NOT_PORTED}")
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(cfg.logit_scale_init), dtype=torch.float32))
        self.logit_bias = nn.Parameter(
            torch.tensor(cfg.logit_bias_init, dtype=torch.float32))
        if "lightcurve" in cfg.combinations:
            tk = cfg.tk()
            self.lightcurve_encoder = SequenceEncoder(
                nband=cfg.nband, dtype=cfg.dtype, **tk)
            self.lightcurve_projection = Dense(tk["n_out"], cfg.enc_dim)
        if "spectral" in cfg.combinations:
            tsk = cfg.tsk()
            self.spectral_encoder = SequenceEncoder(nband=1, dtype=cfg.dtype, **tsk)
            self.spectral_projection = Dense(tsk["n_out"], cfg.enc_dim)
        init_weights(self, generator)

    def embed_lightcurve(self, x, t, mask, train: bool = False,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return _l2_normalize(self.lightcurve_projection(
            self.lightcurve_encoder(x, t, mask, train, generator)))

    def embed_spectral(self, x, t, mask, train: bool = False,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return _l2_normalize(self.spectral_projection(
            self.spectral_encoder(x, t, mask, train, generator)))

    def encode(self, batch: Mapping[str, torch.Tensor], train: bool = False,
               generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """L2-normalised per-modality embeddings in canonical order;
        ``batch`` holds the fields x_lc, t_lc, mask_lc, x_sp, t_sp, mask_sp
        (others are ignored). ``train=True`` applies dropout from
        ``generator``."""
        out = []
        if "lightcurve" in self.cfg.combinations:
            out.append(self.embed_lightcurve(
                batch["x_lc"], batch["t_lc"], batch["mask_lc"], train, generator))
        if "spectral" in self.cfg.combinations:
            out.append(self.embed_spectral(
                batch["x_sp"], batch["t_sp"], batch["mask_sp"], train, generator))
        return out

    def loss_fn(self, batch: Mapping[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The contrastive loss (``cfg.loss``: 'softmax' for CLIP, 'sigmoid'
        for SigLIP) over all modality pairs, and ``{"embeddings": [...]}``."""
        out = self.encode(batch, train, generator)
        pair_loss = {
            "sigmoid": L.sigmoid_loss_multimodal,
            "softmax": L.clip_loss_multimodal,
        }[self.cfg.loss]
        return pair_loss(out, self.logit_scale, self.logit_bias), {"embeddings": out}
