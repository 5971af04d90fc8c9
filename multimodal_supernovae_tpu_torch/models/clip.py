"""The multimodal CLIP model (port of multimodal_supernovae_tpu/models/clip.py).

Per enabled modality an encoder plus a float32 projection to the shared
``enc_dim`` space: the ConvMixer image tower (host_galaxy), the light-curve
and spectral sequence encoders, and the meta tower (a class embedding beside
the repeated redshift, through an MLP). Three modes, as in the JAX package:

  * contrastive (default): ``encode`` returns the L2-normalised embeddings
    in the canonical order (host_galaxy, lightcurve, spectral, meta) and
    ``loss_fn`` the CLIP softmax or SigLIP sigmoid loss summed over every
    modality pair, with a learnable log logit-scale and logit-bias;
  * regression: the unnormalised embeddings, concatenated, through one
    Linear to a redshift, trained with the MSE;
  * classification: the same concatenation to ``n_classes`` logits, trained
    with the reference's class-weighted cross entropy.

``train=True`` applies dropout drawn from an explicit ``torch.Generator``
and puts the image tower's BatchNorm in batch-statistics mode, updating its
running statistics; eval mode (the default) uses the running ones. The
image and meta towers and the head compute in float32 whatever
``compute_dtype`` says (the JAX package builds them without a dtype). With
``image_encoder="vit"`` the image tower is the ViT (models/vit.py), whose
blocks compute in ``compute_dtype`` as the JAX tower's do; ``image_size``
sizes its positional embedding (a loaded state_dict brings its own).

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

from ..data.transforms import CLASS_WEIGHTS
from ..ops import losses as L
from .convmixer import ConvMixer
from .mlp import MLP
from .transformer import Dense, SequenceEncoder, init_weights
from .vit import DEFAULT_IMAGE_SIZE, ViT

MODALITIES = ("host_galaxy", "lightcurve", "spectral", "meta")


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

    def ck(self) -> Dict[str, Any]:
        return dict(self.conv_kwargs)

    def mk(self) -> Dict[str, Any]:
        return dict(self.meta_kwargs)

    def vk(self) -> Dict[str, Any]:
        return dict(self.vit_kwargs)

    @property
    def head_out(self) -> int:
        return self.n_classes if self.classification else 1

    @property
    def supervised(self) -> bool:
        return self.regression or self.classification


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class CLIPModel(nn.Module):
    """The towers of ``cfg.combinations``, each with its float32 projection
    to ``enc_dim``, and, for a supervised config, the ``linear`` head.
    Parameters are drawn from ``generator``. ``image_size`` is the side of
    the images a ViT tower takes (its ``pos_emb`` rows; default 60); the
    ConvMixer takes any."""

    def __init__(self, cfg: CLIPConfig, generator: Optional[torch.Generator] = None,
                 image_size: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        combos = set(cfg.combinations)
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(cfg.logit_scale_init), dtype=torch.float32))
        self.logit_bias = nn.Parameter(
            torch.tensor(cfg.logit_bias_init, dtype=torch.float32))
        if "lightcurve" in combos:
            tk = cfg.tk()
            self.lightcurve_encoder = SequenceEncoder(
                nband=cfg.nband, dtype=cfg.dtype, **tk)
            self.lightcurve_projection = Dense(tk["n_out"], cfg.enc_dim)
        if "spectral" in combos:
            tsk = cfg.tsk()
            self.spectral_encoder = SequenceEncoder(nband=1, dtype=cfg.dtype, **tsk)
            self.spectral_projection = Dense(tsk["n_out"], cfg.enc_dim)
        if "host_galaxy" in combos:
            if cfg.image_encoder == "vit":
                vk = cfg.vk()
                self.image_encoder = ViT(dtype=cfg.dtype,
                                         image_size=image_size or DEFAULT_IMAGE_SIZE, **vk)
                self.image_projection = Dense(vk["n_out"], cfg.enc_dim)
            elif cfg.image_encoder == "convmixer":
                ck = cfg.ck()
                self.image_encoder = ConvMixer(**ck)
                self.image_projection = Dense(ck["n_out"], cfg.enc_dim)
            else:
                raise ValueError(f"unknown image_encoder {cfg.image_encoder!r}: "
                                 "expected 'convmixer' or 'vit'")
        if "meta" in combos:
            mk = cfg.mk()
            half = mk["input_dim"] // 2
            self.class_emb = nn.Embedding(cfg.n_classes, half)
            self.meta_encoder = MLP(2 * half, mk["hidden_dim"], cfg.enc_dim,
                                    mk["num_layers"], mk.get("dropout", 0.0))
        if cfg.supervised:
            self.linear = Dense(cfg.enc_dim * len(combos), cfg.head_out)
        if cfg.classification and cfg.n_classes in CLASS_WEIGHTS:
            self.register_buffer("class_weights", torch.from_numpy(
                CLASS_WEIGHTS[cfg.n_classes]), persistent=False)
        else:
            self.class_weights = None
        init_weights(self, generator)
        if "meta" in combos:
            with torch.no_grad():  # torch.nn.Embedding's N(0, 1), from generator
                self.class_emb.weight.normal_(generator=generator)

    # -- per-modality embeddings (projection included) ---------------------

    def embed_image(self, x_img, train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    normalize: bool = True) -> torch.Tensor:
        h = self.image_projection(self.image_encoder(x_img, train, generator))
        return _l2_normalize(h) if normalize else h

    def embed_lightcurve(self, x, t, mask, train: bool = False,
                         generator: Optional[torch.Generator] = None,
                         normalize: bool = True) -> torch.Tensor:
        h = self.lightcurve_projection(
            self.lightcurve_encoder(x, t, mask, train, generator))
        return _l2_normalize(h) if normalize else h

    def embed_spectral(self, x, t, mask, train: bool = False,
                       generator: Optional[torch.Generator] = None,
                       normalize: bool = True) -> torch.Tensor:
        h = self.spectral_projection(self.spectral_encoder(x, t, mask, train, generator))
        return _l2_normalize(h) if normalize else h

    def embed_meta(self, label, redshift, train: bool = False,
                   generator: Optional[torch.Generator] = None,
                   normalize: bool = True) -> torch.Tensor:
        """Half class embedding, half the redshift repeated."""
        ce = self.class_emb(label.long())
        rz = redshift[:, None].to(ce.dtype).expand(-1, ce.shape[-1])
        h = self.meta_encoder(torch.cat([ce, rz], dim=-1), train, generator)
        return _l2_normalize(h) if normalize else h

    # -- forward -------------------------------------------------------------

    def encode(self, batch: Mapping[str, torch.Tensor], train: bool = False,
               generator: Optional[torch.Generator] = None,
               normalize: bool = True) -> List[torch.Tensor]:
        """Per-modality projected embeddings in canonical order (L2-normalised
        unless ``normalize=False``). ``batch`` holds the fields the towers
        read: x_img; x_lc, t_lc, mask_lc; x_sp, t_sp, mask_sp; label,
        redshift (others are ignored). ``train=True`` applies dropout from
        ``generator`` and BatchNorm's batch statistics."""
        combos = self.cfg.combinations
        out = []
        if "host_galaxy" in combos:
            out.append(self.embed_image(batch["x_img"], train, generator, normalize))
        if "lightcurve" in combos:
            out.append(self.embed_lightcurve(
                batch["x_lc"], batch["t_lc"], batch["mask_lc"], train, generator,
                normalize))
        if "spectral" in combos:
            out.append(self.embed_spectral(
                batch["x_sp"], batch["t_sp"], batch["mask_sp"], train, generator,
                normalize))
        if "meta" in combos:
            out.append(self.embed_meta(batch["label"], batch["redshift"], train,
                                       generator, normalize))
        return out

    def forward(self, batch: Mapping[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None):
        """The JAX ``__call__``. Contrastive: the list of normalised
        embeddings. Supervised: (B, head_out) from the concatenated
        unnormalised embeddings."""
        if self.cfg.supervised:
            embs = self.encode(batch, train, generator, normalize=False)
            return self.linear(torch.cat(embs, dim=-1))
        return self.encode(batch, train, generator)

    def loss_fn(self, batch: Mapping[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None, mesh=None,
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The training loss and the auxiliary outputs: regression, the MSE on
        ``redshift`` and ``{"pred": (B,)}``; classification, the
        class-weighted cross entropy on ``label`` and ``{"logits": ...}``;
        otherwise the contrastive loss (``cfg.loss``: 'softmax' for CLIP,
        'sigmoid' for SigLIP) over every modality pair and
        ``{"embeddings": [...]}``.

        ``mesh`` (a ``parallel.mesh.DataMesh``; the JAX ``gather_axis``):
        ``batch`` is this rank's rows, the outputs are all-gathered before
        the loss, so the loss is the global batch's on every rank, and the
        auxiliary outputs are the global batch's too."""
        cfg = self.cfg
        out = self(batch, train, generator)
        gather = (lambda t: t) if mesh is None else mesh.all_gather
        if cfg.regression:
            pred = gather(out[:, 0])
            return L.mse_loss(pred, gather(batch["redshift"])), {"pred": pred}
        if cfg.classification:
            out = gather(out)
            return (L.weighted_cross_entropy(out, gather(batch["label"]),
                                             self.class_weights), {"logits": out})
        pair_loss = {
            "sigmoid": L.sigmoid_loss_multimodal,
            "softmax": L.clip_loss_multimodal,
        }[cfg.loss]
        if mesh is not None:
            out = L.all_gather_embeddings(out, mesh)
        return pair_loss(out, self.logit_scale, self.logit_bias), {"embeddings": out}
