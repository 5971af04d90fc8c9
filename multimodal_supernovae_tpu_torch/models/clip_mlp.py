"""An MLP head over CLIP embeddings (port of
multimodal_supernovae_tpu/models/clip_mlp.py).

The L2-normalised light-curve and/or spectral embeddings of a CLIP model are
concatenated and fed to an MLP, for redshift regression (MSE) or SN-type
classification (the class-weighted cross entropy). Freezing the CLIP
backbone happens outside the module, in the optimizer
(``training.optim.freeze_encoders_except_projection``), as the JAX package
does it with an optax mask. The state_dict is the reference's ClipMLP
layout: ``clip_model.*`` and ``mlp_model.*``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..data.transforms import CLASS_WEIGHTS
from ..ops import losses as L
from .clip import CLIPConfig, CLIPModel, _tuplify
from .mlp import MLP
from .transformer import init_weights


@dataclasses.dataclass(frozen=True)
class ClipMLPConfig:
    """The JAX ``ClipMLPConfig``'s fields and defaults."""

    clip: CLIPConfig
    combinations: Tuple[str, ...] = ("lightcurve",)
    hidden_dim: int = 32
    num_layers: int = 2
    dropout: float = 0.0
    regression: bool = True
    classification: bool = False
    n_classes: int = 5

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ClipMLPConfig":
        """The ``config`` entry of a ``model_config.json`` sidecar (the CLIP
        config nested under ``clip``)."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: _tuplify(v) for k, v in d.items() if k in names and k != "clip"}
        return cls(clip=CLIPConfig.from_dict(d["clip"]), **kw)

    @property
    def head_out(self) -> int:
        return self.n_classes if self.classification else 1

    @property
    def supervised(self) -> bool:
        return self.regression or self.classification


class ClipMLPHead(nn.Module):
    """``clip_model`` (a CLIPModel) and ``mlp_model`` (an MLP over the
    concatenated embeddings), with parameters drawn from ``generator``."""

    def __init__(self, cfg: ClipMLPConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.clip_model = CLIPModel(cfg.clip, generator)
        self.mlp_model = MLP(cfg.clip.enc_dim * len(cfg.combinations), cfg.hidden_dim,
                             cfg.head_out, cfg.num_layers, cfg.dropout)
        init_weights(self.mlp_model, generator)
        if cfg.classification and cfg.n_classes in CLASS_WEIGHTS:
            self.register_buffer("class_weights", torch.from_numpy(
                CLASS_WEIGHTS[cfg.n_classes]), persistent=False)
        else:
            self.class_weights = None

    def forward(self, batch: Mapping[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, head_out) from the normalised embeddings of ``combinations``."""
        embs = []
        if "lightcurve" in self.cfg.combinations:
            embs.append(self.clip_model.embed_lightcurve(
                batch["x_lc"], batch["t_lc"], batch["mask_lc"], train, generator))
        if "spectral" in self.cfg.combinations:
            embs.append(self.clip_model.embed_spectral(
                batch["x_sp"], batch["t_sp"], batch["mask_sp"], train, generator))
        return self.mlp_model(torch.cat(embs, dim=-1), train, generator)

    def loss_fn(self, batch: Mapping[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None, mesh=None,
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Regression: the MSE on ``redshift`` and ``{"pred": (B,)}``;
        classification: the class-weighted cross entropy on ``label`` and
        ``{"logits": ...}``. Under a data ``mesh`` the outputs and targets
        are all-gathered first (``CLIPModel.loss_fn``)."""
        out = self(batch, train, generator)
        gather = (lambda t: t) if mesh is None else mesh.all_gather
        if self.cfg.regression:
            pred = gather(out[:, 0])
            return L.mse_loss(pred, gather(batch["redshift"])), {"pred": pred}
        out = gather(out)
        return (L.weighted_cross_entropy(out, gather(batch["label"]), self.class_weights),
                {"logits": out})
