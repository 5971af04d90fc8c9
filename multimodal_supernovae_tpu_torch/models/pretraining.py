"""Masked light-curve pretraining (port of
multimodal_supernovae_tpu/models/pretraining.py).

A ``SequenceEncoder`` in ``agg='pretraining'`` mode (the full pad-zeroed
sequence) and a ``Dense(emb -> 1)`` head back to one value per position. A
random contiguous span per band (or a random subset) of the valid positions
is zeroed in the input, the transformer still attends over the full padding
mask, and the loss is the MSE over exactly the hidden positions.

The encoder's ``projection`` is never called, as in the reference, but its
keys stay in the state_dict for the reference's strict layout: the JAX
package's exporter writes them as zeros of shape (n_out, emb), and so does
this model. The layer takes no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..data.augment import contiguous_span_mask, random_subset_mask
from .clip import _tuplify
from .transformer import Dense, SequenceEncoder, init_weights


@dataclasses.dataclass(frozen=True)
class MaskedEncoderConfig:
    """The JAX ``MaskedEncoderConfig``'s fields and defaults."""

    f_mask: float = 0.2
    nband: int = 1
    contiguous: bool = True  # one span per band (the reference's) vs a subset
    transformer_kwargs: Tuple[Tuple[str, Any], ...] = (
        ("n_out", 1),
        ("emb", 128),
        ("heads", 2),
        ("depth", 4),
    )

    @classmethod
    def create(cls, transformer_kwargs: Optional[Dict[str, Any]] = None, **kw):
        merged = {"n_out": 1, "emb": 128, "heads": 2, "depth": 4}
        merged.update(transformer_kwargs or {})
        return cls(transformer_kwargs=tuple(sorted(merged.items())), **kw)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MaskedEncoderConfig":
        """The ``config`` entry of a ``model_config.json`` sidecar."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: _tuplify(v) for k, v in d.items() if k in names})

    def tk(self) -> Dict[str, Any]:
        return dict(self.transformer_kwargs)


class MaskedLightCurveEncoder(nn.Module):
    """``net`` (the sequence encoder) and ``last_layer`` (emb -> 1), with
    parameters drawn from ``generator``."""

    def __init__(self, cfg: MaskedEncoderConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        tk = cfg.tk()
        tk.pop("use_pallas", None)  # a TPU knob of the JAX config, unused here
        self.net = SequenceEncoder(nband=cfg.nband, agg="pretraining", **tk)
        self.last_layer = Dense(tk["emb"], 1)
        init_weights(self, generator)
        with torch.no_grad():  # the dead projection: the exporter's zeros
            self.net.projection.weight.zero_()
            self.net.projection.bias.zero_()
        self.net.projection.requires_grad_(False)

    def forward(self, batch: Mapping[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The light curve reconstructed from the whole input: (B, T)."""
        return self.predict(batch["x_lc"], batch["t_lc"], batch["mask_lc"], train, generator)

    def predict(self, x, t, mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One value per sequence position: (B, T) -> (B, T)."""
        return self.last_layer(self.net(x, t, mask, train, generator))[..., 0]

    def masked_pred(self, x, t, padding_mask, train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    uniform: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Hide a random span (or subset), reconstruct, and return (truth,
        prediction, mask_pred), all (B, T). The hidden positions of the
        input are zeroed; attention still covers every valid position.
        ``uniform`` is the mask's draw (contiguous_span_mask's (B, nband)
        or random_subset_mask's (B, T)); without it the mask is drawn from
        ``generator``, before any dropout."""
        if self.cfg.contiguous:
            keep, pred_mask = contiguous_span_mask(padding_mask, self.cfg.nband,
                                                   self.cfg.f_mask, generator, uniform)
        else:
            keep, pred_mask = random_subset_mask(padding_mask, self.cfg.f_mask,
                                                 generator, uniform)
        x_masked = torch.where(keep, x, torch.zeros_like(x))
        return x, self.predict(x_masked, t, padding_mask, train, generator), pred_mask

    def loss_fn(self, batch: Mapping[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None,
                uniform: Optional[torch.Tensor] = None, mesh=None,
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The MSE over the hidden positions, ``se.sum() / max(m.sum(), 1)``,
        and ``{"pred", "mask_pred"}``. The mask needs ``generator`` or a
        handed-in ``uniform``, in train and eval mode alike. Under a data
        ``mesh`` the truth, prediction and mask are all-gathered first, so
        the MSE is the global batch's (``CLIPModel.loss_fn``)."""
        if generator is None and uniform is None:
            raise ValueError("the masked pretraining loss needs a generator or a "
                             "handed-in uniform draw")
        truth, pred, mask_pred = self.masked_pred(batch["x_lc"], batch["t_lc"],
                                                  batch["mask_lc"], train, generator,
                                                  uniform)
        if mesh is not None:
            truth, pred, mask_pred = (mesh.all_gather(t) for t in (truth, pred, mask_pred))
        m = mask_pred.to(pred.dtype)
        se = (truth - pred) ** 2 * m
        return se.sum() / m.sum().clamp_min(1.0), {"pred": pred, "mask_pred": mask_pred}
