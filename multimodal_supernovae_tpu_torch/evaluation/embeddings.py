"""Embeddings, supervised predictions and masked-reconstruction scores of a
whole dataset (port of multimodal_supernovae_tpu/evaluation/embeddings.py,
``get_embeddings``, ``predict_supervised`` and ``masked_reconstruction_mse``).

The frozen model runs in eval mode over every sample in one fixed-shape
plan on the device-resident dataset: sequential batches whose tail repeats
the last sample, trimmed to the dataset's size afterwards.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.batching import ArrayDataset, epoch_indices, take
from ..models.clip import MODALITIES


def _run_frozen(model, ds: ArrayDataset, batch_size: int, device,
                fn: Callable) -> List:
    """``fn(batch)`` in eval mode without gradients over every fixed-shape
    batch of ``ds`` on ``device``, where the model's parameters must be."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    on = next(model.parameters()).device
    if on.type != device.type or (device.index is not None and on != device):
        raise ValueError(f"the model is on {on}, not on {device}")
    n = len(ds)
    if n == 0:
        raise ValueError("the dataset is empty")
    data = ds.to_device(on)
    plan = torch.from_numpy(epoch_indices(n, min(batch_size, n), shuffle=False,
                                          pad="repeat_last")).to(on)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return [fn(take(data, idx)) for idx in plan]
    finally:
        model.train(was_training)


def get_embeddings(model, ds: ArrayDataset, batch_size: int = 256,
                   device="cuda") -> Tuple[List[np.ndarray], List[str]]:
    """Per-modality L2-normalised embeddings of every sample of ``ds``, in
    the dataset's order, as float32 (n, enc_dim) arrays, and the modality
    names in canonical order.

    Runs ``model.encode`` in eval mode under ``torch.no_grad()`` on
    ``device``, where the model's parameters must be; runs on the card
    unless the caller asks for the CPU, and raises when CUDA is asked for
    and absent."""
    stacked = _run_frozen(model, ds, batch_size, device, model.encode)
    n = len(ds)
    out = [torch.cat([s[i] for s in stacked]).float()[:n].cpu().numpy()
           for i in range(len(stacked[0]))]
    names = [m for m in MODALITIES if m in model.cfg.combinations]
    return out, names


def predict_supervised(model, ds: ArrayDataset, batch_size: int = 256,
                       device="cuda") -> np.ndarray:
    """The regression or classification head's (n, head_out) float32 output
    for every sample of ``ds`` in eval mode (the JAX
    ``predict_supervised``), on ``device`` as ``get_embeddings`` runs."""
    if not model.cfg.supervised:
        raise ValueError("predict_supervised needs a regression or classification model")
    stacked = _run_frozen(model, ds, batch_size, device, model)
    return torch.cat(stacked).float()[:len(ds)].cpu().numpy()


def masked_reconstruction_mse(model, ds: ArrayDataset,
                              generator: Optional[torch.Generator] = None,
                              uniforms: Optional[Sequence[torch.Tensor]] = None,
                              batch_size: int = 256, device="cuda") -> np.ndarray:
    """Per-sample MSE of a ``MaskedLightCurveEncoder``'s reconstruction over
    a seeded random hidden span (an anomaly score), float32 (n,), in the
    dataset's order. Each batch's mask is drawn from ``generator`` (on
    ``device``), or taken from ``uniforms``: one ``masked_pred`` draw per
    batch of the fixed-shape plan, ceil(n / min(batch_size, n)) of them. Runs on
    ``device`` as ``get_embeddings`` does: on the card unless the caller
    asks for the CPU."""
    if generator is None and uniforms is None:
        raise ValueError("masked_reconstruction_mse needs a generator or the uniforms")
    draws = None
    if uniforms is not None:
        steps = -(-len(ds) // min(batch_size, len(ds)))
        if len(uniforms) != steps:
            raise ValueError(f"{len(uniforms)} uniforms for a plan of {steps} batches")
        draws = iter(uniforms)

    def mse(batch):
        u = None if draws is None else next(draws).to(batch["x_lc"].device)
        truth, pred, pmask = model.masked_pred(batch["x_lc"], batch["t_lc"],
                                               batch["mask_lc"], generator=generator,
                                               uniform=u)
        w = pmask.to(pred.dtype)
        return ((pred - truth) ** 2 * w).sum(dim=-1) / w.sum(dim=-1).clamp_min(1.0)

    stacked = _run_frozen(model, ds, batch_size, device, mse)
    return torch.cat(stacked).float()[:len(ds)].cpu().numpy()
