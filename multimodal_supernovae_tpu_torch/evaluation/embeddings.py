"""Embeddings of a whole dataset (port of
multimodal_supernovae_tpu/evaluation/embeddings.py, ``get_embeddings``).

The frozen model runs over every sample in one fixed-shape plan on the
device-resident dataset: sequential batches whose tail repeats the last
sample, trimmed to the dataset's size afterwards.

Not ported yet: ``masked_reconstruction_mse`` (ROADMAP.md queue 1, item 12)
and ``predict_supervised`` (item 11).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..data.batching import ArrayDataset, epoch_indices, take
from ..models.clip import MODALITIES


def get_embeddings(model, ds: ArrayDataset, batch_size: int = 256,
                   device="cuda") -> Tuple[List[np.ndarray], List[str]]:
    """Per-modality L2-normalised embeddings of every sample of ``ds``, in
    the dataset's order, as float32 (n, enc_dim) arrays, and the modality
    names in canonical order.

    Runs ``model.encode`` in eval mode under ``torch.no_grad()`` on
    ``device``, where the model's parameters must be; runs on the card
    unless the caller asks for the CPU, and raises when CUDA is asked for
    and absent."""
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
            stacked = [model.encode(take(data, idx)) for idx in plan]
    finally:
        model.train(was_training)
    out = [torch.cat([s[i] for s in stacked]).float()[:n].cpu().numpy()
           for i in range(len(stacked[0]))]
    names = [m for m in MODALITIES if m in model.cfg.combinations]
    return out, names
