"""Device selection (port of multimodal_supernovae_tpu/utils/platform.py).

The JAX package's ``select_platform`` picks the JAX backend before any
backend starts. The port's counterpart picks the torch device a command
runs on: the card unless the caller asks for the CPU, and no fallback
from one to the other."""

from __future__ import annotations

from typing import Optional, Union

import torch


def select_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` or ``"cuda"`` is the card, which raises when CUDA is absent
    (no CPU fallback); ``"cpu"`` is the CPU; any other torch device string
    is taken as it is."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
