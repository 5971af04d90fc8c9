"""Train state: the model with its optimizer, scheduler and step count (the
counterpart of the JAX package's flax ``TrainState``; the parameters live in
the module)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None
    step: int = 0
