"""Plain MLP (port of multimodal_supernovae_tpu/models/mlp.py): ``num_layers``
Linear-ReLU-Dropout hidden layers of ``hidden_dim``, then a Linear head.

The layers sit in one list at the reference MLP's indices
(``layers.{3n}`` for the n-th hidden Linear, ``layers.{3 * num_layers}``
for the head; models/torch_export.py:160-172), so an exported checkpoint
loads strictly. Dropout in train mode draws from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .transformer import Dense, dropout


class MLP(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, dropout: float = 0.0):
        super().__init__()
        self.num_layers, self.rate = num_layers, dropout
        layers = []
        for i in range(num_layers):
            layers += [Dense(input_dim if i == 0 else hidden_dim, hidden_dim),
                       nn.ReLU(), nn.Dropout(dropout)]
        layers.append(Dense(hidden_dim if num_layers else input_dim, output_dim))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = dropout(torch.relu(self.layers[3 * i](x)), self.rate, train, generator)
        return self.layers[-1](x)
