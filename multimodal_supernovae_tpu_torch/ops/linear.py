"""``F.linear`` for stacked ensemble members (training/ensemble.py).

Under ``torch.func.vmap`` with a weight per member, torch's batching rule
turns a linear layer into batched matrix products, and its weight gradient
into one whose reduction runs over every row of the member's batch (B * T,
up to 51,200) for an output of E x E (32 x 32 to 64 x 256): a batched GEMM
with a tiny output and a very long K, which cuBLAS runs in a handful of
thread blocks (the stacked step's GEMMs took 99 of its 175 ms of device
time at N = 5 on an H100, against 3 ms for one member alone).

``linear`` splits a member's rows into chunks (``chunks``: the largest
power of two up to MAX_CHUNKS that divides the rows and leaves
MIN_CHUNK_ROWS a chunk) and multiplies each chunk by the weight expanded
along the chunks. The forward computes the same rows; autograd then takes
the expanded weight's gradient as one batched product over members x
chunks and sums the chunks, so the weight gradient's long reduction is
split across the card. Outside vmap, and where the rows do not split,
``linear`` is ``F.linear``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .attention import is_batched

MAX_CHUNKS, MIN_CHUNK_ROWS = 64, 256


def chunks(rows: int) -> int:
    """How many chunks ``linear`` splits ``rows`` rows into."""
    c = 1
    while c < MAX_CHUNKS and rows % (2 * c) == 0 and rows // (2 * c) >= MIN_CHUNK_ROWS:
        c *= 2
    return c


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear(x, w, b)``; under vmap, the rows in ``chunks`` chunks (the
    module doc)."""
    if not is_batched(x, w, b):
        return F.linear(x, w, b)
    fin = x.shape[-1]
    rows = x.numel() // fin
    c = chunks(rows)
    if c == 1:
        return F.linear(x, w, b)
    wt = w.t()
    y = torch.matmul(x.reshape(c, rows // c, fin), wt.expand(c, *wt.shape))
    y = y.reshape(*x.shape[:-1], w.shape[0])
    return y if b is None else y + b
