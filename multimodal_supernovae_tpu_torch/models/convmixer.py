"""ConvMixer host-galaxy image encoder (port of
multimodal_supernovae_tpu/models/convmixer.py).

A stride = patch patch-embedding convolution without bias, ``depth`` mixer
blocks (a residual depthwise k x k convolution, then a pointwise 1 x 1
convolution, each followed by exact-erf GELU, BatchNorm and dropout, in the
JAX package's order), then a global average pool and a GELU head to
``n_out``. The batch is NHWC (the batch contract); the tower turns it to
NCHW once, at its entry, for cuDNN. It computes in float32 whatever the
model's compute dtype, as the JAX tower does (it is built without one).

Two of flax's conventions are kept:
  * padding is ``SAME`` for every convolution, the stride-p patch
    convolution included: where H is not a multiple of p the input is padded
    to ceil(H / p) patches, ``total // 2`` on the low side;
  * BatchNorm (eps 1e-5, flax momentum 0.9, torch's 0.1) updates its
    running variance with the BIASED batch variance, E[x^2] - E[x]^2, where
    ``torch.nn.BatchNorm2d`` uses the unbiased one (x n / (n - 1)).

Module names give the reference's Sequential layout, which
``multimodal_supernovae_tpu/models/torch_export.py`` writes: ``net.0``
(patch conv), ``net.2`` (its BatchNorm), ``net.{3+i}.0.fn.{0,2}``
(depthwise conv and BatchNorm), ``net.{3+i}.{1,3}`` (pointwise conv and
BatchNorm) and ``projection.{2,5}`` (the head's Linears), so an exported
checkpoint, running statistics and ``num_batches_tracked`` included, loads
strictly.

Under a model axis (parallel/sharding.py) the head's ``projection.2``
(``head_fc1``) is column-split and ``projection.5`` (``head_fc2``)
row-split; the dropout between them then keeps this rank's columns of the
global batch's mask (``utils.draws.RankRows``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import ColumnParallelDense, Dense, dropout


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """``flax.linen.Conv`` with ``SAME`` padding on NCHW input, weight in
    torch's (out, in / groups, k, k) layout. Parameters are made empty (no
    draw from the global generator) and drawn by ``init_weights``."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """N(0, 1 / fan_in): flax's lecun_normal scale, untruncated."""
        fan_in = math.prod(self.weight.shape[1:])
        with torch.no_grad():
            self.weight.normal_(generator=generator).mul_(fan_in ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (h0, h1), (w0, w1) = (_same_pad(s, self.k, self.stride) for s in x.shape[2:])
        if h0 or h1 or w0 or w1:
            x = F.pad(x, (w0, w1, h0, h1))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, 1, self.groups)


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm`` over NCHW channels, with ``BatchNorm2d``'s
    parameters and buffers. ``train=True`` normalises by the batch's
    statistics and updates the running ones as flax does: ``running =
    momentum * running + (1 - momentum) * batch`` with the biased batch
    variance; ``num_batches_tracked`` counts the updates, as torch's does.
    Otherwise it normalises by the running statistics.

    Under data parallelism (``mesh``, a ``parallel.mesh.DataMesh`` that
    ``parallel.mesh.batch_stats_over`` sets; the JAX tower's ``axis_name``)
    the batch statistics are the GLOBAL batch's: one differentiable
    all-reduce of each channel's sum and sum of squares, taken in float64
    (flax's ``E[x^2] - E[x]^2``, without its float32 cancellation), and the
    running statistics move by them on every rank alike.
    ``nn.SyncBatchNorm`` is no substitute: it refuses CPU tensors and keeps
    torch's unbiased running variance."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__(features, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum
        self.mesh = None

    def _global_stats(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(biased variance, mean) per channel over every rank's rows."""
        n = x.shape[0] * x.shape[2] * x.shape[3] * self.mesh.size
        x64 = x.double()
        sums = self.mesh.all_reduce(torch.stack([x64.sum(dim=(0, 2, 3)),
                                                 (x64 * x64).sum(dim=(0, 2, 3))])) / n
        mean = sums[0]
        var = (sums[1] - mean * mean).clamp_min(0.0)
        return var.to(x.dtype), mean.to(x.dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        if self.mesh is not None and self.mesh.group is not None:
            var, mean = self._global_stats(x)
            scale = self.weight * torch.rsqrt(var + self.eps)
            y = ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                 + self.bias[None, :, None, None])
            var, mean = var.detach(), mean.detach()
        else:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
            self.num_batches_tracked.add_(1)
        return y


class Residual(nn.Module):
    """The reference's ``Residual(fn)``: holds the depthwise branch as ``fn``
    (conv at ``fn.0``, its BatchNorm at ``fn.2``)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn


def _mixer_block(dim: int, k: int, momentum: float) -> nn.Sequential:
    return nn.Sequential(
        Residual(nn.Sequential(Conv2d(dim, dim, k, groups=dim), nn.GELU(),
                               BatchNorm(dim, momentum))),
        Conv2d(dim, dim, 1), nn.GELU(), BatchNorm(dim, momentum))


class ConvMixer(nn.Module):
    """NHWC image (B, H, W, channels) -> (B, n_out) float32. ``train=True``
    takes BatchNorm's batch statistics (and updates its running ones) and
    applies dropout, drawn from ``generator``."""

    def __init__(self, dim: int = 32, depth: int = 8, channels: int = 3,
                 kernel_size: int = 5, patch_size: int = 8, n_out: int = 128,
                 dropout_prob: float = 0.5, bn_momentum: float = 0.9):
        super().__init__()
        self.depth, self.rate = depth, dropout_prob
        self.net = nn.Sequential(
            Conv2d(channels, dim, patch_size, stride=patch_size, bias=False),
            nn.GELU(), BatchNorm(dim, bn_momentum),
            *(_mixer_block(dim, kernel_size, bn_momentum) for _ in range(depth)))
        self.projection = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Flatten(), Dense(dim, 1024), nn.GELU(),
            nn.Dropout(dropout_prob), Dense(1024, n_out))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def drop(h):
            return dropout(h, self.rate, train, generator)

        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW, once
        x = self.net[2](F.gelu(self.net[0](x)), train)
        for i in range(self.depth):
            block = self.net[3 + i]
            dw = block[0].fn
            x = x + drop(dw[2](F.gelu(dw[0](x)), train))
            x = drop(block[3](F.gelu(block[1](x)), train))
        fc1 = self.projection[2]
        # a head split over a model axis keeps its block of the mask's columns
        h = dropout(F.gelu(fc1(x.mean(dim=(2, 3)))), self.rate, train, generator,
                    split_cols=isinstance(fc1, ColumnParallelDense))
        return self.projection[5](h)
