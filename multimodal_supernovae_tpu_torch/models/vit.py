"""ViT host-galaxy image encoder (port of multimodal_supernovae_tpu/models/vit.py).

The alternative image tower that ``extra_args.image_encoder: vit`` selects
in place of the ConvMixer: the image is cut into p x p patches, each patch
embedded by one ``Dense``, a learned positional embedding added, then
``depth`` pre-norm blocks (``x + MHSA(LN(x))``, ``x + MLP(LN(x))`` with an
exact-erf GELU MLP of width ``mlp_mult * emb``), a float32 LayerNorm, a
mean over the tokens and a float32 ``Dense`` to ``n_out``. It has no
BatchNorm, so nothing but the parameters is saved.

Module names are the flax ones, so a state_dict reads like the JAX tree:
``patch_embed``, ``pos_emb`` (1, N, emb), ``block_{i}.{norm1, toqueries,
tokeys, tovalues, unifyheads, norm2, mlp_in, mlp_out}``, ``norm_out``,
``head`` (Dense weights in torch's (out, in) layout; models/convert.py
carries JAX parameters across).

The attention core is the sequence towers' (``ops/attention.py:attention``:
the flash kernels for CUDA tensors, ``dense_attention`` on the CPU) with
no key mask, given ``emb = head_dim``: q and k are each scaled by
head_dim**-0.25, the standard ViT 1/sqrt(head_dim), where the sequence
towers pass the full emb. At the defaults (emb 128, 4 heads) the head dim
is 32, which the flash kernels take on the tensor cores (bf16, or 3xTF32
for float32), as they take 64 (2 heads).

Under ``dtype`` (the model's compute dtype) the blocks' Dense layers and
LayerNorms return that dtype, as flax's do; ``norm_out`` and ``head`` stay
float32. Dropout follows the patch embedding, the attention and the MLP,
drawn from the caller's generator (or ``utils.draws.DrawSource``).

``pos_emb`` has one row a patch, so its size follows the image side:
``image_size`` (default 60, the ZTF BTS cutouts) sizes it at construction,
and loading a state_dict takes the token count of the loaded ``pos_emb``,
so a run trained on other cutouts loads as it is. A forward on an image
whose patch count differs from ``pos_emb``'s raises, as does an image side
that ``patch_size`` does not divide.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from .transformer import Dense, LayerNorm, dropout

DEFAULT_IMAGE_SIZE = 60
CHANNELS = 3  # RGB cutouts; the JAX tower reads them off its first input


class ViTBlock(nn.Module):
    """Pre-norm block: ``x + drop(MHSA(LN(x)))``, then ``x + drop(MLP(LN(x)))``."""

    def __init__(self, emb: int, heads: int, mlp_mult: int = 4,
                 dropout_prob: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if emb % heads:
            raise ValueError(f"emb {emb} is not a multiple of heads {heads}")
        self.emb, self.heads, self.rate = emb, heads, dropout_prob
        self.norm1 = LayerNorm(emb, dtype=dtype)
        self.toqueries = Dense(emb, emb, bias=False, dtype=dtype)
        self.tokeys = Dense(emb, emb, bias=False, dtype=dtype)
        self.tovalues = Dense(emb, emb, bias=False, dtype=dtype)
        self.unifyheads = Dense(emb, emb, dtype=dtype)
        self.norm2 = LayerNorm(emb, dtype=dtype)
        self.mlp_in = Dense(emb, mlp_mult * emb, dtype=dtype)
        self.mlp_out = Dense(mlp_mult * emb, emb, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t, e = x.shape
        h, s = self.heads, e // self.heads

        def to_heads(a):
            return a.view(b, t, h, s).transpose(1, 2)

        y = self.norm1(x)
        out = attention(to_heads(self.toqueries(y)), to_heads(self.tokeys(y)),
                        to_heads(self.tovalues(y)), None, s)  # 1/sqrt(head_dim)
        out = self.unifyheads(out.transpose(1, 2).reshape(b, t, e))
        x = x + dropout(out, self.rate, train, generator)
        y = self.mlp_out(F.gelu(self.mlp_in(self.norm2(x))))
        return x + dropout(y, self.rate, train, generator)


class ViT(nn.Module):
    """NHWC image (B, H, W, C) in [0, 1] -> (B, n_out) float32, the
    ConvMixer's contract. ``use_pallas`` is the JAX config's TPU knob, read
    and ignored. ``train=True`` applies dropout, drawn from ``generator``."""

    def __init__(self, emb: int = 128, depth: int = 6, heads: int = 4,
                 patch_size: int = 10, mlp_mult: int = 4, n_out: int = 128,
                 dropout_prob: float = 0.0, use_pallas: Optional[bool] = None,
                 dtype: Optional[torch.dtype] = None, image_size: int = DEFAULT_IMAGE_SIZE):
        super().__init__()
        del use_pallas
        self.emb, self.depth, self.heads, self.patch_size = emb, depth, heads, patch_size
        self.rate, self.dtype = dropout_prob, dtype
        self.patch_embed = Dense(patch_size * patch_size * CHANNELS, emb, dtype=dtype)
        self.pos_emb = nn.Parameter(torch.zeros(1, self._tokens(image_size, image_size), emb))
        for i in range(depth):
            self.add_module(f"block_{i}", ViTBlock(emb, heads, mlp_mult, dropout_prob, dtype))
        self.norm_out = LayerNorm(emb)
        self.head = Dense(emb, n_out)

    def _tokens(self, hh: int, ww: int) -> int:
        p = self.patch_size
        if hh % p or ww % p:
            raise ValueError(f"image {hh}x{ww} not divisible by patch_size {p}")
        return (hh // p) * (ww // p)

    def init_weights(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():  # flax's normal(stddev=0.02)
            self.pos_emb.normal_(generator=generator).mul_(0.02)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # pos_emb takes the loaded token count (a run trained on other cutouts)
        saved = state_dict.get(prefix + "pos_emb")
        if saved is not None and saved.shape != self.pos_emb.shape:
            self.pos_emb = nn.Parameter(torch.empty(
                saved.shape, dtype=self.pos_emb.dtype, device=self.pos_emb.device),
                requires_grad=self.pos_emb.requires_grad)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, hh, ww, c = x.shape
        p = self.patch_size
        n = self._tokens(hh, ww)
        if n != self.pos_emb.shape[1]:
            raise ValueError(
                f"image {hh}x{ww} at patch_size {p} gives {n} patches; pos_emb holds "
                f"{self.pos_emb.shape[1]} (build the model with image_size={hh})")
        # patchify: (B, H, W, C) -> (B, gh, gw, p, p, C) -> (B, N, p * p * C)
        x = x.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
        h = self.patch_embed(x.reshape(b, n, p * p * c))
        h = dropout(h + self.pos_emb.to(h.dtype), self.rate, train, generator)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, train, generator)
        h = self.norm_out(h.float()).mean(dim=1)  # mean over the tokens
        return self.head(h)
