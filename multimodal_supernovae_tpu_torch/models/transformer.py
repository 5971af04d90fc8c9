"""Sequence encoders (port of multimodal_supernovae_tpu/models/transformer.py).

Transformer over (value, time) sequences with a continuous time/wavelength
positional encoding, band embeddings and masked aggregation. ``train=True``
turns on dropout at the JAX package's three places (the transformer's input,
after ``norm1`` and after ``norm2`` in each block), drawn from an explicit
``torch.Generator``; in eval mode (the default) dropout is the identity.

Parameter names are the reference state_dict keys that
``multimodal_supernovae_tpu/models/torch_export.py`` writes
(``embedding_mag``, ``band_emb``, ``transformer.tblocks.{i}.attention.
{tokeys,toqueries,tovalues,unifyheads}``, ``norm1``/``norm2``,
``ff.0``/``ff.2``, ``query``, ``agg_attn.in_proj_weight``/``in_proj_bias``/
``out_proj``, ``projection``), so an exported checkpoint loads strictly.

Compute dtype follows flax's rules, which the JAX reference relies on:
parameters stay float32; a layer given ``dtype`` casts its input and
parameters to it, and a layer without one computes in the promotion of its
input and parameters. LayerNorm takes its statistics in float32 in the
E[x^2] - E[x]^2 form with eps 1e-6 (flax's, not torch's 1e-5) and returns
its ``dtype``.

``use_fused_block`` routes a block through ``fused_transformer_block`` (q/k/v
projections, attention, then ``ops/fused_block.py``'s fused
unify/LayerNorm/FFN/LayerNorm kernels) with the JAX package's rules: ``MMSN_FUSED_BLOCK=0`` turns it off
even over an explicit ``True``; with ``None`` the env opt-in
``MMSN_FUSED_BLOCK=1`` engages only for CUDA tensors; an explicit ``True``
routes on any device (the plain versions on the CPU); only a block whose
configured dropout rate is 0 (whatever the ``train`` flag) and whose
widths ``fused_block.supports`` takes is fused. The parameter tree is the
same either way.

Under a mesh's model axis (parallel/sharding.py) each block's ``ff.0`` is
a ``ColumnParallelDense`` and ``ff.2`` a ``RowParallelDense`` holding this
rank's slice (the Megatron split; attention stays whole); the fused path
gathers the slices before its kernels.

``MMSN_FUSED_QKV=1`` routes a ``SelfAttention`` through
``ops/qkv_attention.py``'s whole-module kernels (packed q/k/v projection,
attention and unify in one launch, forward and backward) with the JAX
package's rules: only the environment variable, only for CUDA tensors, only
where ``qkv_attention.supports`` passes (T <= 256; longer sequences keep the
flash kernels). A block that runs through ``fused_transformer_block`` never
reaches ``SelfAttention``, so with both opt-ins the fused block wins in the
blocks it takes.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_block as _fused
from ..ops import qkv_attention as _qkv
from ..ops.attention import attention
from ..ops.linear import linear
from ..utils.draws import DrawSource

LN_EPS = 1e-6


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator], split_cols: bool = False) -> torch.Tensor:
    """flax ``nn.Dropout``: in train mode keep each element with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``; otherwise the identity.
    The keep mask is drawn from ``generator`` (on ``x``'s device), or is the
    next one of a ``utils.draws.DrawSource`` given in its place (stacked
    ensemble members, whose masks are drawn before the forward; a data
    mesh's ``RankRows``). ``split_cols``: ``x``'s last dimension is split
    over a mesh's model axis (a column-split layer's output), and the mask
    is this rank's block of the global one, which only ``RankRows`` draws."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    if isinstance(generator, DrawSource):
        keep = generator.keep_mask(x, keep_prob, split_cols)
    elif split_cols:
        raise ValueError("a dropout over model-split columns draws through "
                         "utils.draws.RankRows, not a torch.Generator")
    else:
        keep = torch.empty(x.shape, device=x.device).bernoulli_(
            keep_prob, generator=generator).bool()
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def time_positional_encoding(t: torch.Tensor, d_emb: int, norm: float) -> torch.Tensor:
    """Sinusoidal encoding of continuous times/wavelengths: even channels
    sin, odd channels cos, one frequency per pair. t (B, T) -> (B, T, d_emb)."""
    half = d_emb // 2
    div = torch.exp(
        torch.arange(0, d_emb, 2, dtype=torch.float32, device=t.device)
        * (-math.log(norm) / d_emb))
    arg = t[..., None] * div
    pe = torch.stack([torch.sin(arg), torch.cos(arg)], dim=-1)
    return pe.reshape(*t.shape, 2 * half)


def _compute_dtype(x: torch.Tensor, param: torch.Tensor,
                   dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, param.dtype)


def _fan_in_normal_(w: torch.Tensor, generator: Optional[torch.Generator]):
    """Weight (out, in) ~ N(0, 1/in): flax's lecun_normal scale, untruncated."""
    with torch.no_grad():
        w.normal_(generator=generator).mul_(w.shape[-1] ** -0.5)


class Dense(nn.Module):
    """flax ``nn.Dense`` with a torch ``Linear``'s (out, in) weight layout
    (``ops.linear.linear``: ``F.linear``, with a rule of its own for stacked
    members under vmap)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def init_weights(self, generator: Optional[torch.Generator] = None):
        _fan_in_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.weight, self.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return linear(x.to(dt), self.weight.to(dt), b)


class ColumnParallelDense(Dense):
    """A ``Dense`` whose outputs are split over a mesh's model axis (the
    Megatron column split of parallel/sharding.py): this rank holds rows
    [m c, (m + 1) c) of the weight and of the bias, and its input passes
    through ``mesh.copy_to_model``, whose backward sums the model ranks'
    input gradients."""

    split = {"weight": 0, "bias": 0}  # the torch dimension each tensor is split on

    def __init__(self, full: Dense, mesh):
        nn.Module.__init__(self)
        self.dtype, self.mesh = full.dtype, mesh
        self.weight = _slice_param(full.weight, 0, mesh)
        self.bias = None if full.bias is None else _slice_param(full.bias, 0, mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(self.mesh.copy_to_model(x))


class RowParallelDense(Dense):
    """A ``Dense`` whose inputs are split over a mesh's model axis (the
    Megatron row split): this rank holds columns [m c, (m + 1) c) of the
    weight; the partial products are summed over the model ranks
    (``mesh.reduce_from_model``) and the whole bias is added once, after
    the sum (adding it on every rank before would add it n_model times)."""

    split = {"weight": 1}

    def __init__(self, full: Dense, mesh):
        nn.Module.__init__(self)
        self.dtype, self.mesh = full.dtype, mesh
        self.weight = _slice_param(full.weight, 1, mesh)
        self.bias = None if full.bias is None else nn.Parameter(
            full.bias.detach().clone(), requires_grad=full.bias.requires_grad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.weight, self.dtype)
        y = self.mesh.reduce_from_model(linear(x.to(dt), self.weight.to(dt)))
        return y if self.bias is None else y + self.bias.to(dt)


def _slice_param(p: torch.Tensor, dim: int, mesh) -> nn.Parameter:
    """This model rank's block of ``p`` along ``dim``, as a new parameter."""
    c = p.shape[dim] // mesh.n_model
    return nn.Parameter(p.detach().narrow(dim, mesh.model_rank * c, c).clone(),
                        requires_grad=p.requires_grad)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: float32 statistics, fast variance, eps 1e-6."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = (x32.square().mean(-1, keepdim=True) - mu.square()).clamp_min(0.0)
        y = (x32 - mu) * (torch.rsqrt(var + LN_EPS) * self.weight) + self.bias
        return y.to(_compute_dtype(x, self.weight, self.dtype))


def _on_card(x: torch.Tensor) -> bool:
    """The device predicate of the ``MMSN_FUSED_QKV`` routing."""
    return x.is_cuda


class SelfAttention(nn.Module):
    """Bias-free K/Q/V projections, masked attention with the full-emb
    e**-1/4 scaling (ops/attention.py), biased head unification; as one
    kernel under ``MMSN_FUSED_QKV=1`` (see ``fused_qkv``)."""

    def __init__(self, emb: int, heads: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if emb % heads:
            raise ValueError(f"emb {emb} is not a multiple of heads {heads}")
        self.emb, self.heads, self.dtype = emb, heads, dtype
        self.tokeys = Dense(emb, emb, bias=False, dtype=dtype)
        self.toqueries = Dense(emb, emb, bias=False, dtype=dtype)
        self.tovalues = Dense(emb, emb, bias=False, dtype=dtype)
        self.unifyheads = Dense(emb, emb, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, e = x.shape
        if e != self.emb:
            raise ValueError(f"input dim {e} != layer emb {self.emb}")
        h, s = self.heads, e // self.heads
        if self.fused_qkv(x):
            cdt = self.dtype or x.dtype
            return _qkv.fused_qkv_attention(
                x.to(cdt).contiguous(), mask, self.toqueries.weight,
                self.tokeys.weight, self.tovalues.weight, self.unifyheads.weight,
                self.unifyheads.bias, heads=h, emb=e)

        def to_heads(a):
            return a.view(b, t, h, s).transpose(1, 2)

        out = attention(to_heads(self.toqueries(x)), to_heads(self.tokeys(x)),
                        to_heads(self.tovalues(x)), mask, e)  # (B, H, T, S)
        return self.unifyheads(out.transpose(1, 2).reshape(b, t, e))

    def fused_qkv(self, x: torch.Tensor) -> bool:
        """Whether this call takes the whole-module kernels: the environment
        opt-in ``MMSN_FUSED_QKV=1``, a tensor on the card, and a shape
        ``qkv_attention.supports`` takes. The fused route computes in the
        layer's ``dtype`` (``x``'s when it has none) and reads the four
        ``Dense`` weights and the unify bias as they are. The CPU tests reach
        the routed module by patching ``_on_card``, the one device
        predicate."""
        return bool(os.environ.get("MMSN_FUSED_QKV") == "1" and _on_card(x)
                    and _qkv.supports(x.shape[1], self.emb, self.heads))


class TransformerBlock(nn.Module):
    """Post-norm block: ``norm1(attn(x) + x)`` -> dropout ->
    ``norm2(ff(x) + x)`` -> dropout, with a ReLU MLP of width
    ``ff_hidden_mult * emb``. ``use_fused_block``: see the module doc."""

    def __init__(self, emb: int, heads: int, ff_hidden_mult: int = 4,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None,
                 use_fused_block: Optional[bool] = None):
        super().__init__()
        self.emb, self.heads, self.ff_hidden_mult = emb, heads, ff_hidden_mult
        self.dropout = dropout
        self.use_fused_block = use_fused_block
        self.attention = SelfAttention(emb, heads, dtype=dtype)
        self.norm1 = LayerNorm(emb, dtype=dtype)
        self.ff = nn.Sequential(
            Dense(emb, ff_hidden_mult * emb, dtype=dtype),
            nn.ReLU(),
            Dense(ff_hidden_mult * emb, emb, dtype=dtype),
        )
        self.norm2 = LayerNorm(emb, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.fused(x):
            return fused_transformer_block(x, mask, self)
        x = self.norm1(self.attention(x, mask) + x)
        x = dropout(x, self.dropout, train, generator)
        x = self.norm2(self.ff(x) + x)
        return dropout(x, self.dropout, train, generator)

    def fused(self, x: torch.Tensor) -> bool:
        """Whether this call takes the fused path (the module doc's rules)."""
        env = os.environ.get("MMSN_FUSED_BLOCK")
        use = self.use_fused_block
        if env == "0":
            use = False  # kill switch, even over an explicit True
        elif use is None:
            use = env == "1" and x.is_cuda
        return bool(use and self.dropout == 0.0
                    and _fused.supports(self.emb, self.heads, self.ff_hidden_mult))


def fused_transformer_block(x: torch.Tensor, mask: Optional[torch.Tensor],
                            block: TransformerBlock) -> torch.Tensor:
    """The whole post-norm block of ``block`` over x (B, T, E), computed in
    ``x``'s dtype as the JAX package does (not in the block's configured
    dtype): q/k/v projections (plain ``F.linear``, as the JAX package leaves
    them to XLA), ``attention`` (the flash kernels on CUDA), then
    ``ops.fused_block.fused_ffn_block`` over the parameters of
    ``attention.unifyheads``, ``norm1``, ``ff.0``, ``ff.2`` and ``norm2``.
    Under a model axis (``ff.0`` / ``ff.2`` split by parallel/sharding.py)
    the FFN's weights are all-gathered over the model group first, as XLA
    gathers the JAX package's sharded parameters before its Pallas call."""
    b, t, e = x.shape
    sa = block.attention
    h, s = sa.heads, e // sa.heads
    cdt = x.dtype

    def heads(lin):
        return F.linear(x, lin.weight.to(cdt)).view(b, t, h, s).transpose(1, 2)

    att = attention(heads(sa.toqueries), heads(sa.tokeys), heads(sa.tovalues),
                    mask, e)                            # (B, H, T, S)
    att = att.transpose(1, 2).reshape(b * t, e)
    ff_in, ff_out = block.ff[0], block.ff[2]
    w1, b1, w2 = ff_in.weight, ff_in.bias, ff_out.weight
    if isinstance(ff_in, ColumnParallelDense):
        # the kernel runs LN2 over the FFN's whole output: under a model
        # axis every model rank gathers the slices and computes the block;
        # the gradients come back as this rank's slices
        w1, b1 = ff_in.mesh.gather_from_model(w1, 0), ff_in.mesh.gather_from_model(b1, 0)
        w2 = ff_out.mesh.gather_from_model(w2, 1)
    out = _fused.fused_ffn_block(
        att, x.reshape(b * t, e).contiguous(),
        sa.unifyheads.weight, sa.unifyheads.bias,
        block.norm1.weight, block.norm1.bias,
        w1, b1, w2, ff_out.bias,
        block.norm2.weight, block.norm2.bias)
    return out.view(b, t, e)


class Transformer(nn.Module):
    """Input dropout + a stack of post-norm blocks."""

    def __init__(self, emb: int, heads: int, depth: int, ff_hidden_mult: int = 4,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None,
                 use_fused_block: Optional[bool] = None):
        super().__init__()
        self.dropout = dropout
        self.tblocks = nn.ModuleList(
            TransformerBlock(emb, heads, ff_hidden_mult, dropout, dtype=dtype,
                             use_fused_block=use_fused_block)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(x, self.dropout, train, generator)
        for block in self.tblocks:
            x = block(x, mask, train, generator)
        return x


class TorchStyleMHA(nn.Module):
    """Attention pooling with ``nn.MultiheadAttention`` semantics and
    parameter names: packed biased in-projection, 1/sqrt(head_dim) scaling,
    unmasked softmax, biased out-projection. Computes in the promotion of
    its inputs and float32 parameters, as the flax original does."""

    def __init__(self, emb: int, heads: int = 2):
        super().__init__()
        self.emb, self.heads = emb, heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * emb, emb))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * emb))
        self.out_proj = Dense(emb, emb)

    def init_weights(self, generator: Optional[torch.Generator] = None):
        for w in self.in_proj_weight.chunk(3):
            _fan_in_normal_(w, generator)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        e, h = self.emb, self.heads
        s = e // h
        ws = self.in_proj_weight.chunk(3)
        bs = self.in_proj_bias.chunk(3)

        def proj_heads(x, w, b):
            dt = _compute_dtype(x, w, None)
            y = linear(x.to(dt), w.to(dt), b.to(dt))
            return y.view(x.shape[0], x.shape[1], h, s).transpose(1, 2)

        qh, kh, vh = (proj_heads(x, w, b) for x, w, b in zip((q, k, v), ws, bs))
        scores = torch.einsum("bhts,bhus->bhtu", qh, kh) / math.sqrt(s)
        out = torch.einsum("bhtu,bhus->bhts", torch.softmax(scores, dim=-1), vh)
        return self.out_proj(out.transpose(1, 2).reshape(q.shape[0], q.shape[1], e))


class SequenceEncoder(nn.Module):
    """``Dense(1->emb)(value) + time_PE(t) [+ band embedding]`` -> transformer
    -> zero padded positions -> aggregate -> ``Dense(emb->n_out)`` in float32.

    ``nband > 1`` expects the band-blocked layout (band b occupies positions
    [b*T/nband, (b+1)*T/nband)). Aggregations: 'mean' (mask-weighted),
    'max', 'attn' (learned query + TorchStyleMHA) and 'pretraining' (the
    full pad-zeroed sequence, no projection; ``projection`` still exists, as
    in the reference, so its state_dict loads strictly)."""

    def __init__(self, n_out: int, emb: int, heads: int = 2, depth: int = 8,
                 ff_hidden_mult: int = 4, dropout: float = 0.0, nband: int = 1,
                 agg: str = "mean", time_norm: float = 10000.0,
                 dtype: Optional[torch.dtype] = None,
                 use_fused_block: Optional[bool] = None):
        super().__init__()
        if agg not in ("mean", "max", "attn", "pretraining"):
            raise ValueError(f"unknown agg: {agg}")
        self.emb, self.nband, self.agg, self.time_norm = emb, nband, agg, time_norm
        self.embedding_mag = Dense(1, emb, dtype=dtype)
        if nband > 1:
            self.band_emb = nn.Embedding(nband, emb)
        self.transformer = Transformer(emb, heads, depth, ff_hidden_mult,
                                       dropout, dtype=dtype,
                                       use_fused_block=use_fused_block)
        if agg == "attn":
            self.query = nn.Parameter(torch.empty(emb))
            self.agg_attn = TorchStyleMHA(emb, heads=2)
        self.projection = Dense(emb, n_out)

    def init_weights(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            if self.nband > 1:
                self.band_emb.weight.normal_(generator=generator)
            if self.agg == "attn":
                self.query.uniform_(generator=generator)  # torch.rand init

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train=True`` applies dropout, drawn from ``generator``."""
        if x.dim() == 2:
            x = x[..., None]  # the value channel
        h = self.embedding_mag(x)
        h = h + time_positional_encoding(t, self.emb, self.time_norm).to(h.dtype)
        if self.nband > 1:
            band_ids = torch.arange(self.nband, device=h.device).repeat_interleave(
                h.shape[1] // self.nband)
            h = h + self.band_emb(band_ids)[None]  # float32: promotes h
        h = self.transformer(h, mask, train, generator)
        if mask is not None:
            h = h * mask[:, :, None].to(h.dtype)

        if self.agg == "mean":
            if mask is None:
                h = h.mean(dim=1)
            else:
                h = h.sum(dim=1) / mask.sum(dim=1).to(h.dtype)[:, None]
        elif self.agg == "max":
            h = h.amax(dim=1)
        elif self.agg == "attn":
            q = self.query[None, None, :].expand(h.shape[0], 1, self.emb)
            h = self.agg_attn(q, h, h)[:, 0, :]
        else:  # pretraining
            return h
        # float32 projection: the embedding feeds L2 normalisation
        return self.projection(h.float())


def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None):
    """Draw ``module``'s random parameters from ``generator``: fan-in normal
    weights (flax's lecun_normal scale), normal band embeddings and a
    uniform pooling query; biases stay zero and LayerNorm scales one, as
    constructed."""
    for m in module.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(generator)
