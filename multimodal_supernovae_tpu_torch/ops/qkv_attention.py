"""The whole ``SelfAttention`` as one kernel, forward and backward: wrappers
over the hand-written CUDA kernels, paired in one ``torch.autograd.Function``.
Two routes, as for flash attention:

  * ``"mma"``, the tensor cores: ``csrc/fused_qkv_fwd_mma.cu`` and
    ``csrc/fused_qkv_bwd_mma.cu`` (shared ``csrc/fused_qkv_mma.cuh``), for
    bfloat16 at head dims 8 and 16: both towers of maven-lite;
  * ``"simt"``, the CUDA cores: ``csrc/fused_qkv_fwd.cu`` and
    ``csrc/fused_qkv_bwd.cu``, for float32.

``_route`` is the one rule that picks between them, a pure function of the
dtype and the head dim; there is no fallback from one route to the other, and
a refused or failed build or launch raises.

Replaces the Pallas TPU kernels ``multimodal_supernovae_tpu/ops/
qkv_attention.py:_fwd_kernel`` and ``_bwd_kernel`` (the ``custom_vjp``
``_qkv_attn``). From the layer input x (B, T, E) in its own layout it computes
the packed q/k/v projection, the head split, masked attention and the biased
head unification, so q, k, v and the per-head output never reach device
memory. The rounding points are the JAX kernel's, with ``cdt`` the dtype of
``x`` (float32 parameters are cast to it):

  forward   qkv = round(x @ Wqkv^T); float32 scores; masked keys SET to -1e7;
            row max, exp and row sum in float32; exp rounded to ``cdt``
            before the value product; the float32 product divided by the row
            sum (the output is normalised, not the probabilities) and
            rounded; out = round(att @ Wu^T) + round(bu) in ``cdt``.
  backward  full recompute from (x, mask, Wqkv, Wu) with a plain softmax P
            (rounded to ``cdt`` for att and dv); datt = round(g @ Wu);
            dWu = sum g^T att and dbu = sum g in float32; dP = datt_h . v;
            dS = P * (dP - rowsum(P * dP)), zeroed at masked keys, rounded;
            dq, dk, dv rounded; dx = round(dqkv @ Wqkv) over the 3E
            contraction in float32; dWqkv = sum dqkv^T x in float32.

The ``emb ** -0.25`` scaling of q and k is folded into the float32 weights
OUTSIDE the autograd Function (``fused_qkv_attention``), as the JAX package
folds it outside its ``custom_vjp``: the fold and the packing live in the
autograd graph, so dWq = scale * dWqkv[:E] and so on.

Weights are in the layout of this package's ``Dense.weight`` (a torch
``Linear``'s (out, in)), so the packed weight is (3E, E): rows 0..E-1 are the
scaled query weight, E..2E-1 the scaled key weight, 2E..3E-1 the value weight
(the JAX function packs flax (in, out) kernels into (E, 3E), its transpose).

Dispatch: CPU tensors take the plain versions (``fused_qkv_attention_plain``
and ``fused_qkv_attention_bwd_plain``); CUDA tensors launch the kernels of
``_route``'s route or raise. ``fused_qkv_attention.launches`` and
``fused_qkv_attention_bwd.launches`` count kernel launches of both routes,
``.mma_launches`` those of the tensor-core route (bumped only after a launch
the runtime accepted). Without a gradient to take, a CUDA call goes through
the registered op ``mmsn_torch::fused_qkv_attention_fwd``
(``fused_qkv_attention_fwd``), which ``torch.export`` keeps as one node of an
exported encoder (evaluation/export.py); its body launches as a direct call
does.

Under ``torch.func.vmap`` (stacked ensemble members, training/ensemble.py,
each with its own weights; the packing in ``fused_qkv_attention`` then gives
each member its own (3E, E) weight) the ``vmap`` rule of
``FusedQKVAttention`` stacks the members as the fused block's does
(``attention.stack_members``: a shared mask or weight, or an unbatched x, is
expanded to the members and copied) and launches each kernel
once for all M members, the member a grid dimension that offsets its samples
and weights, each member with the block count a call for it alone takes:
bitwise that call's results. On the CPU the stacked calls run the plain
versions member by member.

The TPU kernel's (NB, 3E, Tp) sublane layout, its samples-per-program choice
and VMEM budgets, the mask pre-broadcast to head rows and the padding of T to
a multiple of 8 are not carried over: the CUDA kernels take any T <= 256 and
leave keys past T out. ``supports`` keeps the JAX conditions and adds the
kernels' own limits (the CUDA-core backward's shared memory sets them; every
shape it takes at head dim 8 or 16 the tensor-core kernels take too).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .attention import (PLAIN_DEVICES, is_batched, per_member, register_kernel_op,
                        stack_members)

MASK_FILL = -1e7
MAX_TQ = 256       # one thread per sequence position; longer sequences use the flash kernels
HEAD_DIMS = (8, 16)
COLS = 32          # output columns of one pass over E in the kernels
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = {  # the C entry points' ctypes signatures
    "fused_qkv_fwd": ([ctypes.c_void_p] * 6       # x mask wqkv wu bu out
                      + [ctypes.c_int] * 6         # M, B, T, E, H, dtype
                      + [ctypes.c_void_p]),        # stream
    "fused_qkv_fwd_mma": ([ctypes.c_void_p] * 6   # x mask wqkv wu bu out
                          + [ctypes.c_int] * 5     # M, B, T, E, H
                          + [ctypes.c_void_p]),    # stream
    "fused_qkv_bwd": ([ctypes.c_void_p] * 8       # x mask wqkv wu g dx partial grads
                      + [ctypes.c_int] * 7         # M, B, T, E, H, dtype, blocks
                      + [ctypes.c_void_p]),        # stream
    "fused_qkv_bwd_mma": ([ctypes.c_void_p] * 8   # x mask wqkv wu g dx partial grads
                          + [ctypes.c_int] * 6     # M, B, T, E, H, blocks
                          + [ctypes.c_void_p]),    # stream
}
_bound = {}
_sm_count = {}     # device index: its number of SMs


def _smem_bytes(t: int, e: int, s: int, backward: bool) -> int:
    """Dynamic shared memory of one block, all float32: a staged weight slice
    (E x 32), per-head row buffers of T x S (fwd: q, k, v; bwd: q, k, v, datt,
    att, dq), whole-sample row buffers of T x (E + 1) (fwd: x, att; bwd: x,
    dx) and per-row scalars (fwd: the mask; bwd: the mask, max, 1/sum, D)."""
    heads, scalars = (6, 4) if backward else (3, 1)
    return 4 * (e * COLS + heads * t * s + 2 * t * (e + 1) + scalars * t)


def supports(t: int, e: int, heads: int) -> bool:
    """Whether the fused path takes a (T, E) sequence with ``heads`` heads.

    The JAX package's conditions, so that the opt-in selects the same layers
    in both packages: ``e % heads == 0``, head dim and ``e`` multiples of 8,
    and ``ceil8(t) <= 256`` (one q-tile). The CUDA kernels' own limits on
    top: ``e`` a multiple of 32 (the column passes), a head dim of 8 or 16
    (register arrays; the sources instantiate no other), and the backward's float32 buffers at
    T = 256, ``4 * (32e + 6 * 256 * s + 512 * (e + 1) + 1024)`` bytes, within
    one block's 227 KB of shared memory: (E, head dim) = (32, 8), (32, 16)
    and (64, 8) fit (maven-lite's towers are (64, 8) and (32, 16)); (64, 16) and E >= 96 do
    not."""
    if heads <= 0 or e % heads or (e // heads) % 8 or e % 8:
        return False
    if -(-t // 8) * 8 > MAX_TQ:
        return False
    s = e // heads
    return (e % COLS == 0 and s in HEAD_DIMS
            and _smem_bytes(MAX_TQ, e, s, backward=True) <= SMEM_LIMIT)


# ----------------------------------------------------------- plain versions

def _heads(a: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, E) -> (B, H, T, S), a view."""
    b, t, e = a.shape
    return a.view(b, t, heads, e // heads).transpose(1, 2)


def _merge(a: torch.Tensor) -> torch.Tensor:
    """(B, H, T, S) -> (B, T, E)."""
    b, h, t, s = a.shape
    return a.transpose(1, 2).reshape(b, t, h * s)


def _project(x, wqkv, heads):
    """q, k, v (B, H, T, S) float32 holding values rounded to x's dtype."""
    cdt = x.dtype
    qkv = (x.float() @ wqkv.to(cdt).float().t()).to(cdt).float()
    return tuple(_heads(a, heads) for a in qkv.chunk(3, dim=-1))


def _scores(q, k, mask):
    scores = q @ k.transpose(-1, -2)                     # (B, H, T, T) float32
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], MASK_FILL)
    return scores


def fused_qkv_attention_plain(x: torch.Tensor, mask: Optional[torch.Tensor],
                              wqkv: torch.Tensor, wu: torch.Tensor,
                              bu: torch.Tensor, heads: int) -> torch.Tensor:
    """The plain PyTorch version of the forward kernel: x (B, T, E), mask
    (B, T) bool or None, wqkv (3E, E) with the scaling folded in, wu (E, E),
    bu (E,), parameters float32; returns (B, T, E) in x's dtype."""
    cdt = x.dtype
    q, k, v = _project(x, wqkv, heads)
    scores = _scores(q, k, mask)
    ex = torch.exp(scores - scores.amax(-1, keepdim=True))
    att = (ex.to(cdt).float() @ v) / ex.sum(-1, keepdim=True)
    att = _merge(att.to(cdt)).float()
    return (att @ wu.to(cdt).float().t()).to(cdt) + bu.to(cdt)


def fused_qkv_attention_bwd_plain(x, mask, wqkv, wu, g, heads: int
                                  ) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of the backward kernel: the JAX kernel's
    recompute and backward, op for op. Returns (dx in x's dtype, dwqkv
    (3E, E), dwu (E, E), dbu (E,)), the parameter gradients float32 and in
    the (out, in) layout."""
    cdt = x.dtype
    b, t, e = x.shape
    x32, g32 = x.float(), g.to(cdt).float()
    wqkv_c, wu_c = wqkv.to(cdt).float(), wu.to(cdt).float()
    q, k, v = _project(x, wqkv, heads)
    probs = torch.softmax(_scores(q, k, mask), dim=-1)
    probs_c = probs.to(cdt).float()
    att = _merge((probs_c @ v).to(cdt)).float()          # (B, T, E)

    datt = (g32 @ wu_c).to(cdt).float()                  # (B, T, E)
    dwu = g32.reshape(b * t, e).t() @ att.reshape(b * t, e)
    dbu = g32.sum((0, 1))

    gh = _heads(datt, heads)
    dprobs = gh @ v.transpose(-1, -2)
    dscores = probs * (dprobs - (probs * dprobs).sum(-1, keepdim=True))
    if mask is not None:
        dscores = dscores.masked_fill(~mask[:, None, None, :], 0.0)
    dscores = dscores.to(cdt).float()
    dq = (dscores @ k).to(cdt)
    dk = (dscores.transpose(-1, -2) @ q).to(cdt)
    dv = (probs_c.transpose(-1, -2) @ gh).to(cdt)
    dqkv = torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1).float()

    dx = (dqkv @ wqkv_c).to(cdt)
    dwqkv = dqkv.reshape(b * t, 3 * e).t() @ x32.reshape(b * t, e)
    return dx, dwqkv, dwu, dbu


# ------------------------------------------------------------------ kernels

def _entry(name: str):
    """The C entry point ``mmsn_<name>`` of ``csrc/<name>.cu``, with its
    ctypes signature declared once."""
    fn = _bound.get(name)
    if fn is None:
        from ..kernels.build import load_library

        fn = getattr(load_library(name), f"mmsn_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _route(dtype: torch.dtype, head_dim: int) -> str:
    """``"mma"`` (the tensor-core kernels) for bfloat16 at head dim 8 or 16,
    ``"simt"`` (the CUDA-core kernels) otherwise. The tensor-core entry points
    also want x, g and the weights on 16 bytes, which fresh tensors are; they
    refuse a launch without it, and the wrapper then raises."""
    return "mma" if dtype == torch.bfloat16 and head_dim in HEAD_DIMS else "simt"


def _check(x, mask, wqkv, wu, heads, members: Optional[int] = None):
    """(B, T, E) of a call; ``members`` M: stacked members, every tensor
    with a leading member axis (M, ...)."""
    lead = () if members is None else (members,)
    if x.dim() != 3 + len(lead) or tuple(x.shape[:len(lead)]) != lead:
        raise ValueError(f"x must be {'(M, B, T, E)' if lead else '(B, T, E)'}, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype} not supported (float32, bfloat16)")
    b, t, e = x.shape[-3:]
    if min(b, t) < 1 or not supports(t, e, heads):
        raise ValueError(f"(B, T, E, heads) = ({b}, {t}, {e}, {heads}) not supported "
                         "(supports: T <= 256, E a multiple of 32 within the "
                         "shared-memory limit, head dim 8 or 16)")
    for name, p, shape in (("wqkv", wqkv, lead + (3 * e, e)), ("wu", wu, lead + (e, e))):
        if tuple(p.shape) != shape or p.dtype != torch.float32 or p.device != x.device:
            raise ValueError(f"{name} must be float32 {shape} on {x.device}, got "
                             f"{p.dtype} {tuple(p.shape)} on {p.device}")
        if not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mask is not None:
        if mask.shape != lead + (b, t) or mask.dtype != torch.bool or mask.device != x.device:
            raise ValueError(f"mask must be bool {lead + (b, t)} on {x.device}, got "
                             f"{mask.dtype} {tuple(mask.shape)} on {mask.device}")
        if not mask.is_contiguous():
            raise ValueError("mask must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return b, t, e


def _check_fwd(x, mask, wqkv, wu, bu, heads, members: Optional[int] = None):
    b, t, e = _check(x, mask, wqkv, wu, heads, members)
    shape = (e,) if members is None else (members, e)
    if (tuple(bu.shape) != shape or bu.dtype != torch.float32 or bu.device != x.device
            or not bu.is_contiguous()):
        raise ValueError(f"bu must be contiguous float32 {shape} on {x.device}")
    return b, t, e


def _qkv_fwd(x, mask, wqkv, wu, bu, heads, members: Optional[int] = None):
    """Launch the forward kernel (CUDA) or run the plain version (CPU).
    ``members`` M: stacked members, every tensor (M, ...), one launch for
    all of them."""
    if x.device.type in PLAIN_DEVICES:
        return per_member(fused_qkv_attention_plain, members, x, mask, wqkv, wu, bu,
                          heads=heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention runs on CUDA or CPU, got {x.device}")
    b, t, e = _check_fwd(x, mask, wqkv, wu, bu, heads, members)
    out = torch.empty_like(x)
    mma = _route(x.dtype, e // heads) == "mma"
    name = "fused_qkv_fwd_mma" if mma else "fused_qkv_fwd"
    dtype = () if mma else (_DTYPE_CODES[x.dtype],)
    m = members or 1
    fn = _entry(name)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), None if mask is None else mask.data_ptr(),
                wqkv.data_ptr(), wu.data_ptr(), bu.data_ptr(), out.data_ptr(),
                m, b, t, e, heads, *dtype,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc} (M, B, T, E, heads "
                           f"= {m}, {b}, {t}, {e}, {heads}, {x.dtype})")
    fused_qkv_attention.launches += 1
    fused_qkv_attention.mma_launches += mma
    return out


def _bwd_blocks(b: int, device) -> int:
    """Blocks of the backward's fixed grid: one per SM (its shared memory
    leaves room for one), at most one per sample. Each writes one float32
    partial of the parameter gradients, which the reduce kernel sums in block
    order. A stacked member takes the count of its own B samples."""
    sms = _sm_count.get(device.index)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_count[device.index] = sms
    return max(1, min(b, sms))


def fused_qkv_attention_bwd(x, mask, wqkv, wu, g, heads: int,
                            members: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """(dx, dwqkv, dwu, dbu) for the cotangent ``g``: the plain version for
    CPU tensors; for CUDA tensors the backward kernel of ``_route``'s route
    (recompute, backward, per-block float32 partials of the parameter
    gradients) and its reduce kernel, counted as one launch, or raise.
    ``members`` M: stacked members, every tensor and every result (M, ...),
    one launch of each kernel for all of them."""
    if x.device.type in PLAIN_DEVICES:
        return per_member(fused_qkv_attention_bwd_plain, members, x, mask, wqkv, wu, g,
                          heads=heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention_bwd runs on CUDA or CPU, got {x.device}")
    b, t, e = _check(x, mask, wqkv, wu, heads, members)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g must be {tuple(x.shape)} on {x.device}")
    g = g.to(x.dtype).contiguous()
    nblk = _bwd_blocks(b, x.device)
    m = members or 1
    lead = () if members is None else (members,)
    sizes = [3 * e * e, e * e, e]
    dx = torch.empty_like(x)
    partial = torch.empty((m, nblk, sum(sizes)), dtype=torch.float32, device=x.device)
    grads = torch.empty((*lead, sum(sizes)), dtype=torch.float32, device=x.device)
    mma = _route(x.dtype, e // heads) == "mma"
    name = "fused_qkv_bwd_mma" if mma else "fused_qkv_bwd"
    dtype = () if mma else (_DTYPE_CODES[x.dtype],)
    fn = _entry(name)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), None if mask is None else mask.data_ptr(),
                wqkv.data_ptr(), wu.data_ptr(), g.data_ptr(), dx.data_ptr(),
                partial.data_ptr(), grads.data_ptr(), m, b, t, e, heads, *dtype, nblk,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc} (M, B, T, E, heads "
                           f"= {m}, {b}, {t}, {e}, {heads}, {x.dtype})")
    fused_qkv_attention_bwd.launches += 1
    fused_qkv_attention_bwd.mma_launches += mma
    dwqkv, dwu, dbu = grads.split(sizes, dim=-1)
    return dx, dwqkv.unflatten(-1, (3 * e, e)), dwu.unflatten(-1, (e, e)), dbu


fused_qkv_attention_bwd.launches = 0
fused_qkv_attention_bwd.mma_launches = 0


def _fused_qkv_attention_fwd_fake(x, mask, wqkv, wu, bu, heads):
    _check_fwd(x, mask, wqkv, wu, bu, heads)
    return torch.empty_like(x)


# The forward kernel alone as a registered op (CUDA only): the no-grad call
# of ``fused_qkv_attention`` and the node an exported encoder holds.
fused_qkv_attention_fwd = register_kernel_op(
    "fused_qkv_attention_fwd",
    "(Tensor x, Tensor? mask, Tensor wqkv, Tensor wu, Tensor bu, int heads) -> Tensor",
    _qkv_fwd, _fused_qkv_attention_fwd_fake)


class FusedQKVAttention(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient (the JAX
    package's ``custom_vjp``). The residuals are x, the mask and the two
    weights; the backward recomputes the forward from them. The weight
    gradients are cast to the weights' dtype, as the JAX backward does.
    ``members``: None for one call, else M stacked members, every tensor
    (M, ...).

    Under ``torch.func.vmap`` (stacked ensemble members) the ``vmap`` rule
    stacks the members and applies this Function once with ``members``: one
    launch each way for all M, each member bitwise its own call."""

    @staticmethod
    def forward(x, mask, wqkv, wu, bu, heads, members=None):
        return _qkv_fwd(x, mask, wqkv, wu, bu, heads, members)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, mask, wqkv, wu, bu, heads = inputs[:6]
        ctx.save_for_backward(x, mask, wqkv, wu)
        ctx.heads, ctx.bu_dtype = heads, bu.dtype
        ctx.members = inputs[6] if len(inputs) > 6 else None

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, mask, wqkv, wu = ctx.saved_tensors
        dx, dwqkv, dwu, dbu = fused_qkv_attention_bwd(x, mask, wqkv, wu, g, ctx.heads,
                                                      ctx.members)
        return (dx, None, dwqkv.to(wqkv.dtype), dwu.to(wu.dtype),
                dbu.to(ctx.bu_dtype), None, None)

    @staticmethod
    def vmap(info, in_dims, *args):
        n, stacked = stack_members(info, in_dims[:5], args[:5])
        return FusedQKVAttention.apply(*stacked, args[5], n), 0


def fused_qkv_attention(x: torch.Tensor, mask: Optional[torch.Tensor],
                        wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                        wu: torch.Tensor, bu: torch.Tensor, heads: int,
                        emb: int) -> torch.Tensor:
    """The whole ``SelfAttention`` (q/k/v projections, head split, masked
    attention, biased unify) over x (B, T, E), differentiable in x and the
    five parameters.

    ``x``: contiguous (B, T, E), float32 or bfloat16 (the compute dtype).
    ``mask``: (B, T) bool, True where the KEY position is valid, or None.
    ``wq``/``wk``/``wv``/``wu``: float32 (E, E) in a ``Linear``'s (out, in)
    layout; ``bu``: float32 (E,). ``emb``: the embedding dim of the
    ``emb ** -0.25`` scaling, which must be E (the argument is the JAX
    function's). The scaling is folded into
    ``wq`` and ``wk`` in float32 and the three are packed into one (3E, E)
    weight here, in autograd. CPU tensors take the plain versions; CUDA
    tensors launch the kernels (``supports`` gives the shapes) or raise.
    Without a gradient to take (``no_grad``, ``inference_mode``, as in
    serving) the forward runs alone and keeps no residuals, on CUDA through
    the registered op ``fused_qkv_attention_fwd``. Under ``torch.func.vmap``
    (stacked members; each member's weights packed into its own (3E, E)) a
    call goes through ``FusedQKVAttention``, gradients on or off, one launch
    each way for all members (under ``no_grad`` no residual outlives the
    call)."""
    e = x.shape[-1]
    if x.shape[1] > MAX_TQ:
        raise ValueError(f"T = {x.shape[1]} > {MAX_TQ}: use the flash kernels")
    if emb != e:
        raise ValueError(f"emb = {emb} but x has E = {e}")
    scale = float(emb) ** -0.25
    wqkv = torch.cat([wq * scale, wk * scale, wv], dim=0)
    args = (x, wqkv, wu, bu)
    if is_batched(x, mask, *args) or (torch.is_grad_enabled()
                                      and any(a.requires_grad for a in args)):
        return FusedQKVAttention.apply(x, mask, wqkv, wu, bu, heads)
    if x.device.type == "cuda":
        return fused_qkv_attention_fwd(x, mask, wqkv, wu, bu, heads)
    return _qkv_fwd(x, mask, wqkv, wu, bu, heads)


fused_qkv_attention.launches = 0
fused_qkv_attention.mma_launches = 0
