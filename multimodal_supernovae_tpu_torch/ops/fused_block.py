"""The fused row-local tail of a post-norm transformer block, forward and
backward: wrappers over the hand-written CUDA kernels ``csrc/fused_ffn_fwd.cu``
and ``csrc/fused_ffn_bwd.cu`` (CUDA cores), ``csrc/fused_ffn_fwd_mma.cu`` and
``csrc/fused_ffn_bwd_mma.cu`` (tensor cores, 3xTF32, float32 only), paired in
one ``torch.autograd.Function``.

Replaces the Pallas TPU kernels ``multimodal_supernovae_tpu/ops/
fused_block.py:_ffn_fwd_kernel`` and ``_ffn_bwd_kernel`` (the ``custom_vjp``
``_ffn_block``). Over (N, E) rows it computes

    a   = att @ Wu^T + bu                 # head unification
    y1  = LN1(a + x)
    y   = LN2(relu(y1 @ Wf1^T + bf1) @ Wf2^T + bf2 + y1)

with the JAX kernel's rounding points: every product takes operands in the
compute dtype ``cdt`` (the dtype of ``x``; float32 parameters are cast to it),
accumulates in float32, is rounded to ``cdt`` and then has its bias added in
``cdt``; LayerNorm takes float32 statistics in the E[x^2] - E[x]^2 form with
eps 1e-6 and no clamp, and returns ``cdt``. The backward recomputes the
forward from ``att``, ``x`` and the parameters and returns float32 weight,
bias and LayerNorm gradients summed over all rows.

Weights are read in the layout of this package's ``Dense.weight`` (a torch
``Linear``'s (out, in)), so the modules' parameters are passed as they are,
with no copy; biases and LayerNorm scales are 1-D. (flax kernels are
(in, out): the JAX function takes the transposes.)

Dispatch: CPU tensors take the plain versions (``fused_ffn_block_plain`` and
``fused_ffn_block_bwd_plain``); CUDA tensors launch the kernels or raise. The
forward and the backward each have two routes, one ``_route`` for both,
chosen from dtype and widths alone: float32 at the widths the tensor-core
kernels take goes to them, everything else (bfloat16 included) to the
CUDA-core kernels; a failed build or launch raises and never falls back to
the other route.
Without a gradient to take, a CUDA call goes through the registered op
``mmsn_torch::fused_ffn_block_fwd`` (``fused_ffn_block_fwd``), which
``torch.export`` keeps as one node of an exported encoder
(evaluation/export.py); its body picks the route and launches as a direct
call does.
``fused_ffn_block.launches`` and ``fused_ffn_block_bwd.launches`` (both
routes) and their ``.mma_launches`` (the tensor cores) count kernel calls
(bumped only after a launch the runtime accepted).

Under ``torch.func.vmap`` (stacked ensemble members, training/ensemble.py,
each with its own parameters) the ``vmap`` rule of ``FusedFFNBlock`` moves
every input's member axis to the front (``attention.stack_members``: an
unbatched one expanded to the members and copied, so a shared weight's
gradient is summed over them) and launches each kernel once for all M
members: the
member is a grid dimension of every kernel, which offsets its rows and
parameters, and each member keeps the block and split counts a call for it
alone takes, so its results are bitwise that call's. The JAX package's
Pallas batching rule adds a grid dimension in the same way. On the CPU the
stacked calls run the plain versions member by member.

The whole block (q/k/v projections, attention, then ``fused_ffn_block``) is
composed in ``models/transformer.py:fused_transformer_block``; this module
takes tensors only.

The TPU kernel's 1024-row tiles, the zero-padding of rows to them and its
VMEM estimate are not carried over; ``supports`` states the CUDA kernels'
own limits instead.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .attention import (PLAIN_DEVICES, is_batched, per_member, register_kernel_op,
                        stack_members)

LN_EPS = 1e-6
ROWS = 32          # rows per block tile in both kernels
CHUNK_K = 32       # contraction depth of one staged weight chunk
CHUNK_LD = 257     # floats per staged chunk row (256 columns + 1 of padding)
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
SM_SMEM = 233472     # bytes of shared memory an SM has (1,024 of them reserved a block)
MMA_ROWS = 64      # rows per block tile of the tensor-core forward (4 warps x 16)
MMA_CHUNK = 64     # hidden columns of one staged chunk in the tensor-core forward
MMA_PAD = 4        # floats of padding a shared row in the tensor-core forward
MMA_WIDTHS = (64, 96, 128)  # E the tensor-core kernels are built for
BWD_MMA_CHUNK = 32  # hidden columns of one staged chunk in the tensor-core backward
BWD_MMA_ROWS = 32   # rows of one step of its weight-gradient kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_bound = {}
_ARGTYPES = {
    "fused_ffn_fwd": ([ctypes.c_void_p] * 13       # att x wu bu g1 b1 wf1 bf1 wf2 bf2 g2 b2 out
                      + [ctypes.c_int] * 5          # M, N, E, F, dtype
                      + [ctypes.c_float]            # eps
                      + [ctypes.c_void_p]),         # stream
    "fused_ffn_fwd_mma": ([ctypes.c_void_p] * 13   # att x wu bu g1 b1 wf1 bf1 wf2 bf2 g2 b2 out
                          + [ctypes.c_int] * 4      # M, N, E, F
                          + [ctypes.c_float]        # eps
                          + [ctypes.c_void_p]),     # stream
    "fused_ffn_bwd": ([ctypes.c_void_p] * 13       # att x wu bu g1 b1 wf1 bf1 wf2 bf2 g2 b2 g
                      + [ctypes.c_void_p] * 4       # datt dx partial grads
                      + [ctypes.c_int] * 6          # M, N, E, F, dtype, blocks
                      + [ctypes.c_float]            # eps
                      + [ctypes.c_void_p]),         # stream
    "fused_ffn_bwd_mma": ([ctypes.c_void_p] * 13   # att x wu bu g1 b1 wf1 bf1 wf2 bf2 g2 b2 g
                          + [ctypes.c_void_p] * 3   # datt dx grads
                          + [ctypes.c_void_p] * 6   # dr2 h dh y1 ln_partial w_partial
                          + [ctypes.c_int] * 6      # M, N, E, F, blocks, splits
                          + [ctypes.c_float]        # eps
                          + [ctypes.c_void_p]),     # stream
}


def _smem_bytes(e: int, f: int, backward: bool) -> int:
    """Dynamic shared memory of one block: row buffers of ROWS rows (fwd:
    att, y1, h; bwd: att, xhat1, y1, h, xhat2, dr2 and two row scalars) plus
    one staged weight chunk, all float32."""
    rows = ROWS * (5 * e + f) + 2 * ROWS if backward else ROWS * (2 * e + f)
    return 4 * (rows + CHUNK_K * CHUNK_LD)


def _mma_smem_bytes(e: int) -> int:
    """Dynamic shared memory of one tensor-core forward block, float32: the
    att / y1 rows and one chunk of h rows, then the larger of Wu and one
    chunk of Wf1 and Wf2, each split into TF32 hi and lo; every row padded
    by MMA_PAD floats."""
    xld, hld = e + MMA_PAD, MMA_CHUNK + MMA_PAD
    weights = max(2 * e * xld, 2 * MMA_CHUNK * xld + 2 * e * hld)
    return 4 * (MMA_ROWS * xld + MMA_ROWS * hld + weights)


def _bwd_mma_smem_bytes(e: int, f: int) -> int:
    """Dynamic shared memory of one block of the tensor-core backward's row
    kernel, as its source states it: float32 rows of 4 warps x 16 (att, y1,
    dr2 and dr1; one chunk of h and dh; xhat1), the largest of the weights
    it stages split into TF32 hi and lo (Wu; a chunk of Wf1 and Wf2 either
    way round), the LayerNorm sums of each warp, and 2 bytes of relu' bits a
    chunk, warp and lane."""
    rows, fc = MMA_ROWS, BWD_MMA_CHUNK
    xld, hld = e + MMA_PAD, fc + MMA_PAD
    weights = max(e * (e + 8), fc * xld + e * hld, e * (fc + 8) + fc * (e + 8))
    floats = rows * (xld + hld + e) + 2 * weights + 16 * e
    return 4 * floats + 8 * f


def _route(dtype: torch.dtype, e: int, f: int) -> str:
    """``"mma"`` (the 3xTF32 tensor-core kernels, forward and backward) for
    float32 at E in MMA_WIDTHS and F a multiple of MMA_CHUNK, where both
    kernels fit one block's shared memory (``_mma_smem_bytes``,
    ``_bwd_mma_smem_bytes``); ``"simt"`` (the CUDA-core kernels) otherwise,
    bfloat16 included. So a block's forward and backward always take one
    route. The tensor-core entries also want every pointer on 16 bytes,
    which fresh tensors are; they refuse a launch without it, and the
    wrapper then raises."""
    fits = max(_mma_smem_bytes(e), _bwd_mma_smem_bytes(e, f)) <= SMEM_LIMIT
    return ("mma" if dtype == torch.float32 and e in MMA_WIDTHS and f % MMA_CHUNK == 0
            and fits else "simt")


def supports(e: int, heads: int, ff_hidden_mult: int = 4) -> bool:
    """Whether the fused path takes a block of width ``e``.

    The JAX package's conditions, so that the opt-in selects the same
    blocks in both packages: ``e % heads == 0``, a head dim that is a
    multiple of 8, and ``e >= 64``. In place of its VMEM estimate, the CUDA
    kernels' own limits: ``e`` and the hidden width ``f = ff_hidden_mult * e``
    are multiples of 32 (a warp's columns), ``e <= 256`` (8 columns a lane
    in a LayerNorm row), and the backward's row buffers,
    ``4 * (32 * (5e + f) + 64 + 32 * 257)`` bytes, fit one block's 227 KB of
    shared memory: at ``f = 4e`` that is ``e <= 160`` (maven-lite's LC
    tower: e = 64, f = 256)."""
    if e % heads or (e // heads) % 8 or e < 64:
        return False
    f = ff_hidden_mult * e
    return (e % 32 == 0 and f % 32 == 0 and e <= 256
            and _smem_bytes(e, f, backward=True) <= SMEM_LIMIT)


# ----------------------------------------------------------- plain versions

def _mm(a: torch.Tensor, w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """a @ w^T with operands in ``cdt``, float32 accumulation, one rounding
    to ``cdt``; ``w`` is (out, in)."""
    return (a.to(cdt).float() @ w.to(cdt).float().t()).to(cdt)


def _mmf(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two float32 matrices: the backward's six products."""
    return a @ b


def _layernorm_rows(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float):
    """float32 statistics, fast variance, no clamp; returns (y in r's dtype,
    xhat, rstd)."""
    r32 = r.float()
    mean = r32.mean(-1, keepdim=True)
    var = (r32 * r32).mean(-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + eps)
    xhat = (r32 - mean) * rstd
    y = xhat * g.float() + b.float()
    return y.to(r.dtype), xhat, rstd


def _ln_bwd_rows(dy: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
                 g: torch.Tensor):
    """Backward of ``_layernorm_rows`` w.r.t. its input; dy float32."""
    dg = (dy * xhat).sum(0)
    db = dy.sum(0)
    dxhat = dy * g.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2), dg, db


def _forward_rows(att, x, wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2, eps):
    cdt = x.dtype
    a = _mm(att, wu, cdt) + bu.to(cdt)
    y1, xhat1, rstd1 = _layernorm_rows(a + x, g1, b1, eps)
    pre_h = _mm(y1, wf1, cdt) + bf1.to(cdt)
    h = torch.clamp_min(pre_h, 0)
    f = _mm(h, wf2, cdt) + bf2.to(cdt)
    y2, xhat2, rstd2 = _layernorm_rows(f + y1, g2, b2, eps)
    return y2, (xhat1, rstd1, y1, pre_h, h, xhat2, rstd2)


def fused_ffn_block_plain(att, x, wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2,
                          eps: float = LN_EPS) -> torch.Tensor:
    """The plain PyTorch version of the forward kernel."""
    return _forward_rows(att, x, wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2, eps)[0]


def fused_ffn_block_bwd_plain(att, x, wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2,
                              g, eps: float = LN_EPS,
                              relu_mask: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of the backward kernel: the JAX kernel's
    recompute and backward, op for op. Returns (datt, dx, dwu, dbu, dg1,
    db1, dwf1, dbf1, dwf2, dbf2, dg2, db2), weight gradients in the (out,
    in) layout, all parameter gradients float32.

    ``relu_mask`` ((N, F) bool) replaces the ReLU's mask, pre-activation > 0.
    Where a pre-activation lies within rounding of 0, two float32
    computations of it (a kernel's, this one's) may take the mask's two
    sides, and one such entry moves a whole dh value; given a kernel's own
    mask (its h > 0), this version is that kernel's function on every row."""
    cdt = x.dtype
    _, (xhat1, rstd1, y1, pre_h, h, xhat2, rstd2) = _forward_rows(
        att, x, wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2, eps)
    wu_c, wf1_c, wf2_c = (w.to(cdt).float() for w in (wu, wf1, wf2))
    dr2, dg2, db2 = _ln_bwd_rows(g.float(), xhat2, rstd2, g2)
    df = dr2.to(cdt).float()
    dbf2 = dr2.sum(0)
    dwf2 = _mmf(df.t(), h.float())                     # (E, F)
    mask = pre_h.float() > 0 if relu_mask is None else relu_mask
    dh = torch.where(mask, _mmf(df, wf2_c), 0.0)
    dhc = dh.to(cdt).float()
    dbf1 = dh.sum(0)
    dwf1 = _mmf(dhc.t(), y1.float())                   # (F, E)
    dy1 = dr2 + _mmf(dhc, wf1_c)
    dr1, dg1, db1 = _ln_bwd_rows(dy1, xhat1, rstd1, g1)
    da = dr1.to(cdt).float()
    dbu = dr1.sum(0)
    dwu = _mmf(da.t(), att.to(cdt).float())            # (E, E)
    datt = _mmf(da, wu_c).to(att.dtype)
    return (datt, dr1.to(x.dtype), dwu, dbu, dg1, db1, dwf1, dbf1, dwf2, dbf2,
            dg2, db2)


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


def _check(att, x, params, members: Optional[int] = None):
    """(N, E, F) of a call; ``members`` M: stacked members, every tensor
    with a leading member axis (M, ...)."""
    lead = () if members is None else (members,)
    if x.dim() != 2 + len(lead) or att.shape != x.shape or tuple(x.shape[:len(lead)]) != lead:
        raise ValueError(f"att and x must be {'(M, N, E)' if lead else '(N, E)'} of one "
                         f"shape, got {tuple(att.shape)} and {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES or att.dtype != x.dtype:
        raise ValueError(f"att and x must share a dtype in (float32, bfloat16), "
                         f"got {att.dtype} and {x.dtype}")
    n, e = x.shape[-2:]
    wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2 = params
    f = wf1.shape[-2]
    shapes = ((e, e), (e,), (e,), (e,), (f, e), (f,), (e, f), (e,), (e,), (e,))
    for i, (p, shape) in enumerate(zip(params, shapes)):
        shape = lead + shape
        if tuple(p.shape) != shape or p.dtype != torch.float32 or p.device != x.device:
            raise ValueError(f"parameter {i} must be float32 {shape} on {x.device}, "
                             f"got {p.dtype} {tuple(p.shape)} on {p.device}")
        if not p.is_contiguous():
            raise ValueError(f"parameter {i} must be contiguous")
    if n < 1 or e % 32 or f % 32 or e > 256 or _smem_bytes(e, f, True) > SMEM_LIMIT:
        raise ValueError(f"(N, E, F) = ({n}, {e}, {f}) not supported: N >= 1, E and F "
                         "multiples of 32 within the shared-memory limit (supports)")
    if not (att.is_contiguous() and x.is_contiguous()):
        raise ValueError("att and x must be contiguous")
    return n, e, f


def _ffn_fwd(att, x, *params, eps, members: Optional[int] = None):
    """Launch the forward kernel of ``_route``'s choice (CUDA) or run the
    plain version (CPU). ``members`` M: stacked members, every tensor (M,
    ...), one launch for all of them."""
    if x.device.type in PLAIN_DEVICES:
        return per_member(fused_ffn_block_plain, members, att, x, *params, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn_block runs on CUDA or CPU, got {x.device}")
    n, e, f = _check(att, x, params, members)
    out = torch.empty_like(x)
    mma = _route(x.dtype, e, f) == "mma"
    name = "fused_ffn_fwd_mma" if mma else "fused_ffn_fwd"
    m = members or 1
    shape = (m, n, e, f) if mma else (m, n, e, f, _DTYPE_CODES[x.dtype])
    fn = _entry(name)
    with torch.cuda.device(x.device):
        rc = fn(att.data_ptr(), x.data_ptr(), *(p.data_ptr() for p in params),
                out.data_ptr(), *shape, eps, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        hint = ", every pointer must be on 16 bytes" if mma else ""
        raise RuntimeError(f"{name} launch failed with CUDA error {rc} (M, N, E, F = {m}, {n}, "
                           f"{e}, {f}, {x.dtype}{hint})")
    fused_ffn_block.launches += 1
    fused_ffn_block.mma_launches += mma
    return out


def _bwd_blocks(n: int, device) -> int:
    """Blocks of the backward's fixed grid: one per SM (one fits, at 255
    registers a thread), at most one per row tile. Each writes one float32
    partial of every parameter gradient, which the reduce kernel sums in
    block order. A stacked member takes the count of its own N rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n // ROWS), sms))


def _bwd_mma_grid(n: int, e: int, f: int, device) -> Tuple[int, int]:
    """(blocks, splits) of the tensor-core backward: the row kernel's fixed
    grid, as many blocks as fit on the SMs at once (two an SM where two
    blocks' shared memory fits), at most one per 64-row tile; and the row
    splits of its weight-gradient kernel, one per SM, at most one per 32-row
    step. Each block or split writes one float32 partial, which the reduce
    kernel sums in order."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = 2 if 2 * (_bwd_mma_smem_bytes(e, f) + 1024) <= SM_SMEM else 1
    blocks = max(1, min(-(-n // MMA_ROWS), sms * per_sm))
    return blocks, max(1, min(-(-n // BWD_MMA_ROWS), sms))


def _bwd_mma(att, x, params, g, n, e, f, eps, members=None):
    """Launch the tensor-core backward: row kernel, weight-gradient kernel
    three times and their reduces, with float32 scratch for the row
    gradients (dr2, h, dh, y1) and the partials, a member axis in front of
    each for ``members`` stacked members. Returns (datt, dx, grads (M, P),
    h); h > 0 is the kernel's ReLU mask."""
    m = members or 1
    lead = () if members is None else (members,)
    blocks, splits = _bwd_mma_grid(n, e, f, x.device)
    datt, dx = torch.empty_like(att), torch.empty_like(x)
    grads = torch.empty((m, sum(p.numel() for p in params) // m), dtype=torch.float32,
                        device=x.device)

    def scratch(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    bufs = (scratch(*lead, n, e), scratch(*lead, n, f), scratch(*lead, n, f),
            scratch(*lead, n, e), scratch(m, 2, blocks, 2 * e), scratch(m, splits, e * f + f))
    fn = _entry("fused_ffn_bwd_mma")
    with torch.cuda.device(x.device):
        rc = fn(att.data_ptr(), x.data_ptr(), *(p.data_ptr() for p in params), g.data_ptr(),
                datt.data_ptr(), dx.data_ptr(), grads.data_ptr(),
                *(b.data_ptr() for b in bufs), m, n, e, f, blocks, splits, eps,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_ffn_bwd_mma launch failed with CUDA error {rc} (M, N, E, F "
                           f"= {m}, {n}, {e}, {f}, {x.dtype}, every pointer must be on 16 "
                           "bytes)")
    return datt, dx, grads, bufs[1]


def fused_ffn_block_bwd(att, x, wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2, g,
                        eps: float = LN_EPS, members: Optional[int] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """(datt, dx, dwu, dbu, dg1, db1, dwf1, dbf1, dwf2, dbf2, dg2, db2) for
    the cotangent ``g``: the plain version for CPU tensors; for CUDA tensors
    the backward kernels of ``_route``'s choice (recompute, backward,
    float32 partials of the parameter gradients, and their reduce), or
    raise. ``members`` M: stacked members, every tensor and every result
    (M, ...), one launch of each kernel for all of them."""
    params = (wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2)
    if x.device.type in PLAIN_DEVICES:
        return per_member(fused_ffn_block_bwd_plain, members, att, x, *params, g, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn_block_bwd runs on CUDA or CPU, got {x.device}")
    n, e, f = _check(att, x, params, members)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g must be {tuple(x.shape)} on {x.device}")
    g = g.to(x.dtype).contiguous()
    m = members or 1
    sizes = [p.numel() // m for p in params]
    mma = _route(x.dtype, e, f) == "mma"
    if mma:
        datt, dx, grads, _ = _bwd_mma(att, x, params, g, n, e, f, eps, members)
    else:
        nblk = _bwd_blocks(n, x.device)
        datt, dx = torch.empty_like(att), torch.empty_like(x)
        partial = torch.empty((m, nblk, sum(sizes)), dtype=torch.float32, device=x.device)
        grads = torch.empty((m, sum(sizes)), dtype=torch.float32, device=x.device)
        fn = _entry("fused_ffn_bwd")
        with torch.cuda.device(x.device):
            rc = fn(att.data_ptr(), x.data_ptr(), *(p.data_ptr() for p in params),
                    g.data_ptr(), datt.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                    grads.data_ptr(), m, n, e, f, _DTYPE_CODES[x.dtype], nblk, eps,
                    torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused_ffn_bwd launch failed with CUDA error {rc} "
                               f"(M, N, E, F = {m}, {n}, {e}, {f}, {x.dtype})")
    fused_ffn_block_bwd.launches += 1
    fused_ffn_block_bwd.mma_launches += mma
    pgrads = [gr.reshape(p.shape) for gr, p in zip(grads.split(sizes, dim=1), params)]
    return (datt, dx, *pgrads)


fused_ffn_block_bwd.launches = 0
fused_ffn_block_bwd.mma_launches = 0


def _fused_ffn_block_fwd_impl(att, x, wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2, eps):
    return _ffn_fwd(att, x, wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2, eps=eps)


def _fused_ffn_block_fwd_fake(att, x, wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2, eps):
    _check(att, x, (wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2))
    return torch.empty_like(x)


# The forward kernel alone as a registered op (CUDA only): the no-grad call
# of ``fused_ffn_block`` and the node an exported encoder holds.
fused_ffn_block_fwd = register_kernel_op(
    "fused_ffn_block_fwd",
    "(Tensor att, Tensor x, Tensor wu, Tensor bu, Tensor g1, Tensor b1, Tensor wf1, "
    "Tensor bf1, Tensor wf2, Tensor bf2, Tensor g2, Tensor b2, float eps) -> Tensor",
    _fused_ffn_block_fwd_impl, _fused_ffn_block_fwd_fake)


class FusedFFNBlock(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient (the JAX
    package's ``custom_vjp``). The residuals are ``att``, ``x`` and the
    parameters; the backward recomputes the forward from them. ``members``:
    None for one call, else M stacked members, every tensor (M, ...).

    Under ``torch.func.vmap`` (stacked ensemble members) the ``vmap`` rule
    stacks the members (``stack_members``) and applies this Function once
    with ``members``: one launch each way for all M, each member bitwise
    its own call."""

    @staticmethod
    def forward(att, x, wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2, eps, members=None):
        return _ffn_fwd(att, x, wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2, eps=eps,
                        members=members)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:12])
        ctx.eps, ctx.members = inputs[12], inputs[13] if len(inputs) > 13 else None

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        grads = fused_ffn_block_bwd(*ctx.saved_tensors, g, eps=ctx.eps, members=ctx.members)
        return (*grads, None, None)

    @staticmethod
    def vmap(info, in_dims, *args):
        n, stacked = stack_members(info, in_dims[:12], args[:12])
        return FusedFFNBlock.apply(*stacked, args[12], n), 0


def fused_ffn_block(att, x, wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2,
                    eps: float = LN_EPS) -> torch.Tensor:
    """unify -> +x -> LN1 -> FF -> +residual -> LN2 over (N, E) rows,
    differentiable in every input.

    ``att``/``x``: contiguous (N, E), float32 or bfloat16, one dtype (the
    compute dtype). Parameters: float32, contiguous, weights (out, in) —
    ``wu`` (E, E), ``wf1`` (F, E), ``wf2`` (E, F) — and 1-D biases and
    LayerNorm scales. CPU tensors take the plain versions; CUDA tensors
    launch the kernels (``supports`` gives the widths) or raise. Without a
    gradient to take (``no_grad``, ``inference_mode``, as in serving) the
    forward runs alone and keeps no residuals, on CUDA through the registered
    op ``fused_ffn_block_fwd``. Under ``torch.func.vmap`` (stacked members,
    any of the inputs batched; a BatchedTensor's ``requires_grad`` reads
    False) a call goes through ``FusedFFNBlock``, gradients on or off, one
    launch each way for all members (under ``no_grad`` no residual outlives
    the call)."""
    args = (att, x, wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2)
    if is_batched(*args) or (torch.is_grad_enabled() and any(a.requires_grad for a in args)):
        return FusedFFNBlock.apply(*args, eps)
    if x.device.type == "cuda":
        return fused_ffn_block_fwd(*args, eps)
    return _ffn_fwd(*args, eps=eps)


fused_ffn_block.launches = 0
fused_ffn_block.mma_launches = 0
