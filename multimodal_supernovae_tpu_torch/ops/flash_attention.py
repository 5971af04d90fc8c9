"""Flash attention, forward and backward: wrappers over the hand-written CUDA
kernels, paired in one ``torch.autograd.Function``. Three routes:

  * ``"mma"``, the tensor cores in bf16: ``csrc/flash_attention_fwd_mma.cu``
    and ``csrc/flash_attention_bwd_mma.cu`` (shared
    ``csrc/flash_attention_mma.cuh``), for bfloat16 with 16-byte rows at
    head dims 8, 16, 32 and 64 (``TC_HEAD_DIMS``): both towers of
    maven-lite under ``compute_dtype`` bfloat16, and the ViT image tower
    (head dim 32 at 4 heads, 64 at 2);
  * ``"tf32"``, the tensor cores in 3xTF32: ``csrc/flash_attention_fwd_tf32.cu``
    and ``csrc/flash_attention_bwd_tf32.cu`` (shared
    ``csrc/flash_attention_tf32.cuh`` and ``csrc/tf32x3.cuh``), for float32
    with 16-byte rows at the same head dims: the route every shipped
    configuration (float32, heads 64/8 and 32/2, the ViT at 128/4) trains
    on;
  * ``"simt"``, the CUDA cores: ``csrc/flash_attention_fwd.cu`` and
    ``csrc/flash_attention_bwd.cu``, for everything else: every other head
    dim from 1 to 64 (instantiated at capacities 4, 8, 16, 32 and 64, the
    true head dim passed at run time) and rows off 16 bytes.

``_route`` is the one rule that picks among them, a pure function of the
dtype, the head dim and the tensors' pointers and strides, the same for
both directions; there is no fallback from one route to another, and a
failed build or launch raises. Head dims above ``MAX_HEAD_DIM`` (64) raise.

Replaces the Pallas TPU kernels ``multimodal_supernovae_tpu/ops/
pallas_attention.py:_fwd_kernel`` and ``_bwd_kernel`` (the ``custom_vjp``
``_flash_attention_st``) and computes exactly ``ops.attention.
dense_attention`` and its autograd gradient, the plain versions: q and k
scaled by emb**-0.25 with the FULL embedding dim, float32 scores, masked
keys set to -1e7, probabilities rounded to v's dtype before the value
product, float32 accumulation, output in the input dtype; in the backward
dS zeroed at masked keys and rounded to q's dtype, P rounded to v's dtype
before dv.

What bounds them on an H100: the softmax. Each (query, key) pair costs one
exponential and a few float32 operations in the forward, two and about a
dozen in the backward, beside 2*S multiply-adds (7*S in the backward) that
the CUDA-core kernels run as float32 FMAs and the tensor-core kernels as
bf16 ``mma.sync`` or, for float32, three TF32 ``mma.sync``; q/k/v/g are
read from device memory once per tile and the (T, T) scores never leave
the SM. The plain version instead writes and
re-reads float32 (B, H, T, T) scores, softmax weights and their casts (2.1
GB of scores per layer at the spectral serving shape B=256, H=2, T=1024).
The CUDA-core design: one thread per query row (forward, dq) or key row
(dk/dv) with float32 accumulators in registers, the other side staged in
shared-memory tiles (broadcast reads). The tensor-core designs: a warp per
16 rows holding its side as mma fragments, the other side streamed in 64-row
tiles (cp.async; bf16 read by ldmatrix, float32 split into TF32 halves once a
block); see the sources' notes.

The TPU kernels' (B*H, S, T) transposes, rows-per-program blocking, VMEM
budgets and 8-row padding exist for the TPU's (8, 128) tiling and are not
carried over. The kernels take q/k/v by their (B, H, T) strides, so the
encoder's ``view(b, t, h, s).transpose(1, 2)`` head split is passed with no
copy, and write out, dq, dk and dv in (B, T, H, S) memory order, so the
head merge and its backward are views as well. The cotangent ``g`` is taken
by its strides too; only one whose head dim is not contiguous is copied.

Dispatch (``flash_attention``): a CPU tensor takes ``dense_attention``, whose
torch autograd is the plain backward; a CUDA tensor launches the kernels or
raises. On CUDA, a call that needs a gradient goes through
``FlashAttention``: the forward also stores each row's softmax (max, sum)
and the backward launches ``flash_attention_bwd``; under ``no_grad`` or
``inference_mode`` the forward runs alone, as in serving, through the
registered op ``mmsn_torch::flash_attention_fwd`` (``flash_attention_fwd``),
so that ``torch.export`` keeps it as one node of an exported encoder
(evaluation/export.py) and a loaded artifact launches the same kernel on the
same route as the live call: the route is picked inside the op's body, from
the real tensors. ``flash_attention.launches`` and
``flash_attention_bwd.launches`` count kernel launches of every route,
``.mma_launches`` those of the bf16 tensor-core route and ``.tf32_launches``
those of the 3xTF32 route (each bumped only after a launch the runtime
accepted); the CUDA-core route's are ``launches - mma_launches -
tf32_launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .attention import (
    PLAIN_DEVICES,
    dense_attention,
    dense_attention_bwd,
    is_batched,
    register_kernel_op,
)

MAX_HEAD_DIM = 64  # every head dim from 1 to this, forward and backward
TC_HEAD_DIMS = (8, 16, 32, 64)  # both tensor-core routes, both directions
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = {  # the C entry points' ctypes signatures
    "flash_attention_fwd": (
        [ctypes.c_void_p] * 6                # q, k, v, mask, out, stats
        + [ctypes.c_int] * 5                 # B, H, T, S, dtype
        + [ctypes.c_float]                   # scale
        + [ctypes.c_int64] * 6               # in, out strides (b, h, t)
        + [ctypes.c_void_p]),                # stream
    "flash_attention_fwd_mma": (
        [ctypes.c_void_p] * 6                # q, k, v, mask, out, stats
        + [ctypes.c_int] * 4                 # B, H, T, S
        + [ctypes.c_float]                   # scale
        + [ctypes.c_int64] * 6               # in, out strides (b, h, t)
        + [ctypes.c_void_p]),                # stream
    "flash_attention_fwd_tf32": (
        [ctypes.c_void_p] * 6                # q, k, v, mask, out, stats
        + [ctypes.c_int] * 4                 # B, H, T, S
        + [ctypes.c_float]                   # scale
        + [ctypes.c_int64] * 6               # in, out strides (b, h, t)
        + [ctypes.c_void_p]),                # stream
    "flash_attention_bwd": (
        [ctypes.c_void_p] * 10               # q k v mask stats g dq dk dv dsum
        + [ctypes.c_int] * 5                 # B, H, T, S, dtype
        + [ctypes.c_float]                   # scale
        + [ctypes.c_int64] * 9               # q/k/v, g, grads strides
        + [ctypes.c_void_p]),                # stream
    "flash_attention_bwd_mma": (
        [ctypes.c_void_p] * 11               # q k v mask out stats g dq dk dv dsum
        + [ctypes.c_int] * 4                 # B, H, T, S
        + [ctypes.c_float]                   # scale
        + [ctypes.c_int64] * 12              # q/k/v, out, g, grads strides
        + [ctypes.c_void_p]),                # stream
    "flash_attention_bwd_tf32": (
        [ctypes.c_void_p] * 10               # q k v mask stats g dq dk dv dsum
        + [ctypes.c_int] * 4                 # B, H, T, S
        + [ctypes.c_float]                   # scale
        + [ctypes.c_int64] * 9               # q/k/v, g, grads strides
        + [ctypes.c_void_p]),                # stream
}
_bound = {}


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


def _rows_aligned(a: torch.Tensor) -> bool:
    """Whether every (b, h, t) row of ``a`` starts on 16 bytes: the data
    pointer and the first three strides in multiples of 16 bytes."""
    sb, sh, st = a.stride()[:3]
    es = a.element_size()
    return (a.data_ptr() % 16 == 0 and sb * es % 16 == 0 and sh * es % 16 == 0
            and st * es % 16 == 0)


def _route(dtype: torch.dtype, s: int, tensors, backward: bool = False) -> str:
    """At a head dim of ``TC_HEAD_DIMS`` (8, 16, 32, 64), when every tensor
    of ``tensors`` (q, k, v; the backward adds out and g) has 16-byte rows,
    which the encoder's (B, T, H, S) views and contiguous (B, H, T, S)
    tensors both have: ``"mma"`` (the bf16 tensor-core kernels) for
    bfloat16, ``"tf32"`` (the 3xTF32 tensor-core kernels) for float32.
    ``"simt"`` (the CUDA-core kernels) otherwise. ``backward`` names the
    direction (passed positionally by the backward), which takes the same
    rule. The tensor-core entry points check the same conditions and refuse
    a launch without them (the wrapper then raises)."""
    if s in TC_HEAD_DIMS and all(_rows_aligned(a) for a in tensors):
        if dtype == torch.bfloat16:
            return "mma"
        if dtype == torch.float32:
            return "tf32"
    return "simt"


def tf32_check(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """The card's 3xTF32 arithmetic alone, to hold it bit for bit to a CPU
    model: ``split_tf32`` of each value of the float32 CUDA tensor ``x`` as
    (hi, lo) int32 bit patterns, and the three passes (lo . hi, hi . lo,
    hi . hi) of one m16n8k8 TF32 ``mma.sync`` of ``a`` (16, 8) and ``b`` (8,
    8), each from a zero accumulator, as a (3, 16, 8) float32 tensor. The
    entry is ``mmsn_flash_attention_tf32_check`` beside the forward in
    ``csrc/flash_attention_fwd_tf32.cu``; no path of the port calls it."""
    from ..kernels.build import load_library

    for name, t, shape in (("x", x, None), ("a", a, (16, 8)), ("b", b, (8, 8))):
        if (t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous()
                or (shape is not None and tuple(t.shape) != shape)):
            raise ValueError(f"{name} must be contiguous float32 on CUDA"
                             + (f" of shape {shape}" if shape else ""))
    fn = _bound.get("flash_attention_tf32_check")
    if fn is None:
        fn = load_library("flash_attention_fwd_tf32").mmsn_flash_attention_tf32_check
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _bound["flash_attention_tf32_check"] = fn
    hi, lo = torch.empty_like(x, dtype=torch.int32), torch.empty_like(x, dtype=torch.int32)
    c = torch.empty((3, 16, 8), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), hi.data_ptr(), lo.data_ptr(), x.numel(), a.data_ptr(),
                b.data_ptr(), c.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_tf32_check launch failed with CUDA error {rc}")
    return hi, lo, c


def _check(q, k, v, key_mask, emb):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, S), got shape {tuple(q.shape)}")
    for name, a in (("k", k), ("v", v)):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(
                f"{name} must match q in shape, dtype and device: "
                f"{tuple(a.shape)} {a.dtype} {a.device} vs "
                f"{tuple(q.shape)} {q.dtype} {q.device}")
        if a.stride() != q.stride():
            raise ValueError(
                f"{name} strides {a.stride()} differ from q's {q.stride()}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    b, h, t, s = q.shape
    if not 1 <= s <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {s} not supported: the flash kernels take 1 to "
                         f"{MAX_HEAD_DIM}")
    if min(b, h, t) < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if q.stride(-1) != 1:
        raise ValueError(f"the head dim must be contiguous, strides {q.stride()}")
    if key_mask is not None:
        if (key_mask.shape != (b, t) or key_mask.dtype != torch.bool
                or key_mask.device != q.device):
            raise ValueError(
                f"key_mask must be bool ({b}, {t}) on {q.device}, got "
                f"{key_mask.dtype} {tuple(key_mask.shape)} on {key_mask.device}")
        if not key_mask.is_contiguous():
            raise ValueError("key_mask must be contiguous")
    if emb < 1:
        raise ValueError(f"emb must be positive, got {emb}")


def _check_bwd(q, out, stats, g):
    s = q.shape[-1]
    if not 1 <= s <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {s} not supported by the backward: it takes 1 to "
                         f"{MAX_HEAD_DIM}")
    for name, a in (("out", out), ("g", g)):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
        if a.stride(-1) != 1:
            raise ValueError(f"the head dim of {name} must be contiguous")
    b, h, t, _ = q.shape
    if (stats is None or stats.shape != (b, h, t, 2) or stats.dtype != torch.float32
            or stats.device != q.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be contiguous float32 ({b}, {h}, {t}, 2) "
                         f"on {q.device}: the forward's residual")


def _empty_heads(q: torch.Tensor) -> torch.Tensor:
    """(B, H, T, S) output in (B, T, H, S) memory order."""
    b, h, t, s = q.shape
    return torch.empty((b, t, h, s), dtype=q.dtype, device=q.device).transpose(1, 2)


def _flash_fwd(q, k, v, key_mask, emb, with_stats: bool):
    """Launch the forward kernel of ``_route``'s route; returns (out, stats
    or None)."""
    _check(q, k, v, key_mask, emb)
    b, h, t, s = q.shape
    out = _empty_heads(q)
    stats = (torch.empty((b, h, t, 2), dtype=torch.float32, device=q.device)
             if with_stats else None)
    route = _route(q.dtype, s, (q, k, v))
    name = "flash_attention_fwd" if route == "simt" else f"flash_attention_fwd_{route}"
    dtype = (_DTYPE_CODES[q.dtype],) if route == "simt" else ()
    fn = _entry(name)
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_mask is None else key_mask.data_ptr(),
            out.data_ptr(), None if stats is None else stats.data_ptr(),
            b, h, t, s, *dtype, float(emb) ** -0.25,
            *q.stride()[:3], *out.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed with CUDA error {rc} (q {tuple(q.shape)} {q.dtype})")
    flash_attention.launches += 1
    flash_attention.mma_launches += route == "mma"
    flash_attention.tf32_launches += route == "tf32"
    return out, stats


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    out: Optional[torch.Tensor],
    stats: Optional[torch.Tensor],
    g: torch.Tensor,
    emb: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of masked attention for the cotangent ``g``.

    CPU tensors go to ``dense_attention_bwd`` (``out`` and ``stats`` are not
    read). CUDA tensors launch the backward kernels of ``_route``'s route or
    raise: ``out`` and ``stats`` are the forward's output and row residual
    (``_flash_fwd(..., with_stats=True)``, of any route; only the bf16
    tensor-core backward at head dims 8 and 16 reads ``out``), head dim from
    1 to 64."""
    if q.device.type in PLAIN_DEVICES:
        return dense_attention_bwd(q, k, v, key_mask, g, emb)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or CPU, got {q.device}")
    _check(q, k, v, key_mask, emb)
    if g.stride(-1) != 1:
        g = g.contiguous()
    _check_bwd(q, out, stats, g)
    b, h, t, s = q.shape
    dq, dk, dv = _empty_heads(q), _empty_heads(q), _empty_heads(q)
    # D of each row (bf16 tensor cores: g . out at head dims 8 and 16,
    # rowsum(P o dP) at 32 and 64; CUDA cores: rowsum(P o dP); 3xTF32: rowsum(P o
    # dP) less key 0's dP), written by the dq kernel, read by the dk/dv kernel
    dsum = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    mask = None if key_mask is None else key_mask.data_ptr()
    route = _route(q.dtype, s, (q, k, v, out, g), True)  # the backward
    if route == "mma":
        name = "flash_attention_bwd_mma"
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask, out.data_ptr(),
                stats.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), dsum.data_ptr(), b, h, t, s, float(emb) ** -0.25,
                *q.stride()[:3], *out.stride()[:3], *g.stride()[:3], *dq.stride()[:3])
    else:  # the CUDA cores and 3xTF32 take the same arguments, but the dtype
        name = "flash_attention_bwd" if route == "simt" else "flash_attention_bwd_tf32"
        dtype = (_DTYPE_CODES[q.dtype],) if route == "simt" else ()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask, stats.data_ptr(),
                g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                dsum.data_ptr(), b, h, t, s, *dtype, float(emb) ** -0.25,
                *q.stride()[:3], *g.stride()[:3], *dq.stride()[:3])
    fn = _entry(name)
    with torch.cuda.device(q.device):
        rc = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed with CUDA error {rc} (q {tuple(q.shape)} {q.dtype})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.mma_launches += route == "mma"
    flash_attention_bwd.tf32_launches += route == "tf32"
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.mma_launches = 0
flash_attention_bwd.tf32_launches = 0


def _flash_attention_fwd_impl(q, k, v, key_mask, emb):
    """The op's CUDA implementation: ``_flash_fwd``, so ``_route`` reads the
    real tensors' pointers at each call and the launch counters count as for
    a direct call."""
    return _flash_fwd(q, k, v, key_mask, emb, with_stats=False)[0]


def _flash_attention_fwd_fake(q, k, v, key_mask, emb):
    """The kernel's output as the real call makes it: (B, H, T, S) in (B, T,
    H, S) memory order, so that a traced graph sees the real strides."""
    _check(q, k, v, key_mask, emb)
    return _empty_heads(q)


# The forward kernel alone as a registered op (CUDA only): the no-grad call
# of ``flash_attention`` and the node an exported encoder holds.
flash_attention_fwd = register_kernel_op(
    "flash_attention_fwd", "(Tensor q, Tensor k, Tensor v, Tensor? key_mask, int emb) -> Tensor",
    _flash_attention_fwd_impl, _flash_attention_fwd_fake)


def _fold_members(info, in_dims, q, k, v, key_mask):
    """The vmap rule's folding: each batched input's member dim moved to the
    front, an unbatched one expanded, then (N, B, ...) merged into (N*B, ...).
    q/k/v of the encoder's (B, T, H, S) views fold with no copy; a key mask
    that is not batched is copied N times."""
    n = info.batch_size

    def front(a, d):
        return a.expand(n, *a.shape) if d is None else a.movedim(d, 0)

    q, k, v = (front(a, d).flatten(0, 1) for a, d in zip((q, k, v), in_dims))
    if key_mask is not None:
        key_mask = front(key_mask, in_dims[3]).reshape(-1, key_mask.shape[-1])
    return n, q, k, v, key_mask


def _unfold(n: int, a: torch.Tensor) -> torch.Tensor:
    return a.unflatten(0, (n, -1))


class FlashAttention(torch.autograd.Function):
    """The forward kernel with its row residual, and the backward kernel as
    its gradient (the JAX package's ``custom_vjp`` pair). ``key_mask`` and
    ``emb`` take no gradient. Returns (out, stats); stats is the forward's
    (B, H, T, 2) float32 row residual and takes no gradient.

    Under ``torch.func.vmap`` (stacked ensemble members, training/ensemble.py)
    the ``vmap`` rule folds the member axis into B: one launch each way for
    all N members, exactly N separate launches' numbers, since every (b, h)
    tile is computed alone."""

    @staticmethod
    def forward(q, k, v, key_mask, emb):
        if not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
            raise ValueError(f"head dim {q.shape[-1]} has no backward kernel: the flash "
                             f"kernels take 1 to {MAX_HEAD_DIM}")
        return _flash_fwd(q, k, v, key_mask, emb, with_stats=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, key_mask, emb = inputs
        out, stats = output
        ctx.mark_non_differentiable(stats)
        ctx.save_for_backward(q, k, v, key_mask, out, stats)
        ctx.emb = emb

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, g_stats):
        q, k, v, key_mask, out, stats = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, key_mask, out, stats, g, ctx.emb)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, key_mask, emb):
        n, q, k, v, key_mask = _fold_members(info, in_dims, q, k, v, key_mask)
        out, stats = FlashAttention.apply(q, k, v, key_mask, emb)
        return (_unfold(n, out), _unfold(n, stats)), (0, 0)


class FlashForward(torch.autograd.Function):
    """The forward kernel alone, without the residual, under ``vmap`` where
    no gradient is taken (evaluation of stacked members), with
    ``FlashAttention``'s folding rule."""

    @staticmethod
    def forward(q, k, v, key_mask, emb):
        return _flash_fwd(q, k, v, key_mask, emb, with_stats=False)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, q, k, v, key_mask, emb):
        n, q, k, v, key_mask = _fold_members(info, in_dims, q, k, v, key_mask)
        return _unfold(n, FlashForward.apply(q, k, v, key_mask, emb)), 0


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    emb: int,
) -> torch.Tensor:
    """Masked attention forward, (B, H, T, S) in and out, differentiable.

    CPU tensors go to ``dense_attention``; CUDA tensors launch the kernel
    of ``_route``'s route (float32 or bfloat16, head dim from 1 to 64, any
    T >= 1, q/k/v with equal strides and a contiguous head dim) or raise.
    When autograd needs a gradient of a CUDA call it goes through
    ``FlashAttention``; without one it goes through the registered
    op ``flash_attention_fwd``. Under ``torch.func.vmap`` a CUDA call goes
    through ``FlashAttention`` while gradients are on and ``FlashForward``
    under ``no_grad``, whose rules fold the member axis into B."""
    if q.device.type in PLAIN_DEVICES:
        return dense_attention(q, k, v, key_mask, emb)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU, got {q.device}")
    if is_batched(q, k, v, key_mask):
        if torch.is_grad_enabled():
            return FlashAttention.apply(q, k, v, key_mask, emb)[0]
        return FlashForward.apply(q, k, v, key_mask, emb)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, key_mask, emb)[0]
    return flash_attention_fwd(q, k, v, key_mask, emb)


flash_attention.launches = 0
flash_attention.mma_launches = 0
flash_attention.tf32_launches = 0
