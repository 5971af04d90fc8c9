"""Flash attention, forward and backward: wrappers over the hand-written CUDA
kernels, paired in one ``torch.autograd.Function``. Three routes:

  * ``"mma"``, the tensor cores in bf16: ``csrc/flash_attention_fwd_mma.cu``
    and ``csrc/flash_attention_bwd_mma.cu`` (shared
    ``csrc/flash_attention_mma.cuh``), for bfloat16 at head dims 8 and 16
    with 16-byte rows: both towers of maven-lite under ``compute_dtype``
    bfloat16;
  * ``"tf32"``, the tensor cores in 3xTF32: ``csrc/flash_attention_fwd_tf32.cu``
    and ``csrc/flash_attention_bwd_tf32.cu`` (shared
    ``csrc/flash_attention_tf32.cuh`` and ``csrc/tf32x3.cuh``), for float32
    at head dims 8 and 16 with 16-byte rows: the route every shipped
    configuration (float32, heads 64/8 and 32/2) trains on;
  * ``"simt"``, the CUDA cores: ``csrc/flash_attention_fwd.cu`` and
    ``csrc/flash_attention_bwd.cu``, for everything else (head dims 32 and
    64, rows off 16 bytes).

``_route`` is the one rule that picks among them, a pure function of the
dtype, the head dim and the tensors' pointers and strides; there is no
fallback from one route to another, and a failed build or launch raises.

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
``inference_mode`` the forward runs alone, as in serving.
``flash_attention.launches`` and ``flash_attention_bwd.launches`` count
kernel launches of every route, ``.mma_launches`` those of the bf16
tensor-core route and ``.tf32_launches`` those of the 3xTF32 route (each
bumped only after a launch the runtime accepted); the CUDA-core route's are
``launches - mma_launches - tf32_launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .attention import dense_attention, dense_attention_bwd

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64)
BWD_HEAD_DIMS = (8, 16, 32)
MMA_HEAD_DIMS = (8, 16)  # both tensor-core routes
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


def _route(dtype: torch.dtype, s: int, tensors) -> str:
    """At head dim 8 or 16, when every tensor of ``tensors`` (q, k, v; the
    backward adds out and g) has 16-byte rows, which the encoder's (B, T, H,
    S) views and contiguous (B, H, T, S) tensors both have: ``"mma"`` (the
    bf16 tensor-core kernels) for bfloat16, ``"tf32"`` (the 3xTF32
    tensor-core kernels) for float32. ``"simt"`` (the CUDA-core kernels)
    otherwise. The tensor-core entry points check the same conditions and
    refuse a launch without them (the wrapper then raises)."""
    if s in MMA_HEAD_DIMS and all(_rows_aligned(a) for a in tensors):
        if dtype == torch.bfloat16:
            return "mma"
        if dtype == torch.float32:
            return "tf32"
    return "simt"


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
    if s not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {s} not supported {SUPPORTED_HEAD_DIMS}")
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
    if s not in BWD_HEAD_DIMS:
        raise ValueError(f"head dim {s} not supported by the backward {BWD_HEAD_DIMS}")
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
    (``_flash_fwd(..., with_stats=True)``, of any route; the CUDA-core and
    3xTF32 backwards read only ``stats``), head dim in {8, 16, 32}."""
    if q.device.type == "cpu":
        return dense_attention_bwd(q, k, v, key_mask, g, emb)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or CPU, got {q.device}")
    _check(q, k, v, key_mask, emb)
    if g.stride(-1) != 1:
        g = g.contiguous()
    _check_bwd(q, out, stats, g)
    b, h, t, s = q.shape
    dq, dk, dv = _empty_heads(q), _empty_heads(q), _empty_heads(q)
    # D of each row (bf16 tensor cores: g . out; CUDA cores: rowsum(P o dP);
    # 3xTF32: rowsum(P o dP) less key 0's dP), written by the dq kernel, read
    # by the dk/dv kernel
    dsum = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    mask = None if key_mask is None else key_mask.data_ptr()
    route = _route(q.dtype, s, (q, k, v, out, g))
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


class FlashAttention(torch.autograd.Function):
    """The forward kernel with its row residual, and the backward kernel as
    its gradient (the JAX package's ``custom_vjp`` pair). ``key_mask`` and
    ``emb`` take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, emb):
        if q.shape[-1] not in BWD_HEAD_DIMS:
            raise ValueError(f"head dim {q.shape[-1]} has no backward kernel "
                             f"{BWD_HEAD_DIMS}")
        out, stats = _flash_fwd(q, k, v, key_mask, emb, with_stats=True)
        ctx.save_for_backward(q, k, v, key_mask, out, stats)
        ctx.emb = emb
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, key_mask, out, stats = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, key_mask, out, stats, g, ctx.emb)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    emb: int,
) -> torch.Tensor:
    """Masked attention forward, (B, H, T, S) in and out, differentiable.

    CPU tensors go to ``dense_attention``; CUDA tensors launch the kernel
    of ``_route``'s route (float32 or bfloat16, head dim in {8, 16, 32, 64},
    any T >= 1, q/k/v with equal strides and a contiguous head dim) or
    raise. When autograd
    needs a gradient of a CUDA call it goes through ``FlashAttention``
    (head dim in {8, 16, 32})."""
    if q.device.type == "cpu":
        return dense_attention(q, k, v, key_mask, emb)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, key_mask, emb)
    return _flash_fwd(q, k, v, key_mask, emb, with_stats=False)[0]


flash_attention.launches = 0
flash_attention.mma_launches = 0
flash_attention.tf32_launches = 0
