"""Flash-attention forward: wrapper over the hand-written CUDA kernel
``csrc/flash_attention_fwd.cu``.

Replaces the Pallas TPU kernel ``multimodal_supernovae_tpu/ops/
pallas_attention.py:_fwd_kernel`` (reached through ``flash_attention`` and
``_flash_fwd_impl``) and computes exactly ``ops.attention.dense_attention``,
its plain version: q and k scaled by emb**-0.25 with the FULL embedding dim,
float32 scores, masked keys set to -1e7, probabilities rounded to v's dtype
before the value product, float32 accumulation, output in the input dtype.

What bounds it on an H100: CUDA-core compute. Each (query, key) pair costs
2*S FMAs and one exponential; q/k/v are read from device memory once per
128-row query tile and the (T, T) scores never leave the SM. The plain
version instead writes and re-reads float32 (B, H, T, T) scores, softmax
weights and their cast (2.1 GB of scores per layer at the spectral serving
shape B=256, H=2, T=1024). The design: one thread per query row with an
online softmax in registers, K/V tiles of 32 keys staged in shared memory
(broadcast reads), so any T fits; no tensor cores, since the light-curve
head dim of 8 is below every MMA tile.

The TPU kernel's (B*H, S, T) transposes, rows-per-program blocking, VMEM
budgets and 8-row padding exist for the TPU's (8, 128) tiling and are not
carried over. The kernel takes q/k/v by their (B, H, T) strides, so the
encoder's ``view(b, t, h, s).transpose(1, 2)`` head split is passed with no
copy, and writes its output in (B, T, H, S) memory order, so the caller's
head merge is a view as well.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. ``flash_attention.launches`` counts kernel launches (it is
bumped only after a launch the runtime accepted).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .attention import dense_attention

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIB_NAME = "flash_attention_fwd"
_bound = None


def _entry():
    """The C entry point, with its ctypes signature declared once."""
    global _bound
    if _bound is None:
        from ..kernels.build import load_library

        fn = load_library(_LIB_NAME).mmsn_flash_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 5            # q, k, v, mask, out
            + [ctypes.c_int] * 5             # B, H, T, S, dtype
            + [ctypes.c_float]               # scale
            + [ctypes.c_int64] * 6           # in strides, out strides (b, h, t)
            + [ctypes.c_void_p]              # stream
        )
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


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


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    emb: int,
) -> torch.Tensor:
    """Masked attention forward, (B, H, T, S) in and out.

    CPU tensors go to ``dense_attention``; CUDA tensors launch the kernel
    (float32 or bfloat16, head dim in {8, 16, 32, 64}, any T >= 1, q/k/v
    with equal strides and a contiguous head dim) or raise."""
    if q.device.type == "cpu":
        return dense_attention(q, k, v, key_mask, emb)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU, got {q.device}")
    _check(q, k, v, key_mask, emb)
    b, h, t, s = q.shape
    out = torch.empty((b, t, h, s), dtype=q.dtype, device=q.device).transpose(1, 2)
    fn = _entry()
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_mask is None else key_mask.data_ptr(),
            out.data_ptr(),
            b, h, t, s, _DTYPE_CODES[q.dtype], float(emb) ** -0.25,
            *q.stride()[:3], *out.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_fwd launch failed with CUDA error {rc} "
            f"(q {tuple(q.shape)} {q.dtype})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
