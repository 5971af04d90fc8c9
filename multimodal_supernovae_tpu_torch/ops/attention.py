"""Attention cores (port of multimodal_supernovae_tpu/ops/attention.py).

``dense_attention`` is the plain PyTorch version of the reference's MHSA
math over already-projected heads, in the JAX layout (B, H, T, S):

  * q and k are each scaled by ``emb ** -0.25``, with ``emb`` the FULL
    embedding dim (H * S), not the head dim;
  * masked KEY positions are set (not added) to -1e7 before the softmax, so
    a fully masked row gets finite uniform weights over its T keys;
  * scores and softmax are float32 whatever the input dtype; the weights are
    cast to ``v.dtype`` before the value product.

``dense_attention_bwd`` is its gradient by torch autograd, the plain
version of the backward kernel.

``attention`` is the entry the encoders call. It goes through
``flash_attention`` (ops/flash_attention.py), which launches the CUDA
kernels (forward, and backward when a gradient is needed) for CUDA tensors
and takes ``dense_attention`` with torch autograd for CPU and meta tensors. The JAX
config's ``use_pallas`` is a TPU knob; the port reads it and ignores it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

MASK_FILL = -1e7
# The device types whose tensors take the kernels' plain versions: the CPU,
# and the meta device, where a call is shape work only (training/preflight.py).
# A CUDA tensor launches a kernel or raises.
PLAIN_DEVICES = ("cpu", "meta")


def is_batched(*tensors) -> bool:
    """Whether any of ``tensors`` is a ``torch.func.vmap`` BatchedTensor (a
    stacked ensemble member's, training/ensemble.py): a tensor whose data
    pointer and strides no kernel wrapper can read."""
    return any(isinstance(t, torch.Tensor) and torch._C._functorch.is_batchedtensor(t)
               for t in tensors)


def stack_members(info, in_dims, args):
    """The fused kernels' vmap rules' stacking (fused_block.py,
    qkv_attention.py): each batched tensor of ``args`` with its member dim
    moved to the front, an unbatched one expanded to the members (in
    autograd, so a shared weight's gradient is the sum over them), each made
    contiguous for the kernels, which read member m at m times a member's
    size; None stays None. Returns (M, the stacked args)."""
    n = info.batch_size

    def front(a, d):
        if a is None:
            return None
        return (a.expand(n, *a.shape) if d is None else a.movedim(d, 0)).contiguous()

    return n, tuple(front(a, d) for a, d in zip(args, in_dims))


def per_member(fn, members: Optional[int], *args, **kw):
    """``fn`` (a plain version) on ``args`` as they are where ``members`` is
    None, else on each member's slice of them (None stays None) with the
    results stacked: a stacked call on the CPU."""
    if members is None:
        return fn(*args, **kw)
    outs = [fn(*(None if a is None else a[m] for a in args), **kw) for m in range(members)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


# The namespace of the kernel forwards' registered ops (flash_attention.py,
# fused_block.py, qkv_attention.py); kept alive with this module.
_KERNEL_OPS = torch.library.Library("mmsn_torch", "DEF")


def register_kernel_op(name: str, schema: str, impl, fake):
    """Define ``mmsn_torch::<name><schema>`` with ``impl`` as its CUDA
    kernel and ``fake`` as its fake (shape) implementation; returns the op's
    default overload. A plain ``torch.library.Library`` registration rather
    than ``torch.library.custom_op``: the dispatcher calls ``impl`` with no
    Python wrapper around it, which takes most of ``custom_op``'s host cost
    a call over a direct launch away (probe_artifact_host.py). There
    is no CPU implementation and no autograd formula: a CPU call raises, and
    only calls without a gradient to take reach the op."""
    _KERNEL_OPS.define(name + schema)
    _KERNEL_OPS.impl(name, impl, "CUDA")
    torch.library.register_fake(f"mmsn_torch::{name}", fake, lib=_KERNEL_OPS)
    return getattr(torch.ops.mmsn_torch, name).default


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    emb: int,
) -> torch.Tensor:
    """Multi-head attention with the reference's scaling and masking.

    Args:
      q, k, v: (B, H, T, S) projected heads.
      key_mask: (B, T) bool, True where the KEY position is valid, or None.
      emb: full embedding dimension (H * S), used for the e**-1/4 scaling.

    Returns:
      (B, H, T, S) attention output in ``v.dtype``.
    """
    scale = emb ** -0.25
    qs = (q * scale).float()
    ks = (k * scale).float()
    scores = torch.einsum("bhts,bhus->bhtu", qs, ks)
    if key_mask is not None:
        scores.masked_fill_(~key_mask[:, None, None, :], MASK_FILL)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhtu,bhus->bhts", weights.to(v.dtype), v)


def dense_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    g: torch.Tensor,
    emb: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``dense_attention`` for the cotangent ``g``, by torch
    autograd: the plain version of the backward kernel. ``masked_fill_``
    passes zero gradient to masked scores, as the JAX ``where`` does."""
    with torch.enable_grad():
        q, k, v = (a.detach().requires_grad_() for a in (q, k, v))
        out = dense_attention(q, k, v, key_mask, emb)
        return torch.autograd.grad(out, (q, k, v), g)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    emb: int,
) -> torch.Tensor:
    """Masked attention, differentiable: the CUDA kernels for CUDA tensors,
    ``dense_attention`` for CPU tensors (the dispatch lives in the kernels'
    wrapper)."""
    from .flash_attention import flash_attention

    return flash_attention(q, k, v, key_mask, emb)
