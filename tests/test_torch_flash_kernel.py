"""The flash-attention CUDA kernels and their wrappers, without jax.

The ``gpu`` tests hold the kernels against their plain versions on the card
and skip without one. Forward against ``dense_attention``: float32 at
atol = rtol = 1e-4 (another summation order and the online-softmax
rescale), bfloat16 at 0.05. Backward against torch autograd through
``dense_attention``: float32 at 5e-4 (the JAX kernel tests' gradient
tolerance), bfloat16 at 0.05. The rest check the wrappers' argument
validation and the build module's cache key, which need no card. This file
imports no jax, so the GPU host runs it with ``--noconftest`` (README,
"PyTorch port").
"""

import shutil

import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu_torch.kernels import build, library_path
from multimodal_supernovae_tpu_torch.kernels.build import BUILD_DIR
from multimodal_supernovae_tpu_torch.ops import dense_attention, dense_attention_bwd
from multimodal_supernovae_tpu_torch.ops.flash_attention import (
    _check,
    _check_bwd,
    _flash_fwd,
    flash_attention,
    flash_attention_bwd,
)

TOL = {"float32": 1e-4, "bfloat16": 0.05}
GRAD_TOL = {"float32": 5e-4, "bfloat16": 0.05}


def _inputs(seed, b, h, t, s, mask, dtype, device="cpu", model_layout=False):
    rng = np.random.default_rng(seed)

    def one():
        shape = (b, t, h, s) if model_layout else (b, h, t, s)
        a = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        a = a.to(device, getattr(torch, dtype))
        return a.transpose(1, 2) if model_layout else a

    q, k, v = one(), one(), one()
    if mask is None:
        return q, k, v, None
    m = np.ones((b, t), bool)
    for i in range(b):  # ragged tails like the synthetic spectra
        m[i, rng.integers(t // 2, t + 1):] = False
    if mask == "masked_rows":
        m[0] = False            # every key masked: uniform weights
        m[-1, : min(t - 1, 100)] = False  # leading key tiles masked only
    return q, k, v, torch.from_numpy(m).to(device)


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,mask,layout", [
    ((16, 8, 200, 8), "ragged", True),          # light-curve tower
    ((8, 2, 1024, 16), "masked_rows", True),    # spectral tower
    ((4, 2, 220, 16), "ragged", False),         # T not a tile multiple
    ((4, 8, 200, 8), None, False),              # key_mask=None
    ((3, 2, 77, 32), "masked_rows", False),
    ((2, 1, 5, 64), "ragged", False),
    ((2, 2, 1, 8), None, False),                # a single key
])
def test_kernel_matches_plain(dtype, shape, mask, layout):
    _needs_cuda()
    b, h, t, s = shape
    q, k, v, m = _inputs(sum(shape), b, h, t, s, mask, dtype, "cuda", layout)
    before = flash_attention.launches
    got = flash_attention(q, k, v, m, h * s)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = dense_attention(q, k, v, m, h * s)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.gpu
def test_kernel_rejects_unsupported_on_cuda():
    _needs_cuda()
    q, k, v, m = _inputs(0, 2, 2, 16, 12, "ragged", "float32", "cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v, m, 24)
    q, k, v, m = _inputs(0, 2, 2, 16, 8, "ragged", "float32", "cuda")
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), k.half(), v.half(), m, 16)


@pytest.mark.parametrize("bad,match", [
    ("head_dim", "head dim"),
    ("dtype", "dtype"),
    ("stride", "strides"),
    ("mask_dtype", "key_mask"),
    ("mask_shape", "key_mask"),
    ("mask_layout", "contiguous"),
    ("last_dim", "contiguous"),
    ("rank", r"\(B, H, T, S\)"),
])
def test_wrapper_validation(bad, match):
    q, k, v, m = _inputs(1, 2, 2, 16, 8, "ragged", "float32")
    emb = 16
    if bad == "head_dim":
        q, k, v, m = _inputs(1, 2, 2, 16, 12, "ragged", "float32")
        emb = 24
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "stride":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "mask_dtype":
        m = m.float()
    elif bad == "mask_shape":
        m = m[:, :8]
    elif bad == "mask_layout":
        m = torch.ones(16, 2, dtype=torch.bool).t()
    elif bad == "last_dim":
        q, k, v = (a.transpose(2, 3).contiguous().transpose(2, 3) for a in (q, k, v))
    elif bad == "rank":
        q, k, v = q[0], k[0], v[0]
    with pytest.raises(ValueError, match=match):
        _check(q, k, v, m, emb)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,mask,layout", [
    ((16, 8, 200, 8), "ragged", True),          # light-curve tower
    ((16, 2, 220, 16), "masked_rows", True),    # spectral tower, training T
    ((4, 2, 1024, 16), "masked_rows", False),   # spectral serving T
    ((4, 8, 200, 8), None, True),               # key_mask=None
    ((3, 2, 77, 32), "ragged", False),
    ((2, 2, 1, 8), None, False),                # a single key
])
def test_backward_kernel_matches_autograd(dtype, shape, mask, layout):
    """dq, dk, dv through ``flash_attention``'s autograd Function against
    torch autograd through ``dense_attention``, with the cotangent in the
    head merge's (B, T, H, S) memory order, as the encoder hands it back."""
    _needs_cuda()
    b, h, t, s = shape
    q, k, v, m = _inputs(sum(shape) + 1, b, h, t, s, mask, dtype, "cuda", layout)
    rng = np.random.default_rng(sum(shape))
    g = torch.from_numpy(rng.normal(size=(b, t, h, s)).astype(np.float32))
    g = g.to("cuda", q.dtype).transpose(1, 2)
    want = dense_attention_bwd(q, k, v, m, g, h * s)
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    fwd0, bwd0 = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*leaves, m, h * s)
    out.backward(g)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (fwd0 + 1, bwd0 + 1)
    for name, leaf, w in zip("qkv", leaves, want):
        assert leaf.grad.dtype == q.dtype and leaf.grad.shape == q.shape
        torch.testing.assert_close(leaf.grad.float(), w.float(), rtol=GRAD_TOL[dtype],
                                   atol=GRAD_TOL[dtype], msg=lambda e: f"d{name}: {e}")
    if mask == "masked_rows":  # row 0 is fully masked: no dq/dk, uniform dv
        assert torch.count_nonzero(leaves[0].grad[0]) == 0
        assert torch.count_nonzero(leaves[1].grad[0]) == 0
        assert torch.count_nonzero(leaves[2].grad[0]) > 0


@pytest.mark.gpu
def test_backward_wrapper_rejects_unsupported_on_cuda():
    _needs_cuda()
    q, k, v, m = _inputs(0, 2, 1, 16, 64, "ragged", "float32", "cuda")
    leaves = [a.requires_grad_() for a in (q, k, v)]
    with pytest.raises(ValueError, match="no backward kernel"):
        flash_attention(*leaves, m, 64)
    q, k, v, m = _inputs(0, 2, 2, 16, 8, "ragged", "float32", "cuda")
    out, stats = _flash_fwd(q, k, v, m, 16, with_stats=True)
    with pytest.raises(ValueError, match="stats"):
        flash_attention_bwd(q, k, v, m, out, None, out, 16)


@pytest.mark.parametrize("bad,match", [
    ("head_dim", "backward"),
    ("out_shape", "out must match"),
    ("g_dtype", "g must match"),
    ("out_last_dim", "head dim of out"),
    ("stats_shape", "stats"),
    ("stats_dtype", "stats"),
    ("stats_layout", "stats"),
])
def test_backward_wrapper_validation(bad, match):
    b, h, t, s = 2, 2, 16, 8
    q, _, _, _ = _inputs(3, b, h, t, s, None, "float32")
    out, g = q.clone(), q.clone()
    stats = torch.zeros(b, h, t, 2)
    if bad == "head_dim":
        q, _, _, _ = _inputs(3, b, h, t, 64, None, "float32")
        out, g = q.clone(), q.clone()
    elif bad == "out_shape":
        out = out[:, :, :8]
    elif bad == "g_dtype":
        g = g.bfloat16()
    elif bad == "out_last_dim":
        out = out.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "stats_shape":
        stats = stats[..., :1]
    elif bad == "stats_dtype":
        stats = stats.double()
    elif bad == "stats_layout":
        stats = torch.zeros(b, h, 2, t).transpose(2, 3)
    with pytest.raises(ValueError, match=match):
        _check_bwd(q, out, stats, g)


def test_valid_inputs_pass_validation():
    q, k, v, m = _inputs(2, 2, 2, 16, 8, "ragged", "bfloat16", model_layout=True)
    _check(q, k, v, m, 16)
    _check(q, k, v, None, 16)
    _check_bwd(q, q, torch.zeros(2, 2, 16, 2), k)


def test_library_path_keys_on_the_source():
    path = library_path("flash_attention_fwd")
    assert path.parent == BUILD_DIR and path.suffix == ".so"
    assert path == library_path("flash_attention_fwd")
    assert path.name.startswith("libflash_attention_fwd-")


def test_each_source_builds_to_its_own_library():
    fwd, bwd = library_path("flash_attention_fwd"), library_path("flash_attention_bwd")
    assert bwd.parent == BUILD_DIR and bwd.name.startswith("libflash_attention_bwd-")
    assert fwd != bwd


def test_build_without_nvcc_says_so(monkeypatch):
    if shutil.which("nvcc"):
        pytest.skip("nvcc present: the build itself is exercised on the GPU host")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build("flash_attention_fwd")
