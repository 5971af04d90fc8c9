"""The fused-QKV CUDA kernels and their wrappers, without jax.

The ``gpu`` tests hold the kernels against their plain versions on the card
and skip without one: the forward at atol = rtol = 1e-4 in float32 (another
summation order) and 0.05 in bfloat16; every backward output within 5e-4 of
that output's largest in float32 (the weight gradients are sums over B * T
rows taken in block partials, another order than the plain version's matrix
products) and 0.05 of it in bfloat16. The rest check the wrappers' dispatch
and argument validation, which need no card. This file imports no jax, so the
GPU host runs it with ``--noconftest`` (README, "PyTorch port").
"""

import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu_torch.ops import qkv_attention as qa

TOL = {"float32": 1e-4, "bfloat16": 0.05}
GRAD_TOL = {"float32": 5e-4, "bfloat16": 0.05}


def _inputs(seed, b, t, e, dtype, device="cpu", mask="random"):
    """x, mask, the packed weight (scaling folded in), wu, bu and a cotangent."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(device)

    x, g = n(b, t, e).to(getattr(torch, dtype)), n(b, t, e).to(getattr(torch, dtype))
    wqkv = n(3 * e, e, scale=e ** -0.5)
    wqkv[:2 * e] *= e ** -0.25
    wu, bu = n(e, e, scale=e ** -0.5), n(e, scale=0.1)
    if mask == "none":
        m = None
    else:
        m = rng.random((b, t)) > 0.3
        if mask == "masked_sample":
            m[0] = False       # a fully masked sample: uniform weights over its T keys
            m[1, :t // 2] = False
        m = torch.from_numpy(m).to(device)
    return x, m, wqkv, wu, bu, g


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


CASES = [  # (B, T, E, heads), mask
    ((256, 200, 64, 8), "random"),          # the light-curve tower
    ((256, 220, 32, 2), "random"),          # the spectral tower at its training length
    ((5, 37, 64, 8), "random"),             # a ragged T
    ((3, 256, 64, 8), "random"),            # the limit
    ((3, 256, 32, 2), "random"),
    ((16, 200, 64, 8), "masked_sample"),
    ((16, 220, 32, 2), "none"),
    ((4, 40, 32, 4), "random"),             # head dim 8 at E = 32
    ((1, 1, 32, 2), "none"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,mask", CASES)
def test_forward_kernel_matches_plain(dtype, shape, mask):
    _needs_cuda()
    b, t, e, h = shape
    x, m, wqkv, wu, bu, _ = _inputs(0, b, t, e, dtype, "cuda", mask)
    before = qa.fused_qkv_attention.launches
    got = qa._qkv_fwd(x, m, wqkv, wu, bu, h)
    torch.cuda.synchronize()
    assert qa.fused_qkv_attention.launches == before + 1
    want = qa.fused_qkv_attention_plain(x, m, wqkv, wu, bu, h)
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,mask", CASES)
def test_backward_kernel_matches_plain(dtype, shape, mask):
    _needs_cuda()
    b, t, e, h = shape
    x, m, wqkv, wu, _, g = _inputs(1, b, t, e, dtype, "cuda", mask)
    before = qa.fused_qkv_attention_bwd.launches
    got = qa.fused_qkv_attention_bwd(x, m, wqkv, wu, g, h)
    torch.cuda.synchronize()
    assert qa.fused_qkv_attention_bwd.launches == before + 1
    want = qa.fused_qkv_attention_bwd_plain(x, m, wqkv, wu, g, h)
    for name, a, w in zip(("dx", "dwqkv", "dwu", "dbu"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        err = float((a.float() - w.float()).abs().max())
        assert err <= GRAD_TOL[dtype] * float(w.float().abs().max()), (name, err)


@pytest.mark.gpu
def test_autograd_function_launches_both_kernels():
    _needs_cuda()
    e, h = 64, 8
    x, m, _, wu, bu, g = _inputs(2, 8, 100, e, "float32", "cuda")
    rng = np.random.default_rng(3)
    ws = [torch.from_numpy(rng.normal(size=(e, e)).astype(np.float32) * e ** -0.5).cuda()
          for _ in range(3)]
    leaves = [a.clone().requires_grad_() for a in (x, *ws, wu, bu)]
    f0, b0 = qa.fused_qkv_attention.launches, qa.fused_qkv_attention_bwd.launches
    qa.fused_qkv_attention(leaves[0], m, *leaves[1:], heads=h, emb=e).backward(g)
    assert (qa.fused_qkv_attention.launches,
            qa.fused_qkv_attention_bwd.launches) == (f0 + 1, b0 + 1)
    scale = e ** -0.25
    wqkv = torch.cat([ws[0] * scale, ws[1] * scale, ws[2]])
    dx, dwqkv, dwu, dbu = qa.fused_qkv_attention_bwd_plain(x, m, wqkv, wu, g, h)
    want = (dx, dwqkv[:e] * scale, dwqkv[e:2 * e] * scale, dwqkv[2 * e:], dwu, dbu)
    for leaf, w in zip(leaves, want):
        assert float((leaf.grad - w).abs().max()) <= 5e-4 * float(w.abs().max())


def test_cpu_takes_the_plain_versions_and_counts_nothing():
    e, h = 32, 2
    x, m, wqkv, wu, bu, g = _inputs(4, 3, 21, e, "float32", mask="masked_sample")
    scale = e ** -0.25
    wq, wk, wv = wqkv[:e] / scale, wqkv[e:2 * e] / scale, wqkv[2 * e:]
    f0, b0 = qa.fused_qkv_attention.launches, qa.fused_qkv_attention_bwd.launches
    leaves = [a.clone().requires_grad_() for a in (x, wq, wk, wv, wu, bu)]
    out = qa.fused_qkv_attention(leaves[0], m, *leaves[1:], heads=h, emb=e)
    torch.testing.assert_close(out, qa.fused_qkv_attention_plain(x, m, wqkv, wu, bu, h),
                               rtol=1e-5, atol=1e-5)
    out.backward(g)
    dx, dwqkv, dwu, dbu = qa.fused_qkv_attention_bwd_plain(x, m, wqkv, wu, g, h)
    want = (dx, dwqkv[:e] * scale, dwqkv[e:2 * e] * scale, dwqkv[2 * e:], dwu, dbu)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=1e-4, atol=1e-4)
    assert (qa.fused_qkv_attention.launches,
            qa.fused_qkv_attention_bwd.launches) == (f0, b0)


@pytest.mark.parametrize("bad", ["rank", "dtype", "weight_dtype", "weight_shape", "width",
                                 "head_dim", "length", "mask_dtype", "contiguous"])
def test_check_rejects_what_the_kernels_do_not_take(bad):
    x, m, wqkv, wu, _, _ = _inputs(5, 2, 16, 64, "float32")
    h = 8
    if bad == "rank":
        x = x[0]
    elif bad == "dtype":
        x = x.double()
    elif bad == "weight_dtype":
        wu = wu.double()
    elif bad == "weight_shape":
        wqkv = wqkv.t().contiguous()
    elif bad == "width":
        x, m, wqkv, wu, _, _ = _inputs(5, 2, 16, 48, "float32")
        h = 6
    elif bad == "head_dim":
        h = 1
    elif bad == "length":
        x, m, wqkv, wu, _, _ = _inputs(5, 2, 257, 64, "float32")
    elif bad == "mask_dtype":
        m = m.float()
    else:
        x = x.transpose(0, 1)
    with pytest.raises(ValueError):
        qa._check(x, m, wqkv, wu, h)


def test_smem_formula_matches_the_sources():
    """The limit in supports() is the sources' shared-memory size at T = 256."""
    assert qa._smem_bytes(200, 64, 8, False) == 4 * (32 * 64 + 3 * 200 * 8 + 2 * 200 * 65 + 200)
    assert qa._smem_bytes(256, 64, 8, True) == 4 * (32 * 64 + 6 * 256 * 8 + 2 * 256 * 65
                                                    + 4 * 256)
    assert qa._smem_bytes(256, 64, 8, True) <= qa.SMEM_LIMIT < qa._smem_bytes(256, 64, 16, True)
    assert qa._smem_bytes(256, 32, 16, True) <= qa.SMEM_LIMIT < qa._smem_bytes(256, 96, 8, True)
