"""The fused-block CUDA kernels and their wrappers, without jax.

The ``gpu`` tests hold the kernels against their plain versions on the card
and skip without one: the forward at atol = rtol = 1e-4 in float32 (another
summation order) and 0.05 in bfloat16; every backward output within 5e-4 of
that output's largest in float32 (the weight gradients are sums over N rows,
taken in another order than the plain version's matrix products) and 0.05
of it in bfloat16. The rest check the wrappers' dispatch and argument
validation, which need no card. This file imports no jax, so the GPU host
runs it with ``--noconftest`` (README, "PyTorch port").
"""

import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu_torch.ops import fused_block as fb

TOL = {"float32": 1e-4, "bfloat16": 0.05}
GRAD_TOL = {"float32": 5e-4, "bfloat16": 0.05}


def _inputs(seed, n, e, f, dtype, device="cpu"):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0):
        a = rng.normal(size=shape).astype(np.float32) * scale + shift
        return torch.from_numpy(a).to(device)

    att, x = t(n, e).to(getattr(torch, dtype)), t(n, e).to(getattr(torch, dtype))
    params = [t(e, e, scale=e ** -0.5), t(e, scale=0.1), t(e, scale=0.1, shift=1.0),
              t(e, scale=0.1), t(f, e, scale=e ** -0.5), t(f, scale=0.1),
              t(e, f, scale=f ** -0.5), t(e, scale=0.1), t(e, scale=0.1, shift=1.0),
              t(e, scale=0.1)]
    g = t(n, e).to(getattr(torch, dtype))
    return att, x, params, g


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


CASES = [(51200, 64, 256), (51200 - 37, 64, 256), (4096 - 5, 128, 512), (33, 64, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,e,f", CASES)
def test_forward_kernel_matches_plain(dtype, n, e, f):
    _needs_cuda()
    att, x, params, _ = _inputs(0, n, e, f, dtype, "cuda")
    before = fb.fused_ffn_block.launches
    got = fb.fused_ffn_block(att, x, *params)
    torch.cuda.synchronize()
    assert fb.fused_ffn_block.launches == before + 1
    want = fb.fused_ffn_block_plain(att, x, *params)
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,e,f", CASES)
def test_backward_kernel_matches_plain(dtype, n, e, f):
    _needs_cuda()
    att, x, params, g = _inputs(1, n, e, f, dtype, "cuda")
    before = fb.fused_ffn_block_bwd.launches
    got = fb.fused_ffn_block_bwd(att, x, *params, g)
    torch.cuda.synchronize()
    assert fb.fused_ffn_block_bwd.launches == before + 1
    want = fb.fused_ffn_block_bwd_plain(att, x, *params, g)
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape and a.dtype == w.dtype, i
        err = float((a.float() - w.float()).abs().max())
        assert err <= GRAD_TOL[dtype] * float(w.float().abs().max()), (i, err)


@pytest.mark.gpu
def test_autograd_function_launches_both_kernels():
    _needs_cuda()
    att, x, params, g = _inputs(2, 1000, 64, 256, "float32", "cuda")
    leaves = [a.clone().requires_grad_() for a in [att, x] + params]
    f0, b0 = fb.fused_ffn_block.launches, fb.fused_ffn_block_bwd.launches
    fb.fused_ffn_block(*leaves).backward(g)
    assert (fb.fused_ffn_block.launches, fb.fused_ffn_block_bwd.launches) == (f0 + 1, b0 + 1)
    want = fb.fused_ffn_block_bwd_plain(att, x, *params, g)
    for leaf, w in zip(leaves, want):
        assert float((leaf.grad - w).abs().max()) <= 5e-4 * float(w.abs().max())


def test_cpu_takes_the_plain_versions_and_counts_nothing():
    att, x, params, g = _inputs(3, 40, 64, 256, "float32")
    f0, b0 = fb.fused_ffn_block.launches, fb.fused_ffn_block_bwd.launches
    leaves = [a.clone().requires_grad_() for a in [att, x] + params]
    out = fb.fused_ffn_block(*leaves)
    torch.testing.assert_close(out, fb.fused_ffn_block_plain(att, x, *params))
    out.backward(g)
    for leaf, w in zip(leaves, fb.fused_ffn_block_bwd_plain(att, x, *params, g)):
        torch.testing.assert_close(leaf.grad, w)
    assert (fb.fused_ffn_block.launches, fb.fused_ffn_block_bwd.launches) == (f0, b0)


@pytest.mark.parametrize("bad", ["shape", "dtype", "param_dtype", "width", "contiguous"])
def test_check_rejects_what_the_kernels_do_not_take(bad):
    att, x, params, _ = _inputs(4, 8, 64, 256, "float32")
    if bad == "shape":
        att = att[:4]
    elif bad == "dtype":
        att = att.double()
    elif bad == "param_dtype":
        params[0] = params[0].double()
    elif bad == "width":
        att, x, params, _ = _inputs(4, 8, 48, 192, "float32")
    else:
        params[4] = params[6].t()
    with pytest.raises(ValueError):
        fb._check(att, x, params)


def test_smem_formula_matches_the_sources():
    """The limits in supports() are the sources' shared-memory sizes."""
    assert fb._smem_bytes(64, 256, False) == 4 * (32 * 384 + 32 * 257)
    assert fb._smem_bytes(64, 256, True) == 4 * (32 * 576 + 64 + 32 * 257)
    assert fb._smem_bytes(160, 640, True) <= fb.SMEM_LIMIT < fb._smem_bytes(192, 768, True)
