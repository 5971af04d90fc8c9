"""The port's attention ops against the JAX package's, on CPU.

The port's ``dense_attention`` and the gradient of ``attention`` (torch
autograd on CPU tensors) are held against JAX ``dense_attention`` and
against the JAX Pallas flash kernels (forward and backward) run in TPU
interpret mode. Tolerances: float32 2e-5 forward and 5e-4 gradients (the
JAX kernel tests' own); bfloat16 0.05 (both stacks round q*scale, the
weights, dS and the outputs to bf16, at different points).
The CUDA kernels themselves are checked against ``dense_attention`` and its
autograd on the card (tests/test_torch_flash_kernel.py and chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from multimodal_supernovae_tpu.ops.attention import attention as jax_attention
from multimodal_supernovae_tpu.ops.attention import dense_attention as jax_dense
from multimodal_supernovae_tpu.ops.pallas_attention import (
    flash_attention as jax_flash,
)
from multimodal_supernovae_tpu_torch.ops import (
    attention,
    dense_attention,
    dense_attention_bwd,
)
from multimodal_supernovae_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
)

TOL = {"float32": 2e-5, "bfloat16": 0.05}
GRAD_TOL = {"float32": 5e-4, "bfloat16": 0.05}


def _inputs(seed, b=2, h=2, t=13, s=8, mask="ragged"):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, t, s)).astype(np.float32) for _ in range(3))
    if mask is None:
        m = None
    else:
        m = rng.random((b, t)) > 0.3
        m[:, 0] = True
        if mask == "full_row":
            m[-1] = False  # one sample with every key masked
    return q, k, v, m


def _to_jax(q, k, v, m, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return ([jnp.asarray(a).astype(jdt) for a in (q, k, v)],
            None if m is None else jnp.asarray(m))


def _to_torch(q, k, v, m, dtype):
    tdt = getattr(torch, dtype)
    return ([torch.from_numpy(a).to(tdt) for a in (q, k, v)],
            None if m is None else torch.from_numpy(m))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["ragged", "full_row", None])
@pytest.mark.parametrize("t", [13, 200])
def test_dense_matches_jax_dense(dtype, mask, t):
    q, k, v, m = _inputs(t, t=t, mask=mask)
    emb = q.shape[1] * q.shape[3]
    (jq, jk, jv), jm = _to_jax(q, k, v, m, dtype)
    (tq, tk, tv), tm = _to_torch(q, k, v, m, dtype)
    want = jax_dense(jq, jk, jv, jm, emb)
    got = dense_attention(tq, tk, tv, tm, emb)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


# Head dims beyond the shipped 8 and 16 that the CUDA kernels now take: 4
# (configs/smoke.yaml), 12 (no multiple of 8: the JAX dispatcher's dense
# path), 24 and 64 (a ViT at vit_emb 128, 2 heads)
OTHER_HEAD_DIMS = [4, 12, 24, 64]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["ragged", "full_row", None])
@pytest.mark.parametrize("s", OTHER_HEAD_DIMS)
def test_dense_matches_jax_dense_at_other_head_dims(dtype, mask, s):
    """test_dense_matches_jax_dense at the ViT's T = 36 and at head dims the
    flash kernels' capacities (4, 8, 16, 32, 64) hold with zero columns."""
    q, k, v, m = _inputs(300 + s, b=2, h=2, t=36, s=s, mask=mask)
    emb = q.shape[1] * q.shape[3]
    (jq, jk, jv), jm = _to_jax(q, k, v, m, dtype)
    (tq, tk, tv), tm = _to_torch(q, k, v, m, dtype)
    want = jax_dense(jq, jk, jv, jm, emb)
    got = dense_attention(tq, tk, tv, tm, emb)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["ragged", "full_row", None])
@pytest.mark.parametrize("t", [13, 200])
def test_dense_matches_jax_flash_kernel(dtype, mask, t):
    """The plain version equals the TPU kernel it stands for (interpret mode).

    Where T is not a multiple of 8 the TPU kernel pads the keys with masked
    ones, and a fully masked row then averages over the padded keys too; the
    port follows ``dense_attention`` (T keys), so that row is left out."""
    q, k, v, m = _inputs(100 + t, b=2, h=4, t=t, s=8, mask=mask)
    emb = q.shape[1] * q.shape[3]
    (jq, jk, jv), jm = _to_jax(q, k, v, m, dtype)
    (tq, tk, tv), tm = _to_torch(q, k, v, m, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash(jq, jk, jv, jm, emb)
    got = dense_attention(tq, tk, tv, tm, emb)
    rows = slice(None, -1) if mask == "full_row" and t % 8 else slice(None)
    np.testing.assert_allclose(_np(got)[rows], _np(want)[rows],
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_fully_masked_row_is_uniform():
    """-1e7 is a fill, not -inf: an all-masked row averages every value."""
    q, k, v, m = _inputs(3, t=13, mask="full_row")
    (tq, tk, tv), tm = _to_torch(q, k, v, m, "float32")
    out = dense_attention(tq, tk, tv, tm, 16)
    np.testing.assert_allclose(
        out[-1].numpy(), np.broadcast_to(v[-1].mean(axis=1, keepdims=True), v[-1].shape),
        rtol=2e-5, atol=2e-5)


def test_cpu_tensors_take_the_plain_version_without_launching():
    q, k, v, m = _inputs(4, t=37, s=16)
    (tq, tk, tv), tm = _to_torch(q, k, v, m, "float32")
    before = flash_attention.launches
    want = dense_attention(tq, tk, tv, tm, 32)
    for fn in (flash_attention, attention):
        torch.testing.assert_close(fn(tq, tk, tv, tm, 32), want, rtol=0, atol=0)
    assert flash_attention.launches == before == 0


def test_strided_head_split_is_accepted():
    """The encoder passes ``view(b, t, h, s).transpose(1, 2)`` views."""
    rng = np.random.default_rng(5)
    x = [torch.from_numpy(rng.normal(size=(2, 11, 16)).astype(np.float32))
         for _ in range(3)]
    q, k, v = (a.view(2, 11, 2, 8).transpose(1, 2) for a in x)
    want = dense_attention(q.contiguous(), k.contiguous(), v.contiguous(), None, 16)
    torch.testing.assert_close(attention(q, k, v, None, 16), want)


def _jax_grads(fn, q, k, v, g):
    _, vjp = jax.vjp(fn, q, k, v)
    return vjp(g)


def _torch_grads(q, k, v, m, g, emb):
    q, k, v = (a.clone().requires_grad_() for a in (q, k, v))
    out = attention(q, k, v, m, emb)
    out.backward(g)
    return out, (q.grad, k.grad, v.grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["ragged", "full_row", None])
@pytest.mark.parametrize("t", [16, 40])
def test_attention_grads_match_jax_flash_kernel(dtype, mask, t):
    """Gradients of the port's ``attention`` (autograd through the plain
    version) against ``jax.vjp`` through the Pallas flash kernels, in
    interpret mode, and through JAX ``dense_attention``. T is a multiple of
    8, where a fully masked row means the same in both (ROADMAP §3)."""
    q, k, v, m = _inputs(200 + t, b=2, h=2, t=t, s=8, mask=mask)
    g = np.random.default_rng(t).normal(size=q.shape).astype(np.float32)
    emb = q.shape[1] * q.shape[3]
    (jq, jk, jv), jm = _to_jax(q, k, v, m, dtype)
    jg = jnp.asarray(g).astype(jq.dtype)
    with pltpu.force_tpu_interpret_mode():
        want_flash = _jax_grads(lambda a, b, c: jax_flash(a, b, c, jm, emb),
                                jq, jk, jv, jg)
    want_dense = _jax_grads(lambda a, b, c: jax_dense(a, b, c, jm, emb),
                            jq, jk, jv, jg)
    (tq, tk, tv), tm = _to_torch(q, k, v, m, dtype)
    _, got = _torch_grads(tq, tk, tv, tm, torch.from_numpy(g).to(tq.dtype), emb)
    for name, gt, wf, wd in zip("qkv", got, want_flash, want_dense):
        assert gt.dtype == tq.dtype and gt.shape == tq.shape
        for want in (wf, wd):
            np.testing.assert_allclose(_np(gt), _np(want), rtol=GRAD_TOL[dtype],
                                       atol=GRAD_TOL[dtype], err_msg=f"d{name}")
    if mask == "full_row":  # no gradient reaches q or k through masked scores
        assert np.all(_np(got[0])[-1] == 0) and np.all(_np(got[1])[-1] == 0)
        assert np.any(_np(got[2])[-1] != 0)  # dv is not zero: P is uniform


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["ragged", "full_row", None])
@pytest.mark.parametrize("s", OTHER_HEAD_DIMS)
def test_attention_grads_match_jax_at_other_head_dims(dtype, mask, s):
    """test_attention_grads_match_jax_flash_kernel at head dims 4, 12, 24 and
    64: the port's gradients against ``jax.vjp`` through the JAX package's
    dispatcher with use_pallas on, in interpret mode (the Pallas kernels at
    24 and 64, B * H = 8; its dense path at 4 and 12, which are no
    multiple of 8), and through JAX ``dense_attention``."""
    q, k, v, m = _inputs(400 + s, b=2, h=4, t=40, s=s, mask=mask)
    g = np.random.default_rng(s).normal(size=q.shape).astype(np.float32)
    emb = q.shape[1] * q.shape[3]
    (jq, jk, jv), jm = _to_jax(q, k, v, m, dtype)
    jg = jnp.asarray(g).astype(jq.dtype)
    with pltpu.force_tpu_interpret_mode():
        want_kernel = _jax_grads(lambda a, b, c: jax_attention(a, b, c, jm, emb, use_pallas=True),
                                 jq, jk, jv, jg)
    want_dense = _jax_grads(lambda a, b, c: jax_dense(a, b, c, jm, emb), jq, jk, jv, jg)
    (tq, tk, tv), tm = _to_torch(q, k, v, m, dtype)
    _, got = _torch_grads(tq, tk, tv, tm, torch.from_numpy(g).to(tq.dtype), emb)
    for name, gt, wk, wd in zip("qkv", got, want_kernel, want_dense):
        assert gt.dtype == tq.dtype and gt.shape == tq.shape
        for want in (wk, wd):
            np.testing.assert_allclose(_np(gt), _np(want), rtol=GRAD_TOL[dtype],
                                       atol=GRAD_TOL[dtype], err_msg=f"d{name}")
    if mask == "full_row":  # no gradient reaches q or k through masked scores
        assert np.all(_np(got[0])[-1] == 0) and np.all(_np(got[1])[-1] == 0)
        assert np.any(_np(got[2])[-1] != 0)


def test_flash_attention_bwd_on_cpu_is_the_plain_backward():
    q, k, v, m = _inputs(7, t=19, mask="full_row")
    (tq, tk, tv), tm = _to_torch(q, k, v, m, "float32")
    g = torch.from_numpy(np.random.default_rng(8).normal(size=q.shape).astype(np.float32))
    _, want = _torch_grads(tq, tk, tv, tm, g, 16)
    before = flash_attention_bwd.launches
    for got in (dense_attention_bwd(tq, tk, tv, tm, g, 16),
                flash_attention_bwd(tq, tk, tv, tm, None, None, g, 16)):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert flash_attention_bwd.launches == before == 0


def test_no_grad_calls_and_cpu_grads_launch_nothing():
    q, k, v, m = _inputs(9, t=11)
    (tq, tk, tv), tm = _to_torch(q, k, v, m, "float32")
    with torch.no_grad():
        attention(tq, tk, tv, tm, 16)
    _torch_grads(tq, tk, tv, tm, torch.ones(tq.shape), 16)
    assert flash_attention.launches == 0 and flash_attention_bwd.launches == 0


def test_function_rejects_head_dims_without_a_backward():
    """Above the kernels' 64 the Function refuses, naming the limit."""
    q, k, v, m = _inputs(10, b=1, h=1, t=5, s=72)
    (tq, tk, tv), tm = _to_torch(q, k, v, m, "float32")
    with pytest.raises(ValueError, match="no backward kernel: the flash kernels take 1 to 64"):
        FlashAttention.apply(tq, tk, tv, tm, 72)
