"""The flash-attention CUDA kernels and their wrappers, without jax.

The ``gpu`` tests hold the kernels of the three routes (the bf16 tensor
cores for bfloat16 and the 3xTF32 tensor cores for float32 at head dims 8
and 16, the CUDA cores otherwise) against their plain versions on the card
and skip without one. Forward against
``dense_attention``: float32 at atol = rtol = 1e-4 (another summation order
and the online-softmax rescale), bfloat16 at 0.05. Backward against torch
autograd through ``dense_attention``: float32 at 5e-4 (the JAX kernel tests'
gradient tolerance), bfloat16 at 0.05. Every bfloat16 output (out, dq, dk,
dv) whose plain value is not all zero is also held to ||got - want|| /
||want|| <= NORM_TOL: at the spectral
shapes the values are about 0.05 in size, so 0.05 absolute alone would pass
an output 20% off, and a tensor-core dq off by 1% must fail this check.
Every float32 output of the 3xTF32 route is held to FP32_NORM_TOL in the
same measure, which its dq off by 1% must fail too. The
rest check the routing rule, the
wrappers' argument validation, the C entry points' signatures and the build
module's cache key, which need no card. This file imports no jax, so the GPU
host runs it with ``--noconftest`` (README, "PyTorch port").
"""

import ctypes
import importlib
import re
import shutil

import numpy as np
import pytest
import torch

import multimodal_supernovae_tpu_torch.ops.flash_attention as flash_mod
from multimodal_supernovae_tpu_torch.kernels import build, library_path
from multimodal_supernovae_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR
from multimodal_supernovae_tpu_torch.ops import dense_attention, dense_attention_bwd
from multimodal_supernovae_tpu_torch.ops.flash_attention import (
    _ARGTYPES,
    _check,
    _check_bwd,
    _flash_fwd,
    _route,
    flash_attention,
    flash_attention_bwd,
)

# the module, not the ``build`` function that kernels/__init__ re-exports
build_mod = importlib.import_module("multimodal_supernovae_tpu_torch.kernels.build")
TOL = {"float32": 1e-4, "bfloat16": 0.05}
GRAD_TOL = {"float32": 5e-4, "bfloat16": 0.05}
NORM_TOL = 6e-3  # as chip_smoke.py's (sound runs: PERF.md section 6)
# float32 outputs of the 3xTF32 route against the plain versions, as
# chip_smoke.py's: between a CPU model's 3xTF32 and 1xTF32 readings
# (tests/test_torch_flash_tf32.py)
FP32_NORM_TOL = 1e-5


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


def _norm_err(got, want):
    """||got - want|| / ||want|| in float64; None where the plain output is
    exactly zero (dq and dk at T = 1), which the elementwise limit covers."""
    norm = float(torch.linalg.vector_norm(want.double().flatten()))
    diff = float(torch.linalg.vector_norm((got.double() - want.double()).flatten()))
    return diff / norm if norm else None


def _assert_close(got, want, dtype, tol, what="", norm_tol=None):
    """Elementwise within ``tol``; a bfloat16 output also within NORM_TOL
    in the normalised error, any output within ``norm_tol`` where given."""
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               msg=lambda e: f"{what}: {e}")
    if norm_tol is None and dtype in ("bfloat16", torch.bfloat16):
        norm_tol = NORM_TOL
    if norm_tol is not None:
        err = _norm_err(got, want)
        assert err is None or err <= norm_tol, f"{what}: ||got - want|| / ||want|| {err:.3e}"


def _launch_counts():
    """(launches, mma_launches, tf32_launches) of the forward and of the
    backward wrapper."""
    return tuple((fn.launches, fn.mma_launches, fn.tf32_launches)
                 for fn in (flash_attention, flash_attention_bwd))


def _route_of(monkeypatch, route, q, k, v):
    """Patch ``_route`` to the CUDA cores for route "simt"; returns the route
    the call takes."""
    if route == "simt":
        monkeypatch.setattr(flash_mod, "_route", lambda *a: "simt")
        return "simt"
    return _route(q.dtype, q.shape[-1], (q, k, v))


def _count_of(route):
    """The launch counts one call on ``route`` adds, as _launch_counts per
    wrapper."""
    return (1, route == "mma", route == "tf32")


def _tf32_norm(route):
    return FP32_NORM_TOL if route == "tf32" else None


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


# float32 on both of its routes (as routed: the 3xTF32 tensor cores at head
# dims 8 and 16; the CUDA cores through a patch of _route), bfloat16 as routed
DTYPE_ROUTES = [("float32", "routed"), ("float32", "simt"), ("bfloat16", "routed")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,route", DTYPE_ROUTES)
@pytest.mark.parametrize("shape,mask,layout", [
    ((16, 8, 200, 8), "ragged", True),          # light-curve tower
    ((8, 2, 1024, 16), "masked_rows", True),    # spectral tower
    ((4, 2, 220, 16), "ragged", False),         # T not a tile multiple
    ((4, 8, 200, 8), None, False),              # key_mask=None
    ((3, 2, 77, 32), "masked_rows", False),
    ((2, 1, 5, 64), "ragged", False),
    ((2, 2, 1, 8), None, False),                # a single key
])
def test_kernel_matches_plain(monkeypatch, dtype, route, shape, mask, layout):
    _needs_cuda()
    b, h, t, s = shape
    q, k, v, m = _inputs(sum(shape), b, h, t, s, mask, dtype, "cuda", layout)
    route = _route_of(monkeypatch, route, q, k, v)
    before = _launch_counts()[0]
    got = flash_attention(q, k, v, m, h * s)
    torch.cuda.synchronize()
    assert _launch_counts()[0] == tuple(a + c for a, c in zip(before, _count_of(route)))
    assert got.dtype == q.dtype and got.shape == q.shape
    want = dense_attention(q, k, v, m, h * s)
    _assert_close(got, want, dtype, TOL[dtype], "out", _tf32_norm(route))


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
@pytest.mark.parametrize("dtype,route", DTYPE_ROUTES)
@pytest.mark.parametrize("shape,mask,layout", [
    ((16, 8, 200, 8), "ragged", True),          # light-curve tower
    ((16, 2, 220, 16), "masked_rows", True),    # spectral tower, training T
    ((4, 2, 1024, 16), "masked_rows", False),   # spectral serving T
    ((4, 8, 200, 8), None, True),               # key_mask=None
    ((3, 2, 77, 32), "ragged", False),
    ((2, 2, 1, 8), None, False),                # a single key
])
def test_backward_kernel_matches_autograd(monkeypatch, dtype, route, shape, mask, layout):
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
    route = _route_of(monkeypatch, route, q, k, v)
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    before = _launch_counts()
    out = flash_attention(*leaves, m, h * s)
    out.backward(g)
    torch.cuda.synchronize()
    assert _launch_counts() == tuple(tuple(a + c for a, c in zip(x, _count_of(route)))
                                     for x in before)
    for name, leaf, w in zip("qkv", leaves, want):
        assert leaf.grad.dtype == q.dtype and leaf.grad.shape == q.shape
        _assert_close(leaf.grad, w, dtype, GRAD_TOL[dtype], f"d{name}", _tf32_norm(route))
    if mask == "masked_rows":  # row 0 is fully masked: no dq/dk, uniform dv
        assert torch.count_nonzero(leaves[0].grad[0]) == 0
        assert torch.count_nonzero(leaves[1].grad[0]) == 0
        assert torch.count_nonzero(leaves[2].grad[0]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["tf32", "simt"])
def test_float32_backward_matches_autograd_at_one_lc_layer(monkeypatch, route):
    """Pin of the float32 backwards, 3xTF32 (csrc/flash_attention_bwd_tf32.cu,
    as routed) and CUDA-core (csrc/flash_attention_bwd.cu, through a patch of
    _route), each with P from the forward's log2-domain (max, sum), against
    torch autograd through ``dense_attention`` on one light-curve layer's
    shapes: B = 256, H = 8, T = 200, S = 8 in the encoder's layout, ragged
    tails, one fully masked sample. Each of dq, dk, dv within 1e-5 of its
    largest plain value: a summation order difference, not a 2e-4 one."""
    _needs_cuda()
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    b, h, t, s = 256, 8, 200, 8
    q, k, v, m = _inputs(31, b, h, t, s, "masked_rows", "float32", "cuda", True)
    g = _cotangent(32, b, h, t, s, "float32")
    want = dense_attention_bwd(q, k, v, m, g, h * s)
    assert _route_of(monkeypatch, route, q, k, v) == route
    counts = _launch_counts()[1]
    _, grads = _grads_through_flash(q, k, v, m, g, h * s)
    assert _launch_counts()[1] == tuple(a + c for a, c in zip(counts, _count_of(route)))
    for name, got, w in zip("qkv", grads, want):
        err = float((got - w).abs().max()) / float(w.abs().max())
        assert err <= 1e-5, f"d{name}: max|got - want| / max|want| {err:.3e}"


def _f64_grads(q, k, v, m, g, emb):
    """dq, dk, dv of dense_attention's function in float64."""
    with torch.enable_grad():
        q, k, v = (a.detach().double().requires_grad_() for a in (q, k, v))
        c = emb ** -0.25
        scores = torch.einsum("bhts,bhus->bhtu", q * c, k * c)
        if m is not None:
            scores = scores.masked_fill(~m[:, None, None, :], -1e7)
        out = torch.einsum("bhtu,bhus->bhts", torch.softmax(scores, dim=-1), v)
        return torch.autograd.grad(out, (q, k, v), g.double())


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["tf32", "simt"])
def test_float32_backward_dq_as_accurate_as_plain_on_near_equal_values(monkeypatch, route):
    """The fault the previous pin could not see: where a row's values are
    nearly equal across its keys (as in a deep encoder layer), dP - D
    cancels, and D = g . out (the forward output's rounding) put the kernel's
    dq several times farther from a float64 reference than the plain
    version's D = rowsum(P o dP). The kernel's dq, dk and dv must sit within
    2x the plain float32 version's distance to float64 (plus 1e-7 of the
    largest value), on the 3xTF32 route (as routed) and on the CUDA cores
    (through a patch of _route)."""
    _needs_cuda()
    b, h, t, s = 64, 8, 200, 8
    rng = np.random.default_rng(33)
    q, k, _, m = _inputs(34, b, h, t, s, "masked_rows", "float32", "cuda", True)
    v0 = rng.normal(size=(b, 1, h, s)) + 0.1 * rng.normal(size=(b, t, h, s))
    v = torch.from_numpy(v0.astype(np.float32)).to("cuda").transpose(1, 2)
    g = _cotangent(35, b, h, t, s, "float32")
    ref = _f64_grads(q, k, v, m, g, h * s)
    plain = dense_attention_bwd(q, k, v, m, g, h * s)
    assert _route_of(monkeypatch, route, q, k, v) == route
    counts = _launch_counts()[1]
    _, grads = _grads_through_flash(q, k, v, m, g, h * s)
    assert _launch_counts()[1] == tuple(a + c for a, c in zip(counts, _count_of(route)))
    for name, got, p, r in zip("qkv", grads, plain, ref):
        top = float(r.abs().max())
        err = float((got.double() - r).abs().max()) / top
        plain_err = float((p.double() - r).abs().max()) / top
        assert err <= 2 * plain_err + 1e-7, (
            f"d{name}: kernel {err:.3e}, plain {plain_err:.3e} from float64")


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


# ---- the tensor-core route ------------------------------------------------

def _grads_through_flash(q, k, v, m, g, emb):
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, m, emb)
    out.backward(g)
    torch.cuda.synchronize()
    return out, [leaf.grad for leaf in leaves]


def _cotangent(seed, b, h, t, s, dtype):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(size=(b, t, h, s)).astype(np.float32))
    return g.to("cuda", getattr(torch, dtype)).transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mask,layout", [
    ((16, 8, 200, 8), "ragged", True),          # light-curve tower
    ((8, 2, 1024, 16), "masked_rows", True),    # spectral serving T
    ((4, 2, 220, 16), "masked_rows", False),    # spectral training T, contiguous
    ((4, 8, 200, 8), None, False),              # key_mask=None
    ((3, 8, 77, 8), "masked_rows", True),       # ragged T
    ((3, 2, 77, 16), "ragged", False),
    ((2, 2, 1, 8), None, True),                 # a single key
    ((2, 2, 1, 16), "ragged", False),
])
def test_mma_route_matches_plain(shape, mask, layout):
    """Forward and backward of a bf16 call at head dim 8 or 16 take the
    tensor-core kernels (one launch each) and match the plain versions."""
    _needs_cuda()
    b, h, t, s = shape
    q, k, v, m = _inputs(sum(shape) + 2, b, h, t, s, mask, "bfloat16", "cuda", layout)
    assert _route(q.dtype, s, (q, k, v)) == "mma"
    g = _cotangent(sum(shape), b, h, t, s, "bfloat16")
    counts = (flash_attention.mma_launches, flash_attention_bwd.mma_launches)
    out, grads = _grads_through_flash(q, k, v, m, g, h * s)
    assert (flash_attention.mma_launches, flash_attention_bwd.mma_launches) == (
        counts[0] + 1, counts[1] + 1)
    _assert_close(out, dense_attention(q, k, v, m, h * s), "bfloat16", TOL["bfloat16"],
                  "out")
    for name, got, want in zip("qkv", grads, dense_attention_bwd(q, k, v, m, g, h * s)):
        assert got.dtype == q.dtype and got.shape == q.shape
        _assert_close(got, want, "bfloat16", GRAD_TOL["bfloat16"], f"d{name}")
    if mask == "masked_rows":  # row 0 is fully masked: no dq/dk, uniform dv
        assert torch.count_nonzero(grads[0][0]) == 0
        assert torch.count_nonzero(grads[1][0]) == 0
        assert torch.count_nonzero(grads[2][0]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 8, 200, 8), (4, 2, 220, 16)])
def test_simt_route_keeps_bf16(monkeypatch, shape):
    """The CUDA-core kernels still compute bf16 when routed there."""
    _needs_cuda()
    b, h, t, s = shape
    q, k, v, m = _inputs(sum(shape), b, h, t, s, "masked_rows", "bfloat16", "cuda", True)
    g = _cotangent(sum(shape) + 3, b, h, t, s, "bfloat16")
    monkeypatch.setattr(flash_mod, "_route", lambda *a: "simt")
    counts = (flash_attention.mma_launches, flash_attention_bwd.mma_launches)
    out, grads = _grads_through_flash(q, k, v, m, g, h * s)
    assert (flash_attention.mma_launches, flash_attention_bwd.mma_launches) == counts
    _assert_close(out, dense_attention(q, k, v, m, h * s), "bfloat16", TOL["bfloat16"],
                  "out")
    for name, got, want in zip("qkv", grads, dense_attention_bwd(q, k, v, m, g, h * s)):
        _assert_close(got, want, "bfloat16", GRAD_TOL["bfloat16"], f"d{name}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,fwd_route,bwd_route", [
    ("bfloat16", "simt", "mma"), ("bfloat16", "mma", "simt"),
    ("float32", "simt", "tf32"), ("float32", "tf32", "simt")])
def test_either_forward_feeds_either_backward(monkeypatch, dtype, fwd_route, bwd_route):
    """The routes of a dtype share the (max, sum) residual."""
    _needs_cuda()
    b, h, t, s = 4, 2, 220, 16
    q, k, v, m = _inputs(5, b, h, t, s, "masked_rows", dtype, "cuda", True)
    g = _cotangent(6, b, h, t, s, dtype)
    monkeypatch.setattr(flash_mod, "_route", lambda *a: fwd_route)
    out, stats = _flash_fwd(q, k, v, m, h * s, with_stats=True)
    monkeypatch.setattr(flash_mod, "_route", lambda *a: bwd_route)
    before = _launch_counts()[1]
    got = flash_attention_bwd(q, k, v, m, out, stats, g, h * s)
    torch.cuda.synchronize()
    assert _launch_counts()[1] == tuple(a + c for a, c in zip(before, _count_of(bwd_route)))
    norm_tol = FP32_NORM_TOL if dtype == "float32" else None
    for name, a, w in zip("qkv", got, dense_attention_bwd(q, k, v, m, g, h * s)):
        _assert_close(a, w, dtype, GRAD_TOL[dtype], f"d{name}", norm_tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(16, 8, 200, 8), (16, 2, 220, 16)])
def test_mma_dq_one_percent_off_fails_the_check(dtype, shape):
    """Negative control: the tensor-core dq scaled by 0.99 fails the
    normalised check of its route, NORM_TOL for the bf16 kernels (while it
    passes their 0.05 elementwise limit) and FP32_NORM_TOL for the 3xTF32
    ones."""
    _needs_cuda()
    b, h, t, s = shape
    q, k, v, m = _inputs(sum(shape) + 7, b, h, t, s, "ragged", dtype, "cuda", True)
    g = _cotangent(sum(shape) + 8, b, h, t, s, dtype)
    route = _route(q.dtype, s, (q, k, v))
    assert route == ("mma" if dtype == "bfloat16" else "tf32")
    norm_tol = NORM_TOL if route == "mma" else FP32_NORM_TOL
    out, stats = _flash_fwd(q, k, v, m, h * s, with_stats=True)
    before = _launch_counts()[1]
    dq = flash_attention_bwd(q, k, v, m, out, stats, g, h * s)[0]
    torch.cuda.synchronize()
    assert _launch_counts()[1] == tuple(a + c for a, c in zip(before, _count_of(route)))
    want = dense_attention_bwd(q, k, v, m, g, h * s)[0]
    _assert_close(dq, want, dtype, GRAD_TOL[dtype], "dq", norm_tol)
    if route == "mma":
        torch.testing.assert_close((dq * 0.99).float(), want.float(),
                                   rtol=GRAD_TOL["bfloat16"], atol=GRAD_TOL["bfloat16"])
    assert _norm_err(dq * 0.99, want) > norm_tol


@pytest.mark.gpu
@pytest.mark.parametrize("route,dtype", [("mma", "bfloat16"), ("tf32", "float32")])
def test_mma_entry_raises_on_rows_off_16_bytes(monkeypatch, route, dtype):
    """No fallback: each tensor-core entry refuses rows it cannot copy 16
    bytes at a time, and the wrapper raises."""
    _needs_cuda()
    q, k, v, m = _inputs(0, 2, 2, 16, 8, "ragged", dtype, "cuda")
    # the same values one element past a 16-byte boundary
    off = [torch.zeros(a.numel() + 1, dtype=a.dtype, device="cuda")[1:].view(a.shape).copy_(a)
           for a in (q, k, v)]
    monkeypatch.setattr(flash_mod, "_route", lambda *a: route)
    before = _launch_counts()[0]
    with pytest.raises(RuntimeError, match=f"flash_attention_fwd_{route} launch failed"):
        flash_attention(*off, m, 16)
    assert _launch_counts()[0] == before


def _heads_like(layout, dtype, s, b=2, h=2, t=16):
    """(q, k, v) of one layout: the encoder's view of (B, T, H, S), a
    contiguous (B, H, T, S), one shifted by an element, or one whose rows
    lie S + 4 elements apart."""
    dt = getattr(torch, dtype)
    if layout == "encoder":
        return [torch.zeros(b, t, h, s, dtype=dt).transpose(1, 2) for _ in range(3)]
    if layout == "contiguous":
        return [torch.zeros(b, h, t, s, dtype=dt) for _ in range(3)]
    if layout == "offset":
        return [torch.zeros(b * h * t * s + 1, dtype=dt)[1:].view(b, h, t, s)
                for _ in range(3)]
    return [torch.zeros(b, h, t, s + 4, dtype=dt)[..., :s] for _ in range(3)]


@pytest.mark.parametrize("layout", ["encoder", "contiguous", "offset", "row_stride"])
@pytest.mark.parametrize("s", [8, 16, 32])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_route(dtype, s, layout):
    """The tensor cores take head dim 8 or 16 with 16-byte rows, bfloat16 on
    the bf16 route and float32 on the 3xTF32 one; the CUDA cores take the
    rest."""
    tensors = _heads_like(layout, dtype, s)
    # S + 4 elements apart is 16 bytes apart in float32 (48 or 80), not in bf16
    aligned = ("encoder", "contiguous") + (("row_stride",) if dtype == "float32" else ())
    tensor_cores = s in (8, 16) and layout in aligned
    want = {"bfloat16": "mma", "float32": "tf32"}[dtype] if tensor_cores else "simt"
    assert _route(getattr(torch, dtype), s, tensors) == want


@pytest.mark.parametrize("which", ["out", "g"])
def test_route_backward_needs_every_row_aligned(which):
    q, k, v = _heads_like("encoder", "bfloat16", 16)
    out, g = _heads_like("encoder", "bfloat16", 16)[:2]
    assert _route(torch.bfloat16, 16, (q, k, v, out, g)) == "mma"
    bad = _heads_like("offset", "bfloat16", 16)[0]
    tensors = (q, k, v, bad, g) if which == "out" else (q, k, v, out, bad)
    assert _route(torch.bfloat16, 16, tensors) == "simt"


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float, "int64_t": ctypes.c_int64}


@pytest.mark.parametrize("name", sorted(_ARGTYPES))
def test_ctypes_signature_matches_the_c_entry(name):
    """The wrapper's ctypes argument types are the C entry point's, one for
    one (ctypes would silently cut a pointer passed as an int)."""
    src = (CSRC_DIR / f"{name}.cu").read_text()
    sig = re.search(rf'extern "C" int mmsn_{name}\((.*?)\)\s*\{{', src, re.S)
    assert sig, f"no entry mmsn_{name} in csrc/{name}.cu"
    params = [" ".join(p.split()[:-1]).replace(" *", "*") for p in sig.group(1).split(",")]
    assert [_CTYPES[p] for p in params] == list(_ARGTYPES[name])


def test_library_path_keys_on_the_mma_sources():
    fwd, bwd = library_path("flash_attention_fwd_mma"), library_path("flash_attention_bwd_mma")
    assert fwd.name.startswith("libflash_attention_fwd_mma-")
    assert bwd.name.startswith("libflash_attention_bwd_mma-")
    assert len({fwd, bwd, library_path("flash_attention_fwd")}) == 3


def test_library_path_keys_on_the_mma_header(monkeypatch, tmp_path):
    """An edit of csrc/flash_attention_mma.cuh rebuilds both tensor-core
    kernels."""
    for f in CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build_mod, "CSRC_DIR", tmp_path)
    names = ("flash_attention_fwd_mma", "flash_attention_bwd_mma")
    before = [library_path(n) for n in names]
    header = tmp_path / "flash_attention_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [library_path(n) for n in names]
    assert all(a != b for a, b in zip(before, after))
