"""The fused-QKV CUDA kernels and their wrappers, without jax.

The ``gpu`` tests hold the kernels of both routes (the tensor cores for
bfloat16 at head dims 8 and 16, the CUDA cores otherwise) against their plain
versions on the card and skip without one: the forward at atol = rtol = 1e-4
in float32 (another summation order) and 0.05 in bfloat16; every backward
output within 5e-4 of that output's largest in float32 (the weight gradients
are sums over B * T rows taken in block partials, another order than the
plain version's matrix products) and 0.05 of it in bfloat16. Every bfloat16
output (out, dx, dWqkv, dWu, dbu) whose plain value is not all zero is also
held to ||got - want|| / ||want|| <= NORM_TOL, which a tensor-core dWqkv
whose query third is off by 1% must fail. The rest check the routing rule,
the wrappers' dispatch and argument validation, the C entry points'
signatures and the build key, which need no card. This file imports no jax,
so the GPU host runs it with ``--noconftest`` (README, "PyTorch port").
"""

import ctypes
import importlib
import re

import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu_torch.kernels import library_path
from multimodal_supernovae_tpu_torch.kernels.build import CSRC_DIR
from multimodal_supernovae_tpu_torch.ops import qkv_attention as qa

# the module, not the ``build`` function that kernels/__init__ re-exports
build_mod = importlib.import_module("multimodal_supernovae_tpu_torch.kernels.build")

TOL = {"float32": 1e-4, "bfloat16": 0.05}
GRAD_TOL = {"float32": 5e-4, "bfloat16": 0.05}
NORM_TOL = 6e-3  # as chip_smoke.py's (sound runs: PERF.md section 6)
# (dtype, route) of the card tests: float32 on the CUDA cores, bfloat16 on both
ROUTED = [("float32", "simt"), ("bfloat16", "simt"), ("bfloat16", "mma")]


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


def _norm_err(got, want):
    """||got - want|| / ||want|| in float64; None where the plain output is
    exactly zero, which the elementwise limit covers."""
    norm = float(torch.linalg.vector_norm(want.double().flatten()))
    diff = float(torch.linalg.vector_norm((got.double() - want.double()).flatten()))
    return diff / norm if norm else None


def _on_route(monkeypatch, route, dtype, s):
    """Take ``route``: the tensor cores where ``_route`` picks them, the CUDA
    cores through a patch of ``_route`` (a test-time patch, no user knob)."""
    if route == "simt":
        monkeypatch.setattr(qa, "_route", lambda *a: "simt")
    else:
        assert qa._route(getattr(torch, dtype), s) == "mma"


def _counts():
    return (qa.fused_qkv_attention.launches, qa.fused_qkv_attention.mma_launches,
            qa.fused_qkv_attention_bwd.launches, qa.fused_qkv_attention_bwd.mma_launches)


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
@pytest.mark.parametrize("dtype,route", ROUTED)
@pytest.mark.parametrize("shape,mask", CASES)
def test_forward_kernel_matches_plain(monkeypatch, dtype, route, shape, mask):
    _needs_cuda()
    b, t, e, h = shape
    x, m, wqkv, wu, bu, _ = _inputs(0, b, t, e, dtype, "cuda", mask)
    _on_route(monkeypatch, route, dtype, e // h)
    before = _counts()
    got = qa._qkv_fwd(x, m, wqkv, wu, bu, h)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + (route == "mma")) + before[2:]
    want = qa.fused_qkv_attention_plain(x, m, wqkv, wu, bu, h)
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    if dtype == "bfloat16":
        err = _norm_err(got, want)
        assert err is None or err <= NORM_TOL, err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,route", ROUTED)
@pytest.mark.parametrize("shape,mask", CASES)
def test_backward_kernel_matches_plain(monkeypatch, dtype, route, shape, mask):
    _needs_cuda()
    b, t, e, h = shape
    x, m, wqkv, wu, _, g = _inputs(1, b, t, e, dtype, "cuda", mask)
    _on_route(monkeypatch, route, dtype, e // h)
    before = _counts()
    got = qa.fused_qkv_attention_bwd(x, m, wqkv, wu, g, h)
    torch.cuda.synchronize()
    assert _counts() == before[:2] + (before[2] + 1, before[3] + (route == "mma"))
    want = qa.fused_qkv_attention_bwd_plain(x, m, wqkv, wu, g, h)
    for name, a, w in zip(("dx", "dwqkv", "dwu", "dbu"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        err = float((a.float() - w.float()).abs().max())
        assert err <= GRAD_TOL[dtype] * float(w.float().abs().max()), (name, err)
        if dtype == "bfloat16":
            rel = _norm_err(a, w)
            assert rel is None or rel <= NORM_TOL, (name, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 200, 64, 8), (256, 220, 32, 2)])
def test_mma_dwqkv_one_percent_off_fails_the_check(shape):
    """Negative control: the tensor-core dWqkv with its query third scaled by
    0.99 passes the elementwise limit but not NORM_TOL, over the whole of
    dWqkv and (by a wider margin) over the query third, which the sound
    kernel's query, key and value thirds each meet on their own."""
    _needs_cuda()
    b, t, e, h = shape
    x, m, wqkv, wu, _, g = _inputs(6, b, t, e, "bfloat16", "cuda")
    before = qa.fused_qkv_attention_bwd.mma_launches
    dwqkv = qa.fused_qkv_attention_bwd(x, m, wqkv, wu, g, h)[1]
    torch.cuda.synchronize()
    assert qa.fused_qkv_attention_bwd.mma_launches == before + 1
    want = qa.fused_qkv_attention_bwd_plain(x, m, wqkv, wu, g, h)[1]
    assert _norm_err(dwqkv, want) <= NORM_TOL
    for i in range(3):
        assert _norm_err(dwqkv[i * e:(i + 1) * e], want[i * e:(i + 1) * e]) <= NORM_TOL
    wrong = dwqkv.clone()
    wrong[:e] *= 0.99
    assert float((wrong - want).abs().max()) <= GRAD_TOL["bfloat16"] * float(want.abs().max())
    assert _norm_err(wrong, want) > NORM_TOL
    assert _norm_err(wrong[:e], want[:e]) > NORM_TOL


def _f64_grads(x, m, wqkv, wu, g, heads):
    """dx and dWqkv of the whole SelfAttention's function in float64."""
    with torch.enable_grad():
        x64 = x.double().requires_grad_()
        w64 = wqkv.double().requires_grad_()
        b, t, e = x.shape
        q, k, v = (a.reshape(b, t, heads, e // heads).transpose(1, 2)
                   for a in (x64 @ w64.t()).chunk(3, dim=-1))
        scores = q @ k.transpose(-1, -2)
        if m is not None:
            scores = scores.masked_fill(~m[:, None, None, :], qa.MASK_FILL)
        att = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, t, e)
        return torch.autograd.grad(att @ wu.double().t(), (x64, w64), g.double())


def _near_equal_errors(shape, seed):
    """{dx, dwqkv: (kernel's, plain version's max|x - float64| / max|float64|)}
    of the float32 backward on inputs whose positions are nearly equal, as in
    a deep encoder layer: there dP - D cancels, and an error of D = rowsum(P o
    dP) comes through whole."""
    b, t, e, h = shape
    x, m, wqkv, wu, _, g = _inputs(seed, b, t, e, "float32", "cuda")
    rng = np.random.default_rng(seed + 1)
    x0 = rng.normal(size=(b, 1, e)) + 0.1 * rng.normal(size=(b, t, e))
    x = torch.from_numpy(x0.astype(np.float32)).cuda()
    ref = _f64_grads(x, m, wqkv, wu, g, h)
    kern = qa.fused_qkv_attention_bwd(x, m, wqkv, wu, g, h)
    plain = qa.fused_qkv_attention_bwd_plain(x, m, wqkv, wu, g, h)
    out = {}
    for i, name in enumerate(("dx", "dwqkv")):
        top = float(ref[i].abs().max())
        out[name] = tuple(float((a[i].double() - ref[i]).abs().max()) / top
                          for a in (kern, plain))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 200, 64, 8), (64, 220, 32, 2)])
def test_float32_backward_as_accurate_as_plain_on_near_equal_values(shape):
    """The CUDA-core backward (float32) must keep dx and dWqkv within 2x the
    plain float32 version's distance to float64 (plus 1e-7 of the largest
    value) where a row's positions are nearly equal: a running float32 sum
    of D over 200 keys, whose error grows with the key count, put it
    farther (ROADMAP section 3a; chip_smoke.py phase grad-probe)."""
    _needs_cuda()
    for name, (err, plain_err) in _near_equal_errors(shape, 40).items():
        assert err <= 2 * plain_err + 1e-7, (
            f"{name}: kernel {err:.3e}, plain {plain_err:.3e} from float64")


@pytest.mark.gpu
def test_mma_entry_raises_on_x_off_16_bytes():
    """No fallback: the tensor-core entry refuses an x it cannot copy 16 bytes
    at a time, and the wrapper raises."""
    _needs_cuda()
    x, m, wqkv, wu, bu, _ = _inputs(7, 2, 16, 32, "bfloat16", "cuda")
    off = torch.zeros(x.numel() + 1, dtype=x.dtype, device="cuda")[1:].view(x.shape).copy_(x)
    before = _counts()
    with pytest.raises(RuntimeError, match="fused_qkv_fwd_mma launch failed"):
        qa._qkv_fwd(off, m, wqkv, wu, bu, 2)
    assert _counts() == before


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
    before = _counts()
    leaves = [a.clone().requires_grad_() for a in (x, wq, wk, wv, wu, bu)]
    out = qa.fused_qkv_attention(leaves[0], m, *leaves[1:], heads=h, emb=e)
    torch.testing.assert_close(out, qa.fused_qkv_attention_plain(x, m, wqkv, wu, bu, h),
                               rtol=1e-5, atol=1e-5)
    out.backward(g)
    dx, dwqkv, dwu, dbu = qa.fused_qkv_attention_bwd_plain(x, m, wqkv, wu, g, h)
    want = (dx, dwqkv[:e] * scale, dwqkv[e:2 * e] * scale, dwqkv[2 * e:], dwu, dbu)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=1e-4, atol=1e-4)
    assert _counts() == before


@pytest.mark.parametrize("e,h", [(64, 8), (32, 2)])
def test_cpu_bf16_takes_the_plain_versions_on_the_mma_route(e, h):
    """A bfloat16 call at head dim 8 or 16 routes to the tensor cores on the
    card; on the CPU it takes the plain versions and bumps no counter."""
    x, m, wqkv, wu, bu, g = _inputs(8, 2, 19, e, "bfloat16", mask="masked_sample")
    assert qa._route(x.dtype, e // h) == "mma"
    scale = e ** -0.25
    wq, wk, wv = wqkv[:e] / scale, wqkv[e:2 * e] / scale, wqkv[2 * e:]
    packed = torch.cat([wq * scale, wk * scale, wv])  # as the wrapper packs them
    before = _counts()
    leaves = [a.clone().requires_grad_() for a in (x, wq, wk, wv, wu, bu)]
    out = qa.fused_qkv_attention(leaves[0], m, *leaves[1:], heads=h, emb=e)
    assert torch.equal(out, qa.fused_qkv_attention_plain(x, m, packed, wu, bu, h))
    out.backward(g)
    dx = qa.fused_qkv_attention_bwd_plain(x, m, packed, wu, g, h)[0]
    assert torch.equal(leaves[0].grad, dx)
    assert _counts() == before


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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
@pytest.mark.parametrize("s", [4, 8, 16, 32])
def test_route(dtype, s):
    """The tensor cores take bfloat16 at head dim 8 or 16; the CUDA cores
    take the rest (float32; no other dtype or head dim passes _check)."""
    want = "mma" if dtype == "bfloat16" and s in (8, 16) else "simt"
    assert qa._route(getattr(torch, dtype), s) == want


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int}


@pytest.mark.parametrize("name", sorted(qa._ARGTYPES))
def test_ctypes_signature_matches_the_c_entry(name):
    """The wrapper's ctypes argument types are the C entry point's, one for
    one (ctypes would silently cut a pointer passed as an int)."""
    src = (CSRC_DIR / f"{name}.cu").read_text()
    sig = re.search(rf'extern "C" int mmsn_{name}\((.*?)\)\s*\{{', src, re.S)
    assert sig, f"no entry mmsn_{name} in csrc/{name}.cu"
    params = [" ".join(p.split()[:-1]).replace(" *", "*") for p in sig.group(1).split(",")]
    assert [_CTYPES[p] for p in params] == list(qa._ARGTYPES[name])


def test_library_path_keys_on_the_qkv_mma_header(monkeypatch, tmp_path):
    """An edit of csrc/fused_qkv_mma.cuh rebuilds both tensor-core kernels,
    each into a library of its own."""
    for f in CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build_mod, "CSRC_DIR", tmp_path)
    names = ("fused_qkv_fwd_mma", "fused_qkv_bwd_mma")
    before = [library_path(n) for n in names]
    assert before[0] != before[1]
    assert before[0].name.startswith("libfused_qkv_fwd_mma-")
    header = tmp_path / "fused_qkv_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [library_path(n) for n in names]
    assert all(a != b for a, b in zip(before, after))


@pytest.mark.gpu
@pytest.mark.parametrize("route,dtype", [("simt", "float32"), ("mma", "bfloat16"),
                                         ("simt", "bfloat16")])
@pytest.mark.parametrize("shape,mask", [((16, 200, 64, 8), "masked_sample"),
                                        ((16, 220, 32, 2), "random"), ((8, 37, 32, 2), "none")])
def test_stacked_members_bitwise_their_own_calls(monkeypatch, route, dtype, shape, mask):
    """Three stacked members (the wrappers given members = 3), each with its
    own x, mask and weights: one launch each way, and every output and
    gradient bitwise each member's own call on the same route."""
    _needs_cuda()
    b, t, e, h = shape
    _on_route(monkeypatch, route, dtype, e // h)
    members = [_inputs(30 + i, b, t, e, dtype, "cuda", mask) for i in range(3)]
    x, m, wqkv, wu, bu, g = (None if members[0][k] is None else
                             torch.stack([a[k] for a in members]) for k in range(6))
    before = _counts()
    out = qa._qkv_fwd(x, m, wqkv, wu, bu, h, 3)
    grads = qa.fused_qkv_attention_bwd(x, m, wqkv, wu, g, h, 3)
    torch.cuda.synchronize()
    mma = route == "mma"
    assert _counts() == (before[0] + 1, before[1] + mma, before[2] + 1, before[3] + mma)
    for i, (xi, mi, wi, ui, bi, gi) in enumerate(members):
        assert torch.equal(out[i], qa._qkv_fwd(xi, mi, wi, ui, bi, h))
        for got, want in zip(grads, qa.fused_qkv_attention_bwd(xi, mi, wi, ui, gi, h)):
            assert torch.equal(got[i], want)
