"""The fused-block CUDA kernels and their wrappers, without jax.

The ``gpu`` tests hold the kernels against their plain versions on the card
and skip without one: the forward at atol = rtol = 1e-4 in float32 (another
summation order) and 0.05 in bfloat16; every backward output within 5e-4 of
that output's largest in float32 (the weight gradients are sums over N rows,
taken in another order than the plain version's matrix products) and 0.05
of it in bfloat16. The float32 forward of either route (the 3xTF32 tensor
cores as routed, the CUDA cores through a patch of ``_route``) is also held
to ||got - want|| / ||want|| <= FP32_NORM_TOL, which the plain version with
TF32 matmuls must fail. The rest run on the CPU: a model of the 3xTF32
arithmetic (``cvt.rna.tf32`` on the int32 view) that puts FP32_NORM_TOL
between the 3xTF32 and the 1xTF32 errors, the routing rule, the
shared-memory formulas, the C entry points' signatures, the build key, and
the wrappers' dispatch and argument validation. This file imports no jax, so
the GPU host runs it with ``--noconftest`` (README, "PyTorch port").
"""

import ctypes
import importlib
import re

import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu_torch.kernels import library_path
from multimodal_supernovae_tpu_torch.kernels.build import CSRC_DIR
from multimodal_supernovae_tpu_torch.ops import fused_block as fb

# the module, not the ``build`` function that kernels/__init__ re-exports
build_mod = importlib.import_module("multimodal_supernovae_tpu_torch.kernels.build")

TOL = {"float32": 1e-4, "bfloat16": 0.05}
GRAD_TOL = {"float32": 5e-4, "bfloat16": 0.05}
# float32 forward against the plain version: ||got - want|| / ||want||. As
# chip_smoke.py's; between the 3xTF32 and 1xTF32 readings of
# test_tf32x3_model_holds_the_block_to_float32.
FP32_NORM_TOL = 1e-5


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


def _norm_err(got, want):
    """||got - want|| / ||want|| in float64."""
    want = want.double().flatten()
    return float(torch.linalg.vector_norm(got.double().flatten() - want)
                 / torch.linalg.vector_norm(want))


def _tf32(a):
    """cvt.rna.tf32.f32 on the int32 view: round to 10 mantissa bits, to
    nearest with ties away from zero (the sign bit is apart from the
    magnitude), the 13 low bits cleared."""
    i = a.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _split(a):
    """(hi, lo), each a TF32 value, as csrc/fused_ffn_mma.cuh:split_tf32."""
    hi = _tf32(a)
    return hi, _tf32(a.float() - hi)


def _mm_tf32(passes):
    """A stand-in for fused_block._mm (float32 only) on the tensor cores'
    arithmetic: TF32 operands, products exact (float64 here), one float32
    rounding of the sum; 3 passes (lo.hi + hi.lo + hi.hi) or 1 (hi.hi)."""
    def mm(a, w, cdt):
        assert cdt == torch.float32
        (ah, al), (wh, wl) = _split(a), _split(w)

        def prod(u, v):
            return u.double() @ v.double().t()

        out = prod(ah, wh) if passes == 1 else prod(al, wh) + prod(ah, wl) + prod(ah, wh)
        return out.float()
    return mm


def test_tf32_emulation_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # of TF32 at 1.0
    vals = torch.tensor([1.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                         1 + 1.5 * ulp, 3.0e-3, -7.25], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp], dtype=torch.float32)
    got = _tf32(vals)
    torch.testing.assert_close(got[:5], want, rtol=0, atol=0)
    assert float((got[5] - 3.0e-3).abs()) <= 2.0 ** -11 * 3.0e-3 and float(got[6]) == -7.25
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())


def test_split_keeps_22_bits():
    """x - (hi + lo) is within 2^-22 |x| (x - hi is exact in float32)."""
    x = torch.from_numpy(np.random.default_rng(6).normal(size=4096).astype(np.float32))
    hi, lo = _split(x)
    assert bool(((x.double() - hi.double() - lo.double()).abs()
                 <= 2.0 ** -22 * x.double().abs()).all())
    assert bool((x - hi == (x.double() - hi.double()).float()).all())


def test_tf32x3_model_holds_the_block_to_float32(monkeypatch):
    """fused_ffn_block_plain with its three products in the kernel's 3xTF32
    arithmetic stays within FP32_NORM_TOL of the float32 plain version at the
    light-curve widths; with one TF32 product it does not."""
    att, x, params, _ = _inputs(5, 400, 64, 256, "float32")
    want = fb.fused_ffn_block_plain(att, x, *params)
    errs = {}
    for passes in (3, 1):
        monkeypatch.setattr(fb, "_mm", _mm_tf32(passes))
        errs[passes] = _norm_err(fb.fused_ffn_block_plain(att, x, *params), want)
    assert errs[3] <= FP32_NORM_TOL < errs[1], (
        f"||err|| / ||plain||: 3xTF32 {errs[3]:.3e}, 1xTF32 {errs[1]:.3e} "
        f"(FP32_NORM_TOL {FP32_NORM_TOL})")


@pytest.mark.parametrize("e,f,want", [(64, 256, "mma"), (128, 512, "mma"), (96, 384, "mma"),
                                      (64, 128, "mma"), (32, 128, "simt"), (160, 640, "simt"),
                                      (64, 96, "simt")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route(dtype, e, f, want):
    """The tensor cores take float32 at E 64, 96 or 128 and F a multiple of
    64; the CUDA cores take the rest, bfloat16 always."""
    assert fb._route(getattr(torch, dtype), e, f) == (want if dtype == "float32" else "simt")


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float}


@pytest.mark.parametrize("name", sorted(fb._ARGTYPES))
def test_ctypes_signature_matches_the_c_entry(name):
    """The wrapper's ctypes argument types are the C entry point's, one for
    one (ctypes would silently cut a pointer passed as an int)."""
    src = (CSRC_DIR / f"{name}.cu").read_text()
    sig = re.search(rf'extern "C" int mmsn_{name}\((.*?)\)\s*\{{', src, re.S)
    assert sig, f"no entry mmsn_{name} in csrc/{name}.cu"
    params = [" ".join(p.split()[:-1]).replace(" *", "*") for p in sig.group(1).split(",")]
    assert [_CTYPES[p] for p in params] == list(fb._ARGTYPES[name])


def test_library_path_keys_on_the_ffn_mma_header(monkeypatch, tmp_path):
    """An edit of csrc/fused_ffn_mma.cuh rebuilds the tensor-core forward."""
    for f in CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build_mod, "CSRC_DIR", tmp_path)
    before = library_path("fused_ffn_fwd_mma")
    assert before.name.startswith("libfused_ffn_fwd_mma-")
    header = tmp_path / "fused_ffn_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert library_path("fused_ffn_fwd_mma") != before


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
@pytest.mark.parametrize("route", ["mma", "simt"])
@pytest.mark.parametrize("n,e,f", CASES)
def test_float32_forward_routes_match_plain_in_the_norm(route, n, e, f, monkeypatch):
    """Both float32 routes within 1e-4 and FP32_NORM_TOL, each counted on its
    own route."""
    _needs_cuda()
    if route == "simt":
        monkeypatch.setattr(fb, "_route", lambda *a: "simt")
    assert fb._route(torch.float32, e, f) == route
    att, x, params, _ = _inputs(0, n, e, f, "float32", "cuda")
    before = (fb.fused_ffn_block.launches, fb.fused_ffn_block.mma_launches)
    got = fb.fused_ffn_block(att, x, *params)
    torch.cuda.synchronize()
    assert (fb.fused_ffn_block.launches, fb.fused_ffn_block.mma_launches) == (
        before[0] + 1, before[1] + (route == "mma"))
    want = fb.fused_ffn_block_plain(att, x, *params)
    torch.testing.assert_close(got, want, rtol=TOL["float32"], atol=TOL["float32"])
    err = _norm_err(got, want)
    assert err <= FP32_NORM_TOL, f"{route}: ||err|| / ||plain|| {err:.3e}"


@pytest.mark.gpu
def test_tf32_plain_version_fails_the_norm_check():
    """The control: the plain version with TF32 matmuls reads above
    FP32_NORM_TOL, so the check sees TF32 rounding."""
    _needs_cuda()
    att, x, params, _ = _inputs(0, 51200, 64, 256, "float32", "cuda")
    want = fb.fused_ffn_block_plain(att, x, *params)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = fb.fused_ffn_block_plain(att, x, *params)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert _norm_err(tf32, want) > FP32_NORM_TOL


@pytest.mark.gpu
def test_routed_float32_never_reaches_the_cuda_core_entry(monkeypatch):
    _needs_cuda()

    def refuse(*args):
        raise AssertionError("the CUDA-core forward was called on the tensor-core route")

    monkeypatch.setitem(fb._bound, "fused_ffn_fwd", refuse)
    att, x, params, _ = _inputs(7, 1000, 64, 256, "float32", "cuda")
    got = fb.fused_ffn_block(att, x, *params)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fb.fused_ffn_block_plain(att, x, *params),
                               rtol=TOL["float32"], atol=TOL["float32"])


@pytest.mark.gpu
def test_mma_entry_raises_on_x_off_16_bytes():
    _needs_cuda()
    att, x, params, _ = _inputs(8, 100, 64, 256, "float32", "cuda")
    buf = torch.empty(100 * 64 + 1, device="cuda")
    x_off = buf[1:].view(100, 64)
    x_off.copy_(x)
    before = fb.fused_ffn_block.launches
    with pytest.raises(RuntimeError, match="16 bytes"):
        fb.fused_ffn_block(att, x_off, *params)
    assert fb.fused_ffn_block.launches == before


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
    # the tensor-core forward: 64 (E + 4) + 64 (64 + 4) + max(2E (E + 4),
    # 2 * 64 (E + 4) + 2E (64 + 4)) floats, as its source states them
    assert fb._mma_smem_bytes(64) == 4 * (64 * 68 + 64 * 68 + 2 * 64 * 68 + 2 * 64 * 68)
    assert fb._mma_smem_bytes(128) == 4 * (64 * 132 + 64 * 68 + 2 * 64 * 132 + 2 * 128 * 68)
    src = (CSRC_DIR / "fused_ffn_fwd_mma.cu").read_text()
    for e in (64, 128):
        assert f"{fb._mma_smem_bytes(e):,} " in src
    assert 2 * (fb._mma_smem_bytes(64) + 1024) <= 233472  # two blocks an SM at E = 64
    assert max(fb._mma_smem_bytes(e) for e in fb.MMA_WIDTHS) <= fb.SMEM_LIMIT
