"""The fused-block CUDA kernels and their wrappers, without jax.

The ``gpu`` tests hold the kernels against their plain versions on the card
and skip without one: the forward at atol = rtol = 1e-4 in float32 (another
summation order) and 0.05 in bfloat16; every backward output within 5e-4 of
that output's largest in float32 (the weight gradients are sums over N rows,
taken in another order than the plain version's matrix products) and 0.05
of it in bfloat16. The float32 forward and backward of either route (the
3xTF32 tensor cores as routed, the CUDA cores through a patch of
``_route``) are also held to ||got - want|| / ||want|| <= FP32_NORM_TOL
(every backward output but db2, which takes no product), which the plain
version with TF32 matmuls must fail. Every row counts. The tensor-core
backward is held to the plain version on the kernel's own ReLU mask (its h
scratch > 0, ``relu_mask``): where a pre-activation lies within rounding of
0, the kernel and the plain version may take the mask's two sides, and one
such entry moves a whole dh value; its h is held to the plain h as the
forward is. The CUDA-core route is held to the plain version as it is. The
rest run on the CPU: a model of
the 3xTF32 arithmetic (``cvt.rna.tf32`` on the int32 view) that puts
FP32_NORM_TOL between the 3xTF32 and the 1xTF32 errors of the forward and
the backward, the routing rule, the shared-memory formulas, the C entry
points' signatures, the build keys, and the wrappers' dispatch and argument
validation. This file imports no jax, so the GPU host runs it with
``--noconftest`` (README, "PyTorch port").
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
    """(hi, lo), each a TF32 value, as csrc/tf32x3.cuh:split_tf32."""
    hi = _tf32(a)
    return hi, _tf32(a.float() - hi)


def _kernel_mask(monkeypatch):
    """Spy on fused_block._bwd_mma: the dict returned gets the h scratch of
    each tensor-core backward (``"h"``) and its ReLU mask, h > 0
    (``"mask"``). A CUDA-core backward leaves it empty, and
    ``seen.get("mask")`` is then None: the plain version's own mask."""
    seen, real = {}, fb._bwd_mma

    def spy(*args):
        out = real(*args)
        seen["h"], seen["mask"] = out[3], out[3] > 0
        return out

    monkeypatch.setattr(fb, "_bwd_mma", spy)
    return seen


def _mmf_tf32(passes):
    """A stand-in for fused_block._mmf (a @ b, float32) on the tensor cores'
    arithmetic: TF32 operands, products exact (float64 here), one float32
    rounding of the sum; 3 passes (lo.hi + hi.lo + hi.hi) or 1 (hi.hi)."""
    def mmf(a, b):
        (ah, al), (bh, bl) = _split(a), _split(b)

        def prod(u, v):
            return u.double() @ v.double()

        out = prod(ah, bh) if passes == 1 else prod(al, bh) + prod(ah, bl) + prod(ah, bh)
        return out.float()
    return mmf


def _mm_tf32(passes):
    """A stand-in for fused_block._mm (a @ w^T, float32 only) on the same
    arithmetic as _mmf_tf32."""
    def mm(a, w, cdt):
        assert cdt == torch.float32
        return _mmf_tf32(passes)(a, w.t())
    return mm


# what the backward returns, in order (weight gradients in the (out, in) layout)
BWD_NAMES = ("datt", "dx", "dwu", "dbu", "dg1", "db1", "dwf1", "dbf1", "dwf2", "dbf2",
             "dg2", "db2")


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


def test_tf32x3_model_holds_the_backward_to_float32(monkeypatch):
    """fused_ffn_block_bwd_plain with its nine products (the recompute's
    three, the backward's six) in the kernel's 3xTF32 arithmetic stays within
    FP32_NORM_TOL of the float32 plain version in every output but db2 (no
    product); with one TF32 product datt, dx, dWu and dWf1 do not. Every
    row counts: the float32 version takes the model's own ReLU mask, as the
    card's checks take the kernel's. On one mask, one TF32 product reads
    about 3e-4 here, as in the forward; a mask of its own would add its
    flips."""
    att, x, params, g = _inputs(9, 2048, 64, 256, "float32")
    errs = {}
    for passes in (3, 1):
        monkeypatch.setattr(fb, "_mm", _mm_tf32(passes))
        monkeypatch.setattr(fb, "_mmf", _mmf_tf32(passes))
        mask = fb._forward_rows(att, x, *params, fb.LN_EPS)[1][4] > 0  # the model's h > 0
        got = fb.fused_ffn_block_bwd_plain(att, x, *params, g)
        monkeypatch.undo()
        want = fb.fused_ffn_block_bwd_plain(att, x, *params, g, relu_mask=mask)
        errs[passes] = {k: _norm_err(a, w) for k, a, w in zip(BWD_NAMES, got, want)}
        print(f"{passes}xTF32 ||err|| / ||plain||:",
              " ".join(f"{k} {v:.2e}" for k, v in errs[passes].items()))  # shown by -rP
    worst3 = max(v for k, v in errs[3].items() if k != "db2")
    assert worst3 <= FP32_NORM_TOL, errs[3]
    for k in ("datt", "dx", "dwu", "dwf1"):
        assert errs[1][k] > FP32_NORM_TOL, (k, errs[1][k])


def test_plain_backward_takes_a_given_relu_mask():
    """relu_mask replaces pre-activation > 0 and nothing else: its own mask
    gives the plain version's gradients exactly; one entry flipped moves
    that entry's dh, (dr2 . Wf2)[i, j], into dbf1 and changes no other row's
    dx or datt."""
    att, x, params, g = _inputs(10, 256, 64, 256, "float32")
    want = fb.fused_ffn_block_bwd_plain(att, x, *params, g)
    _, (xhat1, rstd1, y1, pre_h, h, xhat2, rstd2) = fb._forward_rows(
        att, x, *params, fb.LN_EPS)
    for a, w in zip(fb.fused_ffn_block_bwd_plain(att, x, *params, g, relu_mask=pre_h > 0),
                    want):
        assert torch.equal(a, w)
    i, j = 7, int(pre_h[7].abs().argmin())
    mask = pre_h > 0
    mask[i, j] = ~mask[i, j]
    got = fb.fused_ffn_block_bwd_plain(att, x, *params, g, relu_mask=mask)
    dr2 = fb._ln_bwd_rows(g, xhat2, rstd2, params[8])[0]
    moved = float(dr2[i] @ params[6][:, j]) * (1 if mask[i, j] else -1)
    dbf1 = BWD_NAMES.index("dbf1")
    assert float(got[dbf1][j] - want[dbf1][j]) == pytest.approx(moved, rel=1e-3, abs=1e-6)
    rest = torch.arange(len(x)) != i
    for k in (0, 1):  # datt, dx: row-local
        assert torch.equal(got[k][rest], want[k][rest])
        assert not torch.equal(got[k][i], want[k][i])


@pytest.mark.parametrize("e,f,want", [(64, 256, "mma"), (128, 512, "mma"), (96, 384, "mma"),
                                      (64, 128, "mma"), (32, 128, "simt"), (160, 640, "simt"),
                                      (64, 96, "simt")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route(dtype, e, f, want):
    """The tensor cores take float32 at E 64, 96 or 128 and F a multiple of
    64; the CUDA cores take the rest, bfloat16 always."""
    assert fb._route(getattr(torch, dtype), e, f) == (want if dtype == "float32" else "simt")


@pytest.mark.parametrize("e,f,want", [(64, 256, "mma"), (128, 512, "mma"), (96, 384, "mma"),
                                      (64, 128, "mma"), (128, 1152, "mma"), (128, 1216, "simt"),
                                      (32, 128, "simt"), (160, 640, "simt"), (64, 96, "simt")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_needs_both_kernels_to_fit(dtype, e, f, want):
    """One route for the forward and the backward: float32 at E 64, 96 or
    128 and F a multiple of 64 where both kernels fit one block's shared
    memory (the backward's row kernel is the larger: at E = 128 not past F
    = 1152); bfloat16 always on the CUDA cores."""
    assert fb._route(getattr(torch, dtype), e, f) == (
        want if dtype == "float32" else "simt")


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
    """An edit of csrc/tf32x3.cuh rebuilds the tensor-core forward."""
    for f in CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build_mod, "CSRC_DIR", tmp_path)
    before = library_path("fused_ffn_fwd_mma")
    assert before.name.startswith("libfused_ffn_fwd_mma-")
    header = tmp_path / "tf32x3.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert library_path("fused_ffn_fwd_mma") != before


@pytest.mark.parametrize("name", ["fused_ffn_bwd", "fused_ffn_bwd_mma", "fused_qkv_bwd",
                                  "fused_qkv_bwd_mma"])
def test_library_path_keys_on_the_reduce_header(name, monkeypatch, tmp_path):
    """An edit of csrc/reduce_partials.cuh, the one reduce kernel, rebuilds
    every backward that includes it."""
    for f in CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build_mod, "CSRC_DIR", tmp_path)
    assert '#include "reduce_partials.cuh"' in (tmp_path / f"{name}.cu").read_text()
    before = library_path(name)
    header = tmp_path / "reduce_partials.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert library_path(name) != before


def test_one_reduce_kernel():
    """reduce_partials is defined once, in csrc/reduce_partials.cuh."""
    defined = [f.name for f in sorted(CSRC_DIR.iterdir())
               if re.search(r"__global__ void reduce_\w*partials", f.read_text())]
    assert defined == ["reduce_partials.cuh"]


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
def test_backward_kernel_matches_plain(dtype, n, e, f, monkeypatch):
    """Each output within GRAD_TOL of its largest, every row; the
    tensor-core route (float32) against the plain version on its own ReLU
    mask (_kernel_mask)."""
    _needs_cuda()
    att, x, params, g = _inputs(1, n, e, f, dtype, "cuda")
    seen = _kernel_mask(monkeypatch)
    before = fb.fused_ffn_block_bwd.launches
    got = fb.fused_ffn_block_bwd(att, x, *params, g)
    torch.cuda.synchronize()
    assert fb.fused_ffn_block_bwd.launches == before + 1
    assert ("mask" in seen) == (dtype == "float32")
    want = fb.fused_ffn_block_bwd_plain(att, x, *params, g, relu_mask=seen.get("mask"))
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape and a.dtype == w.dtype, i
        err = float((a.float() - w.float()).abs().max())
        assert err <= GRAD_TOL[dtype] * float(w.float().abs().max()), (i, err)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["mma", "simt"])
@pytest.mark.parametrize("n,e,f", CASES)
def test_float32_backward_routes_match_plain_in_the_norm(route, n, e, f, monkeypatch):
    """Both float32 backward routes, every row: every output within
    GRAD_TOL of its largest and, but db2, within FP32_NORM_TOL in the
    normalised error; the tensor cores against the plain version on their
    own ReLU mask, the CUDA cores against it as it is; each call counted on
    its own route."""
    _needs_cuda()
    if route == "simt":
        monkeypatch.setattr(fb, "_route", lambda *a: "simt")
    assert fb._route(torch.float32, e, f) == route
    att, x, params, g = _inputs(11, n, e, f, "float32", "cuda")
    seen = _kernel_mask(monkeypatch)
    before = (fb.fused_ffn_block_bwd.launches, fb.fused_ffn_block_bwd.mma_launches)
    got = fb.fused_ffn_block_bwd(att, x, *params, g)
    torch.cuda.synchronize()
    assert (fb.fused_ffn_block_bwd.launches, fb.fused_ffn_block_bwd.mma_launches) == (
        before[0] + 1, before[1] + (route == "mma"))
    assert ("mask" in seen) == (route == "mma")
    want = fb.fused_ffn_block_bwd_plain(att, x, *params, g, relu_mask=seen.get("mask"))
    for name, a, w in zip(BWD_NAMES, got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        err = float((a - w).abs().max())
        assert err <= GRAD_TOL["float32"] * float(w.abs().max()), (route, name, err)
        if name != "db2":
            ne = _norm_err(a, w)
            assert ne <= FP32_NORM_TOL, f"{route} {name}: ||err|| / ||plain|| {ne:.3e}"


@pytest.mark.gpu
def test_tf32_plain_backward_fails_the_norm_check():
    """The control: the plain backward with TF32 matmuls reads above
    FP32_NORM_TOL in datt, dx, dWu and dWf1, against the float32 plain
    version on the same (TF32) ReLU mask, as the kernel is checked."""
    _needs_cuda()
    att, x, params, g = _inputs(0, 51200, 64, 256, "float32", "cuda")
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        mask = fb._forward_rows(att, x, *params, fb.LN_EPS)[1][4] > 0
        tf32 = fb.fused_ffn_block_bwd_plain(att, x, *params, g, relu_mask=mask)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    want = fb.fused_ffn_block_bwd_plain(att, x, *params, g, relu_mask=mask)
    errs = {k: _norm_err(a, w) for k, a, w in zip(BWD_NAMES, tf32, want)}
    assert all(errs[k] > FP32_NORM_TOL for k in ("datt", "dx", "dwu", "dwf1")), errs


@pytest.mark.gpu
def test_routed_float32_backward_never_reaches_the_cuda_core_entry(monkeypatch):
    _needs_cuda()

    def refuse(*args):
        raise AssertionError("the CUDA-core backward was called on the tensor-core route")

    monkeypatch.setitem(fb._bound, "fused_ffn_bwd", refuse)
    att, x, params, g = _inputs(12, 1000, 64, 256, "float32", "cuda")
    seen = _kernel_mask(monkeypatch)
    got = fb.fused_ffn_block_bwd(att, x, *params, g)
    torch.cuda.synchronize()
    want = fb.fused_ffn_block_bwd_plain(att, x, *params, g, relu_mask=seen["mask"])
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= GRAD_TOL["float32"] * float(w.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n,e,f", CASES)
def test_mma_backward_h_matches_the_plain_forward(n, e, f, monkeypatch):
    """The tensor-core backward's recomputed h (its scratch, whose > 0 is
    the mask the other checks hand the plain version) within the forward's
    float32 tolerance of the plain h: so its mask differs from the plain
    one only where the plain pre-activation is within that of 0."""
    _needs_cuda()
    att, x, params, g = _inputs(15, n, e, f, "float32", "cuda")
    seen = _kernel_mask(monkeypatch)
    fb.fused_ffn_block_bwd(att, x, *params, g)
    torch.cuda.synchronize()
    pre_h, h = fb._forward_rows(att, x, *params, fb.LN_EPS)[1][3:5]
    torch.testing.assert_close(seen["h"], h, rtol=TOL["float32"], atol=TOL["float32"])
    flips = seen["mask"] != (pre_h > 0)
    assert int(flips.sum()) < 1e-4 * flips.numel()


@pytest.mark.gpu
def test_mma_backward_entry_raises_on_x_off_16_bytes():
    _needs_cuda()
    att, x, params, g = _inputs(13, 100, 64, 256, "float32", "cuda")
    buf = torch.empty(100 * 64 + 1, device="cuda")
    x_off = buf[1:].view(100, 64)
    x_off.copy_(x)
    before = (fb.fused_ffn_block_bwd.launches, fb.fused_ffn_block_bwd.mma_launches)
    with pytest.raises(RuntimeError, match="16 bytes"):
        fb.fused_ffn_block_bwd(att, x_off, *params, g)
    assert (fb.fused_ffn_block_bwd.launches, fb.fused_ffn_block_bwd.mma_launches) == before


@pytest.mark.gpu
def test_bfloat16_backward_stays_on_the_cuda_cores(monkeypatch):
    _needs_cuda()

    def refuse(*args):
        raise AssertionError("the tensor-core backward was called for bfloat16")

    monkeypatch.setitem(fb._bound, "fused_ffn_bwd_mma", refuse)
    att, x, params, g = _inputs(14, 1000, 64, 256, "bfloat16", "cuda")
    before = (fb.fused_ffn_block_bwd.launches, fb.fused_ffn_block_bwd.mma_launches)
    fb.fused_ffn_block_bwd(att, x, *params, g)
    torch.cuda.synchronize()
    assert (fb.fused_ffn_block_bwd.launches, fb.fused_ffn_block_bwd.mma_launches) == (
        before[0] + 1, before[1])


@pytest.mark.gpu
def test_autograd_function_launches_both_kernels(monkeypatch):
    _needs_cuda()
    att, x, params, g = _inputs(2, 1000, 64, 256, "float32", "cuda")
    seen = _kernel_mask(monkeypatch)
    leaves = [a.clone().requires_grad_() for a in [att, x] + params]
    f0, b0 = fb.fused_ffn_block.launches, fb.fused_ffn_block_bwd.launches
    m0 = fb.fused_ffn_block_bwd.mma_launches
    fb.fused_ffn_block(*leaves).backward(g)
    assert (fb.fused_ffn_block.launches, fb.fused_ffn_block_bwd.launches) == (f0 + 1, b0 + 1)
    assert fb.fused_ffn_block_bwd.mma_launches == m0 + 1
    want = fb.fused_ffn_block_bwd_plain(att, x, *params, g, relu_mask=seen["mask"])
    for leaf, w in zip(leaves, want):
        assert float((leaf.grad - w).abs().max()) <= 5e-4 * float(w.abs().max())


def test_cpu_takes_the_plain_versions_and_counts_nothing():
    att, x, params, g = _inputs(3, 40, 64, 256, "float32")
    counters = (fb.fused_ffn_block, fb.fused_ffn_block_bwd)
    before = [(c.launches, c.mma_launches) for c in counters]
    leaves = [a.clone().requires_grad_() for a in [att, x] + params]
    out = fb.fused_ffn_block(*leaves)
    torch.testing.assert_close(out, fb.fused_ffn_block_plain(att, x, *params))
    out.backward(g)
    for leaf, w in zip(leaves, fb.fused_ffn_block_bwd_plain(att, x, *params, g)):
        torch.testing.assert_close(leaf.grad, w)
    assert [(c.launches, c.mma_launches) for c in counters] == before


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


def test_bwd_mma_smem_formula_matches_the_source():
    """The tensor-core backward's row kernel: 64 (E + 4) + 64 (32 + 4) +
    64 E + 2 max(E (E + 8), 32 (E + 4) + E (32 + 4), E (32 + 8) + 32 (E + 8))
    + 16 E floats and 8 F bytes, as csrc/fused_ffn_bwd_mma.cu states them;
    two blocks an SM at the light-curve widths, one at E = 128."""
    def floats(e):
        return (64 * (e + 4) + 64 * 36 + 64 * e
                + 2 * max(e * (e + 8), 32 * (e + 4) + e * 36, e * 40 + 32 * (e + 8)) + 16 * e)

    for e, f in ((64, 256), (96, 384), (128, 512)):
        assert fb._bwd_mma_smem_bytes(e, f) == 4 * floats(e) + 8 * f
    src = (CSRC_DIR / "fused_ffn_bwd_mma.cu").read_text()
    for e, f in ((64, 256), (128, 512)):
        assert f"{fb._bwd_mma_smem_bytes(e, f):,} " in src
    assert 2 * (fb._bwd_mma_smem_bytes(64, 256) + 1024) <= fb.SM_SMEM
    assert 2 * (fb._bwd_mma_smem_bytes(128, 512) + 1024) > fb.SM_SMEM
    assert fb._bwd_mma_smem_bytes(128, 512) <= fb.SMEM_LIMIT
