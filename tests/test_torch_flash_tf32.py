"""The float32 flash-attention route on the 3xTF32 tensor cores, on the CPU.

The kernels (``csrc/flash_attention_{fwd,bwd}_tf32.cu``) run only on the
card (``tests/test_torch_flash_kernel.py``, ``chip_smoke.py``). Here a numpy
model of their arithmetic is held to the JAX package: TF32 halves by
``cvt.rna`` on the int32 view, each product three m16n8k8 passes (lo . hi,
hi . lo, hi . hi, exact products, each pass of each 8-wide step rounded to
float32 and the three summed as hi . hi + (lo . hi + hi . lo), each step
added to a float32 sum), the forward over 64-key tiles with the online
rescale in the log2 domain, the backward's D as c0 + rowsum(P o (dP - c0)),
c0 = dP at key 0, with dP - c0 taken as g . (v - v0). The JAX side is the
Pallas flash kernel in interpret mode where T is a multiple of 8 and no row
is fully masked, and ``dense_attention`` with ``jax.vjp`` elsewhere.
Tolerances: out within 2e-5 elementwise and FP32_NORM_TOL (1e-5) in
||got - want|| / ||want||, which a one-pass (1xTF32) model fails; dq, dk, dv
within 5e-4 (the JAX kernel tests' gradient tolerance). The lane layout of
the C-to-A key permutation is checked against the PTX fragment layouts, the
shared-memory banks of the tiles' loads and stores against the sources'
strides, and the routing rule and the build's sources, without a card.
"""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multimodal_supernovae_tpu.ops.attention import dense_attention as jax_dense
from multimodal_supernovae_tpu.ops.pallas_attention import flash_attention as jax_flash
from multimodal_supernovae_tpu_torch.kernels import library_path
from multimodal_supernovae_tpu_torch.kernels.build import CSRC_DIR
from multimodal_supernovae_tpu_torch.ops import dense_attention_bwd
from multimodal_supernovae_tpu_torch.ops.flash_attention import _ARGTYPES, _route
from tf32_model import split as _split

flash_mod = importlib.import_module("multimodal_supernovae_tpu_torch.ops.flash_attention")
build_mod = importlib.import_module("multimodal_supernovae_tpu_torch.kernels.build")
REPO = Path(__file__).resolve().parent.parent

OUT_TOL, FP32_NORM_TOL, GRAD_TOL = 2e-5, 1e-5, 5e-4
LOG2E = np.float32(1.4426950408889634)
MASK_FILL_LOG2 = np.float32(-1e7) * LOG2E
TILE = 64


# ---- the model (_split: tests/tf32_model.py) ------------------------------------

def _mma(a, b, passes=3):
    """a (..., M, K) @ b (..., K, N) as the kernels take it on mma.sync
    m16n8k8 TF32: over 8-wide steps of K (K zero-padded to a multiple of 8),
    each pass of a step from a zero accumulator, its products exact (float64
    here) and rounded to float32, the passes summed in float32 as hi . hi +
    (lo . hi + hi . lo) and the step added to the float32 result (the
    kernels' mma_rows; mma_head chains each pass over its one or two steps,
    which differs by a rounding); 3 passes or 1 (hi . hi)."""
    pad = -a.shape[-1] % 8
    if pad:
        a = np.concatenate([a, np.zeros(a.shape[:-1] + (pad,), np.float32)], -1)
        b = np.concatenate([b, np.zeros(b.shape[:-2] + (pad, b.shape[-1]), np.float32)], -2)
    (ah, al), (bh, bl) = _split(a), _split(b)
    pairs = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    c = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], 8):
        p = [(x[..., k0:k0 + 8].astype(np.float64)
              @ y[..., k0:k0 + 8, :].astype(np.float64)).astype(np.float32) for x, y in pairs]
        c = c + (p[0] if passes == 1 else p[2] + (p[0] + p[1]))
    return c


def _kinds(mask, b, t):
    """(B, T) key kinds: 0 valid, 1 masked."""
    return np.zeros((b, t), np.int8) if mask is None else np.where(mask, 0, 1).astype(np.int8)


def model_fwd(q, k, v, mask, emb, passes=3):
    """out and the (max, sum) residual of csrc/flash_attention_fwd_tf32.cu."""
    b, h, t, s = q.shape
    c = np.float32(emb ** -0.25)
    qs = (q * c) * LOG2E
    ks = k * c
    kind = _kinds(mask, b, t)
    m = np.full((b, h, t), -np.inf, np.float32)
    l = np.zeros((b, h, t), np.float32)
    o = np.zeros((b, h, t, s), np.float32)
    for j0 in range(0, t, TILE):
        kt, vt = ks[:, :, j0:j0 + TILE], v[:, :, j0:j0 + TILE]
        kd = kind[:, None, None, j0:j0 + TILE]
        sc = _mma(qs, np.swapaxes(kt, -1, -2), passes)
        sc = np.where(kd == 0, sc, MASK_FILL_LOG2).astype(np.float32)
        m_new = np.maximum(m, sc.max(-1))
        alpha = np.exp2(m - m_new)
        p = np.exp2(sc - m_new[..., None])
        l = l * alpha + p.sum(-1, dtype=np.float32)
        o = o * alpha[..., None] + _mma(p, vt, passes)
        o = o.astype(np.float32)
        m = m_new
    return (o * (np.float32(1) / l)[..., None]).astype(np.float32), m, l


def model_bwd(q, k, v, mask, g, m, l, emb, passes=3):
    """dq, dk, dv of csrc/flash_attention_bwd_tf32.cu from the forward's
    (max, sum): the dq kernel's and the dk/dv kernel's products. As there,
    selects drop the keys that are not valid, where P may overflow."""
    with np.errstate(over="ignore", invalid="ignore"):
        return _model_bwd(q, k, v, mask, g, m, l, emb, passes)


def _model_bwd(q, k, v, mask, g, m, l, emb, passes):
    b, h, t, s = q.shape
    c = np.float32(emb ** -0.25)
    qs, ks = q * c, k * c
    valid = _kinds(mask, b, t) == 0
    inv_l = np.float32(1) / l
    dv_shift = v - v[:, :, :1]  # v - v0, in float32
    # dq kernel: D - c0, then dS and dq
    sc = _mma(qs * LOG2E, np.swapaxes(ks, -1, -2), passes)
    p = np.exp2(sc - m[..., None]) * inv_l[..., None]
    dp = _mma(g, np.swapaxes(dv_shift, -1, -2), passes)  # dP - c0
    vk = valid[:, None, None, :]
    d = np.where(vk, p * dp, 0).sum(-1, dtype=np.float32)  # D - c0
    ds = np.where(vk, p * (dp - d[..., None]), 0).astype(np.float32)
    dq = _mma(ds, ks, passes) * c
    # dk/dv kernel: S^T and (dP - c0)^T, keys x queries
    st = _mma(ks * LOG2E, np.swapaxes(qs, -1, -2), passes)
    kv = valid[:, None, :, None]
    pt = np.exp2(np.where(kv, st, MASK_FILL_LOG2) - m[:, :, None, :]) * inv_l[:, :, None, :]
    pt = pt.astype(np.float32)
    dpt = _mma(dv_shift, np.swapaxes(g, -1, -2), passes)
    dst = np.where(kv, pt * (dpt - d[:, :, None, :]), 0).astype(np.float32)
    dv = _mma(pt, g, passes)
    dk = _mma(dst, qs, passes) * c
    return dq, dk, dv


# ---- the JAX reference -------------------------------------------------------

def _inputs(seed, b, h, t, s, mask):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, h, t, s)).astype(np.float32) for _ in range(4))
    m = rng.random((b, t)) > 0.3
    m[:, 0] = True
    if t > 100:
        m[0, :100] = False  # leading key tiles masked, later ones valid
    if mask == "full_row":
        m[-1] = False  # one sample with every key masked
    return q, k, v, g, m


def _jax(q, k, v, g, m, emb, flash):
    """out and (dq, dk, dv) of the JAX package's flash kernel (interpret
    mode) or of its dense_attention."""
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jm = jnp.asarray(m)
    if flash:
        def fn(a, b_, c):
            return jax_flash(a, b_, c, jm, emb)

        with pltpu.force_tpu_interpret_mode():
            out, vjp = jax.vjp(fn, jq, jk, jv)
            grads = vjp(jg)
    else:
        out, vjp = jax.vjp(lambda a, b_, c: jax_dense(a, b_, c, jm, emb), jq, jk, jv)
        grads = vjp(jg)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _norm_err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


# head dims 8 and 16 (the sequence towers) and 32 and 64 (the ViT image
# tower at 4 and 2 heads), both directions on the 3xTF32 route
CASES = [(t, s, mask) for t in (16, 77, 200) for s in (8, 16, 32, 64)
         for mask in ("ragged", "full_row")]


@pytest.mark.parametrize("t,s,mask", CASES)
def test_tf32_model_matches_the_jax_package(t, s, mask):
    b, h = 2, 2
    emb = h * s
    q, k, v, g, m = _inputs(t + s, b, h, t, s, mask)
    flash = t % 8 == 0 and mask == "ragged"  # where both mean the same (ROADMAP §3)
    want_out, want_grads = _jax(q, k, v, g, m, emb, flash)
    out, rm, rl = model_fwd(q, k, v, m, emb)
    np.testing.assert_allclose(out, want_out, rtol=OUT_TOL, atol=OUT_TOL)
    err = _norm_err(out, want_out)
    assert err <= FP32_NORM_TOL, f"out: ||model - jax|| / ||jax|| {err:.3e}"
    grads = model_bwd(q, k, v, m, g, rm, rl, emb)
    for name, got, want in zip(("dq", "dk", "dv"), grads, want_grads):
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)
    if mask == "full_row":  # no dq/dk in the fully masked sample, a uniform dv
        assert not grads[0][-1].any() and not grads[1][-1].any() and grads[2][-1].any()


@pytest.mark.parametrize("s", [8, 16, 32, 64])
def test_one_tf32_pass_fails_the_norm_check(s):
    """The control: the same model with one TF32 pass (hi . hi) leaves
    FP32_NORM_TOL, which the three passes keep."""
    b, h, t = 2, 2, 200
    q, k, v, g, m = _inputs(7 + s, b, h, t, s, "ragged")
    want, _ = _jax(q, k, v, g, m, h * s, True)
    three = _norm_err(model_fwd(q, k, v, m, h * s)[0], want)
    one = _norm_err(model_fwd(q, k, v, m, h * s, passes=1)[0], want)
    print(f"S = {s}: ||model - jax|| / ||jax||: 3xTF32 {three:.3e}, 1xTF32 {one:.3e}")
    assert three <= FP32_NORM_TOL < one


def _near_equal_case(seed, b, h, t, s):
    """The model's dq, dk, dv on values nearly equal across the keys against
    the plain float32 backward's, each as a distance to float64 (the largest
    elementwise over the largest value): [(name, model, plain)]."""
    rng = np.random.default_rng(seed)
    q, k, _, g, m = _inputs(seed + 1, b, h, t, s, "full_row")
    v = (rng.normal(size=(b, h, 1, s)) + 0.1 * rng.normal(size=(b, h, t, s))).astype(np.float32)
    emb = h * s
    _, rm, rl = model_fwd(q, k, v, m, emb)
    got = model_bwd(q, k, v, m, g, rm, rl, emb)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    tm = torch.from_numpy(m)
    plain = [a.numpy() for a in dense_attention_bwd(tq, tk, tv, tm, tg, emb)]
    with torch.enable_grad():
        leaves = [a.double().requires_grad_() for a in (tq, tk, tv)]
        c = emb ** -0.25
        sc = torch.einsum("bhts,bhus->bhtu", leaves[0] * c, leaves[1] * c)
        sc = sc.masked_fill(~tm[:, None, None, :], -1e7)
        out = torch.einsum("bhtu,bhus->bhts", torch.softmax(sc, -1), leaves[2])
        ref = [a.numpy() for a in torch.autograd.grad(out, leaves, tg.double())]
    errs = []
    for name, a, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        top = np.abs(r).max()
        errs.append((name, np.abs(a - r).max() / top, np.abs(p - r).max() / top))
        print(f"S = {s}, {name}: model {errs[-1][1]:.3e}, plain {errs[-1][2]:.3e} from float64")
    return errs


def test_model_dq_on_near_equal_values_as_accurate_as_plain():
    """Where a row's values are nearly equal across its keys, dP - D cancels:
    the model's dq, dk, dv (dP - c0 as g . (v - v0)) sit within 2x the plain
    float32 backward's distance to float64, plus 1e-7 of the largest value
    (the card's check, tests/test_torch_flash_kernel.py)."""
    for name, err, plain_err in _near_equal_case(33, 4, 8, 200, 8):
        assert err <= 2 * plain_err + 1e-7, f"{name}: model {err:.3e}, plain {plain_err:.3e}"


def test_model_dq_on_near_equal_values_as_accurate_as_plain_at_head_dim_32():
    """The same at the ViT image tower's head dim 32 and T = 36, where the
    float32 backward takes the 3xTF32 kernels."""
    for name, err, plain_err in _near_equal_case(43, 4, 4, 36, 32):
        assert err <= 2 * plain_err + 1e-7, f"{name}: model {err:.3e}, plain {plain_err:.3e}"


def test_model_dq_on_near_equal_values_as_accurate_as_plain_at_head_dim_64():
    """And at head dim 64 (the ViT at 2 heads), T = 36: each 3xTF32 product
    sums 64-wide head-dim products in 8 chained k-steps."""
    for name, err, plain_err in _near_equal_case(53, 4, 2, 36, 64):
        assert err <= 2 * plain_err + 1e-7, f"{name}: model {err:.3e}, plain {plain_err:.3e}"


# ---- fragment layouts and banks -----------------------------------------------

def _a_frag(lane):
    """PTX m16n8k8 .tf32 A places (row, column) of a lane: a0..a3."""
    g, t = lane >> 2, lane & 3
    return [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]


def _b_frag(lane):
    """PTX m16n8k8 .tf32 B places (k, column) of a lane: b0, b1."""
    g, t = lane >> 2, lane & 3
    return [(t, g), (t + 4, g)]


def _c_frag(lane):
    """PTX m16n8k8 C places (row, column) of a lane: c0..c3."""
    g, t = lane >> 2, lane & 3
    return [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]


def _mma_lanes(a_regs, b_regs):
    """The 16 x 8 product mma.sync computes from per-lane registers."""
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        for (r, col), x in zip(_a_frag(lane), a_regs[lane]):
            a[r, col] = x
        for (kk, col), x in zip(_b_frag(lane), b_regs[lane]):
            b[kk, col] = x
    return a @ b


def test_key_permutation_feeds_c_fragments_to_the_next_product():
    """c_to_a_perm (a = c0, c2, c1, c3) with load_b_perm (rows 2t, 2t + 1)
    computes C . X for a C fragment C (16 x 8) and shared rows X (8 x 8),
    though no lane holds the A fragment's own columns."""
    rng = np.random.default_rng(0)
    cmat, x = rng.normal(size=(16, 8)), rng.normal(size=(8, 8))
    a_regs, b_regs = [], []
    for lane in range(32):
        c = [cmat[r, col] for r, col in _c_frag(lane)]
        a_regs.append([c[0], c[2], c[1], c[3]])
        g, t = lane >> 2, lane & 3
        b_regs.append([x[2 * t, g], x[2 * t + 1, g]])
    np.testing.assert_allclose(_mma_lanes(a_regs, b_regs), cmat @ x, rtol=1e-12, atol=1e-12)
    # without the permutation (the C registers as they lie) the product is wrong
    plain = [[cmat[r, col] for r, col in _c_frag(lane)] for lane in range(32)]
    assert not np.allclose(_mma_lanes(plain, b_regs), cmat @ x)


@pytest.mark.parametrize("s", [8, 16, 32, 64])
def test_shared_memory_accesses_are_conflict_free(s):
    """The tiles' strides of csrc/flash_attention_tf32.cuh (row tiles S + 4
    floats a row, transposed tiles 2 * 64 + 16 words a column) put every
    phase of each access on distinct banks: an ldmatrix matrix (8 rows of 16
    bytes, load_b_rows) on 8 distinct 16-byte chunks, each quarter warp of a
    16-byte load (load_b_perm) on 8 distinct chunks, and the split's stores
    (a 16-byte row chunk by each of 8 consecutive rows; a half warp's (hi,
    lo) pairs of 16 consecutive rows) likewise."""
    rs, rt = s + 4, 2 * 64 + 16
    for n0 in range(0, 64, 8):
        for k0 in range(0, s, 8):
            for half in (0, 4):  # hi or lo tile alike
                chunks = {((n0 + r) * rs + k0 + half) // 4 % 8 for r in range(8)}
                assert len(chunks) == 8
    for r0 in range(0, 64, 8):
        for n0 in range(0, s, 8):
            for q in range(4):  # the lanes of each quarter warp
                chunks = {((n0 + (ln >> 2)) * rt + 2 * (r0 + 2 * (ln & 3))) // 4 % 8
                          for ln in range(8 * q, 8 * q + 8)}
                assert len(chunks) == 8
    for r0 in range(0, 64, 8):  # split: 16-byte row chunks of 8 consecutive rows
        for c in range(s // 4):
            assert len({((r0 + r) * rs + 4 * c) // 4 % 8 for r in range(8)}) == 8
    for r0 in range(0, 64, 16):  # split: (hi, lo) pairs of 16 consecutive rows
        for col in range(s):
            banks = {(col * rt + 2 * (r0 + r) + w) % 32 for r in range(16) for w in (0, 1)}
            assert len(banks) == 32


def _ldmatrix_x4(addr_of_lane, words):
    """ldmatrix.sync.aligned.m8n8.x4.b16 on 32-bit words, as the kernels use
    it: lane l names row l & 7 of matrix l >> 3 (16 bytes from the word
    address it gives); register j of lane L holds word L & 3 of row L >> 2
    of matrix j."""
    rows = [addr_of_lane(lane) for lane in range(32)]
    return [[words[rows[8 * j + (lane >> 2)] + (lane & 3)] for j in range(4)]
            for lane in range(32)]


def test_a_side_in_shared_memory_round_trips_conflict_free():
    """At head dim 64 the dk/dv kernel keeps v - v0 split in each warp's
    shared hi and lo tiles (row stride 68 words): store_a_smem's stores of
    a k-step's fragments fall on 32 distinct banks, and load_a_smem's
    ldmatrix.x4 reads back exactly the A fragment (a0..a3 of every lane), each
    of its matrices' 8 rows on distinct 16-byte chunks."""
    s, rs = 64, 64 + 4
    words = {}
    for ks in range(s // 8):
        for e in range(4):  # store_a_smem: one e of every lane at once
            banks = set()
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                off = (g + 8 * (e & 1)) * rs + 8 * ks + t + 4 * (e >> 1)
                words[off] = (g + 8 * (e & 1), 8 * ks + t + 4 * (e >> 1))
                banks.add(off % 32)
            assert len(banks) == 32
    for ks in range(s // 8):
        def addr(lane, ks=ks):
            j = lane >> 3
            return (8 * (j & 1) + (lane & 7)) * rs + 8 * ks + 4 * (j >> 1)

        got = _ldmatrix_x4(addr, words)
        for lane in range(32):
            want = [(r, 8 * ks + col) for r, col in _a_frag(lane)]
            assert got[lane] == want
        for j in range(4):
            assert len({addr(8 * j + r) // 4 % 8 for r in range(8)}) == 8


# ---- routing and build ----------------------------------------------------------

@pytest.mark.parametrize("dtype,s,layout,want", [
    ("float32", 8, "encoder", "tf32"),
    ("float32", 16, "encoder", "tf32"),
    ("float32", 8, "contiguous", "tf32"),
    ("float32", 16, "contiguous", "tf32"),
    ("float32", 32, "encoder", "tf32"),
    ("float32", 64, "contiguous", "tf32"),
    ("float32", 24, "encoder", "simt"),
    ("float32", 32, "offset", "simt"),
    ("float32", 8, "offset", "simt"),
    ("float32", 16, "offset", "simt"),
    ("bfloat16", 8, "encoder", "mma"),
    ("bfloat16", 16, "contiguous", "mma"),
    ("bfloat16", 64, "encoder", "mma"),
])
def test_route(dtype, s, layout, want):
    """float32 at head dims 8, 16, 32 and 64 with 16-byte rows takes the
    3xTF32 kernels; other head dims and rows off 16 bytes the CUDA cores;
    bfloat16 the bf16 tensor cores. The backward takes the same rule."""
    dt = getattr(torch, dtype)
    b, h, t = 2, 2, 16
    if layout == "encoder":
        tensors = [torch.zeros(b, t, h, s, dtype=dt).transpose(1, 2) for _ in range(3)]
    elif layout == "contiguous":
        tensors = [torch.zeros(b, h, t, s, dtype=dt) for _ in range(3)]
    else:
        tensors = [torch.zeros(b * h * t * s + 1, dtype=dt)[1:].view(b, h, t, s)
                   for _ in range(3)]
    assert _route(dt, s, tensors) == want
    assert _route(dt, s, tensors, True) == want
    # the backward's out and g count too
    off = torch.zeros(b * h * t * s + 1, dtype=dt)[1:].view(b, h, t, s)
    assert _route(dt, s, (*tensors, off, tensors[0])) == "simt"


def test_both_sources_are_built_and_bound():
    """Each tf32 source builds to its own library, has a ctypes signature,
    and is among chip_smoke.py's kernels (its build phase compiles every
    one)."""
    names = ("flash_attention_fwd_tf32", "flash_attention_bwd_tf32")
    paths = {library_path(n) for n in names + ("flash_attention_fwd", "flash_attention_bwd")}
    assert len(paths) == 4
    smoke = (REPO / "chip_smoke.py").read_text()
    sources = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    for name in names:
        assert (CSRC_DIR / f"{name}.cu").exists() and name in _ARGTYPES
        assert '#include "flash_attention_tf32.cuh"' in (CSRC_DIR / f"{name}.cu").read_text()
    for name in sources:
        assert re.search(rf'"{name}": \("multimodal_supernovae_tpu_torch/csrc/{name}\.cu"',
                         smoke), f"chip_smoke.py does not build csrc/{name}.cu"
    assert len(sources) == 14


@pytest.mark.parametrize("header", ["flash_attention_tf32.cuh", "tf32x3.cuh"])
def test_library_path_keys_on_the_tf32_headers(header, monkeypatch, tmp_path):
    """An edit of either header the tf32 kernels include rebuilds both."""
    for f in CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build_mod, "CSRC_DIR", tmp_path)
    names = ("flash_attention_fwd_tf32", "flash_attention_bwd_tf32")
    before = [library_path(n) for n in names]
    path = tmp_path / header
    path.write_text(path.read_text() + "\n// edited\n")
    assert all(a != b for a, b in zip(before, [library_path(n) for n in names]))


def test_cpu_float32_takes_the_plain_versions_and_counts_nothing():
    q, k, v, g, m = _inputs(3, 2, 2, 16, 8, "ragged")
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    tm = torch.from_numpy(m)
    fwd, bwd = flash_mod.flash_attention, flash_mod.flash_attention_bwd
    before = (fwd.tf32_launches, bwd.tf32_launches, fwd.launches, bwd.launches)
    out = fwd(tq, tk, tv, tm, 16)
    grads = bwd(tq, tk, tv, tm, None, None, tg, 16)
    want_out, want_grads = _jax(q, k, v, g, m, 16, False)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=OUT_TOL, atol=OUT_TOL)
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_TOL, atol=GRAD_TOL)
    assert (fwd.tf32_launches, bwd.tf32_launches, fwd.launches, bwd.launches) == before
