#!/usr/bin/env python3
"""Diagnostics of the float32 flash-attention kernels on the 3xTF32 tensor
cores (csrc/flash_attention_{fwd,bwd}_tf32.cu), on one CUDA GPU.

  python3 probe_flash_tf32.py        # from the repository root

Builds the kernels as they are and three variants made from the same
sources by text substitution, each into its own library under the
git-ignored multimodal_supernovae_tpu_torch/.kernel_build/probe/:
  * "one pass": one TF32 product (hi . hi) in place of three, wrong on
    purpose: how much of the time the tensor pipe's three passes take;
  * "no exp": the exponentials left out, wrong on purpose: the MUFU pipe's
    share;
  * "chained": each 8-wide step of a sum over keys or queries accumulated on
    the tensor core, chained (mma_rows), in place of summed from zero and
    added on the CUDA cores: the accuracy that step buys.
Every variant's forward and backward is read against the plain versions
(||got - want|| / ||want||) at the light-curve, spectral serving and
training, and trimodal shapes, and on nearly equal values against float64
(max|x - float64| / max|float64|, beside the plain version's); then each is
timed (CUDA events, median of 25 calls) in turns, built, variants, variants
reversed, built. Prints the card's name and power limit first. It checks
nothing but that the kernels as built stay within FP32_NORM_TOL (1e-5) and
that the near-equal limit (2x the plain distance + 1e-7) holds for them;
exits non-zero otherwise or without CUDA.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import multimodal_supernovae_tpu_torch.ops.flash_attention as flash_mod
from multimodal_supernovae_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc
from multimodal_supernovae_tpu_torch.ops import dense_attention, dense_attention_bwd

NAMES = ("flash_attention_fwd_tf32", "flash_attention_bwd_tf32")
HEADER = "flash_attention_tf32.cuh"
FP32_NORM_TOL = 1e-5
SHAPES = ((256, 8, 200, 8), (256, 2, 1024, 16), (256, 2, 220, 16), (32, 2, 1024, 16))

# (file, pattern, replacement) of each variant, applied to copies of csrc/
ONE_PASS = [(HEADER, r"\n\s*mma_tf32\(c0, a(\[ks\])?\.lo, b\.hi\);\n\s*mma_tf32\(c1, a(\[ks\])?\.hi, b\.lo\);",
             "")]
NO_EXP = [(f"{n}.cu", r"exp2_approx\(", "(") for n in NAMES]
CHAINED = [(HEADER, r"float c0\[4\] = \{0\.f, 0\.f, 0\.f, 0\.f\}, c1\[4\] = \{0\.f, 0\.f, 0\.f, 0\.f\};\n"
            r"\s*float c2\[4\] = \{0\.f, 0\.f, 0\.f, 0\.f\};\n"
            r"\s*mma_tf32\(c0, a\.lo, b\.hi\);\n\s*mma_tf32\(c1, a\.hi, b\.lo\);\n"
            r"\s*mma_tf32\(c2, a\.hi, b\.hi\);\n#pragma unroll\n"
            r"\s*for \(int e = 0; e < 4; \+\+e\) acc\[n\]\[e\] \+= c2\[e\] \+ \(c0\[e\] \+ c1\[e\]\);",
            "mma_tf32(acc[n], a.lo, b.hi);\n    mma_tf32(acc[n], a.hi, b.lo);\n"
            "    mma_tf32(acc[n], a.hi, b.hi);")]
VARIANTS = {"as built": [], "one pass": ONE_PASS, "no exp": NO_EXP, "chained": CHAINED}


def _sources(variant, edits):
    """A copy of csrc/ with ``edits`` applied; each must match once."""
    out = BUILD_DIR / "probe" / variant.replace(" ", "_")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(CSRC_DIR, out)
    for name, pattern, repl in edits:
        path = out / name
        text, n = re.subn(pattern, repl, path.read_text())
        if n < 1:
            raise RuntimeError(f"{variant}: no match for {pattern!r} in {name}")
        path.write_text(text)
    return out


def _build(job):
    variant, src, name = job
    lib = src / f"lib{name}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {variant} {name}:\n{proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(lib)), f"mmsn_{name}")
    fn.argtypes = flash_mod._ARGTYPES[name]
    fn.restype = ctypes.c_int
    return (variant, name), fn


def _use(entries, variant):
    for name in NAMES:
        flash_mod._bound[name] = entries[(variant, name)]


def _norm(got, want):
    want = want.double()
    return float(torch.linalg.vector_norm((got.double() - want).flatten())
                 / torch.linalg.vector_norm(want.flatten()))


def _inputs(gen, b, h, t, s, near_equal=False):
    def one():
        return torch.randn((b, t, h, s), generator=gen).cuda().transpose(1, 2)

    q, k, v, g = one(), one(), one(), one()
    if near_equal:  # a row's values nearly equal across its keys
        v = (torch.randn((b, 1, h, s), generator=gen)
             + 0.1 * torch.randn((b, t, h, s), generator=gen)).cuda().transpose(1, 2)
    mask = torch.rand((b, t), generator=gen) > 0.3
    mask[:, 0] = True
    mask[0] = False  # a fully masked row
    return q, k, v, g, mask.cuda()


def _f64_grads(q, k, v, mask, g, emb):
    with torch.enable_grad():
        leaves = [a.detach().double().requires_grad_() for a in (q, k, v)]
        c = emb ** -0.25
        scores = torch.einsum("bhts,bhus->bhtu", leaves[0] * c, leaves[1] * c)
        scores = scores.masked_fill(~mask[:, None, None, :], -1e7)
        out = torch.einsum("bhtu,bhus->bhts", torch.softmax(scores, -1), leaves[2])
        return torch.autograd.grad(out, leaves, g.double())


def _time_ms(fn, iters=25):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_flash_tf32.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    jobs = [(v, _sources(v, edits), n) for v, edits in VARIANTS.items() for n in NAMES]
    with ThreadPoolExecutor(len(jobs)) as pool:
        entries = dict(pool.map(_build, jobs))
    gen = torch.Generator().manual_seed(0)
    ok = True
    for shape in SHAPES + ((64, 8, 200, 8),):
        near = shape == (64, 8, 200, 8)
        b, h, t, s = shape
        q, k, v, g, mask = _inputs(gen, b, h, t, s, near)
        emb = h * s
        want = [dense_attention(q, k, v, mask, emb),
                *dense_attention_bwd(q, k, v, mask, g, emb)]
        ref = _f64_grads(q, k, v, mask, g, emb) if near else None
        for variant in VARIANTS:
            _use(entries, variant)
            out, stats = flash_mod._flash_fwd(q, k, v, mask, emb, with_stats=True)
            got = [out, *flash_mod.flash_attention_bwd(q, k, v, mask, out, stats, g, emb)]
            torch.cuda.synchronize()
            errs = [_norm(a, w) for a, w in zip(got, want)]
            line = (f"{variant} {shape}: ||x - plain|| / ||plain|| out, dq, dk, dv "
                    + " ".join(f"{e:.3e}" for e in errs))
            if variant == "as built":
                ok &= max(errs) <= FP32_NORM_TOL
            if near:
                for name, a, p, r in zip(("dq", "dk", "dv"), got[1:], want[1:], ref):
                    top = float(r.abs().max())
                    err = float((a.double() - r).abs().max()) / top
                    plain = float((p.double() - r).abs().max()) / top
                    line += f"; {name} from float64 {err:.3e} (plain {plain:.3e})"
                    if variant == "as built":
                        ok &= err <= 2 * plain + 1e-7
            print(line, flush=True)
    for shape in SHAPES:
        b, h, t, s = shape
        q, k, v, g, mask = _inputs(gen, b, h, t, s)
        emb = h * s
        _use(entries, "as built")
        out, stats = flash_mod._flash_fwd(q, k, v, mask, emb, with_stats=True)
        times = {}
        for variant in (*VARIANTS, *reversed(VARIANTS)):
            _use(entries, variant)
            fwd = _time_ms(lambda: flash_mod._flash_fwd(q, k, v, mask, emb, with_stats=True))
            bwd = _time_ms(lambda: flash_mod.flash_attention_bwd(q, k, v, mask, out, stats, g,
                                                                 emb))
            times.setdefault(variant, []).append((fwd, bwd))
        print(f"time {shape} float32, ms (forward, backward) per turn: " + "; ".join(
            f"{v} " + " ".join(f"({f:.4f}, {b:.4f})" for f, b in ts) for v, ts in times.items()),
            flush=True)
    print("probe_flash_tf32: " + ("ok" if ok else "the kernels as built left a limit"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
