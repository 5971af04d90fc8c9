#!/usr/bin/env python3
"""Which D the bf16 tensor-core flash backward (csrc/flash_attention_bwd_mma.cu)
should take, on one CUDA GPU.

  python3 probe_flash_bf16_d.py        # from the repository root

The backward's dS = P o (dP - D) cancels where a row's values are nearly
equal across its keys (the ViT image tower's 36 tokens), so any error of D
comes through whole. The kernel as built takes D = g . out at head dims 8
and 16 and sums D = c0 + rowsum(P o (dP - c0)) over the keys at 32. Two
variants are built from the same source by text substitution, each into
its own library under the git-ignored
multimodal_supernovae_tpu_torch/.kernel_build/probe/:
  * "g . out at 32": D = g . out at every head dim;
  * "summed at 8 and 16": D summed over the keys at every head dim.
On bf16 inputs whose values are nearly equal across the keys (v = v0 + 0.1
noise) at (64, 4, 36, S) for S = 8, 16, 32 (no mask, the ViT's T) and at
(64, 8, 200, 8) with ragged tails and a fully masked row (the light curve's
shape), each variant's dq is read against the float64 gradient of the same
bf16 inputs, as ||dq - ref|| / ||ref|| over the plain bf16 version's
(dense_attention's autograd): the measure of chip_smoke.py's
VIT_BF16_DQ_RATIO (1.2). The CUDA-core backward (csrc/flash_attention_bwd.cu,
D summed) is read beside them, and each variant's backward is timed (CUDA
events, median of 25) in turns.

Then each variant's backward is timed by device time (torch.profiler, the
sum of its kernels' durations, chip_smoke.py's _device_ms) in turns
(ABC, CBA) at the shapes the bf16 backward runs in training: the
spectral tower's (256, 2, 220, 16) and (256, 2, 1024, 16), the light
curve's (256, 8, 200, 8), ragged masks, and the ViT's (256, 4, 36, 32):
what summing D at every head dim would cost, since the dq kernel then walks
the keys twice.

Last, at head dims 8, 16 and 32 on the near-equal inputs (64, 4, 36, S),
each backward of each dtype (bf16: the tensor cores and the CUDA cores;
float32: 3xTF32 and the CUDA cores) is read for dq, dk and dv against the
float64 gradient, over the plain version of the same dtype: the ratio of
||x - float64|| / ||float64||, and of the largest elementwise distance
(the measure of tests/test_torch_flash_kernel.py's float32 pins).

Prints the card's name and power limit first. It checks nothing but that
the kernel as built stays within 1.2 at head dim 32; exits non-zero
otherwise or without CUDA.
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
from chip_smoke import _device_ms
from multimodal_supernovae_tpu_torch.ops import dense_attention_bwd

NAME = "flash_attention_bwd_mma"
SUM_D = r"constexpr bool SUM_D = S == 32;"
VARIANTS = {"as built": None, "g . out at 32": "constexpr bool SUM_D = false;",
            "summed at 8 and 16": "constexpr bool SUM_D = true;"}
SHAPES = (((64, 4, 36, 8), False), ((64, 4, 36, 16), False), ((64, 4, 36, 32), False),
          ((64, 8, 200, 8), True))
TIMED = (((256, 2, 220, 16), True), ((256, 2, 1024, 16), True), ((256, 8, 200, 8), True),
         ((256, 4, 36, 32), False))
VIT_BF16_DQ_RATIO = 1.2  # chip_smoke.py's limit on the bf16 dq at the ViT


def _build(variant):
    """The backward of ``variant`` built from a copy of csrc/ into its own
    library; returns its ctypes entry."""
    out = BUILD_DIR / "probe" / re.sub(r"\W+", "_", variant)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(CSRC_DIR, out)
    repl = VARIANTS[variant]
    if repl is not None:
        path = out / f"{NAME}.cu"
        text, n = re.subn(re.escape(SUM_D), repl, path.read_text())
        if n != 1:
            raise RuntimeError(f"{variant}: {SUM_D!r} matched {n} times")
        path.write_text(text)
    lib = out / f"lib{NAME}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(out / f"{NAME}.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {variant}:\n{proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(lib)), f"mmsn_{NAME}")
    fn.argtypes = flash_mod._ARGTYPES[NAME]
    fn.restype = ctypes.c_int
    return fn


def _inputs(gen, b, h, t, s, masked, dtype=torch.bfloat16):
    def one(x=None):
        x = torch.randn((b, t, h, s), generator=gen) if x is None else x
        return x.to("cuda", dtype).transpose(1, 2)

    q, k, g = one(), one(), one()
    v = one(torch.randn((b, 1, h, s), generator=gen)
            + 0.1 * torch.randn((b, t, h, s), generator=gen))
    mask = None
    if masked:
        mask = torch.rand((b, t), generator=gen) > 0.3
        mask[:, 0] = True
        mask[0] = False  # a fully masked row
        mask = mask.cuda()
    return q, k, v, g, mask


def _f64_grads(q, k, v, mask, g, emb):
    with torch.enable_grad():
        leaves = [a.detach().double().requires_grad_() for a in (q, k, v)]
        c = emb ** -0.25
        scores = torch.einsum("bhts,bhus->bhtu", leaves[0] * c, leaves[1] * c)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :], -1e7)
        out = torch.einsum("bhtu,bhus->bhts", torch.softmax(scores, -1), leaves[2])
        return torch.autograd.grad(out, leaves, g.double())


def _dist(got, ref):
    return float(torch.linalg.vector_norm((got.double() - ref).flatten())
                 / torch.linalg.vector_norm(ref.flatten()))


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
        print("CUDA is not available: probe_flash_bf16_d.py needs one GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        entries = dict(zip(VARIANTS, pool.map(_build, VARIANTS)))
    gen = torch.Generator().manual_seed(0)
    ok = True
    for (b, h, t, s), masked in SHAPES:
        q, k, v, g, mask = _inputs(gen, b, h, t, s, masked)
        emb = h * s
        out, stats = flash_mod._flash_fwd(q, k, v, mask, emb, with_stats=True)
        ref = _f64_grads(q, k, v, mask, g, emb)[0]
        plain = _dist(dense_attention_bwd(q, k, v, mask, g, emb)[0], ref)

        def call():
            return flash_mod.flash_attention_bwd(q, k, v, mask, out, stats, g, emb)

        ratios, times = {}, {n: [] for n in entries}
        for variant, fn in entries.items():
            flash_mod._bound[NAME] = fn
            if flash_mod._route(q.dtype, s, (q, k, v, out, g), True) != "mma":
                raise RuntimeError(f"{(b, h, t, s)}: not on the bf16 tensor-core route")
            ratios[variant] = _dist(call()[0], ref) / plain
        for order in (list(entries), list(entries)[::-1]):  # in turns
            for variant in order:
                flash_mod._bound[NAME] = entries[variant]
                times[variant].append(_time_ms(call))
        flash_mod._bound.pop(NAME)
        route = flash_mod._route
        flash_mod._route = lambda *a: "simt"
        try:
            ratios["CUDA cores"] = _dist(call()[0], ref) / plain
            simt_ms = _time_ms(call)
        finally:
            flash_mod._route = route
        shape = f"{(b, h, t, s)} bf16, {'ragged mask' if masked else 'no mask'}"
        print(f"{shape}: dq's ||x - float64|| / ||float64|| over the plain version's "
              f"({plain:.3e}): " + ", ".join(f"{n} {r:.3f}" for n, r in ratios.items()),
              flush=True)
        print(f"{shape}: backward by events (ms, median of 25, two turns): " + ", ".join(
            f"{n} {np.mean(ms):.4f}" for n, ms in times.items())
            + f", CUDA cores {simt_ms:.4f}", flush=True)
        if s == 32 and not ratios["as built"] <= VIT_BF16_DQ_RATIO:
            ok = False
    for (b, h, t, s), masked in TIMED:
        _device_times(entries, *_inputs(gen, b, h, t, s, masked))
    for s in (8, 16, 32):
        for dtype in (torch.bfloat16, torch.float32):
            _route_errors(*_inputs(gen, 64, 4, 36, s, False, dtype))
    sys.exit(0 if ok else 1)


def _device_times(entries, q, k, v, g, mask):
    """Each variant's backward by device time, in turns."""
    emb = q.shape[1] * q.shape[3]
    out, stats = flash_mod._flash_fwd(q, k, v, mask, emb, with_stats=True)
    times = {n: [] for n in entries}
    for order in (list(entries), list(entries)[::-1]):
        for variant in order:
            flash_mod._bound[NAME] = entries[variant]
            times[variant].append(_device_ms(
                lambda: flash_mod.flash_attention_bwd(q, k, v, mask, out, stats, g, emb)))
    flash_mod._bound.pop(NAME)
    print(f"{tuple(q.shape)} bf16, {'ragged mask' if mask is not None else 'no mask'}: "
          "backward device time (ms, torch.profiler, 25 calls, two turns): " + ", ".join(
              f"{n} {ms[0]:.4f} / {ms[1]:.4f}" for n, ms in times.items()), flush=True)


def _route_errors(q, k, v, g, mask):
    """dq, dk and dv of the routed backward and of the CUDA cores against
    float64, over the plain version of the same dtype."""
    emb = q.shape[1] * q.shape[3]
    ref = _f64_grads(q, k, v, mask, g, emb)
    plain = dense_attention_bwd(q, k, v, mask, g, emb)
    out, stats = flash_mod._flash_fwd(q, k, v, mask, emb, with_stats=True)
    routed = flash_mod._route(q.dtype, q.shape[3], (q, k, v, out, g), True)
    route = flash_mod._route
    for name in (routed, "simt"):
        flash_mod._route = lambda *a, name=name: name
        try:
            grads = flash_mod.flash_attention_bwd(q, k, v, mask, out, stats, g, emb)
        finally:
            flash_mod._route = route
        parts = []
        for x, got, p, r in zip("qkv", grads, plain, ref):
            elem = float((got.double() - r).abs().max()) / float((p.double() - r).abs().max())
            parts.append(f"d{x} {_dist(got, r) / _dist(p, r):.3f} / {elem:.3f}")
        print(f"{tuple(q.shape)} {str(q.dtype)[6:]} near-equal values, route {name}: over the "
              "plain version's distance to float64 (norm / largest element): "
              + ", ".join(parts), flush=True)


if __name__ == "__main__":
    main()
