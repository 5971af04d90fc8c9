#!/usr/bin/env python3
"""The register knobs of the tensor-core flash kernels at head dims 32 and 64,
on one CUDA GPU: each knob as built against its other settings, by ptxas's
registers and spills and by device time.

  python3 probe_flash_tc_steps.py        # from the repository root
  python3 probe_flash_tc_steps.py --parent .checkouts/parent   # and a parent's kernels

The knobs (made from the sources by text substitution, each variant built
into its own library under the git-ignored
multimodal_supernovae_tpu_torch/.kernel_build/probe/):
  * the forwards' step (csrc/flash_attention_fwd_{mma,tf32}.cu, ``NJ``): a
    64-key tile taken in one step or in two 32-key steps (as built: bf16 at
    head dim 32, 3xTF32 at 32 and 64);
  * the backwards' unrolling at head dim 64
    (csrc/flash_attention_bwd_{mma,tf32}.cu, ``#pragma unroll (S == 64 ?
    ...)``): the steps of a tile one, two (as built: bf16; 3xTF32 takes
    one) or all at a time;
  * the 3xTF32 dq kernel's single key tile (T <= 64): copied and split once
    for both walks (as built), or again for the second ("reload", with the
    raw tiles double-buffered as at longer T);
  * the backwards' steps of a tile past T at head dims 32 and 64: skipped
    (as built) or computed ("no step skip"), and a warp whose rows all lie
    past T: idle (as built) or computing ("no warp skip"); both also timed
    at the main path's shapes with --parent.
Each variant is held to the plain versions (||got - want|| / ||want||:
NORM_TOL for bf16, FP32_NORM_TOL for float32) at the ViT's (B, 4, 36, 32)
and at (B, 2, 36, 64), B = 32 and 256, no mask, and at (16, 2, 77, 64) with
a ragged mask, then timed there by device time (torch.profiler sums over 25
calls) in turns: as built, the variants, the variants reversed, as built.
With ``--parent DIR`` (a commit unpacked by ``git archive``, whose
multimodal_supernovae_tpu_torch/csrc/ is read), the four kernels as that
commit builds them are held and timed beside the ones as built at the main
path's shapes, ragged masks, in turns (as built, parent, parent, as built):
the light curve (256, 8, 200, 8), the spectrum at training and serving T
(256, 2, 220 and 1024, 16) and the trimodal spectrum (32, 2, 1024, 16).
Prints the card's name and power limit first, then ptxas's lines (every
kernel as built and the parent's, the variants' at head dims 32 and 64);
exits non-zero when a variant leaves its limit or without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import multimodal_supernovae_tpu_torch.ops.flash_attention as flash_mod
from multimodal_supernovae_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc
from multimodal_supernovae_tpu_torch.ops import dense_attention, dense_attention_bwd

NORM_TOL, FP32_NORM_TOL = 6e-3, 1e-5
SHAPES = ((32, 4, 36, 32), (256, 4, 36, 32), (32, 2, 36, 64), (256, 2, 36, 64))
MAIN_SHAPES = ((256, 8, 200, 8), (256, 2, 220, 16), (256, 2, 1024, 16), (32, 2, 1024, 16))
# source: {variant: [(pattern, replacement)]}; "as built" first
NJ, UNROLL = r"int NJ = S [=>]= 32 \? 4 : 8;", r"#pragma unroll \(S == 64 \? \d :"
# a backward's steps of a tile that lie past T, computed (adding zeros)
STEP_SKIP = (r"\n\s*if \(S >= 32 && (kk|j) >= n_steps\) break;  "
             r"// the rest of the tile lies past T")
# the dq kernel's second walk copies and splits a single key tile again
RELOAD = [(r"const bool reuse = n_tiles == 1 && it == 1;", "const bool reuse = false;"),
          (r"const int buf = n_tiles == 1 \? 0 : it & 1;", "const int buf = it & 1;"),
          (r"const bool more = n_tiles > 1 && it \+ 1 < n_iter;",
           "const bool more = it + 1 < n_iter;"),
          (r"it < n_tiles && n_tiles > 1 \? nullptr", "it < n_tiles ? nullptr"),
          (r"const int nbuf = raw_buffers\(a\.T_len\);", "const int nbuf = 2;")]
KNOBS = {
    "flash_attention_fwd_mma": {"as built": [], "one step": [(NJ, "int NJ = 8;")],
                                "two steps": [(NJ, "int NJ = S >= 32 ? 4 : 8;")]},
    "flash_attention_fwd_tf32": {"as built": [], "one step": [(NJ, "int NJ = 8;")]},
    "flash_attention_bwd_mma": {
        "as built": [], "unroll 1": [(UNROLL, "#pragma unroll (S == 64 ? 1 :")],
        "unroll all": [(UNROLL, "#pragma unroll (S == 64 ? TILE / 16 :")],
        "no step skip": [(STEP_SKIP, "")],
        "no warp skip": [(r"if \(row0 >= T_len\) \{  // no row of this warp: copies and "
                          r"barriers only\n\s*\} else if \(dense\)", "if (dense)"),
                         (r"if \(row0 >= T_len\) \{  // no key row of this warp: copies and "
                          r"barriers only\n\s*\} else if \(dense\)", "if (dense)"),
                         (r"if \(row0 < T_len\)\n(\s*)dsum_tile", r"\1dsum_tile")]},
    "flash_attention_bwd_tf32": {
        "as built": [], "unroll 2": [(UNROLL, "#pragma unroll (S == 64 ? 2 :")],
        "unroll all": [(UNROLL, "#pragma unroll (S == 64 ? TILE / 8 :")],
        "reload": RELOAD,
        "no step skip": [(STEP_SKIP, "")],
        "no warp skip": [(r"if \(row0 >= T_len\) \{  // no row of this warp: copies, splits "
                          r"and barriers only\n\s*\} else if \(it < n_tiles\)",
                          "if (it < n_tiles)"),
                         (r"if \(row0 < T_len\)  // else no key row of this warp: copies, "
                          r"splits and barriers only\n", "")]},
}
# knobs also timed at the main path's shapes (with --parent)
MAIN_KNOBS = ("no step skip", "no warp skip")


def _build(job):
    """(name, variant): the variant's library, its ctypes entry and its
    ptxas lines (every head dim as built and for the parent, 32 and 64 for
    the knobs' variants)."""
    name, variant, edits, csrc = job
    out = BUILD_DIR / "probe" / f"{name}-{variant.replace(' ', '_')}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    path = out / f"{name}.cu"
    text = path.read_text()
    for pattern, repl in edits:
        text, n = re.subn(pattern, repl, text)
        if n < 1:
            raise RuntimeError(f"{name} {variant}: no match for {pattern!r}")
    path.write_text(text)
    lib = out / f"lib{name}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name} {variant}:\n{proc.stdout}{proc.stderr}")
    lines, keep = [], False
    every = variant in ("as built", "parent")  # every head dim; the knobs' at 32 and 64
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line:
            keep = bool(re.search(r"ILi(32|64)E" if not every else r"ILi\d+E", line))
            kernel = re.search(r"(\w+_kernel)ILi(\d+)E", line)
            if keep:
                lines.append(f"{kernel.group(1)}<{kernel.group(2)}>")
        elif keep and ("registers" in line or "spill" in line):
            lines[-1] += " | " + line.split(":", 1)[-1].strip()
    fn = getattr(ctypes.CDLL(str(lib)), f"mmsn_{name}")
    fn.argtypes = flash_mod._ARGTYPES[name]
    fn.restype = ctypes.c_int
    return (name, variant), (fn, lines)


def _device_ops(fn, iters):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]


def _device_ms(fn, iters=25, tries=5):
    """ms of device time a call: the sum of the device ops of ``iters`` calls
    under torch.profiler over ``iters``. A trace with fewer ops than
    ``iters`` times one call's (the profiler dropped some) is taken again."""
    fn()
    torch.cuda.synchronize()
    per_call = max(len(_device_ops(fn, 1)) for _ in range(tries))
    for _ in range(tries):
        ops = _device_ops(fn, iters)
        if per_call and len(ops) == per_call * iters:
            return sum(ops) / 1e6 / iters
    raise RuntimeError(f"torch.profiler dropped device ops in {tries} traces")


def _norm(got, want):
    want = want.double()
    return float(torch.linalg.vector_norm((got.double() - want).flatten())
                 / torch.linalg.vector_norm(want.flatten()))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="an unpacked commit whose kernels to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_flash_tc_steps.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    jobs = [(n, v, e, CSRC_DIR) for n, vs in KNOBS.items() for v, e in vs.items()]
    if args.parent:
        parent = Path(args.parent) / "multimodal_supernovae_tpu_torch" / "csrc"
        jobs += [(n, "parent", [], parent) for n in KNOBS]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(pool.map(_build, jobs))
    for (name, variant), (_, lines) in built.items():
        for line in lines:
            print(f"ptxas {name} [{variant}] {line}", flush=True)
    gen = torch.Generator().manual_seed(0)
    cases = []  # (shape, dtype, q, k, v, g, mask, timed with a mask: the main path's)
    main_shapes = MAIN_SHAPES if args.parent else ()
    for b, h, t, s in SHAPES + ((16, 2, 77, 64),) + main_shapes:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, g = (torch.randn((b, t, h, s), generator=gen).to("cuda", dtype)
                          .transpose(1, 2) for _ in range(4))
            mask = None
            if t not in (36, 1) and (b, h, t, s) not in SHAPES:
                mask = torch.rand((b, t), generator=gen) > 0.3
                mask[:, 0] = True
                mask = mask.cuda()
            cases.append(((b, h, t, s), dtype, q, k, v, g, mask, (b, h, t, s) in main_shapes))
    failed = []
    for name, variants in KNOBS.items():
        bwd = "_bwd_" in name
        dtype = torch.bfloat16 if name.endswith("_mma") else torch.float32
        tol = NORM_TOL if dtype == torch.bfloat16 else FP32_NORM_TOL
        knob_order = list(variants)
        knob_order = knob_order + knob_order[1:][::-1] + knob_order[:1]
        times = {v: {} for v in (*variants, "parent")}
        for shape, dt, q, k, v, g, mask, main_path in cases:
            if dt != dtype:
                continue
            main_order = ["as built", "parent", *(k for k in MAIN_KNOBS if k in variants)]
            order = (main_order + main_order[1:][::-1] + main_order[:1] if main_path
                     else knob_order)
            emb = shape[1] * shape[3]
            out, stats = flash_mod._flash_fwd(q, k, v, mask, emb, with_stats=True)
            want = (dense_attention_bwd(q, k, v, mask, g, emb) if bwd
                    else (dense_attention(q, k, v, mask, emb),))

            def call():
                if bwd:
                    return flash_mod.flash_attention_bwd(q, k, v, mask, out, stats, g, emb)
                return (flash_mod._flash_fwd(q, k, v, mask, emb, with_stats=False)[0],)

            for variant in order:
                flash_mod._bound[name] = built[(name, variant)][0]
                if variant not in times or shape not in times[variant]:
                    errs = [_norm(a, w) for a, w in zip(call(), want)]
                    if max(errs) > tol:
                        failed.append((name, variant, shape, errs))
                    print(f"check {name} [{variant}] {shape}: ||err||/||plain|| "
                          + " ".join(f"{e:.3e}" for e in errs) + f" (tol {tol})", flush=True)
                if mask is None or main_path:
                    times[variant].setdefault(shape, []).append(_device_ms(call))
        flash_mod._bound.pop(name, None)
        for variant, by_shape in times.items():
            if not by_shape:
                continue
            print(f"time {name} [{variant}] device ms (turns): " + "; ".join(
                f"{shape} " + " ".join(f"{t:.4f}" for t in ts) for shape, ts in by_shape.items()),
                flush=True)
    if failed:
        print(f"FAILED: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
