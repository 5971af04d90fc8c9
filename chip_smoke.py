#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU: the maven-lite embedding
server end to end, through the hand-written flash-attention kernel.

  python3 chip_smoke.py        # from the repository root, one GPU

Phases (each prints a progress line; any failure raises, exit code != 0):
  1. device: CUDA must be present; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for float32 matmuls and convolutions;
  2. build: compiles csrc/flash_attention_fwd.cu with nvcc for sm_90a;
  3. kernel: the CUDA kernel against its plain version (dense_attention) on
     the card, float32 (atol = rtol = 1e-4: another summation order and the
     online rescale) and bfloat16 (0.05), at the light-curve (256, 8, 200, 8)
     and spectral (256, 2, 1024, 16) serving shapes, T = 220, a batch with a
     fully masked row, key_mask=None and the other head dims; then times
     both at the two serving shapes (CUDA events, median of 25);
  4. serve: a maven-lite CLIPModel with seeded random weights (bf16
     compute) is written as a run directory, served by load_live +
     EmbedServer on 127.0.0.1, and sent concurrent npz and JSON requests of
     1, 37, 256 and 300 samples. Checks: every status 200, (n, 32) finite
     unit-norm embeddings per modality, 18 kernel launches per device call
     and no plain attention call, answers equal to the same model run
     through the plain attention on the card (bf16 tolerance).

Prints, before the last line, one JSON object {"kernels": [...]} with the
measured numbers, and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import tempfile
import threading
import time
import urllib.request
from unittest import mock

import numpy as np
import torch

import multimodal_supernovae_tpu_torch.models.transformer as transformer_mod
import multimodal_supernovae_tpu_torch.ops.flash_attention as flash_mod
from multimodal_supernovae_tpu_torch.data import make_synthetic_arrays
from multimodal_supernovae_tpu_torch.kernels import build, library_path
from multimodal_supernovae_tpu_torch.models import (
    CLIPConfig,
    CLIPModel,
    load_model,
    write_model_config,
)
from multimodal_supernovae_tpu_torch.ops import dense_attention
from multimodal_supernovae_tpu_torch.serving import EmbedServer, load_live

KERNEL = "flash_attention_fwd"
KERNEL_SOURCE = "multimodal_supernovae_tpu_torch/csrc/flash_attention_fwd.cu"
REPLACES = "multimodal_supernovae_tpu/ops/pallas_attention.py:85"
TOL = {"float32": 1e-4, "bfloat16": 0.05}
LC_LEN, NBAND, SP_LEN, BATCH = 100, 2, 1024, 256
# maven-lite (configs/maven-lite.yaml; bench.py's model at serving shapes)
SEQ_LC = {"n_out": 32, "emb": 64, "heads": 8, "depth": 5, "time_norm": 20583.37,
          "agg": "attn", "dropout": 0.0}
SEQ_SP = {"n_out": 32, "emb": 32, "heads": 2, "depth": 13, "time_norm": 17945.14,
          "agg": "mean", "dropout": 0.0}
LAYERS_PER_CALL = SEQ_LC["depth"] + SEQ_SP["depth"]


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return card


def phase_build():
    seconds = build(KERNEL)
    log(f"build: nvcc {KERNEL_SOURCE} -> sm_90a in {seconds:.2f} s")
    for line in library_path(KERNEL).with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return seconds


def _heads(gen, b, h, t, s, dtype, model_layout):
    """q, k, v on the card; in the encoder's layout (views of (B, T, H, S)
    buffers) or contiguous (B, H, T, S)."""
    def one():
        shape = (b, t, h, s) if model_layout else (b, h, t, s)
        a = torch.randn(shape, generator=gen).to("cuda", dtype)
        return a.transpose(1, 2) if model_layout else a
    return one(), one(), one()


def _time_ms(fn, warmup=3, iters=25):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


def phase_kernel():
    flash_attention = flash_mod.flash_attention
    syn = make_synthetic_arrays(n=BATCH, n_max_lc=LC_LEN, nband=NBAND,
                                n_max_sp=SP_LEN, seed=0)
    mask_lc = torch.from_numpy(syn["mask_lc"]).cuda()
    mask_sp = torch.from_numpy(syn["mask_sp"]).cuda()
    masked = mask_sp[:16].clone()
    masked[0] = False          # a fully masked row: uniform over its T keys
    masked[1, :100] = False    # leading key tiles masked, later ones valid
    cases = [  # name, (B, H, T, S), mask, encoder layout
        ("lc", (BATCH, 8, 2 * LC_LEN, 8), mask_lc, True),
        ("sp", (BATCH, 2, SP_LEN, 16), mask_sp, True),
        ("t220", (BATCH, 2, 220, 16), mask_sp[:, -220:].contiguous(), False),
        ("masked_rows", (16, 2, SP_LEN, 16), masked, False),
        ("no_mask", (BATCH, 8, 2 * LC_LEN, 8), None, True),
        ("s32", (8, 2, 77, 32), mask_sp[:8, :77].contiguous(), False),
        ("s64", (8, 1, 77, 64), mask_sp[:8, -77:].contiguous(), False),
    ]
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    timing = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for name, (b, h, t, s), mask, layout in cases:
            q, k, v = _heads(gen, b, h, t, s, dtype, layout)
            emb = h * s
            got = flash_attention(q, k, v, mask, emb)
            torch.cuda.synchronize()
            want = dense_attention(q, k, v, mask, emb)
            if got.dtype != dtype or got.shape != want.shape:
                raise AssertionError(f"{name} {dtype_name}: got {got.dtype} "
                                     f"{tuple(got.shape)}")
            err = float((got.float() - want.float()).abs().max())
            max_err = max(max_err, err)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=TOL[dtype_name], atol=TOL[dtype_name],
                                       msg=lambda m: f"{name} {dtype_name}: {m}")
            log(f"kernel {name} {dtype_name} {(b, h, t, s)}: max|err| {err:.3e} "
                f"(tol {TOL[dtype_name]})")
            if name in ("lc", "sp"):
                ms = _time_ms(lambda: flash_attention(q, k, v, mask, emb))
                plain_ms = _time_ms(lambda: dense_attention(q, k, v, mask, emb))
                timing[(name, dtype_name)] = (ms, plain_ms)
                log(f"time {name} {dtype_name} {(b, h, t, s)}: kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms")
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return max_err, timing


def _run_dir(tmp):
    cfg = CLIPConfig.create(
        combinations=("lightcurve", "spectral"), enc_dim=32, nband=NBAND,
        logit_scale_init=19.55, loss="softmax", transformer_kwargs=SEQ_LC,
        transformer_spectral_kwargs=SEQ_SP, compute_dtype="bfloat16")
    model = CLIPModel(cfg, generator=torch.Generator().manual_seed(0))
    write_model_config(tmp, model)
    torch.save({"epoch": 0, "global_step": 0, "state_dict": model.state_dict()},
               os.path.join(tmp, "epoch=0-step=0.ckpt"))


def _post(port, feed, as_json):
    if as_json:
        body = json.dumps({k: v.tolist() for k, v in feed.items()}).encode()
        ctype = "application/json"
    else:
        buf = io.BytesIO()
        np.savez(buf, **feed)
        body, ctype = buf.getvalue(), "application/x-npz"
    req = urllib.request.Request(f"http://127.0.0.1:{port}/embed", body,
                                 {"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as r:
        status, data = r.status, r.read()
    if as_json:
        out = {k: np.asarray(v, np.float32) for k, v in json.loads(data).items()}
    else:
        with np.load(io.BytesIO(data)) as z:
            out = {k: z[k] for k in z.files}
    return status, out


def phase_serve():
    flash_attention = flash_mod.flash_attention

    sizes = [(1, False), (37, True), (256, False), (300, False)]  # (n, as JSON)
    syn = make_synthetic_arrays(n=sum(n for n, _ in sizes), n_max_lc=LC_LEN,
                                nband=NBAND, n_max_sp=SP_LEN, seed=1)
    fields = ("x_lc", "t_lc", "mask_lc", "x_sp", "t_sp", "mask_sp")
    feeds, lo = [], 0
    for n, _ in sizes:
        feeds.append({k: syn[k][lo:lo + n] for k in fields})
        lo += n

    with tempfile.TemporaryDirectory() as tmp:
        _run_dir(tmp)
        serving_model = load_live(tmp, BATCH, device="cuda", lc_len=LC_LEN,
                                  sp_len=SP_LEN)
        srv = EmbedServer(serving_model, host="127.0.0.1", port=0,
                          max_wait_ms=50.0)  # warms up: one device call
        plain_calls = []

        def counting_dense(*args, **kw):
            plain_calls.append(1)
            return dense_attention(*args, **kw)

        results = [None] * len(sizes)
        try:
            srv.start_background()
            barrier = threading.Barrier(len(sizes))

            def client(i):
                barrier.wait()
                results[i] = _post(srv.port, feeds[i], sizes[i][1])

            with mock.patch.object(flash_mod, "dense_attention", counting_dense):
                flash_attention.launches = 0
                t0 = time.perf_counter()
                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(len(sizes))]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=600)
                wall = time.perf_counter() - t0
                launches = flash_attention.launches
            if any(th.is_alive() for th in threads) or None in results:
                raise RuntimeError("a client did not finish")
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/healthz", timeout=60) as r:
                health = json.loads(r.read())
                if r.status != 200 or health["status"] != "ok":
                    raise AssertionError(f"/healthz: {r.status} {health}")
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/stats", timeout=60) as r:
                stats = json.loads(r.read())
                if r.status != 200:
                    raise AssertionError(f"/stats: {r.status}")
            calls = stats["device_calls"]
            log(f"serve: {len(sizes)} concurrent requests, "
                f"{sum(n for n, _ in sizes)} samples in {wall:.3f} s wall, "
                f"{calls} device calls, batch_fill {stats.get('batch_fill')}, "
                f"{launches} kernel launches, {len(plain_calls)} plain attention calls")
            if calls < -(-sum(n for n, _ in sizes) // BATCH):
                raise AssertionError(f"too few device calls: {calls}")
            if launches != LAYERS_PER_CALL * calls or plain_calls:
                raise AssertionError(
                    f"expected {LAYERS_PER_CALL} kernel launches per device call "
                    f"and no plain attention: {launches} launches for {calls} "
                    f"calls, {len(plain_calls)} plain calls")

            # per-call time of the served batch (fn ends in a host copy)
            full = {k: syn[k][:BATCH] for k in fields}
            serving_model.fn(full)
            per_call = []
            for _ in range(10):
                t0 = time.perf_counter()
                serving_model.fn(full)
                per_call.append((time.perf_counter() - t0) * 1e3)
            call_ms = float(np.median(per_call))
            log(f"serve: device call at B={BATCH}: {call_ms:.3f} ms median of 10 "
                f"({BATCH / call_ms * 1e3:.1f} samples/s), host clock incl. copies")
        finally:
            srv.close()

        # answers against the same model run through the plain attention
        ref_model, _ = load_model(tmp, "cuda")
        max_err = 0.0
        with mock.patch.object(transformer_mod, "attention", dense_attention), \
                torch.inference_mode():
            for (n, as_json), feed, (status, out) in zip(sizes, feeds, results):
                if status != 200:
                    raise AssertionError(f"request n={n}: status {status}")
                ref = ref_model.encode({k: torch.from_numpy(v).cuda()
                                        for k, v in feed.items()})
                for name, r in zip(("emb_lightcurve", "emb_spectral"), ref):
                    got = out[name]
                    if got.shape != (n, 32) or not np.isfinite(got).all():
                        raise AssertionError(f"{name} n={n}: shape {got.shape} "
                                             "or non-finite values")
                    norms = np.linalg.norm(got, axis=-1)
                    if np.abs(norms - 1).max() > 1e-3:
                        raise AssertionError(f"{name} n={n}: norms {norms.min()}"
                                             f"..{norms.max()}")
                    err = float(np.abs(got - r.float().cpu().numpy()).max())
                    max_err = max(max_err, err)
                    if err > TOL["bfloat16"]:
                        raise AssertionError(f"{name} n={n} ({'json' if as_json else 'npz'}): "
                                             f"max|served - plain| {err}")
        log(f"serve: every answer matches the plain-attention model, "
            f"max|err| {max_err:.3e} (tol {TOL['bfloat16']})")
    return launches


def main():
    card = phase_device()
    phase_build()
    max_err, timing = phase_kernel()
    launches = phase_serve()
    ms, plain_ms = timing[("sp", "bfloat16")]
    log(f"kernels line: ms/plain_ms at the spectral serving shape, bfloat16; "
        f"card {card}")
    print(json.dumps({"kernels": [{
        "name": KERNEL, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
