#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU: the maven-lite embedding
server and the maven-lite contrastive trainer end to end, through the
hand-written flash-attention kernels (forward and backward).

  python3 chip_smoke.py        # from the repository root, one GPU

Phases (each prints a progress line; any failure raises, exit code != 0):
  1. device: CUDA must be present; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for float32 matmuls and convolutions;
  2. build: compiles csrc/flash_attention_fwd.cu and flash_attention_bwd.cu
     with nvcc for sm_90a, both at once;
  3. kernel: the forward kernel against its plain version (dense_attention) on
     the card, float32 (atol = rtol = 1e-4: another summation order and the
     online rescale) and bfloat16 (0.05), at the light-curve (256, 8, 200, 8)
     and spectral (256, 2, 1024, 16) serving shapes, T = 220, a batch with a
     fully masked row, key_mask=None and the other head dims; then times
     both at the two serving shapes (CUDA events, median of 25);
  4. kernel-bwd: the backward kernel's dq/dk/dv against torch autograd
     through dense_attention on the card, float32 (atol = rtol = 5e-4, the
     JAX kernel tests' gradient tolerance) and bfloat16 (0.05), at the
     training shapes LC (256, 8, 200, 8) and SP (256, 2, 220, 16), at SP
     T = 1024, with a fully masked row and leading key tiles masked, and
     key_mask=None; then times kernel and plain backward at LC and SP, bf16
     (CUDA events, median of 25);
  5. serve: a maven-lite CLIPModel with seeded random weights (bf16
     compute) is written as a run directory, served by load_live +
     EmbedServer on 127.0.0.1, and sent concurrent npz and JSON requests of
     1, 37, 256 and 300 samples. Checks: every status 200, (n, 32) finite
     unit-norm embeddings per modality, 18 kernel launches per device call
     and no plain attention call, answers equal to the same model run
     through the plain attention on the card (bf16 tolerance);
  6. train: maven-lite at bench.py's shapes (B = 256, T_lc = 2 x 100,
     T_sp = 220, bf16, lr 5e-4, noise_level_mag 1.0, dropout 0) on the
     2048-sample synthetic set, through Trainer.fit for 3 epochs. Checks:
     every loss finite, AUC_val in [0, 1], 18 forward and 18 backward kernel
     launches per train step (18 forward per eval step) and no plain
     attention call. Then, from the same seeded float32 weights with the
     noise off, 12 steps on the kernel path and 12 on the plain path over
     one index plan: the per-step losses agree to relative 1e-5 (sound runs
     differ by about 1e-7: summation order). At lr 5e-4 the loss moves
     too little for this to see a wrong backward, so every parameter's
     gradient of one float32 loss is held against the plain path's too,
     max|diff| / max|plain| <= 5e-4 per parameter (the gradient tolerance;
     the denominator floored at 1e-3 of the model's largest gradient); the
     kernel path with every dq off by 1% must fail that check.
     Prints the median train-step time and paired samples/s of both paths
     (bf16, the same batch, host clock around synchronised steps, three
     alternating rounds of 20 steps each) and their peak device memory;
  7. profile: torch.profiler (device activity) over 5 train steps of each
     path (bf16, one batch, after 3 warm-up steps): device time per step
     (the union of device ops), the trace's wall per step (first device
     op's start to the last one's end), one minus their ratio as the device
     idle share, device ops per step, and device time by kind of kernel
     (flash forward, dq, dk/dv, GEMMs, reductions, ...).

Prints, before the last line, one JSON object {"kernels": [...]} with the
measured numbers, and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import multimodal_supernovae_tpu_torch.models.transformer as transformer_mod
import multimodal_supernovae_tpu_torch.ops.flash_attention as flash_mod
from multimodal_supernovae_tpu_torch.data import (
    epoch_indices,
    make_synthetic_arrays,
    make_synthetic_dataset,
    take,
)
from multimodal_supernovae_tpu_torch.kernels import build, library_path
from multimodal_supernovae_tpu_torch.models import (
    CLIPConfig,
    CLIPModel,
    load_model,
    write_model_config,
)
from multimodal_supernovae_tpu_torch.ops import dense_attention, dense_attention_bwd
from multimodal_supernovae_tpu_torch.serving import EmbedServer, load_live
from multimodal_supernovae_tpu_torch.training import (
    Trainer,
    TrainerConfig,
    TrainState,
    build_optimizer,
    make_epoch_runner,
    make_train_step,
)

KERNELS = {  # name: (source, the TPU kernel it replaces)
    "flash_attention_fwd": ("multimodal_supernovae_tpu_torch/csrc/flash_attention_fwd.cu",
                            "multimodal_supernovae_tpu/ops/pallas_attention.py:85"),
    "flash_attention_bwd": ("multimodal_supernovae_tpu_torch/csrc/flash_attention_bwd.cu",
                            "multimodal_supernovae_tpu/ops/pallas_attention.py:108"),
}
TOL = {"float32": 1e-4, "bfloat16": 0.05}
GRAD_TOL = {"float32": 5e-4, "bfloat16": 0.05}
TRAJ_RTOL, GRAD_RTOL = 1e-5, 5e-4
WRONG_DQ = "kernel, dq x 0.99"
LC_LEN, NBAND, SP_LEN, BATCH = 100, 2, 1024, 256
TRAIN_SP_LEN, TRAIN_N, TRAIN_EPOCHS, TRAJ_STEPS, TIMED_STEPS = 220, 2048, 3, 12, 20
PROFILED_STEPS = 5
DEVICE = "cuda"
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
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        seconds = dict(zip(KERNELS, pool.map(build, KERNELS)))
    for name, (source, _) in KERNELS.items():
        log(f"build: nvcc {source} -> sm_90a in {seconds[name]:.2f} s")
        for line in library_path(name).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build: both kernels in {time.perf_counter() - t0:.2f} s wall")


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


def phase_kernel_bwd():
    fwd, bwd = flash_mod._flash_fwd, flash_mod.flash_attention_bwd
    syn = make_synthetic_arrays(n=BATCH, n_max_lc=LC_LEN, nband=NBAND,
                                n_max_sp=SP_LEN, seed=2)
    mask_lc = torch.from_numpy(syn["mask_lc"]).cuda()
    mask_sp = torch.from_numpy(syn["mask_sp"]).cuda()
    mask_train = mask_sp[:, :TRAIN_SP_LEN].contiguous()
    masked = mask_sp[:16].clone()
    masked[0] = False          # a fully masked row: uniform P, dq = dk = 0
    masked[1, :100] = False    # leading key tiles masked, later ones valid
    cases = [  # name, (B, H, T, S), mask, encoder layout
        ("lc", (BATCH, 8, 2 * LC_LEN, 8), mask_lc, True),
        ("sp", (BATCH, 2, TRAIN_SP_LEN, 16), mask_train, True),
        ("sp_t1024", (BATCH, 2, SP_LEN, 16), mask_sp, True),
        ("masked_rows", (16, 2, SP_LEN, 16), masked, False),
        ("no_mask", (BATCH, 8, 2 * LC_LEN, 8), None, True),
        ("s32", (8, 2, 77, 32), mask_sp[:8, :77].contiguous(), False),
    ]
    gen = torch.Generator().manual_seed(1)
    max_err = 0.0
    timing = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        tol = GRAD_TOL[dtype_name]
        for name, (b, h, t, s), mask, layout in cases:
            q, k, v = _heads(gen, b, h, t, s, dtype, layout)
            # the cotangent in the head merge's (B, T, H, S) memory order
            g = torch.randn((b, t, h, s), generator=gen).to("cuda", dtype).transpose(1, 2)
            emb = h * s
            out, stats = fwd(q, k, v, mask, emb, with_stats=True)
            got = bwd(q, k, v, mask, out, stats, g, emb)
            torch.cuda.synchronize()
            want = dense_attention_bwd(q, k, v, mask, g, emb)
            errs = []
            for gname, a, w in zip(("dq", "dk", "dv"), got, want):
                if a.dtype != dtype or a.shape != q.shape:
                    raise AssertionError(f"{name} {dtype_name} {gname}: {a.dtype} "
                                         f"{tuple(a.shape)}")
                errs.append(float((a.float() - w.float()).abs().max()))
                torch.testing.assert_close(
                    a.float(), w.float(), rtol=tol, atol=tol,
                    msg=lambda m: f"{name} {dtype_name} {gname}: {m}")
            if name == "masked_rows" and (got[0][0].any() or got[1][0].any()
                                          or not got[2][0].any()):
                raise AssertionError("fully masked row: want dq = dk = 0, dv != 0")
            max_err = max(max_err, *errs)
            log(f"kernel-bwd {name} {dtype_name} {(b, h, t, s)}: max|err| dq "
                f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (tol {tol})")
            if name in ("lc", "sp") and dtype_name == "bfloat16":
                ms = _time_ms(lambda: bwd(q, k, v, mask, out, stats, g, emb))
                leaves = [a.detach().requires_grad_() for a in (q, k, v)]
                plain_out = dense_attention(*leaves, mask, emb)
                plain_ms = _time_ms(lambda: torch.autograd.grad(
                    plain_out, leaves, g, retain_graph=True))
                timing[name] = (ms, plain_ms)
                log(f"time-bwd {name} {dtype_name} {(b, h, t, s)}: kernel {ms:.4f} ms, "
                    f"plain (autograd of dense_attention) {plain_ms:.4f} ms")
                del leaves, plain_out
            del q, k, v, g, out, stats, got, want
    torch.cuda.empty_cache()
    return max_err, timing


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


def _train_model(compute_dtype, seed=0):
    cfg = CLIPConfig.create(
        combinations=("lightcurve", "spectral"), enc_dim=32, nband=NBAND,
        logit_scale_init=19.55, loss="softmax", transformer_kwargs=SEQ_LC,
        transformer_spectral_kwargs=SEQ_SP, compute_dtype=compute_dtype)
    return CLIPModel(cfg, generator=torch.Generator().manual_seed(seed)).to(DEVICE)


@contextlib.contextmanager
def _plain_calls():
    """Records each plain attention call (forward or backward) made through
    the kernels' wrapper module."""
    calls = []

    def counted(fn):
        def wrapped(*args, **kw):
            calls.append(1)
            return fn(*args, **kw)
        return wrapped

    with mock.patch.object(flash_mod, "dense_attention",
                           counted(flash_mod.dense_attention)), \
            mock.patch.object(flash_mod, "dense_attention_bwd",
                              counted(flash_mod.dense_attention_bwd)):
        yield calls


def _zero_counts():
    flash_mod.flash_attention.launches = 0
    flash_mod.flash_attention_bwd.launches = 0


def _counts():
    return flash_mod.flash_attention.launches, flash_mod.flash_attention_bwd.launches


def _attention_path(path):
    """The kernel path as it is, or the plain path: every encoder layer's
    attention replaced by dense_attention (with torch autograd)."""
    if path == "plain":
        return mock.patch.object(transformer_mod, "attention", dense_attention)
    return contextlib.nullcontext()


def _time_train_steps(path, batch):
    """ms of each of TIMED_STEPS train steps (bf16, noise on) on one batch,
    each step ended by a synchronise; their launch counts; peak memory."""
    model = _train_model("bfloat16")
    opt, _ = build_optimizer(model.named_parameters(), lr=5e-4)
    state = TrainState(model, opt)
    step = make_train_step(model, noise_level_mag=1.0)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    with _attention_path(path):
        for _ in range(3):
            step(state, batch, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        times = []
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            _, loss = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = _counts()
        if not torch.isfinite(loss):
            raise AssertionError(f"{path} path: non-finite loss {loss}")
    return times, counts, torch.cuda.max_memory_allocated() / 2**30


def _wrong_dq():
    """The kernel path with a wrong backward: every layer's dq off by 1%."""
    bwd = flash_mod.flash_attention_bwd

    def wrong(*args):
        dq, dk, dv = bwd(*args)
        return dq * 0.99, dk, dv

    wrong.launches = 0  # the wrapper counts on the module attribute it replaces
    return mock.patch.object(flash_mod, "flash_attention_bwd", wrong)


def _path(path):
    return _wrong_dq() if path == WRONG_DQ else _attention_path(path)


def _trajectory(path, data, plan):
    """Per-step losses of TRAJ_STEPS float32 steps (noise off) from the
    seeded weights over ``plan``."""
    model = _train_model(None)
    opt, _ = build_optimizer(model.named_parameters(), lr=5e-4)
    with _path(path):
        _, losses = make_epoch_runner(model)(TrainState(model, opt), data, plan,
                                             torch.Generator(device=DEVICE))
    return losses.cpu().numpy()


def _param_grads(path, batch):
    """Every parameter's gradient of one float32 train-mode loss (noise off)
    from the seeded weights."""
    model = _train_model(None)
    with _path(path):
        loss, _ = model.loss_fn(batch, train=True, generator=torch.Generator(device=DEVICE))
        loss.backward()
    return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def _grad_error(got, want):
    """Worst parameter by max|got - want| / max|want|, and that ratio. The
    denominator is floored at 1e-3 of the largest gradient in the model: a
    gradient that is zero in exact arithmetic (logit_bias under the
    shift-invariant softmax loss) is rounding noise on both paths."""
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    errs = {name: float((got[name] - w).abs().max()) / max(float(w.abs().max()), floor)
            for name, w in want.items()}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def phase_train():
    ds = make_synthetic_dataset(n=TRAIN_N, n_max_lc=LC_LEN, nband=NBAND,
                                n_max_sp=TRAIN_SP_LEN, seed=0)
    n_train = TRAIN_N - BATCH
    train_ds, val_ds = ds.subset(np.arange(n_train)), ds.subset(np.arange(n_train, TRAIN_N))
    model = _train_model("bfloat16")
    trainer = Trainer(model, "contrastive", TrainerConfig(
        epochs=TRAIN_EPOCHS, batch_size=BATCH, lr=5e-4, seed=0, noise_level_mag=1.0))

    # the main path: Trainer.fit, counted from zero
    with _plain_calls() as plain:
        _zero_counts()
        t0 = time.perf_counter()
        result = trainer.fit(train_ds, val_ds)
        wall = time.perf_counter() - t0
        fwd_launches, bwd_launches = _counts()
    steps = TRAIN_EPOCHS * -(-n_train // BATCH)
    eval_steps = TRAIN_EPOCHS * -(-len(val_ds) // BATCH)
    rows = result["metric_rows"]
    for row in rows:
        log(f"train: epoch {row['epoch']} train_loss {row['train_loss']:.5f} "
            f"val_loss {row['val_loss']:.5f} AUC_val {row['AUC_val']:.4f} "
            f"step {row['step_time_s'] * 1e3:.2f} ms")
        for key in ("train_loss", "val_loss", "AUC_val"):
            if not np.isfinite(row[key]):
                raise AssertionError(f"train: non-finite {key} at epoch {row['epoch']}")
        if not 0.0 <= row["AUC_val"] <= 1.0:
            raise AssertionError(f"train: AUC_val {row['AUC_val']}")
    log(f"train: Trainer.fit {len(rows)} epochs, {steps} train + {eval_steps} eval "
        f"steps in {wall:.3f} s wall; {fwd_launches} forward and {bwd_launches} "
        f"backward kernel launches, {len(plain)} plain attention calls")
    if (result["epochs_run"] != TRAIN_EPOCHS or plain
            or fwd_launches != LAYERS_PER_CALL * (steps + eval_steps)
            or bwd_launches != LAYERS_PER_CALL * steps):
        raise AssertionError(
            f"expected {LAYERS_PER_CALL} forward + {LAYERS_PER_CALL} backward launches "
            f"per train step, {LAYERS_PER_CALL} forward per eval step, no plain call")

    # train-step time, kernel path against plain path, on one batch
    data = ds.to_device(DEVICE)
    batch = take(data, torch.arange(BATCH, device=DEVICE))
    times = {"kernel": [], "plain": []}
    for path in ("kernel", "plain", "plain", "kernel", "kernel", "plain"):
        ts, counts, peak = _time_train_steps(path, batch)
        times[path] += ts
        want = ((LAYERS_PER_CALL * TIMED_STEPS,) * 2 if path == "kernel" else (0, 0))
        if counts != want:
            raise AssertionError(f"{path} path: launches {counts}, want {want}")
        ms = float(np.median(ts))
        log(f"train-step {path}: {ms:.3f} ms median of {TIMED_STEPS} at B={BATCH} bf16 "
            f"({BATCH / ms * 1e3:.1f} paired samples/s), peak {peak:.3f} GiB, "
            f"launches fwd/bwd {counts}")
    for path, ts in times.items():
        q1, ms, q3 = np.percentile(ts, [25, 50, 75])
        log(f"train-step {path}, all rounds: median {ms:.3f} ms (quartiles {q1:.3f}-"
            f"{q3:.3f}) over {len(ts)} steps, {BATCH / ms * 1e3:.1f} paired samples/s")

    # loss trajectory, kernel path against plain path, float32, noise off
    plan = epoch_indices(TRAIN_N, BATCH, rng=np.random.default_rng(0), shuffle=True,
                         pad="drop")
    plan = np.concatenate([plan, plan])[:TRAJ_STEPS]
    got, want = _trajectory("kernel", data, plan), _trajectory("plain", data, plan)
    rel = float((np.abs(got - want) / np.abs(want)).max())
    log(f"train-trajectory float32, {TRAJ_STEPS} steps: kernel {got.tolist()}")
    log(f"train-trajectory float32, {TRAJ_STEPS} steps: plain  {want.tolist()}")
    log(f"train-trajectory: max relative difference {rel:.3e} (tol {TRAJ_RTOL})")
    if not (np.isfinite(got).all() and rel <= TRAJ_RTOL):
        raise AssertionError(f"kernel path's losses leave the plain path's: {rel}")

    # whole-model parameter gradients on one batch, float32, noise off
    want = _param_grads("plain", take(data, torch.from_numpy(plan[0]).to(DEVICE)))
    errs = {}
    for path in ("kernel", WRONG_DQ):
        got = _param_grads(path, take(data, torch.from_numpy(plan[0]).to(DEVICE)))
        if sorted(got) != sorted(want):
            raise AssertionError(f"{path} path: gradients of {sorted(set(got) ^ set(want))}")
        worst, errs[path] = _grad_error(got, want)
        log(f"train-grads float32, {len(want)} parameters: {path} path, worst "
            f"max|diff|/max|plain| {errs[path]:.3e} at {worst} (tol {GRAD_RTOL})")
    if errs["kernel"] > GRAD_RTOL:
        raise AssertionError(f"kernel path's gradients leave the plain path's: {errs}")
    if errs[WRONG_DQ] <= GRAD_RTOL:
        raise AssertionError(f"the gradient check cannot see a 1% error in dq: {errs}")
    return fwd_launches, bwd_launches


def _kind(name):
    """Kind of a device op, by its kernel name."""
    n = name.lower()
    for word, kind in (("flash_attention_fwd", "flash forward"),
                       ("flash_attention_bwd_dq", "flash backward dq"),
                       ("flash_attention_bwd_dkdv", "flash backward dk/dv"),
                       ("gemm", "GEMM"), ("cutlass", "GEMM"), ("xmma", "GEMM"),
                       ("sm90", "GEMM"), ("gemv", "GEMM"), ("softmax", "softmax"),
                       ("reduce", "reductions"), ("multi_tensor", "RAdam (foreach)"),
                       ("foreach", "RAdam (foreach)"), ("memcpy", "copies, casts"),
                       ("copy", "copies, casts"), ("cast", "copies, casts"),
                       ("elementwise", "elementwise"), ("vectorized", "elementwise"),
                       ("index", "index, gather")):
        if word in n:
            return kind
    return "other"


def _profile_steps(path, batch):
    """torch.profiler over PROFILED_STEPS train steps after 3 warm-up steps;
    returns (device ms, trace wall ms, host-clock ms) per step, the idle
    share, device ops per step and device ms per step by kind."""
    model = _train_model("bfloat16")
    opt, _ = build_optimizer(model.named_parameters(), lr=5e-4)
    state = TrainState(model, opt)
    step = make_train_step(model, noise_level_mag=1.0)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    with _attention_path(path):
        for _ in range(3):
            step(state, batch, gen)
        torch.cuda.synchronize()
        # device activity only: recording ~3,000 host ops per step would
        # stretch the host's share of the wall the idle share is read from
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                step(state, batch, gen)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    if not dev:
        raise AssertionError(f"{path} path: the trace holds no device op")
    busy, lo, hi = 0.0, dev[0][0], dev[0][1]
    for s0, s1, _ in dev[1:]:  # the union of device intervals
        if s0 > hi:
            busy, lo = busy + hi - lo, s0
        hi = max(hi, s1)
    busy += hi - lo
    wall = hi - dev[0][0]
    kinds = {}
    for s0, s1, name in dev:
        kinds[_kind(name)] = kinds.get(_kind(name), 0.0) + (s1 - s0) / 1e3 / PROFILED_STEPS
    return (busy / 1e3 / PROFILED_STEPS, wall / 1e3 / PROFILED_STEPS, host_ms,
            1 - busy / wall, len(dev) / PROFILED_STEPS, kinds)


def phase_profile():
    ds = make_synthetic_dataset(n=BATCH, n_max_lc=LC_LEN, nband=NBAND,
                                n_max_sp=TRAIN_SP_LEN, seed=0)
    batch = ds.to_device(DEVICE)
    for path in ("kernel", "plain"):
        device_ms, wall_ms, host_ms, idle, ops, kinds = _profile_steps(path, batch)
        log(f"profile {path}: {PROFILED_STEPS} train steps at B={BATCH} bf16 under "
            f"torch.profiler: device {device_ms:.3f} ms/step, trace wall "
            f"{wall_ms:.3f} ms/step (host clock {host_ms:.3f}), device idle share "
            f"{idle:.3f}, {ops:.0f} device ops/step")
        for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
            log(f"profile {path}:   {kind:22s} {ms:8.3f} ms/step "
                f"({100 * ms / device_ms:.1f}% of device time)")


def main():
    card = phase_device()
    phase_build()
    max_err, timing = phase_kernel()
    bwd_err, bwd_timing = phase_kernel_bwd()
    serve_launches = phase_serve()
    train_fwd, train_bwd = phase_train()
    phase_profile()
    log(f"kernels line: forward ms/plain_ms at the spectral serving shape "
        f"(256, 2, 1024, 16), backward at the spectral training shape "
        f"(256, 2, 220, 16), bfloat16; forward launches are serve "
        f"({serve_launches}) + train ({train_fwd}); card {card}")
    measured = {  # name: (launches, max_abs_err, (ms, plain_ms))
        "flash_attention_fwd": (serve_launches + train_fwd, max_err,
                                timing[("sp", "bfloat16")]),
        "flash_attention_bwd": (train_bwd, bwd_err, bwd_timing["sp"]),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": measured[name][0], "max_abs_err": measured[name][1],
         "ms": measured[name][2][0], "plain_ms": measured[name][2][1]}
        for name, (source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
