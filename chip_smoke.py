#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU: the maven-lite embedding
server and the maven-lite contrastive trainer end to end, through the
hand-written flash-attention kernels (forward and backward; bf16 on the
tensor-core route, float32 on the CUDA-core route), and the same server and
trainer under ``use_fused_block``, through the fused-block kernels (forward
and backward) as well, and under ``MMSN_FUSED_QKV=1``, through the
whole-SelfAttention kernels (forward and backward; bf16 on the tensor-core
route, float32 on the CUDA-core route).

  python3 chip_smoke.py        # from the repository root, one GPU

Phases (each prints a progress line; any failure raises, exit code != 0):
  1. device: CUDA must be present; prints the card's name and power limit
     (nvidia-smi), reads its SM count and maximum SM clock (the
     exponential floor beside the flash bounds), turns TF32 off for
     float32 matmuls and convolutions and prints the float32 matmul
     precision;
  2. build: compiles the eleven csrc/*.cu sources (flash_attention_fwd,
     flash_attention_bwd and their tensor-core versions
     flash_attention_{fwd,bwd}_mma, fused_ffn_fwd and its tensor-core
     version fused_ffn_fwd_mma, fused_ffn_bwd,
     fused_qkv_fwd, fused_qkv_bwd and their tensor-core versions
     fused_qkv_{fwd,bwd}_mma) with nvcc for sm_90a, one nvcc each, all
     started together, and echoes ptxas's entry, register and spill lines;
  3. kernel: the forward kernels against their plain version
     (dense_attention) on the card, float32 (atol = rtol = 1e-4: another
     summation order and the online rescale) and bfloat16 (0.05, and the
     normalised error ||got - want|| / ||want|| within NORM_TOL, which sees
     an output 1% off where 0.05 absolute cannot), at the
     light-curve (256, 8, 200, 8) and spectral (256, 2, 1024, 16) serving
     shapes in the encoder's layout and contiguous, T = 220, a batch with a
     fully masked row and leading masked key tiles, key_mask=None, ragged
     T = 1 and T = 77 at head dims 8 and 16, and the other head dims. Every
     bf16 case at head dim 8 or 16 runs on both routes (the tensor cores as
     routed, the CUDA cores through a patch of flash_attention._route) and
     must show one tensor-core launch on the first; every other case runs
     on the CUDA cores. Then times the routes at the two serving shapes
     (CUDA events, median of 25; and the wrapper's host time a call,
     perf_counter around a call made on an idle card, median of 50), the
     plain version, and
     F.scaled_dot_product_attention (scale emb**-0.5, boolean key mask) as
     the library yardstick (timed only; it differs on fully masked rows,
     where it gives NaN);
  4. kernel-bwd: the backward kernels' dq/dk/dv against torch autograd
     through dense_attention on the card, float32 (atol = rtol = 5e-4, the
     JAX kernel tests' gradient tolerance) and bfloat16 (0.05 and NORM_TOL
     on each of dq, dk, dv whose plain value is not all zero), at the cases
     of phase 3 with SP at the training T = 220, plus SP T = 1024, both
     routes as in phase 3 from one forward's output and stats (either
     forward feeds either backward); a fully masked row must give dq = dk =
     0 and dv != 0; at LC and SP the tensor-core dq x 0.99 (_wrong_dq) must
     fail the NORM_TOL check. Then times both routes (and their host time
     a call, as in phase 3), the plain backward and the
     autograd backward of F.scaled_dot_product_attention at LC and SP, bf16
     (CUDA events, median of 25), and, beside the events, each kernel's and
     the library call's device time (the sum of their device kernels under
     torch.profiler over 25 calls), which the host's pace does not move;
  4b. kernel-ffn: the fused-block forward kernel against its plain version
     (fused_ffn_block_plain) and the backward kernel against
     fused_ffn_block_bwd_plain, on the card, at the light-curve tower's rows
     (N = 256 x 200 = 51,200, E = 64, F = 256), at a ragged N (51,163) and
     at E = 128, F = 512, float32 and bfloat16. Every float32 forward runs on
     both routes (the 3xTF32 tensor cores as routed, the CUDA cores through
     a patch of fused_block._route) and must show one launch on its route
     and none on the other; bfloat16 runs on the CUDA cores. Forward: atol =
     rtol = 1e-4 in float32, and the normalised error within FP32_NORM_TOL
     (1e-5), which the plain version with TF32 matmuls must fail (the
     control); 0.05 in bfloat16. Backward: each output within 5e-4 of its
     largest in float32 (the JAX fused tests use 2e-4 against XLA; here the
     weight gradients are sums over 51,200 rows taken in block partials,
     another order than the plain version's matrix products), 0.05 in
     bfloat16. Times the forward of each route, the plain version and the
     backward at the LC shape in both dtypes (CUDA events, median of 25),
     and in float32 each forward route's device time (profiler sums over 25
     calls) and the tensor-core forward's device time at 1, 2 and 3 full
     waves of blocks (a diagnostic: it logs, it checks nothing);
  4c. kernel-qkv: the fused-QKV forward kernels against their plain version
     (fused_qkv_attention_plain) and the backward kernels (dx, dWqkv, dWu,
     dbu) against fused_qkv_attention_bwd_plain, on the card, float32 on the
     CUDA cores (forward atol = rtol = 1e-4; each gradient within 5e-4 of
     its largest) and bfloat16 on both routes (the tensor cores as routed,
     the CUDA cores through a patch of qkv_attention._route; 0.05, and
     every output within NORM_TOL in the normalised error), at LC (B, T, E,
     H) = (256, 200, 64, 8), SP (256, 220, 32, 2), a ragged T = 37, T = 256
     (the limit) at both widths, a batch with a fully masked sample, and
     mask=None; each call must show its route's launches. At LC and SP the
     tensor-core dWqkv with its query third x 0.99 must fail the NORM_TOL
     check. Times (bf16, CUDA events, median of 25) the kernels of both
     routes (and the wrappers' host time a call, as in phase 3) and the
     plain versions at LC and SP, and the SelfAttention module forward and
     forward + backward on the unfused route (three F.linear, the flash
     kernels, F.linear) and under the opt-in. The library yardstick is
     F.multi_head_attention_forward
     (packed in-projection without bias, key_padding_mask, biased
     out-projection; the q rows of the packed weight times sqrt(head dim) so
     that its scores equal the kernel's), forward and autograd backward,
     on bf16 copies of the weights and x in its (T, B, E) layout, both made
     outside the timed region. It is timed and held to the plain versions
     off fully masked samples (where it gives NaN), and called nowhere in
     the port;
  5. serve: a maven-lite CLIPModel with seeded random weights (bf16
     compute) is written as a run directory, served by load_live +
     EmbedServer on 127.0.0.1, and sent concurrent npz and JSON requests of
     1, 37, 256 and 300 samples. Checks: every status 200, (n, 32) finite
     unit-norm embeddings per modality, 18 tensor-core flash launches per
     device call and no plain attention call, answers within SERVE_TOL
     (0.02) of the same model run through the plain attention on the card.
     Times the device call on the tensor-core and the CUDA-core route in
     alternating rounds (host clock, medians of 10) and profiles 5 device
     calls on each (device time, idle share, time by kind of kernel);
  5b. serve-fused: the same, with the run directory's transformer_kwargs
     carrying use_fused_block: true: the LC tower's 5 blocks (E = 64) run
     fused, in float32 (the band embedding promotes them), the SP tower's 13
     (E = 32) unfused. Checks 5 fused forward launches, all on the tensor
     cores (3xTF32), and 18 flash forward launches
     (5 float32 on the CUDA cores, 13 bf16 on the tensor cores) per device
     call, no plain call of either, and answers equal to the same
     model through the plain versions of all kernels (SERVE_TOL);
  5c. serve-qkv: phase 5 with MMSN_FUSED_QKV=1 set for the phase and
     restored after: the LC tower's 5 layers (T = 200) take the tensor-core
     fused-QKV forward kernel, the SP tower's 13 (T = 1024 > 256) fall back
     to the flash forward kernel (tensor cores). Checks 5 + 13 launches per
     device call, no plain
     call, and answers within SERVE_TOL of the same model through the plain
     versions of all kernels;
  6. train: maven-lite at bench.py's shapes (B = 256, T_lc = 2 x 100,
     T_sp = 220, bf16, lr 5e-4, noise_level_mag 1.0, dropout 0) on the
     2048-sample synthetic set, through Trainer.fit for 3 epochs. Checks:
     every loss finite, AUC_val in [0, 1], 18 forward and 18 backward
     tensor-core flash launches per train step (18 forward per eval step)
     and no plain attention call. Then, from the same seeded float32 weights
     (the CUDA-core route) with the
     noise off, 12 steps on the kernel path and 12 on the plain path over
     one index plan: the per-step losses agree to relative 1e-5 (sound runs
     differ by about 1e-7: summation order). At lr 5e-4 the loss moves
     too little for this to see a wrong backward, so every parameter's
     gradient of one float32 loss is held against the plain path's too,
     max|diff| / max|plain| <= 5e-4 per parameter (the gradient tolerance;
     the denominator floored at 1e-3 of the model's largest gradient); the
     kernel path with every dq off by 1% must fail that check. Those float32
     runs count their launches too: every kernel on the CUDA cores, none on
     the plain path;
  6a. grad-probe: every attention call of one float32 loss on the plain
     path is recorded with its cotangent, and each layer's dq, dk, dv from
     the CUDA-core flash backward and from dense_attention's autograd are
     read against a float64 reference on those inputs, beside the plain
     backward's dq with D = g.out and with rowsum(P o dP) (a diagnostic:
     it logs, it checks nothing);
     Prints the median train-step time and paired samples/s of the kernel
     path, the plain path and the kernel path on the CUDA-core route (bf16,
     the same batch, host clock around synchronised steps, alternating
     rounds of 20 steps each: three of the plain path, seven of each flash
     route) and their peak device memory;
  6b. train-fused: the same trainer with use_fused_block in the LC tower's
     kwargs: 5 fused forward (all on the tensor cores) + 5 fused backward +
     18 flash forward + 18 flash backward launches per train step (5 + 18
     forward per eval step), no plain call; the float32 trajectory and
     gradient runs take the tensor-core fused forward too (5 a step), their
     plain path none. The trajectory and gradient checks of phase 6 hold the
     fused kernel path against the fused path through the plain versions of
     all four kernels; the gradient check must fail when the fused
     backward's ff.0 weight gradient is scaled by 0.99. Flash launches: the
     5 float32 LC layers on the CUDA cores, the 13 SP on the tensor cores.
     Times train steps
     and peak memory, fused ("fused") against unfused ("kernel"), both on
     the kernel path, and the fused path with its forward on the CUDA cores
     ("fused-simt");
  6c. train-qkv: the same trainer under MMSN_FUSED_QKV=1: 18 tensor-core
     fused-QKV forward + 18 backward launches and no flash launch per train
     step (18 forward per eval step), no plain call. The float32 trajectory
     and gradient checks (on the CUDA-core QKV kernels, counted) hold the
     fused-QKV kernel path against the same path through the plain
     versions; the gradient check must fail when the query third of every
     layer's dWqkv is scaled by 0.99. Times train steps and peak memory, the
     opt-in ("qkv") against the unfused kernel route ("kernel") and the
     opt-in on the CUDA-core QKV kernels ("qkv-simt");
  7. profile: torch.profiler (device activity) over 5 train steps of each
     path (kernel, kernel-simt: the kernel path on the CUDA-core route,
     plain, fused, fused-simt: the fused path with its forward on the CUDA
     cores, qkv, qkv-simt: the opt-in on the CUDA-core QKV kernels;
     bf16, one batch, after 3 warm-up steps):
     device time per step
     (the union of device ops), the trace's wall per step (first device
     op's start to the last one's end), one minus their ratio as the device
     idle share, device ops per step, and device time by kind of kernel
     (flash forward, dq, dk/dv, GEMMs, reductions, ...).

Prints, before the last line, one JSON object {"kernels": [...]} with the
measured numbers, the shape they were timed at ("shape"; launches are summed
over every shape the main paths gave the kernel: the serve phases' requests,
and of the train phases Trainer.fit, the timed train-step rounds (the
CUDA-core route patches included) and the float32 trajectory and gradient
runs; the flash and fused-QKV
entries carry the times and bound at their second shape under "also_at"; the
fused-QKV entries add their and the library call's device time, "device_ms"
and "library_device_ms", and the wrapper's host time a call, "host_ms")
and each kernel's bound (the larger of its bytes over
3.35 TB/s and its operations over the peak for its input type: 989 TFLOP/s
for bfloat16 on the tensor cores, 67 TFLOP/s for float32 on the CUDA cores,
TF32 being off, and for the 3xTF32 fused forward three times its operations
at 495 TFLOP/s); the flash backward and fused forward entries add
"device_ms" (profiler sums), the flash backward "library_device_ms", the
fused forward "norm_err" (float32, its route's worst case). The "bounds" log lines add the flash
kernels' exponential floor (their exponentials alone at the MUFU pipes'
rate). The last line is {"ok": true,
"device": {...}}.
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
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import multimodal_supernovae_tpu_torch.models.transformer as transformer_mod
import multimodal_supernovae_tpu_torch.ops.flash_attention as flash_mod
import multimodal_supernovae_tpu_torch.ops.fused_block as ffn_mod
import multimodal_supernovae_tpu_torch.ops.qkv_attention as qkv_mod
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
    "flash_attention_fwd_mma": ("multimodal_supernovae_tpu_torch/csrc/flash_attention_fwd_mma.cu",
                                "multimodal_supernovae_tpu/ops/pallas_attention.py:85"),
    "flash_attention_bwd_mma": ("multimodal_supernovae_tpu_torch/csrc/flash_attention_bwd_mma.cu",
                                "multimodal_supernovae_tpu/ops/pallas_attention.py:108"),
    "fused_ffn_fwd": ("multimodal_supernovae_tpu_torch/csrc/fused_ffn_fwd.cu",
                      "multimodal_supernovae_tpu/ops/fused_block.py:86"),
    "fused_ffn_fwd_mma": ("multimodal_supernovae_tpu_torch/csrc/fused_ffn_fwd_mma.cu",
                          "multimodal_supernovae_tpu/ops/fused_block.py:86"),
    "fused_ffn_bwd": ("multimodal_supernovae_tpu_torch/csrc/fused_ffn_bwd.cu",
                      "multimodal_supernovae_tpu/ops/fused_block.py:102"),
    "fused_qkv_fwd": ("multimodal_supernovae_tpu_torch/csrc/fused_qkv_fwd.cu",
                      "multimodal_supernovae_tpu/ops/qkv_attention.py:115"),
    "fused_qkv_bwd": ("multimodal_supernovae_tpu_torch/csrc/fused_qkv_bwd.cu",
                      "multimodal_supernovae_tpu/ops/qkv_attention.py:147"),
    "fused_qkv_fwd_mma": ("multimodal_supernovae_tpu_torch/csrc/fused_qkv_fwd_mma.cu",
                          "multimodal_supernovae_tpu/ops/qkv_attention.py:115"),
    "fused_qkv_bwd_mma": ("multimodal_supernovae_tpu_torch/csrc/fused_qkv_bwd_mma.cu",
                          "multimodal_supernovae_tpu/ops/qkv_attention.py:147"),
}
TOL = {"float32": 1e-4, "bfloat16": 0.05}
GRAD_TOL = {"float32": 5e-4, "bfloat16": 0.05}
# bf16 flash outputs (out, dq, dk, dv) against the plain version on the same
# inputs: ||got - want|| / ||want||. At SP the values are about 0.05 in size,
# so the 0.05 absolute limit above passes an output 20% off; this one fails
# one 1% off. Sound runs read at most 3.8e-3 on either route (dq, dk; out
# 3.2e-3), the tensor-core dq x 0.99 1.07e-2 (PERF.md section 6).
NORM_TOL = 6e-3
# float32 fused-block forward against its plain version on the same inputs:
# ||got - want|| / ||want||. A CPU model of the kernel's arithmetic at the LC
# widths reads 2.2e-7 with 3xTF32 products and 3.2e-4 with one TF32 product
# (tests/test_torch_fused_block_kernel.py); the plain version with TF32
# matmuls must fail it.
FP32_NORM_TOL = 1e-5
# served vs plain-version embeddings, every serve phase; sound runs read 6.6e-3
SERVE_TOL = 0.02
TRAJ_RTOL, GRAD_RTOL = 1e-5, 5e-4
WRONG_DQ = "kernel, dq x 0.99"
WRONG_DWF1 = "fused, ff.0 weight grad x 0.99"
WRONG_DWQ = "qkv, query third of dWqkv x 0.99"
# H100 SXM published peaks (NVIDIA's datasheet), at a 700 W limit
PEAK_BYTES_S = 3.35e12
# "tf32x3": 495 TFLOP/s of TF32 over the three products of each 3xTF32 one
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
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
FUSED_PER_CALL = SEQ_LC["depth"]  # E = 64 blocks; the SP tower (E = 32) stays unfused
FFN_E, FFN_F = SEQ_LC["emb"], 4 * SEQ_LC["emb"]
FFN_ROWS = BATCH * NBAND * LC_LEN  # the LC tower's (B * T) rows
# (B, T, E, heads) of the two towers' SelfAttention at the training shapes
QKV_LC = (BATCH, NBAND * LC_LEN, SEQ_LC["emb"], SEQ_LC["heads"])
QKV_SP = (BATCH, TRAIN_SP_LEN, SEQ_SP["emb"], SEQ_SP["heads"])
COUNT_NAMES = ("(flash fwd CUDA cores, flash bwd CUDA cores, flash fwd tensor cores, "
               "flash bwd tensor cores, ffn fwd CUDA cores, ffn bwd, qkv fwd CUDA cores, qkv "
               "bwd CUDA cores, qkv fwd tensor cores, qkv bwd tensor cores, ffn fwd tensor "
               "cores)")
# MUFU exponentials a clock on one SM (16), for the exponential floor beside
# the flash kernels' bound
EXP_PER_CLOCK_SM = 16


_T0 = time.perf_counter()


def log(msg: str):
    print(f"[chip_smoke +{time.perf_counter() - _T0:.1f}s] {msg}", flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp_per_s = EXP_PER_CLOCK_SM * sms * float(clock.stdout.split()[0]) * 1e6
    log(f"device: {sms} SMs, max SM clock {clock.stdout.strip()} MHz: "
        f"{exp_per_s:.3e} exponentials/s on the MUFU pipes")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: float32 matmul precision {torch.get_float32_matmul_precision()!r}, "
        f"TF32 in matmuls {torch.backends.cuda.matmul.allow_tf32}, in convolutions "
        f"{torch.backends.cudnn.allow_tf32}")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return card, exp_per_s


def phase_build():
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        seconds = dict(zip(KERNELS, pool.map(build, KERNELS)))
    for name, (source, _) in KERNELS.items():
        log(f"build: nvcc {source} -> sm_90a in {seconds[name]:.2f} s")
        for line in library_path(name).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s wall")


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


def _host_ms(fn, iters=50):
    """ms of host time a call of ``fn`` (its wrapper up to the launch):
    perf_counter around each call, each made on an idle card; median."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def _norm_err(got, want):
    """||got - want|| / ||want|| in float64; None where the plain output is
    exactly zero (dq and dk at T = 1), which the elementwise limit covers."""
    norm = float(torch.linalg.vector_norm(want.double().flatten()))
    diff = float(torch.linalg.vector_norm((got.double() - want.double()).flatten()))
    return diff / norm if norm else None


def _check_norm(got, want, what):
    """The normalised error of a bf16 output (None where the plain output is
    zero); raises above NORM_TOL."""
    err = _norm_err(got, want)
    if err is not None and not err <= NORM_TOL:
        raise AssertionError(f"{what}: ||got - want|| / ||want|| {err:.3e} (tol {NORM_TOL})")
    return err


def _fmt(err):
    return "n/a" if err is None else f"{err:.3e}"


def _bound(flops, nbytes, dtype_name):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations over the peak for the
    input type."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_OPS_S[dtype_name] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sdpa(q, k, v, mask, emb):
    """The library call computing the same attention (timed only: it gives
    NaN where every key of a row is masked, the port uniform weights)."""
    m = None if mask is None else mask[:, None, None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=emb ** -0.5)


@contextlib.contextmanager
def _simt_route():
    """Every flash call of the block on the CUDA-core kernels: ``_route``
    patched (a test-time patch, no user knob)."""
    with mock.patch.object(flash_mod, "_route", lambda *a: "simt"):
        yield


ROUTES = {"mma": contextlib.nullcontext, "simt": _simt_route}


def _routes(dtype, s, tensors):
    """The routes a case is checked on: both where ``_route`` takes the
    tensor cores, the CUDA cores alone elsewhere."""
    return ("mma", "simt") if flash_mod._route(dtype, s, tensors) == "mma" else ("simt",)


def _device_ms(fn, iters=25):
    """ms of device time a call of ``fn``: the sum of its device ops'
    durations under torch.profiler over ``iters`` calls, after a warm-up.
    Unlike CUDA events around a call, it leaves out the host's pace."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return us / 1e3 / iters


def _flash_cases(mask_lc, mask_sp, t_sp):
    """(name, (B, H, T, S), mask, encoder layout) of the flash checks: the
    two towers' shapes in the encoder's layout and contiguous, a fully
    masked row with leading masked key tiles, no mask, ragged T = 1 and 77
    at both head dims, and the CUDA-core kernels' other head dims."""
    masked = mask_sp[:16].clone()
    masked[0] = False          # a fully masked row: uniform over its T keys
    masked[1, :100] = False    # leading key tiles masked, later ones valid
    m77 = mask_sp[:16, :77].clone()
    m77[0] = False
    m77[1, :40] = False
    return [
        ("lc", (BATCH, 8, 2 * LC_LEN, 8), mask_lc, True),
        ("lc_contig", (BATCH, 8, 2 * LC_LEN, 8), mask_lc, False),
        ("sp", (BATCH, 2, t_sp, 16), mask_sp[:, :t_sp].contiguous(), True),
        ("sp_contig", (BATCH, 2, 220, 16), mask_sp[:, -220:].contiguous(), False),
        ("masked_rows", (16, 2, SP_LEN, 16), masked, False),
        ("no_mask", (BATCH, 8, 2 * LC_LEN, 8), None, True),
        ("t1_s8", (16, 8, 1, 8), mask_lc[:16, :1].contiguous(), True),
        ("t1_s16", (16, 2, 1, 16), None, False),
        ("t77_s8", (16, 8, 77, 8), m77, False),
        ("t77_s16", (16, 2, 77, 16), m77, True),
        ("s32", (8, 2, 77, 32), mask_sp[:8, :77].contiguous(), False),
    ]


def phase_kernel():
    """The forward kernels of both routes against dense_attention; times at
    the serving shapes. Returns ({route: max|err|}, {(case, dtype): times})."""
    flash_attention = flash_mod.flash_attention
    syn = make_synthetic_arrays(n=BATCH, n_max_lc=LC_LEN, nband=NBAND,
                                n_max_sp=SP_LEN, seed=0)
    mask_lc = torch.from_numpy(syn["mask_lc"]).cuda()
    mask_sp = torch.from_numpy(syn["mask_sp"]).cuda()
    cases = _flash_cases(mask_lc, mask_sp, SP_LEN) + [
        ("s64", (8, 1, 77, 64), mask_sp[:8, -77:].contiguous(), False)]
    gen = torch.Generator().manual_seed(0)
    max_err = {"mma": 0.0, "simt": 0.0}
    norm_err = {"mma": 0.0, "simt": 0.0}
    timing = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for name, (b, h, t, s), mask, layout in cases:
            q, k, v = _heads(gen, b, h, t, s, dtype, layout)
            emb = h * s
            want = dense_attention(q, k, v, mask, emb)
            routes = _routes(dtype, s, (q, k, v))
            for route in routes:
                before = flash_attention.mma_launches
                with ROUTES[route]():
                    got = flash_attention(q, k, v, mask, emb)
                torch.cuda.synchronize()
                if flash_attention.mma_launches - before != (route == "mma"):
                    raise AssertionError(f"{name} {dtype_name}: not on the {route} route")
                if got.dtype != dtype or got.shape != want.shape:
                    raise AssertionError(f"{name} {dtype_name}: got {got.dtype} "
                                         f"{tuple(got.shape)}")
                err = float((got.float() - want.float()).abs().max())
                max_err[route] = max(max_err[route], err)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=TOL[dtype_name], atol=TOL[dtype_name],
                                           msg=lambda m: f"{name} {dtype_name} {route}: {m}")
                norm = ""
                if dtype == torch.bfloat16:
                    rel = _check_norm(got, want, f"{name} {dtype_name} {route}")
                    norm_err[route] = max(norm_err[route], rel or 0.0)
                    norm = f", ||err||/||plain|| {_fmt(rel)} (tol {NORM_TOL})"
                log(f"kernel {name} {dtype_name} {(b, h, t, s)} {route}: max|err| "
                    f"{err:.3e} (tol {TOL[dtype_name]}){norm}")
            if name in ("lc", "sp"):
                times = {}
                for route in routes:
                    with ROUTES[route]():
                        times[route] = _time_ms(lambda: flash_attention(q, k, v, mask, emb))
                        times[f"{route}_host"] = _host_ms(
                            lambda: flash_attention(q, k, v, mask, emb))
                times["plain"] = _time_ms(lambda: dense_attention(q, k, v, mask, emb))
                times["library"] = _time_ms(lambda: _sdpa(q, k, v, mask, emb))
                timing[(name, dtype_name)] = times
                log(f"time {name} {dtype_name} {(b, h, t, s)}: "
                    + ", ".join(f"{r} {ms:.4f} ms" for r, ms in times.items())
                    + " (library: scaled_dot_product_attention; *_host: the wrapper's "
                    "host time a call on an idle card, median of 50)")
            del q, k, v, got, want
    torch.cuda.empty_cache()
    log(f"kernel: bf16 ||err||/||plain|| largest over the cases: " + ", ".join(
        f"{r} {e:.3e}" for r, e in norm_err.items()) + f" (tol {NORM_TOL})")
    return max_err, timing


def _seq_lc(fused):
    return {**SEQ_LC, "use_fused_block": True} if fused else SEQ_LC


def _run_dir(tmp, fused=False):
    cfg = CLIPConfig.create(
        combinations=("lightcurve", "spectral"), enc_dim=32, nband=NBAND,
        logit_scale_init=19.55, loss="softmax", transformer_kwargs=_seq_lc(fused),
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
    """The backward kernels of both routes against torch autograd through
    dense_attention (from one forward's output and stats: either forward
    feeds either backward); times at the training shapes. Returns ({route:
    max|err|}, {case: times})."""
    fwd, bwd = flash_mod._flash_fwd, flash_mod.flash_attention_bwd
    syn = make_synthetic_arrays(n=BATCH, n_max_lc=LC_LEN, nband=NBAND,
                                n_max_sp=SP_LEN, seed=2)
    mask_lc = torch.from_numpy(syn["mask_lc"]).cuda()
    mask_sp = torch.from_numpy(syn["mask_sp"]).cuda()
    cases = _flash_cases(mask_lc, mask_sp, TRAIN_SP_LEN) + [
        ("sp_t1024", (BATCH, 2, SP_LEN, 16), mask_sp, True)]
    gen = torch.Generator().manual_seed(1)
    max_err = {"mma": 0.0, "simt": 0.0}
    norm_err = {"mma": 0.0, "simt": 0.0}
    control = {}
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
            want = dense_attention_bwd(q, k, v, mask, g, emb)
            routes = _routes(dtype, s, (q, k, v, out, g))
            for route in routes:
                before = flash_mod.flash_attention_bwd.mma_launches
                with ROUTES[route]():
                    got = bwd(q, k, v, mask, out, stats, g, emb)
                torch.cuda.synchronize()
                if flash_mod.flash_attention_bwd.mma_launches - before != (route == "mma"):
                    raise AssertionError(f"{name} {dtype_name}: not on the {route} route")
                errs, norms = [], []
                for gname, a, w in zip(("dq", "dk", "dv"), got, want):
                    if a.dtype != dtype or a.shape != q.shape:
                        raise AssertionError(f"{name} {dtype_name} {gname}: {a.dtype} "
                                             f"{tuple(a.shape)}")
                    errs.append(float((a.float() - w.float()).abs().max()))
                    torch.testing.assert_close(
                        a.float(), w.float(), rtol=tol, atol=tol,
                        msg=lambda m: f"{name} {dtype_name} {route} {gname}: {m}")
                    if dtype == torch.bfloat16:
                        norms.append(_check_norm(a, w, f"{name} {dtype_name} {route} {gname}"))
                if (name in ("masked_rows", "t77_s8", "t77_s16")
                        and (got[0][0].any() or got[1][0].any() or not got[2][0].any())):
                    raise AssertionError(f"{name} {route}: fully masked row: want dq = dk = 0, "
                                         "dv != 0")
                max_err[route] = max(max_err[route], *errs)
                norm = ""
                if norms:
                    norm_err[route] = max(norm_err[route], *(e or 0.0 for e in norms))
                    norm = (f"; ||err||/||plain|| dq {_fmt(norms[0])} dk {_fmt(norms[1])} "
                            f"dv {_fmt(norms[2])} (tol {NORM_TOL})")
                log(f"kernel-bwd {name} {dtype_name} {(b, h, t, s)} {route}: max|err| dq "
                    f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (tol {tol}){norm}")
                if route == "mma" and name in ("lc", "sp"):
                    # negative control: the tensor-core dq off by 1% must fail
                    with _wrong_dq() as wrong_bwd:
                        wrong = wrong_bwd(q, k, v, mask, out, stats, g, emb)
                    if wrong_bwd.mma_launches != 1:
                        raise AssertionError(f"{name}: the control left the tensor cores")
                    control[name] = _norm_err(wrong[0], want[0])
                    log(f"kernel-bwd {name} {dtype_name} {WRONG_DQ}: ||err||/||plain|| dq "
                        f"{control[name]:.3e} (must exceed {NORM_TOL})")
                    if control[name] <= NORM_TOL:
                        raise AssertionError(f"{name}: the normalised check cannot see a 1% "
                                             f"error in dq: {control[name]:.3e}")
            if name in ("lc", "sp") and dtype_name == "bfloat16":
                times = {}
                for route in routes:
                    with ROUTES[route]():
                        times[route] = _time_ms(lambda: bwd(q, k, v, mask, out, stats, g, emb))
                        times[f"{route}_host"] = _host_ms(
                            lambda: bwd(q, k, v, mask, out, stats, g, emb))
                        times[f"{route}_device"] = _device_ms(
                            lambda: bwd(q, k, v, mask, out, stats, g, emb))
                leaves = [a.detach().requires_grad_() for a in (q, k, v)]
                plain_out = dense_attention(*leaves, mask, emb)
                times["plain"] = _time_ms(lambda: torch.autograd.grad(
                    plain_out, leaves, g, retain_graph=True))
                lib_out = _sdpa(*leaves, mask, emb)
                times["library"] = _time_ms(lambda: torch.autograd.grad(
                    lib_out, leaves, g, retain_graph=True))
                times["library_device"] = _device_ms(lambda: torch.autograd.grad(
                    lib_out, leaves, g, retain_graph=True))
                timing[name] = times
                log(f"time-bwd {name} {dtype_name} {(b, h, t, s)}: "
                    + ", ".join(f"{r} {ms:.4f} ms" for r, ms in times.items())
                    + " (plain: autograd of dense_attention; library: autograd of "
                    "scaled_dot_product_attention; *_device: the sum of its device "
                    "kernels under torch.profiler, 25 calls; *_host: the wrapper's host "
                    "time a call on an idle card, median of 50)")
                del leaves, plain_out, lib_out
            del q, k, v, g, out, stats, got, want
    torch.cuda.empty_cache()
    log(f"kernel-bwd: bf16 ||err||/||plain|| largest over the cases and dq/dk/dv: "
        + ", ".join(f"{r} {e:.3e}" for r, e in norm_err.items())
        + f" (tol {NORM_TOL}); {WRONG_DQ}: " + ", ".join(
            f"{n} {e:.3e}" for n, e in control.items()))
    return max_err, timing


def _ffn_inputs(gen, n, e, f, dtype):
    """att, x, the ten float32 parameters (a Linear's layout) and a
    cotangent, on the card."""
    def t(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to("cuda")

    params = [t(e, e, scale=e ** -0.5), t(e, scale=0.1), t(e, scale=0.1, shift=1.0),
              t(e, scale=0.1), t(f, e, scale=e ** -0.5), t(f, scale=0.1),
              t(e, f, scale=f ** -0.5), t(e, scale=0.1), t(e, scale=0.1, shift=1.0),
              t(e, scale=0.1)]
    return t(n, e).to(dtype), t(n, e).to(dtype), params, t(n, e).to(dtype)


@contextlib.contextmanager
def _ffn_simt_route():
    """Every fused-block forward of the block on the CUDA-core kernel:
    ``fused_block._route`` patched (a test-time patch, no user knob)."""
    with mock.patch.object(ffn_mod, "_route", lambda *a: "simt"):
        yield


FFN_ROUTES = {"mma": contextlib.nullcontext, "simt": _ffn_simt_route}


def _ffn_counts():
    """(CUDA-core, tensor-core) fused forward launches since _zero_counts."""
    c = ffn_mod.fused_ffn_block
    return c.launches - c.mma_launches, c.mma_launches


def phase_kernel_ffn():
    """The fused-block forward of both routes and the backward against their
    plain versions; the TF32 control; times at LC."""
    fwd, bwd = ffn_mod._ffn_fwd, ffn_mod.fused_ffn_block_bwd
    plain, plain_bwd = ffn_mod.fused_ffn_block_plain, ffn_mod.fused_ffn_block_bwd_plain
    eps = ffn_mod.LN_EPS
    cases = [("lc", FFN_ROWS, FFN_E, FFN_F), ("ragged", FFN_ROWS - 37, FFN_E, FFN_F),
             ("e128", FFN_ROWS // 4 - 5, 128, 512)]
    gen = torch.Generator().manual_seed(4)
    fwd_err, norm_err, bwd_err = {"mma": 0.0, "simt": 0.0}, {"mma": 0.0, "simt": 0.0}, 0.0
    timing = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for name, n, e, f in cases:
            att, x, params, g = _ffn_inputs(gen, n, e, f, dtype)
            want = plain(att, x, *params)
            routes = ("mma", "simt") if ffn_mod._route(dtype, e, f) == "mma" else ("simt",)
            if dtype == torch.float32 and routes != ("mma", "simt"):
                raise AssertionError(f"ffn {name} float32 (E, F) = {(e, f)}: not routed to "
                                     "the tensor cores")
            said = []
            for route in routes:
                with FFN_ROUTES[route]():
                    _zero_counts()
                    got = fwd(att, x, *params, eps=eps)
                    torch.cuda.synchronize()
                    counts = _ffn_counts()
                if counts != ((0, 1) if route == "mma" else (1, 0)):
                    raise AssertionError(f"ffn {name} {dtype_name} {route}: launches (CUDA "
                                         f"cores, tensor cores) {counts}")
                if got.dtype != dtype or got.shape != want.shape:
                    raise AssertionError(f"ffn {name} {dtype_name} {route}: {got.dtype} "
                                         f"{tuple(got.shape)}")
                err = float((got.float() - want.float()).abs().max())
                fwd_err[route] = max(fwd_err[route], err)
                torch.testing.assert_close(
                    got.float(), want.float(), rtol=TOL[dtype_name], atol=TOL[dtype_name],
                    msg=lambda m: f"ffn {name} {dtype_name} {route}: {m}")
                said.append(f"{route} max|err| {err:.3e}")
                if dtype == torch.float32:
                    ne = _norm_err(got, want)
                    norm_err[route] = max(norm_err[route], ne)
                    said[-1] += f", ||err||/||plain|| {ne:.3e}"
                    if not ne <= FP32_NORM_TOL:
                        raise AssertionError(f"ffn {name} float32 {route}: ||got - want|| / "
                                             f"||want|| {ne:.3e} (tol {FP32_NORM_TOL})")
                del got
            grads = bwd(att, x, *params, g)
            torch.cuda.synchronize()
            rel = []
            for i, (a, w) in enumerate(zip(grads, plain_bwd(att, x, *params, g))):
                if a.dtype != w.dtype or a.shape != w.shape:
                    raise AssertionError(f"ffn-bwd {name} {dtype_name} output {i}: "
                                         f"{a.dtype} {tuple(a.shape)}")
                d = float((a.float() - w.float()).abs().max())
                rel.append(d / float(w.float().abs().max()))
                bwd_err = max(bwd_err, d)
            log(f"kernel-ffn {name} {dtype_name} (N, E, F) = {(n, e, f)}: forward "
                f"{'; '.join(said)} (tol {TOL[dtype_name]}"
                + (f", FP32_NORM_TOL {FP32_NORM_TOL}" if dtype == torch.float32 else "")
                + f"); backward max|err|/max|plain| "
                f"per output {max(rel):.3e} worst, datt {rel[0]:.3e} dx {rel[1]:.3e} "
                f"dWu {rel[2]:.3e} dWf1 {rel[6]:.3e} dWf2 {rel[8]:.3e} "
                f"(tol {GRAD_TOL[dtype_name]})")
            if max(rel) > GRAD_TOL[dtype_name]:
                raise AssertionError(f"ffn-bwd {name} {dtype_name}: {rel}")
            if dtype == torch.float32 and name == "lc":
                # the control: TF32 matmuls in the plain version must fail the check
                saved = torch.backends.cuda.matmul.allow_tf32
                try:
                    torch.backends.cuda.matmul.allow_tf32 = True
                    control = _norm_err(plain(att, x, *params), want)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = saved
                log(f"kernel-ffn control: the plain version with TF32 matmuls, "
                    f"||err||/||plain|| {control:.3e} (must exceed {FP32_NORM_TOL})")
                if not control > FP32_NORM_TOL:
                    raise AssertionError(f"the float32 check cannot see TF32 rounding: {control}")
            if name == "lc":
                tm = {}
                for route in routes + routes[::-1]:  # mma, simt, simt, mma
                    with FFN_ROUTES[route]():
                        tm.setdefault(route, []).append(
                            _time_ms(lambda: fwd(att, x, *params, eps=eps)))
                        if dtype == torch.float32 and f"{route}_device" not in tm:
                            tm[f"{route}_device"] = _device_ms(
                                lambda: fwd(att, x, *params, eps=eps))
                for route in routes:
                    tm[route] = float(np.median(tm[route]))
                tm["plain"] = _time_ms(lambda: plain(att, x, *params))
                tm["bwd"] = _time_ms(lambda: bwd(att, x, *params, g))
                tm["bwd_plain"] = _time_ms(lambda: plain_bwd(att, x, *params, g))
                timing[dtype_name] = tm
                log(f"time-ffn lc {dtype_name} (N, E, F) = {(n, e, f)}: forward "
                    + ", ".join(f"{r} {tm[r]:.4f} ms" + (
                        f" (device {tm[r + '_device']:.4f} ms)" if r + "_device" in tm else "")
                        for r in routes)
                    + f", plain {tm['plain']:.4f} ms; backward kernel {tm['bwd']:.4f} ms, "
                    f"plain {tm['bwd_plain']:.4f} ms")
                if dtype == torch.float32:  # what the block count costs: whole waves
                    wave = (2 * torch.cuda.get_device_properties(0).multi_processor_count
                            * ffn_mod.MMA_ROWS)  # rows of one wave at 2 blocks an SM
                    waves = [_device_ms(lambda: fwd(att[:k * wave], x[:k * wave], *params,
                                                    eps=eps)) for k in (1, 2, 3)]
                    log(f"time-ffn waves, tensor cores float32: device {waves[0]:.4f} / "
                        f"{waves[1]:.4f} / {waves[2]:.4f} ms at 1 / 2 / 3 full waves of "
                        f"{wave} rows (two 64-row blocks an SM); LC is {n / wave:.3f} waves")
            del att, x, params, g, grads, want
    torch.cuda.empty_cache()
    return fwd_err, norm_err, bwd_err, timing


def _qkv_inputs(gen, b, t, e, dtype, mask):
    """x, the packed weight with the scaling folded in, wu, bu and a
    cotangent, on the card."""
    def n(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to("cuda")

    wqkv = n(3 * e, e, scale=e ** -0.5)
    wqkv[:2 * e] *= e ** -0.25
    return (n(b, t, e).to(dtype), mask, wqkv, n(e, e, scale=e ** -0.5), n(e, scale=0.1),
            n(b, t, e).to(dtype))


def _time_self_attention(shape, mask, dtype):
    """ms of the SelfAttention module at ``shape``, forward (no_grad) and
    forward + backward, on the unfused kernel route (three F.linear, the
    flash kernels, F.linear) and under MMSN_FUSED_QKV=1."""
    b, t, e, h = shape
    gen = torch.Generator().manual_seed(6)
    sa = transformer_mod.SelfAttention(e, h, dtype=dtype)
    transformer_mod.init_weights(sa, gen)
    sa.to(DEVICE)
    x = torch.randn((b, t, e), generator=gen).to(DEVICE, dtype).requires_grad_()
    g = torch.randn((b, t, e), generator=gen).to(DEVICE, dtype)

    def fwd():
        with torch.no_grad():
            sa(x, mask)

    def both():
        sa(x, mask).backward(g)

    out = {}
    for route, ctx in (("unfused", contextlib.nullcontext), ("qkv", _qkv_env),
                       ("qkv", _qkv_env), ("unfused", contextlib.nullcontext)):
        with ctx():
            if sa.fused_qkv(x) != (route == "qkv"):
                raise AssertionError(f"SelfAttention {shape}: wrong route for {route}")
            out.setdefault(route, []).append((_time_ms(fwd), _time_ms(both)))
    return {route: tuple(float(np.mean(c)) for c in zip(*v)) for route, v in out.items()}


def _mha_library(x, mask, wqkv, wu, bu, g, heads, want, want_grads):
    """Times of F.multi_head_attention_forward, the one PyTorch call
    computing the fused-QKV function: forward and autograd backward, by CUDA
    events and in device time (_device_ms); and its errors. It scales q by
    head_dim ** -0.5, so the packed weight's query rows are multiplied by
    sqrt(head dim) to give the kernel's scores. Weights and x are copied to
    the call's own dtype and (T, B, E) layout beforehand. Its forward and
    gradients are held to the plain versions' (``want``, ``want_grads``) at
    the bf16 tolerance, on the samples with a valid key: on a fully masked
    one it gives NaN."""
    b, t, e = x.shape
    w_in = wqkv.clone()
    w_in[:e] *= (e // heads) ** 0.5
    leaves = [a.detach().clone().requires_grad_() for a in
              (x.transpose(0, 1).contiguous(), w_in.to(x.dtype), wu.to(x.dtype),
               bu.to(x.dtype))]
    gt = g.transpose(0, 1).contiguous()
    pad = None if mask is None else ~mask

    def call():
        xt, w, wo, bo = leaves
        return F.multi_head_attention_forward(
            xt, xt, xt, e, heads, w, None, None, None, False, 0.0, wo, bo,
            training=False, key_padding_mask=pad, need_weights=False)[0]

    with torch.no_grad():
        out = call().transpose(0, 1)
    lib_out = call()
    grads = torch.autograd.grad(lib_out, leaves, gt, retain_graph=True)
    valid = torch.ones(b, dtype=torch.bool, device=x.device) if mask is None else mask.any(1)
    tol = GRAD_TOL["bfloat16"]
    torch.testing.assert_close(out[valid].float(), want[valid].float(), rtol=tol, atol=tol,
                               msg=lambda m: f"multi_head_attention_forward: {m}")
    dx, dw_in, dwu, dbu = grads
    dw_in = dw_in.float()
    dw_in[:e] *= (e // heads) ** 0.5   # d/d(wqkv query rows) from d/d(w_in query rows)
    pairs = [("dx", dx.transpose(0, 1)[valid], want_grads[0][valid])]
    if bool(valid.all()):
        pairs += [("dwqkv", dw_in, want_grads[1]), ("dwu", dwu, want_grads[2]),
                  ("dbu", dbu, want_grads[3])]
    rel = {}
    for name, a, w in pairs:
        rel[name] = float((a.float() - w.float()).abs().max() / w.float().abs().max())
        if not rel[name] <= tol:
            raise AssertionError(f"multi_head_attention_forward {name}: {rel[name]:.3e} "
                                 f"of the plain version's largest (tol {tol})")

    def fwd():
        with torch.no_grad():
            call()

    def bwd():
        torch.autograd.grad(lib_out, leaves, gt, retain_graph=True)

    times = {"library": _time_ms(fwd), "library_bwd": _time_ms(bwd),
             "library_device": _device_ms(fwd), "library_bwd_device": _device_ms(bwd)}
    return times, float((out[valid].float() - want[valid].float()).abs().max()), rel


@contextlib.contextmanager
def _qkv_simt_route():
    """Every fused-QKV call of the block on the CUDA-core kernels: the QKV
    ``_route`` patched (a test-time patch, no user knob)."""
    with mock.patch.object(qkv_mod, "_route", lambda *a: "simt"):
        yield


QKV_ROUTES = {"mma": contextlib.nullcontext, "simt": _qkv_simt_route}


def _qkv_counts():
    fwd, bwd = qkv_mod.fused_qkv_attention, qkv_mod.fused_qkv_attention_bwd
    return fwd.launches, fwd.mma_launches, bwd.launches, bwd.mma_launches


def phase_kernel_qkv():
    """The fused-QKV kernels of both routes against their plain versions;
    times at LC and SP. Returns ({route: forward max|err|}, {route: backward
    max|err|}, {case: times})."""
    fwd, bwd = qkv_mod._qkv_fwd, qkv_mod.fused_qkv_attention_bwd
    plain, plain_bwd = (qkv_mod.fused_qkv_attention_plain,
                        qkv_mod.fused_qkv_attention_bwd_plain)
    syn = make_synthetic_arrays(n=BATCH, n_max_lc=LC_LEN, nband=NBAND,
                                n_max_sp=TRAIN_SP_LEN, seed=5)
    mask_lc = torch.from_numpy(syn["mask_lc"]).cuda()
    mask_sp = torch.from_numpy(syn["mask_sp"]).cuda()
    masked = mask_lc[:16].clone()
    masked[0] = False          # a fully masked sample: uniform over its T keys
    masked[1, :100] = False
    limit = torch.rand((8, 256), generator=torch.Generator().manual_seed(7)).cuda() > 0.3
    cases = [  # name, (B, T, E, heads), mask
        ("lc", QKV_LC, mask_lc),
        ("sp", QKV_SP, mask_sp),
        ("t37", (16, 37, 64, 8), mask_lc[:16, :37].contiguous()),
        ("t256", (8, 256, 64, 8), limit),
        ("t256_sp", (8, 256, 32, 2), limit),
        ("masked_sample", (16,) + QKV_LC[1:], masked),
        ("no_mask", QKV_SP, None),
    ]
    gen = torch.Generator().manual_seed(5)
    fwd_err, bwd_err = {"mma": 0.0, "simt": 0.0}, {"mma": 0.0, "simt": 0.0}
    norm_err = {"mma": 0.0, "simt": 0.0}
    control = {}
    timing = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for name, (b, t, e, h), mask in cases:
            x, mask, wqkv, wu, bu, g = _qkv_inputs(gen, b, t, e, dtype, mask)
            want = plain(x, mask, wqkv, wu, bu, h)
            want_grads = plain_bwd(x, mask, wqkv, wu, g, h)
            routes = ("mma", "simt") if qkv_mod._route(dtype, e // h) == "mma" else ("simt",)
            for route in routes:
                before = _qkv_counts()
                with QKV_ROUTES[route]():
                    got = fwd(x, mask, wqkv, wu, bu, h)
                    grads = bwd(x, mask, wqkv, wu, g, h)
                torch.cuda.synchronize()
                mma = route == "mma"
                if _qkv_counts() != (before[0] + 1, before[1] + mma, before[2] + 1,
                                     before[3] + mma):
                    raise AssertionError(f"qkv {name} {dtype_name}: not on the {route} route")
                if got.dtype != dtype or got.shape != want.shape:
                    raise AssertionError(f"qkv {name} {dtype_name}: {got.dtype} "
                                         f"{tuple(got.shape)}")
                err = float((got.float() - want.float()).abs().max())
                fwd_err[route] = max(fwd_err[route], err)
                torch.testing.assert_close(
                    got.float(), want.float(), rtol=TOL[dtype_name], atol=TOL[dtype_name],
                    msg=lambda m: f"qkv {name} {dtype_name} {route}: {m}")
                rel, norms = [], []
                outs = (("out", got, want),) + tuple(zip(("dx", "dwqkv", "dwu", "dbu"), grads,
                                                         want_grads))
                for gname, a, w in outs[1:]:
                    if a.dtype != w.dtype or a.shape != w.shape:
                        raise AssertionError(f"qkv-bwd {name} {dtype_name} {gname}: "
                                             f"{a.dtype} {tuple(a.shape)}")
                    d = float((a.float() - w.float()).abs().max())
                    rel.append(d / float(w.float().abs().max()))
                    bwd_err[route] = max(bwd_err[route], d)
                norm = ""
                if dtype == torch.bfloat16:
                    norms = [_check_norm(a, w, f"qkv {name} {route} {gname}")
                             for gname, a, w in outs]
                    norm_err[route] = max(norm_err[route], *(n or 0.0 for n in norms))
                    norm = "; ||err||/||plain|| " + " ".join(
                        f"{o[0]} {_fmt(n)}" for o, n in zip(outs, norms)) + f" (tol {NORM_TOL})"
                log(f"kernel-qkv {name} {dtype_name} (B, T, E, H) = {(b, t, e, h)} {route}: "
                    f"forward max|err| {err:.3e} (tol {TOL[dtype_name]}); backward "
                    f"max|err|/max|plain| dx {rel[0]:.3e} dWqkv {rel[1]:.3e} dWu {rel[2]:.3e} "
                    f"dbu {rel[3]:.3e} (tol {GRAD_TOL[dtype_name]}){norm}")
                if max(rel) > GRAD_TOL[dtype_name]:
                    raise AssertionError(f"qkv-bwd {name} {dtype_name} {route}: {rel}")
                if mma and name in ("lc", "sp"):
                    # negative control: the tensor-core dWqkv's query third off by 1%
                    wrong = grads[1].clone()
                    wrong[:e] *= 0.99
                    control[name] = _norm_err(wrong, want_grads[1])
                    log(f"kernel-qkv {name} {dtype_name} {WRONG_DWQ}: ||err||/||plain|| "
                        f"{control[name]:.3e} (must exceed {NORM_TOL})")
                    if control[name] <= NORM_TOL:
                        raise AssertionError(f"qkv {name}: the normalised check cannot see "
                                             f"a 1% error in dWqkv: {control[name]:.3e}")
            if name in ("lc", "sp") and dtype_name == "bfloat16":
                times = {}
                for route in routes:
                    with QKV_ROUTES[route]():
                        times[route] = _time_ms(lambda: fwd(x, mask, wqkv, wu, bu, h))
                        times[f"{route}_bwd"] = _time_ms(lambda: bwd(x, mask, wqkv, wu, g, h))
                        times[f"{route}_device"] = _device_ms(
                            lambda: fwd(x, mask, wqkv, wu, bu, h))
                        times[f"{route}_bwd_device"] = _device_ms(
                            lambda: bwd(x, mask, wqkv, wu, g, h))
                        times[f"{route}_host"] = _host_ms(lambda: fwd(x, mask, wqkv, wu, bu, h))
                        times[f"{route}_bwd_host"] = _host_ms(
                            lambda: bwd(x, mask, wqkv, wu, g, h))
                times["plain"] = _time_ms(lambda: plain(x, mask, wqkv, wu, bu, h))
                times["plain_bwd"] = _time_ms(lambda: plain_bwd(x, mask, wqkv, wu, g, h))
                lib_times, lib_err, lib_rel = _mha_library(
                    x, mask, wqkv, wu, bu, g, h, want, want_grads)
                times.update(lib_times)
                module = _time_self_attention((b, t, e, h), mask, dtype)
                timing[name] = times
                log(f"time-qkv {name} {dtype_name} (B, T, E, H) = {(b, t, e, h)}: "
                    + ", ".join(f"{r} {ms:.4f} ms" for r, ms in times.items())
                    + " (mma / simt: the tensor-core / CUDA-core forward kernel, *_bwd the "
                    "backward with its recompute, plain_bwd the plain backward; library: "
                    "F.multi_head_attention_forward and the autograd of it from its saved "
                    "activations; *_device: the sum of its device kernels under "
                    "torch.profiler, 25 calls; *_host: the wrapper's host time a call on an "
                    "idle card, median of 50); the library call against the plain versions: "
                    "forward "
                    f"max|err| {lib_err:.3e}, gradients max|err|/max|plain| "
                    + " ".join(f"{k} {v:.3e}" for k, v in lib_rel.items()))
                for route, (f_ms, fb_ms) in module.items():
                    log(f"time-qkv {name} {dtype_name} SelfAttention module, {route} route: "
                        f"forward {f_ms:.4f} ms, forward + backward {fb_ms:.4f} ms "
                        f"(mean of two alternating rounds of medians of 25)")
            del x, wqkv, wu, bu, g, got, grads, want, want_grads
    torch.cuda.empty_cache()
    log(f"kernel-qkv: bf16 ||err||/||plain|| largest over the cases and outputs: "
        + ", ".join(f"{r} {e:.3e}" for r, e in norm_err.items())
        + f" (tol {NORM_TOL}); {WRONG_DWQ}: " + ", ".join(
            f"{n} {e:.3e}" for n, e in control.items()))
    return fwd_err, bwd_err, timing


def phase_serve(fused=False, qkv=False):
    tag = "serve-fused" if fused else "serve-qkv" if qkv else "serve"
    sizes = [(1, False), (37, True), (256, False), (300, False)]  # (n, as JSON)
    syn = make_synthetic_arrays(n=sum(n for n, _ in sizes), n_max_lc=LC_LEN,
                                nband=NBAND, n_max_sp=SP_LEN, seed=1)
    fields = ("x_lc", "t_lc", "mask_lc", "x_sp", "t_sp", "mask_sp")
    feeds, lo = [], 0
    for n, _ in sizes:
        feeds.append({k: syn[k][lo:lo + n] for k in fields})
        lo += n

    with tempfile.TemporaryDirectory() as tmp, (_qkv_env if qkv else contextlib.nullcontext)():
        _run_dir(tmp, fused)
        serving_model = load_live(tmp, BATCH, device=DEVICE, lc_len=LC_LEN,
                                  sp_len=SP_LEN)
        srv = EmbedServer(serving_model, host="127.0.0.1", port=0,
                          max_wait_ms=50.0)  # warms up: one device call
        results = [None] * len(sizes)
        try:
            srv.start_background()
            barrier = threading.Barrier(len(sizes))

            def client(i):
                barrier.wait()
                results[i] = _post(srv.port, feeds[i], sizes[i][1])

            with _plain_calls() as plain_calls:
                _zero_counts()
                t0 = time.perf_counter()
                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(len(sizes))]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=600)
                wall = time.perf_counter() - t0
                launches = _counts()
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
            log(f"{tag}: {len(sizes)} concurrent requests, "
                f"{sum(n for n, _ in sizes)} samples in {wall:.3f} s wall, "
                f"{calls} device calls, batch_fill {stats.get('batch_fill')}, "
                f"launches {COUNT_NAMES} {launches}, "
                f"{len(plain_calls)} plain kernel calls")
            if calls < -(-sum(n for n, _ in sizes) // BATCH):
                raise AssertionError(f"too few device calls: {calls}")
            # under the opt-in the LC tower (T = 200) takes the fused-QKV kernel and
            # the SP tower (T = 1024 > 256) falls back to the flash kernel; the fused
            # LC blocks compute in float32 (CUDA cores), every other layer in bf16
            # (tensor cores, the fused-QKV layers too); the fused forward takes the
            # tensor cores (3xTF32)
            n_qkv, n_f32 = SEQ_LC["depth"] * qkv, FUSED_PER_CALL * fused
            want = (n_f32 * calls, 0, (LAYERS_PER_CALL - n_qkv - n_f32) * calls, 0,
                    0, 0, 0, 0, n_qkv * calls, 0, FUSED_PER_CALL * calls * fused)
            if launches != want or plain_calls:
                raise AssertionError(
                    f"{tag}: expected launches {want} for {calls} device calls and no "
                    f"plain call: {launches}, {len(plain_calls)} plain calls")

            # per-call time of the served batch (fn ends in a host copy); the
            # kernel path on both flash routes, in alternating rounds
            full = {k: syn[k][:BATCH] for k in fields}
            serving_model.fn(full)
            rounds = ("mma", "simt", "simt", "mma") if tag == "serve" else ("mma",)
            per_call = {}
            for route in rounds:
                with ROUTES[route]():
                    _zero_counts()
                    for _ in range(10):
                        t0 = time.perf_counter()
                        serving_model.fn(full)
                        per_call.setdefault(route, []).append((time.perf_counter() - t0) * 1e3)
                    mma = _counts()[2]
                if (mma > 0) != (route == "mma" and want[2] > 0):
                    raise AssertionError(f"{tag}: {mma} tensor-core launches on the {route} "
                                         "route")
            for route, ts in per_call.items():
                call_ms = float(np.median(ts))
                log(f"{tag}: device call at B={BATCH}, {route} route: {call_ms:.3f} ms median "
                    f"of {len(ts)} ({BATCH / call_ms * 1e3:.1f} samples/s), host clock incl. "
                    "copies")
            if tag == "serve":
                for route in ("mma", "simt"):
                    with ROUTES[route]():
                        _log_trace(f"profile serve {route}", "device calls",
                                   *_trace(lambda: serving_model.fn(full), PROFILED_STEPS))
        finally:
            srv.close()

        # answers against the same model run through the plain versions
        ref_model, _ = load_model(tmp, DEVICE)
        tol = SERVE_TOL
        max_err = 0.0
        with _plain_kernels(), torch.inference_mode():
            for (n, as_json), feed, (status, out) in zip(sizes, feeds, results):
                if status != 200:
                    raise AssertionError(f"request n={n}: status {status}")
                ref = ref_model.encode({k: torch.from_numpy(v).to(DEVICE)
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
                    if err > tol:
                        raise AssertionError(f"{name} n={n} ({'json' if as_json else 'npz'}): "
                                             f"max|served - plain| {err}")
        log(f"{tag}: every answer matches the model through the plain versions, "
            f"max|err| {max_err:.3e} (tol {tol})")
    return launches


def _train_model(compute_dtype, seed=0, fused=False):
    cfg = CLIPConfig.create(
        combinations=("lightcurve", "spectral"), enc_dim=32, nband=NBAND,
        logit_scale_init=19.55, loss="softmax", transformer_kwargs=_seq_lc(fused),
        transformer_spectral_kwargs=SEQ_SP, compute_dtype=compute_dtype)
    return CLIPModel(cfg, generator=torch.Generator().manual_seed(seed)).to(DEVICE)


@contextlib.contextmanager
def _plain_calls():
    """Records each call of a kernel's plain version (forward or backward)
    made through the kernels' wrappers."""
    calls = []

    def counted(fn):
        def wrapped(*args, **kw):
            calls.append(1)
            return fn(*args, **kw)
        return wrapped

    with mock.patch.object(flash_mod, "dense_attention",
                           counted(flash_mod.dense_attention)), \
            mock.patch.object(flash_mod, "dense_attention_bwd",
                              counted(flash_mod.dense_attention_bwd)), \
            mock.patch.object(ffn_mod, "fused_ffn_block_plain",
                              counted(ffn_mod.fused_ffn_block_plain)), \
            mock.patch.object(ffn_mod, "fused_ffn_block_bwd_plain",
                              counted(ffn_mod.fused_ffn_block_bwd_plain)), \
            mock.patch.object(qkv_mod, "fused_qkv_attention_plain",
                              counted(qkv_mod.fused_qkv_attention_plain)), \
            mock.patch.object(qkv_mod, "fused_qkv_attention_bwd_plain",
                              counted(qkv_mod.fused_qkv_attention_bwd_plain)):
        yield calls


def _zero_counts():
    for fn in (flash_mod.flash_attention, flash_mod.flash_attention_bwd,
               qkv_mod.fused_qkv_attention, qkv_mod.fused_qkv_attention_bwd):
        fn.launches = fn.mma_launches = 0
    ffn_mod.fused_ffn_block.launches = ffn_mod.fused_ffn_block.mma_launches = 0
    ffn_mod.fused_ffn_block_bwd.launches = 0


def _counts():
    """Launches since _zero_counts, in the order of COUNT_NAMES: the flash
    forward and backward on the CUDA cores, then on the tensor cores, the
    fused-block forward on the CUDA cores and the backward, the fused-QKV
    forward and backward on the CUDA cores and on the tensor cores, then the
    fused-block forward on the tensor cores (forwards at even places)."""
    fwd, bwd = flash_mod.flash_attention, flash_mod.flash_attention_bwd
    qfwd, qbwd = qkv_mod.fused_qkv_attention, qkv_mod.fused_qkv_attention_bwd
    ffn_simt, ffn_mma = _ffn_counts()
    return (fwd.launches - fwd.mma_launches, bwd.launches - bwd.mma_launches,
            fwd.mma_launches, bwd.mma_launches,
            ffn_simt, ffn_mod.fused_ffn_block_bwd.launches,
            qfwd.launches - qfwd.mma_launches, qbwd.launches - qbwd.mma_launches,
            qfwd.mma_launches, qbwd.mma_launches, ffn_mma)


@contextlib.contextmanager
def _plain_kernels():
    """Every kernel replaced by its plain version: the encoders' attention by
    dense_attention (with torch autograd), the fused block's forward and
    backward by fused_ffn_block_plain and fused_ffn_block_bwd_plain, the
    fused-QKV forward and backward by fused_qkv_attention_plain and
    fused_qkv_attention_bwd_plain."""
    plain_bwd = ffn_mod.fused_ffn_block_bwd_plain
    with mock.patch.object(transformer_mod, "attention", dense_attention), \
            mock.patch.object(ffn_mod, "_ffn_fwd", lambda *a, eps: (
                ffn_mod.fused_ffn_block_plain(*a, eps=eps))), \
            mock.patch.object(ffn_mod, "fused_ffn_block_bwd", plain_bwd), \
            mock.patch.object(qkv_mod, "_qkv_fwd", qkv_mod.fused_qkv_attention_plain), \
            mock.patch.object(qkv_mod, "fused_qkv_attention_bwd",
                              qkv_mod.fused_qkv_attention_bwd_plain):
        yield


@contextlib.contextmanager
def _qkv_env():
    """MMSN_FUSED_QKV=1 for the block, restored after."""
    with mock.patch.dict(os.environ, {"MMSN_FUSED_QKV": "1"}):
        yield


@contextlib.contextmanager
def _qkv_plain():
    with _qkv_env(), _plain_kernels():
        yield


@contextlib.contextmanager
def _qkv_simt():
    """The opt-in on the CUDA-core fused-QKV kernels (bf16 too)."""
    with _qkv_env(), _qkv_simt_route():
        yield


def _wrong_dq():
    """The kernel path with a wrong backward: every layer's dq off by 1%."""
    bwd = flash_mod.flash_attention_bwd

    def wrong(*args):
        dq, dk, dv = bwd(*args)
        return dq * 0.99, dk, dv

    # the wrapper counts on the module attribute it replaces
    wrong.launches = wrong.mma_launches = 0
    return mock.patch.object(flash_mod, "flash_attention_bwd", wrong)


def _wrong_dwf1():
    """The fused kernel path with a wrong backward: every fused block's ff.0
    weight gradient off by 1%."""
    bwd = ffn_mod.fused_ffn_block_bwd

    def wrong(*args, **kw):
        grads = list(bwd(*args, **kw))
        grads[6] = grads[6] * 0.99  # (datt, dx, dwu, dbu, dg1, db1, dwf1, ...)
        return tuple(grads)

    wrong.launches = 0  # the wrapper counts on the module attribute it replaces
    return mock.patch.object(ffn_mod, "fused_ffn_block_bwd", wrong)


@contextlib.contextmanager
def _wrong_dwq():
    """The fused-QKV kernel path with a wrong backward: the query third of
    every layer's dWqkv off by 1%."""
    bwd = qkv_mod.fused_qkv_attention_bwd

    def wrong(x, *args):
        dx, dwqkv, dwu, dbu = bwd(x, *args)
        dwqkv = dwqkv.clone()
        dwqkv[:x.shape[-1]] *= 0.99
        return dx, dwqkv, dwu, dbu

    # the wrapper counts on the module attribute it replaces
    wrong.launches = wrong.mma_launches = 0
    with _qkv_env(), mock.patch.object(qkv_mod, "fused_qkv_attention_bwd", wrong):
        yield


# name: (use_fused_block, the context it runs in: the opt-in, and what runs in
# place of the kernels)
PATHS = {
    "kernel": (False, contextlib.nullcontext),
    "kernel-simt": (False, _simt_route),
    "plain": (False, _plain_kernels),
    WRONG_DQ: (False, _wrong_dq),
    "fused": (True, contextlib.nullcontext),
    "fused-plain": (True, _plain_kernels),
    "fused-simt": (True, _ffn_simt_route),
    WRONG_DWF1: (True, _wrong_dwf1),
    "qkv": (False, _qkv_env),
    "qkv-plain": (False, _qkv_plain),
    "qkv-simt": (False, _qkv_simt),
    WRONG_DWQ: (False, _wrong_dwq),
}


def _step_counts(path):
    """Launches per train step on ``path``, in the order of _counts. bf16
    flash calls take the tensor cores unless the path patches the route;
    the fused blocks of the LC tower compute in float32: their attention on
    the CUDA cores, their forward on the tensor cores (3xTF32) unless the
    path patches the fused route. Under the fused-QKV opt-in both towers (T
    = 200 and 220) take its kernels and the flash kernels none."""
    n = LAYERS_PER_CALL
    if path == "plain":
        return (0,) * 11
    if path == "qkv":  # bf16 at head dims 8 and 16: the tensor-core QKV kernels
        return (0,) * 8 + (n, n, 0)
    if path == "kernel-simt":
        return (n, n) + (0,) * 9
    if path == "qkv-simt":
        return (0,) * 6 + (n, n, 0, 0, 0)
    f = FUSED_PER_CALL if PATHS[path][0] else 0
    simt = path == "fused-simt"
    return (f, f, n - f, n - f, f * simt, f, 0, 0, 0, 0, f * (not simt))


def _f32_step_counts(path):
    """Launches per float32 train step on ``path`` (the trajectory and
    gradient checks): every kernel on the CUDA cores, the fused forward on
    the tensor cores (3xTF32 takes float32)."""
    c = _step_counts(path)
    return (c[0] + c[2], c[1] + c[3], 0, 0, c[4], c[5], c[6] + c[8], c[7] + c[9], 0, 0,
            c[10])


def _time_train_steps(path, batch):
    """ms of each of TIMED_STEPS train steps (bf16, noise on) on one batch,
    each step ended by a synchronise; their launch counts; peak memory."""
    fused, ctx = PATHS[path]
    model = _train_model("bfloat16", fused=fused)
    opt, _ = build_optimizer(model.named_parameters(), lr=5e-4)
    state = TrainState(model, opt)
    step = make_train_step(model, noise_level_mag=1.0)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    with ctx():
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


def _trajectory(path, data, plan):
    """Per-step losses of TRAJ_STEPS float32 steps (noise off) from the
    seeded weights over ``plan``, and their launches."""
    fused, ctx = PATHS[path]
    model = _train_model(None, fused=fused)
    opt, _ = build_optimizer(model.named_parameters(), lr=5e-4)
    with ctx():
        _zero_counts()
        _, losses = make_epoch_runner(model)(TrainState(model, opt), data, plan,
                                             torch.Generator(device=DEVICE))
        counts = _check_f32_counts(path, len(plan))
    return losses.cpu().numpy(), counts


def _check_f32_counts(path, steps):
    """The float32 steps' launches: every kernel but the fused forward on
    the CUDA cores, none on a plain path (the negative controls replace a wrapper and are not
    counted)."""
    counts = _counts()
    if path in (WRONG_DQ, WRONG_DWF1, WRONG_DWQ):
        return counts
    want = (0,) * 11 if "plain" in path else tuple(c * steps for c in _f32_step_counts(path))
    if counts != want:
        raise AssertionError(f"{path} float32: launches {counts}, want {want}")
    return counts


def _param_grads(path, batch):
    """Every parameter's gradient of one float32 train-mode loss (noise off)
    from the seeded weights, and the launches."""
    fused, ctx = PATHS[path]
    model = _train_model(None, fused=fused)
    with ctx():
        _zero_counts()
        loss, _ = model.loss_fn(batch, train=True, generator=torch.Generator(device=DEVICE))
        loss.backward()
        counts = _check_f32_counts(path, 1)
    return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}, counts


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


# variant: (tag, main path, its reference, its negative control, the paths it is timed against)
TRAIN_VARIANTS = {
    "kernel": ("train", "kernel", "plain", WRONG_DQ, ("plain", "kernel-simt")),
    "fused": ("train-fused", "fused", "fused-plain", WRONG_DWF1, ("kernel", "fused-simt")),
    "qkv": ("train-qkv", "qkv", "qkv-plain", WRONG_DWQ, ("kernel", "qkv-simt")),
}


def phase_train(variant="kernel"):
    """Trainer.fit on the kernel path (with use_fused_block for "fused", under
    MMSN_FUSED_QKV=1 for "qkv"), then train-step times and the trajectory and
    gradient checks."""
    tag, main_path, ref_path, wrong_path, others = TRAIN_VARIANTS[variant]
    fused = PATHS[main_path][0]
    ds = make_synthetic_dataset(n=TRAIN_N, n_max_lc=LC_LEN, nband=NBAND,
                                n_max_sp=TRAIN_SP_LEN, seed=0)
    n_train = TRAIN_N - BATCH
    train_ds, val_ds = ds.subset(np.arange(n_train)), ds.subset(np.arange(n_train, TRAIN_N))
    model = _train_model("bfloat16", fused=fused)
    trainer = Trainer(model, "contrastive", TrainerConfig(
        epochs=TRAIN_EPOCHS, batch_size=BATCH, lr=5e-4, seed=0, noise_level_mag=1.0))

    # the main path: Trainer.fit, counted from zero
    with PATHS[main_path][1](), _plain_calls() as plain:
        _zero_counts()
        t0 = time.perf_counter()
        result = trainer.fit(train_ds, val_ds)
        wall = time.perf_counter() - t0
        fit_counts = _counts()
    steps = TRAIN_EPOCHS * -(-n_train // BATCH)
    eval_steps = TRAIN_EPOCHS * -(-len(val_ds) // BATCH)
    rows = result["metric_rows"]
    for row in rows:
        log(f"{tag}: epoch {row['epoch']} train_loss {row['train_loss']:.5f} "
            f"val_loss {row['val_loss']:.5f} AUC_val {row['AUC_val']:.4f} "
            f"step {row['step_time_s'] * 1e3:.2f} ms")
        for key in ("train_loss", "val_loss", "AUC_val"):
            if not np.isfinite(row[key]):
                raise AssertionError(f"{tag}: non-finite {key} at epoch {row['epoch']}")
        if not 0.0 <= row["AUC_val"] <= 1.0:
            raise AssertionError(f"{tag}: AUC_val {row['AUC_val']}")
    per_step = _step_counts(main_path)
    # forward kernels run in train and eval steps, backward kernels in train steps
    want = tuple(c * (steps if i % 2 else steps + eval_steps)
                 for i, c in enumerate(per_step))
    log(f"{tag}: Trainer.fit {len(rows)} epochs, {steps} train + {eval_steps} eval "
        f"steps in {wall:.3f} s wall; launches {COUNT_NAMES} "
        f"{fit_counts}, {len(plain)} plain kernel calls")
    if result["epochs_run"] != TRAIN_EPOCHS or plain or fit_counts != want:
        raise AssertionError(
            f"{tag}: expected launches {want} (per train step {per_step}, forward "
            f"only per eval step) and no plain call")

    # train-step time against the other path, on one batch, alternating rounds
    data = ds.to_device(DEVICE)
    batch = take(data, torch.arange(BATCH, device=DEVICE))
    order = (main_path, *others, *others[::-1], main_path, main_path, *others)
    if variant == "kernel":  # the two flash routes: four more rounds each
        order += ("kernel-simt", "kernel", "kernel", "kernel-simt") * 2
    times = {main_path: [], **{p: [] for p in others}}
    round_ms = {p: [] for p in times}
    timed_counts = (0,) * 11
    for path in order:
        ts, counts, peak = _time_train_steps(path, batch)
        timed_counts = tuple(a + b for a, b in zip(timed_counts, counts))
        times[path] += ts
        round_ms[path].append(float(np.median(ts)))
        want = tuple(c * TIMED_STEPS for c in _step_counts(path))
        if counts != want:
            raise AssertionError(f"{path} path: launches {counts}, want {want}")
        ms = float(np.median(ts))
        log(f"train-step {path}: {ms:.3f} ms median of {TIMED_STEPS} at B={BATCH} bf16 "
            f"({BATCH / ms * 1e3:.1f} paired samples/s), peak {peak:.3f} GiB, "
            f"launches {counts}")
    for path, ts in times.items():
        q1, ms, q3 = np.percentile(ts, [25, 50, 75])
        log(f"train-step {path}, all rounds: median {ms:.3f} ms (quartiles {q1:.3f}-"
            f"{q3:.3f}) over {len(ts)} steps, {BATCH / ms * 1e3:.1f} paired samples/s; "
            f"round medians {[round(r, 3) for r in round_ms[path]]}")

    # loss trajectory against the plain versions, float32, noise off
    plan = epoch_indices(TRAIN_N, BATCH, rng=np.random.default_rng(0), shuffle=True,
                         pad="drop")
    plan = np.concatenate([plan, plan])[:TRAJ_STEPS]
    (got, traj_counts), (want, _) = (_trajectory(main_path, data, plan),
                                     _trajectory(ref_path, data, plan))
    rel = float((np.abs(got - want) / np.abs(want)).max())
    log(f"{tag}-trajectory float32, {TRAJ_STEPS} steps: {main_path} {got.tolist()}")
    log(f"{tag}-trajectory float32, {TRAJ_STEPS} steps: {ref_path} {want.tolist()}")
    log(f"{tag}-trajectory: max relative difference {rel:.3e} (tol {TRAJ_RTOL})")
    if not (np.isfinite(got).all() and rel <= TRAJ_RTOL):
        raise AssertionError(f"{main_path} path's losses leave the plain path's: {rel}")

    # whole-model parameter gradients on one batch, float32, noise off
    one = take(data, torch.from_numpy(plan[0]).to(DEVICE))
    want, _ = _param_grads(ref_path, one)
    errs, counts = {}, {}
    for path in (main_path, wrong_path):
        got, counts[path] = _param_grads(path, one)
        if sorted(got) != sorted(want):
            raise AssertionError(f"{path} path: gradients of {sorted(set(got) ^ set(want))}")
        worst, errs[path] = _grad_error(got, want)
        log(f"{tag}-grads float32, {len(want)} parameters: {path} path, worst "
            f"max|diff|/max|plain| {errs[path]:.3e} at {worst} (tol {GRAD_RTOL})")
    grad_counts = counts[main_path]
    if errs[main_path] > GRAD_RTOL:
        raise AssertionError(f"{main_path} path's gradients leave the plain path's: {errs}")
    if errs[wrong_path] <= GRAD_RTOL:
        raise AssertionError(f"the gradient check cannot see a 1% error: {errs}")
    total = tuple(sum(c) for c in zip(fit_counts, timed_counts, traj_counts, grad_counts))
    log(f"{tag}: launches {COUNT_NAMES} of Trainer.fit (bf16), the timed rounds (bf16), the "
        f"float32 trajectory and the float32 gradients: {fit_counts}, {timed_counts}, "
        f"{traj_counts}, {grad_counts}")
    return total


def _attention_f64_grads(q, k, v, mask, g, emb):
    """dq, dk, dv of dense_attention's function in float64 (the reference
    the two float32 backwards are read against)."""
    with torch.enable_grad():
        q, k, v = (a.detach().double().requires_grad_() for a in (q, k, v))
        c = emb ** -0.25
        scores = torch.einsum("bhts,bhus->bhtu", q * c, k * c)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :], -1e7)
        out = torch.einsum("bhtu,bhus->bhts", torch.softmax(scores, dim=-1), v)
        return torch.autograd.grad(out, (q, k, v), g.double())


def _dq_with_d(q, k, v, mask, g, emb, d_from_out):
    """dq of the plain float32 backward with D = rowsum(P o dP) (the
    reference's) or D = g . out (the tensor-core flash kernel's)."""
    c = emb ** -0.25
    qs, ks = (q * c).float(), (k * c).float()
    scores = torch.einsum("bhts,bhus->bhtu", qs, ks)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], -1e7)
    p = torch.softmax(scores, dim=-1)
    dp = torch.einsum("bhts,bhus->bhtu", g, v)
    if d_from_out:
        d = (g * torch.einsum("bhtu,bhus->bhts", p, v)).sum(-1, keepdim=True)
    else:
        d = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - d)
    if mask is not None:
        ds = ds.masked_fill(~mask[:, None, None, :], 0.0)
    return torch.einsum("bhtu,bhus->bhts", ds, ks) * c


def phase_grad_probe():
    """Where the kernel path's float32 whole-model gradients part from the
    plain path's (2.2e-4 at the first LC toqueries weight): every attention
    call of one float32 loss on the plain path is recorded with its
    cotangent, and on each layer's own inputs the flash backward (CUDA cores,
    D = rowsum(P o dP)), dense_attention's autograd and the plain backward
    with either D (g . out, which the CUDA-core kernel took before, or
    rowsum(P o dP)) are read against a float64 reference. A diagnostic: it
    logs, it checks nothing."""
    ds = make_synthetic_dataset(n=TRAIN_N, n_max_lc=LC_LEN, nband=NBAND,
                                n_max_sp=TRAIN_SP_LEN, seed=0)
    plan = epoch_indices(TRAIN_N, BATCH, rng=np.random.default_rng(0), shuffle=True,
                         pad="drop")
    batch = take(ds.to_device(DEVICE), torch.from_numpy(plan[0]).to(DEVICE))
    calls = []

    def recording(q, k, v, mask, emb):
        out = dense_attention(q, k, v, mask, emb)
        rec = {"qkv": [a.detach() for a in (q, k, v)], "mask": mask, "emb": emb}
        out.register_hook(lambda g: rec.__setitem__("g", g.detach()))
        calls.append(rec)
        return out

    model = _train_model(None)
    with mock.patch.object(transformer_mod, "attention", recording):
        loss, _ = model.loss_fn(batch, train=True, generator=torch.Generator(device=DEVICE))
        loss.backward()

    def rel(got, ref):
        return float((got.double() - ref).abs().max() / ref.abs().max())

    for i, rec in enumerate(calls):
        (q, k, v), mask, emb, g = rec["qkv"], rec["mask"], rec["emb"], rec["g"]
        ref = _attention_f64_grads(q, k, v, mask, g, emb)
        plain = dense_attention_bwd(q, k, v, mask, g, emb)
        out, stats = flash_mod._flash_fwd(q, k, v, mask, emb, with_stats=True)
        kern = flash_mod.flash_attention_bwd(q, k, v, mask, out, stats, g, emb)
        d_out = _dq_with_d(q, k, v, mask, g, emb, True)
        d_rowsum = _dq_with_d(q, k, v, mask, g, emb, False)
        log(f"grad-probe layer {i} {tuple(q.shape)}: max|x - float64| / max|float64| dq, dk, "
            f"dv: flash kernel {rel(kern[0], ref[0]):.3e} {rel(kern[1], ref[1]):.3e} "
            f"{rel(kern[2], ref[2]):.3e}; dense_attention autograd {rel(plain[0], ref[0]):.3e} "
            f"{rel(plain[1], ref[1]):.3e} {rel(plain[2], ref[2]):.3e}; plain dq with D = g.out "
            f"{rel(d_out, ref[0]):.3e}, with rowsum(P o dP) {rel(d_rowsum, ref[0]):.3e}")
        del ref, plain, out, stats, kern, d_out, d_rowsum
    torch.cuda.empty_cache()


def _kind(name):
    """Kind of a device op, by its kernel name."""
    n = name.lower()
    for word, kind in (("fused_qkv_fwd", "fused QKV forward"),
                       ("fused_qkv_bwd", "fused QKV backward"),
                       ("reduce_qkv_partials", "fused QKV backward"),
                       ("fused_ffn_fwd", "fused FFN forward"),
                       ("fused_ffn_bwd", "fused FFN backward"),
                       ("reduce_partials", "fused FFN backward"),
                       ("flash_attention_fwd", "flash forward"),
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


def _trace(fn, n):
    """torch.profiler (device activity only) over ``n`` calls of ``fn``;
    returns (device ms, trace wall ms, host-clock ms) per call, the idle
    share, device ops per call and device ms per call by kind of kernel."""
    torch.cuda.synchronize()
    # device activity only: recording ~3,000 host ops per step would
    # stretch the host's share of the wall the idle share is read from
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    if not dev:
        raise AssertionError("the trace holds no device op")
    busy, lo, hi = 0.0, dev[0][0], dev[0][1]
    for s0, s1, _ in dev[1:]:  # the union of device intervals
        if s0 > hi:
            busy, lo = busy + hi - lo, s0
        hi = max(hi, s1)
    busy += hi - lo
    wall = hi - dev[0][0]
    kinds = {}
    for s0, s1, name in dev:
        kinds[_kind(name)] = kinds.get(_kind(name), 0.0) + (s1 - s0) / 1e3 / n
    return busy / 1e3 / n, wall / 1e3 / n, host_ms, 1 - busy / wall, len(dev) / n, kinds


def _log_trace(tag, unit, device_ms, wall_ms, host_ms, idle, ops, kinds):
    log(f"{tag}: {PROFILED_STEPS} {unit} at B={BATCH} bf16 under torch.profiler: device "
        f"{device_ms:.3f} ms each, trace wall {wall_ms:.3f} ms (host clock {host_ms:.3f}), "
        f"device idle share {idle:.3f}, {ops:.0f} device ops each")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"{tag}:   {kind:22s} {ms:8.3f} ms each ({100 * ms / device_ms:.1f}% of "
            "device time)")


def _profile_steps(path, batch):
    """_trace over PROFILED_STEPS train steps on ``path`` after 3 warm-up
    steps."""
    fused, ctx = PATHS[path]
    model = _train_model("bfloat16", fused=fused)
    opt, _ = build_optimizer(model.named_parameters(), lr=5e-4)
    state = TrainState(model, opt)
    step = make_train_step(model, noise_level_mag=1.0)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    with ctx():
        for _ in range(3):
            step(state, batch, gen)
        return _trace(lambda: step(state, batch, gen), PROFILED_STEPS)


def phase_profile():
    ds = make_synthetic_dataset(n=BATCH, n_max_lc=LC_LEN, nband=NBAND,
                                n_max_sp=TRAIN_SP_LEN, seed=0)
    batch = ds.to_device(DEVICE)
    for path in ("kernel", "kernel-simt", "plain", "fused", "fused-simt", "qkv", "qkv-simt"):
        _log_trace(f"profile {path}", "train steps", *_profile_steps(path, batch))


def _flash_bounds(b, h, t, s):
    """Bounds of the flash forward and backward at (B, H, T, S), bf16."""
    fwd = _bound(4 * b * h * t * t * s, 4 * b * h * t * s * 2 + b * t, "bfloat16")
    bwd = _bound(10 * b * h * t * t * s,
                 8 * b * h * t * s * 2 + b * h * t * 2 * 4 + b * t, "bfloat16")
    return fwd, bwd


def _qkv_bounds(b, t, e, h):
    """Bounds of the fused-QKV forward and backward at (B, T, E, heads),
    bf16. Bytes: x and out (backward: x, g and dx) once, the mask, the
    float32 weights (backward: the weights in and their gradients out).
    Multiply-adds a row: forward 3E^2 (projection) + 2TE (q.k and p.v, all
    heads) + E^2 (unify); the backward recomputes the first two and adds
    E^2 each for datt and dWu, TE each for dP, dq, dk and dv, and 3E^2 each
    for dx and dWqkv."""
    n, p = b * t, 4 * e * e + e
    fwd = _bound(2 * n * (4 * e * e + 2 * t * e), 2 * n * e * 2 + n + 4 * p, "bfloat16")
    bwd = _bound(2 * n * (11 * e * e + 6 * t * e), 3 * n * e * 2 + n + 8 * p, "bfloat16")
    return fwd, bwd


def _exp_floor_ms(b, h, t, exp_per_s):
    """(forward, backward) ms of the flash kernels' exponentials alone at
    (B, H, T): one a (query, key) pair forward, two backward (dq and dk/dv
    each rebuild P), at the MUFU pipes' rate. A floor beside the bound,
    which leaves the exponentials out."""
    n = b * h * t * t
    return n / exp_per_s * 1e3, 2 * n / exp_per_s * 1e3


def _kernel_bounds():
    """(ms, what bounds it) of each kernel at the shapes of its timed case:
    each input read once and each output written once; operations are the
    products' multiply-adds (two each), the exponentials left out."""
    b = BATCH
    fwd = _flash_bounds(b, 2, SP_LEN, 16)[0]        # flash forward, SP serving, bf16
    bwd = _flash_bounds(b, 2, TRAIN_SP_LEN, 16)[1]  # flash backward, SP training, bf16
    qkv_fwd, qkv_bwd = _qkv_bounds(*QKV_LC)         # fused QKV, LC, bf16
    n, e, f = FFN_ROWS, FFN_E, FFN_F           # fused block, LC rows, float32
    p = e * e + 2 * e * f + 6 * e + f          # parameter floats
    ffn_fwd = _bound(2 * n * (e * e + 2 * e * f), 4 * (3 * n * e + p), "float32")
    ffn_fwd_mma = _bound(2 * n * (e * e + 2 * e * f), 4 * (3 * n * e + p), "tf32x3")
    ffn_bwd = _bound(2 * n * (3 * e * e + 6 * e * f), 4 * (5 * n * e + 2 * p), "float32")
    return {"flash_attention_fwd": fwd, "flash_attention_bwd": bwd,
            "flash_attention_fwd_mma": fwd, "flash_attention_bwd_mma": bwd,
            "fused_ffn_fwd": ffn_fwd, "fused_ffn_fwd_mma": ffn_fwd_mma,
            "fused_ffn_bwd": ffn_bwd,
            "fused_qkv_fwd": qkv_fwd, "fused_qkv_bwd": qkv_bwd,
            "fused_qkv_fwd_mma": qkv_fwd, "fused_qkv_bwd_mma": qkv_bwd}


def main():
    card, exp_per_s = phase_device()
    phase_build()
    fwd_err, timing = phase_kernel()
    bwd_err, bwd_timing = phase_kernel_bwd()
    ffn_err, ffn_norm_err, ffn_bwd_err, ffn_timing = phase_kernel_ffn()
    qkv_err, qkv_bwd_err, qkv_timing = phase_kernel_qkv()
    serve = phase_serve()
    serve_fused = phase_serve(fused=True)
    serve_qkv = phase_serve(qkv=True)
    train = phase_train()
    phase_grad_probe()
    train_fused = phase_train("fused")
    train_qkv = phase_train("qkv")
    phase_profile()
    runs = (serve, serve_fused, serve_qkv, train, train_fused, train_qkv)
    log(f"kernels line: each entry's \"shape\" is what its times and bound are at; "
        f"launches {COUNT_NAMES} of serve, serve-fused, serve-qkv, train, train-fused, "
        f"train-qkv, summed in the line: {runs}; card {card}")
    lc, sp_fwd, sp_bwd = ((BATCH, 8, NBAND * LC_LEN, 8), (BATCH, 2, SP_LEN, 16),
                          (BATCH, 2, TRAIN_SP_LEN, 16))
    for name, shape in (("LC", lc), ("SP serving", sp_fwd), ("SP training", sp_bwd)):
        (f_ms, f_by), (b_ms, b_by) = _flash_bounds(*shape)
        e_fwd, e_bwd = _exp_floor_ms(*shape[:3], exp_per_s)
        log(f"bounds bf16 at {name} {shape}: flash forward {f_ms:.4f} ms ({f_by}), flash "
            f"backward {b_ms:.4f} ms ({b_by}); exponentials alone: forward {e_fwd:.4f} ms, "
            f"backward {e_bwd:.4f} ms")
    for name, shape in (("LC", QKV_LC), ("SP", QKV_SP)):
        (f_ms, f_by), (b_ms, b_by) = _qkv_bounds(*shape)
        log(f"bounds bf16 at {name} (B, T, E, H) = {shape}: fused QKV forward "
            f"{f_ms:.4f} ms ({f_by}), backward {b_ms:.4f} ms ({b_by})")
    lc32 = ffn_timing["float32"]
    qkv_lc, qkv_sp = qkv_timing["lc"], qkv_timing["sp"]

    def flash(route, bwd):
        """The flash entry of ``route``: SP timed, LC under also_at."""
        times = ((bwd_timing["sp"], bwd_timing["lc"]) if bwd else
                 (timing[("sp", "bfloat16")], timing[("lc", "bfloat16")]))
        shapes = (sp_bwd if bwd else sp_fwd, lc)
        entries = []
        for tm, shape in zip(times, shapes):
            bound = _flash_bounds(*shape)[bwd]
            entry = {"ms": tm[route], "plain_ms": tm["plain"], "bound_ms": bound[0],
                     "bound_by": bound[1], "library_ms": tm["library"],
                     "shape": f"(B, H, T, S) = {shape} bfloat16"}
            if bwd:
                entry.update(device_ms=tm[f"{route}_device"],
                             library_device_ms=tm["library_device"])
            entries.append(entry)
        entries[0]["also_at"] = entries[1]
        return entries[0]

    measured = {  # name: (launches, max_abs_err, the rest of the entry)
        "flash_attention_fwd": (0, fwd_err["simt"], flash("simt", 0)),
        "flash_attention_bwd": (1, bwd_err["simt"], flash("simt", 1)),
        "flash_attention_fwd_mma": (2, fwd_err["mma"], flash("mma", 0)),
        "flash_attention_bwd_mma": (3, bwd_err["mma"], flash("mma", 1)),
        "fused_ffn_bwd": (5, ffn_bwd_err, {
            "ms": lc32["bwd"], "plain_ms": lc32["bwd_plain"], "library_ms": None,
            "shape": f"(N, E, F) = {(FFN_ROWS, FFN_E, FFN_F)} float32"}),
    }
    for i, route in ((4, "simt"), (10, "mma")):  # the fused forward's two routes
        measured["fused_ffn_fwd" + ("_mma" if route == "mma" else "")] = (i, ffn_err[route], {
            "ms": lc32[route], "device_ms": lc32[route + "_device"], "plain_ms": lc32["plain"],
            "library_ms": None, "norm_err": ffn_norm_err[route],
            "shape": f"(N, E, F) = {(FFN_ROWS, FFN_E, FFN_F)} float32"})
    # the fused-QKV kernels, timed at LC; their second shape, SP, under also_at (13
    # of a train step's 18 launches)
    sp_qkv_bounds = _qkv_bounds(*QKV_SP)
    for i, name in enumerate(("fused_qkv_fwd", "fused_qkv_bwd", "fused_qkv_fwd_mma",
                              "fused_qkv_bwd_mma")):
        route, bwd = ("mma" if i > 1 else "simt"), i % 2
        key = f"{route}_bwd" if bwd else route
        suffix = "_bwd" if bwd else ""
        def entry(tm):
            return {"ms": tm[key], "plain_ms": tm["plain" + suffix],
                    "library_ms": tm["library" + suffix], "device_ms": tm[key + "_device"],
                    "library_device_ms": tm["library" + suffix + "_device"],
                    "host_ms": tm[key + "_host"]}

        measured[name] = (6 + i, (qkv_bwd_err if bwd else qkv_err)[route], {
            **entry(qkv_lc), "shape": f"(B, T, E, H) = {QKV_LC} bfloat16",
            "also_at": {**entry(qkv_sp), "shape": f"(B, T, E, H) = {QKV_SP} bfloat16",
                        "bound_ms": sp_qkv_bounds[bwd][0], "bound_by": sp_qkv_bounds[bwd][1]}})
    bounds = _kernel_bounds()
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": sum(r[measured[name][0]] for r in runs),
         "max_abs_err": measured[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], **measured[name][2]}
        for name, (source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
