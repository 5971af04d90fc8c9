#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU: the maven-lite embedding
server and the maven-lite contrastive trainer end to end (and maven-lite
from its own config, trained into run directories, resumed and served; and
the image and meta towers and the supervised heads: trimodal from its own
config, quadrimodal, redshift regression and classification), through the
hand-written flash-attention kernels (forward and backward; bf16 on the
tensor cores, float32 on the tensor cores in 3xTF32, head dims 32/64 and rows
off 16 bytes on the CUDA cores), and the same server and
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
  2. build: compiles the fourteen csrc/*.cu sources (flash_attention_fwd,
     flash_attention_bwd and their tensor-core versions
     flash_attention_{fwd,bwd}_mma (bf16) and flash_attention_{fwd,bwd}_tf32
     (float32, 3xTF32), fused_ffn_fwd, fused_ffn_bwd and their
     tensor-core versions fused_ffn_{fwd,bwd}_mma,
     fused_qkv_fwd, fused_qkv_bwd and their tensor-core versions
     fused_qkv_{fwd,bwd}_mma) with nvcc for sm_90a, one nvcc each, all
     started together, and echoes ptxas's entry, register and spill lines;
  3. kernel: the forward kernels against their plain version
     (dense_attention) on the card, float32 (atol = rtol = 1e-4: another
     summation order and the online rescale) and bfloat16 (0.05, and the
     normalised error ||got - want|| / ||want|| within NORM_TOL, which sees
     an output 1% off where 0.05 absolute cannot), at the
     light-curve (256, 8, 200, 8) and spectral (256, 2, 1024, 16) serving
     shapes in the encoder's layout and contiguous, the light curve at 2
     heads of 16 (config_grid's heads), T = 220, a batch with a
     fully masked row and leading masked key tiles, key_mask=None, ragged
     T = 1 and T = 77 at head dims 8 and 16, the trimodal spectral shape
     (32, 2, 1024, 16), and the other head dims. Every case at head dim 8
     or 16 runs on both of its dtype's routes (the tensor cores as routed:
     bf16, or 3xTF32 for float32; the CUDA cores through a patch of
     flash_attention._route) and must show one launch on the first's
     counter; every other case runs on the CUDA cores. The 3xTF32 route is
     also held to FP32_NORM_TOL (1e-5) in the normalised error, which the
     plain version with TF32 matmuls must fail (the control). Then times
     the routes at the two serving shapes (CUDA events, median of 25; and
     the wrapper's host time a call, perf_counter around a call made on an
     idle card, median of 50), the plain version, and
     F.scaled_dot_product_attention (scale emb**-0.5, boolean key mask) as
     the library yardstick (timed only; it differs on fully masked rows,
     where it gives NaN), in both dtypes (float32 with TF32 off), and in
     float32 at the training and trimodal spectral shapes too, each route
     and the library call also by device time (profiler sums);
  4. kernel-bwd: the backward kernels' dq/dk/dv against torch autograd
     through dense_attention on the card, float32 (atol = rtol = 5e-4, the
     JAX kernel tests' gradient tolerance) and bfloat16 (0.05 and NORM_TOL
     on each of dq, dk, dv whose plain value is not all zero), at the cases
     of phase 3 with SP at the training T = 220, plus SP T = 1024, both
     routes as in phase 3 from one forward's output and stats (either
     forward feeds either backward); the 3xTF32 route also within
     FP32_NORM_TOL, which the plain backward with TF32 matmuls must fail; a
     fully masked row must give dq = dk = 0 and dv != 0; at LC and SP the
     tensor-core dq x 0.99 (_wrong_dq) must fail the normalised check of
     its route (NORM_TOL for bf16, FP32_NORM_TOL for 3xTF32); on nearly
     equal values (64, 8, 200, 8) the 3xTF32 dq, dk and dv must each sit
     within 2x the plain float32 version's distance to float64 (plus 1e-7
     of the largest value). Then times
     both routes (and their host time a call, as in phase 3), the plain
     backward and the autograd backward of F.scaled_dot_product_attention
     at LC and SP, bf16 and float32 (and float32 at SP T = 1024 and the
     trimodal (32, 2, 1024, 16)) (CUDA events, median of 25), and, beside
     the events, each kernel's and the library call's device time (the sum
     of their device kernels under torch.profiler over 25 calls), which the
     host's pace does not move;
  4b. kernel-ffn: the fused-block forward kernel against its plain version
     (fused_ffn_block_plain) and the backward kernel against
     fused_ffn_block_bwd_plain, on the card, at the light-curve tower's rows
     (N = 256 x 200 = 51,200, E = 64, F = 256), at a ragged N (51,163) and
     at E = 128, F = 512, float32 and bfloat16. Every float32 forward and
     backward runs on both routes (the 3xTF32 tensor cores as routed, the
     CUDA cores through a patch of fused_block._route) and must show one
     launch on its route and none on the other; bfloat16 runs on the CUDA
     cores. Forward: atol = rtol = 1e-4 in float32, and the normalised
     error within FP32_NORM_TOL (1e-5), which the plain version with TF32
     matmuls must fail (the control); 0.05 in bfloat16. Backward: each
     output within 5e-4 of its largest in float32 (the JAX fused tests use
     2e-4 against XLA; here the weight gradients are sums over 51,200 rows
     taken in block partials, another order than the plain version's
     matrix products) and, but db2 (no product), within FP32_NORM_TOL in the
     normalised error, which the plain backward with TF32 matmuls must fail
     in datt, dx, dWu and dWf1; 0.05 in bfloat16. Every row counts. The
     tensor-core backward is held to the plain version on its own ReLU
     mask (its h scratch > 0, relu_mask), since where a pre-activation lies
     within rounding of 0 a kernel and the plain version may take the
     mask's two sides and one such entry moves a whole dh value; its h is
     held to the plain h at the forward's 1e-4, and the entries where the
     masks differ are logged. The CUDA-core backward is held to the plain
     version as it is. Times at the LC shape the forward
     of each route, the plain version and the backward of each route in
     float32 (the CUDA cores in bfloat16) (CUDA events, median of 25), in
     float32 each route's device time (profiler sums over 25 calls), the
     tensor-core backward's device time by stage (row kernel,
     weight-gradient kernel, reduces), and the tensor-core forward's device
     time at 1, 2 and 3 full waves of blocks (a diagnostic: it logs, it
     checks nothing);
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
     (5 float32 on the 3xTF32 route, 13 bf16 on the tensor cores) per device
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
     (the 3xTF32 route) with the
     noise off, 12 steps on the kernel path and 12 on the plain path over
     one index plan: the per-step losses agree to relative 1e-5 (sound runs
     differ by about 1e-7: summation order). At lr 5e-4 the loss moves
     too little for this to see a wrong backward, so every parameter's
     gradient of one float32 loss is held against the plain path's too,
     max|diff| / max|plain| <= 5e-4 per parameter (the gradient tolerance;
     the denominator floored at 1e-3 of the model's largest gradient); the
     kernel path with every dq off by 1% must fail that check. Those float32
     runs count their launches too: the flash kernels on the 3xTF32 route,
     the fused-QKV ones on the CUDA cores, none on the plain path;
  6a. grad-probe: every attention call of one float32 loss on the plain
     path is recorded with its cotangent, and each layer's dq, dk, dv from
     the 3xTF32 flash backward, the CUDA-core one and dense_attention's
     autograd are read against a float64 reference on those inputs, beside
     the plain
     backward's dq with D = g.out and with rowsum(P o dP); then, under
     MMSN_FUSED_QKV=1, every fused-QKV layer's inputs and cotangent are
     recorded the same way and its dx and dWqkv from the CUDA-core fused-QKV
     backward (float32) and from its plain version are read against float64,
     with the ratio of the two distances (a diagnostic: it logs, it checks
     nothing);
     Prints the median train-step time and paired samples/s of the kernel
     path, the plain path and the kernel path on the CUDA-core route (bf16,
     the same batch, host clock around synchronised steps, alternating
     rounds of 20 steps each: three of the plain path, seven of each flash
     route) and their peak device memory;
  6b. train-fused: the same trainer with use_fused_block in the LC tower's
     kwargs: 5 fused forward + 5 fused backward (all on the tensor cores) +
     18 flash forward + 18 flash backward launches per train step (5 + 18
     forward per eval step), no plain call; the float32 trajectory and
     gradient runs take the tensor-core fused forward and backward too (5
     each a step), their plain path none. The trajectory and gradient checks of phase 6 hold the
     fused kernel path against the fused path through the plain versions of
     all four kernels; the gradient check must fail when the fused
     backward's ff.0 weight gradient is scaled by 0.99. Flash launches: the
     5 float32 LC layers on the 3xTF32 route, the 13 SP on the bf16 tensor
     cores.
     Times train steps
     and peak memory, fused ("fused") against unfused ("kernel"), both on
     the kernel path, and the fused path with both fused kernels on the CUDA
     cores ("fused-simt");
  6c. train-qkv: the same trainer under MMSN_FUSED_QKV=1: 18 tensor-core
     fused-QKV forward + 18 backward launches and no flash launch per train
     step (18 forward per eval step), no plain call. The float32 trajectory
     and gradient checks (on the CUDA-core QKV kernels, counted) hold the
     fused-QKV kernel path against the same path through the plain
     versions; the gradient check must fail when the query third of every
     layer's dWqkv is scaled by 0.99. Times train steps and peak memory, the
     opt-in ("qkv") against the unfused kernel route ("kernel") and the
     opt-in on the CUDA-core QKV kernels ("qkv-simt");
  6d. run-dir: maven-lite built by the port from the first grid point of
     configs/maven-lite.yaml (its own reader, build_clip_config(nband=2),
     build_trainer_config): LC emb 64, 8 heads, 5 blocks, agg attn; SP emb
     32, 2 heads, 13 blocks, agg mean; n_out 32, enc_dim 128 (the
     reference's default), lr 3.7e-5, B = 32, float32, softmax loss,
     noise_level_mag 1.0, dropout 2.2e-4; only the epochs are overridden
     (3, logged). On the 640-sample synthetic set at 2 x 100 light-curve
     points and T_sp = 1024 (max_spectral_data_len), split 512/128
     (val_fraction 0.2): Trainer.fit into run directory A (3 epochs), into
     B (2 epochs), then a new Trainer with resume=True on B (to 3). Each fit
     counts 18 flash forward launches a train and an eval step and 18
     backward a train step, all on the 3xTF32 route (float32), and no plain
     call. Both directories must hold config.yaml (the port's reader parses
     it to the dump), the two manifests (512 and 128 lines),
     model_config.json, metrics.jsonl (epochs 0, 1, 2; B's third row from
     the resumed run), summary.json, the two best epoch= files and
     last.ckpt. B's resumed epoch must give A's epoch 2: train and
     validation loss within relative 1e-5, every parameter within 1e-5 of
     its largest absolute value. load_model(A, which="last") and
     load_live(A, batch_size=32) serve 32 validation samples, and
     get_embeddings reads all 128, each within 1e-6 absolute of the
     in-memory final model's encode on the same samples (18 forward
     launches a call);
  6e. towers: trimodal built by the port from the first grid point of
     configs/trimodal.yaml (ConvMixer dim 32, depth 8, kernel 5, patch 10,
     n_out 32; LC emb 64, 8 heads, 5 blocks, agg mean; SP emb 32, 2 heads,
     13 blocks, agg mean, T_sp = 1024; B = 32, float32, image and
     magnitude noise 1.0; only the epochs cut, 1000 to 2) on the
     640-sample synthetic set with 60 x 60 images, split 512/128:
     Trainer.fit into a run directory with 18 + 18 3xTF32 flash launches
     a train step (18 an eval step, _f32_step_counts) and none on the CUDA
     cores, no plain call;
     every BatchNorm buffer of last.ckpt finite and moved from its start,
     num_batches_tracked the train steps; AUC_val1..3 and AUC_val_mean in
     metrics.jsonl; load_live serving x_img within 1e-6 of the in-memory
     encode; 6 float32 steps (noise and rotation on, the same draws) on the
     kernel path within relative 1e-5 of the plain path's; every
     parameter's float32 gradient on one batch within 5e-4 of the plain
     path's (relative to the parameter's largest, floored at 1e-3 of the
     model's largest), the kernel path on the plain path's ReLU masks (a
     unit at the kink takes either side on two float32 forwards), and the
     same check failing with every dq off by 1%;
     the step's host
     time (median of 10) and one torch.profiler breakdown (ConvMixer
     convolutions and BatchNorm, flash, the rest). Then quadrimodal (the
     conv and meta kwargs of benchmarks/profile_tpu.py, maven-lite's
     towers, bf16, B = 256, 60 x 60 images): image and meta towers and
     every embedding float32, 12 train steps on the tensor-core flash
     routes (18 + 18 a step), a finite loss, the step's host time. Then
     configs/config_grid.yaml's light-curve redshift regression (emb 32, 2
     heads, 9 blocks, B = 256, float32) and the same towers with a 5-class
     head: one epoch of Trainer.fit each (9 + 9 3xTF32 launches a train
     step), R2_val and f1_val finite, predict_supervised equal to the eval
     head's output (9 launches a call), every parameter's float32
     gradient at B = 256 held to the plain path's as above, the step's
     host time;
  7. profile: torch.profiler (device activity) over 5 train steps of each
     path (kernel, kernel-simt: the kernel path on the CUDA-core route,
     plain, fused, fused-simt: the fused path with both fused kernels on the
     CUDA cores, qkv, qkv-simt: the opt-in on the CUDA-core QKV kernels;
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
runs, and every counted call of the run-dir and towers phases; the flash and fused-QKV
entries carry the times and bound at their second shape under "also_at"; the
fused-QKV entries add their and the library call's device time, "device_ms"
and "library_device_ms", and the wrapper's host time a call, "host_ms")
and each kernel's bound (the larger of its bytes over
3.35 TB/s and its operations over the peak for its input type: 989 TFLOP/s
for bfloat16 on the tensor cores, 67 TFLOP/s for float32 on the CUDA cores,
TF32 being off, and for the 3xTF32 kernels three times their operations
at 495 TFLOP/s); the flash entries of the CUDA cores and of 3xTF32 carry
their float32 times under "float32" (the 3xTF32 ones at the top level),
with the trimodal spectral shape under "also_at_trimodal"; the flash
backward and fused-block entries add
"device_ms" (profiler sums), the flash backward "library_device_ms", the
fused-block entries "norm_err" (float32, its route's worst case), and the
tensor-core fused backward "stage_device_ms" (row kernel, weight-gradient
kernel, reduces). The "bounds" log lines add the flash
kernels' exponential floor (their exponentials alone at the MUFU pipes'
rate). The last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from multimodal_supernovae_tpu_torch.config import (
    build_clip_config,
    build_trainer_config,
    expand_grid,
    load_sweep,
    safe_load,
)
from multimodal_supernovae_tpu_torch.data import (
    epoch_indices,
    make_synthetic_arrays,
    make_synthetic_dataset,
    take,
)
from multimodal_supernovae_tpu_torch.evaluation import get_embeddings, predict_supervised
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
    "flash_attention_fwd_tf32": ("multimodal_supernovae_tpu_torch/csrc/flash_attention_fwd_tf32.cu",
                                 "multimodal_supernovae_tpu/ops/pallas_attention.py:85"),
    "flash_attention_bwd_tf32": ("multimodal_supernovae_tpu_torch/csrc/flash_attention_bwd_tf32.cu",
                                 "multimodal_supernovae_tpu/ops/pallas_attention.py:108"),
    "fused_ffn_fwd": ("multimodal_supernovae_tpu_torch/csrc/fused_ffn_fwd.cu",
                      "multimodal_supernovae_tpu/ops/fused_block.py:86"),
    "fused_ffn_fwd_mma": ("multimodal_supernovae_tpu_torch/csrc/fused_ffn_fwd_mma.cu",
                          "multimodal_supernovae_tpu/ops/fused_block.py:86"),
    "fused_ffn_bwd": ("multimodal_supernovae_tpu_torch/csrc/fused_ffn_bwd.cu",
                      "multimodal_supernovae_tpu/ops/fused_block.py:102"),
    "fused_ffn_bwd_mma": ("multimodal_supernovae_tpu_torch/csrc/fused_ffn_bwd_mma.cu",
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
# float32 fused-block and 3xTF32 flash outputs against their plain versions on
# the same inputs: ||got - want|| / ||want||. A CPU model of the fused-block
# kernels' arithmetic reads 2.2e-7 (forward) and at most 4.0e-7 (backward,
# every row, on the model's own ReLU mask) with 3xTF32 products; 3.2e-4 and
# 2.6e-4 to 4.7e-4 with one TF32 product (tests/test_torch_fused_block_kernel.py,
# the backward's printed under -rP); the flash model 2.1-2.3e-7 against
# 3.6-4.0e-4 (tests/test_torch_flash_tf32.py); the plain versions with TF32
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
               "flash bwd tensor cores, ffn fwd CUDA cores, ffn bwd CUDA cores, qkv fwd CUDA "
               "cores, qkv bwd CUDA cores, qkv fwd tensor cores, qkv bwd tensor cores, ffn fwd "
               "tensor cores, ffn bwd tensor cores, flash fwd 3xTF32, flash bwd 3xTF32)")
NONE = (0,) * 14  # no launch, in the order of COUNT_NAMES


def _tf32_flash(fwd, bwd):
    """Counts with ``fwd`` and ``bwd`` flash launches on the 3xTF32 route and
    none elsewhere: a float32 model whose every layer takes it."""
    return (0,) * 12 + (fwd, bwd)
# what the fused backward returns, in order
BWD_NAMES = ("datt", "dx", "dwu", "dbu", "dg1", "db1", "dwf1", "dbf1", "dwf2", "dbf2", "dg2",
             "db2")
# MUFU exponentials a clock on one SM (16), for the exponential floor beside
# the flash kernels' bound
EXP_PER_CLOCK_SM = 16
# phase run-dir: maven-lite from its own config, trained into run directories
MAVEN_LITE = "configs/maven-lite.yaml"
RUN_DIR_N, RUN_DIR_EPOCHS = 640, 3
# the resumed epoch against the straight run's, float32 on the card: the losses
# in relative terms, every parameter against its largest absolute value
RESUME_RTOL, RESUME_PARAM_TOL = 1e-5, 1e-5
# served and get_embeddings outputs against the in-memory model's encode
RUN_DIR_EMBED_TOL = 1e-6
RUN_DIR_FILES = ("config.yaml", "train_filenames.txt", "val_filenames.txt",
                 "model_config.json", "metrics.jsonl", "summary.json", "last.ckpt")
# phase towers: trimodal from its own config, quadrimodal bf16 (the conv and
# meta kwargs of benchmarks/profile_tpu.py:112-115), the supervised heads of
# configs/config_grid.yaml
TRIMODAL, GRID = "configs/trimodal.yaml", "configs/config_grid.yaml"
TOWERS_N, TOWERS_EPOCHS, IMAGE_SIZE, HEADS_EPOCHS = 640, 2, 60, 1
TOWERS_TRAJ_STEPS, TOWERS_TIMED = 6, 10
QUAD = ("host_galaxy", "lightcurve", "spectral", "meta")
QUAD_CONV = {"dim": 32, "depth": 8, "kernel_size": 5, "patch_size": 10, "n_out": 32,
             "dropout_prob": 0.0}
QUAD_META = {"input_dim": 128, "hidden_dim": 128, "num_layers": 2}
# what the two configs must give: ConvMixer (dim, depth, kernel, patch, n_out), LC
# and SP (emb, heads, depth, agg[, T_sp]), (B, compute dtype, image and magnitude
# noise, towers); the head's LC, towers, regression, B, compute dtype
TRIMODAL_STATED = ((32, 8, 5, 10, 32), (64, 8, 5, "mean"), (32, 2, 13, "mean", 1024),
                   (32, None, 1.0, 1.0, ("host_galaxy", "lightcurve", "spectral")))
HEADS_STATED = ((32, 2, 9, "mean"), ("lightcurve",), True, 256, None)


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


def _check_norm(got, want, what, tol=NORM_TOL):
    """The normalised error of an output (None where the plain output is
    zero); raises above ``tol`` (NORM_TOL for bf16 outputs)."""
    err = _norm_err(got, want)
    if err is not None and not err <= tol:
        raise AssertionError(f"{what}: ||got - want|| / ||want|| {err:.3e} (tol {tol})")
    return err


def _route_norm(got, want, dtype, route, what):
    """The normalised error of a flash output and its limit where the route
    has one: NORM_TOL for bf16, FP32_NORM_TOL for the 3xTF32 route (the
    float32 CUDA-core route is logged, not held); raises above it."""
    tol = (NORM_TOL if dtype == torch.bfloat16 else FP32_NORM_TOL if route == "tf32"
           else None)
    if tol is None:
        return _norm_err(got, want), None
    return _check_norm(got, want, what, tol), tol


def _tf32_control(what, got, want):
    """The control of FP32_NORM_TOL: the plain output with TF32 matmuls
    (``got``) must fail it against the float32 plain output ``want``."""
    err = _norm_err(got, want)
    log(f"{what}: the plain version with TF32 matmuls, ||err||/||plain|| {err:.3e} (must "
        f"exceed {FP32_NORM_TOL})")
    if not err > FP32_NORM_TOL:
        raise AssertionError(f"{what}: FP32_NORM_TOL cannot see TF32 products: {err:.3e}")
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


ROUTES = {"mma": contextlib.nullcontext, "tf32": contextlib.nullcontext, "simt": _simt_route}


def _routes(dtype, s, tensors):
    """The routes a case is checked on: both where ``_route`` takes the
    tensor cores (bf16 or 3xTF32), the CUDA cores alone elsewhere."""
    route = flash_mod._route(dtype, s, tensors)
    return (route, "simt") if route != "simt" else ("simt",)


def _route_counts(fn):
    """(bf16 tensor-core, 3xTF32) launches of a flash wrapper so far."""
    return fn.mma_launches, fn.tf32_launches


def _on_route(fn, before, route):
    """Whether one call of ``fn`` since ``before`` (_route_counts) took
    ``route``."""
    mma, tf32 = _route_counts(fn)
    return (mma - before[0], tf32 - before[1]) == (route == "mma", route == "tf32")


@contextlib.contextmanager
def _tf32_matmuls():
    """float32 matmuls in TF32 for the block (the controls), restored after."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _device_ops(fn, iters=25):
    """(kernel name, ms) of each device op of ``iters`` calls of ``fn``
    under torch.profiler, in the order they started, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in
            sorted(prof.events(), key=lambda e: e.time_range.start)
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def _device_ms(fn, iters=25):
    """ms of device time a call of ``fn``: the sum of its device ops'
    durations under torch.profiler over ``iters`` calls, after a warm-up.
    Unlike CUDA events around a call, it leaves out the host's pace."""
    return sum(ms for _, ms in _device_ops(fn, iters)) / iters


def _flash_cases(mask_lc, mask_sp, t_sp):
    """(name, (B, H, T, S), mask, encoder layout) of the flash checks: the
    two towers' shapes in the encoder's layout and contiguous, the light
    curve at config_grid's 2 heads of 16, a fully
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
        ("lc_h2", (BATCH, 2, 2 * LC_LEN, 16), mask_lc, True),
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


# the flash timings: (case, dtype) of the forward and backward phases (the
# serving and training shapes in both dtypes; the trimodal spectral shape, and
# the backward's spectral serving T, in float32, the trimodal step's dtype)
FWD_TIMED = {("lc", "bfloat16"), ("sp", "bfloat16"), ("lc", "float32"), ("sp", "float32"),
             ("sp_train", "float32"), ("sp_tri", "float32")}
BWD_TIMED = {("lc", "bfloat16"), ("sp", "bfloat16"), ("lc", "float32"), ("sp", "float32"),
             ("sp_t1024", "float32"), ("sp_tri", "float32")}
TIMING_NOTE = ("(plain: dense_attention, its autograd for the backward; library: "
               "scaled_dot_product_attention, its autograd for the backward; *_device: the "
               "sum of its device kernels under torch.profiler, 25 calls; *_host: the "
               "wrapper's host time a call on an idle card, median of 50; float32 with TF32 "
               "off)")


def phase_kernel():
    """The forward kernels of every route against dense_attention; times at
    the serving, training and trimodal shapes. Returns ({route: max|err|},
    {(case, dtype): times}, {route: largest normalised error})."""
    flash_attention = flash_mod.flash_attention
    syn = make_synthetic_arrays(n=BATCH, n_max_lc=LC_LEN, nband=NBAND,
                                n_max_sp=SP_LEN, seed=0)
    mask_lc = torch.from_numpy(syn["mask_lc"]).cuda()
    mask_sp = torch.from_numpy(syn["mask_sp"]).cuda()
    cases = _flash_cases(mask_lc, mask_sp, SP_LEN) + [
        ("sp_train", (BATCH, 2, TRAIN_SP_LEN, 16), mask_sp[:, :TRAIN_SP_LEN].contiguous(),
         True),
        ("sp_tri", (32, 2, SP_LEN, 16), mask_sp[:32].contiguous(), True),
        ("s64", (8, 1, 77, 64), mask_sp[:8, -77:].contiguous(), False)]
    gen = torch.Generator().manual_seed(0)
    max_err = {r: 0.0 for r in ROUTES}
    norm_err = {(r, d): 0.0 for r in ROUTES for d in ("float32", "bfloat16")}
    timing = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for name, (b, h, t, s), mask, layout in cases:
            if name in ("sp_train", "sp_tri") and dtype_name == "bfloat16":
                continue  # float32 timing shapes
            q, k, v = _heads(gen, b, h, t, s, dtype, layout)
            emb = h * s
            want = dense_attention(q, k, v, mask, emb)
            routes = _routes(dtype, s, (q, k, v))
            for route in routes:
                before = _route_counts(flash_attention)
                with ROUTES[route]():
                    got = flash_attention(q, k, v, mask, emb)
                torch.cuda.synchronize()
                if not _on_route(flash_attention, before, route):
                    raise AssertionError(f"{name} {dtype_name}: not on the {route} route")
                if got.dtype != dtype or got.shape != want.shape:
                    raise AssertionError(f"{name} {dtype_name}: got {got.dtype} "
                                         f"{tuple(got.shape)}")
                err = float((got.float() - want.float()).abs().max())
                max_err[route] = max(max_err[route], err)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=TOL[dtype_name], atol=TOL[dtype_name],
                                           msg=lambda m: f"{name} {dtype_name} {route}: {m}")
                rel, tol = _route_norm(got, want, dtype, route, f"{name} {dtype_name} {route}")
                norm_err[(route, dtype_name)] = max(norm_err[(route, dtype_name)], rel or 0.0)
                log(f"kernel {name} {dtype_name} {(b, h, t, s)} {route}: max|err| "
                    f"{err:.3e} (tol {TOL[dtype_name]}), ||err||/||plain|| {_fmt(rel)} (tol "
                    f"{tol})")
            if dtype == torch.float32 and name in ("lc", "sp"):
                with _tf32_matmuls():
                    control = dense_attention(q, k, v, mask, emb)
                _tf32_control(f"kernel {name} float32", control, want)
                del control
            if (name, dtype_name) in FWD_TIMED:
                times = {}
                for route in routes:
                    with ROUTES[route]():
                        times[route] = _time_ms(lambda: flash_attention(q, k, v, mask, emb))
                        times[f"{route}_device"] = _device_ms(
                            lambda: flash_attention(q, k, v, mask, emb))
                        times[f"{route}_host"] = _host_ms(
                            lambda: flash_attention(q, k, v, mask, emb))
                times["plain"] = _time_ms(lambda: dense_attention(q, k, v, mask, emb))
                times["library"] = _time_ms(lambda: _sdpa(q, k, v, mask, emb))
                times["library_device"] = _device_ms(lambda: _sdpa(q, k, v, mask, emb))
                timing[(name, dtype_name)] = times
                log(f"time {name} {dtype_name} {(b, h, t, s)}: "
                    + ", ".join(f"{r} {ms:.4f} ms" for r, ms in times.items())
                    + " " + TIMING_NOTE)
            del q, k, v, got, want
    torch.cuda.empty_cache()
    log(f"kernel: ||err||/||plain|| largest over the cases: " + ", ".join(
        f"{r} {d} {e:.3e}" for (r, d), e in norm_err.items() if e)
        + f" (tol: bf16 {NORM_TOL}, 3xTF32 {FP32_NORM_TOL})")
    return max_err, timing, norm_err


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
    """The backward kernels of every route against torch autograd through
    dense_attention (from one forward's output and stats: either forward
    feeds either backward); times at the training, serving and trimodal
    shapes. Returns ({route: max|err|}, {(case, dtype): times}, {route:
    largest normalised error}, {(case, dtype): the dq x 0.99 control's
    normalised error})."""
    fwd, bwd = flash_mod._flash_fwd, flash_mod.flash_attention_bwd
    syn = make_synthetic_arrays(n=BATCH, n_max_lc=LC_LEN, nband=NBAND,
                                n_max_sp=SP_LEN, seed=2)
    mask_lc = torch.from_numpy(syn["mask_lc"]).cuda()
    mask_sp = torch.from_numpy(syn["mask_sp"]).cuda()
    cases = _flash_cases(mask_lc, mask_sp, TRAIN_SP_LEN) + [
        ("sp_t1024", (BATCH, 2, SP_LEN, 16), mask_sp, True),
        ("sp_tri", (32, 2, SP_LEN, 16), mask_sp[:32].contiguous(), True)]
    gen = torch.Generator().manual_seed(1)
    max_err = {r: 0.0 for r in ROUTES}
    norm_err = {(r, d): 0.0 for r in ROUTES for d in ("float32", "bfloat16")}
    control = {}
    timing = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        tol = GRAD_TOL[dtype_name]
        for name, (b, h, t, s), mask, layout in cases:
            if name == "sp_tri" and dtype_name == "bfloat16":
                continue  # a float32 timing shape
            q, k, v = _heads(gen, b, h, t, s, dtype, layout)
            # the cotangent in the head merge's (B, T, H, S) memory order
            g = torch.randn((b, t, h, s), generator=gen).to("cuda", dtype).transpose(1, 2)
            emb = h * s
            out, stats = fwd(q, k, v, mask, emb, with_stats=True)
            want = dense_attention_bwd(q, k, v, mask, g, emb)
            routes = _routes(dtype, s, (q, k, v, out, g))
            for route in routes:
                before = _route_counts(flash_mod.flash_attention_bwd)
                with ROUTES[route]():
                    got = bwd(q, k, v, mask, out, stats, g, emb)
                torch.cuda.synchronize()
                if not _on_route(flash_mod.flash_attention_bwd, before, route):
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
                    rel, ntol = _route_norm(a, w, dtype, route,
                                            f"{name} {dtype_name} {route} {gname}")
                    norms.append(rel)
                if (name in ("masked_rows", "t77_s8", "t77_s16")
                        and (got[0][0].any() or got[1][0].any() or not got[2][0].any())):
                    raise AssertionError(f"{name} {route}: fully masked row: want dq = dk = 0, "
                                         "dv != 0")
                max_err[route] = max(max_err[route], *errs)
                norm_err[(route, dtype_name)] = max(norm_err[(route, dtype_name)],
                                                    *(e or 0.0 for e in norms))
                log(f"kernel-bwd {name} {dtype_name} {(b, h, t, s)} {route}: max|err| dq "
                    f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (tol {tol}); "
                    f"||err||/||plain|| dq {_fmt(norms[0])} dk {_fmt(norms[1])} dv "
                    f"{_fmt(norms[2])} (tol {ntol})")
                if route != "simt" and name in ("lc", "sp"):
                    # negative control: the tensor-core dq off by 1% must fail
                    with _wrong_dq() as wrong_bwd:
                        wrong = wrong_bwd(q, k, v, mask, out, stats, g, emb)
                    if _route_counts(wrong_bwd) != (route == "mma", route == "tf32"):
                        raise AssertionError(f"{name}: the control left the {route} route")
                    ctol = NORM_TOL if route == "mma" else FP32_NORM_TOL
                    err = control[(name, dtype_name)] = _norm_err(wrong[0], want[0])
                    log(f"kernel-bwd {name} {dtype_name} {WRONG_DQ} on the {route} route: "
                        f"||err||/||plain|| dq {err:.3e} (must exceed {ctol})")
                    if err <= ctol:
                        raise AssertionError(f"{name}: the normalised check cannot see a 1% "
                                             f"error in dq: {err:.3e}")
            if dtype == torch.float32 and name in ("lc", "sp"):
                with _tf32_matmuls():
                    ctl = dense_attention_bwd(q, k, v, mask, g, emb)
                for gname, a, w in zip(("dq", "dk", "dv"), ctl, want):
                    _tf32_control(f"kernel-bwd {name} float32 {gname}", a, w)
                del ctl
            if (name, dtype_name) in BWD_TIMED:
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
                timing[(name, dtype_name)] = times
                log(f"time-bwd {name} {dtype_name} {(b, h, t, s)}: "
                    + ", ".join(f"{r} {ms:.4f} ms" for r, ms in times.items())
                    + " " + TIMING_NOTE)
                del leaves, plain_out, lib_out
            del q, k, v, g, out, stats, got, want
    _near_equal_check(gen)
    torch.cuda.empty_cache()
    log(f"kernel-bwd: ||err||/||plain|| largest over the cases and dq/dk/dv: "
        + ", ".join(f"{r} {d} {e:.3e}" for (r, d), e in norm_err.items() if e)
        + f" (tol: bf16 {NORM_TOL}, 3xTF32 {FP32_NORM_TOL}); {WRONG_DQ}: " + ", ".join(
            f"{n} {d} {e:.3e}" for (n, d), e in control.items()))
    return max_err, timing, norm_err, control


def _near_equal_check(gen):
    """Where a row's values are nearly equal across its keys (a deep encoder
    layer), dP - D cancels: on (64, 8, 200, 8) float32 with v = v0 + 0.1
    noise, the 3xTF32 backward's dq, dk and dv must each sit within 2x the
    plain float32 version's distance to float64, plus 1e-7 of the largest
    value (the CUDA-core route's logged beside it)."""
    b, h, t, s = 64, 8, 2 * LC_LEN, 8
    q, k, _ = _heads(gen, b, h, t, s, torch.float32, True)
    v = (torch.randn((b, 1, h, s), generator=gen)
         + 0.1 * torch.randn((b, t, h, s), generator=gen)).cuda().transpose(1, 2)
    mask = torch.rand((b, t), generator=gen).cuda() > 0.3
    mask[:, 0] = True
    mask[0] = False
    g = torch.randn((b, t, h, s), generator=gen).cuda().transpose(1, 2)
    emb = h * s
    ref = _attention_f64_grads(q, k, v, mask, g, emb)
    plain = dense_attention_bwd(q, k, v, mask, g, emb)
    out, stats = flash_mod._flash_fwd(q, k, v, mask, emb, with_stats=True)
    if flash_mod._route(q.dtype, s, (q, k, v, out, g)) != "tf32":
        raise AssertionError("near-equal case: not on the 3xTF32 route")
    got = {"tf32": flash_mod.flash_attention_bwd(q, k, v, mask, out, stats, g, emb)}
    with _simt_route():
        got["simt"] = flash_mod.flash_attention_bwd(q, k, v, mask, out, stats, g, emb)
    for i, name in enumerate(("dq", "dk", "dv")):
        plain_err = _rel_f64(plain[i], ref[i])
        errs = {r: _rel_f64(a[i], ref[i]) for r, a in got.items()}
        log(f"kernel-bwd near-equal values {(b, h, t, s)} float32 {name}: max|x - float64| / "
            f"max|float64|: 3xTF32 {errs['tf32']:.3e}, CUDA cores {errs['simt']:.3e}, plain "
            f"{plain_err:.3e} (3xTF32 limit 2x plain + 1e-7)")
        if not errs["tf32"] <= 2 * plain_err + 1e-7:
            raise AssertionError(f"near-equal {name}: 3xTF32 {errs['tf32']:.3e} against "
                                 f"plain {plain_err:.3e}")


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
    """Every fused-block forward and backward on the CUDA-core kernels:
    ``fused_block._route`` patched (a test-time patch, no user knob)."""
    with mock.patch.object(ffn_mod, "_route", lambda *a: "simt"):
        yield


FFN_ROUTES = {"mma": contextlib.nullcontext, "simt": _ffn_simt_route}


@contextlib.contextmanager
def _ffn_kernel_mask():
    """Spy on fused_block._bwd_mma: the dict yielded gets the h scratch of
    each tensor-core backward (its h > 0 is the kernel's ReLU mask, which
    the plain version takes as ``relu_mask``); a CUDA-core backward leaves
    it empty."""
    seen, real = {}, ffn_mod._bwd_mma

    def spy(*args):
        out = real(*args)
        seen["h"] = out[3]
        return out

    with mock.patch.object(ffn_mod, "_bwd_mma", spy):
        yield seen


def _ffn_counts(c=None):
    """(CUDA-core, tensor-core) fused forward (or, given
    fused_ffn_block_bwd, backward) launches since _zero_counts."""
    c = c or ffn_mod.fused_ffn_block
    return c.launches - c.mma_launches, c.mma_launches


def _bwd_stages(ops, iters=25):
    """The tensor-core fused backward's device ms a call by stage, from
    _device_ops: the row kernel, the weight-gradient kernel (three
    launches; "wgrad_each" in launch order: dWf2, dWf1, dWu), the five
    reduces and the rest."""
    stages = {"rows": 0.0, "wgrad": 0.0, "reduce": 0.0, "other": 0.0}
    wgrad = []
    for name, ms in ops:
        key = next((k for k in ("rows", "wgrad", "reduce") if k in name), "other")
        stages[key] += ms / iters
        if key == "wgrad":
            wgrad.append(ms)
    stages["wgrad_each"] = [sum(wgrad[i::3]) / iters for i in range(3)]
    return stages


def _ffn_bwd_check(name, dtype_name, route, grads, want):
    """Each backward output against the plain version: within GRAD_TOL of
    its largest and, in float32 but db2, within FP32_NORM_TOL in the
    normalised error. Returns (max|err|, max|err|/max|plain| per output,
    the largest normalised error or None)."""
    rel, norms, worst = [], [], 0.0
    for out, a, w in zip(BWD_NAMES, grads, want):
        if a.dtype != w.dtype or a.shape != w.shape:
            raise AssertionError(f"ffn-bwd {name} {dtype_name} {route} {out}: "
                                 f"{a.dtype} {tuple(a.shape)}")
        d = float((a.float() - w.float()).abs().max())
        worst = max(worst, d)
        rel.append(d / float(w.float().abs().max()))
        if dtype_name == "float32" and out != "db2":
            norms.append(_norm_err(a, w))
    if max(rel) > GRAD_TOL[dtype_name]:
        raise AssertionError(f"ffn-bwd {name} {dtype_name} {route}: max|err|/max|plain| "
                             f"{dict(zip(BWD_NAMES, rel))} (tol {GRAD_TOL[dtype_name]})")
    if norms and not max(norms) <= FP32_NORM_TOL:
        raise AssertionError(f"ffn-bwd {name} float32 {route}: ||got - want|| / ||want|| "
                             f"{dict(zip(BWD_NAMES, norms))} (tol {FP32_NORM_TOL})")
    return worst, rel, max(norms) if norms else None


def phase_kernel_ffn():
    """The fused-block forward and backward of both routes against their
    plain versions; the TF32 controls; times at LC."""
    fwd, bwd = ffn_mod._ffn_fwd, ffn_mod.fused_ffn_block_bwd
    plain, plain_bwd = ffn_mod.fused_ffn_block_plain, ffn_mod.fused_ffn_block_bwd_plain
    eps = ffn_mod.LN_EPS
    cases = [("lc", FFN_ROWS, FFN_E, FFN_F), ("ragged", FFN_ROWS - 37, FFN_E, FFN_F),
             ("e128", FFN_ROWS // 4 - 5, 128, 512)]
    gen = torch.Generator().manual_seed(4)
    fwd_err, norm_err = {"mma": 0.0, "simt": 0.0}, {"mma": 0.0, "simt": 0.0}
    bwd_err, bwd_norm = {"mma": 0.0, "simt": 0.0}, {"mma": 0.0, "simt": 0.0}
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
            log(f"kernel-ffn {name} {dtype_name} (N, E, F) = {(n, e, f)}: forward "
                f"{'; '.join(said)} (tol {TOL[dtype_name]}"
                + (f", FP32_NORM_TOL {FP32_NORM_TOL}" if dtype == torch.float32 else "") + ")")
            want_bwd = plain_bwd(att, x, *params, g)
            for route in routes:  # one route for the forward and the backward
                with FFN_ROUTES[route](), _ffn_kernel_mask() as spied:
                    _zero_counts()
                    grads = bwd(att, x, *params, g)
                    torch.cuda.synchronize()
                    counts = _ffn_counts(ffn_mod.fused_ffn_block_bwd)
                if counts != ((0, 1) if route == "mma" else (1, 0)):
                    raise AssertionError(f"ffn-bwd {name} {dtype_name} {route}: launches (CUDA "
                                         f"cores, tensor cores) {counts}")
                want_r, said = want_bwd, ""
                if route == "mma":  # every row, on the kernel's own ReLU mask
                    pre_h, h = ffn_mod._forward_rows(att, x, *params, eps)[1][3:5]
                    torch.testing.assert_close(
                        spied["h"], h, rtol=TOL["float32"], atol=TOL["float32"],
                        msg=lambda m: f"ffn-bwd {name} float32 mma: recomputed h: {m}")
                    mask = spied["h"] > 0
                    flips = mask != (pre_h > 0)
                    nflip = int(flips.sum())
                    near = float(pre_h[flips].abs().max()) if nflip else 0.0
                    said = (f"; h max|err| {float((spied['h'] - h).abs().max()):.3e}, ReLU mask "
                            f"differs from the plain one at {nflip} of {flips.numel()} "
                            f"entries (|plain pre-activation| there at most {near:.3e})")
                    del pre_h, h, flips
                    want_r = plain_bwd(att, x, *params, g, relu_mask=mask)
                    del mask
                spied.clear()
                worst, rel, ne = _ffn_bwd_check(name, dtype_name, route, grads, want_r)
                bwd_err[route] = max(bwd_err[route], worst)
                if ne is not None:
                    bwd_norm[route] = max(bwd_norm[route], ne)
                log(f"kernel-ffn {name} {dtype_name} backward {route}: max|err|/max|plain| "
                    f"worst {max(rel):.3e}, datt {rel[0]:.3e} dx {rel[1]:.3e} dWu {rel[2]:.3e} "
                    f"dWf1 {rel[6]:.3e} dWf2 {rel[8]:.3e} (tol {GRAD_TOL[dtype_name]})"
                    + ("" if ne is None else
                       f"; ||err||/||plain|| worst but db2 {ne:.3e} (tol {FP32_NORM_TOL})")
                    + said)
                del grads, want_r
            if dtype == torch.float32 and name == "lc":
                # the controls: TF32 matmuls in the plain versions must fail the checks
                # (the backward's against the float32 plain version on the same,
                # TF32, ReLU mask, as the kernel is checked)
                saved = torch.backends.cuda.matmul.allow_tf32
                try:
                    torch.backends.cuda.matmul.allow_tf32 = True
                    control = _norm_err(plain(att, x, *params), want)
                    mask = ffn_mod._forward_rows(att, x, *params, eps)[1][4] > 0
                    tf32_bwd = plain_bwd(att, x, *params, g, relu_mask=mask)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = saved
                control_bwd = [_norm_err(a, w) for a, w in
                               zip(tf32_bwd, plain_bwd(att, x, *params, g, relu_mask=mask))]
                del mask, tf32_bwd
                seen = {k: control_bwd[BWD_NAMES.index(k)] for k in ("datt", "dx", "dwu", "dwf1")}
                log(f"kernel-ffn control: the plain versions with TF32 matmuls, ||err||/||plain|| "
                    f"forward {control:.3e}, backward "
                    + " ".join(f"{k} {v:.3e}" for k, v in seen.items())
                    + f" (each must exceed {FP32_NORM_TOL})")
                if not (control > FP32_NORM_TOL and min(seen.values()) > FP32_NORM_TOL):
                    raise AssertionError(f"the float32 check cannot see TF32 rounding: "
                                         f"{control}, {seen}")
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
                for route in routes + routes[::-1]:  # mma, simt, simt, mma
                    with FFN_ROUTES[route]():
                        tm.setdefault("bwd_" + route, []).append(
                            _time_ms(lambda: bwd(att, x, *params, g)))
                        if dtype == torch.float32 and f"bwd_{route}_device" not in tm:
                            ops = _device_ops(lambda: bwd(att, x, *params, g))
                            tm[f"bwd_{route}_device"] = sum(ms for _, ms in ops) / 25
                            if route == "mma":
                                tm["bwd_mma_stages"] = _bwd_stages(ops)
                for route in routes:
                    tm["bwd_" + route] = float(np.median(tm["bwd_" + route]))
                tm["bwd_plain"] = _time_ms(lambda: plain_bwd(att, x, *params, g))
                timing[dtype_name] = tm
                log(f"time-ffn lc {dtype_name} (N, E, F) = {(n, e, f)}: forward "
                    + ", ".join(f"{r} {tm[r]:.4f} ms" + (
                        f" (device {tm[r + '_device']:.4f} ms)" if r + "_device" in tm else "")
                        for r in routes)
                    + f", plain {tm['plain']:.4f} ms; backward "
                    + ", ".join(f"{r} {tm['bwd_' + r]:.4f} ms" + (
                        f" (device {tm[f'bwd_{r}_device']:.4f} ms)"
                        if f"bwd_{r}_device" in tm else "") for r in routes)
                    + f", plain {tm['bwd_plain']:.4f} ms")
                if "bwd_mma_stages" in tm:
                    st = tm["bwd_mma_stages"]
                    log("time-ffn lc float32 tensor-core backward, device ms by stage: "
                        + ", ".join(f"{k} {st[k]:.4f} ({100 * st[k] / tm['bwd_mma_device']:.1f}%)"
                                    for k in ("rows", "wgrad", "reduce", "other"))
                        + " (rows: the row kernel; wgrad: the weight-gradient kernel, three "
                        "launches, dWf2 / dWf1 / dWu "
                        + " / ".join(f"{v:.4f}" for v in st["wgrad_each"])
                        + "; reduce: the five block-order reduces)")
                if dtype == torch.float32:  # what the block count costs: whole waves
                    wave = (2 * torch.cuda.get_device_properties(0).multi_processor_count
                            * ffn_mod.MMA_ROWS)  # rows of one wave at 2 blocks an SM
                    waves = [_device_ms(lambda: fwd(att[:k * wave], x[:k * wave], *params,
                                                    eps=eps)) for k in (1, 2, 3)]
                    log(f"time-ffn waves, tensor cores float32: device {waves[0]:.4f} / "
                        f"{waves[1]:.4f} / {waves[2]:.4f} ms at 1 / 2 / 3 full waves of "
                        f"{wave} rows (two 64-row blocks an SM); LC is {n / wave:.3f} waves")
            del att, x, params, g, want, want_bwd
    torch.cuda.empty_cache()
    return fwd_err, norm_err, bwd_err, bwd_norm, timing


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
            # LC blocks compute in float32 (their attention on the 3xTF32 route),
            # every other layer in bf16 (tensor cores, the fused-QKV layers too);
            # the fused forward takes the tensor cores (3xTF32)
            n_qkv, n_f32 = SEQ_LC["depth"] * qkv, FUSED_PER_CALL * fused
            want = (0, 0, (LAYERS_PER_CALL - n_qkv - n_f32) * calls, 0,
                    0, 0, 0, 0, n_qkv * calls, 0, FUSED_PER_CALL * calls * fused, 0,
                    n_f32 * calls, 0)
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
               qkv_mod.fused_qkv_attention, qkv_mod.fused_qkv_attention_bwd,
               ffn_mod.fused_ffn_block, ffn_mod.fused_ffn_block_bwd):
        fn.launches = fn.mma_launches = 0
    for fn in (flash_mod.flash_attention, flash_mod.flash_attention_bwd):
        fn.tf32_launches = 0


def _counts():
    """Launches since _zero_counts, 14 numbers in the order of COUNT_NAMES:
    the flash forward and backward on the CUDA cores, then on the bf16
    tensor cores, the fused-block forward and backward on the CUDA cores,
    the fused-QKV forward and backward on the CUDA cores and on the tensor
    cores, the fused-block forward and backward on the tensor cores, then
    the flash forward and backward on the 3xTF32 tensor cores (forwards at
    even places). A route's CUDA-core count is its launches less those of
    its tensor-core routes."""
    fwd, bwd = flash_mod.flash_attention, flash_mod.flash_attention_bwd
    qfwd, qbwd = qkv_mod.fused_qkv_attention, qkv_mod.fused_qkv_attention_bwd
    ffn_simt, ffn_mma = _ffn_counts()
    ffn_bwd_simt, ffn_bwd_mma = _ffn_counts(ffn_mod.fused_ffn_block_bwd)
    return (fwd.launches - fwd.mma_launches - fwd.tf32_launches,
            bwd.launches - bwd.mma_launches - bwd.tf32_launches,
            fwd.mma_launches, bwd.mma_launches, ffn_simt, ffn_bwd_simt,
            qfwd.launches - qfwd.mma_launches, qbwd.launches - qbwd.mma_launches,
            qfwd.mma_launches, qbwd.mma_launches, ffn_mma, ffn_bwd_mma,
            fwd.tf32_launches, bwd.tf32_launches)


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
    wrong.launches = wrong.mma_launches = wrong.tf32_launches = 0
    return mock.patch.object(flash_mod, "flash_attention_bwd", wrong)


def _wrong_dwf1():
    """The fused kernel path with a wrong backward: every fused block's ff.0
    weight gradient off by 1%."""
    bwd = ffn_mod.fused_ffn_block_bwd

    def wrong(*args, **kw):
        grads = list(bwd(*args, **kw))
        grads[6] = grads[6] * 0.99  # (datt, dx, dwu, dbu, dg1, db1, dwf1, ...)
        return tuple(grads)

    # the wrapper counts on the module attribute it replaces, on either route
    wrong.launches = wrong.mma_launches = 0
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
    the 3xTF32 route unless the path patches the flash route, their forward
    and backward on the tensor cores (3xTF32) unless the path patches the
    fused route. Under the fused-QKV opt-in both towers (T = 200 and 220)
    take its kernels and the flash kernels none."""
    n = LAYERS_PER_CALL
    if path == "plain":
        return NONE
    if path == "qkv":  # bf16 at head dims 8 and 16: the tensor-core QKV kernels
        return (0,) * 8 + (n, n, 0, 0, 0, 0)
    if path == "kernel-simt":
        return (n, n) + (0,) * 12
    if path == "qkv-simt":
        return (0,) * 6 + (n, n) + (0,) * 6
    f = FUSED_PER_CALL if PATHS[path][0] else 0
    simt, mma = f * (path == "fused-simt"), f * (path != "fused-simt")
    return (0, 0, n - f, n - f, simt, simt, 0, 0, 0, 0, mma, mma, f, f)


def _f32_step_counts(path):
    """Launches per float32 train step on ``path`` (the trajectory and
    gradient checks): the flash kernels on the 3xTF32 route (the CUDA cores
    where the path patches the route), the fused-QKV ones on the CUDA cores,
    the fused forward and backward on the tensor cores (3xTF32 takes
    float32)."""
    c = _step_counts(path)
    return (c[0], c[1], 0, 0, c[4], c[5], c[6] + c[8], c[7] + c[9], 0, 0, c[10], c[11],
            c[2] + c[12], c[3] + c[13])


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
    """The float32 steps' launches (_f32_step_counts), none on a plain path
    (the negative controls replace a wrapper and are not counted)."""
    counts = _counts()
    if path in (WRONG_DQ, WRONG_DWF1, WRONG_DWQ):
        return counts
    want = NONE if "plain" in path else tuple(c * steps for c in _f32_step_counts(path))
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
    timed_counts = NONE
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


def _rel_f64(got, ref):
    """max|got - ref| / max|ref| against a float64 reference."""
    return float((got.double() - ref).abs().max() / ref.abs().max())


def _probe_batch():
    """The first batch of the float32 trajectory's plan, on the card."""
    ds = make_synthetic_dataset(n=TRAIN_N, n_max_lc=LC_LEN, nband=NBAND,
                                n_max_sp=TRAIN_SP_LEN, seed=0)
    plan = epoch_indices(TRAIN_N, BATCH, rng=np.random.default_rng(0), shuffle=True,
                         pad="drop")
    return take(ds.to_device(DEVICE), torch.from_numpy(plan[0]).to(DEVICE))


def phase_grad_probe():
    """Where the kernel paths' float32 whole-model gradients part from the
    plain path's. Flash: every attention call of one float32 loss on the
    plain path is recorded with its cotangent, and on each layer's own inputs
    the flash backward of both float32 routes (3xTF32 as routed, D - c0 as
    rowsum(P o g . (v - v0)); the CUDA cores, D as c0 + rowsum(P o (dP -
    c0))), dense_attention's autograd and the plain backward with either D
    (g . out, which the CUDA-core kernel took before, or rowsum(P o dP)) are
    read against a float64 reference. Fused QKV: _qkv_grad_probe. A
    diagnostic: it logs, it checks nothing; returns the fused-QKV readings."""
    batch = _probe_batch()
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

    rel = _rel_f64
    for i, rec in enumerate(calls):
        (q, k, v), mask, emb, g = rec["qkv"], rec["mask"], rec["emb"], rec["g"]
        ref = _attention_f64_grads(q, k, v, mask, g, emb)
        plain = dense_attention_bwd(q, k, v, mask, g, emb)
        out, stats = flash_mod._flash_fwd(q, k, v, mask, emb, with_stats=True)
        route = flash_mod._route(q.dtype, q.shape[-1], (q, k, v, out, g))
        kern = flash_mod.flash_attention_bwd(q, k, v, mask, out, stats, g, emb)
        with _simt_route():
            simt = flash_mod.flash_attention_bwd(q, k, v, mask, out, stats, g, emb)
        d_out = _dq_with_d(q, k, v, mask, g, emb, True)
        d_rowsum = _dq_with_d(q, k, v, mask, g, emb, False)
        log(f"grad-probe layer {i} {tuple(q.shape)}: max|x - float64| / max|float64| dq, dk, "
            f"dv: flash kernel ({route} route) {rel(kern[0], ref[0]):.3e} "
            f"{rel(kern[1], ref[1]):.3e} {rel(kern[2], ref[2]):.3e}; CUDA-core flash kernel "
            f"{rel(simt[0], ref[0]):.3e} {rel(simt[1], ref[1]):.3e} "
            f"{rel(simt[2], ref[2]):.3e}; "
            f"dense_attention autograd {rel(plain[0], ref[0]):.3e} "
            f"{rel(plain[1], ref[1]):.3e} {rel(plain[2], ref[2]):.3e}; plain dq with D = g.out "
            f"{rel(d_out, ref[0]):.3e}, with rowsum(P o dP) {rel(d_rowsum, ref[0]):.3e}")
        del ref, plain, out, stats, kern, simt, d_out, d_rowsum
    del calls, model
    torch.cuda.empty_cache()
    return _qkv_grad_probe(batch)


def _qkv_f64_grads(x, mask, wqkv, wu, g, heads):
    """dx and dWqkv of the whole SelfAttention's function (packed projection,
    masked attention, unify) in float64, the reference the fused-QKV
    backwards are read against."""
    with torch.enable_grad():
        x64 = x.detach().double().requires_grad_()
        w64 = wqkv.detach().double().requires_grad_()
        b, t, e = x.shape
        q, k, v = (a.reshape(b, t, heads, e // heads).transpose(1, 2)
                   for a in (x64 @ w64.t()).chunk(3, dim=-1))
        scores = q @ k.transpose(-1, -2)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :], -1e7)
        att = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, t, e)
        out = att @ wu.detach().double().t()
        return torch.autograd.grad(out, (x64, w64), g.double())


def _qkv_grad_probe(batch):
    """Every fused-QKV layer of one float32 loss under MMSN_FUSED_QKV=1 (all
    18 SelfAttention layers), its inputs and cotangent recorded on the plain
    path: dx and dWqkv of the CUDA-core backward (csrc/fused_qkv_bwd.cu) and of
    the plain version, each against float64. Returns, for dx and dWqkv, the
    largest ratio of the kernel's distance to the plain version's over the
    layers, and at which layer."""
    calls = []

    def recording(x, mask, wqkv, wu, g, heads):
        calls.append((x.detach(), mask, wqkv.detach(), wu.detach(), g.detach(), heads))
        return qkv_mod.fused_qkv_attention_bwd_plain(x, mask, wqkv, wu, g, heads)

    kernel_bwd = qkv_mod.fused_qkv_attention_bwd
    model = _train_model(None)
    with _qkv_plain(), mock.patch.object(qkv_mod, "fused_qkv_attention_bwd", recording):
        loss, _ = model.loss_fn(batch, train=True, generator=torch.Generator(device=DEVICE))
        loss.backward()
    if len(calls) != LAYERS_PER_CALL:
        raise AssertionError(f"grad-probe qkv: {len(calls)} fused-QKV layers recorded, "
                             f"want {LAYERS_PER_CALL}")
    worst = {"dx": (0.0, -1), "dwqkv": (0.0, -1)}
    for i, (x, mask, wqkv, wu, g, heads) in enumerate(calls):
        ref = _qkv_f64_grads(x, mask, wqkv, wu, g, heads)
        _zero_counts()
        kern = kernel_bwd(x, mask, wqkv, wu, g, heads)
        if _counts()[7] != 1:
            raise AssertionError(f"grad-probe qkv: launches {_counts()}, want one "
                                 "CUDA-core fused-QKV backward")
        plain = qkv_mod.fused_qkv_attention_bwd_plain(x, mask, wqkv, wu, g, heads)
        parts = []
        for j, name in enumerate(("dx", "dwqkv")):
            k_err, p_err = _rel_f64(kern[j], ref[j]), _rel_f64(plain[j], ref[j])
            ratio = k_err / max(p_err, 1e-30)
            worst[name] = max(worst[name], (ratio, i))
            parts.append(f"{name} kernel {k_err:.3e}, plain {p_err:.3e} ({ratio:.2f}x)")
        log(f"grad-probe qkv layer {i} {tuple(x.shape)} heads {heads}: max|x - float64| / "
            f"max|float64|: {'; '.join(parts)}")
        del ref, kern, plain
    del calls, model
    torch.cuda.empty_cache()
    log(f"grad-probe qkv: the CUDA-core backward's distance to float64 over the plain "
        f"version's, worst over the layers: dx {worst['dx'][0]:.2f}x (layer "
        f"{worst['dx'][1]}), dWqkv {worst['dwqkv'][0]:.2f}x (layer {worst['dwqkv'][1]})")
    return worst


def _run_dir_fit(clip_cfg, tcfg, run_dir, train_ds, val_ds, dump, resume=False, seed=0):
    """Trainer.fit of a fresh maven-lite model (seeded weights) into
    ``run_dir`` on the card, counted from zero; returns the result, the
    launches and the wall seconds."""
    model = CLIPModel(clip_cfg, generator=torch.Generator().manual_seed(seed)).to(DEVICE)
    trainer = Trainer(model, "contrastive", tcfg, run_dir=run_dir)
    with _plain_calls() as plain:
        _zero_counts()
        t0 = time.perf_counter()
        result = trainer.fit(train_ds, val_ds, config_dump=dump, resume=resume)
        wall = time.perf_counter() - t0
        counts = _counts()
    if plain:
        raise AssertionError(f"run-dir: {len(plain)} plain kernel calls in Trainer.fit")
    return result, counts, wall


def _check_run_dir(path, dump, n_train, n_val, epochs):
    """Every file of the run directory, as described: config.yaml that the
    port's reader parses to the dump, the manifests, the sidecar, one metrics
    row an epoch (``epochs``, in order), the summary, the best two epoch=
    files and last.ckpt."""
    files = set(os.listdir(path))
    missing = [f for f in RUN_DIR_FILES if f not in files]
    kept = sorted(f for f in files if f.startswith("epoch=") and f.endswith(".ckpt"))
    with open(os.path.join(path, "config.yaml")) as f:
        config = safe_load(f.read())
    lines = {}
    for name in ("train_filenames.txt", "val_filenames.txt"):
        with open(os.path.join(path, name)) as f:
            lines[name] = len(f.read().splitlines())
    with open(os.path.join(path, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(path, "summary.json")) as f:
        summary = json.load(f)
    log(f"run-dir {os.path.basename(path)}: files {sorted(files)}; manifests {lines}; "
        f"metrics rows of epochs {[r['epoch'] for r in rows]}; summary {summary}")
    want_summary = {"best_val_loss", "best_epoch", "best_ckpt_epoch", "best_auc"}
    if (missing or len(kept) != 2 or config != dump
            or lines != {"train_filenames.txt": n_train, "val_filenames.txt": n_val}
            or [r["epoch"] for r in rows] != epochs or not want_summary <= set(summary)):
        raise AssertionError(f"run-dir {path}: missing {missing}, kept {kept}, config "
                             f"equal to the dump {config == dump}, manifests {lines}, rows "
                             f"{[r['epoch'] for r in rows]} (want {epochs}), summary {summary}")


def phase_run_dir():
    """maven-lite from the first grid point of its own config, read by the
    port, trained on the card into run directory A (3 epochs) and into B (2
    epochs, then a new Trainer resumed to 3); both directories checked file by
    file; B's resumed epoch held to A's epoch 2; A served by load_model and
    load_live and read by get_embeddings, each held to the in-memory model's
    encode. Returns the launches of every call."""
    t_phase = time.perf_counter()
    sweep = load_sweep(MAVEN_LITE)
    point = next(expand_grid(sweep))
    extra = sweep.extra_args
    clip_cfg = build_clip_config(point, extra, nband=NBAND)
    tcfg = build_trainer_config(point, extra)
    log(f"run-dir: {MAVEN_LITE}, first of {sweep.n_points} grid points; override: epochs "
        f"{tcfg.epochs} -> {RUN_DIR_EPOCHS}")
    tcfg = dataclasses.replace(tcfg, epochs=RUN_DIR_EPOCHS)
    dump = dict(point, epochs=RUN_DIR_EPOCHS)
    tk, tsk = clip_cfg.tk(), clip_cfg.tsk()
    log(f"run-dir: LC {tk}; SP {tsk}; enc_dim {clip_cfg.enc_dim}, loss {clip_cfg.loss}, "
        f"compute dtype {clip_cfg.compute_dtype or 'float32'}; trainer {tcfg}")
    stated = ((tk["emb"], tk["heads"], tk["depth"], tk["agg"], tk["n_out"]),
              (tsk["emb"], tsk["heads"], tsk["depth"], tsk["agg"]),
              (tcfg.batch_size, clip_cfg.compute_dtype, clip_cfg.loss, tcfg.noise_level_mag))
    if stated != ((64, 8, 5, "attn", 32), (32, 2, 13, "mean"), (32, None, "softmax", 1.0)):
        raise AssertionError(f"run-dir: {MAVEN_LITE} does not give maven-lite: {stated}")
    sp_len, batch = int(extra["max_spectral_data_len"]), tcfg.batch_size
    ds = make_synthetic_dataset(n=RUN_DIR_N, n_max_lc=LC_LEN, nband=NBAND, n_max_sp=sp_len,
                                seed=0)
    train_ds, val_ds = _split(ds, extra["val_fraction"])
    n_train, n_val = len(train_ds), len(val_ds)
    train_steps, eval_steps = -(-n_train // batch), -(-n_val // batch)

    def want(epochs):  # every layer float32: the flash kernels on the 3xTF32 route
        return _tf32_flash(LAYERS_PER_CALL * epochs * (train_steps + eval_steps),
                           LAYERS_PER_CALL * epochs * train_steps)

    total = NONE
    with tempfile.TemporaryDirectory() as tmp:
        dir_a, dir_b = os.path.join(tmp, "A"), os.path.join(tmp, "B")
        fits = {}
        for tag, path, epochs, resume, seed in (("A", dir_a, 3, False, 0),
                                                ("B", dir_b, 2, False, 0),
                                                ("B resumed", dir_b, 3, True, 1)):
            result, counts, wall = _run_dir_fit(
                clip_cfg, dataclasses.replace(tcfg, epochs=epochs), path, train_ds, val_ds,
                dump, resume=resume, seed=seed)
            ran = epochs - (2 if resume else 0)
            for row in result["metric_rows"][-ran:]:
                log(f"run-dir {tag}: epoch {row['epoch']} train_loss {row['train_loss']:.7f} "
                    f"val_loss {row['val_loss']:.7f} AUC_val {row['AUC_val']:.4f} step "
                    f"{row['step_time_s'] * 1e3:.2f} ms")
            log(f"run-dir {tag}: Trainer.fit {ran} epochs ({ran * train_steps} train + "
                f"{ran * eval_steps} eval steps at B={batch}, T_sp={sp_len}, float32) in "
                f"{wall:.3f} s; launches {COUNT_NAMES} {counts}")
            if counts != want(ran) or result["epochs_run"] != epochs:
                raise AssertionError(f"run-dir {tag}: launches {counts}, want {want(ran)}; "
                                     f"epochs run {result['epochs_run']}")
            total = tuple(a + b for a, b in zip(total, counts))
            if tag == "B":  # the first model of B goes before the resumed one is built
                del result
                torch.cuda.empty_cache()
            else:
                fits[tag] = result
        _check_run_dir(dir_a, dump, n_train, n_val, [0, 1, 2])
        _check_run_dir(dir_b, dump, n_train, n_val, [0, 1, 2])

        # B's resumed epoch against A's epoch 2
        a, b = fits["A"], fits["B resumed"]
        rels = {k: abs(b["metric_rows"][2][k] - a["metric_rows"][2][k])
                / abs(a["metric_rows"][2][k]) for k in ("train_loss", "val_loss")}
        params_a = a["state"].model.state_dict()
        params_b = b["state"].model.state_dict()
        perr = {n: float((params_b[n] - p).abs().max() / p.abs().max())
                for n, p in params_a.items()}
        worst = max(perr, key=perr.get)
        n_equal = sum(torch.equal(params_b[n], p) for n, p in params_a.items())
        log(f"run-dir resume: epoch 2 of B (resumed) against A: train_loss relative "
            f"{rels['train_loss']:.3e}, val_loss {rels['val_loss']:.3e} (tol {RESUME_RTOL}); "
            f"parameters max|B - A| / max|A| worst {perr[worst]:.3e} at {worst} (tol "
            f"{RESUME_PARAM_TOL}), {n_equal} of {len(perr)} bitwise equal; global step "
            f"{b['state'].step} and {a['state'].step}")
        if (max(rels.values()) > RESUME_RTOL or perr[worst] > RESUME_PARAM_TOL
                or b["state"].step != a["state"].step):
            raise AssertionError(f"run-dir: the resumed run leaves the straight one: {rels}, "
                                 f"{worst} {perr[worst]}")
        del b, params_a, params_b, fits["B resumed"]
        torch.cuda.empty_cache()

        # serving A, and its embeddings, against the in-memory final model
        model_a = a["state"].model.eval()
        fields = ("x_lc", "t_lc", "mask_lc", "x_sp", "t_sp", "mask_sp")
        feed = {k: val_ds.arrays[k][:batch] for k in fields}
        with torch.no_grad():
            want_emb = [e.float().cpu().numpy() for e in model_a.encode(
                {k: torch.from_numpy(v).to(DEVICE) for k, v in feed.items()})]
        loaded, _ = load_model(dir_a, DEVICE, which="last")
        serving_model = load_live(dir_a, batch, device=DEVICE, which="last", lc_len=LC_LEN,
                                  sp_len=sp_len)
        with _plain_calls() as plain, torch.no_grad():
            _zero_counts()
            got_loaded = [e.float().cpu().numpy() for e in loaded.encode(
                {k: torch.from_numpy(v).to(DEVICE) for k, v in feed.items()})]
            served = serving_model.fn(feed)
            serve_counts = _counts()
        errs = {"load_model": max(float(np.abs(g - w).max())
                                  for g, w in zip(got_loaded, want_emb)),
                "load_live": max(float(np.abs(g - w).max()) for g, w in zip(served, want_emb))}
        shapes = [s.shape for s in served]
        want_serve = _tf32_flash(2 * LAYERS_PER_CALL, 0)
        log(f"run-dir serve: load_model and load_live of A (last.ckpt), {batch} validation "
            f"samples: {shapes}, max|x - encode| {errs} (tol {RUN_DIR_EMBED_TOL}); launches "
            f"{serve_counts}, {len(plain)} plain kernel calls")
        if (max(errs.values()) > RUN_DIR_EMBED_TOL or plain or serve_counts != want_serve
                or shapes != [(min(batch, n_val), clip_cfg.enc_dim)] * 2):
            raise AssertionError(f"run-dir serve: {errs}, launches {serve_counts} (want "
                                 f"{want_serve}), {len(plain)} plain calls, shapes {shapes}")

        with _plain_calls() as plain:
            _zero_counts()
            embs, names = get_embeddings(model_a, val_ds, batch_size=batch, device=DEVICE)
            emb_counts = _counts()
        val_data = val_ds.to_device(DEVICE)
        with torch.no_grad():
            per_batch = [model_a.encode(take(val_data, idx)) for idx in
                         torch.arange(n_val, device=DEVICE).split(batch)]
        want_all = [torch.cat([p[i] for p in per_batch]).float().cpu().numpy()
                    for i in range(2)]
        err = max(float(np.abs(g - w).max()) for g, w in zip(embs, want_all))
        want_emb_counts = _tf32_flash(LAYERS_PER_CALL * eval_steps, 0)
        log(f"run-dir get_embeddings: {names} {[e.shape for e in embs]} over the {n_val} "
            f"validation samples, max|x - per-batch encode| {err:.3e} (tol "
            f"{RUN_DIR_EMBED_TOL}); launches {emb_counts}, {len(plain)} plain kernel calls")
        if (err > RUN_DIR_EMBED_TOL or names != ["lightcurve", "spectral"] or plain
                or emb_counts != want_emb_counts):
            raise AssertionError(f"run-dir get_embeddings: {err}, {names}, launches "
                                 f"{emb_counts} (want {want_emb_counts})")
        total = tuple(a + b + c for a, b, c in zip(total, serve_counts, emb_counts))
    log(f"run-dir: phase done in {time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


def _host_step_ms(step, state, batch, gen, n):
    """Host-clock ms of each of ``n`` train steps, each ended by a
    synchronise, after 2 warm-up steps; and the last loss."""
    for _ in range(2):
        step(state, batch, gen)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, loss


def _check_counts(tag, counts, want):
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, want {want}")


def _bn_buffers_moved(tag, sd, steps):
    """Every BatchNorm buffer of the image tower finite and away from its
    initial value (running mean 0, variance 1, count 0); the count equals the
    train steps."""
    bufs = {k: v for k, v in sd.items() if k.startswith("image_encoder.")
            and ("running" in k or "num_batches" in k)}
    bad = [k for k, v in bufs.items() if not torch.isfinite(v.float()).all()
           or (("running_mean" in k and not v.abs().max() > 0)
               or ("running_var" in k and not (v - 1).abs().max() > 0)
               or ("num_batches" in k and int(v) != steps))]
    log(f"{tag}: {len(bufs)} BatchNorm buffers in last.ckpt, every one finite and moved "
        f"from its start: {not bad}; running_var range [{min(float(v.min()) for k, v in bufs.items() if 'var' in k):.4g}, "
        f"{max(float(v.max()) for k, v in bufs.items() if 'var' in k):.4g}]")
    if bad or not bufs:
        raise AssertionError(f"{tag}: BatchNorm buffers not finite or not moved: {bad}")


@contextlib.contextmanager
def _relu_masks(model, masks):
    """With ``masks`` empty, records the mask (input > 0) of each nn.ReLU call
    of ``model`` into it; else applies those masks, in call order, in place of
    the calls' own and yields the list of how many units each call would have
    put on the other side. Two float32 paths whose forwards differ by rounding
    can put a unit on either side of the kink, which moves its weight and bias
    gradients by a finite amount whatever the kernels' accuracy."""
    replay, flips = bool(masks), []

    def hook(module, inputs, out):
        if not replay:
            masks.append(out > 0)
            return None
        mask = masks[len(flips)]
        flips.append(int(((inputs[0] > 0) != mask).sum()))
        return inputs[0] * mask

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.ReLU)]
    try:
        yield flips
    finally:
        for h in hooks:
            h.remove()
    if replay and len(flips) != len(masks):
        raise AssertionError(f"ReLU calls {len(flips)}, recorded {len(masks)}")


def _towers_grads(tag, cfg, batch, per_step):
    """Every parameter's gradient of one float32 train-mode loss (noise off)
    from ``cfg``'s seeded weights on ``batch``: the kernel path held to the
    plain path, and the kernel path with every dq off by 1% shown to fail
    the same check, as phase_train holds them. Both take the plain path's
    ReLU masks (_relu_masks); the kernel path on its own masks is logged,
    not held. Returns the kernel path's launches, which must be
    ``per_step``."""
    grads, counts, masks, flips = {}, {}, [], {}
    for name, path in (("plain", "plain"), ("kernel", "kernel"), (WRONG_DQ, WRONG_DQ),
                       ("kernel, own masks", "kernel")):
        model = CLIPModel(cfg, generator=torch.Generator().manual_seed(0)).to(DEVICE)
        replay = [] if name == "kernel, own masks" else masks
        with PATHS[path][1](), _relu_masks(model, replay) as flips[name]:
            _zero_counts()
            loss, _ = model.loss_fn(batch, train=True,
                                    generator=torch.Generator(device=DEVICE).manual_seed(4))
            loss.backward()
            counts[name] = _counts()
        grads[name] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        del model
    _check_counts(f"{tag} grads plain", counts["plain"], NONE)
    _check_counts(f"{tag} grads", counts["kernel"], per_step)
    want, errs, b = grads["plain"], {}, len(next(iter(batch.values())))
    for name in ("kernel", WRONG_DQ, "kernel, own masks"):
        if sorted(grads[name]) != sorted(want):
            raise AssertionError(f"{tag} {name}: gradients of "
                                 f"{sorted(set(grads[name]) ^ set(want))}")
        worst, errs[name] = _grad_error(grads[name], want)
        masks_of = ("its own ReLU masks (not held)" if name == "kernel, own masks" else
                    f"the plain path's masks of {len(masks)} ReLU calls (units its own "
                    f"forward would flip: {sum(flips[name])})")
        log(f"{tag} grads float32, {len(want)} parameters at B={b}: {name!r} on "
            f"{masks_of}, worst max|diff|/max|plain| {errs[name]:.3e} at {worst} (tol "
            f"{GRAD_RTOL})")
    if errs["kernel"] > GRAD_RTOL:
        raise AssertionError(f"{tag}: the kernel path's gradients leave the plain path's: "
                             f"{errs}")
    if errs[WRONG_DQ] <= GRAD_RTOL:
        raise AssertionError(f"{tag}: the gradient check cannot see a 1% error: {errs}")
    return counts["kernel"]


def _split(ds, val_fraction):
    n_val = int(round(len(ds) * float(val_fraction)))
    n_train = len(ds) - n_val
    return ds.subset(np.arange(n_train)), ds.subset(np.arange(n_train, len(ds)))


def _towers_trimodal(card):
    """trimodal from the first grid point of configs/trimodal.yaml: fit into a
    run dir, BN buffers, task metrics, serving with images, the float32
    trajectory and parameter gradients against the plain path, step time and
    a profile."""
    sweep = load_sweep(TRIMODAL)
    point, extra = next(expand_grid(sweep)), sweep.extra_args
    clip_cfg = build_clip_config(point, extra, nband=NBAND)
    tcfg = build_trainer_config(point, extra)
    log(f"towers trimodal: {TRIMODAL}, first of {sweep.n_points} grid points; override: "
        f"epochs {tcfg.epochs} -> {TOWERS_EPOCHS}")
    tcfg = dataclasses.replace(tcfg, epochs=TOWERS_EPOCHS)
    tk, tsk, ck = clip_cfg.tk(), clip_cfg.tsk(), clip_cfg.ck()
    sp_len = int(extra["max_spectral_data_len"])
    stated = ((ck["dim"], ck["depth"], ck["kernel_size"], ck["patch_size"], ck["n_out"]),
              (tk["emb"], tk["heads"], tk["depth"], tk["agg"]),
              (tsk["emb"], tsk["heads"], tsk["depth"], tsk["agg"], sp_len),
              (tcfg.batch_size, clip_cfg.compute_dtype, tcfg.noise_level_img,
               tcfg.noise_level_mag, clip_cfg.combinations))
    log(f"towers trimodal: ConvMixer {ck}; LC {tk}; SP {tsk}; enc_dim {clip_cfg.enc_dim}; "
        f"trainer {tcfg}")
    if stated != TRIMODAL_STATED:
        raise AssertionError(f"towers: {TRIMODAL} does not give the stated widths: {stated}")
    ds = make_synthetic_dataset(n=TOWERS_N, n_max_lc=LC_LEN, nband=NBAND, n_max_sp=sp_len,
                                image_size=IMAGE_SIZE, modalities=clip_cfg.combinations,
                                seed=0)
    train_ds, val_ds = _split(ds, extra["val_fraction"])
    batch = tcfg.batch_size
    train_steps, eval_steps = -(-len(train_ds) // batch), -(-len(val_ds) // batch)
    per_step = _f32_step_counts("kernel")  # float32: the 3xTF32 flash kernels
    epochs = TOWERS_EPOCHS
    want_fit = tuple(a * epochs * (train_steps + eval_steps) if i % 2 == 0 else
                     a * epochs * train_steps for i, a in enumerate(per_step))
    total = NONE
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "trimodal")
        model = CLIPModel(clip_cfg, generator=torch.Generator().manual_seed(0)).to(DEVICE)
        trainer = Trainer(model, "contrastive", tcfg, run_dir=run_dir)
        with _plain_calls() as plain:
            _zero_counts()
            t0 = time.perf_counter()
            result = trainer.fit(train_ds, val_ds, config_dump=dict(point, epochs=epochs))
            wall = time.perf_counter() - t0
            counts = _counts()
        log(f"towers trimodal: Trainer.fit {epochs} epochs ({epochs * train_steps} train + "
            f"{epochs * eval_steps} eval steps at B={batch}, {IMAGE_SIZE}x{IMAGE_SIZE} images, "
            f"T_sp={sp_len}, float32) in {wall:.3f} s; launches {counts}, {len(plain)} plain "
            "kernel calls")
        _check_counts("towers trimodal fit", counts, want_fit)
        if plain:
            raise AssertionError(f"towers trimodal: {len(plain)} plain kernel calls")
        total = tuple(a + b for a, b in zip(total, counts))
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        keys = ("train_loss", "val_loss", "AUC_val1", "AUC_val2", "AUC_val3", "AUC_val_mean")
        for row in rows:
            log(f"towers trimodal: epoch {row['epoch']} " + ", ".join(
                f"{k} {row.get(k, float('nan')):.6f}" for k in keys)
                + f", step {row['step_time_s'] * 1e3:.2f} ms")
        if len(rows) != epochs or not all(
                k in r and np.isfinite(r[k]) for r in rows for k in keys):
            raise AssertionError(f"towers trimodal: metrics.jsonl rows {rows}")
        ckpt = torch.load(os.path.join(run_dir, "last.ckpt"), map_location="cpu",
                          weights_only=True)
        _bn_buffers_moved("towers trimodal", ckpt["state_dict"], epochs * train_steps)

        # serving the run dir with images, against the in-memory model's encode
        model = result["state"].model.eval()
        fields = ("x_img", "x_lc", "t_lc", "mask_lc", "x_sp", "t_sp", "mask_sp")
        feed = {k: val_ds.arrays[k][:batch] for k in fields}
        with torch.no_grad():
            want_emb = [e.float().cpu().numpy() for e in model.encode(
                {k: torch.from_numpy(v).to(DEVICE) for k, v in feed.items()})]
        served = load_live(run_dir, batch, device=DEVICE, which="last", lc_len=LC_LEN,
                           sp_len=sp_len, image_size=IMAGE_SIZE)
        with _plain_calls() as plain, torch.no_grad():
            _zero_counts()
            got = served.fn(feed)
            serve_counts = _counts()
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want_emb))
        log(f"towers trimodal serve: load_live (x_img {served.input_spec['x_img'][0]}), "
            f"{batch} samples: {[g.shape for g in got]}, max|served - encode| {err:.3e} (tol "
            f"{RUN_DIR_EMBED_TOL}); launches {serve_counts}, {len(plain)} plain calls")
        _check_counts("towers trimodal serve", serve_counts, _tf32_flash(LAYERS_PER_CALL, 0))
        if (err > RUN_DIR_EMBED_TOL or plain or len(got) != 3
                or served.input_spec["x_img"][0] != feed["x_img"].shape[1:]):
            raise AssertionError(f"towers trimodal serve: {err}, {len(plain)} plain calls")
        total = tuple(a + b for a, b in zip(total, serve_counts))
        del result, trainer, model, served

    # the float32 trajectory on the kernel path against the plain path
    plan = epoch_indices(len(train_ds), batch, rng=np.random.default_rng(1), shuffle=True,
                         pad="wrap")[:TOWERS_TRAJ_STEPS]
    data = train_ds.to_device(DEVICE)
    losses = {}
    for path in ("kernel", "plain"):
        model = CLIPModel(clip_cfg, generator=torch.Generator().manual_seed(0)).to(DEVICE)
        opt, _ = build_optimizer(model.named_parameters(), lr=tcfg.lr,
                                 weight_decay=tcfg.weight_decay)
        run = make_epoch_runner(model, tcfg.noise_level_mag,
                                noise_level_img=tcfg.noise_level_img)
        with PATHS[path][1]():
            _zero_counts()
            _, got = run(TrainState(model, opt), data, plan,
                         torch.Generator(device=DEVICE).manual_seed(2))
            counts = _check_f32_counts(path, len(plan))
        losses[path] = got.cpu().numpy()
        total = tuple(a + b for a, b in zip(total, counts))
    rel = np.abs(losses["kernel"] - losses["plain"]) / np.abs(losses["plain"])
    log(f"towers trimodal trajectory: {len(plan)} float32 steps (noise and rotation on, the "
        f"same draws), kernel {losses['kernel'].tolist()}, plain {losses['plain'].tolist()}, "
        f"worst relative difference {rel.max():.3e} (tol {TRAJ_RTOL})")
    if not np.all(np.isfinite(losses["kernel"])) or rel.max() > TRAJ_RTOL:
        raise AssertionError(f"towers trimodal: the kernel path's trajectory leaves the plain "
                             f"path's: {rel}")
    one = take(data, torch.from_numpy(plan[0]).to(DEVICE))
    counts = _towers_grads("towers trimodal", clip_cfg, one, per_step)
    total = tuple(a + b for a, b in zip(total, counts))

    # step time by the host clock and one profile of the trimodal step
    model = CLIPModel(clip_cfg, generator=torch.Generator().manual_seed(0)).to(DEVICE)
    opt, _ = build_optimizer(model.named_parameters(), lr=tcfg.lr)
    state = TrainState(model, opt)
    step = make_train_step(model, tcfg.noise_level_mag, noise_level_img=tcfg.noise_level_img)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    tbatch = take(data, torch.arange(batch, device=DEVICE))
    _zero_counts()
    times, loss = _host_step_ms(step, state, tbatch, gen, TOWERS_TIMED)
    counts = _counts()
    _check_counts("towers trimodal timed steps", counts,
                  tuple(c * (TOWERS_TIMED + 2) for c in per_step))
    total = tuple(a + b for a, b in zip(total, counts))
    log(f"towers trimodal: train step (B={batch}, float32) host clock median "
        f"{np.median(times):.3f} ms (quartiles {np.percentile(times, 25):.3f}-"
        f"{np.percentile(times, 75):.3f}) over {TOWERS_TIMED}; loss {float(loss):.5f}; card {card}")
    traced = _trace(lambda: step(state, tbatch, gen), PROFILED_STEPS)
    _log_trace("towers profile trimodal", "train steps", *traced, at=f"B={batch} float32")
    kinds = traced[-1]
    conv = sum(ms for k, ms in kinds.items() if k in ("convolution", "BatchNorm"))
    flash = sum(ms for k, ms in kinds.items() if k.startswith("flash"))
    log(f"towers profile trimodal: ConvMixer convolutions and BatchNorm {conv:.3f} ms, flash "
        f"kernels (3xTF32 tensor cores, float32) {flash:.3f} ms, the rest "
        f"{traced[0] - conv - flash:.3f} ms of {traced[0]:.3f} ms device time a step; card "
        f"{card}")
    return total, (batch, float(np.median(times)))


def _towers_quadrimodal(card):
    """quadrimodal in bf16 at B = 256 (profile_tpu's recipe): a few train
    steps on the tensor-core flash routes; the image and meta towers stay
    float32."""
    cfg = CLIPConfig.create(
        combinations=QUAD, enc_dim=32, nband=NBAND, logit_scale_init=19.55, loss="softmax",
        transformer_kwargs=SEQ_LC, transformer_spectral_kwargs=SEQ_SP, conv_kwargs=QUAD_CONV,
        meta_kwargs=QUAD_META, compute_dtype="bfloat16")
    model = CLIPModel(cfg, generator=torch.Generator().manual_seed(0)).to(DEVICE)
    ds = make_synthetic_dataset(n=BATCH, n_max_lc=LC_LEN, nband=NBAND, n_max_sp=TRAIN_SP_LEN,
                                image_size=IMAGE_SIZE, modalities=QUAD, seed=0)
    batch = ds.to_device(DEVICE)
    with torch.no_grad():
        img = model.image_encoder(batch["x_img"])
        meta = model.embed_meta(batch["label"], batch["redshift"], normalize=False)
        embs = model.encode(batch)
    dtypes = [str(t.dtype) for t in [img, meta] + embs]
    log(f"towers quadrimodal: bf16 compute, B={BATCH}; image tower out {img.dtype} "
        f"{tuple(img.shape)}, meta tower out {meta.dtype}, embeddings {dtypes[2:]}")
    if set(dtypes) != {"torch.float32"}:
        raise AssertionError(f"towers quadrimodal: towers not float32: {dtypes}")
    opt, _ = build_optimizer(model.named_parameters(), lr=5e-4)
    step = make_train_step(model, 1.0, noise_level_img=1.0)
    _zero_counts()
    times, loss = _host_step_ms(step, TrainState(model, opt), batch,
                                torch.Generator(device=DEVICE).manual_seed(3), TOWERS_TIMED)
    counts = _counts()
    log(f"towers quadrimodal: train step (B={BATCH}, bf16, {IMAGE_SIZE}x{IMAGE_SIZE} images, "
        f"T_lc={NBAND * LC_LEN}, "
        f"T_sp={TRAIN_SP_LEN}) host clock median {np.median(times):.3f} ms (quartiles "
        f"{np.percentile(times, 25):.3f}-{np.percentile(times, 75):.3f}) over "
        f"{TOWERS_TIMED}; loss {float(loss):.5f}; launches {counts}; card {card}")
    _check_counts("towers quadrimodal", counts,
                  tuple(c * (TOWERS_TIMED + 2) for c in _step_counts("kernel")))
    if not torch.isfinite(loss):
        raise AssertionError(f"towers quadrimodal: loss {loss}")
    return counts, float(np.median(times))


def _towers_heads(card):
    """config_grid.yaml's light-curve redshift regression and the same towers
    with a 5-class head: a few steps each through Trainer.fit, the task
    metric finite, predict_supervised equal to the eval head's output, the
    parameter gradients at B = 256 held to the plain path's."""
    sweep = load_sweep(GRID)
    point, extra = next(expand_grid(sweep)), sweep.extra_args
    reg_cfg = build_clip_config(point, extra, nband=NBAND)
    tcfg = dataclasses.replace(build_trainer_config(point, extra), epochs=HEADS_EPOCHS)
    tk = reg_cfg.tk()
    stated = ((tk["emb"], tk["heads"], tk["depth"], tk["agg"]), reg_cfg.combinations,
              reg_cfg.regression, tcfg.batch_size, reg_cfg.compute_dtype)
    log(f"towers heads: {GRID}, first of {sweep.n_points} grid points; override: epochs "
        f"-> {HEADS_EPOCHS}; LC {tk}; trainer {tcfg}")
    if stated != HEADS_STATED:
        raise AssertionError(f"towers: {GRID} does not give the stated head: {stated}")
    ds = make_synthetic_dataset(n=TOWERS_N, n_max_lc=LC_LEN, nband=NBAND,
                                modalities=reg_cfg.combinations, seed=0)
    train_ds, val_ds = _split(ds, extra["val_fraction"])
    batch = tcfg.batch_size
    train_steps, eval_steps = -(-len(train_ds) // batch), -(-len(val_ds) // batch)
    depth = tk["depth"]
    total, step_ms = NONE, {"batch": batch}
    tbatch = take(train_ds.to_device(DEVICE), torch.arange(batch, device=DEVICE))
    cls_cfg = dataclasses.replace(reg_cfg, regression=False, classification=True, n_classes=5)
    for task, cfg, metric in (("regression", reg_cfg, "R2_val"),
                              ("classification", cls_cfg, "f1_val")):
        model = CLIPModel(cfg, generator=torch.Generator().manual_seed(0)).to(DEVICE)
        trainer = Trainer(model, task, tcfg)
        with _plain_calls() as plain:
            _zero_counts()
            t0 = time.perf_counter()
            result = trainer.fit(train_ds, val_ds)
            wall = time.perf_counter() - t0
            counts = _counts()
        row = result["metric_rows"][-1]
        log(f"towers {task}: Trainer.fit {HEADS_EPOCHS} epoch ({train_steps} train + "
            f"{eval_steps} eval steps at B={batch}, float32) in {wall:.3f} s: train_loss "
            f"{row['train_loss']:.6f}, val_loss {row['val_loss']:.6f}, {metric} "
            f"{row[metric]:.6f}, step {row['step_time_s'] * 1e3:.2f} ms (the epoch's mean); "
            f"monitor {trainer.monitor}/{trainer.mode}; launches {counts}; card {card}")
        _check_counts(f"towers {task} fit", counts,
                      _tf32_flash(depth * HEADS_EPOCHS * (train_steps + eval_steps),
                                  depth * HEADS_EPOCHS * train_steps))
        if plain or not np.isfinite(row[metric]):
            raise AssertionError(f"towers {task}: {metric} {row[metric]}, {len(plain)} plain")
        model = result["state"].model
        with _plain_calls() as plain:
            _zero_counts()
            pred = predict_supervised(model, val_ds, batch_size=batch, device=DEVICE)
            pred_counts = _counts()
        val_data = val_ds.to_device(DEVICE)
        with torch.no_grad():
            want = torch.cat([model.eval()(take(val_data, idx)) for idx in
                              torch.arange(len(val_ds), device=DEVICE).split(batch)])
        err = float(np.abs(pred - want.float().cpu().numpy()).max())
        log(f"towers {task}: predict_supervised {pred.shape} against the eval head, max "
            f"difference {err:.3e}; launches {pred_counts}")
        _check_counts(f"towers {task} predict", pred_counts, _tf32_flash(depth * eval_steps, 0))
        if err > RUN_DIR_EMBED_TOL or pred.shape != (len(val_ds), cfg.head_out):
            raise AssertionError(f"towers {task}: predict_supervised {pred.shape} off by {err}")
        opt, _ = build_optimizer(model.named_parameters(), lr=tcfg.lr)
        step = make_train_step(model, tcfg.noise_level_mag)
        _zero_counts()
        times, loss = _host_step_ms(step, TrainState(model, opt), tbatch,
                                    torch.Generator(device=DEVICE).manual_seed(3),
                                    TOWERS_TIMED)
        timed_counts = _counts()
        log(f"towers {task}: train step (B={batch}, float32) host clock median "
            f"{np.median(times):.3f} ms (quartiles {np.percentile(times, 25):.3f}-"
            f"{np.percentile(times, 75):.3f}) over {TOWERS_TIMED}; loss {float(loss):.5f}; "
            f"card {card}")
        _check_counts(f"towers {task} timed steps", timed_counts,
                      _tf32_flash(depth * (TOWERS_TIMED + 2), depth * (TOWERS_TIMED + 2)))
        del result, trainer, model, opt, step
        grad_counts = _towers_grads(f"towers {task}", cfg, tbatch, _tf32_flash(depth, depth))
        total = tuple(sum(c) for c in
                      zip(total, counts, pred_counts, timed_counts, grad_counts))
        step_ms[task] = float(np.median(times))
    return total, step_ms


def phase_towers(card):
    """The image and meta towers and the supervised heads on the card:
    trimodal, quadrimodal bf16 and the heads. Returns the launches of every
    counted call."""
    t_phase = time.perf_counter()
    tri, tri_ms = _towers_trimodal(card)
    torch.cuda.empty_cache()
    quad, quad_ms = _towers_quadrimodal(card)
    torch.cuda.empty_cache()
    heads, heads_ms = _towers_heads(card)
    total = tuple(a + b + c for a, b, c in zip(tri, quad, heads))
    log(f"towers: step time by the host clock: trimodal (B={tri_ms[0]}, float32) "
        f"{tri_ms[1]:.3f} ms, quadrimodal (B={BATCH}, bf16) {quad_ms:.3f} ms, regression and "
        f"classification (B={heads_ms['batch']}, float32) {heads_ms['regression']:.3f} and "
        f"{heads_ms['classification']:.3f} ms; card {card}")
    log(f"towers: phase done in {time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


def _kind(name):
    """Kind of a device op, by its kernel name."""
    n = name.lower()
    for word, kind in (("fused_qkv_fwd", "fused QKV forward"),
                       ("fused_qkv_bwd", "fused QKV backward"),
                       ("fused_ffn_fwd", "fused FFN forward"),
                       ("fused_ffn_bwd", "fused FFN backward"),
                       ("reduce_partials", "backward partials reduce"),
                       ("flash_attention_fwd", "flash forward"),
                       ("flash_attention_bwd_dq", "flash backward dq"),
                       ("flash_attention_bwd_dkdv", "flash backward dk/dv"),
                       ("fprop", "convolution"), ("dgrad", "convolution"),
                       ("wgrad", "convolution"), ("conv", "convolution"),
                       ("batch_norm", "BatchNorm"), ("bn_fw", "BatchNorm"),
                       ("bn_bw", "BatchNorm"),
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


def _log_trace(tag, unit, device_ms, wall_ms, host_ms, idle, ops, kinds,
               at=f"B={BATCH} bf16"):
    log(f"{tag}: {PROFILED_STEPS} {unit} at {at} under torch.profiler: device "
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


def _flash_bounds(b, h, t, s, peak="bfloat16"):
    """Bounds of the flash forward and backward at (B, H, T, S): bf16 on the
    tensor cores, or float32 (``peak`` "tf32x3": three TF32 passes of each
    product; "float32": the CUDA cores). Operations: the products' least
    multiply-adds a (query, key) pair, 2S forward (S, P . V) and 5S backward
    (S, dP, dq, dk, dv); the kernels' dq and dk/dv kernels each recompute S
    and dP, 7S."""
    size = 2 if peak == "bfloat16" else 4
    fwd = _bound(4 * b * h * t * t * s, 4 * b * h * t * s * size + b * t, peak)
    bwd = _bound(10 * b * h * t * t * s,
                 8 * b * h * t * s * size + b * h * t * 2 * 4 + b * t, peak)
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
    fwd_tf32 = _flash_bounds(b, 2, SP_LEN, 16, "tf32x3")[0]        # the same, float32
    bwd_tf32 = _flash_bounds(b, 2, TRAIN_SP_LEN, 16, "tf32x3")[1]
    qkv_fwd, qkv_bwd = _qkv_bounds(*QKV_LC)         # fused QKV, LC, bf16
    n, e, f = FFN_ROWS, FFN_E, FFN_F           # fused block, LC rows, float32
    p = e * e + 2 * e * f + 6 * e + f          # parameter floats
    ffn_fwd = _bound(2 * n * (e * e + 2 * e * f), 4 * (3 * n * e + p), "float32")
    ffn_fwd_mma = _bound(2 * n * (e * e + 2 * e * f), 4 * (3 * n * e + p), "tf32x3")
    ffn_bwd = _bound(2 * n * (3 * e * e + 6 * e * f), 4 * (5 * n * e + 2 * p), "float32")
    ffn_bwd_mma = _bound(2 * n * (3 * e * e + 6 * e * f), 4 * (5 * n * e + 2 * p), "tf32x3")
    return {"flash_attention_fwd": fwd, "flash_attention_bwd": bwd,
            "flash_attention_fwd_mma": fwd, "flash_attention_bwd_mma": bwd,
            "flash_attention_fwd_tf32": fwd_tf32, "flash_attention_bwd_tf32": bwd_tf32,
            "fused_ffn_fwd": ffn_fwd, "fused_ffn_fwd_mma": ffn_fwd_mma,
            "fused_ffn_bwd": ffn_bwd, "fused_ffn_bwd_mma": ffn_bwd_mma,
            "fused_qkv_fwd": qkv_fwd, "fused_qkv_bwd": qkv_bwd,
            "fused_qkv_fwd_mma": qkv_fwd, "fused_qkv_bwd_mma": qkv_bwd}


def main():
    card, exp_per_s = phase_device()
    phase_build()
    fwd_err, timing, fwd_norm = phase_kernel()
    bwd_err, bwd_timing, bwd_norm, bwd_control = phase_kernel_bwd()
    ffn_err, ffn_norm_err, ffn_bwd_err, ffn_bwd_norm, ffn_timing = phase_kernel_ffn()
    qkv_err, qkv_bwd_err, qkv_timing = phase_kernel_qkv()
    serve = phase_serve()
    serve_fused = phase_serve(fused=True)
    serve_qkv = phase_serve(qkv=True)
    train = phase_train()
    phase_grad_probe()
    train_fused = phase_train("fused")
    train_qkv = phase_train("qkv")
    run_dir = phase_run_dir()
    towers = phase_towers(card)
    phase_profile()
    runs = (serve, serve_fused, serve_qkv, train, train_fused, train_qkv, run_dir, towers)
    log(f"kernels line: each entry's \"shape\" is what its times and bound are at; "
        f"launches {COUNT_NAMES} of serve, serve-fused, serve-qkv, train, train-fused, "
        f"train-qkv, run-dir, towers, summed in the line: {runs}; card {card}")
    lc, sp_fwd, sp_bwd, tri = ((BATCH, 8, NBAND * LC_LEN, 8), (BATCH, 2, SP_LEN, 16),
                               (BATCH, 2, TRAIN_SP_LEN, 16), (32, 2, SP_LEN, 16))
    for name, shape in (("LC", lc), ("SP serving", sp_fwd), ("SP training", sp_bwd),
                        ("SP trimodal", tri)):
        e_fwd, e_bwd = _exp_floor_ms(*shape[:3], exp_per_s)
        for peak in ("bfloat16", "tf32x3", "float32"):
            (f_ms, f_by), (b_ms, b_by) = _flash_bounds(*shape, peak)
            ops_7s = _bound(14 * np.prod(shape, dtype=np.int64) * shape[2], 0, peak)[0]
            log(f"bounds {peak} at {name} {shape}: flash forward {f_ms:.4f} ms ({f_by}), "
                f"flash backward {b_ms:.4f} ms ({b_by}; the kernels' 7S products alone "
                f"{ops_7s:.4f} ms); exponentials alone: forward {e_fwd:.4f} ms, backward "
                f"{e_bwd:.4f} ms")
    for name, shape in (("LC", QKV_LC), ("SP", QKV_SP)):
        (f_ms, f_by), (b_ms, b_by) = _qkv_bounds(*shape)
        log(f"bounds bf16 at {name} (B, T, E, H) = {shape}: fused QKV forward "
            f"{f_ms:.4f} ms ({f_by}), backward {b_ms:.4f} ms ({b_by})")
    lc32 = ffn_timing["float32"]
    qkv_lc, qkv_sp = qkv_timing["lc"], qkv_timing["sp"]

    def flash(route, bwd, dtype="bfloat16"):
        """The flash entry of ``route`` in ``dtype``: SP timed (serving T
        forward, training T backward), LC under also_at; in float32 the
        trimodal SP under also_at_trimodal and the other SP T under
        also_at_training (forward) or also_at_serving (backward)."""
        tm = bwd_timing if bwd else timing
        peak = "bfloat16" if dtype == "bfloat16" else "tf32x3" if route == "tf32" else "float32"
        shapes = {"sp": sp_bwd if bwd else sp_fwd, "lc": lc, "sp_tri": tri,
                  "sp_train": sp_bwd, "sp_t1024": sp_fwd}

        def entry(case):
            t, shape = tm[(case, dtype)], shapes[case]
            bound = _flash_bounds(*shape, peak)[bwd]
            return {"ms": t[route], "device_ms": t[f"{route}_device"],
                    "host_ms": t[f"{route}_host"], "plain_ms": t["plain"],
                    "bound_ms": bound[0], "bound_by": bound[1], "library_ms": t["library"],
                    "library_device_ms": t["library_device"],
                    "shape": f"(B, H, T, S) = {shape} {dtype}"}

        top = {**entry("sp"), "also_at": entry("lc")}
        if dtype == "float32":
            top["also_at_trimodal"] = entry("sp_tri")
            other = "also_at_serving" if bwd else "also_at_training"
            top[other] = entry("sp_t1024" if bwd else "sp_train")
        return top

    measured = {  # name: (launches, max_abs_err, the rest of the entry)
        "flash_attention_fwd": (0, fwd_err["simt"], {
            **flash("simt", 0), "float32": flash("simt", 0, "float32"),
            "norm_err_float32": fwd_norm[("simt", "float32")]}),
        "flash_attention_bwd": (1, bwd_err["simt"], {
            **flash("simt", 1), "float32": flash("simt", 1, "float32"),
            "norm_err_float32": bwd_norm[("simt", "float32")]}),
        "flash_attention_fwd_mma": (2, fwd_err["mma"], {
            **flash("mma", 0), "norm_err": fwd_norm[("mma", "bfloat16")]}),
        "flash_attention_bwd_mma": (3, bwd_err["mma"], {
            **flash("mma", 1), "norm_err": bwd_norm[("mma", "bfloat16")]}),
        "flash_attention_fwd_tf32": (12, fwd_err["tf32"], {
            **flash("tf32", 0, "float32"), "norm_err": fwd_norm[("tf32", "float32")]}),
        "flash_attention_bwd_tf32": (13, bwd_err["tf32"], {
            **flash("tf32", 1, "float32"), "norm_err": bwd_norm[("tf32", "float32")],
            "wrong_dq_norm_err": {n: e for (n, d), e in bwd_control.items()
                                  if d == "float32"}}),
    }
    for i, route in ((5, "simt"), (11, "mma")):  # the fused backward's two routes
        measured["fused_ffn_bwd" + ("_mma" if route == "mma" else "")] = (
            i, ffn_bwd_err[route], {
                "ms": lc32["bwd_" + route], "device_ms": lc32[f"bwd_{route}_device"],
                "plain_ms": lc32["bwd_plain"], "library_ms": None,
                "norm_err": ffn_bwd_norm[route],
                "shape": f"(N, E, F) = {(FFN_ROWS, FFN_E, FFN_F)} float32"})
    measured["fused_ffn_bwd_mma"][2]["stage_device_ms"] = lc32["bwd_mma_stages"]
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
