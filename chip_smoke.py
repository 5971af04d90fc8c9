#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU: the maven-lite embedding
server and the maven-lite contrastive trainer end to end (and maven-lite
from its own config, trained into run directories, resumed and served, and
trained from a ZTF BTS data directory through the training CLIs; the
image and meta towers and the supervised heads: trimodal from its own
config, quadrimodal, redshift regression and classification, and the ViT
image tower in trimodal, its run dir rebuilt without a sidecar; and masked
pretraining, its graft into a CLIP light-curve tower, and Maven's
pretraining and fine-tuning, each from its shipped config; and Maven's
pretraining from a simulated HDF5 corpus through cli.pretrain_sim, in
memory and streamed shard by shard (--streaming), in one process and over
two ranks; and the serving artifact (cli.export_model, serve --artifact)
reloaded without the model code; and the
five folds of maven-lite, and an lr x seed grid, as one stacked program
through --parallel-folds / --parallel-members; and data-parallel training
over two ranks, and the umbrella CLI under torchrun; and tensor-parallel
training over (data, model) meshes of ranks, and the stacked members over
the ranks' data axis), through the
hand-written flash-attention kernels (forward and backward; at head dims 8,
16, 32 and 64 bf16 on the tensor cores and float32 on the tensor cores in
3xTF32, every other head dim from 1 to 64 and rows off 16 bytes on the CUDA
cores), and the same server and
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
     every build ends before phase 3, so no compiler runs beside a timed
     kernel;
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
     (32, 2, 1024, 16), Maven pretraining's float32 light curve (1024, 8,
     200, 8) and spectrum (1024, 2, 220, 16), and the other head
     dims: 32 (contiguous, and with rows off 16 bytes), the ViT's (B, 4,
     36, 32) at B = 32 and 256, and 4, 24 and 64 at (B, H, 36, S) with no
     mask and at a ragged T = 77 with a fully masked row. Every case at
     head dim 8, 16, 32 or 64 with 16-byte rows
     runs on both of its dtype's routes (the tensor cores as routed:
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
     float32 at the training, trimodal and Maven shapes too, head dims 4
     (the CUDA cores) and 64 (both routes) at (256, 2, 36, S), no mask, in
     both dtypes, each route and the library call also by device time
     (profiler sums);
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
     at LC and SP, bf16 and float32 (and float32 at SP T = 1024, the
     trimodal (32, 2, 1024, 16) and Maven's two B = 1024 shapes) (CUDA
     events, median of 25), and, beside
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
     every output, and each third of dWqkv (query, key, value) on its own,
     within NORM_TOL in the normalised error), at LC (B, T, E,
     H) = (256, 200, 64, 8), SP (256, 220, 32, 2), a ragged T = 37, T = 256
     (the limit) at both widths, a batch with a fully masked sample, and
     mask=None; each call must show its route's launches. At LC and SP the
     tensor-core dWqkv with its query third x 0.99 must fail the query
     third's NORM_TOL check. Times (bf16, CUDA events, median of 25) the kernels of both
     routes (and the wrappers' host time a call, as in phase 3) and the
     plain versions at LC and SP, and the SelfAttention module forward and
     forward + backward on the unfused route (three F.linear, the flash
     kernels, F.linear) and under the opt-in; and in float32 the CUDA-core
     kernels, the plain versions and the library call at LC and SP. The
     library yardstick is F.multi_head_attention_forward
     (packed in-projection without bias, key_padding_mask, biased
     out-projection; the q rows of the packed weight times sqrt(head dim) so
     that its scores equal the kernel's), forward and autograd backward,
     on copies of the weights and x in the call's type and its (T, B, E)
     layout, made outside the timed region. It is timed and held to the plain versions
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
  5d. export: the serving artifact. Phase 5's run dir (bf16), the same
     under MMSN_FUSED_BLOCK=1 and under MMSN_FUSED_QKV=1, and a float32
     one (the 3xTF32 route), each exported by cli.export_model --batch-size
     256 --check in process (the check's two calls counted, the trace
     launching nothing): the graph must hold one registered op node
     (mmsn_torch::flash_attention_fwd, fused_ffn_block_fwd,
     fused_qkv_attention_fwd) for every forward launch of the live call;
     each artifact reloaded in a fresh process (python -c ARTIFACT_HOST,
     no MMSN_FUSED_* in its environment) that must import no module of
     the port's models or of JAX, launch exactly the live call's kernels
     a call, and give embeddings within ARTIFACT_TOL (1e-4) of
     load_live's (bitwise logged); meanwhile, in this process,
     load_artifact's embeddings against load_live's and the artifact
     served by EmbedServer to phase 5's requests, launches counted per
     device call, within SERVE_TOL of the plain path; once the fresh
     processes have ended, the artifact's call against load_live's (host
     clock in rounds of consecutive calls, device time and idle share by
     torch.profiler) and the flash forward through its op against the
     direct launcher at LC and SP (host time a call, CUDA events);
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
     rounds of 10 steps each, in the order main, the others, main) and
     their peak device memory;
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
     time (median of 6) and one torch.profiler breakdown (ConvMixer
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
  6e'. vit: the same trimodal grid point with extra_args.image_encoder vit
     at the JAX ViT defaults (emb 128, depth 6, 4 heads, patch 10, mlp 4;
     60 x 60 images: 36 tokens at head dim 32, the flash kernels on the
     tensor cores both ways), B = 32, float32, on a
     320-sample set: Trainer.fit (2 epochs) into a sweep's run-0 with 24 +
     24 3xTF32 flash launches a train step;
     the run dir loaded by its sidecar, then, model_config.json removed
     and the sweep's sweep_config.yaml beside it, rebuilt from its config
     files (initialize_from_run_dir's schema path) within 1e-6 of the
     sidecar path, and served by load_live
     (the image side from pos_emb) within 1e-6 of the encode; 6 float32
     steps (noise and rotation on) within relative 1e-5 of the plain
     path's; every float32 gradient within 5e-4 on the plain path's ReLU
     masks, with the dq x 0.99 control; the grid point at vit_heads 2
     (head dim 64): --check's preflight for the card (the 3xTF32 tensor
     cores), 3 float32 steps within relative 1e-5 of the plain path's and
     every gradient within 5e-4 with the dq x 0.99 control, 24 + 24
     3xTF32 launches a step; the tower alone in bf16 (each
     attention layer's output, dk and dv against the plain versions on its
     own inputs within 0.05 and NORM_TOL, dq within 0.05 and no farther
     from float64 than VIT_BF16_DQ_RATIO x the plain version, with the dq x
     0.99 control; the tower's output within 0.05 and NORM_TOL); the step's
     host time and profile; the forward and backward on the tensor cores
     (1b/2b in bf16, 1c/2c in float32) and on the CUDA cores (1a/2a)
     timed at (B, 4, 36, 32), B = 32 and 256, both dtypes, no mask
     (events, device sums, host time, the plain version, SDPA at scale
     S**-0.5) after a check against the plain versions;
  6f. maven: four stages from the shipped configs, each through
     training/experiment.py:_build_run, float32, every attention layer on
     the 3xTF32 flash route, no plain call, launches counted and asserted
     per fit (forwards a train and an eval step, backwards a train step);
     each stage's train-step host time (median of 6) and one
     torch.profiler breakdown. Cuts, and nothing else: the epochs (3000 to
     3 for (a), 1000 to 2 for (c) and (d), the head 1), synthetic sets for
     the corpora, val_fraction for the fold split, nruns 1.
     (a) masked pretraining, configs/config_grid.yaml's first point
     through masked_model_builder (emb 32, 2 heads, 9 blocks, n_out 1,
     f_mask 0.15, contiguous spans; B = 256, lr 5e-4, StepLR 2 epochs x
     0.1, magnitude noise 1.0) on 2048 light curves (val_fraction 0.05):
     run dir M (3 epochs) and R (2, then a new model and Trainer resumed to
     3): R bitwise equal to M (every state_dict tensor, every epoch's
     losses), the lr at each epoch's start equal to optax's staircase;
     load_model(M) a MaskedLightCurveEncoder whose
     masked_reconstruction_mse equals the in-memory model's (1e-6); 6
     float32 steps (noise, dropout and masks on, the same draws) within
     relative 1e-5 of the plain path's; every parameter gradient within
     5e-4 on the plain path's ReLU masks, and the dq x 0.99 control failing;
     (b) the graft: the same point with pretrain_lc_path = M's monitored
     best epoch= file and freeze_backbone_lc, 2 epochs of regression: the
     light-curve tower but its projection bitwise M's net.* after the graft
     and after training, its projection and the head moved, R2_val finite;
     (c) Maven pretraining, configs/maven_pretrain.yaml's first point (LC
     emb 64, 8 heads, 5 blocks; SP emb 32, 2 heads, 13 blocks; agg mean;
     enc_dim 128, the reference's default; B = 1024, T_sp = 220) on 4096
     pairs (val_fraction 0.05), 2 epochs into run dir P;
     (d) Maven fine-tuning, configs/maven_finetune.yaml's first point with
     pretrain_path = P through finetune_model_builder, on 640 pairs
     (val_fraction 0.2), B = 32: the initial weights bitwise P's monitored
     best, 2 contrastive epochs, 6 float32 steps within relative 1e-5 of
     the plain path's; then classification with freeze_backbone, a 5-class
     ClipMLPHead, 1 epoch: the frozen encoders bitwise unchanged,
     predict_supervised of load_model of its run dir equal to the
     in-memory head's (1e-6);
  6g. sim: Maven's first stage from a simulated corpus: 50,000 pairs (5
     types x 4 models x 2,500; a tenth of Maven's ~0.5M), 220 photometry
     points a pair in both filters at random and 300 wavelengths, float64,
     written by write_sim_hdf5 (numpy and struct; h5py's default layout:
     superblock 0, version-1 object headers, symbol-table groups,
     contiguous little-endian datasets; the card has no h5py) into the
     phase's directory; every dataset read by the port's HDF5 reader (timed);
     load_or_ingest of cli.pretrain_sim's ingest config on a miss (timed,
     pairs/s), bitwise pack_ragged_rows of the arrays the writer was
     handed, and on a hit, bitwise the miss. Then cli.pretrain_sim on
     configs/maven_pretrain.yaml in process (its full width, held to
     MAVEN_STATED; epochs 1000 -> 1) into run dir S: exactly 18 + 18
     3xTF32 flash launches a train step and 18 an eval step, no plain call,
     the cache hit, the run files, the manifests the random split's
     (val_fraction 0.05); its first 5 float32 steps on the kernel and plain
     paths within relative 1e-5; its step's host clock (median of 6) and
     one profile. cli.pretrain_masked --source sim on configs/config_grid.yaml
     (1 epoch, 1 run) from a legacy TransientTable file of 20,000 light
     curves (about 10% sentinels): 3xTF32 launches only, finite losses;
     cli.infer S --hdf5 on a 2,048-pair file: its embeddings equal to
     get_embeddings of load_model(S) on ingest_simulation of the file, 18
     forward launches a batch of 256. Run S is kept for phase 6h, the
     corpus for phase 6g';
  6g'. stream: Maven's first stage from phase 6g's corpus through
     cli.pretrain_sim --streaming --rows-per-shard 10240 (the validation
     rows held out at val_fraction, the training rows cut into 4 full
     shards and a partial one, 10 steps of B = 1024 each) for 1 epoch:
     launches counted, the run files with ckpt_cursor/, prefetch on; every
     shard's rows and the validation split bitwise an in-memory
     ValHoldout of iter_simulation_chunks; the first scheduled shard's
     first 5 float32 steps within relative 1e-5 of the plain path's; a
     run cut after its third shard's cursor and resumed from it, its
     last.ckpt within 1e-5 of the uninterrupted run's (bitwise tensors
     counted) and its losses within relative 1e-5; the cut run under
     torch.profiler (the pinned copies' share of time under kernels, the
     idle share); an epoch with prefetch off beside the CLI run's (each
     shard's upload device ms, staging and wait ms, each cursor save's ms).
     Leaves the corpus and the cache to phase 6g'';
  6g''. stream-dp: Maven pretraining (its full width, B = 1024 global)
     streamed by Trainer.fit_sharded over two gloo ranks sharing cuda:0 (B
     = 512 each; the DP_GROUPS "stream" group of phase dp's workers,
     chip_smoke.py --dp-rank stream R TMP, started before the one-process
     run and waiting for it) from a cut of phase 6g''s cache
     (11,264 training rows in shards of 4096, 4096 and 3072; 2,048
     validation rows): run A (2 epochs) on each rank against the same fit
     in this process, phase dp's tolerances (losses rtol = atol = 2e-5,
     every state_dict entry 5e-5) and launches; run B (1 epoch, then
     resumed from its last.ckpt at the epoch boundary under the mesh)
     against A within 1e-5 (bitwise tensors counted); ckpt_cursor/ in the
     one-process run dir and in neither mesh run dir; each rank's step
     against one process's by the host clock. Deletes the corpus and the
     caches;
  6h. ingest: a ZTF BTS tree of 4702 transients (the corpus's candidate
     count) written with numpy and zlib into chiprun_out/ in the corpus's
     layout and formats, by a spawned process started before phase 6f that
     also runs the reader and decoder checks below and fills the ingest
     caches of maven_finetune.yaml and smoke.yaml (start_tree; it touches
     no CUDA) (_write_tree: the transient table with the
     reference's type strings and about 1% empty redshifts, 10-300
     light-curve points a band, 400-4000 spectral rows for about 90%, half
     with error columns holding empty cells, 60 x 60 host PNGs for about
     99% with mixed row filters and some palette and RGBA files; synthetic
     choices), then: fastcsv against its plain version on every CSV
     (numeric columns bitwise, NaN in the same places, strings equal); every
     PNG decoded bitwise to the array written, and the native and numpy
     unfilters timed; load_or_ingest of maven-lite's ingest config timed on
     a cache miss and a hit, the hit bitwise the miss; the stratified folds'
     invariants (test indices partition the set, per-class counts of two
     folds within 1). Then cli.train.main on configs/maven-lite.yaml in
     process (its full width; epochs 1000 -> 2, nruns 5 -> 2: folds 0 and
     1): each run dir the contract's files, its config.yaml the grid point,
     its split manifests the names of stratified_kfolds(labels, 5)[fold],
     every attention launch on the 3xTF32 route (exactly 18 + 18 a train
     step, 18 an eval step), no plain call; fold 0's first 5 steps on the
     kernel and plain paths from the run's initial weights within relative
     1e-5; its step's host clock (median of 6) and device time and idle
     share (one profile of 5 steps); cli.train --resume: no launch, every
     file of the sweep untouched, the cache hit; cli.finetune_clip on a copy
     of configs/maven_finetune.yaml whose pretrain_path is phase 6g's run S
     (1 epoch, 1 run) and cli.pretrain_masked --source real on
     configs/config_grid.yaml (1 epoch, 1 run): 3xTF32 launches only,
     finite losses; then configs/smoke.yaml (emb 8, 2 heads: head dim 4)
     through cli.train: --check for the card (the CUDA-core flash route),
     then 1 epoch of its 3 on the whole tree, every flash launch on the
     CUDA cores and counted, finite losses;
  6i. evaluate: on phase 6h's tree and run dirs, cli.evaluate on the two
     maven-lite fold runs (--max-spec-len 1024 --rescale 1, their config's;
     the JAX package cannot load their attention aggregation): exactly 18
     3xTF32 flash forwards an embedding batch and no backward, 48 regression
     and 96 classification rows in the pickles, finite, the LaTeX logged;
     the kernel path's embeddings of each split against the plain path's
     (float32 tolerance 1e-4), and every probe of run-0 (linear, LinearSVC,
     KNN; each modality and the pair; redshift, 5-way, 3-way; run-1's are
     left out for the time limit) on both: regression
     within 1e-4 of the largest prediction, the classifiers equal, except on
     rows near a tie on the kernel path (LinearSVC top-two margin under
     1e-4, k-th and (k+1)-th distances within 1e-5), whose number is
     logged; the host clock an embedding batch and the seconds by probe
     family. A 1-epoch cli.supervise -- cli.train configs/config_grid.yaml
     child process (its launches uncounted), then cli.evaluate of that run
     (the supervised branch); cli.export_embeddings (maven-lite run-0's val
     split) and cli.infer (the fine-tuned run's embeddings, the supervised
     run's predictions, the masked run's scores at seed 7) equal to
     get_embeddings, predict_supervised and masked_reconstruction_mse called
     directly; --check of cli.train (maven-lite), cli.finetune_clip (the
     phase's copy of maven_finetune), cli.pretrain_masked (config_grid) and
     cli.supervise -- cli.train (config_grid): exit 0 and run-0's n_params
     the parameters (those that take gradients) of the model trained on the
     card; a copy of maven-lite with heads 3 exits 1, naming run-0 and the
     key;
  6j. ensemble: on phase 6h's tree, (a) flash_attention under torch.func.vmap
     with N = 5 members on each route (3xTF32 and the CUDA cores in
     float32, bf16 on the tensor cores) at maven-lite's (5, 32, 8, 200, 8)
     and (5, 32, 2, 1024, 16), and once with one key mask for every member:
     out, dq, dk and dv (and the no_grad out) bitwise those of 5 separate
     calls, one launch each way per vmapped call (the vmap rule folds the
     member axis into B); the fused-block and fused-QKV kernels under vmap
     on each of their eight routes (3a-6b) at maven-lite's widths, N = 5,
     B = 32 (the light curve, and the spectra at T = 220 for the fused
     QKV), every member its own parameters: out and every gradient (and the
     no_grad out) bitwise those of 5 separate calls, one launch each way on
     the route's counter, the plain version member by member at the
     route's tolerance (bf16 dWq, dWk, dWv each at NORM_TOL), and member 0's
     parameters for every member failing the bitwise check.
     (b) cli.train configs/maven-lite.yaml
     --parallel-folds (its full width, its five folds as members; epochs
     1000 -> 2): exactly 18 + 18 3xTF32 launches a stacked step and 18 an
     eval step, no plain call; each member's run dir the contract's files,
     its grid point, its fold's manifests, a row an epoch with
     member_samples_per_s; load_model of each run's last.ckpt against the
     stacked member slice of the last stacked checkpoint through vmap
     (embeddings within 1e-4); the first 5 stacked steps against each
     member's sequential kernel-path steps (its plan, its generator): losses
     within relative 1e-5, the first step's dropout masks bitwise. (c) The
     same CLI stopped after epoch 0's stacked checkpoint, then --resume:
     metric rows, last.ckpt state_dicts and RAdam moments bitwise those of
     (b). (d) --parallel-members on a grid written from maven-lite (lr
     {3.7e-5, 1e-4} x seed {0, 1} x folds {0, 1}, nruns 8; 1 epoch, each
     member's loss a step kept for phase 6l): run dirs and launches as in
     (b), and the first 5 steps against sequential runs of each member's lr
     and seed (StackedRAdam); (f) MMSN_FUSED_BLOCK=1 MMSN_FUSED_QKV=1
     cli.train --parallel-folds on maven-lite at dropout 0 (1 epoch): 5 + 5
     fused-block launches on the tensor cores and 18 + 18 3xTF32 flash
     launches a stacked step, run dirs as in (b); the first 5 stacked steps
     against sequential runs with the same opt-ins, and with
     MMSN_FUSED_QKV=1 alone (5 + 5 fused-QKV launches a step); 5 bf16
     stacked steps of each (launches, finite losses); phases 6k's and 6l's
     torchrun runs go beside (a)-(d) and (f). (e) Once they have ended, each fused route's
     stacked launch at N = 5 against 5 separate launches (device time of
     10 calls, forward and backward), and the stacked step
     at N = 5 x B = 32 (maven-lite) against N sequential steps on the
     same batches: host clock medians of 6 (each step ended by a
     synchronise) and one profile of 5 steps each (device time, idle share,
     time by kind), samples/s over the members;
  6k. dp: data-parallel training (parallel/, Trainer(mesh=...)) on 2 gloo
     ranks that share cuda:0 (NCCL refuses two ranks on one device),
     spawned as subprocesses of this script (--dp-rank GROUP R TMP, the
     group "2x1") with a timeout, from one set of initial weights: (a)
     configs/maven-lite.yaml's first point, float32, B = 32 (16 a rank),
     Trainer.fit for 2 epochs on phase 6h's tree (fold 0); (b)
     configs/trimodal.yaml's first point on phase 6e's synthetic set (the
     global BatchNorm statistics and running buffers), 2 epochs; (c)
     configs/maven_pretrain.yaml at B = 1024 (512 a rank), 3 steps. Each
     rank's per-epoch losses (rtol = atol = 2e-5; Maven's per step,
     relative 1e-5) and every state_dict entry (5e-5) against the
     one-process run on the card, 18 + 18 3xTF32 flash launches a step on
     each rank by the counters, no plain call; then each rank's step (host
     clock median of 6, device time and idle share from one profile of 5)
     beside the one-process step (the ranks fit while this process fits the
     references; the steps are timed apart). (d) python -m
     torch.distributed.run --nproc-per-node 1 -m
     multimodal_supernovae_tpu_torch train configs/maven-lite.yaml --mesh
     --epochs 1 --max-runs 1 --profile-dir D (a one-rank NCCL group) on a
     320-transient tree written as phase 6h's (the trace of a full fold
     would hold about 7 MB a step): the run dir, the 3xTF32 flash forward,
     dq and dk/dv kernels in D's trace (18 each a train step, the forward
     also in eval steps), and the step's MFU by utils/flops.py (its peak
     and compute type printed). This torchrun run and phase 6l's (f) start
     after phase 6i and run beside phase 6j up to its (e), which waits for
     them; phase 6l's groups start with phase 6k's and run beside them;
  6l. tp: tensor parallelism (parallel/sharding.py: each FFN and the
     ConvMixer head split Megatron-style over the model axis) and the
     ensemble member axis over the data axis, on three more groups of gloo
     ranks that share cuda:0 (the same workers: --dp-rank GROUP R TMP),
     from phase 6k's initial weights, against the one-process runs (made
     in phase 6k while the ranks run):
     (a) maven-lite at a 2 x 2 mesh, float32, B = 32, Trainer.fit for 1
     epoch on fold 0 (LC FF hidden 256 -> 128 a model rank, SP 128 -> 64);
     (b) trimodal at 1 x 2 (the split head and its column-split dropout
     mask), (c) Maven pretraining at 1 x 2, B = 1024 (phase 6k's
     one-process steps), (d) maven-lite at dropout 0 under
     MMSN_FUSED_BLOCK=1 at 1 x 2 (the fused kernels on FFN weights
     gathered over the model axis), 3 steps each, and (d) also every
     gradient of one loss, the fused blocks' FFN slices held to the
     one-process gradient's slices within 5e-4 of the largest. Losses and
     every gathered state_dict entry (names and shapes the one process's)
     within rtol = atol = 5e-5 (Maven's losses relative 1e-5 a step), 18 +
     18 3xTF32 flash launches a step on each rank (and 5 + 5 fused under
     the opt-in), no plain call; each rank's step (host clock, device time,
     idle share) beside the one process's. (e) Phase 6j (d)'s 8-member grid
     through run_sweep(parallel_members=True) over a 2 x 1 mesh, 4 members
     a rank, 1 epoch: each member's loss a step within relative 1e-5 of a
     one-process stack of the same 4 members (fit_members; a stack rounds
     its few-output reductions by its member count, so the distance to
     (d)'s stack of 8 is logged, not held), its run dir's files (d)'s, the
     stacked step's launches. (f) python -m torch.distributed.run
     --nproc-per-node 1 -m multimodal_supernovae_tpu_torch train
     configs/maven-lite.yaml --mesh --parallel-folds --epochs 1 (a
     one-rank NCCL group) on phase 6h's tree: the five fold run dirs and
     _ensemble-g0/. The tree is deleted after the phase;
  7. profile: torch.profiler (device activity) over 5 train steps of each
     path (kernel, plain, fused, qkv; bf16, one batch, after 3 warm-up
     steps):
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
runs, and every counted call of the run-dir, towers, vit, maven, sim,
stream, ingest, evaluate, ensemble, dp and tp phases (the ensemble's vmap checks aside;
phase dp's and tp's ranks count in their own processes and report); the CUDA-core fused-QKV entries carry their float32 times, library
times and bounds at LC and SP under "float32"; the flash and fused-QKV
entries carry the times and bound at their second shape under "also_at"; the
fused-QKV entries add their and the library call's device time, "device_ms"
and "library_device_ms", and the wrapper's host time a call, "host_ms")
and each kernel's bound (the larger of its bytes over
3.35 TB/s and its operations over the peak for its input type: 989 TFLOP/s
for bfloat16 on the tensor cores, 67 TFLOP/s for float32 on the CUDA cores,
TF32 being off, and for the 3xTF32 kernels three times their operations
at 495 TFLOP/s); the flash entries of the CUDA cores and of 3xTF32 carry
their float32 times under "float32" (the 3xTF32 ones at the top level),
with the trimodal spectral shape under "also_at_trimodal" and Maven
pretraining's under "also_at_maven_lc" and "also_at_maven_sp"; the
CUDA-core flash entries add the ViT tower's shape at B = 32 and 256 under
"also_at_vit_b32" and "also_at_vit_b256" in both dtypes (with
"exp_floor_ms"), and head dims 4 and 64 at (256, 2, 36, S) under
"also_at_h4" and "also_at_h64" (with "exp_floor_ms" too); the bf16 and
3xTF32 forward and backward entries add the ViT's shapes under
"also_at_vit_b32" and "also_at_vit_b256" and head dim 64 under
"also_at_h64" too; the flash
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

import atexit
import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import multiprocessing
import os
import pickle
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import multimodal_supernovae_tpu_torch.models.transformer as transformer_mod
import multimodal_supernovae_tpu_torch.models.vit as vit_mod
import multimodal_supernovae_tpu_torch.ops.flash_attention as flash_mod
import multimodal_supernovae_tpu_torch.ops.fused_block as ffn_mod
import multimodal_supernovae_tpu_torch.ops.qkv_attention as qkv_mod
import multimodal_supernovae_tpu_torch.training.checkpoint as ckpt_mod
import multimodal_supernovae_tpu_torch.training.experiment as experiment_mod
import multimodal_supernovae_tpu_torch.training.trainer as trainer_mod
from multimodal_supernovae_tpu_torch.cli import common as cli_common
from multimodal_supernovae_tpu_torch.cli import evaluate as cli_evaluate
from multimodal_supernovae_tpu_torch.cli import export_embeddings as cli_export
from multimodal_supernovae_tpu_torch.cli import export_model as cli_export_model
from multimodal_supernovae_tpu_torch.cli import finetune_clip as cli_finetune
from multimodal_supernovae_tpu_torch.cli import infer as cli_infer
from multimodal_supernovae_tpu_torch.cli import pretrain_masked as cli_masked
from multimodal_supernovae_tpu_torch.cli import pretrain_sim as cli_pretrain_sim
from multimodal_supernovae_tpu_torch.cli import supervise as cli_supervise
from multimodal_supernovae_tpu_torch.cli import train as cli_train
from multimodal_supernovae_tpu_torch.config import (
    build_clip_config,
    build_trainer_config,
    expand_grid,
    load_sweep,
    safe_load,
)
from multimodal_supernovae_tpu_torch.data import (
    epoch_indices,
    hdf5,
    ingest_simulation,
    make_synthetic_arrays,
    make_synthetic_dataset,
    take,
)
from multimodal_supernovae_tpu_torch.config.yaml_subset import dump as dump_yaml
from multimodal_supernovae_tpu_torch.data.cache import load_or_ingest
from multimodal_supernovae_tpu_torch.data.folds import (
    random_split,
    split_for_run,
    stratified_kfolds,
)
from multimodal_supernovae_tpu_torch.data.native import read_csv, read_csv_plain
from multimodal_supernovae_tpu_torch.data.simulation import iter_simulation_chunks
from multimodal_supernovae_tpu_torch.data.streaming import (
    ShardedDataset,
    ValHoldout,
    load_val_split,
    save_val_split,
    shard_epoch_schedule,
    write_sharded_cache,
)
from multimodal_supernovae_tpu_torch.data.png import decode, unfilter_numpy
from multimodal_supernovae_tpu_torch.data.transforms import (
    pack_ragged_rows,
    zero_time_origin_rows,
)
from multimodal_supernovae_tpu_torch.data.ztfbts import load_images, load_ztfbts
from multimodal_supernovae_tpu_torch.evaluation import (
    get_embeddings,
    masked_reconstruction_mse,
    predict_supervised,
    probes,
)
from multimodal_supernovae_tpu_torch.evaluation.export import kernel_ops, load_exported
from multimodal_supernovae_tpu_torch.kernels import build, library_path
from multimodal_supernovae_tpu_torch.models import (
    CLIPConfig,
    CLIPModel,
    ClipMLPHead,
    ViT,
    finetune_model_builder,
    init_weights,
    load_model,
    load_run_config,
    masked_model_builder,
    pick_reference_ckpt,
    write_model_config,
)
from multimodal_supernovae_tpu_torch.ops import dense_attention, dense_attention_bwd
from multimodal_supernovae_tpu_torch.ops.attention import per_member
from multimodal_supernovae_tpu_torch.serving import EmbedServer, load_artifact, load_live
from multimodal_supernovae_tpu_torch.training import (
    Trainer,
    TrainerConfig,
    TrainState,
    best_ckpt_path,
    build_optimizer,
    make_epoch_runner,
    make_train_step,
)
from multimodal_supernovae_tpu_torch.training import ensemble as ensemble_mod
from multimodal_supernovae_tpu_torch.training import preflight
from multimodal_supernovae_tpu_torch.training.experiment import _build_run, run_sweep
from multimodal_supernovae_tpu_torch.parallel import (
    batch_stats_over,
    gather_state_dict,
    shard_module,
    spec_for,
)
from multimodal_supernovae_tpu_torch.utils.draws import DrawSource, RankRows
from multimodal_supernovae_tpu_torch.utils.seed import set_seed

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
TRAIN_SP_LEN, TRAIN_N, TRAIN_EPOCHS, TRAJ_STEPS, TIMED_STEPS = 220, 2048, 3, 12, 10
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
TOWERS_TRAJ_STEPS, TOWERS_TIMED = 6, 6
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
# phase maven: masked pretraining from config_grid.yaml, the graft into its
# regression point, then Maven's pretraining and fine-tuning from their configs,
# each on a synthetic set; the epochs cut (3000 -> 3, 1000 -> 2, the head 1)
MAVEN_PRETRAIN, MAVEN_FINETUNE = "configs/maven_pretrain.yaml", "configs/maven_finetune.yaml"
MASKED_N, MASKED_EPOCHS, GRAFT_EPOCHS = 2048, 3, 2
MAVEN_N, MAVEN_EPOCHS, FINETUNE_N, HEAD_EPOCHS = 4096, 2, 640, 1
MAVEN_TRAJ_STEPS, MAVEN_TIMED = 6, 6
# masked_reconstruction_mse of load_model(M) against the in-memory model
MSE_TOL = 1e-6
# what the configs must give: the masked model (emb, heads, depth, n_out, f_mask,
# contiguous), what masked_model_builder returns beside it (task, freeze,
# surgery), (B, lr, step_size, gamma);
# Maven's LC and SP (emb, heads, depth, agg), enc_dim (the reference's default,
# the config names none), towers, compute dtype, B, T_sp, (task, freeze, surgery)
MASKED_STATED = ((32, 2, 9, 1, 0.15, True), ("masked", None, None), (256, 0.0005, 2, 0.1))
MAVEN_STATED = ((64, 8, 5, "mean"), (32, 2, 13, "mean"), 128, ("lightcurve", "spectral"),
                None, 1024, 220, ("contrastive", None, None))
FINETUNE_STATED = ("contrastive", None, 32)  # task, freeze, B


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
    buffers, ``model_layout`` True), contiguous (B, H, T, S) (False), or
    contiguous one element past a 16-byte boundary ("offset": rows off 16
    bytes, which only the CUDA-core kernels take)."""
    def one():
        shape = (b, t, h, s) if model_layout is True else (b, h, t, s)
        a = torch.randn(shape, generator=gen).to("cuda", dtype)
        if model_layout == "offset":
            return torch.zeros(a.numel() + 1, dtype=dtype, device="cuda")[1:].view(
                shape).copy_(a)
        return a.transpose(1, 2) if model_layout is True else a
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


QKV_THIRDS = ("query", "key", "value")  # the thirds of dWqkv, rows 0..E, E..2E, 2E..3E


def _dwqkv_thirds(got, want, what):
    """The normalised error of each third of a bf16 dWqkv (3E, E) on its
    own (a 1% error in one third reads about a third of that over the whole
    of dWqkv, close to NORM_TOL); raises where one is above NORM_TOL."""
    e = got.shape[-1]
    return [_check_norm(got[..., i * e:(i + 1) * e, :], want[..., i * e:(i + 1) * e, :],
                        f"{what} dWqkv {part} third")
            for i, part in enumerate(QKV_THIRDS)]


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


def _routes(dtype, s, tensors, backward=False):
    """The routes a case is checked on (the forward's, or the backward's):
    both where ``_route`` takes the tensor cores (bf16 or 3xTF32), the CUDA
    cores alone elsewhere."""
    route = flash_mod._route(dtype, s, tensors, backward)
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


def _device_spans(prof):
    """(start us, end us, name) of each device op of a finished
    torch.profiler run, in the order they started, read from its raw
    (kineto) events, times from the first op: the same ops ``prof.events()``
    lists, without building its event tree, which takes seconds on a trace
    of an epoch. User annotations (``Optimizer.step#...``) span idle gaps
    and are left out."""
    ops = sorted((e.start_ns(), e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())
    t0 = ops[0][0] if ops else 0  # times from the first op: integers before floats
    return [((s - t0) / 1e3, (s - t0 + d) / 1e3, name) for s, d, name in ops]


def _device_ops(fn, iters=25, tries=3):
    """(kernel name, ms) of each device op of ``iters`` calls of ``fn``
    under torch.profiler, in the order they started, after a warm-up. A
    trace that recorded no device op (seen once on the card, among many
    traces of a call that launches two kernels) is taken again, up to
    ``tries`` times; raises if none records one."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = _device_spans(prof)
        if spans:
            return [(name, (s1 - s0) / 1e3) for s0, s1, name in spans]
    raise AssertionError(f"torch.profiler recorded no device op in {tries} traces")


def _device_ms(fn, iters=25):
    """ms of device time a call of ``fn``: the sum of its device ops'
    durations under torch.profiler over ``iters`` calls, after a warm-up.
    Unlike CUDA events around a call, it leaves out the host's pace."""
    return sum(ms for _, ms in _device_ops(fn, iters)) / iters


def _flash_cases(mask_lc, mask_sp, t_sp):
    """(name, (B, H, T, S), mask, layout) of the flash checks (layout: the
    encoder's, True; contiguous, False; "offset", rows off 16 bytes): the
    two towers' shapes in the encoder's layout and contiguous, the light
    curve at config_grid's 2 heads of 16, a fully
    masked row with leading masked key tiles, no mask, ragged T = 1 and 77
    at both head dims, and the other head dims: 32 (the tensor cores beside
    the CUDA cores; rows off 16 bytes on the CUDA cores alone), the ViT
    tower's (B, 4, 36, 32) at B = 32 and 256, and head dims 4
    (configs/smoke.yaml) and 24 (the CUDA cores alone) and 64 (a ViT at
    vit_emb 128, 2 heads; both routes) at T = 36 with no mask and at a
    ragged T = 77 with a fully masked row."""
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
        ("s32_off", (8, 2, 77, 32), m77[:8].contiguous(), "offset"),
        ("vit_b32", (32, 4, 36, 32), None, True),
        ("vit_b256", (BATCH, 4, 36, 32), None, True),
        ("h4", (BATCH, 2, 36, 4), None, True),
        ("h4_t77", (16, 2, 77, 4), m77, False),
        ("h24", (BATCH, 4, 36, 24), None, True),
        ("h24_t77", (16, 2, 77, 24), m77, True),
        ("h64", (BATCH, 2, 36, 64), None, True),
        ("h64_t77", (16, 2, 77, 64), m77, False),
    ]


# the cases whose row 0 is fully masked: dq = dk = 0 there, dv not
FULLY_MASKED_ROW = ("masked_rows", "t77_s8", "t77_s16", "s32_off", "h4_t77", "h24_t77",
                    "h64_t77")


def _maven_cases(mask_lc, mask_sp):
    """The float32 shapes of Maven pretraining (phase maven, B = 1024): the
    light curve and the spectrum at T = 220, the masks tiled 4 times."""
    return [("maven_lc", (4 * BATCH, 8, 2 * LC_LEN, 8), mask_lc.repeat(4, 1), True),
            ("maven_sp", (4 * BATCH, 2, TRAIN_SP_LEN, 16),
             mask_sp[:, :TRAIN_SP_LEN].repeat(4, 1), True)]


MAVEN_CASES = ("maven_lc", "maven_sp")
# the cases whose float32 plain version with TF32 matmuls must fail FP32_NORM_TOL
TF32_CONTROLLED = ("lc", "sp", "vit_b256", "h64")
# the flash timings: (case, dtype) of the forward and backward phases (the
# serving and training shapes in both dtypes; the trimodal spectral shape, the
# backward's spectral serving T and Maven pretraining's shapes in float32, the
# dtype of those steps)
# head dims 4 (the CUDA cores) and 64 (both routes) at (B, H, 36, S), no mask,
# in both dtypes (the ViT's head dim 32 is timed in phase vit)
HEAD_DIM_TIMED = {(c, d) for c in ("h4", "h64") for d in ("float32", "bfloat16")}
FWD_TIMED = {("lc", "bfloat16"), ("sp", "bfloat16"), ("lc", "float32"), ("sp", "float32"),
             ("sp_train", "float32"), ("sp_tri", "float32"), ("maven_lc", "float32"),
             ("maven_sp", "float32")} | HEAD_DIM_TIMED
BWD_TIMED = {("lc", "bfloat16"), ("sp", "bfloat16"), ("lc", "float32"), ("sp", "float32"),
             ("sp_t1024", "float32"), ("sp_tri", "float32"), ("maven_lc", "float32"),
             ("maven_sp", "float32")} | HEAD_DIM_TIMED
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
        ("s64", (8, 1, 77, 64), mask_sp[:8, -77:].contiguous(), False)] + _maven_cases(
        mask_lc, mask_sp)
    gen = torch.Generator().manual_seed(0)
    max_err = {r: 0.0 for r in ROUTES}
    norm_err = {(r, d): 0.0 for r in ROUTES for d in ("float32", "bfloat16")}
    timing = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for name, (b, h, t, s), mask, layout in cases:
            if name in ("sp_train", "sp_tri", *MAVEN_CASES) and dtype_name == "bfloat16":
                continue  # float32 shapes
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
            if dtype == torch.float32 and name in TF32_CONTROLLED:
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


def _run_dir(tmp, fused=False, compute_dtype="bfloat16"):
    cfg = CLIPConfig.create(
        combinations=("lightcurve", "spectral"), enc_dim=32, nband=NBAND,
        logit_scale_init=19.55, loss="softmax", transformer_kwargs=_seq_lc(fused),
        transformer_spectral_kwargs=SEQ_SP, compute_dtype=compute_dtype)
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
        ("sp_tri", (32, 2, SP_LEN, 16), mask_sp[:32].contiguous(), True)] + _maven_cases(
        mask_lc, mask_sp)
    gen = torch.Generator().manual_seed(1)
    max_err = {r: 0.0 for r in ROUTES}
    norm_err = {(r, d): 0.0 for r in ROUTES for d in ("float32", "bfloat16")}
    control = {}
    timing = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        tol = GRAD_TOL[dtype_name]
        for name, (b, h, t, s), mask, layout in cases:
            if name in ("sp_tri", *MAVEN_CASES) and dtype_name == "bfloat16":
                continue  # float32 shapes
            q, k, v = _heads(gen, b, h, t, s, dtype, layout)
            # the cotangent in the head merge's (B, T, H, S) memory order
            g = torch.randn((b, t, h, s), generator=gen).to("cuda", dtype).transpose(1, 2)
            emb = h * s
            out, stats = fwd(q, k, v, mask, emb, with_stats=True)
            want = dense_attention_bwd(q, k, v, mask, g, emb)
            routes = _routes(dtype, s, (q, k, v, out, g), True)
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
                if (name in FULLY_MASKED_ROW
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
                if route != "simt" and name in ("lc", "sp", "vit_b32", "vit_b256", "h64"):
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
            if dtype == torch.float32 and name in TF32_CONTROLLED:
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
                    thirds = _dwqkv_thirds(grads[1], want_grads[1], f"qkv {name} {route}")
                    norm_err[route] = max(norm_err[route], *(n or 0.0 for n in norms + thirds))
                    norm = "; ||err||/||plain|| " + " ".join(
                        f"{o[0]} {_fmt(n)}" for o, n in zip(outs, norms)) + ", dWqkv by third " + (
                        " ".join(f"{t} {_fmt(n)}" for t, n in zip(QKV_THIRDS, thirds))
                        + f" (tol {NORM_TOL})")
                log(f"kernel-qkv {name} {dtype_name} (B, T, E, H) = {(b, t, e, h)} {route}: "
                    f"forward max|err| {err:.3e} (tol {TOL[dtype_name]}); backward "
                    f"max|err|/max|plain| dx {rel[0]:.3e} dWqkv {rel[1]:.3e} dWu {rel[2]:.3e} "
                    f"dbu {rel[3]:.3e} (tol {GRAD_TOL[dtype_name]}){norm}")
                if max(rel) > GRAD_TOL[dtype_name]:
                    raise AssertionError(f"qkv-bwd {name} {dtype_name} {route}: {rel}")
                if mma and name in ("lc", "sp"):
                    # negative control: the tensor-core dWqkv's query third off by 1%,
                    # which the query third's own check must see
                    wrong = grads[1].clone()
                    wrong[:e] *= 0.99
                    control[name] = _norm_err(wrong[:e], want_grads[1][:e])
                    log(f"kernel-qkv {name} {dtype_name} {WRONG_DWQ}: ||err||/||plain|| of "
                        f"the query third {control[name]:.3e} (must exceed {NORM_TOL}; over "
                        f"the whole of dWqkv {_norm_err(wrong, want_grads[1]):.3e})")
                    if control[name] <= NORM_TOL:
                        raise AssertionError(f"qkv {name}: the normalised check cannot see "
                                             f"a 1% error in dWqkv: {control[name]:.3e}")
            if name in ("lc", "sp"):
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
                module = (_time_self_attention((b, t, e, h), mask, dtype)
                          if dtype_name == "bfloat16" else {})
                timing[name if dtype_name == "bfloat16" else name + "_f32"] = times
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


SERVE_SIZES = ((1, False), (37, True), (256, False), (300, False))  # (n, as JSON)
SERVE_FIELDS = ("x_lc", "t_lc", "mask_lc", "x_sp", "t_sp", "mask_sp")


def _serve_feeds():
    """The synthetic arrays of the serve phases' requests and one feed a
    request of SERVE_SIZES."""
    syn = make_synthetic_arrays(n=sum(n for n, _ in SERVE_SIZES), n_max_lc=LC_LEN,
                                nband=NBAND, n_max_sp=SP_LEN, seed=1)
    feeds, lo = [], 0
    for n, _ in SERVE_SIZES:
        feeds.append({k: syn[k][lo:lo + n] for k in SERVE_FIELDS})
        lo += n
    return syn, feeds


def _serve_requests(tag, srv, feeds):
    """The requests of SERVE_SIZES sent to ``srv`` at once from threads,
    their launches counted from zero, then /healthz and /stats read. Returns
    the answers, the launches, the device calls and the plain calls."""
    srv.start_background()
    results = [None] * len(SERVE_SIZES)
    barrier = threading.Barrier(len(SERVE_SIZES))

    def client(i):
        barrier.wait()
        results[i] = _post(srv.port, feeds[i], SERVE_SIZES[i][1])

    with _plain_calls() as plain_calls:
        _zero_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(SERVE_SIZES))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = _counts()
    if any(th.is_alive() for th in threads) or None in results:
        raise RuntimeError("a client did not finish")
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz", timeout=60) as r:
        health = json.loads(r.read())
        if r.status != 200 or health["status"] != "ok":
            raise AssertionError(f"/healthz: {r.status} {health}")
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/stats", timeout=60) as r:
        stats = json.loads(r.read())
        if r.status != 200:
            raise AssertionError(f"/stats: {r.status}")
    calls = stats["device_calls"]
    n_all = sum(n for n, _ in SERVE_SIZES)
    log(f"{tag}: {len(SERVE_SIZES)} concurrent requests, {n_all} samples in {wall:.3f} s "
        f"wall, {calls} device calls, batch_fill {stats.get('batch_fill')}, launches "
        f"{COUNT_NAMES} {launches}, {len(plain_calls)} plain kernel calls")
    if calls < -(-n_all // BATCH):
        raise AssertionError(f"too few device calls: {calls}")
    return results, launches, calls, plain_calls


def _served_vs_plain(tag, run_dir, feeds, results):
    """Every answer of ``_serve_requests`` (status 200, finite unit-norm (n,
    32) embeddings) within SERVE_TOL of the run dir's model through the
    plain versions of every kernel, in the caller's environment."""
    ref_model, _ = load_model(run_dir, DEVICE)
    max_err = 0.0
    with _plain_kernels(), torch.inference_mode():
        for (n, as_json), feed, (status, out) in zip(SERVE_SIZES, feeds, results):
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
                if err > SERVE_TOL:
                    raise AssertionError(f"{tag} {name} n={n} ({'json' if as_json else 'npz'}): "
                                         f"max|served - plain| {err}")
    log(f"{tag}: every answer matches the model through the plain versions, "
        f"max|err| {max_err:.3e} (tol {SERVE_TOL})")


def phase_serve(fused=False, qkv=False):
    tag = "serve-fused" if fused else "serve-qkv" if qkv else "serve"
    syn, feeds = _serve_feeds()

    with tempfile.TemporaryDirectory() as tmp, (_qkv_env if qkv else contextlib.nullcontext)():
        _run_dir(tmp, fused)
        serving_model = load_live(tmp, BATCH, device=DEVICE, lc_len=LC_LEN,
                                  sp_len=SP_LEN)
        srv = EmbedServer(serving_model, host="127.0.0.1", port=0,
                          max_wait_ms=50.0)  # warms up: one device call
        try:
            results, launches, calls, plain_calls = _serve_requests(tag, srv, feeds)
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
            full = {k: syn[k][:BATCH] for k in SERVE_FIELDS}
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
        _served_vs_plain(tag, tmp, feeds, results)
    return launches


# phase export: the serving artifact (cli/export_model.py, evaluation/export.py,
# serving/server.py:load_artifact)
EXPORT_CASES = (  # (tag, the run dir's compute dtype, the environment of its export)
    ("bf16", "bfloat16", {}),
    ("fused-block", "bfloat16", {"MMSN_FUSED_BLOCK": "1"}),
    ("fused-qkv", "bfloat16", {"MMSN_FUSED_QKV": "1"}),
    ("float32", None, {}),
)
# the registered op that each forward place of _counts() launches through
EXPORT_OPS = {0: "flash_attention_fwd", 2: "flash_attention_fwd", 12: "flash_attention_fwd",
              4: "fused_ffn_block_fwd", 10: "fused_ffn_block_fwd",
              6: "fused_qkv_attention_fwd", 8: "fused_qkv_attention_fwd"}
ARTIFACT_CALLS = 3   # counted calls of each artifact in its fresh process
ARTIFACT_TOL = 1e-4  # an artifact's embeddings against load_live's (the JAX CLI's --check)
EXPORT_TIMED = 5     # host-clock calls a round: artifact, load_live, load_live, artifact
ARTIFACT_HOST_TIMEOUT_S = 300
# a serving host in a fresh process (python -c, argv: artifact, feed .npz, output
# stem, calls): load_artifact on the card, one warm-up call, then the counted
# calls of the feed; writes the last call's embeddings, the forward launch
# counters, the graph's kernel op nodes and the modules of the model code and of
# JAX it imported
ARTIFACT_HOST = r"""
import json, sys, time
import numpy as np
t0 = time.perf_counter()
from multimodal_supernovae_tpu_torch.serving import load_artifact
from multimodal_supernovae_tpu_torch.evaluation.export import kernel_ops, load_exported
from multimodal_supernovae_tpu_torch.ops import flash_attention as fa
from multimodal_supernovae_tpu_torch.ops import fused_block as fb
from multimodal_supernovae_tpu_torch.ops import qkv_attention as qa
art, feed_path, out, calls = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
model = load_artifact(art)
with np.load(feed_path) as z:
    feed = {k: z[k] for k in z.files}
model.fn(feed)
load_s = time.perf_counter() - t0
flash, ffn, qkv = fa.flash_attention, fb.fused_ffn_block, qa.fused_qkv_attention
for c in (flash, ffn, qkv):
    c.launches = c.mma_launches = 0
flash.tf32_launches = 0
outs = [model.fn(feed) for _ in range(calls)]
np.savez(out + ".npz", *outs[-1])
with open(art, "rb") as f:
    nodes = kernel_ops(load_exported(f.read())[1])
with open(out + ".json", "w") as f:
    json.dump({"flash": [flash.launches, flash.mma_launches, flash.tf32_launches],
               "ffn": [ffn.launches, ffn.mma_launches],
               "qkv": [qkv.launches, qkv.mma_launches],
               "models": sorted(m for m in sys.modules
                                if m.startswith("multimodal_supernovae_tpu_torch.models")),
               "jax": sorted(m for m in sys.modules
                             if m == "jax" or m.startswith("multimodal_supernovae_tpu.")),
               "load_s": load_s, "batch": model.batch_size,
               "modalities": model.modalities, "nodes": nodes}, f)
"""


def _host_counts(raw):
    """The 14 numbers of COUNT_NAMES from a fresh process's forward counters."""
    (fl, fm, ft), (bl, bm), (ql, qm) = raw["flash"], raw["ffn"], raw["qkv"]
    return (fl - fm - ft, 0, fm, 0, bl - bm, 0, ql - qm, 0, qm, 0, bm, 0, ft, 0)


def _artifact_ops(per_call):
    """{op: nodes} an artifact must hold for a live call's launches."""
    want = {}
    for i, op in EXPORT_OPS.items():
        if per_call[i]:
            want[op] = want.get(op, 0) + per_call[i]
    return want


def _dispatch_times():
    """The flash forward through its registered op against the direct
    launcher (``_flash_fwd``) at the LC and SP serving shapes in bf16, the
    encoder's head-split views, in inference mode as served: host ms a call
    and CUDA-event ms a call.
    Both must give the same bits."""
    out = {}
    g = torch.Generator(device=DEVICE).manual_seed(4)
    for name, (b, h, t, s) in (("LC", (BATCH, 8, NBAND * LC_LEN, 8)),
                               ("SP", (BATCH, 2, SP_LEN, 16))):
        x = torch.randn(b, t, 3 * h * s, device=DEVICE, generator=g).to(torch.bfloat16)
        q, k, v = (a.view(b, t, h, s).transpose(1, 2) for a in x.split(h * s, dim=-1))
        mask = torch.rand(b, t, device=DEVICE, generator=g) > 0.2

        def op():
            return flash_mod.flash_attention_fwd(q, k, v, mask, h * s)

        def direct():
            return flash_mod._flash_fwd(q, k, v, mask, h * s, with_stats=False)[0]

        if not torch.equal(op(), direct()):
            raise AssertionError(f"export dispatch {name}: the op and the launcher differ")
        times = {}
        with torch.inference_mode():  # as served
            for _ in range(2):  # in turns
                for tag, fn in (("op", op), ("direct", direct)):
                    times.setdefault(f"{tag}_host_ms", []).append(_host_ms(fn))
                    times.setdefault(f"{tag}_ms", []).append(_time_ms(fn))
        out[name] = {k: float(np.median(v)) for k, v in times.items()}
        log(f"export dispatch {name} (B, H, T, S) = {(b, h, t, s)} bf16, inference mode: host "
            f"{out[name]['op_host_ms'] * 1e3:.1f} us a call through the op, "
            f"{out[name]['direct_host_ms'] * 1e3:.1f} us through the launcher; events "
            f"{out[name]['op_ms']:.4f} ms against {out[name]['direct_ms']:.4f} ms (medians of "
            "two rounds in turns)")
    return out


def phase_export(card):
    """The serving artifact on the card: serve's maven-lite run dir (B = 256,
    LC 2 x 100, SP 1024, bf16), the same under MMSN_FUSED_BLOCK=1 and under
    MMSN_FUSED_QKV=1, and a float32 one, each exported by cli.export_model
    --check, then reloaded in a fresh process that imports no model code:
    its graph must hold one op node a launch of the live call, its launches
    a call must equal the live call's and its embeddings lie within
    ARTIFACT_TOL of load_live's. While those processes run, each artifact
    is served here over HTTP to phase serve's requests, within SERVE_TOL of
    the plain path; once they have ended (they would share the host with
    the timings), each artifact's call is timed against load_live's and the
    op's dispatch against the launcher. Returns the launches of every
    counted call and the dispatch times."""
    t_phase = time.perf_counter()
    syn, feeds = _serve_feeds()
    full = {k: syn[k][:BATCH] for k in SERVE_FIELDS}
    total, cases, hosts = NONE, [], []
    root = os.path.dirname(os.path.abspath(__file__))
    host_env = {k: v for k, v in os.environ.items() if not k.startswith("MMSN_FUSED")}
    host_env["PYTHONPATH"] = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                                             if p)
    with tempfile.TemporaryDirectory() as tmp:
        feed_path = os.path.join(tmp, "feed.npz")
        np.savez(feed_path, **full)
        try:
            for tag, dtype, env in EXPORT_CASES:
                run_dir, art = os.path.join(tmp, tag), os.path.join(tmp, f"{tag}.pt2")
                os.makedirs(run_dir)
                _run_dir(run_dir, compute_dtype=dtype)
                with mock.patch.dict(os.environ, env):
                    live = load_live(run_dir, BATCH, device=DEVICE, lc_len=LC_LEN,
                                     sp_len=SP_LEN)
                    live.fn(full)
                    _zero_counts()
                    want = live.fn(full)
                    per_call = _counts()
                    counts, _, printed = _cli_counted(f"export {tag}", cli_export_model.main, [
                        run_dir, "--out", art, "--batch-size", str(BATCH), "--lc-len",
                        str(LC_LEN), "--sp-len", str(SP_LEN), "--device", DEVICE, "--check"])
                check = tuple(2 * c for c in per_call)  # the artifact's and the live call
                if "CHECK OK" not in printed or counts != check or sum(per_call[1::2]):
                    raise AssertionError(f"export {tag}: launches {counts} (want {check}, "
                                         "the check's two calls; the trace launches none)")
                total = tuple(a + c for a, c in zip(total, counts))
                hosts.append(subprocess.Popen(
                    [sys.executable, "-c", ARTIFACT_HOST, art, feed_path,
                     os.path.join(tmp, f"{tag}-host"), str(ARTIFACT_CALLS)],
                    cwd=root, env=host_env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
                cases.append([tag, env, run_dir, art, live, want, per_call])
            for case in cases:  # beside the fresh processes: nothing timed
                tag, env, run_dir, art, live, want, per_call = case
                with mock.patch.dict(os.environ, env):  # the plain path's dispatch reads it
                    model, launches = _export_serve(tag, run_dir, art, full, want, per_call,
                                                    feeds)
                total = tuple(a + c for a, c in zip(total, launches))
                case.append(model)
            for (tag, _, _, _, _, want, per_call, _), proc in zip(cases, hosts):
                total = tuple(a + c for a, c in zip(total, _export_host(
                    tag, proc, os.path.join(tmp, f"{tag}-host"), want, per_call)))
        finally:
            for proc in hosts:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        for tag, env, _, _, live, _, _, model in cases:
            with mock.patch.dict(os.environ, env):  # the live call's dispatch reads it
                _export_time(tag, model, live, full, card)
        del cases
        dispatch = _dispatch_times()
    log(f"export: launches {COUNT_NAMES} {total}; card {card}; phase done in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total, dispatch


def _export_serve(tag, run_dir, art, full, want, per_call, feeds):
    """One artifact through load_artifact in this process: its embeddings
    against load_live's, then served by EmbedServer to phase serve's
    requests (launches a device call the live call's, answers within
    SERVE_TOL of the plain path). Returns the ServingModel and the served
    launches."""
    model = load_artifact(art, device=DEVICE)
    got = model.fn(full)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    bitwise = all(np.array_equal(g, w) for g, w in zip(got, want))
    log(f"export {tag}: load_artifact in this process: max|artifact - load_live| "
        f"{err:.3e} (tol {ARTIFACT_TOL}), bitwise {bitwise}")
    if err > ARTIFACT_TOL:
        raise AssertionError(f"export {tag}: max|artifact - load_live| {err}")
    srv = EmbedServer(model, host="127.0.0.1", port=0, max_wait_ms=50.0)
    try:
        results, launches, calls, plain = _serve_requests(f"export {tag} serve", srv, feeds)
    finally:
        srv.close()
    if launches != tuple(calls * c for c in per_call) or plain:
        raise AssertionError(f"export {tag} serve: launches {launches} for {calls} device "
                             f"calls of {per_call}, {len(plain)} plain calls")
    _served_vs_plain(f"export {tag} serve", run_dir, feeds, results)
    return model, launches


def _export_host(tag, proc, stem, want, per_call):
    """The fresh process's report on one artifact: its exit, the graph's op
    nodes against the live call's launches, its launches, the modules it
    imported and its embeddings against load_live's. Returns its launches."""
    out, _ = proc.communicate(timeout=ARTIFACT_HOST_TIMEOUT_S)
    if proc.returncode:
        for line in out.splitlines()[-30:]:
            log(f"export {tag} host: {line}")
        raise AssertionError(f"export {tag}: the fresh process exited {proc.returncode}")
    with open(stem + ".json") as f:
        rep = json.load(f)
    with np.load(stem + ".npz") as z:
        got = [z[f"arr_{i}"] for i in range(len(z.files))]
    counts = _host_counts(rep)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    bitwise = all(np.array_equal(g, w) for g, w in zip(got, want))
    log(f"export {tag} host: a fresh process loaded the artifact and made its first call "
        f"in {rep['load_s']:.2f} s; the graph's kernel ops {rep['nodes']} (the live call "
        f"launches {per_call}); {ARTIFACT_CALLS} calls launched {counts}; max|artifact - "
        f"load_live| {err:.3e} (tol {ARTIFACT_TOL}), bitwise {bitwise}; model modules "
        f"imported {rep['models']}, JAX modules {rep['jax']}")
    if (rep["nodes"] != _artifact_ops(per_call)
            or counts != tuple(ARTIFACT_CALLS * c for c in per_call) or rep["models"]
            or rep["jax"] or err > ARTIFACT_TOL or len(got) != len(want)
            or rep["batch"] != BATCH):
        raise AssertionError(f"export {tag} host: nodes {rep['nodes']}, launches {counts}, "
                             f"modules {rep['models']} {rep['jax']}, error {err}")
    return counts


def _export_time(tag, model, live, full, card):
    """An artifact's call against load_live's at B = 256: the host clock
    (copies in and out included) in rounds of EXPORT_TIMED consecutive
    calls, artifact, live, live, artifact; device time and idle share by
    torch.profiler; and, as diagnostics, three calls of each in
    alternation and the garbage collector's runs inside the timed calls."""
    fns = {"artifact": model.fn, "load_live": live.fn}
    host = {name: [] for name in fns}
    gc_ms = {name: [] for name in fns}  # the collector's pauses inside each timed call
    now = {"call": None, "t0": 0.0}

    def collected(phase, info):
        if phase == "start":
            now["t0"] = time.perf_counter()
        elif now["call"] is not None:
            gc_ms[now["call"]].append((info["generation"],
                                       round((time.perf_counter() - now["t0"]) * 1e3, 3)))

    gc.callbacks.append(collected)
    try:
        for name in ("artifact", "load_live", "load_live", "artifact"):
            for _ in range(EXPORT_TIMED):
                torch.cuda.synchronize()
                now["call"] = name
                t0 = time.perf_counter()
                fns[name](full)
                host[name].append((time.perf_counter() - t0) * 1e3)
                now["call"] = None
    finally:
        gc.callbacks.remove(collected)
    alternating = {name: [] for name in fns}
    for _ in range(3):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(full)
            alternating[name].append(round((time.perf_counter() - t0) * 1e3, 3))
    traced = {name: _trace(lambda fn=fn: fn(full), PROFILED_STEPS) for name, fn in fns.items()}
    log(f"export {tag}: a call at B={BATCH} (host clock, copies in and out included, median "
        f"of {2 * EXPORT_TIMED} in rounds A, L, L, A): artifact "
        f"{np.median(host['artifact']):.3f} ms, load_live {np.median(host['load_live']):.3f} "
        f"ms; device time {traced['artifact'][0]:.3f} ms against "
        f"{traced['load_live'][0]:.3f} ms, idle share {traced['artifact'][3]:.3f} against "
        f"{traced['load_live'][3]:.3f}; in alternation (a diagnostic) {alternating}; the "
        f"garbage collector's runs inside the timed calls (generation, ms) {gc_ms}, "
        f"{len(gc.get_objects())} objects tracked, {threading.active_count()} threads; card "
        f"{card}")
    for name in fns:
        _log_trace(f"profile export {tag} {name}", "calls", *traced[name],
                   at=f"B={BATCH}, the {tag} run dir")


def _train_model(compute_dtype, seed=0, fused=False):
    cfg = CLIPConfig.create(
        combinations=("lightcurve", "spectral"), enc_dim=32, nband=NBAND,
        logit_scale_init=19.55, loss="softmax", transformer_kwargs=_seq_lc(fused),
        transformer_spectral_kwargs=SEQ_SP, compute_dtype=compute_dtype)
    return CLIPModel(cfg, generator=torch.Generator().manual_seed(seed)).to(DEVICE)


@contextlib.contextmanager
def _plain_calls():
    """Records each call of a kernel's plain version (forward or backward)
    made through the kernels' wrappers on a device other than meta."""
    calls = []

    def counted(fn):
        def wrapped(*args, **kw):
            # a meta-device call is shape work (the ensemble's dry run), no fallback
            if not (args and isinstance(args[0], torch.Tensor) and args[0].is_meta):
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
    """Every kernel replaced by its plain version: the encoders' attention
    (the sequence towers' and the ViT's) by dense_attention (with torch
    autograd), the fused block's forward and
    backward by fused_ffn_block_plain and fused_ffn_block_bwd_plain, the
    fused-QKV forward and backward by fused_qkv_attention_plain and
    fused_qkv_attention_bwd_plain; stacked members (``members``) member by
    member, as the CPU runs them."""
    def ffn_fwd(*a, eps, members=None):
        return per_member(ffn_mod.fused_ffn_block_plain, members, *a, eps=eps)

    def ffn_bwd(*a, eps=ffn_mod.LN_EPS, members=None):
        return per_member(ffn_mod.fused_ffn_block_bwd_plain, members, *a, eps=eps)

    def qkv_fwd(x, mask, wqkv, wu, bu, heads, members=None):
        return per_member(qkv_mod.fused_qkv_attention_plain, members, x, mask, wqkv, wu, bu,
                          heads=heads)

    def qkv_bwd(x, mask, wqkv, wu, g, heads, members=None):
        return per_member(qkv_mod.fused_qkv_attention_bwd_plain, members, x, mask, wqkv, wu,
                          g, heads=heads)

    with mock.patch.object(transformer_mod, "attention", dense_attention), \
            mock.patch.object(vit_mod, "attention", dense_attention), \
            mock.patch.object(ffn_mod, "_ffn_fwd", ffn_fwd), \
            mock.patch.object(ffn_mod, "fused_ffn_block_bwd", ffn_bwd), \
            mock.patch.object(qkv_mod, "_qkv_fwd", qkv_fwd), \
            mock.patch.object(qkv_mod, "fused_qkv_attention_bwd", qkv_bwd):
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
    order = (main_path, *others, main_path)
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

    def recording(x, mask, wqkv, wu, g, heads, members=None):
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


def _towers_grads(tag, cfg, batch, per_step, make=None):
    """Every parameter's gradient of one float32 train-mode loss (noise off)
    from ``cfg``'s seeded weights on ``batch``: the kernel path held to the
    plain path, and the kernel path with every dq off by 1% shown to fail
    the same check, as phase_train holds them. Both take the plain path's
    ReLU masks (_relu_masks); the kernel path on its own masks is logged,
    not held. ``make()``, where given, builds the model in place of ``cfg``'s
    CLIPModel. Returns the kernel path's launches, which must be
    ``per_step``."""
    grads, counts, masks, flips = {}, {}, [], {}
    for name, path in (("plain", "plain"), ("kernel", "kernel"), (WRONG_DQ, WRONG_DQ),
                       ("kernel, own masks", "kernel")):
        model = (make() if make is not None else
                 CLIPModel(cfg, generator=torch.Generator().manual_seed(0)).to(DEVICE))
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


# phase vit: configs/trimodal.yaml's first grid point with image_encoder vit at
# the JAX ViT defaults (its extra_args name no vit_* key: emb 128, depth 6, 4
# heads, the patch its cnn_patch_size 10, mlp 4), 60 x 60 images: 36 tokens at
# head dim 32, which the flash forward takes on the CUDA cores (row 1a) and the
# backward on the tensor cores (rows 2b and 2c)
VIT_N, VIT_EPOCHS, VIT_TRAJ_STEPS, VIT_TIMED = 320, 2, 6, 6
VIT_TIMED_B = (32, 256)  # the flash rows' times at the tower's shape, B = 32 and 256
# (emb, depth, heads, patch, mlp_mult, n_out), tokens, head dim, B
VIT_STATED = ((128, 6, 4, 10, 4, 32), 36, 32, 32)


def _vit_setup():
    """The trimodal ViT grid point: (sweep, point, extra, clip config, trainer
    config), held to VIT_STATED."""
    sweep = load_sweep(TRIMODAL)
    point = next(expand_grid(sweep))
    extra = dict(sweep.extra_args, image_encoder="vit")
    clip_cfg = build_clip_config(point, extra, nband=NBAND)
    tcfg = dataclasses.replace(build_trainer_config(point, extra), epochs=VIT_EPOCHS)
    vk = clip_cfg.vk()
    stated = ((vk["emb"], vk["depth"], vk["heads"], vk["patch_size"], vk["mlp_mult"],
               vk["n_out"]), (IMAGE_SIZE // vk["patch_size"]) ** 2, vk["emb"] // vk["heads"],
              tcfg.batch_size)
    log(f"vit: {TRIMODAL}'s first grid point with extra_args.image_encoder vit; ViT {vk}; "
        f"LC {clip_cfg.tk()}; SP {clip_cfg.tsk()}; trainer {tcfg}; cut: epochs "
        f"{point['epochs']} -> {VIT_EPOCHS}")
    if stated != VIT_STATED:
        raise AssertionError(f"vit: the grid point gives {stated}, not {VIT_STATED}")
    return sweep, point, extra, clip_cfg, tcfg


def _vit_flash_times(gen, b, dtype_name):
    """The flash forward and backward at the ViT's (B, 4, 36, 32), no mask, in
    the encoder's layout, each on the tensor cores as routed (1b/2b in bf16,
    1c/2c in float32) and on the CUDA cores (1a/2a, through a patch of
    _route), each held to dense_attention and its autograd (TOL / GRAD_TOL;
    bf16 also NORM_TOL, 3xTF32 FP32_NORM_TOL), then timed as phases kernel
    and kernel-bwd time every flash row (CUDA events, device sums, the
    wrapper's host time, the plain version, and scaled_dot_product_attention
    at scale S**-0.5 with its autograd). Returns ({"fwd": times, "bwd":
    times}, max|err|)."""
    h, t, s = VIT_STATED[0][2], VIT_STATED[1], VIT_STATED[2]
    dtype = getattr(torch, dtype_name)
    fwd, bwd = flash_mod._flash_fwd, flash_mod.flash_attention_bwd
    flash_attention = flash_mod.flash_attention
    q, k, v = _heads(gen, b, h, t, s, dtype, True)
    g = torch.randn((b, t, h, s), generator=gen).to("cuda", dtype).transpose(1, 2)
    tc = "mma" if dtype == torch.bfloat16 else "tf32"
    # the rule's answer for q, k, v; the calls below show each direction's
    routes = (flash_mod._route(dtype, s, (q, k, v)), flash_mod._route(dtype, s, (q, k, v), True))
    if routes != (tc, tc):
        raise AssertionError(f"vit {dtype_name}: head dim {s} takes {routes}, not the {tc} "
                             f"tensor cores both ways")
    want = dense_attention(q, k, v, None, s)
    want_g = dense_attention_bwd(q, k, v, None, g, s)
    errs = {}
    for route in (tc, "simt"):
        before = (_route_counts(flash_mod.flash_attention), _route_counts(bwd))
        with ROUTES[route]():
            out, stats = fwd(q, k, v, None, s, with_stats=True)
            got = bwd(q, k, v, None, out, stats, g, s)
        torch.cuda.synchronize()
        if not (_on_route(flash_mod.flash_attention, before[0], route)
                and _on_route(bwd, before[1], route)):
            raise AssertionError(f"vit flash {b} {dtype_name}: not on the {route} route")
        for name, a, w, tol in ((f"out {route}", out, want, TOL[dtype_name]),
                                *((f"{n} {route}", a, w, GRAD_TOL[dtype_name])
                                  for n, a, w in zip(("dq", "dk", "dv"), got, want_g))):
            errs[name] = float((a.float() - w.float()).abs().max())
            torch.testing.assert_close(a.float(), w.float(), rtol=tol, atol=tol,
                                       msg=lambda m: f"vit flash {b} {dtype_name} {name}: {m}")
            rel, ntol = _route_norm(a, w, dtype, route, f"vit flash {b} {dtype_name} {name}")
            errs[name + "_norm"] = rel
    times = {"fwd": {}, "bwd": {}}
    tf, tb = times["fwd"], times["bwd"]
    for route in (tc, "simt"):
        with ROUTES[route]():
            tf[route] = _time_ms(lambda: flash_attention(q, k, v, None, s))
            tf[f"{route}_device"] = _device_ms(lambda: flash_attention(q, k, v, None, s))
            tf[f"{route}_host"] = _host_ms(lambda: flash_attention(q, k, v, None, s))
    tf["plain"] = _time_ms(lambda: dense_attention(q, k, v, None, s))
    tf["library"] = _time_ms(lambda: _sdpa(q, k, v, None, s))
    tf["library_device"] = _device_ms(lambda: _sdpa(q, k, v, None, s))
    for route in (tc, "simt"):
        with ROUTES[route]():
            tb[route] = _time_ms(lambda: bwd(q, k, v, None, out, stats, g, s))
            tb[f"{route}_device"] = _device_ms(lambda: bwd(q, k, v, None, out, stats, g, s))
            tb[f"{route}_host"] = _host_ms(lambda: bwd(q, k, v, None, out, stats, g, s))
    leaves = [a.detach().requires_grad_() for a in (q, k, v)]
    plain_out, lib_out = dense_attention(*leaves, None, s), _sdpa(*leaves, None, s)
    tb["plain"] = _time_ms(lambda: torch.autograd.grad(plain_out, leaves, g,
                                                       retain_graph=True))
    tb["library"] = _time_ms(lambda: torch.autograd.grad(lib_out, leaves, g,
                                                         retain_graph=True))
    tb["library_device"] = _device_ms(lambda: torch.autograd.grad(lib_out, leaves, g,
                                                                  retain_graph=True))
    shape = (b, h, t, s)
    log(f"vit flash {shape} {dtype_name}, no mask, forward and backward on the {tc} tensor "
        f"cores and on the CUDA cores: max|err| " + ", ".join(
            f"{n} {e:.3e}" if not n.endswith("_norm") else f"{n} {_fmt(e)}"
            for n, e in errs.items()) + f" (tol {TOL[dtype_name]} / {GRAD_TOL[dtype_name]}, "
        f"norm {NORM_TOL if dtype == torch.bfloat16 else FP32_NORM_TOL} where held)")
    for part in ("fwd", "bwd"):
        log(f"time-vit {part} {shape} {dtype_name}: " + ", ".join(
            f"{r} {ms:.4f} ms" for r, ms in times[part].items()) + " " + TIMING_NOTE)
    for part, row in (("fwd", "1a"), ("bwd", "2a")):
        tp = times[part]
        log(f"time-vit {part} {shape} {dtype_name}: device time {tc} {tp[f'{tc}_device']:.4f} "
            f"ms against the CUDA cores' (row {row}) {tp['simt_device']:.4f} ms "
            f"({tp['simt_device'] / tp[f'{tc}_device']:.2f}x) and SDPA's "
            f"{tp['library_device']:.4f} ms ({tp[f'{tc}_device'] / tp['library_device']:.2f}x "
            f"of it)")
    return times, max(v for n, v in errs.items() if not n.endswith("_norm"))


@contextlib.contextmanager
def _recorded_attention():
    """Every attention call of the ViT recorded: (q, k, v, head dim, its
    output, and after the backward the cotangent and the q, k, v
    gradients), the call itself going through ``vit_mod.attention`` as it
    is."""
    calls, real = [], vit_mod.attention

    def recording(q, k, v, mask, emb):
        out = real(q, k, v, mask, emb)
        rec = {"qkv": (q.detach(), k.detach(), v.detach()), "emb": emb, "out": out.detach()}
        calls.append(rec)
        out.register_hook(lambda g: rec.__setitem__("g", g))
        for name, a in zip("qkv", (q, k, v)):
            a.register_hook(lambda g, name=name: rec.__setitem__("d" + name, g))
        return out

    with mock.patch.object(vit_mod, "attention", recording):
        yield calls


# bf16 dq of the ViT's layers: its distance to the float64 gradient over the
# plain bf16 version's. At the tower's own activations (36 near-uniform keys)
# dP - D cancels, and both bf16 paths sit about 1e-2 from float64 in
# ||err|| / ||ref|| (a CPU model of the kernel's arithmetic, dS rounded to bf16
# as the TPU kernel rounds it, against the plain version's dP rounded to bf16:
# 0.90-1.06 of it over the six layers); dq x 0.99 reads about 1.4
VIT_BF16_DQ_RATIO = 1.2


def _vit_layer_errors(calls):
    """Each recorded attention call's output and its q, k, v gradients against
    dense_attention and its autograd on the same inputs and cotangent:
    {name: (max|diff| / max|plain|, ||diff|| / ||plain||)}, the worst over
    the layers, and "dq_ratio": the worst ratio of dq's distance to the
    float64 gradient to the plain version's (||.|| / ||ref||)."""
    worst = {}
    for rec in calls:
        q, k, v = rec["qkv"]
        want = dense_attention(q, k, v, None, rec["emb"])
        grads = dense_attention_bwd(q, k, v, None, rec["g"], rec["emb"])
        for name, got, ref in (("out", rec["out"], want),
                               *((n, rec[n], w) for n, w in zip(("dq", "dk", "dv"), grads))):
            err = (float((got.float() - ref.float()).abs().max())
                   / float(ref.float().abs().max()), _norm_err(got, ref) or 0.0)
            worst[name] = tuple(max(a, b) for a, b in zip(worst.get(name, (0.0, 0.0)), err))
        ref64 = _attention_f64_grads(q, k, v, None, rec["g"], rec["emb"])[0]
        ratio = _norm_err(rec["dq"], ref64) / _norm_err(grads[0], ref64)
        worst["dq_ratio"] = max(worst.get("dq_ratio", 0.0), ratio)
    return worst


def _vit_bf16_tower(vk, gen_seed=5):
    """The ViT tower of ``vk`` alone in bf16 (B = 32, 60 x 60 images), one
    forward and backward on the kernel path, from the same weights as the
    plain path's and a float32 plain run's. Held: each of its 6 attention
    layers' output, dk and dv against dense_attention and its autograd on
    the layer's own inputs and cotangent, and the tower's output against the
    plain path's, within 0.05 of the largest and NORM_TOL in ||got - want||
    / ||want||; dq within 0.05 and, in place of NORM_TOL (both bf16 paths sit
    about 1e-2 from float64 there), no farther from the float64 gradient than
    VIT_BF16_DQ_RATIO x the plain version; the dq x 0.99 control must fail
    the dq check. The parameter gradients, which two bf16 runs of the same
    math spread by up to 6e-2 normalised (a CPU probe: the plain path
    against itself with attention rounded once from float32), are held to
    be no farther from the float32 run's than 2x the plain bf16 path's.
    Returns the launches (6 forwards and 6 backwards on the bf16 tensor
    cores)."""
    b = VIT_STATED[3]
    x = torch.rand((b, IMAGE_SIZE, IMAGE_SIZE, 3),
                   generator=torch.Generator().manual_seed(gen_seed)).to(DEVICE)
    w = torch.randn((b, vk["n_out"]),
                    generator=torch.Generator().manual_seed(gen_seed + 1)).to(DEVICE)
    outs, grads, counts, layers = {}, {}, {}, {}
    for path, dtype in (("float32", None), ("plain", torch.bfloat16),
                        ("kernel", torch.bfloat16), (WRONG_DQ, torch.bfloat16)):
        tower = ViT(dtype=dtype, image_size=IMAGE_SIZE, **vk)
        init_weights(tower, torch.Generator().manual_seed(0))
        tower = tower.to(DEVICE)
        ctx = PATHS["plain" if path == "float32" else path][1]
        with ctx(), _plain_calls() as plain, _recorded_attention() as calls:
            _zero_counts()
            out = tower(x)
            (out.float() * w).sum().backward()
            counts[path] = _counts()
        if path in ("kernel", WRONG_DQ):
            if plain:
                raise AssertionError(f"vit bf16 {path}: {len(plain)} plain calls")
            layers[path] = _vit_layer_errors(calls)
        outs[path] = out.detach()
        grads[path] = {n: p.grad for n, p in tower.named_parameters()}
        del tower, calls
    depth = vk["depth"]
    _check_counts("vit bf16 tower", counts["kernel"], (0, 0, depth, depth) + (0,) * 10)
    _check_counts("vit bf16 tower plain", counts["plain"], NONE)
    out_err = (float((outs["kernel"].float() - outs["plain"].float()).abs().max())
               / float(outs["plain"].float().abs().max()), _norm_err(outs["kernel"], outs["plain"]))
    held = {n: e for n, e in layers["kernel"].items() if n != "dq_ratio"}
    held["tower_out"] = out_err
    bad = {n: e for n, e in held.items() if not (e[0] <= GRAD_TOL["bfloat16"] and (
        e[1] <= NORM_TOL or n == "dq"))}
    if not layers["kernel"]["dq_ratio"] <= VIT_BF16_DQ_RATIO:
        bad["dq_ratio"] = layers["kernel"]["dq_ratio"]
    control = layers[WRONG_DQ]["dq_ratio"]
    ratio = {}
    for n, g32 in grads["float32"].items():
        ratio[n] = ((_norm_err(grads["kernel"][n], g32) or 0.0)
                    / max(_norm_err(grads["plain"][n], g32) or 0.0, 1e-30))
    top = max(ratio, key=ratio.get)
    spread = max(grads["plain"], key=lambda n: _norm_err(grads["kernel"][n], grads["plain"][n]))
    log(f"vit bf16 tower (B={b}): each of {depth} attention layers against the plain "
        f"versions on its own inputs (max|diff|/max|plain|, normalised): " + ", ".join(
            f"{n} {e[0]:.3e} / {e[1]:.3e}" for n, e in held.items())
        + f" (tol {GRAD_TOL['bfloat16']} / {NORM_TOL}, dq's normalised not held); dq's "
        f"distance to float64 over the plain version's, the worst {layers['kernel']['dq_ratio']:.3f} "
        f"(tol {VIT_BF16_DQ_RATIO}); {WRONG_DQ}: {control:.3f} (must exceed "
        f"{VIT_BF16_DQ_RATIO}); {len(ratio)} parameter gradients: the "
        f"kernel path's distance to the float32 run over the plain bf16 path's, the worst "
        f"{ratio[top]:.3f} at {top} (tol 2); kernel against plain bf16, the widest "
        f"{_norm_err(grads['kernel'][spread], grads['plain'][spread]):.3e} at {spread} "
        f"(not held); launches {counts['kernel']}")
    if bad or not control > VIT_BF16_DQ_RATIO or ratio[top] > 2.0:
        raise AssertionError(f"vit bf16 tower: {bad}, control {control:.3e}, gradient ratio "
                             f"{ratio[top]:.3f} at {top}")
    return counts["kernel"]


VIT64_HEADS, VIT64_STEPS = 2, 3  # vit_emb 128 / 2 heads: head dim 64; its float32 steps


def _vit_head_dim_64(point, extra, data, plan, seq, sp_len):
    """The trimodal ViT grid point at vit_heads 2 (head dim 128 / 2 = 64,
    above the ViT's shipped 32): --check's preflight for the card, which
    must pass and name the 3xTF32 tensor-core route, then VIT64_STEPS
    float32 steps of the kernel path against the plain path (relative
    TRAJ_RTOL a step) and every parameter's gradient (GRAD_RTOL, with the dq
    x 0.99 control), as phase vit holds the shipped ViT. Returns the
    launches: the ViT's forwards and backwards on the 3xTF32 tensor cores,
    beside the sequence towers'."""
    point64 = dict(point, vit_heads=VIT64_HEADS)
    rep = preflight.preflight_run(point64, extra, NBAND, 2 * LC_LEN, sp_len,
                                  image_size=IMAGE_SIZE)
    note = next(n for n in rep["notes"] if n.startswith("image (ViT)"))
    log(f"vit head dim 64: --check's preflight of the grid point at vit_heads "
        f"{VIT64_HEADS}: {note}")
    if not note.endswith("-> flash tf32 (3xTF32 tensor cores)"):
        raise AssertionError(f"vit head dim 64: the preflight names {note!r}")
    cfg = build_clip_config(point64, extra, nband=NBAND)
    vk = cfg.vk()
    if vk["emb"] // vk["heads"] != 64:
        raise AssertionError(f"vit head dim 64: the config gives {vk}")
    tcfg = build_trainer_config(point64, extra)
    depth = vk["depth"]
    per_step = (0,) * 12 + (seq + depth, seq + depth)
    plan = plan[:VIT64_STEPS]
    losses, total = {}, NONE
    for path in ("kernel", "plain"):
        model = CLIPModel(cfg, generator=torch.Generator().manual_seed(0)).to(DEVICE)
        opt, _ = build_optimizer(model.named_parameters(), lr=tcfg.lr,
                                 weight_decay=tcfg.weight_decay)
        run = make_epoch_runner(model, tcfg.noise_level_mag,
                                noise_level_img=tcfg.noise_level_img)
        with PATHS[path][1](), _plain_calls() as plain:
            _zero_counts()
            _, got = run(TrainState(model, opt), data, plan,
                         torch.Generator(device=DEVICE).manual_seed(2))
            counts = _counts()
        want = NONE if path == "plain" else tuple(c * len(plan) for c in per_step)
        if counts != want or (plain and path == "kernel"):
            raise AssertionError(f"vit head dim 64 {path}: launches {counts}, want {want}")
        losses[path] = got.cpu().numpy()
        total = tuple(a + c for a, c in zip(total, counts))
        del model, opt
    rel = np.abs(losses["kernel"] - losses["plain"]) / np.abs(losses["plain"])
    log(f"vit head dim 64: ViT {vk}; {len(plan)} float32 steps, kernel "
        f"{losses['kernel'].tolist()}, plain {losses['plain'].tolist()}, worst relative "
        f"difference {rel.max():.3e} (tol {TRAJ_RTOL}); launches a step {per_step}: the ViT's "
        f"{depth} forwards and backwards on the 3xTF32 tensor cores (rows 1c/2c) beside the "
        f"sequence towers' {seq}")
    if not np.all(np.isfinite(losses["kernel"])) or rel.max() > TRAJ_RTOL:
        raise AssertionError(f"vit head dim 64: the trajectory leaves the plain path's: {rel}")
    one = take(data, torch.from_numpy(plan[0]).to(DEVICE))
    counts = _towers_grads("vit head dim 64", cfg, one, per_step)
    return tuple(a + c for a, c in zip(total, counts))


def phase_vit(card):
    """The ViT image tower in a trimodal model on the card: Trainer.fit into a
    run dir, the run dir rebuilt without its sidecar, served, the float32
    trajectory and gradients against the plain path, the tower in bf16, the
    step's time and profile, and the flash rows timed at its shape on both
    routes. Returns the launches of every counted call and the timings."""
    t_phase = time.perf_counter()
    sweep, point, extra, clip_cfg, tcfg = _vit_setup()
    depth, seq = clip_cfg.vk()["depth"], clip_cfg.tk()["depth"] + clip_cfg.tsk()["depth"]
    # float32: the ViT's and the sequence towers' flash both ways on 3xTF32
    per_step = (0,) * 12 + (seq + depth, seq + depth)
    sp_len = int(extra["max_spectral_data_len"])
    ds = make_synthetic_dataset(n=VIT_N, n_max_lc=LC_LEN, nband=NBAND, n_max_sp=sp_len,
                                image_size=IMAGE_SIZE, modalities=clip_cfg.combinations, seed=0)
    train_ds, val_ds = _split(ds, extra["val_fraction"])
    b = tcfg.batch_size
    train_steps, eval_steps = -(-len(train_ds) // b), -(-len(val_ds) // b)
    total = NONE
    with tempfile.TemporaryDirectory() as tmp:
        # (a) Trainer.fit into a run dir of a sweep directory
        run_dir = os.path.join(tmp, "trimodal-vit", "run-0")
        model = CLIPModel(clip_cfg, generator=torch.Generator().manual_seed(0)).to(DEVICE)
        result, counts = _fit_counted(
            "vit fit", Trainer(model, "contrastive", tcfg, run_dir=run_dir), train_ds, val_ds,
            _fit_want(per_step, VIT_EPOCHS, train_steps, eval_steps),
            config_dump=dict(point, epochs=VIT_EPOCHS))
        total = tuple(a + c for a, c in zip(total, counts))
        keys = ("train_loss", "val_loss", "AUC_val1", "AUC_val2", "AUC_val3")
        if not all(np.isfinite(r[k]) for r in result["metric_rows"] for k in keys):
            raise AssertionError(f"vit fit: {result['metric_rows']}")

        # (b) the sidecar path, then the schema path: no model_config.json, the
        # sweep's sweep_config.yaml beside the run
        fields = ("x_img", "x_lc", "t_lc", "mask_lc", "x_sp", "t_sp", "mask_sp")
        feed = {k: val_ds.arrays[k][:b] for k in fields}
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in feed.items()}
        trained = result["state"].model.eval()
        with torch.no_grad():
            live = [e.cpu().numpy() for e in trained.encode(batch)]
            side_model, _ = load_model(run_dir, DEVICE, which="last")
            side = [e.cpu().numpy() for e in side_model.encode(batch)]
        os.remove(os.path.join(run_dir, "model_config.json"))
        with open(os.path.join(tmp, "trimodal-vit", "sweep_config.yaml"), "w") as f:
            f.write(dump_yaml(dict(sweep.raw, extra_args=extra)))
        schema_model, _ = load_model(run_dir, DEVICE, which="last")
        with torch.no_grad():
            schema = [e.cpu().numpy() for e in schema_model.encode(batch)]
        err = max(float(np.abs(a - w).max()) for a, w in zip(schema, side))
        err_live = max(float(np.abs(a - w).max()) for a, w in zip(side, live))
        same_cfg = schema_model.cfg == side_model.cfg
        log(f"vit run dir: load_model by the sidecar (within {err_live:.3e} of the trained "
            f"model), then without it from config.yaml + sweep_config.yaml: max|schema - "
            f"sidecar| {err:.3e} (tol {RUN_DIR_EMBED_TOL}); the same CLIPConfig: {same_cfg}")
        if err > RUN_DIR_EMBED_TOL or err_live > RUN_DIR_EMBED_TOL:
            raise AssertionError(f"vit run dir: schema {err:.3e}, sidecar {err_live:.3e}")

        # (c) served through load_live (the schema path), against the encode
        served = load_live(run_dir, b, device=DEVICE, which="last", lc_len=LC_LEN,
                           sp_len=sp_len)
        with _plain_calls() as plain, torch.no_grad():
            _zero_counts()
            got = served.fn(feed)
            counts = _counts()
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, live))
        log(f"vit serve: load_live (x_img {served.input_spec['x_img'][0]}), {b} "
            f"samples: max|served - encode| {err:.3e} (tol {RUN_DIR_EMBED_TOL}); launches "
            f"{counts}, {len(plain)} plain calls")
        _check_counts("vit serve", counts, (0,) * 12 + (seq + depth, 0))
        if err > RUN_DIR_EMBED_TOL or plain:
            raise AssertionError(f"vit serve: {err:.3e}, {len(plain)} plain calls")
        total = tuple(a + c for a, c in zip(total, counts))
        del result, model, trained, side_model, schema_model, served

    # (d) the float32 trajectory on the kernel path against the plain path
    plan = epoch_indices(len(train_ds), b, rng=np.random.default_rng(1), shuffle=True,
                         pad="wrap")[:VIT_TRAJ_STEPS]
    data = train_ds.to_device(DEVICE)
    losses = {}
    for path in ("kernel", "plain"):
        model = CLIPModel(clip_cfg, generator=torch.Generator().manual_seed(0)).to(DEVICE)
        opt, _ = build_optimizer(model.named_parameters(), lr=tcfg.lr,
                                 weight_decay=tcfg.weight_decay)
        run = make_epoch_runner(model, tcfg.noise_level_mag,
                                noise_level_img=tcfg.noise_level_img)
        with PATHS[path][1](), _plain_calls() as plain:
            _zero_counts()
            _, got = run(TrainState(model, opt), data, plan,
                         torch.Generator(device=DEVICE).manual_seed(2))
            counts = _counts()
        want = NONE if path == "plain" else tuple(c * len(plan) for c in per_step)
        if counts != want or (plain and path == "kernel"):
            raise AssertionError(f"vit trajectory {path}: launches {counts}, want {want}")
        losses[path] = got.cpu().numpy()
        total = tuple(a + c for a, c in zip(total, counts))
    rel = np.abs(losses["kernel"] - losses["plain"]) / np.abs(losses["plain"])
    log(f"vit trajectory: {len(plan)} float32 steps (noise and rotation on, the same draws), "
        f"kernel {losses['kernel'].tolist()}, plain {losses['plain'].tolist()}, worst "
        f"relative difference {rel.max():.3e} (tol {TRAJ_RTOL})")
    if not np.all(np.isfinite(losses["kernel"])) or rel.max() > TRAJ_RTOL:
        raise AssertionError(f"vit: the kernel path's trajectory leaves the plain path's: {rel}")

    # (e) every parameter's float32 gradient, with the dq x 0.99 control
    one = take(data, torch.from_numpy(plan[0]).to(DEVICE))
    counts = _towers_grads("vit", clip_cfg, one, per_step)
    total = tuple(a + c for a, c in zip(total, counts))

    # (e') a ViT at head dim 64
    counts = _vit_head_dim_64(point, extra, data, plan, seq, sp_len)
    total = tuple(a + c for a, c in zip(total, counts))

    # (f) the tower alone in bf16
    counts = _vit_bf16_tower(clip_cfg.vk())
    total = tuple(a + c for a, c in zip(total, counts))

    # (g) the step's host clock and one profile
    model = CLIPModel(clip_cfg, generator=torch.Generator().manual_seed(0)).to(DEVICE)
    opt, _ = build_optimizer(model.named_parameters(), lr=tcfg.lr)
    state = TrainState(model, opt)
    step = make_train_step(model, tcfg.noise_level_mag, noise_level_img=tcfg.noise_level_img)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    tbatch = take(data, torch.arange(b, device=DEVICE))
    _zero_counts()
    times, loss = _host_step_ms(step, state, tbatch, gen, VIT_TIMED)
    traced = _trace(lambda: step(state, tbatch, gen), PROFILED_STEPS)
    counts = _counts()
    _check_counts("vit timed steps", counts,
                  tuple(c * (VIT_TIMED + 2 + PROFILED_STEPS) for c in per_step))
    total = tuple(a + c for a, c in zip(total, counts))
    log(f"vit: train step (B={b}, float32, ViT image tower) host clock median "
        f"{np.median(times):.3f} ms (quartiles {np.percentile(times, 25):.3f}-"
        f"{np.percentile(times, 75):.3f}) over {VIT_TIMED}; loss {float(loss):.5f}; card {card}")
    _log_trace("vit profile", "train steps", *traced, at=f"B={b} float32")
    del model, opt, state, data, one, tbatch

    # (h) rows 1a/2a and the tensor-core rows at the tower's shape, B = 32 and
    # 256, both dtypes
    gen = torch.Generator().manual_seed(11)
    timing, worst = {}, 0.0
    for bb in VIT_TIMED_B:
        for dtype_name in ("float32", "bfloat16"):
            timing[(bb, dtype_name)], err = _vit_flash_times(gen, bb, dtype_name)
            worst = max(worst, err)
    torch.cuda.empty_cache()
    log(f"vit: launches {COUNT_NAMES} {total}; phase done in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total, timing, worst


def _maven_split(n, sp_len, modalities, val_fraction):
    """The synthetic set of a stage (2 x LC_LEN light-curve points, T_sp =
    ``sp_len``), split at the config's val_fraction."""
    sp = {} if sp_len is None else {"n_max_sp": sp_len}
    ds = make_synthetic_dataset(n=n, n_max_lc=LC_LEN, nband=NBAND, modalities=modalities,
                                seed=0, **sp)
    return _split(ds, val_fraction)


def _fit_counted(tag, trainer, train_ds, val_ds, want, **kw):
    """Trainer.fit counted from zero: the launches must be ``want`` and no
    plain version may run. Returns the result and the launches."""
    with _plain_calls() as plain:
        _zero_counts()
        t0 = time.perf_counter()
        result = trainer.fit(train_ds, val_ds, **kw)
        wall = time.perf_counter() - t0
        counts = _counts()
    for row in result["metric_rows"]:
        log(f"{tag}: epoch {row['epoch']} " + ", ".join(
            f"{k} {v:.7g}" for k, v in row.items()
            if k not in ("epoch", "step_time_s", "samples_per_s"))
            + f", step {row['step_time_s'] * 1e3:.2f} ms (the epoch's mean)")
    log(f"{tag}: Trainer.fit in {wall:.3f} s; launches {counts} (want {want}), "
        f"{len(plain)} plain kernel calls")
    if counts != want or plain:
        raise AssertionError(f"{tag}: launches {counts}, want {want}; {len(plain)} plain")
    return result, counts


def _fit_want(per_step, epochs, train_steps, eval_steps):
    """Launches of ``epochs`` epochs: forwards in train and eval steps,
    backwards in train steps (per_step of a float32 model: _tf32_flash)."""
    return tuple(c * epochs * (train_steps if i % 2 else train_steps + eval_steps)
                 for i, c in enumerate(per_step))


def _maven_trajectory(tag, make, tcfg, data, plan, per_step, freeze=None):
    """MAVEN_TRAJ_STEPS float32 steps (the config's noise, dropout, masks and
    schedule, the same draws) from ``make()``'s weights on the kernel path
    and the plain path; per-step losses within relative TRAJ_RTOL. Returns
    the kernel path's launches."""
    losses, counts = {}, {}
    for path in ("kernel", "plain"):
        model = make()
        opt, sched = build_optimizer(model.named_parameters(), lr=tcfg.lr,
                                     weight_decay=tcfg.weight_decay, step_size=tcfg.step_size,
                                     gamma=tcfg.gamma, steps_per_epoch=len(plan),
                                     freeze=freeze)
        with PATHS[path][1](), _plain_calls() as plain:
            _zero_counts()
            _, got = make_epoch_runner(model, tcfg.noise_level_mag)(
                TrainState(model, opt, sched), data, plan,
                torch.Generator(device=DEVICE).manual_seed(2))
            counts[path] = _counts()
        want = NONE if path == "plain" else tuple(c * len(plan) for c in per_step)
        if counts[path] != want or (plain and path == "kernel"):
            raise AssertionError(f"{tag} trajectory {path}: launches {counts[path]}, want "
                                 f"{want}; {len(plain)} plain calls")
        losses[path] = got.cpu().numpy()
        del model, opt
    rel = np.abs(losses["kernel"] - losses["plain"]) / np.abs(losses["plain"])
    log(f"{tag} trajectory: {len(plan)} float32 steps (the same draws), kernel "
        f"{losses['kernel'].tolist()}, plain {losses['plain'].tolist()}, worst relative "
        f"difference {rel.max():.3e} (tol {TRAJ_RTOL})")
    if not np.all(np.isfinite(losses["kernel"])) or rel.max() > TRAJ_RTOL:
        raise AssertionError(f"{tag}: the kernel path's trajectory leaves the plain path's: "
                             f"{rel}")
    return counts["kernel"]


def _maven_timing(tag, model, tcfg, batch, per_step, card, freeze=None):
    """The train step of ``model`` (the config's noise and lr, ``freeze``) on
    one batch: host-clock ms over MAVEN_TIMED steps after 2 warm-up steps,
    then one profile of PROFILED_STEPS steps. Returns the launches, the
    median host ms and the device ms a step."""
    opt, _ = build_optimizer(model.named_parameters(), lr=tcfg.lr,
                             weight_decay=tcfg.weight_decay, freeze=freeze)
    state = TrainState(model, opt)
    step = make_train_step(model, tcfg.noise_level_mag)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    _zero_counts()
    times, loss = _host_step_ms(step, state, batch, gen, MAVEN_TIMED)
    traced = _trace(lambda: step(state, batch, gen), PROFILED_STEPS)
    counts = _counts()
    b = len(next(iter(batch.values())))
    _check_counts(f"{tag} timed steps", counts,
                  tuple(c * (MAVEN_TIMED + 2 + PROFILED_STEPS) for c in per_step))
    ms = float(np.median(times))
    log(f"{tag}: train step (B={b}, float32) host clock median {ms:.3f} ms (quartiles "
        f"{np.percentile(times, 25):.3f}-{np.percentile(times, 75):.3f}) over "
        f"{MAVEN_TIMED}; loss {float(loss):.6g}; card {card}")
    _log_trace(f"{tag} profile", "train steps", *traced, at=f"B={b} float32")
    if not torch.isfinite(loss):
        raise AssertionError(f"{tag}: loss {loss}")
    return counts, ms, traced[0]


def _unchanged(tag, before, sd, names):
    """``names`` of state_dict ``sd`` bitwise equal to ``before``."""
    moved = [k for k in names if not torch.equal(before[k].to(sd[k].device), sd[k])]
    log(f"{tag}: {len(names) - len(moved)} of {len(names)} tensors bitwise unchanged")
    if moved or not names:
        raise AssertionError(f"{tag}: {moved} changed")


def _maven_masked(card, tmp):
    """Stage (a): masked light-curve pretraining from config_grid.yaml's first
    point. Returns the launches, the run dir, the config point, the data and
    the stage's times."""
    sweep = load_sweep(GRID)
    point, extra = next(expand_grid(sweep)), sweep.extra_args
    builder = masked_model_builder(extra)
    model, task, freeze, override, tcfg = _build_run(point, extra, NBAND, builder,
                                                     MASKED_EPOCHS)
    tk = model.cfg.tk()
    stated = ((tk["emb"], tk["heads"], tk["depth"], tk["n_out"], model.cfg.f_mask,
               model.cfg.contiguous), (task, freeze, override),
              (tcfg.batch_size, tcfg.lr, tcfg.step_size, tcfg.gamma))
    log(f"maven masked: {GRID}, first of {sweep.n_points} grid points; cuts: epochs "
        f"{point['epochs']} -> {MASKED_EPOCHS}, the synthetic light-curve set ({MASKED_N} "
        f"samples, 2 x {LC_LEN} points) for the simulated corpus, val_fraction "
        f"{extra['val_fraction']} for the fold split, nruns {extra['nruns']} -> 1; "
        f"MaskedEncoderConfig {model.cfg}; trainer {tcfg}")
    if stated != MASKED_STATED:
        raise AssertionError(f"maven masked: {GRID} does not give the stated model: {stated}")
    train_ds, val_ds = _maven_split(MASKED_N, None, ("lightcurve",), extra["val_fraction"])
    b = tcfg.batch_size
    train_steps, eval_steps = -(-len(train_ds) // b), -(-len(val_ds) // b)
    depth = tk["depth"]
    per_step = _tf32_flash(depth, depth)
    dump = dict(point, epochs=MASKED_EPOCHS)

    # straight run M, and run R: 2 epochs, then a new model and Trainer resumed to 3
    fits, lrs, total = {}, {}, NONE
    real_runner = trainer_mod.make_epoch_runner

    def recording(tag):
        def make(*a, **kw):
            run = real_runner(*a, **kw)

            def run_epoch(state, *args):
                lrs[tag].append(state.optimizer.param_groups[0]["lr"])
                return run(state, *args)
            return run_epoch
        return make

    m_dir, r_dir = os.path.join(tmp, "M"), os.path.join(tmp, "R")
    for tag, path, epochs, resume in (("M", m_dir, MASKED_EPOCHS, False),
                                      ("R", r_dir, MASKED_EPOCHS - 1, False),
                                      ("R resumed", r_dir, MASKED_EPOCHS, True)):
        model = builder(point, extra, NBAND)[0].to(DEVICE)
        trainer = Trainer(model, "masked", dataclasses.replace(tcfg, epochs=epochs),
                          run_dir=path)
        lrs[tag] = []
        ran = epochs - (MASKED_EPOCHS - 1 if resume else 0)
        with mock.patch.object(trainer_mod, "make_epoch_runner", recording(tag)):
            result, counts = _fit_counted(f"maven masked {tag}", trainer, train_ds, val_ds,
                                          _fit_want(per_step, ran, train_steps, eval_steps),
                                          config_dump=dump, resume=resume)
        total = tuple(a + c for a, c in zip(total, counts))
        if set(result["metric_rows"][-1]) != {"epoch", "train_loss", "step_time_s",
                                              "samples_per_s", "val_loss"}:
            raise AssertionError(f"maven masked {tag}: metrics {result['metric_rows'][-1]}")
        fits[tag] = result
    spe = train_steps
    staircase = [tcfg.lr * tcfg.gamma ** ((e * spe) // (tcfg.step_size * spe))
                 for e in range(MASKED_EPOCHS)]
    log(f"maven masked: lr at the start of each epoch ({spe} steps an epoch, StepLR "
        f"step_size {tcfg.step_size} epochs, gamma {tcfg.gamma}): M {lrs['M']}, R "
        f"{lrs['R']} then resumed {lrs['R resumed']}; optax's staircase {staircase}")
    if (not np.allclose(lrs["M"], staircase, rtol=1e-12, atol=0)
            or lrs["R"] + lrs["R resumed"] != lrs["M"]):
        raise AssertionError(f"maven masked: lr {lrs} against the staircase {staircase}")
    a, r = fits["M"], fits["R resumed"]
    sd_a, sd_r = a["state"].model.state_dict(), r["state"].model.state_dict()
    n_equal = sum(torch.equal(sd_r[k], v) for k, v in sd_a.items())
    same_rows = all(ra[k] == rr[k] for ra, rr in zip(a["metric_rows"], r["metric_rows"])
                    for k in ("train_loss", "val_loss"))
    log(f"maven masked resume: R's resumed epoch {MASKED_EPOCHS - 1} against M: "
        f"{n_equal} of {len(sd_a)} state_dict tensors bitwise equal, losses of every epoch "
        f"equal {same_rows}, global steps {r['state'].step} and {a['state'].step}")
    if n_equal != len(sd_a) or not same_rows or r["state"].step != a["state"].step:
        raise AssertionError("maven masked: the resumed run is not bitwise the straight one")
    del fits["R resumed"], r, sd_r

    # load_model(M) and the anomaly score against the in-memory model
    in_memory = a["state"].model.eval()
    loaded, extra_m = load_model(m_dir, DEVICE, which="last")
    steps_mse = -(-len(val_ds) // min(b, len(val_ds)))
    scores = {}
    with _plain_calls() as plain:
        _zero_counts()
        for name, m in (("load_model", loaded), ("in memory", in_memory)):
            scores[name] = masked_reconstruction_mse(
                m, val_ds, torch.Generator(device=DEVICE).manual_seed(5), batch_size=b,
                device=DEVICE)
        mse_counts = _counts()
    err = float(np.abs(scores["load_model"] - scores["in memory"]).max())
    want_mse = _tf32_flash(2 * depth * steps_mse, 0)
    log(f"maven masked: load_model(M) {type(loaded).__name__} (extra {extra_m}); "
        f"masked_reconstruction_mse of the {len(val_ds)} validation samples, mean "
        f"{scores['in memory'].mean():.6g}, max|loaded - in memory| {err:.3e} (tol "
        f"{MSE_TOL}); launches {mse_counts}, {len(plain)} plain calls")
    if (err > MSE_TOL or plain or mse_counts != want_mse
            or scores["load_model"].shape != (len(val_ds),)
            or not np.isfinite(scores["load_model"]).all()):
        raise AssertionError(f"maven masked: reconstruction scores off by {err}, launches "
                             f"{mse_counts} (want {want_mse})")
    total = tuple(x + y for x, y in zip(total, mse_counts))
    del a, fits, in_memory, loaded

    # the kernel path against the plain path: trajectory and gradients
    data = train_ds.to_device(DEVICE)
    plan = epoch_indices(len(train_ds), b, rng=np.random.default_rng(1), shuffle=True,
                         pad="wrap")[:MAVEN_TRAJ_STEPS]

    def make():
        return builder(point, extra, NBAND)[0].to(DEVICE)

    traj = _maven_trajectory("maven masked", make, tcfg, data, plan, per_step)
    one = take(data, torch.from_numpy(plan[0]).to(DEVICE))
    grads = _towers_grads("maven masked", None, one, per_step, make=make)
    timed, ms, dev_ms = _maven_timing("maven masked", make(), tcfg, one, per_step, card)
    total = tuple(sum(c) for c in zip(total, traj, grads, timed))
    return total, m_dir, (point, extra), (train_ds, val_ds), (ms, dev_ms)


def _maven_graft(card, m_dir, grid, data):
    """Stage (b): config_grid.yaml's regression point with pretrain_lc_path =
    M's monitored best and freeze_backbone_lc, through _build_run."""
    point, extra = grid
    train_ds, val_ds = data
    best = best_ckpt_path(m_dir)
    run_extra = dict(extra, pretrain_lc_path=best, freeze_backbone_lc=True)
    model, task, freeze, override, tcfg = _build_run(point, run_extra, NBAND, None,
                                                     GRAFT_EPOCHS)
    log(f"maven graft: {GRID}, first grid point, overrides pretrain_lc_path {best} (M's "
        f"monitored best; the smallest kept epoch is "
        f"{os.path.basename(pick_reference_ckpt(m_dir))}), freeze_backbone_lc true; cuts: "
        f"epochs {point['epochs']} -> {GRAFT_EPOCHS}; task {task}; trainer {tcfg}")
    if task != "regression" or freeze is None or override is None:
        raise AssertionError(f"maven graft: task {task}, freeze {freeze}, override {override}")
    masked_sd = torch.load(best, map_location="cpu", weights_only=True)["state_dict"]
    model.load_state_dict(override(model.state_dict()), strict=True)
    grafted = {k: v.clone() for k, v in model.state_dict().items()}
    frozen = sorted(k for k in grafted if k.startswith("lightcurve_encoder.")
                    and ".projection." not in k)
    _unchanged("maven graft: lightcurve_encoder.* but projection against M's net.*",
               {k: masked_sd["net." + k[len("lightcurve_encoder."):]] for k in frozen},
               grafted, frozen)
    depth = model.cfg.tk()["depth"]
    per_step = _tf32_flash(depth, depth)  # the frozen tower still runs its backward
    b = tcfg.batch_size
    train_steps, eval_steps = -(-len(train_ds) // b), -(-len(val_ds) // b)
    model = model.to(DEVICE)
    trainer = Trainer(model, task, tcfg, freeze=freeze)
    result, counts = _fit_counted("maven graft", trainer, train_ds, val_ds,
                                  _fit_want(per_step, GRAFT_EPOCHS, train_steps, eval_steps))
    sd = model.state_dict()
    _unchanged("maven graft after training: the frozen tower", grafted, sd, frozen)
    trained = [k for k in sd if k.startswith(("lightcurve_encoder.projection.",
                                              "lightcurve_projection.", "linear."))]
    still = [k for k in trained if torch.equal(grafted[k].to(DEVICE), sd[k])]
    r2 = result["metric_rows"][-1]["R2_val"]
    log(f"maven graft: {len(trained) - len(still)} of {len(trained)} projection and head "
        f"tensors moved; R2_val {r2:.6g}")
    if still or not np.isfinite(r2):
        raise AssertionError(f"maven graft: {still} did not move; R2_val {r2}")
    one = take(train_ds.to_device(DEVICE), torch.arange(b, device=DEVICE))
    timed, ms, dev_ms = _maven_timing("maven graft", model, tcfg, one, per_step, card,
                                      freeze=freeze)
    return tuple(a + c for a, c in zip(counts, timed)), (ms, dev_ms)


def _maven_pretrain_point(tag, epochs):
    """maven_pretrain.yaml's first grid point built as run_sweep builds it
    (epochs cut to ``epochs``), held to MAVEN_STATED. Returns the sweep, the
    point, the model, its task and its trainer config."""
    sweep = load_sweep(MAVEN_PRETRAIN)
    point, extra = next(expand_grid(sweep)), sweep.extra_args
    model, task, freeze, override, tcfg = _build_run(point, extra, NBAND, None, epochs)
    cfg, tk, tsk = model.cfg, model.cfg.tk(), model.cfg.tsk()
    stated = ((tk["emb"], tk["heads"], tk["depth"], tk["agg"]),
              (tsk["emb"], tsk["heads"], tsk["depth"], tsk["agg"]), cfg.enc_dim,
              cfg.combinations, cfg.compute_dtype, tcfg.batch_size,
              int(extra["max_spectral_data_len"]), (task, freeze, override))
    log(f"{tag}: {MAVEN_PRETRAIN}, first of {sweep.n_points} grid points; LC {tk}; SP {tsk}; "
        f"enc_dim {cfg.enc_dim}; trainer {tcfg}")
    if stated != MAVEN_STATED:
        raise AssertionError(f"{tag}: {MAVEN_PRETRAIN} gives {stated}")
    return sweep, point, model, task, tcfg


def _maven_pretrain(card, tmp):
    """Stage (c): Maven pretraining from maven_pretrain.yaml's first point
    into run dir P."""
    sweep, point, model, task, tcfg = _maven_pretrain_point("maven pretrain", MAVEN_EPOCHS)
    extra, cfg = sweep.extra_args, model.cfg
    tk, tsk = cfg.tk(), cfg.tsk()
    sp_len = int(extra["max_spectral_data_len"])
    log(f"maven pretrain: cuts: epochs {point['epochs']} -> {MAVEN_EPOCHS}, the synthetic set "
        f"({MAVEN_N} samples, 2 x {LC_LEN} light-curve points, T_sp = {sp_len}) for "
        f"{extra['filename_trainset']}, nruns {extra['nruns']}")
    train_ds, val_ds = _maven_split(MAVEN_N, sp_len, cfg.combinations, extra["val_fraction"])
    b = tcfg.batch_size
    train_steps, eval_steps = -(-len(train_ds) // b), -(-len(val_ds) // b)
    layers = tk["depth"] + tsk["depth"]
    per_step = _tf32_flash(layers, layers)
    p_dir = os.path.join(tmp, "P")
    trainer = Trainer(model.to(DEVICE), task, tcfg, run_dir=p_dir)
    result, counts = _fit_counted("maven pretrain", trainer, train_ds, val_ds,
                                  _fit_want(per_step, MAVEN_EPOCHS, train_steps, eval_steps),
                                  config_dump=dict(point, epochs=MAVEN_EPOCHS))
    if not all(np.isfinite(r["AUC_val"]) for r in result["metric_rows"]):
        raise AssertionError(f"maven pretrain: {result['metric_rows']}")
    one = take(train_ds.to_device(DEVICE), torch.arange(b, device=DEVICE))
    timed, ms, dev_ms = _maven_timing("maven pretrain", model, tcfg, one, per_step, card)
    del result, trainer, model
    return tuple(a + c for a, c in zip(counts, timed)), p_dir, (ms, dev_ms)


def _maven_finetune(card, tmp, p_dir):
    """Stage (d): maven_finetune.yaml's first point from run dir P, once
    contrastive and once as a 5-class ClipMLPHead with freeze_backbone."""
    sweep = load_sweep(MAVEN_FINETUNE)
    point, extra = next(expand_grid(sweep)), sweep.extra_args
    fextra = dict(extra, pretrain_path=p_dir)
    best = best_ckpt_path(p_dir)
    best_sd = torch.load(best, map_location="cpu", weights_only=True)["state_dict"]
    sp_len = int(extra["max_spectral_data_len"])
    train_ds, val_ds = _maven_split(FINETUNE_N, sp_len, ("lightcurve", "spectral"),
                                    extra["val_fraction"])
    total, times = NONE, {}

    # contrastive
    builder = finetune_model_builder(fextra)
    model, task, freeze, override, tcfg = _build_run(point, fextra, NBAND, builder,
                                                     MAVEN_EPOCHS)
    layers = model.cfg.tk()["depth"] + model.cfg.tsk()["depth"]
    per_step = _tf32_flash(layers, layers)
    log(f"maven finetune: {MAVEN_FINETUNE}, first of {sweep.n_points} grid points "
        f"(foldnumber {point['foldnumber']}), pretrain_path P (monitored best "
        f"{os.path.basename(best)}); cuts: epochs {point['epochs']} -> {MAVEN_EPOCHS}, the "
        f"{FINETUNE_N}-sample synthetic set at val_fraction {extra['val_fraction']} for the "
        f"{extra['kfolds']}-fold split of ZTF BTS, nruns {extra['nruns']} -> 1; task {task}; "
        f"the architecture of P's sidecar {model.cfg.tk()} / {model.cfg.tsk()}; trainer "
        f"{tcfg}")
    if (task, freeze, tcfg.batch_size) != FINETUNE_STATED:
        raise AssertionError(f"maven finetune: task {task}, freeze {freeze}, B "
                             f"{tcfg.batch_size}")
    model.load_state_dict(override(model.state_dict()), strict=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    _unchanged("maven finetune: initial weights against P's best", best_sd, start,
               sorted(start))
    b = tcfg.batch_size
    train_steps, eval_steps = -(-len(train_ds) // b), -(-len(val_ds) // b)
    trainer = Trainer(model.to(DEVICE), task, tcfg, run_dir=os.path.join(tmp, "F"))
    result, counts = _fit_counted("maven finetune", trainer, train_ds, val_ds,
                                  _fit_want(per_step, MAVEN_EPOCHS, train_steps, eval_steps),
                                  config_dump=dict(point, epochs=MAVEN_EPOCHS))
    total = tuple(a + c for a, c in zip(total, counts))
    if not all(np.isfinite(r["AUC_val"]) for r in result["metric_rows"]):
        raise AssertionError(f"maven finetune: {result['metric_rows']}")
    del result, trainer

    def make():
        fresh = builder(point, fextra, NBAND)[0]
        fresh.load_state_dict(start, strict=True)
        return fresh.to(DEVICE)

    data = train_ds.to_device(DEVICE)
    plan = epoch_indices(len(train_ds), b, rng=np.random.default_rng(1), shuffle=True,
                         pad="wrap")[:MAVEN_TRAJ_STEPS]
    traj = _maven_trajectory("maven finetune", make, tcfg, data, plan, per_step)
    one = take(data, torch.from_numpy(plan[0]).to(DEVICE))
    timed, times["contrastive"], dev = _maven_timing("maven finetune", model, tcfg, one,
                                                     per_step, card)
    times["contrastive device"] = dev
    total = tuple(sum(c) for c in zip(total, traj, timed))
    del model

    # a 5-class ClipMLPHead on the frozen encoders
    cextra = dict(fextra, classification=True, freeze_backbone=True)
    head, task, freeze, override, tcfg = _build_run(point, cextra, NBAND,
                                                    finetune_model_builder(cextra),
                                                    HEAD_EPOCHS)
    log(f"maven head: the same point with classification and freeze_backbone: "
        f"{type(head).__name__} {head.cfg.combinations}, hidden {head.cfg.hidden_dim} x "
        f"{head.cfg.num_layers}, dropout {head.cfg.dropout}, {head.cfg.head_out} classes; "
        f"task {task}; epochs {point['epochs']} -> {HEAD_EPOCHS}")
    if not isinstance(head, ClipMLPHead) or task != "classification" or freeze is None:
        raise AssertionError(f"maven head: {type(head).__name__}, {task}, {freeze}")
    head.load_state_dict(override(head.state_dict()), strict=True)
    before = {k: v.clone() for k, v in head.state_dict().items()}
    _unchanged("maven head: clip_model.* against P's best",
               {k: best_sd[k[len("clip_model."):]] for k in before
                if k.startswith("clip_model.")}, before,
               sorted(k for k in before if k.startswith("clip_model.")))
    frozen = sorted(k for k in before if k.startswith(
        ("clip_model.lightcurve_encoder.", "clip_model.spectral_encoder."))
        and ".projection." not in k)
    h_dir = os.path.join(tmp, "H")
    trainer = Trainer(head.to(DEVICE), task, tcfg, run_dir=h_dir, freeze=freeze)
    result, counts = _fit_counted("maven head", trainer, train_ds, val_ds,
                                  _fit_want(per_step, HEAD_EPOCHS, train_steps, eval_steps),
                                  config_dump=dict(point, epochs=HEAD_EPOCHS))
    total = tuple(a + c for a, c in zip(total, counts))
    _unchanged("maven head after training: the frozen encoders", before, head.state_dict(),
               frozen)
    loaded, _ = load_model(h_dir, DEVICE, which="last")
    with _plain_calls() as plain:
        _zero_counts()
        got = predict_supervised(loaded, val_ds, batch_size=b, device=DEVICE)
        want = predict_supervised(head, val_ds, batch_size=b, device=DEVICE)
        pred_counts = _counts()
    err = float(np.abs(got - want).max())
    f1 = result["metric_rows"][-1]["f1_val"]
    want_pred = _tf32_flash(2 * layers * eval_steps, 0)
    log(f"maven head: f1_val {f1:.6g}; predict_supervised of load_model(H) "
        f"({type(loaded).__name__}) {got.shape} against the in-memory head, max difference "
        f"{err:.3e} (tol {RUN_DIR_EMBED_TOL}); launches {pred_counts}, {len(plain)} plain")
    if (err > RUN_DIR_EMBED_TOL or got.shape != (len(val_ds), 5) or plain
            or pred_counts != want_pred or not np.isfinite(f1)):
        raise AssertionError(f"maven head: predictions off by {err}, launches {pred_counts} "
                             f"(want {want_pred})")
    total = tuple(a + c for a, c in zip(total, pred_counts))
    timed, times["head"], times["head device"] = _maven_timing(
        "maven head", head, tcfg, one, per_step, card, freeze=freeze)
    return tuple(a + c for a, c in zip(total, timed)), times


def phase_maven(card):
    """Masked pretraining, the graft, and Maven's two stages from the shipped
    configs on the card. Returns the launches of every counted call."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        masked, m_dir, grid, data, masked_ms = _maven_masked(card, tmp)
        torch.cuda.empty_cache()
        graft, graft_ms = _maven_graft(card, m_dir, grid, data)
        del data
        torch.cuda.empty_cache()
        pre, p_dir, pre_ms = _maven_pretrain(card, tmp)
        torch.cuda.empty_cache()
        fine, fine_ms = _maven_finetune(card, tmp, p_dir)
    total = tuple(sum(c) for c in zip(masked, graft, pre, fine))
    log(f"maven: train step host clock / device ms (float32): masked (a) "
        f"{masked_ms[0]:.3f} / {masked_ms[1]:.3f}, graft (b) {graft_ms[0]:.3f} / "
        f"{graft_ms[1]:.3f}, Maven pretrain (c) {pre_ms[0]:.3f} / {pre_ms[1]:.3f}, finetune "
        f"(d) {fine_ms['contrastive']:.3f} / {fine_ms['contrastive device']:.3f}, head (d) "
        f"{fine_ms['head']:.3f} / {fine_ms['head device']:.3f}; card {card}")
    log(f"maven: phase done in {time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


# phase sim: a simulated corpus written in h5py's default layout (write_sim_hdf5),
# ingested by the port's HDF5 reader and trained from through cli.pretrain_sim
# (Maven's first stage), cli.pretrain_masked --source sim and cli.infer --hdf5
SIM_CORPUS = 500_000  # Maven's simulated pairs (configs/maven_pretrain.yaml:1, ~0.5M)
SIM_SHAPE = (5, 4, 2500)  # types, models a type, pairs a model: 50,000 pairs
SIM_LC_POINTS, SIM_WAVELENGTHS = 220, 300  # both bands mixed; subsampled to 100 / 220
SIM_LEGACY_SHAPE, SIM_LEGACY_POINTS = (5, 4, 1000), 150  # TransientTable: 20,000 curves
SIM_INFER_SHAPE = (2, 2, 512)  # 2,048 pairs for cli.infer --hdf5
SIM_EPOCHS, SIM_TRAJ_STEPS = 1, 5


def _sim_corpus(shape, seed):
    """{group: {name: array}} of a Photometry/Spectroscopy corpus of ``shape``
    (types, models, pairs a model): SIM_LC_POINTS photometry points a pair in
    both filters (1 = g, 2 = R, drawn at random, so a band holds about 110
    and most exceed the 100 kept), SIM_WAVELENGTHS wavelengths a spectrum."""
    n_types, n_models, n = shape
    rng = np.random.default_rng(seed)
    groups, first = {}, 0
    for t in range(n_types):
        for m in range(n_models):
            tid = np.arange(first, first + n)
            first += n
            mag = 19 + 2 * rng.random((n, 1)) + 0.5 * rng.normal(size=(n, SIM_LC_POINTS))
            flux = 1 + 0.3 * rng.random((n, SIM_WAVELENGTHS))
            groups[f"Photometry/type{t}/model{m}"] = {
                "TID": tid, "z": 0.3 * rng.random(n),
                "mjd": 58000 + np.sort(300 * rng.random((n, SIM_LC_POINTS)), axis=1),
                "filter": rng.integers(1, 3, (n, SIM_LC_POINTS)),
                "mag_obs": mag + 0.05 * rng.normal(size=mag.shape), "mag_perfect": mag}
            groups[f"Spectroscopy/type{t}/model{m}"] = {
                "TID": tid,
                "wavelength": np.sort(3000 + 6500 * rng.random((n, SIM_WAVELENGTHS)), axis=1),
                "flux_obs": flux + 0.02 * rng.normal(size=flux.shape), "flux_perfect": flux}
    return groups


def _sim_legacy(shape, seed):
    """{group: {name: array}} of a legacy TransientTable corpus: MJD, mag_r and
    mag_g (about 10% of them the not-observed sentinel 99), mwebv."""
    n_types, n_models, n = shape
    rng = np.random.default_rng(seed)
    groups = {}
    for t in range(n_types):
        for m in range(n_models):
            g = {"MJD": 58000 + np.sort(200 * rng.random((n, SIM_LEGACY_POINTS)), axis=1),
                 "mwebv": 0.1 * rng.random(n)}
            for band in ("r", "g"):
                mag = 23 + rng.normal(size=(n, SIM_LEGACY_POINTS))
                mag[rng.random(mag.shape) < 0.1] = 99.0
                g[f"mag_{band}"] = mag
            groups[f"TransientTable/type{t}/model{m}"] = g
    return groups


def _sim_expected(groups, config):
    """What ingest_simulation must give for ``groups`` under ``config``,
    computed on the arrays themselves with the port's pack_ragged_rows: groups
    in name order, the R band then g, then the spectrum, one generator of
    seed 0."""
    rng = np.random.default_rng(0)
    noise, parts = config["noise"], {}
    for path in sorted(g for g in groups if g.startswith("Photometry/")):
        p, sp = groups[path], groups["Spectroscopy/" + path.split("/", 1)[1]]
        mjd, mag = p["mjd"], p["mag_obs" if noise else "mag_perfect"]
        lc = [pack_ragged_rows({"t": mjd, "x": mag}, p["filter"] == code, config["n_max_obs"],
                               rng, sort_by="t") for code in (2, 1)]
        packed, mask_sp = pack_ragged_rows(
            {"t": sp["wavelength"], "x": sp["flux_obs" if noise else "flux_perfect"]},
            np.ones(sp["wavelength"].shape, bool), config["n_max_obs_spec"], rng, sort_by="t")
        x_lc = np.concatenate([v["x"] for v, _ in lc], axis=1).astype(np.float32)
        x_sp = packed["x"].astype(np.float32)
        chunk = {"t_lc": np.concatenate([zero_time_origin_rows(v["t"], m) for v, m in lc],
                                        axis=1).astype(np.float32),
                 "x_lc": x_lc, "mask_lc": np.concatenate([m for _, m in lc], axis=1),
                 "err_lc": np.zeros_like(x_lc), "redshift": p["z"].astype(np.float32),
                 "t_sp": packed["t"].astype(np.float32), "x_sp": x_sp, "mask_sp": mask_sp,
                 "err_sp": np.zeros_like(x_sp), "label": np.zeros(len(mjd), np.int32)}
        for k, v in chunk.items():
            parts.setdefault(k, []).append(v)
    return {k: np.concatenate(v) for k, v in parts.items()}


def _bitwise(got, want):
    """The same fields, each of the same dtype and shape and bitwise equal."""
    return sorted(got) == sorted(want) and all(
        np.asarray(got[k]).dtype == v.dtype and np.asarray(got[k]).shape == v.shape
        and np.array_equal(np.asarray(got[k]).view(np.uint8), v.view(np.uint8))
        for k, v in want.items())


def phase_sim(card, tmp):
    """Maven's first stage from a simulated corpus: a 50,000-pair HDF5 written
    under ``tmp``, read by the port's reader, ingested (bitwise the packed
    arrays the writer was handed; the cache hit bitwise the miss), and
    trained from through cli.pretrain_sim into run dir ``tmp/S`` (launches
    counted, the first steps against the plain path, the step timed);
    cli.pretrain_masked --source sim on a legacy file and cli.infer --hdf5
    on run S. Returns the launches of every counted call."""
    t_phase = time.perf_counter()
    sweep, point, model, task, tcfg = _maven_pretrain_point("sim pretrain", SIM_EPOCHS)
    extra = sweep.extra_args
    layers = model.cfg.tk()["depth"] + model.cfg.tsk()["depth"]
    per_step, b = _tf32_flash(layers, layers), tcfg.batch_size
    del model
    sim_dir, cache_dir = os.path.join(tmp, "sim"), os.path.join(tmp, "sim-cache")
    analysis = os.path.join(tmp, "sim-analysis")
    os.makedirs(sim_dir)
    path = os.path.join(sim_dir, extra["filename_trainset"])

    # (a) the corpus
    n_pairs = int(np.prod(SIM_SHAPE))
    t0 = time.perf_counter()
    groups = _sim_corpus(SIM_SHAPE, seed=0)
    made = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_sim_hdf5(path, groups)
    wrote = time.perf_counter() - t0
    size = os.path.getsize(path)
    log(f"sim: {n_pairs} pairs ({SIM_SHAPE[0]} types x {SIM_SHAPE[1]} models x "
        f"{SIM_SHAPE[2]}; {SIM_LC_POINTS} photometry points, {SIM_WAVELENGTHS} wavelengths a "
        f"pair, float64) made in {made:.2f} s, written to {extra['filename_trainset']} "
        f"({size / 1e9:.3f} GB) in {wrote:.2f} s; cut: Maven's ~{SIM_CORPUS} pairs -> "
        f"{n_pairs} ({n_pairs / SIM_CORPUS:.3g} of it)")
    t0 = time.perf_counter()
    nbytes = 0
    with hdf5.File(path) as f:
        for top in ("Photometry", "Spectroscopy"):
            for t_type in f[top].keys():
                for m in f[top][t_type].keys():
                    nbytes += sum(f[top][t_type][m][k][...].nbytes for k in f[top][t_type][m])
    read_s = time.perf_counter() - t0
    log(f"sim: the reader: every dataset read, {nbytes / 1e9:.3f} GB in {read_s:.3f} s "
        f"({nbytes / read_s / 1e9:.3f} GB/s)")

    # (b) the ingest through the cache: a miss (checked against the arrays), then a hit
    config = cli_pretrain_sim.ingest_config(path, extra)
    times, sets, ingest_s = {}, {}, []

    def ingest():
        t0 = time.perf_counter()
        ds = ingest_simulation(**config)
        ingest_s.append(time.perf_counter() - t0)
        return ds

    for tag in ("miss", "hit"):
        t0 = time.perf_counter()
        sets[tag], hit = load_or_ingest(cache_dir, ingest, **config)
        times[tag] = time.perf_counter() - t0
        if hit != (tag == "hit"):
            raise AssertionError(f"sim: cache {tag} read hit={hit}")
    ds, miss = sets["hit"], sets["miss"]
    want = _sim_expected(groups, config)
    del groups
    packed_ok = _bitwise(miss.arrays, want)
    hit_ok = _bitwise(ds.arrays, miss.arrays) and ds.filenames == miss.filenames
    log(f"sim: load_or_ingest of pretrain_sim's config ({config}): miss {times['miss']:.3f} s "
        f"(ingest_simulation {ingest_s[0]:.3f} s), {n_pairs / times['miss']:.1f} pairs/s; hit "
        f"{times['hit']:.4f} s; {len(ds)} pairs, fields {sorted(ds.arrays)}; the miss bitwise "
        f"pack_ragged_rows of the written arrays: {packed_ok}; the hit bitwise the miss: "
        f"{hit_ok}; card {card}")
    if not packed_ok or not hit_ok or len(ds) != n_pairs:
        raise AssertionError("sim: the ingest differs from the packed arrays or the cache")
    del want, miss, sets

    # (c) cli.pretrain_sim: Maven's first stage into run dir S
    tr, va = random_split(len(ds), float(extra["val_fraction"]), int(point["seed"]))
    want = _fit_want(per_step, SIM_EPOCHS, -(-len(tr) // b), -(-len(va) // b))
    log(f"sim pretrain: cli.pretrain_sim {MAVEN_PRETRAIN}; cuts: epochs {point['epochs']} -> "
        f"{SIM_EPOCHS}, the corpus {SIM_CORPUS} -> {n_pairs} pairs; split {len(tr)} / "
        f"{len(va)} at val_fraction {extra['val_fraction']}")
    counts, wall, out = _cli_counted("sim pretrain", cli_pretrain_sim.main, [
        MAVEN_PRETRAIN, "--data-dir", sim_dir, "--cache-dir", cache_dir, "--analysis-path",
        analysis, "--device", DEVICE, "--epochs", str(SIM_EPOCHS)])
    s_dir = os.path.join(analysis, os.path.splitext(os.path.basename(MAVEN_PRETRAIN))[0],
                         "run-0")
    files, rows = set(os.listdir(s_dir)), _metric_rows(s_dir)
    manifests = {}
    for name in ("train_filenames.txt", "val_filenames.txt"):
        with open(os.path.join(s_dir, name)) as fh:
            manifests[name] = fh.read().splitlines()
    want_names = {"train_filenames.txt": [ds.filenames[i] for i in tr],
                  "val_filenames.txt": [ds.filenames[i] for i in va]}
    log(f"sim pretrain: run S files {sorted(files)}; manifests the random split's: "
        f"{manifests == want_names}; cache hit: {'cache=hit' in out}; " + "; ".join(
            f"epoch {r['epoch']} train_loss {r['train_loss']:.7f} val_loss {r['val_loss']:.7f} "
            f"step {r['step_time_s'] * 1e3:.3f} ms" for r in rows))
    if (counts != want or not set(RUN_DIR_FILES) <= files or manifests != want_names
            or "cache=hit" not in out or [r["epoch"] for r in rows] != [0]
            or not all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
                       for r in rows)):
        raise AssertionError(f"sim pretrain: launches {counts} (want {want}), files "
                             f"{sorted(files)}, rows {rows}")
    total = counts
    train = ds.subset(tr)
    data = train.to_device(DEVICE)
    plan = epoch_indices(len(train), b, rng=np.random.default_rng(tcfg.seed), shuffle=True,
                         pad="wrap")[:SIM_TRAJ_STEPS]

    def make():
        return _build_run(point, extra, NBAND, None, None)[0].to(DEVICE)

    traj = _maven_trajectory("sim pretrain", make, tcfg, data, plan, per_step)
    one = take(data, torch.from_numpy(plan[0]).to(DEVICE))
    timed, step_ms, dev_ms = _maven_timing("sim pretrain", make(), tcfg, one, per_step, card)
    total = tuple(sum(c) for c in zip(total, traj, timed))
    del data, one, train, ds
    shutil.rmtree(cache_dir)  # the corpus stays for phase stream, which deletes it
    torch.cuda.empty_cache()

    # (d) cli.pretrain_masked --source sim on a legacy TransientTable file
    grid_extra = load_sweep(GRID).extra_args
    legacy_dir = os.path.join(tmp, "simlc")
    os.makedirs(legacy_dir)
    write_sim_hdf5(os.path.join(legacy_dir, grid_extra.get("filename_trainset",
                                                           cli_common.SIM_FILE)),
                   _sim_legacy(SIM_LEGACY_SHAPE, seed=1))
    n_legacy = int(np.prod(SIM_LEGACY_SHAPE))
    counts, _, out = _cli_counted("sim masked", cli_masked.main, [
        GRID, "--source", "sim", "--data-dir", legacy_dir, "--cache-dir", cache_dir,
        "--analysis-path", analysis, "--device", DEVICE, "--epochs", "1", "--max-runs", "1"])
    masked_rows = _metric_rows(os.path.join(analysis, "config_grid-masked", "run-0"))
    log(f"sim masked: {GRID} --source sim on a TransientTable file of {n_legacy} light curves "
        f"({SIM_LEGACY_POINTS} points, about 10% sentinels); cuts: epochs 3000 -> 1, nruns 20 "
        f"-> 1: {masked_rows}")
    _tf32_only("sim masked", counts)
    if (f"dataset: {n_legacy} samples" not in out
            or not all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
                       for r in masked_rows)):
        raise AssertionError(f"sim masked: output {out!r}, rows {masked_rows}")
    total = tuple(a + c for a, c in zip(total, counts))
    shutil.rmtree(legacy_dir)

    # (e) cli.infer S --hdf5 against get_embeddings of the same model on the same set
    infer_path, npz = os.path.join(tmp, "infer.hdf5"), os.path.join(tmp, "sim-infer.npz")
    write_sim_hdf5(infer_path, _sim_corpus(SIM_INFER_SHAPE, seed=2))
    n_infer = int(np.prod(SIM_INFER_SHAPE))
    counts, _, _ = _cli_counted("sim infer", cli_infer.main, [
        s_dir, "--hdf5", infer_path, "--out", npz, "--device", DEVICE,
        "--batch-size", str(EVAL_B)])
    want = _tf32_flash(layers * -(-n_infer // EVAL_B), 0)
    infer_set = ingest_simulation(infer_path, bands=("r", "g"),
                                  n_max_obs=config["n_max_obs"],
                                  n_max_obs_spec=config["n_max_obs_spec"],
                                  combinations=config["combinations"])
    with _plain_calls() as plain:
        embs, names = get_embeddings(load_model(s_dir, DEVICE)[0], infer_set, EVAL_B, DEVICE)
    got = np.load(npz)
    same = all(np.array_equal(got[f"emb_{nm}"], e) for e, nm in zip(embs, names))
    log(f"sim infer: cli.infer S --hdf5 ({n_infer} pairs): "
        + ", ".join(f"emb_{nm} {got[f'emb_{nm}'].shape}" for nm in names)
        + f"; equal to get_embeddings of load_model(S): {same}; launches {counts} (want "
        f"{want}), {len(plain)} plain")
    if not same or counts != want or plain or len(got["filenames"]) != n_infer:
        raise AssertionError(f"sim infer: embeddings equal {same}, launches {counts}")
    total = tuple(a + c for a, c in zip(total, counts))
    shutil.copytree(s_dir, os.path.join(tmp, "S"))
    log(f"sim: Maven step (B={b}, float32, from the simulated corpus) host clock "
        f"{step_ms:.3f} ms, device {dev_ms:.3f} ms; launches per route {COUNT_NAMES}: "
        f"{total}; card {card}")
    log(f"sim: phase done in {time.perf_counter() - t_phase:.1f} s")
    return total


# phase stream: Maven's first stage from phase sim's corpus through
# cli.pretrain_sim --streaming: the corpus held out and cut into shards of
# STREAM_ROWS_PER_SHARD rows on disk, trained shard by shard, each shard's
# upload under the previous shard's steps
STREAM_ROWS_PER_SHARD = 10_240  # 10 steps of B = 1024: 4 full shards and a partial one
STREAM_CUT_AFTER = 2  # the cut run's cursor save raises after its third shard


def _stream_profile(run):
    """``run()`` under torch.profiler (device activity): (its result, the
    share of the pinned host-to-device copies' time that overlaps a kernel,
    the device idle share over the trace, the copies' count and ms)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    dev = _device_spans(prof)
    if not dev:
        raise AssertionError("stream profile: the trace holds no device op")
    uploads = [(a, b) for a, b, n in dev if "HtoD" in n and "Pinned" in n]
    kernels = sorted((a, b) for a, b, n in dev if "Memcpy" not in n and "Memset" not in n)

    def union(spans):
        merged = []
        for a, b in sorted(spans):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    busy_k = union(kernels)
    hidden = sum(max(0, min(b, kb) - max(a, ka)) for a, b in uploads for ka, kb in busy_k)
    up = sum(b - a for a, b in uploads)
    busy = sum(b - a for a, b in union((a, b) for a, b, _ in dev))
    wall = max(b for _, b, _ in dev) - min(a for a, _, _ in dev)
    return out, (hidden / up if up else None), 1 - busy / wall, len(uploads), up / 1e3


def _stream_fit(sds, val, point, extra, run_dir, prefetch=None, resume=False):
    """One epoch of fit_sharded of maven_pretrain's point (run_sweep_streaming's
    model, weights and trainer config) into ``run_dir``."""
    model, task, _, _, tcfg = _build_run(point, extra, NBAND, None, SIM_EPOCHS)
    trainer = Trainer(model.to(DEVICE), task, tcfg, run_dir=run_dir)
    return trainer.fit_sharded(sds, val, config_dump=dict(point), resume=resume,
                               prefetch=prefetch)


def phase_stream(card, tmp):
    """Maven's first stage trained from a sharded cache of phase sim's corpus
    (``tmp/sim``): cli.pretrain_sim --streaming (the cache written, one
    epoch, launches counted), the shards' rows bitwise the in-memory
    holdout's, the first steps against the plain path, a run cut after its
    third shard's cursor (profiled: the uploads' share hidden under kernels,
    the idle share) and resumed against the uninterrupted run, and the
    epoch with prefetch off. Leaves the corpus and the cache to phase
    stream-dp. Returns the launches of every counted call."""
    t_phase = time.perf_counter()
    sweep, point, model, task, tcfg = _maven_pretrain_point("stream", SIM_EPOCHS)
    extra, b = sweep.extra_args, tcfg.batch_size
    layers = model.cfg.tk()["depth"] + model.cfg.tsk()["depth"]
    per_step = _tf32_flash(layers, layers)
    del model
    sim_dir = os.path.join(tmp, "sim")
    path = os.path.join(sim_dir, extra["filename_trainset"])
    cache_dir, analysis = os.path.join(tmp, "stream-cache"), os.path.join(tmp, "stream-analysis")
    config = cli_pretrain_sim.ingest_config(path, extra)
    val_fraction = float(extra["val_fraction"])
    on_card = torch.device(DEVICE).type == "cuda"  # prefetch is the card's: a CPU run reads in turn

    # (a) cli.pretrain_sim --streaming: the cache written, then one epoch
    results = []
    real_runner = experiment_mod.run_sweep_streaming

    def kept(*args, **kw):
        results.extend(real_runner(*args, **kw))
        return results

    with mock.patch.object(experiment_mod, "run_sweep_streaming", kept):
        counts, wall, out = _cli_counted("stream pretrain", cli_pretrain_sim.main, [
            MAVEN_PRETRAIN, "--data-dir", sim_dir, "--cache-dir", cache_dir, "--analysis-path",
            analysis, "--device", DEVICE, "--epochs", str(SIM_EPOCHS), "--streaming",
            "--rows-per-shard", str(STREAM_ROWS_PER_SHARD)])
    (stream_dir,) = [os.path.join(cache_dir, d) for d in os.listdir(cache_dir)]
    sds, val = ShardedDataset(stream_dir), load_val_split(stream_dir)
    sizes, steps_full = sds.shard_sizes, -(-sds.shard_sizes[0] // b)
    n_steps, eval_steps = len(sizes) * steps_full, -(-len(val) // b)
    want = _fit_want(per_step, SIM_EPOCHS, n_steps, eval_steps)
    res = results[0]
    run_dir = res["run_dir"]
    files = set(os.listdir(run_dir))
    feed = res["shard_feed"]
    on_s = res["metric_rows"][0]["step_time_s"] * n_steps
    log(f"stream pretrain: {os.path.basename(stream_dir)}: {len(sds)} train rows in shards of "
        f"{sizes} ({feed['shard_bytes'] / 1e6:.1f} MB the first), {len(val)} validation rows "
        f"held out at {val_fraction}; {n_steps} train steps ({steps_full} a shard) + "
        f"{eval_steps} eval steps at B={b}; run files {sorted(files)}")
    if (len(sizes) < 5 or not sizes[-1] < STREAM_ROWS_PER_SHARD or counts != want
            or not set(RUN_DIR_FILES) <= files or "ckpt_cursor" not in files
            or feed["prefetch"] != on_card or not np.isfinite(res["history"]["val_loss"][0])):
        raise AssertionError(f"stream pretrain: shards {sizes}, launches {counts} (want "
                             f"{want}), files {sorted(files)}, prefetch {feed['prefetch']}")
    total = counts

    # (b) the shards and the held-out rows bitwise the in-memory holdout's
    t0 = time.perf_counter()
    holdout = ValHoldout(val_fraction, seed=0)
    parts = list(holdout.wrap(iter_simulation_chunks(**config)))
    in_memory = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    shards_ok = _bitwise(sds.materialize().arrays, in_memory)
    val_ok = _bitwise(val.arrays, holdout.dataset().arrays)
    log(f"stream cache: every shard's rows bitwise the in-memory holdout of "
        f"iter_simulation_chunks: {shards_ok}; the validation split: {val_ok} "
        f"({time.perf_counter() - t0:.2f} s)")
    if not shards_ok or not val_ok:
        raise AssertionError("stream cache: the shards differ from the in-memory holdout")
    del parts, in_memory, holdout

    # (c) the first steps of the epoch's first shard against the plain path
    si, plan = shard_epoch_schedule(sds, b, np.random.default_rng(tcfg.seed))[0]
    data = {k: torch.from_numpy(np.array(v)).to(DEVICE)
            for k, v in sds.load_shard(si).arrays.items()}

    def make():
        return _build_run(point, extra, NBAND, None, None)[0].to(DEVICE)

    counts = _maven_trajectory("stream", make, tcfg, data, plan[:SIM_TRAJ_STEPS], per_step)
    total = tuple(a + c for a, c in zip(total, counts))
    del data

    # (d) a run cut after its third shard's cursor, resumed, against (a)'s run
    real_save = ckpt_mod.StreamCursor.save

    def save_then_cut(self, state, epoch, shard_pos, *args, **kw):
        real_save(self, state, epoch, shard_pos, *args, **kw)
        if shard_pos == STREAM_CUT_AFTER:
            raise _Stop()

    def cut_run():
        try:
            with mock.patch.object(ckpt_mod.StreamCursor, "save", save_then_cut):
                _stream_fit(sds, val, point, extra, cut_dir)
        except _Stop:
            return True
        return False

    # the cut run under torch.profiler: its three shards, the first uploaded in
    # turn, the second, third and fourth prefetched
    cut_dir = os.path.join(tmp, "stream-cut", "run-0")
    with _plain_calls() as plain:
        _zero_counts()
        was_cut, hidden, idle, n_up, up_ms = _stream_profile(cut_run)
        if not was_cut:
            raise AssertionError("stream cut: the run was not cut")
        cut_counts = _counts()
        _zero_counts()
        resumed = _stream_fit(sds, val, point, extra, cut_dir, resume=True)
        counts = _counts()
    want_cut = tuple(c * (STREAM_CUT_AFTER + 1) * steps_full for c in per_step)
    if (plain or cut_counts != want_cut
            or tuple(a + c for a, c in zip(cut_counts, counts)) != want):
        raise AssertionError(f"stream cut: launches {cut_counts} then {counts} (want "
                             f"{want_cut}, together {want}), {len(plain)} plain")
    total = tuple(a + c + d for a, c, d in zip(total, cut_counts, counts))
    ref = torch.load(os.path.join(run_dir, "last.ckpt"), map_location="cpu",
                     weights_only=True)["state_dict"]
    got = torch.load(os.path.join(cut_dir, "last.ckpt"), map_location="cpu",
                     weights_only=True)["state_dict"]
    errs = {k: float((got[k].float() - v.float()).abs().max()) / max(
        float(v.float().abs().max()), 1e-30) for k, v in ref.items()}
    bitwise = sum(torch.equal(got[k], v) for k, v in ref.items())
    loss_rel = max(abs(a - w) / abs(w) for a, w in zip(
        resumed["history"]["train_loss"] + resumed["history"]["val_loss"],
        res["history"]["train_loss"] + res["history"]["val_loss"]))
    worst = max(errs, key=errs.get)
    log(f"stream cut: the run cut after shard {STREAM_CUT_AFTER} of {len(sizes)}, resumed from "
        f"its cursor: losses within {loss_rel:.3e} of the uninterrupted run's (tol "
        f"{RESUME_RTOL}), {bitwise} of {len(ref)} state_dict tensors bitwise, the worst "
        f"max|diff|/max|want| {errs[worst]:.3e} at {worst} (tol {RESUME_PARAM_TOL})")
    if loss_rel > RESUME_RTOL or errs[worst] > RESUME_PARAM_TOL:
        raise AssertionError(f"stream cut: the resumed run leaves the uninterrupted one: "
                             f"{loss_rel:.3e}, {errs[worst]:.3e}")
    shutil.rmtree(os.path.dirname(cut_dir))

    log(f"stream profile: the cut run ({STREAM_CUT_AFTER + 1} shards, prefetch on, from "
        f"its model's build to the cut) under torch.profiler (device activity): {n_up} "
        f"pinned copies, {up_ms:.3f} ms, {100 * hidden:.1f}% of their time under kernels; "
        f"device idle share {idle:.3f}")

    # (e) the epoch with prefetch off (the CLI's run had it on)
    run = os.path.join(tmp, "stream-off", "run-0")
    save_ms = []

    def timed_save(self, *args, **kw):
        t0 = time.perf_counter()
        real_save(self, *args, **kw)
        save_ms.append((time.perf_counter() - t0) * 1e3)

    with _plain_calls() as plain, mock.patch.object(ckpt_mod.StreamCursor, "save", timed_save):
        _zero_counts()
        off = _stream_fit(sds, val, point, extra, run, prefetch=False)
        counts = _counts()
    if plain or counts != want or off["shard_feed"]["prefetch"]:
        raise AssertionError(f"stream off: launches {counts}, {len(plain)} plain")
    total = tuple(a + c for a, c in zip(total, counts))
    shutil.rmtree(os.path.dirname(run))
    for tag, f, s_ms in (("on (the CLI's run)", feed, None), ("off", off["shard_feed"],
                                                             save_ms)):
        log(f"stream prefetch {tag}: epoch "
            f"{(on_s if f is feed else off['metric_rows'][0]['step_time_s'] * n_steps):.3f} s "
            f"by the host clock ({n_steps} steps, B={b}); uploads "
            f"{[round(u, 3) for u in f['upload_ms']]} ms on the side stream, staging "
            f"{[round(s, 2) for s in f['stage_ms']]} ms, the trainer's wait for each shard "
            f"{[round(w, 2) for w in f['wait_ms']]} ms on the host"
            + ("" if s_ms is None else
               f", each cursor save {[round(c, 2) for c in s_ms]} ms") + f"; card {card}")
    torch.cuda.empty_cache()  # the cache and the corpus stay for phase stream-dp
    log(f"stream: launches {COUNT_NAMES} {total}; phase done in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total


# phase stream-dp: Trainer.fit_sharded over two gloo ranks sharing the card
STREAM_DP_ROWS = 4096     # rows a shard of the phase's cache: 4 steps of B = 1024
STREAM_DP_TRAIN = 11_264  # phase stream's first training rows: shards of 4096, 4096, 3072
STREAM_DP_VAL = 2048      # phase stream's first validation rows
STREAM_DP_EPOCHS = 2      # the uninterrupted runs; the cut one stops after the first
# the jobs of DP_GROUPS' "stream" group, run in this order on each rank: job: (run dir,
# epochs, resume)
STREAM_DP_JOBS = {"stream-A": ("A-mesh", STREAM_DP_EPOCHS, False),
                  "stream-B-first": ("B-mesh", 1, False),
                  "stream-B": ("B-mesh", STREAM_DP_EPOCHS, True)}


def _stream_dp_cache(tmp):
    """The phase's sharded cache in ``tmp/stream-dp/cache``: phase stream's
    first STREAM_DP_TRAIN training rows in shards of STREAM_DP_ROWS and its
    first STREAM_DP_VAL validation rows (the widths, the batch and the
    model are Maven pretraining's; the rows and shards are cut)."""
    (src,) = [os.path.join(tmp, "stream-cache", d) for d in
              os.listdir(os.path.join(tmp, "stream-cache"))]
    sds, val = ShardedDataset(src), load_val_split(src)
    parts, rows = [], 0
    for i in range(sds.n_shards):
        parts.append(sds.load_shard(i, mmap=False).arrays)
        rows += sds.shard_sizes[i]
        if rows >= STREAM_DP_TRAIN:
            break
    chunk = {k: np.concatenate([p[k] for p in parts])[:STREAM_DP_TRAIN] for k in parts[0]}
    out = os.path.join(tmp, "stream-dp", "cache")
    cut = write_sharded_cache(out, iter([chunk]), STREAM_DP_ROWS)
    save_val_split(out, val.subset(np.arange(STREAM_DP_VAL)))
    return cut.shard_sizes


def _stream_dp_fit(tmp, run, mesh=None, epochs=STREAM_DP_EPOCHS, resume=False):
    """fit_sharded of maven_pretrain's first point (run_sweep_streaming's
    model, weights and trainer config, epochs cut to ``epochs``) over the
    phase's cache into ``tmp/stream-dp/<run>``, counted, on a rank of
    ``mesh`` or (None) in this process. Returns what ``_dp_compare`` reads,
    the run's files and the steps' host clock."""
    d = os.path.join(tmp, "stream-dp")
    sweep = load_sweep(MAVEN_PRETRAIN)
    point, extra = next(expand_grid(sweep)), sweep.extra_args
    model, task, _, _, tcfg = _build_run(point, extra, NBAND, None, epochs)
    layers = model.cfg.tk()["depth"] + model.cfg.tsk()["depth"]
    sds, val = ShardedDataset(os.path.join(d, "cache")), load_val_split(os.path.join(d, "cache"))
    run_dir = os.path.join(d, run)
    trainer = Trainer(model.to(DEVICE), task, tcfg, run_dir=run_dir, mesh=mesh)
    with _plain_calls() as plain:
        _zero_counts()
        res = trainer.fit_sharded(sds, val, config_dump=dict(point), resume=resume)
        torch.cuda.synchronize()
        counts = _counts()
    b = tcfg.batch_size
    return {"history": res["history"], "rows": res["metric_rows"],
            "state_dict": {k: v.detach().to("cpu", copy=True)
                           for k, v in gather_state_dict(res["state"].model).items()},
            "counts": counts, "plain": len(plain), "per_step": _tf32_flash(layers, layers),
            "epochs": epochs - (1 if resume else 0), "batch": b,
            "steps": (sds.n_shards * -(-sds.shard_sizes[0] // b), -(-len(val) // b)),
            "step_ms": [r["step_time_s"] * 1e3 for r in res["metric_rows"]],
            "files": sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else []}


def phase_stream_dp(card, tmp):
    """Maven pretraining (configs/maven_pretrain.yaml, B = 1024 global)
    streamed by Trainer.fit_sharded over two gloo ranks sharing cuda:0 (B =
    512 each), from a cut of phase stream's cache, against the one-process
    fit_sharded on the same shards (phase dp's tolerances), and a run cut
    at its first epoch's end and resumed under the mesh from last.ckpt
    against the uninterrupted mesh run; rank 0 alone writes, and no shard
    cursor is kept over several processes. Deletes phase sim's corpus and
    phase stream's cache. Returns the launches of the one-process run and
    of one rank."""
    t_phase = time.perf_counter()
    d = os.path.join(tmp, "stream-dp")
    os.makedirs(d)
    os.makedirs(os.path.join(tmp, "dp"), exist_ok=True)  # the group's store and results
    sizes = _stream_dp_cache(tmp)
    shutil.rmtree(os.path.join(tmp, "stream-cache"))
    shutil.rmtree(os.path.join(tmp, "sim"))
    _, mesh_shape, jobs = DP_GROUPS["stream"]
    n_ranks = int(np.prod(mesh_shape))
    run = {"clis": {}, "ranks": [], "procs": [], "logs": []}
    try:
        run["ranks"], run["procs"], run["logs"] = _dp_start(tmp, ["stream"])
        t_ranks = time.perf_counter()
        try:
            ref = _stream_dp_fit(tmp, "A-one")  # while the ranks start
        finally:
            open(os.path.join(tmp, "dp", "stream-dp-refs-done"), "w").close()
        _dp_wait(tmp, run, "stream-dp")
    finally:
        _dp_stop(run)
    log(f"stream-dp: {len(sizes)} shards of {sizes} rows, {STREAM_DP_VAL} validation rows, "
        f"B={ref['batch']}; two gloo ranks on cuda:0 ran A ({STREAM_DP_EPOCHS} epochs) and B "
        f"(1, then resumed) in {time.perf_counter() - t_ranks:.1f} s (start-up included)")
    ranks = [{job: torch.load(os.path.join(tmp, "dp", f"stream-{job}-{r}.pt"),
                              weights_only=False) for job in jobs} for r in range(n_ranks)]
    ref_files, files = set(ref["files"]), set(ranks[0]["stream-A"]["files"])
    for r, got in enumerate(ranks):
        _dp_compare("maven-pretrain-stream", ref, got["stream-A"], r, "stream-dp",
                    DP_LOSS_TOL, DP_PARAM_TOL)
        full, resumed = got["stream-A"], got["stream-B"]
        a = full["history"]["train_loss"] + full["history"]["val_loss"]
        w = resumed["history"]["train_loss"] + resumed["history"]["val_loss"]
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(w, a))
        errs = {k: float((resumed["state_dict"][k].double() - v.double()).abs().max())
                / max(float(v.double().abs().max()), 1e-30)
                for k, v in full["state_dict"].items() if v.is_floating_point()}
        worst = max(errs, key=errs.get)
        bitwise = sum(torch.equal(resumed["state_dict"][k], v)
                      for k, v in full["state_dict"].items())
        want_b = _fit_want(resumed["per_step"], 1, *resumed["steps"])
        log(f"stream-dp resume rank {r}: B cut after epoch 0 and resumed from last.ckpt under "
            f"the mesh: losses within {loss_rel:.3e} of A's (tol {RESUME_RTOL}), {bitwise} of "
            f"{len(full['state_dict'])} state_dict tensors bitwise, the worst "
            f"max|diff|/max|want| {errs[worst]:.3e} at {worst} (tol {RESUME_PARAM_TOL}); the "
            f"resumed epoch's launches {resumed['counts']} (want {want_b})")
        if (len(w) != len(a) or loss_rel > RESUME_RTOL or errs[worst] > RESUME_PARAM_TOL
                or resumed["counts"] != want_b or resumed["plain"]):
            raise AssertionError(f"stream-dp resume rank {r}: {loss_rel:.3e}, "
                                 f"{errs[worst]:.3e}, launches {resumed['counts']}")
    log(f"stream-dp: run files, one process {sorted(ref_files)}; the mesh's {sorted(files)}")
    if "ckpt_cursor" not in ref_files or "ckpt_cursor" in files or not set(
            RUN_DIR_FILES) - {"val_filenames.txt"} <= files:
        raise AssertionError("stream-dp: a cursor over several processes, or run files "
                             "missing")
    rank_ms = [float(np.mean(g["stream-A"]["step_ms"])) for g in ranks]
    log(f"stream-dp: a step (host clock, the epochs' means, evaluation left out): one process "
        f"at B={ref['batch']} {[round(x, 3) for x in ref['step_ms']]} ms; the ranks at "
        f"B={ref['batch'] // n_ranks} each, sharing the card, "
        f"{[[round(x, 3) for x in g['stream-A']['step_ms']] for g in ranks]} ms (means "
        f"{[round(x, 3) for x in rank_ms]}); card {card}")
    total = tuple(sum(c) for c in zip(ref["counts"], *(ranks[0][j]["counts"] for j in jobs)))
    shutil.rmtree(d)
    for f in os.listdir(os.path.join(tmp, "dp")):  # the group's store, logs and results
        os.remove(os.path.join(tmp, "dp", f))
    torch.cuda.empty_cache()
    log(f"stream-dp: launches {COUNT_NAMES} {total}; phase done in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total


# phase ingest: a ZTF BTS tree in the corpus's layout, written here, ingested
# by the port's reader and trained from through the port's CLIs
INGEST_N = 4702  # the corpus's candidates (SURVEY.md section 0; its data/AAA_README.txt:2)
INGEST_EPOCHS, INGEST_RUNS, INGEST_TRAJ_STEPS, INGEST_TIMED = 2, 2, 5, 6
INGEST_IMAGE = 60  # the side phase towers uses
# the reference's type strings (its merges included) at rough BTS shares; the
# last five fall outside the 5-way classes and are dropped
INGEST_TYPES = (("SN Ia", 0.70), ("SN II", 0.10), ("SN IIP", 0.03), ("SN Ib", 0.015),
                ("SN Ic", 0.015), ("SN Ib/c", 0.01), ("SN IIn", 0.03), ("SLSN-I", 0.02),
                ("SN Ia-91T", 0.02), ("SN IIb", 0.02), ("TDE", 0.02), ("SLSN-II", 0.01),
                ("CV", 0.01))
INGEST_UNFILTER_SAMPLE = 25  # images decoded by both unfilters for their times
# configs/smoke.yaml (emb 8, 2 heads: head dim 4, the CUDA-core flash kernels
# both ways) trained on the tree through cli.train, its 3 epochs cut to 1
SMOKE, SMOKE_EPOCHS = "configs/smoke.yaml", 1
_PNG_COLOUR = {1: 0, 2: 4, 3: 2, 4: 6}  # samples a pixel -> colour type


def _png_chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def write_png(path, pixels, filters=(0,), palette=None, interlace=0):
    """Write ``pixels`` as an 8-bit PNG with numpy and zlib: (H, W) grey,
    (H, W, 2) grey and alpha, (H, W, 3) RGB, (H, W, 4) RGBA, or, with
    ``palette`` ((n, 3) uint8), (H, W) palette indices. Row r is filtered
    with ``filters[r % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth). ``interlace`` is written into the header only (a file a
    decoder must refuse)."""
    x = np.asarray(pixels, dtype=np.uint8)
    x = x[..., None] if x.ndim == 2 else x
    h, w, bpp = x.shape
    colour = 3 if palette is not None else _PNG_COLOUR[bpp]
    raw = x.reshape(h, w * bpp).astype(np.int32)
    a, b, c = np.zeros_like(raw), np.zeros_like(raw), np.zeros_like(raw)
    a[:, bpp:], b[1:], c[1:, bpp:] = raw[:, :-bpp], raw[:-1], raw[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(raw), a, b, (a + b) >> 1, paeth])
    ftype = np.resize(np.asarray(filters, dtype=np.uint8), h)
    filt = ((raw - preds[ftype, np.arange(h)]) & 255).astype(np.uint8)
    data = np.concatenate([ftype[:, None], filt], axis=1).tobytes()
    body = (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, interlace))
            + (b"" if palette is None else _png_chunk(b"PLTE", np.asarray(
                palette, dtype=np.uint8).tobytes()))
            + _png_chunk(b"IDAT", zlib.compress(data, 6)) + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(body)


_H5_UNDEF = b"\xff" * 8  # an undefined address
_H5_LEAF_K, _H5_NODE_K = 4, 16  # symbol table node and group B-tree widths (h5py's)


def _h5_put(f, blob):
    """Write ``blob`` at the next 8-byte boundary; returns its address."""
    f.write(b"\0" * (-f.tell() % 8))
    at = f.tell()
    f.write(blob)
    return at


def _h5_header(msgs):
    """A version-1 object header of ``msgs``, (type, flags, body) each."""
    blob = b"".join(struct.pack("<HHB3x", t, len(b) + -len(b) % 8, fl) + b + b"\0" * (-len(b) % 8)
                    for t, fl, b in msgs)
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(blob)) + blob


def _h5_dtype(dt):
    """The datatype message of a little-endian integer or IEEE float."""
    n = dt.itemsize
    if dt.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, 0x08 if dt.kind == "i" else 0, 0, 0, n, 0, 8 * n)
    exp, mant, bias = {4: (8, 23, 127), 8: (11, 52, 1023)}[n]
    return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 8 * n - 1, 0, n, 0, 8 * n, mant, exp, 0,
                       mant, bias)


def _h5_dataset(f, arr):
    """The array's data, then its header: dataspace (the dims as the maximum),
    datatype, fill value (the default) and a contiguous layout."""
    arr = np.asarray(arr)
    arr = np.asarray(arr, dtype=arr.dtype.newbyteorder("<"), order="C")
    if arr.dtype.kind not in "iuf" or arr.size == 0:
        raise ValueError(f"write_sim_hdf5 writes non-empty numbers, not {arr.dtype} {arr.shape}")
    f.write(b"\0" * (-f.tell() % 8))
    data = f.tell()
    f.write(memoryview(arr).cast("B"))
    dims = struct.pack(f"<{arr.ndim}Q", *arr.shape)
    return _h5_put(f, _h5_header([
        (0x01, 0, struct.pack("<BBB5x", 1, arr.ndim, 1) + dims + dims),
        (0x03, 1, _h5_dtype(arr.dtype)),
        (0x05, 1, bytes([2, 2, 2, 1, 0, 0, 0, 0])),
        (0x08, 0, struct.pack("<BBQQ", 3, 1, data, arr.nbytes))]))


def _h5_group(f, tree):
    """The members of ``tree`` (sub-trees and arrays), then the group: its
    local heap of names, symbol table nodes of up to 2 x _H5_LEAF_K members
    in name order, a one-level B-tree over them and its header. Returns the
    addresses of the header, the B-tree and the heap."""
    names = sorted(tree, key=str.encode)
    if not names or len(names) > 4 * _H5_LEAF_K * _H5_NODE_K:
        raise ValueError(f"write_sim_hdf5 writes groups of 1 to "
                         f"{4 * _H5_LEAF_K * _H5_NODE_K} members, not {len(names)}")
    addrs = {n: (_h5_group(f, tree[n])[0] if isinstance(tree[n], dict)
                 else _h5_dataset(f, tree[n])) for n in names}
    seg, offsets = bytearray(8), {}  # offset 0: the empty name
    for n in names:
        offsets[n] = len(seg)
        b = n.encode() + b"\0"
        seg += b + b"\0" * (-len(b) % 8)
    f.write(b"\0" * (-f.tell() % 8))
    heap = f.tell()  # the heap's header (no free block), then its data
    f.write(b"HEAP" + bytes(4) + struct.pack("<QQQ", len(seg), 1, heap + 32) + bytes(seg))
    width, nodes, keys = 2 * _H5_LEAF_K, [], [0]
    for i in range(0, len(names), width):
        part = names[i:i + width]
        entries = b"".join(struct.pack("<QQII16x", offsets[n], addrs[n], 0, 0) for n in part)
        nodes.append(_h5_put(f, b"SNOD" + struct.pack("<BBH", 1, 0, len(part)) + entries
                             + bytes(40 * (width - len(part)))))
        keys.append(offsets[part[-1]])  # a node's right key: its last name
    body = b"".join(struct.pack("<QQ", k, c) for k, c in zip(keys, nodes)) + struct.pack(
        "<Q", keys[-1])
    full = 16 * 2 * _H5_NODE_K + 8
    btree = _h5_put(f, b"TREE" + struct.pack("<BBH", 0, 0, len(nodes)) + _H5_UNDEF * 2 + body
                    + bytes(full - len(body)))
    return _h5_put(f, _h5_header([(0x11, 0, struct.pack("<QQ", btree, heap))])), btree, heap


def write_sim_hdf5(path, groups):
    """Write ``groups`` ({"Photometry/Ia/model0": {"mjd": array, ...}, ...})
    as an HDF5 file with numpy and struct, in h5py's default layout:
    superblock version 0, version-1 object headers, symbol-table groups and
    contiguous little-endian datasets (integers, floats of 4 or 8 bytes)."""
    tree = {}
    for gpath, arrays in groups.items():
        node = tree
        for part in gpath.split("/"):
            node = node.setdefault(part, {})
        node.update(arrays)
    with open(path, "wb") as f:
        f.write(bytes(96))  # the superblock, written once the root is
        root, btree, heap = _h5_group(f, tree)
        eof = f.tell()
        f.seek(0)
        f.write(b"\x89HDF\r\n\x1a\n" + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                + struct.pack("<HHI", _H5_LEAF_K, _H5_NODE_K, 0) + struct.pack("<Q", 0)
                + _H5_UNDEF + struct.pack("<Q", eof) + _H5_UNDEF
                + struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree, heap))


def _write_tree(root, n, seed=0):
    """A ZTF BTS tree of ``n`` transients in the corpus's layout and formats
    (tests/fixtures.py:write_mini_ztfbts), from ``seed``: the transient table
    (about 1% of redshifts empty), a light curve each (10-300 points a band,
    bands interleaved), a headerless spectrum for about 90% (400-4000 rows;
    half with an error column, about 2% of its cells empty), a 60 x 60 host
    image for about 99% (row filters mixed; every 50th a palette file, every
    50th from the 25th RGBA). Returns the two directories and the RGB array
    each image should decode to."""
    rng = np.random.default_rng(seed)
    data_dir, spectra_dir = os.path.join(root, "ZTFBTS"), os.path.join(root, "ZTFBTS_spectra")
    for d in (os.path.join(data_dir, "light-curves"), os.path.join(data_dir, "hostImgs"),
              spectra_dir):
        os.makedirs(d)
    ids = [f"ZTF{18 + i % 6}a{i:06d}" for i in range(n)]
    names, shares = zip(*INGEST_TYPES)
    types = rng.choice(names, size=n, p=shares)
    z, av = rng.uniform(0.005, 0.2, n), rng.uniform(0.0, 0.5, n)
    no_z, no_sp, no_img = rng.random(n) < 0.01, rng.random(n) < 0.10, rng.random(n) < 0.01
    rows = ["ZTFID,redshift,type,A_V"] + [
        f"{sid},{'' if no_z[i] else f'{z[i]:.5f}'},{types[i]},{av[i]:.4f}"
        for i, sid in enumerate(ids)]
    with open(os.path.join(data_dir, "ZTFBTS_TransientTable.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    images = {}
    for i, sid in enumerate(ids):
        n_r, n_g = (int(v) for v in rng.integers(10, 301, 2))
        m = n_r + n_g
        t = 58000.0 + np.sort(rng.uniform(0.0, 300.0, m))
        bands = np.where(rng.permutation(m) < n_r, "R", "g")
        mag, err = 19.0 + rng.normal(0.0, 1.0, m), 0.02 + 0.1 * rng.random(m)
        with open(os.path.join(data_dir, "light-curves", f"{sid}.csv"), "w") as f:
            f.write("time,mag,magerr,band\n" + ("%.4f,%.4f,%.4f,%s\n" * m) % tuple(
                v for row in zip(t.tolist(), mag.tolist(), err.tolist(), bands.tolist())
                for v in row))
        if not no_sp[i]:
            m = int(rng.integers(400, 4001))
            wl = np.sort(rng.uniform(3500.0, 9500.0, m))
            flux = 1e-14 * (1.0 + 0.3 * rng.random(m))
            if i % 2:
                text = ("%.2f,%.6e\n" * m) % tuple(np.column_stack([wl, flux]).ravel())
            else:
                empty = rng.random(m) < 0.02
                fmt = "".join(np.where(empty, "%.2f,%.6e,\n", "%.2f,%.6e,%.6e\n").tolist())
                vals = np.column_stack([wl, flux, 0.05 * flux])
                keep = np.ones_like(vals, dtype=bool)
                keep[empty, 2] = False
                text = fmt % tuple(vals[keep].tolist())
            with open(os.path.join(spectra_dir, f"{sid}.csv"), "w") as f:
                f.write(text)
        if not no_img[i]:
            shape = (INGEST_IMAGE, INGEST_IMAGE)
            filters = rng.integers(0, 5, INGEST_IMAGE)
            path = os.path.join(data_dir, "hostImgs", f"{sid}.host.png")
            if i % 50 == 0:
                palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
                idx = rng.integers(0, 256, shape, dtype=np.uint8)
                write_png(path, idx, filters, palette=palette)
                images[sid] = palette[idx]
            else:
                pix = rng.integers(0, 256, shape + ((4,) if i % 50 == 25 else (3,)),
                                   dtype=np.uint8)
                write_png(path, pix, filters)
                images[sid] = pix[..., :3]
    return data_dir, spectra_dir, images


def _csv_equal(got, want):
    """fastcsv's columns against the plain reader's: the same names and
    types, numeric columns bitwise with NaN in the same places, strings
    equal."""
    if list(got) != list(want):
        return False
    for k, g in got.items():
        w = want[k]
        if g.dtype != w.dtype or g.shape != w.shape:
            return False
        if g.dtype == object:
            if g.tolist() != w.tolist():
                return False
        elif not (np.array_equal(np.isnan(g), np.isnan(w))
                  and np.array_equal(g[~np.isnan(g)].view(np.int64),
                                     w[~np.isnan(w)].view(np.int64))):
            return False
    return True


def _ingest_checks(data_dir, spectra_dir, images):
    """The native reader against the plain one on every CSV of the tree, every
    PNG decoded against the array written, and the two unfilters timed.
    Returns the seconds of the decode alone (load_images of every image)."""
    files = ([(os.path.join(data_dir, "ZTFBTS_TransientTable.csv"), True)]
             + [(os.path.join(data_dir, "light-curves", f), True)
                for f in sorted(os.listdir(os.path.join(data_dir, "light-curves")))]
             + [(os.path.join(spectra_dir, f), False) for f in sorted(os.listdir(spectra_dir))])
    t0 = time.perf_counter()
    bad = [p for p, header in files
           if not _csv_equal(read_csv(p, header), read_csv_plain(p, header))]
    log(f"ingest: fastcsv against the plain reader on all {len(files)} CSVs (the table, "
        f"light curves, spectra) in {time.perf_counter() - t0:.2f} s: {len(bad)} differ")
    if bad:
        raise AssertionError(f"ingest: fastcsv differs from the plain reader on {bad[:5]}")

    t0 = time.perf_counter()
    decoded, names = load_images(data_dir)
    decode_s = time.perf_counter() - t0
    # x / 255 in float32 is one-to-one on 0..255: equal floats are equal bytes
    wrong = [n for n, img in zip(names, decoded)
             if not np.array_equal(img, np.asarray(images[n], dtype=np.float32) / 255.0)]
    log(f"ingest: load_images decoded {len(names)} PNGs ({decoded.shape}) in {decode_s:.3f} "
        f"s ({decode_s / len(names) * 1e3:.4f} ms each); every one against the array written "
        f"(/ 255): {len(wrong)} differ; names match the files written: "
        f"{sorted(images) == names}")
    if wrong or sorted(images) != names:
        raise AssertionError(f"ingest: PNG decode differs on {wrong[:5]}")
    sample = [open(os.path.join(data_dir, "hostImgs", f"{n}.host.png"), "rb").read()
              for n in names[:INGEST_UNFILTER_SAMPLE]]
    ms = {}
    for name, fn in (("native", None), ("numpy", unfilter_numpy)):
        t0 = time.perf_counter()
        out = [decode(b, fn) for b in sample]
        ms[name] = (time.perf_counter() - t0) / len(sample) * 1e3
        if any(not np.array_equal(o, images[n]) for o, n in zip(out, names)):
            raise AssertionError(f"ingest: the {name} unfilter decodes wrongly")
    log(f"ingest: PNG decode a {INGEST_IMAGE} x {INGEST_IMAGE} image, over "
        f"{len(sample)} images: native unfilter (csrc/fastcsv.cpp) {ms['native']:.4f} ms, "
        f"numpy unfilter (data/png.py:unfilter_numpy) {ms['numpy']:.4f} ms "
        f"({ms['numpy'] / ms['native']:.1f}x)")
    return decode_s


def _tree_files(path):
    """{relative path: (size, mtime_ns, sha256)} of every file under ``path``."""
    out = {}
    for root, _, files in os.walk(path):
        for f in files:
            p = os.path.join(root, f)
            st = os.stat(p)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = (st.st_size, st.st_mtime_ns,
                                                 hashlib.sha256(fh.read()).hexdigest())
    return out


def _cli_counted(tag, main, argv):
    """``main(argv)`` in process, counted from zero; no plain version may
    run. Returns the launches, the wall seconds and what it printed."""
    out = io.StringIO()
    with _plain_calls() as plain, contextlib.redirect_stdout(out):
        _zero_counts()
        t0 = time.perf_counter()
        main(argv)
        wall = time.perf_counter() - t0
        counts = _counts()
    for line in out.getvalue().splitlines():
        log(f"{tag}: | {line}")
    log(f"{tag}: {wall:.3f} s; launches {counts}, {len(plain)} plain kernel calls")
    if plain:
        raise AssertionError(f"{tag}: {len(plain)} plain kernel calls")
    return counts, wall, out.getvalue()


def _tf32_only(tag, counts):
    if counts[:12] != (0,) * 12 or min(counts[12:]) <= 0:
        raise AssertionError(f"{tag}: launches {counts}: not all on the 3xTF32 flash route")


def _metric_rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# the CLI runs of phase ingest whose ingest cache the tree's process fills
# beforehand: (config, the CLI's spectral default); cli.pretrain_masked's stays
# a miss, so a CLI still ingests on a miss
PREFILLED = ((MAVEN_FINETUNE, 220), (SMOKE, 1000))


def _tree_job(tmp, t0_smoke):
    """Phase ingest's tree written under ``tmp``, its host checks
    (_ingest_checks: the native reader and the PNG decoder), then the ingest
    cache of each PREFILLED config as its CLI keys it: (data dir, spectra
    dir, the images written, the decode seconds). Logs on the smoke's clock
    (``t0_smoke``: the monotonic clock is the same in every process)."""
    global _T0
    _T0 = t0_smoke
    t0 = time.perf_counter()
    data_dir, spectra_dir, images = _write_tree(tmp, INGEST_N)
    log(f"ingest: wrote a tree of {INGEST_N} transients ({len(os.listdir(spectra_dir))} "
        f"spectra, {len(images)} images) in {time.perf_counter() - t0:.2f} s (a spawned "
        f"process, beside the phases before ingest)")
    decode_s = _ingest_checks(data_dir, spectra_dir, images)
    t0 = time.perf_counter()
    for path, sp_default in PREFILLED:
        config = cli_common.ingest_config(data_dir, spectra_dir,
                                          load_sweep(path).extra_args, sp_default)
        load_or_ingest(os.path.join(tmp, "cache"),
                       lambda c=config: load_ztfbts(kfolds=None, **c)[0], **config)
    log(f"ingest: the ingest caches of {[p for p, _ in PREFILLED]} filled in "
        f"{time.perf_counter() - t0:.2f} s (the spawned process)")
    return data_dir, spectra_dir, images, decode_s


def start_tree(tmp):
    """_tree_job in one spawned process, started before the phases that
    precede phase ingest and taken by it (``.result()``): numpy, zlib, file
    and native-reader work of about a minute that touches no CUDA, so it
    overlaps the card's phases instead of adding to the smoke's time. Its
    failure raises in phase ingest. Spawned, not forked: this process has
    CUDA and worker threads by then."""
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    future = pool.submit(_tree_job, tmp, _T0)
    pool.shutdown(wait=False)  # the worker exits once the job is done
    return future


def phase_ingest(card, tmp, tree):
    """The ZTF BTS tree under ``tmp`` (``tree``: start_tree's future; the
    native reader and the decoder checked there); the folds and the cache;
    then maven-lite trained from it through
    cli.train (2 folds, 2 epochs) and resumed, cli.finetune_clip from run dir
    ``tmp/S`` (phase sim's cli.pretrain_sim run), cli.pretrain_masked
    --source real, and configs/smoke.yaml through cli.train (--check, then 1
    epoch). Returns the launches of every counted call."""
    t_phase = time.perf_counter()
    data_dir, spectra_dir, images, decode_s = tree.result()
    log(f"ingest: the tree and its reader and decoder checks taken from the spawned process "
        f"after {time.perf_counter() - t_phase:.2f} s of waiting")

    # the cache: a miss, then a hit that must equal it
    sweep = load_sweep(MAVEN_LITE)
    extra = sweep.extra_args
    cache_dir, analysis = os.path.join(tmp, "cache"), os.path.join(tmp, "analysis")
    config = cli_common.ingest_config(data_dir, spectra_dir, extra, 1000)
    times, sets = {}, {}
    for tag in ("miss", "hit"):
        t0 = time.perf_counter()
        sets[tag], hit = load_or_ingest(cache_dir, lambda: load_ztfbts(kfolds=None, **config)[0],
                                        **config)
        times[tag] = time.perf_counter() - t0
        if hit != (tag == "hit"):
            raise AssertionError(f"ingest: cache {tag} read hit={hit}")
    ds, miss = sets["hit"], sets["miss"]
    same = ds.filenames == miss.filenames and _bitwise(ds.arrays, miss.arrays)
    log(f"ingest: load_or_ingest of maven-lite's config ({config}): miss {times['miss']:.3f} "
        f"s, {INGEST_N / times['miss']:.1f} transients/s; hit {times['hit']:.4f} s; "
        f"{len(ds)} samples, fields {sorted(ds.arrays)}; the hit bitwise the miss: {same}")
    log(f"ingest: decode share: {decode_s:.3f} s of host-image decoding beside the "
        f"{times['miss']:.3f} s miss, {decode_s / (decode_s + times['miss']):.3f} of an "
        f"ingest with images; card {card}")
    if not same or len(ds) < INGEST_N // 2:
        raise AssertionError("ingest: the cache hit differs from the miss")
    labels = np.asarray(ds.arrays["label"])
    folds = stratified_kfolds(labels, int(extra["kfolds"]))
    tests = np.sort(np.concatenate([f["test_indices"] for f in folds]))
    per_class = np.array([np.bincount(labels[f["test_indices"]], minlength=5) for f in folds])
    spread = int((per_class.max(axis=0) - per_class.min(axis=0)).max())
    log(f"ingest: {len(folds)} stratified folds, class counts per fold {per_class.tolist()}, "
        f"largest spread {spread}; test indices partition the set: "
        f"{np.array_equal(tests, np.arange(len(ds)))}")
    if not np.array_equal(tests, np.arange(len(ds))) or spread > 1:
        raise AssertionError("ingest: the folds break their invariants")

    # cli.train: maven-lite from its own config, two folds, two epochs
    argv = ["--data-dir", data_dir, "--spectra-dir", spectra_dir, "--cache-dir", cache_dir,
            "--analysis-path", analysis, "--device", DEVICE]
    points = list(expand_grid(sweep))[:INGEST_RUNS]
    model, _, _, _, tcfg = _build_run(points[0], extra, NBAND, None, INGEST_EPOCHS)
    layers = model.cfg.tk()["depth"] + model.cfg.tsk()["depth"]
    per_step, b = _tf32_flash(layers, layers), tcfg.batch_size
    want = NONE
    for p in points:
        f = folds[p["foldnumber"]]
        want = tuple(a + c for a, c in zip(want, _fit_want(
            per_step, INGEST_EPOCHS, -(-len(f["train_indices"]) // b),
            -(-len(f["test_indices"]) // b))))
    log(f"ingest train: cli.train {MAVEN_LITE}: cuts: epochs {points[0]['epochs']} -> "
        f"{INGEST_EPOCHS}, nruns {extra['nruns']} -> {INGEST_RUNS} (folds 0 and 1); LC "
        f"{model.cfg.tk()}; SP {model.cfg.tsk()}; trainer {tcfg}")
    counts, wall, _ = _cli_counted("ingest train", cli_train.main, [
        MAVEN_LITE, *argv, "--epochs", str(INGEST_EPOCHS), "--max-runs", str(INGEST_RUNS)])
    if counts != want:
        raise AssertionError(f"ingest train: launches {counts}, want {want}")
    total = counts
    sweep_dir = os.path.join(analysis, "maven-lite")
    for k, p in enumerate(points):
        run = os.path.join(sweep_dir, f"run-{k}")
        files = set(os.listdir(run))
        kept = sorted(f for f in files if f.startswith("epoch="))
        rows = _metric_rows(run)
        with open(os.path.join(run, "config.yaml")) as fh:
            dumped = safe_load(fh.read())
        f = folds[p["foldnumber"]]
        manifests = {}
        for name in ("train_filenames.txt", "val_filenames.txt"):
            with open(os.path.join(run, name)) as fh:
                manifests[name] = fh.read().splitlines()
        want_names = {"train_filenames.txt": [ds.filenames[i] for i in f["train_indices"]],
                      "val_filenames.txt": [ds.filenames[i] for i in f["test_indices"]]}
        log(f"ingest train run-{k} (fold {p['foldnumber']}): files {sorted(files)}; manifests "
            f"{len(manifests['train_filenames.txt'])} / {len(manifests['val_filenames.txt'])} "
            f"names, the fold's: {manifests == want_names}; " + "; ".join(
                f"epoch {r['epoch']} train_loss {r['train_loss']:.7f} val_loss "
                f"{r['val_loss']:.7f} AUC_val {r['AUC_val']:.4f} step "
                f"{r['step_time_s'] * 1e3:.3f} ms" for r in rows))
        if (not set(RUN_DIR_FILES) <= files or len(kept) != 2 or manifests != want_names
                or dumped != p or [r["epoch"] for r in rows] != list(range(INGEST_EPOCHS))
                or not all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
                           for r in rows)):
            raise AssertionError(f"ingest train run-{k}: files {sorted(files)}, kept {kept}, "
                                 f"manifests the fold's {manifests == want_names}, config "
                                 f"{dumped == p}, rows {rows}")

    # fold 0's first steps on the kernel and the plain path, and its step's time
    f0 = folds[points[0]["foldnumber"]]
    train0 = ds.subset(f0["train_indices"])
    data = train0.to_device(DEVICE)
    plan = epoch_indices(len(train0), b, rng=np.random.default_rng(tcfg.seed), shuffle=True,
                         pad="wrap")[:INGEST_TRAJ_STEPS]

    def make():
        return _build_run(points[0], extra, NBAND, None, None)[0].to(DEVICE)

    traj = _maven_trajectory("ingest train fold 0", make, tcfg, data, plan, per_step)
    model = make()
    opt, _ = build_optimizer(model.named_parameters(), lr=tcfg.lr,
                             weight_decay=tcfg.weight_decay)
    state, step = TrainState(model, opt), make_train_step(model, tcfg.noise_level_mag)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    one = take(data, torch.from_numpy(plan[0]).to(DEVICE))
    _zero_counts()
    host, loss = _host_step_ms(step, state, one, gen, INGEST_TIMED)
    dev_ms, wall_ms, host_ms, idle, ops, kinds = _trace(lambda: step(state, one, gen),
                                                       PROFILED_STEPS)
    timed = _counts()
    _check_counts("ingest timed steps", timed,
                  tuple(c * (INGEST_TIMED + 2 + PROFILED_STEPS) for c in per_step))
    step_ms = float(np.median(host))
    cli_steps = [r["step_time_s"] * 1e3 for r in _metric_rows(os.path.join(sweep_dir, "run-0"))]
    log(f"ingest train: maven-lite step (B={b}, float32, real-layout data of fold 0): host "
        f"clock median {step_ms:.3f} ms (quartiles {np.percentile(host, 25):.3f}-"
        f"{np.percentile(host, 75):.3f}) over {INGEST_TIMED}; the CLI run's epoch means "
        f"{', '.join(f'{s:.3f}' for s in cli_steps)} ms; device {dev_ms:.3f} ms a step, idle "
        f"share {idle:.3f} (one profile of {PROFILED_STEPS} steps); loss {float(loss):.6g}; "
        f"card {card}")
    _log_trace("ingest train profile", "train steps", dev_ms, wall_ms, host_ms, idle, ops,
               kinds, at=f"B={b} float32")
    total = tuple(sum(c) for c in zip(total, traj, timed))
    del model, opt, state, data
    torch.cuda.empty_cache()

    # --resume: the completed runs are skipped, the cache hits
    before = _tree_files(sweep_dir)
    counts, _, out = _cli_counted("ingest resume", cli_train.main, [
        sweep_dir, *argv, "--epochs", str(INGEST_EPOCHS), "--max-runs", str(INGEST_RUNS),
        "--resume"])
    after = _tree_files(sweep_dir)
    log(f"ingest resume: {len(after)} files of the sweep, unchanged: {before == after}; "
        f"cache hit: {'cache=hit' in out}")
    if counts != NONE or before != after or "cache=hit" not in out:
        raise AssertionError(f"ingest resume: launches {counts}, files unchanged "
                             f"{before == after}, output {out!r}")

    # cli.finetune_clip from phase maven's run P, one run, one epoch
    raw = load_sweep(MAVEN_FINETUNE).raw
    ft_cfg = os.path.join(tmp, "maven_finetune.yaml")
    with open(ft_cfg, "w") as fh:
        fh.write(dump_yaml(dict(raw, extra_args=dict(raw["extra_args"],
                                                      pretrain_path=os.path.join(tmp, "S")))))
    counts, _, _ = _cli_counted("ingest finetune", cli_finetune.main, [
        ft_cfg, *argv, "--epochs", "1", "--max-runs", "1"])
    rows = _metric_rows(os.path.join(analysis, "maven_finetune", "run-0"))
    log(f"ingest finetune: a copy of {MAVEN_FINETUNE} with pretrain_path = S (phase sim's "
        f"cli.pretrain_sim run: pretrain_sim, then finetune_clip); cuts: epochs "
        f"1000 -> 1, nruns 5 -> 1: {rows}")
    _tf32_only("ingest finetune", counts)
    total = tuple(a + c for a, c in zip(total, counts))

    # cli.pretrain_masked --source real, one run, one epoch
    counts, _, _ = _cli_counted("ingest masked", cli_masked.main, [
        GRID, "--source", "real", "--data-dir", data_dir, "--cache-dir", cache_dir,
        "--analysis-path", analysis, "--device", DEVICE, "--epochs", "1", "--max-runs", "1"])
    masked_rows = _metric_rows(os.path.join(analysis, "config_grid-masked", "run-0"))
    log(f"ingest masked: {GRID} --source real; cuts: epochs 3000 -> 1, nruns 20 -> 1: "
        f"{masked_rows}")
    _tf32_only("ingest masked", counts)
    total = tuple(a + c for a, c in zip(total, counts))

    # cli.train of configs/smoke.yaml at head dim 4, --check for the card first
    code, text = _exit_code("ingest smoke check", cli_train.main, [SMOKE, "--check"])
    if code != 0 or "flash simt (CUDA cores)" not in text:
        raise AssertionError(f"ingest smoke check: exit {code}, {text!r}")
    counts, wall, _ = _cli_counted("ingest smoke", cli_train.main, [
        SMOKE, *argv, "--epochs", str(SMOKE_EPOCHS)])
    smoke_rows = _metric_rows(os.path.join(analysis, "smoke", "run-0"))
    log(f"ingest smoke: {SMOKE} (head dim 4) on the tree through cli.train; cuts: epochs 3 "
        f"-> {SMOKE_EPOCHS}, the tree's {INGEST_N} transients kept; {wall:.3f} s; flash "
        f"launches at head dim 4, all on the CUDA cores: forward {counts[0]}, backward "
        f"{counts[1]}; {smoke_rows}")
    if (counts[2:] != (0,) * 12 or not counts[0] > counts[1] > 0
            or len(smoke_rows) != SMOKE_EPOCHS):
        raise AssertionError(f"ingest smoke: launches {counts}, rows {smoke_rows}")
    if not all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
               for r in rows + masked_rows + smoke_rows):
        raise AssertionError(f"ingest: a non-finite loss: {rows + masked_rows + smoke_rows}")
    total = tuple(a + c for a, c in zip(total, counts))
    log(f"ingest: launches per route {COUNT_NAMES}: {total}; card {card}")
    log(f"ingest: phase done in {time.perf_counter() - t_phase:.1f} s")
    return total


# phase evaluate: the evaluation CLIs and --check on phase ingest's tree and run dirs
EVAL_B = 256  # the evaluation CLIs' default batch
# the probes on the kernel path's embeddings against the plain path's: regression
# predictions within EVAL_REG_RTOL of the largest, the classifiers' equal, but on the
# rows that sit near a tie on the kernel path's embeddings
EVAL_REG_RTOL, EVAL_MARGIN, EVAL_GAP = 1e-4, 1e-4, 1e-5
EVAL_SEED = 7  # infer --seed of the masked run's anomaly scores
# runs whose every probe is fitted on both paths' embeddings (run-0; run-1's
# embeddings are still held to the plain path's): the smoke's time limit
EVAL_PROBE_RUNS = 1
_PARAMS_LINE = re.compile(r"^run-0: .*\| ([\d,]+) params", re.M)


def _reap(proc):
    """Kill ``proc`` if it still runs (atexit: a failed phase leaves no child)."""
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _exit_code(tag, main, argv):
    """``main(argv)`` in process with its output captured and logged:
    (its exit code, what it printed)."""
    out, code = io.StringIO(), 0
    with contextlib.redirect_stdout(out):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code or 0
    for line in out.getvalue().splitlines():
        log(f"{tag}: | {line}")
    return code, out.getvalue()


def _attention_layers(model):
    return sum(isinstance(m, transformer_mod.SelfAttention) for m in model.modules())


def _trained_params(model):
    """The parameters the preflight counts: those that take gradients."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def _fwd_counted(tag, main, argv, layers, n):
    """``main(argv)`` counted: every launch a 3xTF32 flash forward, ``layers``
    of them for each of the ceil(n / EVAL_B) batches."""
    counts, wall, _ = _cli_counted(tag, main, argv)
    want = _tf32_flash(layers * -(-n // EVAL_B), 0)
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, want {want}")
    return counts, wall


def _probe_family(kind):
    """'Linear', 'KNN', 'Linear-five', 'KNN-five', ... of a probe kind."""
    return ("Linear" if kind.startswith("Linear") else "KNN") + kind[kind.find("-"):] * (
        "-" in kind)


def _probes_against_plain(tag, names, kern, plain, z, y, seconds):
    """Every probe of ``run_probes`` on the kernel path's (train, val)
    embeddings against the same probe on the plain path's. Adds each probe
    family's seconds (kernel-path inputs) to ``seconds``, and logs each
    input's rank (the singular values of its centred train rows above the
    linear regression's cutoff) and the regressions' largest relative
    difference; returns (rows compared, rows near a tie, near-tie rows that
    differ)."""
    rows = near_rows = differ = 0
    kern_in, plain_in = (cli_evaluate.probe_inputs(names, *e) for e in (kern, plain))
    for combo, (xt, xv) in kern_in.items():
        near = cli_evaluate.near_ties(xt, xv, y, EVAL_MARGIN, EVAL_GAP)
        sv = np.linalg.svd(xt - xt.mean(axis=0, dtype=np.float64), compute_uv=False)
        worst = {}
        got, t0 = [], time.perf_counter()
        for kind, task, pred, _ in cli_evaluate.run_probes(xt, xv, z, y):
            t1 = time.perf_counter()
            fam = _probe_family(kind)
            seconds[fam] = seconds.get(fam, 0.0) + t1 - t0
            got.append((kind, task, pred))
            t0 = time.perf_counter()
        want = [(k, p) for k, _, p, _ in cli_evaluate.run_probes(*plain_in[combo], z, y)]
        for (kind, task, a), (kind_w, b) in zip(got, want):
            if kind != kind_w or a.shape != b.shape:
                raise AssertionError(f"{tag} {combo} {kind}: {kind_w}, {a.shape} {b.shape}")
            if task == "regression":
                rel = np.abs(a - b) / np.max(np.abs(b))
                fam = _probe_family(kind)
                worst[fam] = max(worst.get(fam, 0.0), float(np.max(rel[~near[kind]])))
                diff = rel > EVAL_REG_RTOL
            else:
                diff = a != b
            if (diff & ~near[kind]).any():
                raise AssertionError(f"{tag} {combo} {kind}: {int((diff & ~near[kind]).sum())} "
                                     f"rows differ off the near ties")
            rows += len(a)
            near_rows += int(near[kind].sum())
            differ += int(diff.sum())
        rank = int((sv > probes.LSTSQ_RCOND * sv[0]).sum())
        log(f"{tag} {combo}: train rows {xt.shape}, rank {rank} above the linear "
            f"regression's cutoff {probes.LSTSQ_RCOND} (smallest singular value "
            f"{sv[-1] / sv[0]:.3e} of the largest); regression against the plain path, largest "
            f"relative difference off near ties: " + ", ".join(
                f"{f} {w:.3e}" for f, w in worst.items()))
    return rows, near_rows, differ


def phase_evaluate(card, tmp):
    """Phase ingest's run dirs and tree evaluated through the evaluation
    CLIs: cli.evaluate on the two maven-lite fold runs (every embedding batch
    18 3xTF32 flash forwards, the kernel path's embeddings against the
    plain path's, and every probe of run-0 on both), a 1-epoch cli.supervise run of
    configs/config_grid.yaml and cli.evaluate on it (the supervised
    branch), cli.export_embeddings and cli.infer against the direct calls,
    and --check of the four training CLIs. Returns the launches of every
    counted call."""
    t_phase = time.perf_counter()
    data_dir, spectra_dir = os.path.join(tmp, "ZTFBTS"), os.path.join(tmp, "ZTFBTS_spectra")
    cache_dir, analysis = os.path.join(tmp, "cache"), os.path.join(tmp, "analysis")
    sweep = load_sweep(MAVEN_LITE)
    extra = sweep.extra_args
    runs = [os.path.join(analysis, "maven-lite", f"run-{k}") for k in range(INGEST_RUNS)]
    ds = cli_common.load_cached(cache_dir, cli_common.ingest_config(data_dir, spectra_dir,
                                                                    extra, 1000))
    total = NONE

    # (a) cli.evaluate on both fold runs, full width, as the JAX package cannot
    models = [load_model(r, DEVICE)[0] for r in runs]
    layers = _attention_layers(models[0])
    splits = [cli_evaluate.split_datasets(r, ds) for r in runs]
    n_rows = sum(len(s) for pair in splits for s in pair)
    batches = sum(-(-len(s) // EVAL_B) for pair in splits for s in pair)
    out_dir = os.path.join(tmp, "evaluation")
    counts, wall, _ = _cli_counted("evaluate cli", cli_evaluate.main, [
        "--runs", *runs, "--data-dir", data_dir, "--spectra-dir", spectra_dir,
        "--out-dir", out_dir, "--max-spec-len", str(extra["max_spectral_data_len"]),
        "--rescale", str(extra["spectral_rescalefactor"]), "--device", DEVICE])
    want = _tf32_flash(layers * batches, 0)
    if layers != 18 or counts != want:
        raise AssertionError(f"evaluate cli: {layers} layers, launches {counts}, want {want}")
    total = tuple(a + c for a, c in zip(total, counts))
    pickles = {}
    for task, n_kinds in (("regression", 8), ("classification", 16)):
        with open(os.path.join(out_dir, f"{task}_metrics_list.pkl"), "rb") as f:
            pickles[task] = pickle.load(f)
        vals = [v for r in pickles[task] for v in r.values() if isinstance(v, float)]
        if len(pickles[task]) != len(runs) * 3 * n_kinds or not np.all(np.isfinite(vals)):
            raise AssertionError(f"evaluate cli: {task} rows {pickles[task]}")
    log(f"evaluate cli: {len(runs)} maven-lite fold runs, {n_rows} rows in {batches} "
        f"embedding batches of {EVAL_B}: {wall:.3f} s (its ingest included); launches "
        f"{counts[12]} = {layers} x {batches}, all 3xTF32 forwards; pickles: "
        f"{len(pickles['regression'])} regression, {len(pickles['classification'])} "
        f"classification rows, finite; card {card}")

    # (b) the kernel path's embeddings and probes against the plain path's
    seconds, probe_rows = {}, [0, 0, 0]
    emb_ms, worst, worst_norm = [], 0.0, 0.0
    for k, (run, model, (train_ds, val_ds)) in enumerate(zip(runs, models, splits)):
        kern, plain = [], []
        for part in (train_ds, val_ds):
            _zero_counts()
            t0 = time.perf_counter()
            embs, names = get_embeddings(model, part, EVAL_B, DEVICE)
            emb_ms.append((time.perf_counter() - t0) * 1e3 / -(-len(part) // EVAL_B))
            if _counts() != _tf32_flash(layers * -(-len(part) // EVAL_B), 0):
                raise AssertionError(f"evaluate run-{k}: launches {_counts()}")
            with _plain_kernels():
                want_embs, _ = get_embeddings(model, part, EVAL_B, DEVICE)
            for g, w in zip(embs, want_embs):
                err = float(np.max(np.abs(g - w)))
                worst = max(worst, err)
                worst_norm = max(worst_norm, float(np.linalg.norm(g - w) / np.linalg.norm(w)))
                if err > TOL["float32"]:
                    raise AssertionError(f"evaluate run-{k}: embeddings {err:.3e} off the plain "
                                         f"path's")
            kern.append(embs)
            plain.append(want_embs)
        if k >= EVAL_PROBE_RUNS:
            continue
        z = (train_ds.arrays["redshift"], val_ds.arrays["redshift"])
        y = (train_ds.arrays["label"], val_ds.arrays["label"])
        got = _probes_against_plain(f"evaluate run-{k}", names, kern, plain, z, y, seconds)
        probe_rows = [a + b for a, b in zip(probe_rows, got)]
    log(f"evaluate: embeddings, kernel path against the plain path: max abs {worst:.3e} (tol "
        f"{TOL['float32']}), normalised {worst_norm:.3e}; host clock an embedding batch "
        f"(B = {EVAL_B}, float32, the split's tail batch included) median "
        f"{np.median(emb_ms):.3f} ms ({', '.join(f'{m:.3f}' for m in emb_ms)}); card {card}")
    log(f"evaluate: every probe on both paths' embeddings of run-0: {probe_rows[0]} predictions, "
        f"{probe_rows[1]} of them near a tie (LinearSVC margin < {EVAL_MARGIN}, KNN gap <= "
        f"{EVAL_GAP}), {probe_rows[2]} differing, all near ties; regression within "
        f"{EVAL_REG_RTOL} of the largest; host seconds by probe family ({EVAL_PROBE_RUNS} "
        f"of {len(runs)} runs, three inputs each): " + ", ".join(f"{f} {s:.3f}" for f, s in seconds.items()))

    # (c) a 1-epoch supervised run through the supervisor, then its evaluation
    grid = load_sweep(GRID)
    sup_argv = [sys.executable, "-m", "multimodal_supernovae_tpu_torch.cli.train", GRID,
                "--data-dir", data_dir, "--spectra-dir", spectra_dir, "--cache-dir",
                cache_dir, "--analysis-path", analysis, "--device", DEVICE]
    # (e)'s supervisor --check: the training CLI's preflight in a child of a
    # child on the meta device, started now and read in (e)
    sup_check = subprocess.Popen(
        [sys.executable, "-m", "multimodal_supernovae_tpu_torch.cli.supervise", "--check",
         "--", *sup_argv[:4]], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(_reap, sup_check)
    t0 = time.perf_counter()
    code, _ = _exit_code("evaluate supervise", cli_supervise.main, [
        "--max-restarts", "0", "--", *sup_argv, "--epochs", "1", "--max-runs", "1"])
    sup_run = os.path.join(analysis, "config_grid", "run-0")
    rows = _metric_rows(sup_run)
    log(f"evaluate supervise: cli.supervise -- cli.train {GRID} (regression; cuts: epochs "
        f"{next(expand_grid(grid))['epochs']} -> 1, nruns {grid.extra_args['nruns']} -> 1) in "
        f"a child process (its launches uncounted): exit {code} in "
        f"{time.perf_counter() - t0:.1f} s; {rows}")
    if code != 0 or not all(np.isfinite(r["train_loss"]) for r in rows):
        raise AssertionError(f"evaluate supervise: exit {code}, rows {rows}")
    sup_model = load_model(sup_run, DEVICE)[0]
    lc_ds = cli_common.load_cached(cache_dir, cli_common.ingest_config(
        data_dir, spectra_dir, grid.extra_args, 1000))
    _, sup_val = cli_evaluate.split_datasets(sup_run, lc_ds)
    sup_out = os.path.join(tmp, "evaluation-supervised")
    counts, _ = _fwd_counted("evaluate supervised", cli_evaluate.main, [
        "--runs", sup_run, "--data-dir", data_dir, "--spectra-dir", spectra_dir,
        "--out-dir", sup_out, "--device", DEVICE], _attention_layers(sup_model), len(sup_val))
    total = tuple(a + c for a, c in zip(total, counts))
    with open(os.path.join(sup_out, "regression_metrics_list.pkl"), "rb") as f:
        sup_rows = pickle.load(f)
    if len(sup_rows) != 1 or not np.isfinite(sup_rows[0]["R2"]):
        raise AssertionError(f"evaluate supervised: {sup_rows}")

    # (d) export_embeddings and infer against the direct calls
    ft_run = os.path.join(analysis, "maven_finetune", "run-0")
    masked_run = os.path.join(analysis, "config_grid-masked", "run-0")
    npz = os.path.join(tmp, "exported.npz")
    counts, _ = _fwd_counted("evaluate export", cli_export.main, [
        "--run", runs[0], "--data-dir", data_dir, "--spectra-dir", spectra_dir, "--out", npz,
        "--split", "val", "--max-spec-len", str(extra["max_spectral_data_len"]),
        "--rescale", str(extra["spectral_rescalefactor"]), "--device", DEVICE],
        layers, len(splits[0][1]))
    total = tuple(a + c for a, c in zip(total, counts))
    got = np.load(npz)
    direct, names = get_embeddings(models[0], splits[0][1], EVAL_B, DEVICE)
    same = (all(np.array_equal(got[f"emb_{n}"], e) for n, e in zip(names, direct))
            and got["filenames"].tolist() == splits[0][1].filenames)
    log(f"evaluate export: run-0's val split, {sorted(got.files)}: equal to get_embeddings "
        f"{same}")
    if not same:
        raise AssertionError("evaluate export: the .npz differs from get_embeddings")
    infer_cases = (  # run, what infer writes, the direct call
        ("finetune", ft_run, "emb_", lambda m, d: (lambda e: {
            f"emb_{n}": v for v, n in zip(*e)})(get_embeddings(m, d, EVAL_B, DEVICE))),
        ("supervised", sup_run, "pred", lambda m, d: {"pred": predict_supervised(
            m, d, EVAL_B, DEVICE)}),
        ("masked", masked_run, "recon_mse", lambda m, d: {
            "recon_mse": masked_reconstruction_mse(m, d, generator=torch.Generator(
                device=DEVICE).manual_seed(EVAL_SEED), batch_size=EVAL_B, device=DEVICE)}))
    for tag, run, key, direct_call in infer_cases:
        model = load_model(run, DEVICE)[0]
        run_extra = load_run_config(run)[1]
        run_ds = cli_common.load_cached(cache_dir, cli_common.ingest_config(
            data_dir, spectra_dir, dict(run_extra, combinations=run_extra.get(
                "combinations", ("lightcurve",))), 1000))
        out = os.path.join(tmp, f"infer-{tag}.npz")
        counts, _ = _fwd_counted(f"evaluate infer {tag}", cli_infer.main, [
            run, "--data-dir", data_dir, "--spectra-dir", spectra_dir, "--cache-dir", cache_dir,
            "--out", out, "--seed", str(EVAL_SEED), "--device", DEVICE],
            _attention_layers(model), len(run_ds))
        total = tuple(a + c for a, c in zip(total, counts))
        got, want = np.load(out), direct_call(model, run_ds)
        with open(os.path.splitext(out)[0] + ".json") as f:
            manifest = json.load(f)
        same = (all(np.array_equal(got[k], v) for k, v in want.items())
                and sorted(k for k in got.files if k.startswith(key)) == sorted(want)
                and got["filenames"].tolist() == run_ds.filenames)
        log(f"evaluate infer {tag}: {run}: {sorted(got.files)} of {len(run_ds)} rows, equal "
            f"to the direct call {same}; manifest {manifest}")
        if not same or manifest["backend"] != torch.device(DEVICE).type:
            raise AssertionError(f"evaluate infer {tag}: the .npz differs from the direct call")

    # (e) --check of the four training CLIs on their shipped configs
    ft_cfg = os.path.join(tmp, "maven_finetune.yaml")  # phase ingest's copy, pretrain_path S
    checks = (("train", cli_train.main, [MAVEN_LITE, "--check"], models[0]),
              ("finetune_clip", cli_finetune.main, [ft_cfg, "--check"],
               load_model(ft_run, DEVICE)[0]),
              ("pretrain_masked", cli_masked.main, [GRID, "--check", "--source", "real"],
               load_model(masked_run, DEVICE)[0]),
              ("supervise", None, sup_check, sup_model))
    for name, main, argv, model in checks:
        t0 = time.perf_counter()
        if main is None:  # the supervisor runs the training CLI's preflight in a child
            text, _ = argv.communicate(timeout=600)
            code = argv.returncode
            for line in text.splitlines():
                log(f"evaluate check {name}: | {line}")
        else:
            code, text = _exit_code(f"evaluate check {name}", main, argv)
        m = _PARAMS_LINE.search(text)
        n_params = int(m.group(1).replace(",", "")) if m else None
        waited = " waited for (started in (c))" if main is None else ""
        log(f"evaluate check {name}: exit {code} in {time.perf_counter() - t0:.2f} s"
            f"{waited}; run-0 n_params {n_params}, the card's model {_trained_params(model)}")
        if code != 0 or n_params != _trained_params(model):
            raise AssertionError(f"evaluate check {name}: exit {code}, n_params {n_params}")
    broken = os.path.join(tmp, "broken.yaml")
    with open(broken, "w") as f:
        f.write(dump_yaml(dict(sweep.raw, parameters=dict(sweep.raw["parameters"],
                                                          heads={"values": [3]}))))
    code, text = _exit_code("evaluate check broken", cli_train.main,
                            [broken, "--check", "--max-runs", "1"])
    errors = [line for line in text.splitlines() if line.startswith("ERROR: run-0 {")]
    if code == 0 or not errors or "'heads': 3" not in errors[0] or "heads 3" not in errors[0]:
        raise AssertionError(f"evaluate check broken: exit {code}, {text!r}")
    log(f"evaluate check broken: a copy of {MAVEN_LITE} with heads 3: exit {code}")
    del models, sup_model
    torch.cuda.empty_cache()
    log(f"evaluate: launches per route {COUNT_NAMES}: {total}; card {card}")
    log(f"evaluate: phase done in {time.perf_counter() - t_phase:.1f} s")
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


# phase ensemble: k-fold, seed and lr members as one stacked program
# (training/ensemble.py) on phase ingest's tree, and the flash kernels under vmap
ENSEMBLE_EPOCHS, ENSEMBLE_STEPS, ENSEMBLE_TIMED = 2, 5, 6
MEMBER_EPOCHS = 1  # (d)'s lr x seed x fold grid, and phase tp (e)'s
# members of the timed stacked step at B = 32 (N = 1, 2 and 8 were timed once; PERF.md
# section 5 keeps those rows)
ENSEMBLE_N = (5,)
ENSEMBLE_EMBED_TOL = 1e-4  # load_model's embeddings against the stacked member slice
# --parallel-members: the grid written from maven-lite (8 members)
ENSEMBLE_MEMBERS = {"lr": [3.716367614864064e-05, 1e-4], "seed": [0, 1], "foldnumber": [0, 1]}
# (route, dtype, (N, B, H, T, S)) of the vmap checks: maven-lite's LC and SP layers
ENSEMBLE_VMAP_CASES = tuple(
    (route, dtype, shape)
    for route, dtype in (("tf32", torch.float32), ("mma", torch.bfloat16),
                         ("simt", torch.float32))
    for shape in ((5, 32, 8, NBAND * LC_LEN, 8), (5, 32, 2, SP_LEN, 16)))
_ROUTE_PLACE = {"simt": 0, "mma": 2, "tf32": 12}  # the forward's place in _counts()


class _Stop(Exception):
    """Raised after an epoch's stacked checkpoint: a run stopped there."""


def _ensemble_vmap_case(route, dtype, shape, gen, shared_mask=False):
    """flash_attention under vmap (training, then no_grad) against N separate
    calls of the same route: outputs and dq/dk/dv bitwise, one launch each
    way per vmapped call on the route. Returns whether every tensor is equal."""
    n, b, h, t, s = shape
    emb = h * s

    def heads():  # the encoder's (B, T, H, S) views, a member axis in front
        return torch.randn((n, b, t, h, s), generator=gen, device=DEVICE).to(
            dtype).transpose(2, 3).requires_grad_()

    q, k, v = heads(), heads(), heads()
    mask = torch.rand((n, b, t), generator=gen, device=DEVICE) > 0.3
    mask[..., 0] = True
    if shared_mask:
        mask = mask[:1].expand(n, b, t).contiguous()
    g = torch.randn((n, b, t, h, s), generator=gen, device=DEVICE).to(dtype).transpose(2, 3)
    m_arg, m_dim = (mask[0], None) if shared_mask else (mask, 0)

    def call(q, k, v, m):
        return flash_mod.flash_attention(q, k, v, m, emb)

    place = _ROUTE_PLACE[route]
    want = tuple(1 if i in (place, place + 1) else 0 for i in range(14))
    with ROUTES[route]():
        _zero_counts()
        out = torch.func.vmap(call, in_dims=(0, 0, 0, m_dim))(q, k, v, m_arg)
        grads = torch.autograd.grad(out, (q, k, v), g)
        counts = _counts()
        _zero_counts()
        with torch.no_grad():
            ev = torch.func.vmap(call, in_dims=(0, 0, 0, m_dim))(q, k, v, m_arg)
        ev_counts = _counts()
        equal = True
        for i in range(n):
            qi, ki, vi = (a[i].detach().requires_grad_() for a in (q, k, v))
            oi = call(qi, ki, vi, mask[i])
            gi = torch.autograd.grad(oi, (qi, ki, vi), g[i])
            with torch.no_grad():
                ei = call(qi, ki, vi, mask[i])
            equal &= (torch.equal(oi, out[i]) and torch.equal(ei, ev[i])
                      and all(torch.equal(a, w[i]) for a, w in zip(gi, grads)))
    ev_want = tuple(1 if i == place else 0 for i in range(14))
    log(f"ensemble vmap {route} {str(dtype)[6:]} (N, B, H, T, S) = {shape}"
        f"{', one key mask for every member' if shared_mask else ''}: launches {counts} "
        f"(want {want}), no_grad {ev_counts} (want {ev_want}); out, dq, dk, dv and the "
        f"no_grad out bitwise those of {n} separate calls: {equal}")
    if counts != want or ev_counts != ev_want or not equal:
        raise AssertionError(f"ensemble vmap {route} {shape}: launches {counts} / "
                             f"{ev_counts}, bitwise {equal}")


# (kernel, route, dtype, (N, B, T, E, H)) of the fused kernels' stacked checks at
# maven-lite's widths, N = 5, B = 32: the light-curve blocks (the fused block takes
# E >= 64) and, for the fused QKV, the spectral tower's at Maven's T = 220 too.
# float32 reaches 3b/4b and 5a/6a, bf16 3a/4a and 5b/6b: every route of kernels 3-6
ENSEMBLE_FUSED_CASES = (
    ("ffn", "mma", torch.float32, (5, 32, NBAND * LC_LEN, 64, 8)),
    ("ffn", "simt", torch.bfloat16, (5, 32, NBAND * LC_LEN, 64, 8)),
    *(("qkv", route, dtype, shape)
      for route, dtype in (("simt", torch.float32), ("mma", torch.bfloat16))
      for shape in ((5, 32, NBAND * LC_LEN, 64, 8), (5, 32, TRAIN_SP_LEN, 32, 2))))
# a kernel's forward place in _counts() on each route; the backward's is the next
_FUSED_PLACE = {("ffn", "simt"): 4, ("ffn", "mma"): 10, ("qkv", "simt"): 6, ("qkv", "mma"): 8}
# the stacked launch against N separate launches, device time of ENSEMBLE_FUSED_ITERS calls
ENSEMBLE_FUSED_ITERS = 10
# device ops of one launch of each fused route, forward and backward: the kernel, and in
# a backward its reduce (the tensor-core FFN backward: the row kernel, two LayerNorm
# reduces, three weight-gradient kernels and their reduces), whatever the member count
_FUSED_OPS = {("ffn", "simt"): (1, 2), ("ffn", "mma"): (1, 9), ("qkv", "simt"): (1, 2),
              ("qkv", "mma"): (1, 2)}
WRONG_MEMBER = "member 0's parameters for every member"


def _member0_weights(kernel):
    """``stack_members`` of the fused vmap rules with a broken member offset:
    every member's parameters replaced by member 0's, as a kernel that
    ignored the member index for them would read (the control of the
    bitwise check)."""
    real, first = ffn_mod.stack_members, 2  # both kernels: x (and att / mask) first

    def broken(info, in_dims, args):
        n, stacked = real(info, in_dims, args)
        return n, tuple(a if i < first else a[:1].expand_as(a).contiguous()
                        for i, a in enumerate(stacked))

    return mock.patch.object(ffn_mod if kernel == "ffn" else qkv_mod, "stack_members", broken)


def _fused_stacked_inputs(kernel, dtype, shape, gen):
    """(args of the public call, the indices of its differentiable leaves,
    the call, the cotangent) with a member axis in front of every tensor."""
    n, b, t, e, h = shape

    def r(*sh, scale=1.0, shift=0.0):
        return torch.randn(sh, generator=gen, device=DEVICE) * scale + shift

    if kernel == "ffn":
        f = 4 * e
        params = [r(n, e, e, scale=e ** -0.5), r(n, e, scale=0.1), r(n, e, scale=0.1, shift=1.0),
                  r(n, e, scale=0.1), r(n, f, e, scale=e ** -0.5), r(n, f, scale=0.1),
                  r(n, e, f, scale=f ** -0.5), r(n, e, scale=0.1), r(n, e, scale=0.1, shift=1.0),
                  r(n, e, scale=0.1)]
        args = (r(n, b * t, e).to(dtype), r(n, b * t, e).to(dtype), *params)
        return args, tuple(range(12)), ffn_mod.fused_ffn_block, r(n, b * t, e).to(dtype)
    mask = torch.rand((n, b, t), generator=gen, device=DEVICE) > 0.3
    mask[..., 0] = True
    args = (r(n, b, t, e).to(dtype), mask, *(r(n, e, e, scale=e ** -0.5) for _ in range(4)),
            r(n, e, scale=0.1))

    def call(x, m, wq, wk, wv, wu, bu):
        return qkv_mod.fused_qkv_attention(x, m, wq, wk, wv, wu, bu, h, e)

    return args, (0, 2, 3, 4, 5, 6), call, r(n, b, t, e).to(dtype)


def _whole_trace_ms(fn, iters, ops, tries=3):
    """``_device_ms`` of a trace that holds all ``ops`` device ops of each of
    its ``iters`` calls: torch.profiler at times loses some of a trace's
    ops (seen in this phase: a stacked reading at 0.41x of its others), so
    a trace short of any is taken again, up to ``tries`` times; raises if
    none holds them all."""
    seen = []
    for _ in range(tries):
        got = _device_ops(fn, iters)
        if len(got) == iters * ops:
            return sum(ms for _, ms in got) / iters
        seen.append(len(got))
    raise AssertionError(f"torch.profiler traces held {seen} device ops, want {iters * ops}")


def _fused_device_times(kernel, route, args, g, n, h):
    """Device ms of the stacked launch each way (the wrappers given
    ``members``) and of n separate launches of the same route, one member
    each, each from a trace that holds every launch's ops (_FUSED_OPS):
    {"fwd": (stacked, separate), "bwd": (stacked, separate)}."""
    if kernel == "ffn":
        phys = args

        def fwd(a, m=None):
            return ffn_mod._ffn_fwd(*a, eps=ffn_mod.LN_EPS, members=m)

        def bwd(a, gg, m=None):
            return ffn_mod.fused_ffn_block_bwd(*a, gg, members=m)
    else:
        x, mask, wq, wk, wv, wu, bu = args
        scale = float(x.shape[-1]) ** -0.25
        phys = (x, mask, torch.cat([wq * scale, wk * scale, wv], dim=1), wu, bu)

        def fwd(a, m=None):
            return qkv_mod._qkv_fwd(*a, h, m)

        def bwd(a, gg, m=None):
            return qkv_mod.fused_qkv_attention_bwd(*a[:4], gg, h, m)

    def member(i):
        return tuple(a[i] for a in phys)

    iters, (fwd_ops, bwd_ops) = ENSEMBLE_FUSED_ITERS, _FUSED_OPS[(kernel, route)]
    with torch.no_grad():
        return {"fwd": (_whole_trace_ms(lambda: fwd(phys, n), iters, fwd_ops),
                        _whole_trace_ms(lambda: [fwd(member(i)) for i in range(n)], iters,
                                        n * fwd_ops)),
                "bwd": (_whole_trace_ms(lambda: bwd(phys, g, n), iters, bwd_ops),
                        _whole_trace_ms(lambda: [bwd(member(i), g[i]) for i in range(n)], iters,
                                        n * bwd_ops))}


def _members_bitwise(out, grads, ev, separate):
    """Whether the stacked output, gradients and (unless ``ev`` is None) the
    no-grad output are bitwise each member's separate call's."""
    return all(torch.equal(oi, out[i]) and (ev is None or torch.equal(ei, ev[i]))
               and all(torch.equal(a, w[i]) for a, w in zip(gi, grads))
               for i, (oi, gi, ei) in enumerate(separate))


def _ensemble_fused_case(kernel, route, dtype, shape, gen, control=False):
    """A fused kernel under vmap (training, then no_grad) through its public
    call, every member with its own parameters, against N separate calls of
    the same route: outputs and every gradient bitwise, one launch each way
    per vmapped call on the route's counter (the no-grad call on the
    forward's only); the stacked results within the route's tolerance of
    the plain version, member by member (the tensor-core fused-block
    backward on the kernel's own ReLU mask; the bf16 fused QKV's dWq, dWk
    and dWv, the thirds of dWqkv, each held to NORM_TOL). ``control``: the
    same with WRONG_MEMBER, which must fail the bitwise check. Returns
    (forward, backward max|err| against the plain version)."""
    n, b, t, e, h = shape
    dtype_name = str(dtype)[6:]
    tag = (f"ensemble fused {kernel} {route} {dtype_name} (N, B, T, E, H) = {shape}")
    args, leaf_idx, call, g = _fused_stacked_inputs(kernel, dtype, shape, gen)
    leaves = [args[i].requires_grad_() for i in leaf_idx]
    place = _FUSED_PLACE[(kernel, route)]
    want = tuple(1 if i in (place, place + 1) else 0 for i in range(14))
    ev_want = tuple(1 if i == place else 0 for i in range(14))
    routes = FFN_ROUTES if kernel == "ffn" else QKV_ROUTES

    def stacked():
        out = torch.func.vmap(call)(*args)
        return out, torch.autograd.grad(out, leaves, g)

    with routes[route](), _ffn_kernel_mask() as spied:
        _zero_counts()
        out, grads = stacked()
        counts = _counts()
        out, h_kernel = out.detach(), spied.get("h")
        _zero_counts()
        with torch.no_grad():
            ev = torch.func.vmap(call)(*args)
        ev_counts = _counts()
        separate = []
        for i in range(n):
            ai = [a[i].detach() for a in args]
            li = [ai[j].requires_grad_() for j in leaf_idx]
            oi = call(*ai)
            gi = torch.autograd.grad(oi, li, g[i])
            with torch.no_grad():
                separate.append((oi, gi, call(*ai)))
        equal = _members_bitwise(out, grads, ev, separate)
        wrong = None
        if control:
            with _member0_weights(kernel):
                wrong = _members_bitwise(*stacked(), None, separate)
    del separate
    # the plain version, member by member
    worst, bwd_worst, said = 0.0, 0.0, []
    if kernel == "ffn":
        plain, plain_bwd = ffn_mod.fused_ffn_block_plain, ffn_mod.fused_ffn_block_bwd_plain
        rel_worst, norm_worst = 0.0, None
        for i in range(n):
            ai = [a[i].detach() for a in args]
            want_out = plain(*ai)
            torch.testing.assert_close(out[i].float(), want_out.float(), rtol=TOL[dtype_name],
                                       atol=TOL[dtype_name], msg=lambda m: f"{tag}: {m}")
            worst = max(worst, float((out[i].float() - want_out.float()).abs().max()))
            if dtype == torch.float32:
                _check_norm(out[i], want_out, f"{tag} member {i}", FP32_NORM_TOL)
            mask = None if h_kernel is None else h_kernel[i] > 0
            want_g = plain_bwd(*ai, g[i], relu_mask=mask)
            err, rel, ne = _ffn_bwd_check(f"ensemble member {i}", dtype_name, route,
                                          [gr[i] for gr in grads], want_g)
            bwd_worst, rel_worst = max(bwd_worst, err), max(rel_worst, max(rel))
            norm_worst = ne if norm_worst is None or ne is None else max(norm_worst, ne)
        said.append(f"backward max|err|/max|plain| {rel_worst:.3e} (tol {GRAD_TOL[dtype_name]})"
                    + ("" if norm_worst is None else
                       f", ||err||/||plain|| {norm_worst:.3e} (tol {FP32_NORM_TOL})"))
    else:
        with _plain_kernels():
            want_out, want_g = stacked()
        want_out = want_out.detach()
        torch.testing.assert_close(out.float(), want_out.float(), rtol=TOL[dtype_name],
                                   atol=TOL[dtype_name], msg=lambda m: f"{tag}: {m}")
        worst = float((out.float() - want_out.float()).abs().max())
        names = ("dx", "dWq", "dWk", "dWv", "dWu", "dbu")
        rel = {}
        for name, a, w in zip(names, grads, want_g):
            rel[name] = max(float((a[i].float() - w[i].float()).abs().max())
                            / float(w[i].float().abs().max()) for i in range(n))
            bwd_worst = max(bwd_worst, float((a.float() - w.float()).abs().max()))
        if max(rel.values()) > GRAD_TOL[dtype_name]:
            raise AssertionError(f"{tag}: max|err|/max|plain| {rel} (tol {GRAD_TOL[dtype_name]})")
        said.append("backward max|err|/max|plain| " + " ".join(
            f"{k} {v:.3e}" for k, v in rel.items()))
        if dtype == torch.bfloat16:  # dWq, dWk, dWv: the thirds of dWqkv, each on its own
            norms = {name: max(_check_norm(a[i], w[i], f"{tag} member {i} {name}") or 0.0
                               for i in range(n))
                     for name, a, w in (("out", out, want_out), *zip(names, grads, want_g))}
            said.append("||err||/||plain|| " + " ".join(f"{k} {v:.3e}" for k, v in norms.items())
                        + f" (tol {NORM_TOL}; dWq, dWk, dWv the thirds of dWqkv)")
    log(f"{tag}: launches {counts} (want {want}), no_grad {ev_counts} (want {ev_want}); out, "
        f"every gradient and the no_grad out bitwise those of {n} separate calls: {equal}"
        + ("" if wrong is None else f"; {WRONG_MEMBER}: bitwise {wrong} (must be False)")
        + f"; against the plain version forward max|err| {worst:.3e} (tol {TOL[dtype_name]}), "
        + f"backward max|err| {bwd_worst:.3e}, " + "; ".join(said))
    if counts != want or ev_counts != ev_want or not equal or wrong:
        raise AssertionError(f"{tag}: launches {counts} / {ev_counts}, bitwise {equal}, "
                             f"{WRONG_MEMBER} bitwise {wrong}")
    return worst, bwd_worst


def _ensemble_fused_times(card, gen):
    """Device ms a call of each fused route's stacked launch (the first
    shape of ENSEMBLE_FUSED_CASES for it) against N separate launches, on a
    quiet card: {(kernel, route): {"times", "shape", "dtype"}}."""
    out = {}
    for kernel, route, dtype, shape in ENSEMBLE_FUSED_CASES:
        if (kernel, route) in out:
            continue
        args, _, _, g = _fused_stacked_inputs(kernel, dtype, shape, gen)
        with (FFN_ROUTES if kernel == "ffn" else QKV_ROUTES)[route]():
            times = _fused_device_times(kernel, route, args, g, shape[0], shape[-1])
        out[(kernel, route)] = {"times": times, "shape": shape, "dtype": str(dtype)[6:]}
        log(f"ensemble fused {kernel} {route} {str(dtype)[6:]} (N, B, T, E, H) = {shape}: "
            f"device ms a call, the stacked launch / {shape[0]} separate launches: forward "
            f"{times['fwd'][0]:.4f} / {times['fwd'][1]:.4f}, backward {times['bwd'][0]:.4f} / "
            f"{times['bwd'][1]:.4f} ({ENSEMBLE_FUSED_ITERS} calls each); card {card}")
    return out


def _recording_dropout(seen, n):
    """``transformer_mod.dropout`` that keeps the first ``n`` keep masks it
    draws (the draw and the result are dropout's own)."""
    real = transformer_mod.dropout

    def drop(x, rate, train, generator):
        if not train or rate == 0.0 or rate >= 1.0:
            return real(x, rate, train, generator)
        keep = torch.empty(x.shape, device=x.device).bernoulli_(
            1.0 - rate, generator=generator).bool()
        if len(seen) < n:
            seen.append(keep)
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                               device=x.device))
    return drop


@contextlib.contextmanager
def _recorded_member_losses():
    """A context in which every stacked epoch runner appends its epoch's (N,
    steps) losses (host) to the list it yields."""
    real, recorded = ensemble_mod.make_ensemble_epoch_runner, []

    def make(*args, **kwargs):
        run = real(*args, **kwargs)

        def run_epoch(*a):
            state, losses = run(*a)
            recorded.append(losses.cpu())
            return state, losses
        return run_epoch

    with mock.patch.object(ensemble_mod, "make_ensemble_epoch_runner", make):
        yield recorded


def _ensemble_members(sweep, points, ds, folds, epochs=None):
    """(members, their models on the card, the task, freeze and trainer config
    of the first point): run_sweep's parallel path's build of ``points``
    (``epochs``: its epochs_override)."""
    extra = sweep.extra_args
    members, models, first = [], [], None
    for k, p in enumerate(points):
        seed = int(p.get("seed", 0))
        set_seed(seed)
        tr, va = split_for_run(len(ds), float(extra.get("val_fraction", 0.2)), seed,
                               folds=folds, foldnumber=p.get("foldnumber"))
        model, task, freeze, override, tcfg = _build_run(p, extra, NBAND, None, epochs)
        if override is not None:
            model.load_state_dict(override(model.state_dict()), strict=True)
        first = first or (task, freeze, tcfg)
        members.append(ensemble_mod.Member(f"run-{k}", seed, tr, va, lr=float(p["lr"])))
        models.append(model.to(DEVICE))
    return (members, models, *first)


def _ensemble_first_steps(tag, sweep, points, ds, folds, per_step):
    """The first ENSEMBLE_STEPS stacked steps of ``points`` (float32, the
    config's noise and dropout) against each member's sequential kernel-path
    steps (Trainer.fit's epoch runner on its own split, plan and generator):
    losses within relative TRAJ_RTOL a step, and the first step's dropout
    keep masks bitwise. Returns the stacked steps' launches."""
    extra = sweep.extra_args
    members, models, _, freeze, tcfg = _ensemble_members(sweep, points, ds, folds)
    b = tcfg.batch_size
    own = [-(-len(m.train_indices) // b) for m in members]
    data = ds.to_device(DEVICE)
    plans = np.stack([ensemble_mod.member_train_plan(m, b, np.random.default_rng(m.seed),
                                                     max(own))[:ENSEMBLE_STEPS]
                      for m in members])
    recipe = dict(weight_decay=tcfg.weight_decay, step_size=tcfg.step_size,
                  gamma=tcfg.gamma, steps_per_epoch=max(own), freeze=freeze)
    state = ensemble_mod.stack_states(models, [m.lr for m in members], **recipe)
    run = ensemble_mod.make_ensemble_epoch_runner(
        models[0], tcfg.noise_level_mag, noise_level_img=tcfg.noise_level_img,
        rotate_images=tcfg.rotate_images)
    gens = [torch.Generator(device=DEVICE).manual_seed(m.seed + 1) for m in members]
    drawn, real_draw = [], ensemble_mod.draw_stacked_keep_masks

    def recording(specs, generators, device):
        masks = real_draw(specs, generators, device)
        if not drawn:
            drawn.append(masks)
        return masks

    with mock.patch.object(ensemble_mod, "draw_stacked_keep_masks", recording), \
            _plain_calls() as plain:
        _zero_counts()
        _, stacked = run(state, data, plans, gens)
        counts = _counts()
    first = drawn[0] if drawn else []  # at dropout 0 a step draws no keep mask
    _check_counts(f"{tag} stacked steps", counts, tuple(c * ENSEMBLE_STEPS for c in per_step))
    if plain:
        raise AssertionError(f"{tag}: {len(plain)} plain kernel calls")
    stacked = stacked.cpu().numpy()
    optimizer = type(state.optimizer).__name__
    del state, models, run
    torch.cuda.empty_cache()
    worst, masks_equal = 0.0, True
    for i, (m, p) in enumerate(zip(members, points)):
        set_seed(m.seed)
        model = _build_run(p, extra, NBAND, None, None)[0].to(DEVICE)
        opt, sched = build_optimizer(model.named_parameters(), lr=m.lr,
                                     **dict(recipe, steps_per_epoch=own[i]))
        local = epoch_indices(len(m.train_indices), b, rng=np.random.default_rng(m.seed),
                              shuffle=True, pad="wrap")[:ENSEMBLE_STEPS]
        seen = []
        with mock.patch.object(transformer_mod, "dropout", _recording_dropout(seen, len(first))):
            _, seq = make_epoch_runner(
                model, tcfg.noise_level_mag, noise_level_img=tcfg.noise_level_img,
                rotate_images=tcfg.rotate_images)(
                TrainState(model, opt, sched), ds.subset(m.train_indices).to_device(DEVICE),
                local, torch.Generator(device=DEVICE).manual_seed(m.seed + 1))
        seq = seq.cpu().numpy()
        rel = np.abs(stacked[i] - seq) / np.abs(seq)
        same = len(seen) == len(first) and all(torch.equal(a, w[i]) for a, w in zip(seen, first))
        worst, masks_equal = max(worst, float(rel.max())), masks_equal and same
        log(f"{tag} {m.name} (fold {p.get('foldnumber')}, seed {m.seed}, lr {m.lr:.6g}): "
            f"stacked {stacked[i].tolist()}, sequential {seq.tolist()}, worst relative "
            f"{rel.max():.3e} (tol {TRAJ_RTOL}); the first step's {len(seen)} dropout masks "
            + (f"(keep {first[0].float().mean().item():.6f} of the first) " if first else "")
            + f"bitwise: {same}")
        del model, opt
    log(f"{tag}: {len(members)} members ({optimizer} over the stacked leaves), "
        f"{ENSEMBLE_STEPS} steps, launches {counts}; worst relative {worst:.3e}; masks "
        f"bitwise {masks_equal}")
    if worst > TRAJ_RTOL or not masks_equal or not np.all(np.isfinite(stacked)):
        raise AssertionError(f"{tag}: worst relative {worst}, masks bitwise {masks_equal}")
    return counts


def _ensemble_bf16_steps(tag, sweep, points, ds, folds, per_step):
    """ENSEMBLE_STEPS stacked steps of ``points`` (bf16 compute) from their
    first plan: the launches of each step, every loss finite. Returns the
    launches."""
    members, models, _, freeze, tcfg = _ensemble_members(sweep, points, ds, folds)
    b = tcfg.batch_size
    own = [-(-len(m.train_indices) // b) for m in members]
    plans = np.stack([ensemble_mod.member_train_plan(m, b, np.random.default_rng(m.seed),
                                                     max(own))[:ENSEMBLE_STEPS]
                      for m in members])
    state = ensemble_mod.stack_states(models, [m.lr for m in members],
                                      weight_decay=tcfg.weight_decay, step_size=tcfg.step_size,
                                      gamma=tcfg.gamma, steps_per_epoch=max(own), freeze=freeze)
    run = ensemble_mod.make_ensemble_epoch_runner(models[0], tcfg.noise_level_mag)
    gens = [torch.Generator(device=DEVICE).manual_seed(m.seed + 1) for m in members]
    with _plain_calls() as plain:
        _zero_counts()
        _, losses = run(state, ds.to_device(DEVICE), plans, gens)
        counts = _counts()
    losses = losses.cpu().numpy()
    log(f"{tag}: {len(members)} members, {ENSEMBLE_STEPS} bf16 steps, losses "
        f"{losses.tolist()}; launches {counts}")
    _check_counts(f"{tag} stacked steps", counts, tuple(c * ENSEMBLE_STEPS for c in per_step))
    if plain or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: {len(plain)} plain kernel calls, losses {losses}")
    del state, models, run
    torch.cuda.empty_cache()
    return counts


def _ensemble_fused(tmp, sweep, ds, folds, argv, analysis):
    """(f) the five folds as one stacked program with the fused opt-ins:
    cli.train --parallel-folds on maven-lite at dropout 0 (the only rate at
    which the fused block takes a block) with MMSN_FUSED_BLOCK=1
    MMSN_FUSED_QKV=1, one epoch: the launches (the fused block on the five
    light-curve blocks, once a layer each way for all members; the
    spectral tower's T = 1024 stays on the flash kernels, as the attention
    inside the fused block does), the run dirs; the first steps against
    sequential fits with the same opt-ins; the same with MMSN_FUSED_QKV=1
    alone (the light-curve attention on the fused QKV); then the stacked
    steps of both in bf16. Returns the launches."""
    raw = sweep.raw
    lc, sp = SEQ_LC["depth"], SEQ_SP["depth"]

    def per_step(**places):  # launches a step: {forward place: count}, the backward's next
        return tuple(next((c for p, c in places.items() if i in (int(p[1:]), int(p[1:]) + 1)),
                          0) for i in range(14))

    # float32: the fused block on 3b/4b, flash on 3xTF32; the fused QKV on 5a/6a. The
    # fused block computes in its input's dtype, as the JAX package's does: under
    # compute_dtype bfloat16 the light-curve blocks still take float32 input
    opt_ins = {  # name: (environment, float32 step, bf16 step)
        "fused": ({"MMSN_FUSED_BLOCK": "1", "MMSN_FUSED_QKV": "1"},
                  per_step(p10=lc, p12=lc + sp), per_step(p10=lc, p12=lc, p2=sp)),
        "qkv": ({"MMSN_FUSED_QKV": "1"}, per_step(p6=lc, p12=sp), per_step(p8=lc, p2=sp))}
    grids = {}
    for name, extra in (("maven-lite-fused", {}), ("maven-lite-fused-bf16",
                                                   {"compute_dtype": "bfloat16"})):
        grids[name] = os.path.join(tmp, f"{name}.yaml")
        with open(grids[name], "w") as fh:
            fh.write(dump_yaml(dict(raw, parameters=dict(raw["parameters"], dropout={
                "values": [0.0]}), extra_args=dict(raw["extra_args"], **extra))))
    f_sweep, b_sweep = (load_sweep(grids[k]) for k in grids)
    points, b_points = list(expand_grid(f_sweep)), list(expand_grid(b_sweep))
    env, fused, _ = opt_ins["fused"]
    want, splits = _ensemble_cli_want(ds, folds, f_sweep, points, 1, fused)
    log(f"ensemble fused: MMSN_FUSED_BLOCK=1 MMSN_FUSED_QKV=1 cli.train "
        f"{grids['maven-lite-fused']} --parallel-folds (maven-lite; cut: dropout "
        f"{raw['parameters']['dropout']['values'][0]} -> 0, epochs 1000 -> 1)")
    with mock.patch.dict(os.environ, env):
        total, wall, _ = _cli_counted("ensemble fused", cli_train.main, [
            grids["maven-lite-fused"], *argv, "--analysis-path", os.path.join(analysis, "F"),
            "--epochs", "1"])
    _check_counts("ensemble fused", total, want)
    log(f"ensemble fused: {total[10]} + {total[11]} fused-block launches on the tensor cores "
        f"({lc} + {lc} a stacked step for {len(points)} members), {total[12]} + {total[13]} "
        f"3xTF32 flash launches; {wall:.1f} s")
    _ensemble_check_runs("ensemble fused", os.path.join(analysis, "F", "maven-lite-fused"),
                         points, splits, ds, 1)
    for name, (env, f32, bf16) in opt_ins.items():
        with mock.patch.dict(os.environ, env):
            counts = _ensemble_first_steps(f"ensemble {name} steps", f_sweep, points, ds, folds,
                                           f32)
            counts = tuple(a + c for a, c in zip(counts, _ensemble_bf16_steps(
                f"ensemble {name} bf16 steps", b_sweep, b_points, ds, folds, bf16)))
        total = tuple(a + c for a, c in zip(total, counts))
    return total


def _ensemble_cli_want(ds, folds, sweep, points, epochs, per_step):
    extra, b = sweep.extra_args, int(points[0]["batchsize"])
    splits = [split_for_run(len(ds), float(extra.get("val_fraction", 0.2)),
                            int(p.get("seed", 0)), folds=folds, foldnumber=p.get("foldnumber"))
              for p in points]
    steps = max(-(-len(tr) // b) for tr, _ in splits)
    val_steps = max(-(-len(va) // b) for _, va in splits)
    return _fit_want(per_step, epochs, steps, val_steps), splits


def _ensemble_check_runs(tag, sweep_dir, points, splits, ds, epochs):
    """Every member's run dir: the sequential run's files, its config, the
    fold's manifests, a row an epoch with the member's share of the
    throughput."""
    for k, (p, (tr, va)) in enumerate(zip(points, splits)):
        run = os.path.join(sweep_dir, f"run-{k}")
        files = set(os.listdir(run))
        rows = _metric_rows(run)
        with open(os.path.join(run, "config.yaml")) as fh:
            dumped = safe_load(fh.read())
        manifests = []
        for name, idx in (("train_filenames.txt", tr), ("val_filenames.txt", va)):
            with open(os.path.join(run, name)) as fh:
                manifests.append(fh.read().splitlines() == [ds.filenames[i] for i in idx])
        log(f"{tag} run-{k} (fold {p['foldnumber']}, seed {p['seed']}, lr {p['lr']:.6g}): "
            f"files {sorted(files)}; config and manifests its own: {dumped == p}, "
            f"{manifests}; " + "; ".join(
                f"epoch {r['epoch']} train_loss {r['train_loss']:.7f} val_loss "
                f"{r['val_loss']:.7f} AUC_val {r['AUC_val']:.4f} step "
                f"{r['step_time_s'] * 1e3:.3f} ms, {r['samples_per_s']:.1f} samples/s "
                f"({r['member_samples_per_s']:.1f} the member's)" for r in rows))
        if (not set(RUN_DIR_FILES) <= files or not any(f.startswith("epoch=") for f in files)
                or dumped != p or not all(manifests)
                or [r["epoch"] for r in rows] != list(range(epochs))
                or not all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
                           for r in rows)):
            raise AssertionError(f"{tag} run-{k}: files {sorted(files)}, config "
                                 f"{dumped == p}, manifests {manifests}, rows {rows}")


def _ensemble_serves(tag, sweep_dir, n, epochs, ds):
    """Each member's run dir through load_model (last.ckpt) against the
    stacked state's member slice (the ensemble checkpoint of the last epoch)
    run through vmap, on one batch: embeddings within ENSEMBLE_EMBED_TOL."""
    payload = torch.load(os.path.join(sweep_dir, "_ensemble-g0", f"epoch-{epochs - 1}.pt"),
                         map_location=DEVICE, weights_only=True)["cur"]
    template, _ = load_model(os.path.join(sweep_dir, "run-0"), device=DEVICE, which="last")
    wrapper = ensemble_mod._LossOf(template)
    params = {f"model.{k}": v for k, v in payload["params"].items()}
    buffers = {f"model.{k}": v for k, v in payload["buffers"].items()}
    batch = take(ds.to_device(DEVICE), torch.arange(32, device=DEVICE))

    def member(p, bu):
        return torch.func.functional_call(wrapper, (p, bu), (batch, False, DrawSource()))[1][
            "embeddings"]

    with torch.no_grad():
        stacked = torch.func.vmap(member)(params, buffers)
        worst = 0.0
        for k in range(n):
            model, _ = load_model(os.path.join(sweep_dir, f"run-{k}"), device=DEVICE,
                                  which="last")
            got = model.encode(batch)
            worst = max(worst, max(float((a - w[k]).abs().max()) for a, w in zip(got, stacked)))
    log(f"{tag}: load_model(run-k, which='last').encode of 32 samples against the stacked "
        f"member slice through vmap: worst {worst:.3e} (tol {ENSEMBLE_EMBED_TOL})")
    if worst > ENSEMBLE_EMBED_TOL:
        raise AssertionError(f"{tag}: served embeddings {worst} off the stacked member's")


def _ensemble_time(tag, card, members, models, seq_models, tcfg, data, per_step):
    """Host clock (median of ENSEMBLE_TIMED, each step ended by a synchronise,
    after 2 warm-up steps) and one profile of PROFILED_STEPS of the stacked
    step of ``models`` against N sequential steps of ``seq_models`` on the
    same batches. Returns (stacked ms, sequential ms, launches)."""
    n, b = len(members), tcfg.batch_size
    steps = max(-(-len(m.train_indices) // b) for m in members)
    plans = np.stack([ensemble_mod.member_train_plan(m, b, np.random.default_rng(m.seed),
                                                     steps)[:1] for m in members])
    state = ensemble_mod.stack_states(models, [tcfg.lr] * n, weight_decay=tcfg.weight_decay)
    run = ensemble_mod.make_ensemble_epoch_runner(models[0], tcfg.noise_level_mag)
    gens = [torch.Generator(device=DEVICE).manual_seed(m.seed + 1) for m in members]
    seq = [(TrainState(mm, build_optimizer(mm.named_parameters(), lr=tcfg.lr,
                                           weight_decay=tcfg.weight_decay)[0]),
            make_train_step(mm, tcfg.noise_level_mag),
            take(data, torch.from_numpy(plans[i, 0]).to(DEVICE)),
            torch.Generator(device=DEVICE).manual_seed(members[i].seed + 1))
           for i, mm in enumerate(seq_models)]
    results = {}
    _zero_counts()
    for kind, fn in (("stacked", lambda: run(state, data, plans, gens)),
                     ("sequential", lambda: [step(st, bt, g) for st, step, bt, g in seq])):
        for _ in range(2):
            fn()
        times = []
        for _ in range(ENSEMBLE_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        traced = _trace(fn, PROFILED_STEPS)
        results[kind] = (float(np.median(times)), times, traced)
    counts = _counts()
    calls = 2 + ENSEMBLE_TIMED + PROFILED_STEPS
    # a stacked step launches each kernel as often as one member's step does
    _check_counts(f"{tag} timed steps", counts, tuple(c * calls * (1 + n) for c in per_step))
    (ms, times, traced), (seq_ms, seq_times, seq_traced) = (results["stacked"],
                                                           results["sequential"])
    log(f"{tag}: N = {n} x B = {b} float32: the stacked step, host clock median {ms:.3f} ms "
        f"(quartiles {np.percentile(times, 25):.3f}-{np.percentile(times, 75):.3f}), device "
        f"{traced[0]:.3f} ms, idle share {traced[3]:.3f}, {traced[4]:.0f} device ops: "
        f"{n * b / ms * 1e3:.1f} samples/s over the members; {n} sequential steps, host "
        f"clock median {seq_ms:.3f} ms (quartiles {np.percentile(seq_times, 25):.3f}-"
        f"{np.percentile(seq_times, 75):.3f}), device {seq_traced[0]:.3f} ms, idle share "
        f"{seq_traced[3]:.3f}, {seq_traced[4]:.0f} device ops: {n * b / seq_ms * 1e3:.1f} "
        f"samples/s; stacked / sequential samples/s {seq_ms / ms:.3f}; card {card}")
    _log_trace(f"{tag} stacked profile", "stacked steps", *traced, at=f"N={n} B={b} float32")
    del state, run, seq
    torch.cuda.empty_cache()
    return ms, seq_ms, counts


def _ensemble_timing(card, ds, folds):
    """The stacked step at N in ENSEMBLE_N x B = 32 on maven-lite against N
    sequential steps of the same shapes (config_grid's N = 5 x B = 256 is
    no longer timed here, for the smoke's time limit)."""
    total = NONE
    for config, ns in ((MAVEN_LITE, ENSEMBLE_N),):
        sweep = load_sweep(config)
        point = next(expand_grid(sweep))
        for n in ns:
            points = [dict(point, seed=s, foldnumber=s % 5) for s in range(n)]
            members, models, _, _, tcfg = _ensemble_members(sweep, points, ds, folds)
            seq_models = _ensemble_members(sweep, points, ds, folds)[1]
            layers = models[0].cfg.tk()["depth"] + (
                models[0].cfg.tsk()["depth"] if "spectral" in models[0].cfg.combinations
                else 0)
            *_, counts = _ensemble_time(f"ensemble timing {os.path.basename(config)}", card,
                                        members, models, seq_models, tcfg,
                                        ds.to_device(DEVICE), _tf32_flash(layers, layers))
            total = tuple(a + c for a, c in zip(total, counts))
            del models, seq_models
            torch.cuda.empty_cache()
    return total


def phase_ensemble(card, tmp, quiet=None):
    """Stacked members on phase ingest's tree: (a) the flash kernels under
    vmap on every route, bitwise N separate calls, and the fused kernels
    (every route of kernels 3-6) the same way, with a broken member offset
    as the control; (b) cli.train configs/maven-lite.yaml --parallel-folds,
    the five folds as one program (epochs 1000 -> ENSEMBLE_EPOCHS), its
    launches, run dirs and load_model, and the first steps against
    sequential runs; (c) the same run stopped after epoch 0 and resumed,
    bitwise; (d) --parallel-members on an lr x seed x fold grid; (f) both
    fused opt-ins (_ensemble_fused); (e) the stacked step's times against
    sequential steps. Returns the launches of (b)-(f) and {(kernel, route):
    the fused stacked checks' max|err| against the plain version and device
    times}."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    for route, dtype, shape in ENSEMBLE_VMAP_CASES:
        _ensemble_vmap_case(route, dtype, shape, gen)
    _ensemble_vmap_case("tf32", torch.float32, ENSEMBLE_VMAP_CASES[0][2], gen, shared_mask=True)
    stacked = {}
    for kernel, route, dtype, shape in ENSEMBLE_FUSED_CASES:
        first = (kernel, route) not in stacked
        err, bwd_err = _ensemble_fused_case(kernel, route, dtype, shape, gen, control=first)
        entry = stacked.setdefault((kernel, route), {"fwd": 0.0, "bwd": 0.0})
        entry["fwd"], entry["bwd"] = max(entry["fwd"], err), max(entry["bwd"], bwd_err)

    data_dir, spectra_dir = os.path.join(tmp, "ZTFBTS"), os.path.join(tmp, "ZTFBTS_spectra")
    cache_dir, analysis = os.path.join(tmp, "cache"), os.path.join(tmp, "ensemble")
    sweep = load_sweep(MAVEN_LITE)
    extra = sweep.extra_args
    config = cli_common.ingest_config(data_dir, spectra_dir, extra, 1000)
    ds, hit = load_or_ingest(cache_dir, lambda: load_ztfbts(kfolds=None, **config)[0], **config)
    folds = stratified_kfolds(np.asarray(ds.arrays["label"]), int(extra["kfolds"]))
    points = list(expand_grid(sweep))
    layers = SEQ_LC["depth"] + SEQ_SP["depth"]
    per_step = _tf32_flash(layers, layers)
    argv = ["--data-dir", data_dir, "--spectra-dir", spectra_dir, "--cache-dir", cache_dir,
            "--device", DEVICE, "--parallel-folds"]

    # (b) the five folds as one program
    want, splits = _ensemble_cli_want(ds, folds, sweep, points, ENSEMBLE_EPOCHS, per_step)
    log(f"ensemble folds: cli.train {MAVEN_LITE} --parallel-folds on {len(ds)} samples "
        f"(cache hit {hit}); {len(points)} members (folds "
        f"{[p['foldnumber'] for p in points]}), train sizes {[len(s[0]) for s in splits]}, "
        f"B {points[0]['batchsize']}; cut: epochs {points[0]['epochs']} -> {ENSEMBLE_EPOCHS}")
    counts, wall, _ = _cli_counted("ensemble folds", cli_train.main, [
        MAVEN_LITE, *argv, "--analysis-path", os.path.join(analysis, "A"), "--epochs",
        str(ENSEMBLE_EPOCHS)])
    _check_counts("ensemble folds", counts, want)
    log(f"ensemble folds: {counts[12]} + {counts[13]} 3xTF32 flash launches (want {want[12:]})"
        f": {layers} + {layers} a stacked step for {len(points)} members; {wall:.1f} s")
    total = counts
    sweep_a = os.path.join(analysis, "A", "maven-lite")
    _ensemble_check_runs("ensemble folds", sweep_a, points, splits, ds, ENSEMBLE_EPOCHS)
    _ensemble_serves("ensemble folds", sweep_a, len(points), ENSEMBLE_EPOCHS, ds)
    total = tuple(a + c for a, c in zip(
        total, _ensemble_first_steps("ensemble folds steps", sweep, points, ds, folds,
                                     per_step)))

    # (c) stopped after epoch 0, resumed
    real_save = ensemble_mod.EnsembleCheckpoint.save

    def stop_after_first(self, epoch, *args, **kw):
        real_save(self, epoch, *args, **kw)
        if epoch == 0:
            raise _Stop()

    def stopped_main(args):
        with mock.patch.object(ensemble_mod.EnsembleCheckpoint, "save", stop_after_first):
            try:
                cli_train.main(args)
            except _Stop:
                print("stopped after epoch 0's stacked checkpoint")

    r_argv = [*argv, "--analysis-path", os.path.join(analysis, "R"), "--epochs",
              str(ENSEMBLE_EPOCHS)]
    first, _, _ = _cli_counted("ensemble resume (stopped)", stopped_main, [MAVEN_LITE, *r_argv])
    sweep_r = os.path.join(analysis, "R", "maven-lite")
    second, _, _ = _cli_counted("ensemble resume", cli_train.main,
                                [sweep_r, *r_argv, "--resume"])
    one = _ensemble_cli_want(ds, folds, sweep, points, 1, per_step)[0]
    _check_counts("ensemble resume (stopped)", first, one)
    _check_counts("ensemble resume", second, one)
    total = tuple(a + b + c for a, b, c in zip(total, first, second))
    same = True
    for k in range(len(points)):
        ra = [(r["train_loss"], r["val_loss"], r["AUC_val"])
              for r in _metric_rows(os.path.join(sweep_a, f"run-{k}"))]
        rb = [(r["train_loss"], r["val_loss"], r["AUC_val"])
              for r in _metric_rows(os.path.join(sweep_r, f"run-{k}"))]
        a = torch.load(os.path.join(sweep_a, f"run-{k}", "last.ckpt"), weights_only=True)
        b = torch.load(os.path.join(sweep_r, f"run-{k}", "last.ckpt"), weights_only=True)
        sd_same = all(torch.equal(v, b["state_dict"][n]) for n, v in a["state_dict"].items())
        opt_same = all(torch.equal(v[key], b["optimizer_states"][0]["state"][p][key])
                       for p, v in a["optimizer_states"][0]["state"].items()
                       for key in ("exp_avg", "exp_avg_sq"))
        log(f"ensemble resume run-{k}: rows {rb}; the uninterrupted run's {ra}; equal: "
            f"{ra == rb}; last.ckpt state_dict bitwise {sd_same}, RAdam moments bitwise "
            f"{opt_same}")
        same &= ra == rb and sd_same and opt_same
    if not same:
        raise AssertionError("ensemble resume: the resumed run differs from the uninterrupted")

    # (d) seeds and learning rates as members too
    raw = sweep.raw
    grid = os.path.join(tmp, "maven-lite-members.yaml")
    with open(grid, "w") as fh:
        fh.write(dump_yaml(dict(raw, parameters=dict(raw["parameters"], **{
            k: {"values": v} for k, v in ENSEMBLE_MEMBERS.items()}),
            extra_args=dict(raw["extra_args"], nruns=8))))
    m_sweep = load_sweep(grid)
    m_points = list(expand_grid(m_sweep))
    want, m_splits = _ensemble_cli_want(ds, folds, m_sweep, m_points, MEMBER_EPOCHS,
                                        per_step)
    log(f"ensemble members: cli.train --parallel-members on {grid} (maven-lite with lr "
        f"{ENSEMBLE_MEMBERS['lr']} x seed {ENSEMBLE_MEMBERS['seed']} x folds "
        f"{ENSEMBLE_MEMBERS['foldnumber']}, nruns 5 -> 8); cut: epochs 1000 -> "
        f"{MEMBER_EPOCHS}")
    with _recorded_member_losses() as recorded:
        counts, wall, _ = _cli_counted("ensemble members", cli_train.main, [
            grid, *[a for a in argv if a != "--parallel-folds"], "--parallel-members",
            "--analysis-path", os.path.join(analysis, "M"), "--epochs", str(MEMBER_EPOCHS)])
    # each member's per-step losses: phase tp (e) holds the member axis over ranks to them
    torch.save(torch.cat(recorded, dim=1), os.path.join(tmp, "ensemble-members-losses.pt"))
    _check_counts("ensemble members", counts, want)
    total = tuple(a + c for a, c in zip(total, counts))
    _ensemble_check_runs("ensemble members", os.path.join(analysis, "M", "maven-lite-members"),
                         m_points, m_splits, ds, MEMBER_EPOCHS)
    total = tuple(a + c for a, c in zip(
        total, _ensemble_first_steps("ensemble members steps", m_sweep, m_points, ds, folds,
                                     per_step)))

    # (f) both fused opt-ins, float32 and bf16
    total = tuple(a + c for a, c in zip(total, _ensemble_fused(
        tmp, sweep, ds, folds, argv, analysis)))

    # (e) the stacked step against sequential steps, once ``quiet`` has waited for
    # whatever runs beside
    if quiet is not None:
        quiet()
    for key, times in _ensemble_fused_times(card, gen).items():
        stacked[key].update(times)
    total = tuple(a + c for a, c in zip(total, _ensemble_timing(card, ds, folds)))
    log(f"ensemble: launches per route {COUNT_NAMES}: {total}; card {card}")
    log(f"ensemble: phase done in {time.perf_counter() - t_phase:.1f} s")
    return total, stacked


# phase dp: data-parallel training (parallel/, Trainer(mesh=...)) on two gloo
# ranks that share the card (NCCL refuses two ranks on one device) against the
# one-process fit, then the umbrella CLI under torchrun (a one-rank NCCL group)
# with --profile-dir. Phase tp's groups of ranks run on the same workers
# (``--dp-rank GROUP R TMP``), started with phase dp's and running beside it.
DP_EPOCHS, DP_STEPS, DP_TIMED = 2, 3, 6
# JAX tests/test_dp_equivalence.py's tolerances (rtol = atol), and Maven's per step
DP_LOSS_TOL, DP_PARAM_TOL, DP_MAVEN_RTOL = 2e-5, 5e-5, 1e-5
DP_TIMEOUT_S, DP_GROUP_TIMEOUT_S = 300, 120  # a rank's subprocess, a collective
DP_CONFIGS = {"maven-lite": MAVEN_LITE, "trimodal": TRIMODAL, "maven-pretrain": MAVEN_PRETRAIN}
# job: (its config in DP_CONFIGS, the grid point's overrides, Trainer.fit's epochs, or
# None for DP_STEPS counted steps); "fused" is maven-lite at dropout 0, the only rate
# at which MMSN_FUSED_BLOCK=1 routes a block through the fused kernels
DP_JOBS = {"maven-lite": ("maven-lite", {}, DP_EPOCHS),
           "trimodal": ("trimodal", {}, DP_EPOCHS),
           "maven-pretrain": ("maven-pretrain", {}, None),
           "maven-lite-1": ("maven-lite", {}, 1),
           "trimodal-steps": ("trimodal", {}, None),
           "fused": ("maven-lite", {"dropout": 0.0}, None)}
TP_LOSS_TOL = TP_PARAM_TOL = 5e-5  # JAX tests/test_dp_equivalence.py:test_dp_tp_matches_...
TP_MEMBER_RTOL = 1e-5  # JAX tests/test_ensemble.py:test_fit_members_sharded_member_axis
TP_TIMED_STEPS = 3  # host-clock steps and profiled steps of a tp rank (a Maven rank's take 2 s)
# a phase's (loss, parameter) tolerances and its ranks' (host-clock, profiled) steps
DP_TOLS = {"dp": (DP_LOSS_TOL, DP_PARAM_TOL), "tp": (TP_LOSS_TOL, TP_PARAM_TOL)}
DP_TIMING = {"dp": (DP_TIMED, PROFILED_STEPS), "tp": (TP_TIMED_STEPS, TP_TIMED_STEPS)}
# group: (the phase that checks it, its (n_data, n_model) mesh, its jobs); each group
# is a process group of its own; phase stream-dp starts and checks "stream" alone.
# "1x2" runs Maven (B = 1024 on each rank) first, while phase dp fits maven-lite, so
# that its Maven steps and phase dp's (B = 512 on each of two ranks, and B = 1024 in
# this process) do not meet on the card
DP_GROUPS = {"2x1": ("dp", (2, 1), ("maven-lite", "trimodal", "maven-pretrain")),
             "members": ("tp", (2, 1), ("members",)),
             "2x2": ("tp", (2, 2), ("maven-lite-1",)),
             "1x2": ("tp", (1, 2), ("maven-pretrain", "trimodal-steps", "fused")),
             "stream": ("stream-dp", (2, 1), tuple(STREAM_DP_JOBS))}
# groups whose jobs start only once their phase's one-process runs are done (so
# that their steps' host clock does not meet the one process's on the card)
DP_AFTER_REFS = ("stream",)
DP_UNTIMED = ("members", "fused", *STREAM_DP_JOBS)
DP_CLI_N = 320  # transients of the torchrun run's tree, so that its trace stays short
DP_FLASH = ("flash_attention_fwd_tf32", "flash_attention_bwd_dq_tf32",
            "flash_attention_bwd_dkdv_tf32")


def _dp_setup(name, tmp, epochs=DP_EPOCHS, **point):
    """The model (on the host), task, trainer config and train/val sets of a
    config in DP_CONFIGS, built alike in every process from its first grid
    point (with ``point`` laid over it): maven-lite on phase ingest's tree
    in ``tmp`` (its fold, through the cache), trimodal on phase towers'
    synthetic set, Maven pretraining on phase maven's."""
    sweep = load_sweep(DP_CONFIGS[name])
    point, extra = dict(next(expand_grid(sweep)), **point), sweep.extra_args
    model, task, _, _, tcfg = _build_run(point, extra, NBAND, None, epochs)
    sp_len = int(extra["max_spectral_data_len"])
    if name == "maven-lite":
        config = cli_common.ingest_config(os.path.join(tmp, "ZTFBTS"),
                                          os.path.join(tmp, "ZTFBTS_spectra"), extra, 1000)
        ds, _ = load_or_ingest(os.path.join(tmp, "cache"),
                               lambda: load_ztfbts(kfolds=None, **config)[0], **config)
        folds = stratified_kfolds(ds.arrays["label"], int(extra["kfolds"]))
        inds = split_for_run(len(ds), float(extra.get("val_fraction", 0.2)),
                             int(point.get("seed", 0)), folds=folds,
                             foldnumber=point.get("foldnumber"))
        train, val = (ds.subset(i) for i in inds)
    elif name == "trimodal":
        ds = make_synthetic_dataset(n=TOWERS_N, n_max_lc=LC_LEN, nband=NBAND, n_max_sp=sp_len,
                                    image_size=IMAGE_SIZE, modalities=model.cfg.combinations,
                                    seed=0)
        train, val = _split(ds, extra["val_fraction"])
    else:
        train, val = _maven_split(MAVEN_N, sp_len, model.cfg.combinations,
                                  extra["val_fraction"])
    return model, task, tcfg, train, val


def _dp_per_step(name, model):
    """Launches a train step: 18 + 18 3xTF32 flash, and under the fused opt-in
    the LC tower's fused forward and backward on the tensor cores."""
    layers = model.cfg.tk()["depth"] + model.cfg.tsk()["depth"]
    c = _tf32_flash(layers, layers)
    if name != "fused":
        return c
    f = model.cfg.tk()["depth"]
    return (0,) * 10 + (f, f) + c[12:]


def _dp_grads(model, batch, mesh):
    """Every parameter's gradient (this rank's slice where it is split) of one
    train-mode loss on ``batch`` from the current weights, and its launches."""
    _zero_counts()
    loss, _ = model.loss_fn(batch, train=True, generator=_dp_draws(5, mesh),
                            **({} if mesh is None else {"mesh": mesh}))
    loss.backward()
    counts = _counts()
    grads = {n: p.grad.detach().to("cpu", copy=True) for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return grads, counts


def _dp_fit(name, tmp, mesh=None):
    """One job of DP_JOBS in this process, as a rank of ``mesh`` or (None) as
    the one-process reference, from ``_dp_init``'s weights of its config:
    the counted Trainer.fit, or DP_STEPS counted steps (the fused opt-in
    also every gradient of one loss first). Returns the losses (or the
    history), the final state_dict gathered whole (host), the launches and
    plain calls, and what ``_dp_time`` needs."""
    base, point, epochs = DP_JOBS[name]
    model, task, tcfg, train, val = _dp_setup(base, tmp, epochs=epochs or DP_EPOCHS, **point)
    model.load_state_dict(torch.load(os.path.join(tmp, "dp", f"{base}.init.pt"),
                                     weights_only=True))
    model.to(DEVICE)
    b = tcfg.batch_size
    cols = slice(None) if mesh is None else mesh.block(b)
    data = train.to_device(DEVICE)
    out = {}
    with mock.patch.dict(os.environ, {"MMSN_FUSED_BLOCK": "1"} if name == "fused" else {}), \
            _plain_calls() as plain:
        if epochs:
            _zero_counts()
            t0 = time.perf_counter()
            res = Trainer(model, task, tcfg, mesh=mesh).fit(train, val)
            state = res["state"]
            out["history"], out["rows"] = res["history"], res["metric_rows"]
        else:
            if mesh is not None:
                shard_module(model, mesh)
            plan = epoch_indices(len(train), b, rng=np.random.default_rng(tcfg.seed),
                                 shuffle=True, pad="wrap")[:DP_STEPS, cols]
            if name == "fused":
                out["grads"], out["grad_counts"] = _dp_grads(
                    model, take(data, torch.from_numpy(plan[0]).to(DEVICE)), mesh)
            opt, sched = build_optimizer(model.named_parameters(), lr=tcfg.lr,
                                         weight_decay=tcfg.weight_decay)
            state = TrainState(model, opt, sched)
            _zero_counts()
            t0 = time.perf_counter()
            with batch_stats_over(model, mesh):
                state, losses = make_epoch_runner(
                    model, tcfg.noise_level_mag, noise_level_img=tcfg.noise_level_img,
                    mesh=mesh)(state, data, plan, _dp_draws(2, mesh))
            out["losses"] = losses.cpu().tolist()
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        out["counts"] = _counts()
    out["plain"] = len(plain)
    out["state_dict"] = {k: v.detach().to("cpu", copy=True)
                         for k, v in gather_state_dict(model).items()}
    out["steps"], out["batch"], out["epochs"] = (-(-len(train) // b), -(-len(val) // b)), b, \
        epochs
    out["per_step"] = _dp_per_step(name, model)
    one = take(data, torch.arange(b, device=DEVICE)[cols])
    return out, (model, tcfg, state, one)


def _dp_draws(seed, mesh):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return gen if mesh is None else RankRows(gen, mesh)


def _dp_time(job, mesh=None, timed=DP_TIMED, profiled=PROFILED_STEPS):
    """A step's host clock (median of ``timed``), device time and idle share
    (one profile of ``profiled`` steps) on the state ``_dp_fit`` left."""
    model, tcfg, state, one = job
    step = make_train_step(model, tcfg.noise_level_mag, noise_level_img=tcfg.noise_level_img,
                           mesh=mesh)
    gen = _dp_draws(3, mesh)
    with batch_stats_over(model, mesh):  # global BatchNorm statistics, as in the fit
        host, _ = _host_step_ms(step, state, one, gen, timed)
        dev_ms, _, _, idle, _, kinds = _trace(lambda: step(state, one, gen), profiled)
    return {"host_ms": float(np.median(host)), "device_ms": dev_ms, "idle": idle,
            "kinds": kinds}


def _members_data(tmp):
    """Phase ensemble (d)'s lr x seed x fold grid (``maven-lite-members.yaml``
    in ``tmp``), phase ingest's dataset (through the cache) and its folds."""
    sweep = load_sweep(os.path.join(tmp, "maven-lite-members.yaml"))
    extra = sweep.extra_args
    config = cli_common.ingest_config(os.path.join(tmp, "ZTFBTS"),
                                      os.path.join(tmp, "ZTFBTS_spectra"), extra, 1000)
    ds, _ = load_or_ingest(os.path.join(tmp, "cache"),
                           lambda: load_ztfbts(kfolds=None, **config)[0], **config)
    folds = stratified_kfolds(np.asarray(ds.arrays["label"]), int(extra["kfolds"]))
    return sweep, ds, folds


def _dp_members(tmp, mesh):
    """Phase tp (e) on a rank: the grid through ``run_sweep(parallel_members=True,
    mesh=mesh)``, MEMBER_EPOCHS: this rank's members' losses a step, their
    run dirs' files and the launches."""
    sweep, ds, folds = _members_data(tmp)
    extra = sweep.extra_args
    sweep_dir = os.path.join(tmp, "dp", "members", "maven-lite-members")
    os.makedirs(sweep_dir, exist_ok=True)
    with _recorded_member_losses() as recorded, _plain_calls() as plain:
        _zero_counts()
        t0 = time.perf_counter()
        results = run_sweep(sweep, ds, NBAND, folds, sweep_dir, mesh=mesh,
                            max_runs=int(extra["nruns"]), epochs_override=MEMBER_EPOCHS,
                            parallel_members=True, device=DEVICE)
        torch.cuda.synchronize()
        wall, counts = time.perf_counter() - t0, _counts()
    local = [os.path.basename(r["run_dir"]) for r in results if "state" in r]
    mesh.barrier()  # every member's files are written
    m_points = list(expand_grid(sweep))
    layers = SEQ_LC["depth"] + SEQ_SP["depth"]
    want = _ensemble_cli_want(ds, folds, sweep, m_points, MEMBER_EPOCHS,
                              _tf32_flash(layers, layers))[0]
    return {"losses": torch.cat(recorded, dim=1), "local": local, "counts": counts,
            "want": want, "plain": len(plain), "wall_s": wall,
            "files": {k: sorted(os.listdir(os.path.join(sweep_dir, k)))
                      for k in sorted(os.listdir(sweep_dir))}}, None


def _members_reference(tmp, n_data):
    """Phase tp (e)'s reference: each data rank's block of the grid as a
    one-process stack of the same members (``fit_members`` without a mesh,
    MEMBER_EPOCHS), their losses a step in grid order. A stack rounds its
    few-output reductions by its member count (PERF.md section 6), so a
    rank's stack of N / n_data is held to a stack of as many; it trains on
    the whole ensemble's plans and optimizer choice, so each block's own
    must be the same for the reference to be that program."""
    sweep, ds, folds = _members_data(tmp)
    extra = sweep.extra_args
    points = list(expand_grid(sweep))[:int(extra["nruns"])]
    k, b = len(points) // n_data, int(points[0]["batchsize"])
    splits = [split_for_run(len(ds), float(extra.get("val_fraction", 0.2)),
                            int(p.get("seed", 0)), folds=folds, foldnumber=p.get("foldnumber"))
              for p in points]

    def plan(block):
        return (max(-(-len(splits[i][0]) // b) for i in block),
                max(-(-len(splits[i][1]) // b) for i in block),
                len({float(points[i]["lr"]) for i in block}) > 1)

    whole, losses = plan(range(len(points))), []
    for d in range(n_data):
        block = range(d * k, (d + 1) * k)
        if plan(block) != whole:
            raise AssertionError(f"tp members: data rank {d}'s members {list(block)} train "
                                 f"{plan(block)} (steps, val steps, one lr each) alone and "
                                 f"{whole} in the ensemble: no one-process stack of them "
                                 "is the rank's program")
        members, models, task, freeze, tcfg = _ensemble_members(
            sweep, [points[i] for i in block], ds, folds, MEMBER_EPOCHS)
        with _recorded_member_losses() as recorded, _plain_calls() as plain:
            ensemble_mod.fit_members(models, task, tcfg, ds, members,
                                     n_classes=int(extra.get("n_classes", 5)), freeze=freeze)
        if plain:
            raise AssertionError(f"tp members reference: {len(plain)} plain kernel calls")
        losses.append(torch.cat(recorded, dim=1))
        del models
        torch.cuda.empty_cache()
    return torch.cat(losses)


def _dp_job(name, tmp, mesh):
    """One job of a rank: (its result, what ``_dp_time`` needs or None)."""
    if name == "members":
        return _dp_members(tmp, mesh)
    if name in STREAM_DP_JOBS:
        run, epochs, resume = STREAM_DP_JOBS[name]
        return _stream_dp_fit(tmp, run, mesh, epochs=epochs, resume=resume), None
    return _dp_fit(name, tmp, mesh)


def _dp_worker(group, rank, tmp):
    """Rank ``rank`` of ``group`` in DP_GROUPS (``chip_smoke.py --dp-rank GROUP
    R TMP``): joins the group's gloo process group on cuda:0 as its (data,
    model) mesh, runs the group's jobs, then, once its phase's one-process
    runs are done (``tmp/dp/<phase>-refs-done``; a group of DP_AFTER_REFS
    waits for them before its jobs), times each timed job's step and writes
    each job's result to ``tmp/dp/<group>-<job>-<rank>.pt``."""
    from multimodal_supernovae_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = os.path.join(tmp, "dp")
    phase, (n_data, n_model), names = DP_GROUPS[group]
    distributed.initialize(f"file://{os.path.join(d, f'store-{group}')}", n_data * n_model,
                           rank, device=f"{DEVICE}:0", backend="gloo",
                           timeout=DP_GROUP_TIMEOUT_S)
    mesh = distributed.make_global_mesh(n_model=n_model)
    timed = [name for name in names if name not in DP_UNTIMED]

    def wait_for_refs():
        deadline = time.perf_counter() + DP_TIMEOUT_S
        while not os.path.exists(os.path.join(d, f"{phase}-refs-done")):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"{phase}: the one-process runs did not finish")
            time.sleep(0.1)

    try:
        if group in DP_AFTER_REFS:
            wait_for_refs()
            mesh.barrier()
        jobs = {name: _dp_job(name, tmp, mesh) for name in names}
        if timed:
            wait_for_refs()
        mesh.barrier()
        for name, (out, job) in jobs.items():
            if name in timed:
                out.update(_dp_time(job, mesh, *DP_TIMING[phase]))
            torch.save(out, os.path.join(d, f"{group}-{name}-{rank}.pt"))
    finally:
        distributed.shutdown()
    return 0


def _dp_start(tmp, groups):
    """The ranks of ``groups`` as subprocesses (output in tmp/dp/<group>-rank<r>.log)."""
    d = os.path.join(tmp, "dp")
    ranks = [(g, r) for g in groups for r in range(np.prod(DP_GROUPS[g][1]))]
    logs = [open(os.path.join(d, f"{g}-rank{r}.log"), "w") for g, r in ranks]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", g,
                               str(r), tmp], stdout=f, stderr=subprocess.STDOUT)
             for (g, r), f in zip(ranks, logs)]
    return ranks, procs, logs


def _dp_wait(tmp, run, phase):
    """Wait for ``phase``'s ranks of ``run``, each within DP_TIMEOUT_S; any
    left is killed."""
    mine = [i for i, (g, _) in enumerate(run["ranks"]) if DP_GROUPS[g][0] == phase]
    codes = []
    try:
        for i in mine:
            try:
                codes.append(run["procs"][i].wait(timeout=DP_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                codes.append("timeout")
    finally:
        for i in mine:
            p = run["procs"][i]
            if p.poll() is None:
                p.kill()
                p.wait()
            run["logs"][i].close()
    if any(codes):
        for i, c in zip(mine, codes):
            if c:
                g, r = run["ranks"][i]
                with open(os.path.join(tmp, "dp", f"{g}-rank{r}.log")) as f:
                    for line in f.read().splitlines()[-30:]:
                        log(f"{phase} {g} rank {r}: {line}")
        raise AssertionError(f"{phase}: the ranks {[run['ranks'][i] for i in mine]} exited "
                             f"with {codes}")


def _dp_compare(name, ref, got, rank, tag, loss_tol, param_tol):
    """One rank's job against the one-process reference: a fit's epoch
    losses, or a run of steps' losses (Maven pretraining's relative
    DP_MAVEN_RTOL a step), every (gathered) state_dict entry, the launches."""
    tag = f"{tag} {name} rank {rank}"
    per_step = got["per_step"]
    if "losses" in got:
        want = tuple(c * len(got["losses"]) for c in per_step)
        a, w = np.asarray(got["losses"]), np.asarray(ref["losses"])
        if name == "maven-pretrain":
            loss_err = float(np.max(np.abs(a - w) / np.abs(w)))
            loss_ok = loss_err <= DP_MAVEN_RTOL
            what = "relative"
        else:
            loss_err = float(np.max(np.abs(a - w) / (loss_tol + loss_tol * np.abs(w))))
            loss_ok, what = loss_err <= 1.0, "|diff| / (atol + rtol |want|)"
        losses = f"losses {a.tolist()} (one process {w.tolist()}), worst {what} {loss_err:.3e}"
    else:
        want = _fit_want(per_step, got["epochs"], *got["steps"])
        a = np.asarray(got["history"]["train_loss"] + got["history"]["val_loss"])
        w = np.asarray(ref["history"]["train_loss"] + ref["history"]["val_loss"])
        loss_err = float(np.max(np.abs(a - w) / (loss_tol + loss_tol * np.abs(w))))
        loss_ok = loss_err <= 1.0
        losses = (f"train_loss {got['history']['train_loss']} val_loss "
                  f"{got['history']['val_loss']} (one process {ref['history']}), worst "
                  f"|diff| / (atol + rtol |want|) {loss_err:.3f}")
    worst, worst_key, bn = 0.0, None, 0.0
    if sorted(got["state_dict"]) != sorted(ref["state_dict"]) or any(
            got["state_dict"][k].shape != v.shape for k, v in ref["state_dict"].items()):
        raise AssertionError(f"{tag}: the state_dict's names or shapes are not the one "
                             "process's")
    for k, v in ref["state_dict"].items():
        g = got["state_dict"][k]
        if not v.is_floating_point():
            if not torch.equal(g, v):
                worst, worst_key = float("inf"), k
            continue
        diff = (g.double() - v.double()).abs()
        ratio = float((diff / (param_tol + param_tol * v.double().abs())).max())
        if "running" in k:
            bn = max(bn, float(diff.max()))
        if ratio > worst:
            worst, worst_key = ratio, k
    log(f"{tag}: {losses}; every state_dict entry ({len(ref['state_dict'])}), worst "
        f"|diff| / (atol + rtol |want|) {worst:.3f} at {worst_key}" +
        (f", BatchNorm running statistics within {bn:.3e}" if bn else "") +
        f"; launches {got['counts']} (want {want}), {got['plain']} plain calls")
    if not loss_ok or worst > 1.0 or got["counts"] != want or got["plain"]:
        raise AssertionError(f"{tag}: loss check {loss_ok}, parameters {worst:.3f} at "
                             f"{worst_key}, launches {got['counts']} (want {want}), "
                             f"{got['plain']} plain calls")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_start(root, args):
    """Start ``python -m torch.distributed.run --nproc-per-node 1 -m
    multimodal_supernovae_tpu_torch train configs/maven-lite.yaml --mesh
    ARGS`` (a one-rank NCCL group), its output in ``root/torchrun.log``;
    ``_cli_wait`` waits for it."""
    os.makedirs(root, exist_ok=True)
    repo = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
           "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
           "-m", "multimodal_supernovae_tpu_torch", "train", MAVEN_LITE, "--mesh", *args]
    out = open(os.path.join(root, "torchrun.log"), "w")
    proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, cwd=repo,
                            env=dict(os.environ, PYTHONPATH=repo))
    return proc, out, time.perf_counter()


def _cli_wait(cli):
    proc, out, t0 = cli
    try:
        code = proc.wait(timeout=DP_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
    return code, time.perf_counter() - t0


def _dp_cli_check(card, tmp, code, wall, step_ms_single):
    """The torchrun run's exit, its run dir, the 3xTF32 flash kernels in its
    trace (18 + 18 + 18 a train step) and the step's MFU."""
    from multimodal_supernovae_tpu_torch.utils import flops

    root = os.path.join(tmp, "dp", "cli")
    prof, analysis = os.path.join(root, "profile"), os.path.join(root, "analysis")
    with open(os.path.join(root, "torchrun.log")) as f:
        output = f.read()
    for line in output.splitlines()[-8:]:
        log(f"dp cli: {line}")
    if code:
        raise AssertionError(f"dp cli: torchrun exited {code}")
    if "mesh: {'data': 1, 'model': 1} over 1 process(es), nccl" not in output:
        raise AssertionError("dp cli: the run did not report a one-rank NCCL mesh")
    run_dir = os.path.join(analysis, "maven-lite", "run-0")
    files, rows = set(os.listdir(run_dir)), _metric_rows(run_dir)
    with open(os.path.join(run_dir, "train_filenames.txt")) as f:
        n_train = len(f.read().splitlines())
    with open(os.path.join(run_dir, "val_filenames.txt")) as f:
        n_val = len(f.read().splitlines())
    sweep = load_sweep(MAVEN_LITE)
    point, extra = next(expand_grid(sweep)), sweep.extra_args
    model, _, _, _, tcfg = _build_run(point, extra, NBAND, None, 1)
    b, layers = tcfg.batch_size, _dp_per_step("maven-lite", model)[-1]
    train_steps, eval_steps = -(-n_train // b), -(-n_val // b)
    if not set(RUN_DIR_FILES) <= files or len(rows) != 1 or not all(
            np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in rows):
        raise AssertionError(f"dp cli: run dir files {sorted(files)}, rows {rows}")
    traces = [f for f in os.listdir(prof) if f.startswith("trace-rank0-")]
    if len(traces) != 1:
        raise AssertionError(f"dp cli: traces {os.listdir(prof)}")
    path = os.path.join(prof, traces[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    seen = {k: sum(k in e["name"] for e in kernels) for k in DP_FLASH}
    want = dict(zip(DP_FLASH, (layers * (train_steps + eval_steps), layers * train_steps,
                               layers * train_steps)))
    nccl = sum("nccl" in e["name"].lower() for e in kernels)
    log(f"dp cli: torchrun --nproc-per-node 1 ... train {MAVEN_LITE} --mesh --epochs 1 "
        f"--max-runs 1 --profile-dir: ended within {wall:.1f} s (beside phase ensemble) on a "
        f"{DP_CLI_N}-transient tree "
        f"({n_train} train / {n_val} val: {train_steps} + {eval_steps} steps at B={b}); run "
        f"dir {sorted(files)}; {rows[0]}; trace {traces[0]} "
        f"({os.path.getsize(path) / 2**20:.1f} MiB, {len(events)} events, {len(kernels)} "
        f"device kernels, {nccl} of them NCCL): 3xTF32 flash kernels {seen} (want {want})")
    if seen != want:
        raise AssertionError(f"dp cli: the trace's flash kernels {seen}, want {want}")
    t_lc, t_sp = 2 * int(extra.get("max_lightcurve_data_len", 100)), \
        int(extra["max_spectral_data_len"])
    step_flops = flops.clip_train_step_flops(model.cfg, b, t_lc, t_sp)
    for what, ms in (("the CLI run's epoch mean step (under the profiler, recording host ops)",
                      rows[0]["step_time_s"] * 1e3),
                     ("phase dp's one-process step (host clock median)", step_ms_single)):
        m = flops.mfu(step_flops, ms / 1e3, dtype=torch.float32)
        log(f"dp cli: MFU of maven-lite's step (B={b}, T_lc={t_lc}, T_sp={t_sp}, "
            f"{step_flops:.4e} model FLOPs by utils/flops.py) at {what} {ms:.3f} ms: "
            f"{m['model_tflops_per_s']:.4f} TFLOP/s of a {m['peak_tflops_per_s']:.0f} TFLOP/s "
            f"peak (compute type {flops.compute_type(torch.float32)}: float32 matmuls with "
            f"TF32 off; the card {torch.cuda.get_device_name(0)}), {m['mfu_pct']:.4f}%; "
            f"card {card}")


def _folds_cli_check(tmp, code, wall):
    """The torchrun run's exit, its one-rank NCCL mesh, the five folds' run
    dirs (one epoch each) and the stacked checkpoint _ensemble-g0/."""
    root = os.path.join(tmp, "dp", "folds")
    with open(os.path.join(root, "torchrun.log")) as f:
        output = f.read()
    for line in output.splitlines()[-8:]:
        log(f"tp cli: {line}")
    if code:
        raise AssertionError(f"tp cli: torchrun exited {code}")
    if "mesh: {'data': 1, 'model': 1} over 1 process(es), nccl" not in output:
        raise AssertionError("tp cli: the run did not report a one-rank NCCL mesh")
    sweep_dir = os.path.join(root, "analysis", "maven-lite")
    runs = sorted(n for n in os.listdir(sweep_dir) if n.startswith("run-"))
    ens = sorted(os.listdir(os.path.join(sweep_dir, "_ensemble-g0")))
    bad = []
    for k in runs:
        files, rows = set(os.listdir(os.path.join(sweep_dir, k))), \
            _metric_rows(os.path.join(sweep_dir, k))
        if not set(RUN_DIR_FILES) <= files or len(rows) != 1 or not (
                np.isfinite(rows[0]["train_loss"]) and np.isfinite(rows[0]["val_loss"])):
            bad.append((k, sorted(files), rows))
    log(f"tp cli: torchrun --nproc-per-node 1 ... train {MAVEN_LITE} --mesh --parallel-folds "
        f"--epochs 1: ended within {wall:.1f} s (beside phase ensemble); run dirs {runs}, each "
        f"with the sequential run's files and one finite row: {not bad}; _ensemble-g0 "
        f"{ens}")
    if runs != [f"run-{k}" for k in range(5)] or bad or "bookkeeping.json" not in ens:
        raise AssertionError(f"tp cli: runs {runs}, faults {bad}, _ensemble-g0 {ens}")


def _dp_grads_check(ref, got, rank, n_model):
    """The fused job's gradients of one loss: every FFN slice of the fused
    blocks (the LC tower: their ReLU runs inside the fused kernel on
    pre-activations the unsplit tower computes alike) held to the same slice
    of the one-process gradient within GRAD_RTOL of its largest; the other
    parameters logged."""
    want, held, other = {}, {}, {}
    for k, v in ref["grads"].items():
        dim = spec_for(k, v, n_model)
        want[k] = v if dim is None else v.narrow(
            dim, (rank % n_model) * (v.shape[dim] // n_model), v.shape[dim] // n_model)
        (held if k.startswith("lightcurve_encoder.") and ".ff." in k else other)[k] = want[k]
    if sorted(got["grads"]) != sorted(want):
        raise AssertionError(f"tp fused rank {rank}: gradients of "
                             f"{sorted(set(got['grads']) ^ set(want))}")
    worst, err = _grad_error({k: got["grads"][k] for k in held}, held)
    o_worst, o_err = _grad_error({k: got["grads"][k] for k in other}, other)
    log(f"tp fused rank {rank}: one loss's gradients: the fused blocks' {len(held)} FFN "
        f"slices worst max|diff|/max|want| {err:.3e} at {worst} (tol {GRAD_RTOL}); the other "
        f"{len(other)} parameters (not held) {o_err:.3e} at {o_worst}; launches "
        f"{got['grad_counts']} (one process {ref['grad_counts']})")
    if err > GRAD_RTOL or got["grad_counts"] != ref["grad_counts"]:
        raise AssertionError(f"tp fused rank {rank}: FFN gradient slices {err} off, launches "
                             f"{got['grad_counts']} (want {ref['grad_counts']})")


def _members_check(tmp, rank, got, ref):
    """Phase tp (e), one rank: each of its members' loss a step within
    relative TP_MEMBER_RTOL of the one-process stack of the same members
    (``_members_reference``); its run dirs' files those of phase ensemble
    (d)'s; 18 + 18 launches a stacked step. The distance to (d)'s one-process
    stack of all 8 is logged beside, not held: that stack rounds its
    few-output reductions otherwise (PERF.md section 6)."""
    eight = torch.load(os.path.join(tmp, "ensemble-members-losses.pt"), weights_only=True)
    m_dir = os.path.join(tmp, "ensemble", "M", "maven-lite-members")
    idx = [int(k.split("-")[1]) for k in got["local"]]
    a, want, want8 = got["losses"].double(), ref[idx].double(), eight[idx].double()
    if a.shape != want.shape or a.shape != want8.shape:
        raise AssertionError(f"tp members rank {rank}: losses {tuple(a.shape)}, the one "
                             f"process's {tuple(want.shape)} and (d)'s {tuple(want8.shape)}")
    rel = float(((a - want).abs() / want.abs()).max())
    rel8 = float(((a - want8).abs() / want8.abs()).max())
    same_files = {k: got["files"][k] == sorted(os.listdir(os.path.join(m_dir, k)))
                  for k in got["local"]}
    log(f"tp members rank {rank}: members {got['local']} as one stacked program, "
        f"{a.shape[1]} steps over {MEMBER_EPOCHS} epoch(s) in {got['wall_s']:.1f} s; losses a "
        f"step against the one-process stack of the same {len(idx)} members: worst relative "
        f"{rel:.3e} (tol {TP_MEMBER_RTOL}), bitwise {torch.equal(got['losses'], ref[idx])}; "
        f"against phase ensemble (d)'s stack of {eight.shape[0]} (not held): worst relative "
        f"{rel8:.3e}; run dirs with (d)'s files: {same_files}; launches {got['counts']} "
        f"(want {got['want']}), {got['plain']} plain calls")
    if (rel > TP_MEMBER_RTOL or not all(same_files.values()) or got["counts"] != got["want"]
            or got["plain"]):
        raise AssertionError(f"tp members rank {rank}: losses {rel:.3e} relative, files "
                             f"{same_files}, launches {got['counts']} (want {got['want']})")


def _dp_init(tmp):
    """Each DP_CONFIGS model's initial weights in ``tmp/dp``, from its seed."""
    d = os.path.join(tmp, "dp")
    os.makedirs(d, exist_ok=True)
    for name in DP_CONFIGS:
        model = _dp_setup(name, tmp)[0]
        torch.save(model.state_dict(), os.path.join(d, f"{name}.init.pt"))
        del model


def _cli_launch(tmp):
    """Phase dp's and phase tp's torchrun runs, started once phase ingest's
    tree and cache exist: phase dp's on a DP_CLI_N-transient tree of its
    own (--epochs 1 --max-runs 1 --profile-dir), phase tp's (f) on phase
    ingest's (--parallel-folds --epochs 1). They run beside phase ensemble
    up to its timing grid, which waits for them (``_cli_results``). Returns
    the run that ``_dp_launch`` adds the groups of ranks to; ``_dp_stop``
    ends whatever is left."""
    root, folds = os.path.join(tmp, "dp", "cli"), os.path.join(tmp, "dp", "folds")
    data_dir, spectra_dir, _ = _write_tree(root, DP_CLI_N, seed=1)
    run = {"clis": {}, "cli_results": {}, "ranks": [], "procs": [], "logs": []}
    try:
        run["clis"]["dp"] = _cli_start(root, [
            "--epochs", "1", "--max-runs", "1", "--profile-dir", os.path.join(root, "profile"),
            "--data-dir", data_dir, "--spectra-dir", spectra_dir,
            "--cache-dir", os.path.join(root, "cache"),
            "--analysis-path", os.path.join(root, "analysis")])
        run["clis"]["tp"] = _cli_start(folds, [
            "--parallel-folds", "--epochs", "1",
            # the paths phase ingest filled the cache with: a hit
            "--data-dir", os.path.join(tmp, "ZTFBTS"),
            "--spectra-dir", os.path.join(tmp, "ZTFBTS_spectra"),
            "--cache-dir", os.path.join(tmp, "cache"),
            "--analysis-path", os.path.join(folds, "analysis")])
    except BaseException:
        _dp_stop(run)
        raise
    return run


def _cli_results(run):
    """Wait for both torchrun runs of ``run``: {phase: (exit code, seconds from
    its start to the wait's end)}."""
    for phase, cli in run["clis"].items():
        if phase not in run["cli_results"]:
            run["cli_results"][phase] = _cli_wait(cli)
            log(f"{phase} cli: torchrun ended within {run['cli_results'][phase][1]:.1f} s of "
                f"its start, exit code {run['cli_results'][phase][0]}")
    return run["cli_results"]


def _dp_launch(tmp, run):
    """Every group of phases dp and tp in DP_GROUPS, started together from
    ``_dp_init``'s weights into ``run``: phase dp collects its group, phase
    tp the rest."""
    try:
        run["ranks"], run["procs"], run["logs"] = _dp_start(
            tmp, [g for g, (phase, _, _) in DP_GROUPS.items() if phase in ("dp", "tp")])
    except BaseException:
        _dp_stop(run)
        raise
    run["t0"] = time.perf_counter()


def _dp_stop(run):
    """End every process of ``run`` still running and close its logs."""
    clis = list(run["clis"].values())
    for p in (*(c[0] for c in clis), *run["procs"]):
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in (*(c[1] for c in clis), *run["logs"]):
        f.close()


def _dp_check(card, tmp, phase, refs, members=None):
    """Every rank of ``phase``'s groups against the one-process runs
    (``refs``; ``members``: phase tp (e)'s reference), and each timed
    step beside the one process's. Every check runs and logs; returns the
    ranks' launches and the faults."""
    d = os.path.join(tmp, "dp")
    total, faults = NONE, []
    for group, (ph, (n_data, n_model), names) in DP_GROUPS.items():
        if ph != phase:
            continue
        for name in names:
            for r in range(n_data * n_model):
                got = torch.load(os.path.join(d, f"{group}-{name}-{r}.pt"), weights_only=False)
                total = tuple(a + c for a, c in zip(total, got["counts"]))
                if name == "fused":
                    total = tuple(a + c for a, c in zip(total, got["grad_counts"]))
                try:
                    if name == "members":
                        _members_check(tmp, r, got, members)
                    else:
                        _dp_compare(name, refs[name], got, r, f"{phase} {group}",
                                    *DP_TOLS[phase])
                    if name == "fused":
                        _dp_grads_check(refs[name], got, r, n_model)
                except AssertionError as e:
                    log(f"{phase}: FAILED: {e}")
                    faults.append(str(e))
                if "host_ms" in got:
                    ref = refs[name]
                    kinds = ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                        got["kinds"].items(), key=lambda kv: -kv[1])[:4])
                    log(f"{phase} {group} {name} rank {r}: step at B={got['batch']}/{n_data} a "
                        f"data rank, FFNs split over {n_model}: host clock "
                        f"{got['host_ms']:.3f} ms, device {got['device_ms']:.3f} ms, idle share "
                        f"{got['idle']:.3f} ({kinds} ms); one process at the global B: host "
                        f"clock {ref['host_ms']:.3f} ms, device {ref['device_ms']:.3f} ms, idle "
                        f"share {ref['idle']:.3f}; card {card}")
    return total, faults


def _dp_refs(phase, names, tmp, refs):
    """The one-process runs of ``names`` into ``refs``, keeping what ``_dp_time``
    needs under ``refs['_jobs'][phase]``; ``phase``'s ranks may time their
    steps after it (``tmp/dp/<phase>-refs-done``)."""
    try:
        for name in names:
            out, job = _dp_fit(name, tmp)
            refs[name] = out
            refs.setdefault("_jobs", {}).setdefault(phase, {})[name] = job
            log(f"{phase} {name}: one process on the card, {out['wall_s']:.2f} s counted "
                f"(beside the ranks); launches {out['counts']}")
    finally:
        open(os.path.join(tmp, "dp", f"{phase}-refs-done"), "w").close()


def _dp_time_refs(phase, refs):
    """Time ``phase``'s one-process steps, once its ranks are done."""
    for name, job in refs["_jobs"].pop(phase).items():
        if name not in DP_UNTIMED:
            refs[name].update(_dp_time(job, None, *DP_TIMING[phase]))
    torch.cuda.empty_cache()


def phase_dp(card, tmp, run):
    """Data-parallel training on the card, from ``_dp_init``'s weights:
    maven-lite (phase ingest's tree), trimodal (global BatchNorm statistics)
    and Maven pretraining at B = 1024, each on the "2x1" group of gloo ranks
    sharing cuda:0 against the one-process run from the same weights; then
    the umbrella CLI under torchrun with --profile-dir. Every group of
    ``_dp_launch`` runs beside, and while the ranks run this process also
    makes phase tp's one-process runs. Returns the ranks' launches and every
    one-process result."""
    t_phase = time.perf_counter()
    refs = {}
    try:
        _dp_refs("dp", DP_GROUPS["2x1"][2], tmp, refs)
        # phase tp's references, while every group's ranks run
        _dp_refs("tp", ("maven-lite-1", "trimodal-steps", "fused"), tmp, refs)
        t0 = time.perf_counter()
        refs["members"] = _members_reference(tmp, DP_GROUPS["members"][1][0])
        log(f"tp members: the one-process stacks of each data rank's members, "
            f"{refs['members'].shape[1]} steps each, in {time.perf_counter() - t0:.1f} s "
            "(beside the ranks)")
    finally:
        for phase in ("dp", "tp"):  # a rank waits for its phase's references
            open(os.path.join(tmp, "dp", f"{phase}-refs-done"), "w").close()
        _dp_wait(tmp, run, "dp")
    cli_code, cli_wall = _cli_results(run)["dp"]
    log(f"dp: the 2x1 group's gloo ranks on cuda:0 ran {list(DP_GROUPS['2x1'][2])} in "
        f"{time.perf_counter() - run['t0']:.1f} s (subprocesses, start-up included)")
    _dp_time_refs("dp", refs)
    total, faults = _dp_check(card, tmp, "dp", refs)
    log("dp: two ranks share one card here (and phase tp's ranks run beside them), so these "
        "times say nothing about scaling over cards (a 4-card NCCL run is ROADMAP item 8's "
        "cell)")
    if faults:
        raise AssertionError(f"dp: {len(faults)} check(s) failed: {faults}")
    _dp_cli_check(card, tmp, cli_code, cli_wall, refs["maven-lite"]["host_ms"])
    log(f"dp: launches per route {COUNT_NAMES}: {total}; card {card}")
    log(f"dp: phase done in {time.perf_counter() - t_phase:.1f} s")
    return total, refs


def phase_tp(card, tmp, refs, run):
    """Tensor parallelism and the member axis on the card, each group of gloo
    ranks sharing cuda:0 (``_dp_launch``'s, started with phase dp's) against
    the one-process run from the same weights (``refs``, made in phase
    dp): (a) maven-lite at 2 x 2, 1 epoch; (b) trimodal at 1 x 2 (the split
    ConvMixer head and its dropout), (c) Maven pretraining at 1 x 2 (phase
    dp's one-process steps), (d) the fused opt-in at 1 x 2, DP_STEPS steps
    each; (e) phase ensemble's 8 members over a 2 x 1 mesh, 4 a rank,
    MEMBER_EPOCHS, against one-process stacks of the same 4; (f) cli train
    --mesh --parallel-folds under torchrun. Returns the ranks' launches."""
    t_phase = time.perf_counter()
    _dp_wait(tmp, run, "tp")
    cli_code, cli_wall = _cli_results(run)["tp"]
    log(f"tp: the groups {({g: m for g, (ph, m, _) in DP_GROUPS.items() if ph == 'tp'})} of "
        f"gloo ranks on cuda:0 took {time.perf_counter() - run['t0']:.1f} s from their start "
        "beside phase dp (subprocesses, start-up included)")
    _dp_time_refs("tp", refs)
    total, faults = _dp_check(card, tmp, "tp", refs, refs["members"])
    log("tp: the ranks of every group share one card here, so these times say nothing about "
        "scaling over cards (a 2 x 2 NCCL run over 4 cards is ROADMAP item 8's candidate)")
    try:
        _folds_cli_check(tmp, cli_code, cli_wall)
    except AssertionError as e:
        log(f"tp: FAILED: {e}")
        faults.append(str(e))
    if faults:
        raise AssertionError(f"tp: {len(faults)} check(s) failed: {faults}")
    log(f"tp: launches per route {COUNT_NAMES}: {total}; card {card}")
    log(f"tp: phase done in {time.perf_counter() - t_phase:.1f} s")
    return total


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
    dev = _device_spans(prof)
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
    for path in ("kernel", "plain", "fused", "qkv"):
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


def _qkv_bounds(b, t, e, h, dtype_name="bfloat16"):
    """Bounds of the fused-QKV forward and backward at (B, T, E, heads), in
    bf16 on the tensor cores or float32 on the CUDA cores. Bytes: x and out
    (backward: x, g and dx) once, the mask, the float32 weights (backward:
    the weights in and their gradients out).
    Multiply-adds a row: forward 3E^2 (projection) + 2TE (q.k and p.v, all
    heads) + E^2 (unify); the backward recomputes the first two and adds
    E^2 each for datt and dWu, TE each for dP, dq, dk and dv, and 3E^2 each
    for dx and dWqkv."""
    n, p, size = b * t, 4 * e * e + e, 2 if dtype_name == "bfloat16" else 4
    fwd = _bound(2 * n * (4 * e * e + 2 * t * e), 2 * n * e * size + n + 4 * p, dtype_name)
    bwd = _bound(2 * n * (11 * e * e + 6 * t * e), 3 * n * e * size + n + 8 * p, dtype_name)
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
    export, dispatch = phase_export(card)
    train = phase_train()
    phase_grad_probe()
    train_fused = phase_train("fused")
    train_qkv = phase_train("qkv")
    run_dir = phase_run_dir()
    towers = phase_towers(card)
    vit, vit_timing, vit_err = phase_vit(card)
    os.makedirs("chiprun_out", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="chiprun_out", prefix="ingest-") as tmp:
        tree = start_tree(tmp)  # phase ingest's tree, written beside phases maven to stream-dp
        maven = phase_maven(card)
        sim = phase_sim(card, tmp)
        stream = phase_stream(card, tmp)
        stream_dp = phase_stream_dp(card, tmp)
        ingest = phase_ingest(card, tmp, tree)
        evaluation = phase_evaluate(card, tmp)
        run = _cli_launch(tmp)  # phases dp's and tp's torchrun runs, beside phase ensemble
        try:
            ensemble, stacked = phase_ensemble(card, tmp, quiet=lambda: _cli_results(run))
            _dp_init(tmp)
            _dp_launch(tmp, run)  # every group of ranks
            dp, refs = phase_dp(card, tmp, run)
            tp = phase_tp(card, tmp, refs, run)
        finally:
            _dp_stop(run)
    phase_profile()
    runs = (serve, serve_fused, serve_qkv, export, train, train_fused, train_qkv, run_dir,
            towers, vit, maven, sim, stream, stream_dp, ingest, evaluation, ensemble, dp, tp)
    log(f"kernels line: each entry's \"shape\" is what its times and bound are at; "
        f"launches {COUNT_NAMES} of serve, serve-fused, serve-qkv, export, train, train-fused, "
        f"train-qkv, run-dir, towers, vit, maven, sim, stream, stream-dp, ingest, evaluate, "
        f"ensemble, dp, tp, summed in the line: "
        f"{runs}; card {card}")
    lc, sp_fwd, sp_bwd, tri = ((BATCH, 8, NBAND * LC_LEN, 8), (BATCH, 2, SP_LEN, 16),
                               (BATCH, 2, TRAIN_SP_LEN, 16), (32, 2, SP_LEN, 16))
    maven_lc, maven_sp = (4 * BATCH, 8, NBAND * LC_LEN, 8), (4 * BATCH, 2, TRAIN_SP_LEN, 16)
    vit_shapes = {bb: (bb, VIT_STATED[0][2], VIT_STATED[1], VIT_STATED[2]) for bb in VIT_TIMED_B}
    for name, shape in (("LC", lc), ("SP serving", sp_fwd), ("SP training", sp_bwd),
                        ("SP trimodal", tri), ("Maven LC", maven_lc), ("Maven SP", maven_sp),
                        *((f"ViT B={bb}", sh) for bb, sh in vit_shapes.items())):
        e_fwd, e_bwd = _exp_floor_ms(*shape[:3], exp_per_s)
        for peak in ("bfloat16", "tf32x3", "float32"):
            (f_ms, f_by), (b_ms, b_by) = _flash_bounds(*shape, peak)
            ops_7s = _bound(14 * np.prod(shape, dtype=np.int64) * shape[2], 0, peak)[0]
            log(f"bounds {peak} at {name} {shape}: flash forward {f_ms:.4f} ms ({f_by}), "
                f"flash backward {b_ms:.4f} ms ({b_by}; the kernels' 7S products alone "
                f"{ops_7s:.4f} ms); exponentials alone: forward {e_fwd:.4f} ms, backward "
                f"{e_bwd:.4f} ms")
    for name, shape in (("LC", QKV_LC), ("SP", QKV_SP)):
        for dtype_name in ("bfloat16", "float32"):
            (f_ms, f_by), (b_ms, b_by) = _qkv_bounds(*shape, dtype_name)
            log(f"bounds {dtype_name} at {name} (B, T, E, H) = {shape}: fused QKV forward "
                f"{f_ms:.4f} ms ({f_by}), backward {b_ms:.4f} ms ({b_by})")
    lc32 = ffn_timing["float32"]
    qkv_lc, qkv_sp = qkv_timing["lc"], qkv_timing["sp"]

    def flash(route, bwd, dtype="bfloat16"):
        """The flash entry of ``route`` in ``dtype``: SP timed (serving T
        forward, training T backward), LC under also_at; in float32 the
        trimodal SP under also_at_trimodal, Maven pretraining's B = 1024
        shapes under also_at_maven_lc and also_at_maven_sp, and the other SP
        T under also_at_training (forward) or also_at_serving (backward)."""
        tm = bwd_timing if bwd else timing
        peak = "bfloat16" if dtype == "bfloat16" else "tf32x3" if route == "tf32" else "float32"
        shapes = {"sp": sp_bwd if bwd else sp_fwd, "lc": lc, "sp_tri": tri,
                  "sp_train": sp_bwd, "sp_t1024": sp_fwd, "maven_lc": maven_lc,
                  "maven_sp": maven_sp}

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
            top["also_at_maven_lc"] = entry("maven_lc")
            top["also_at_maven_sp"] = entry("maven_sp")
            other = "also_at_serving" if bwd else "also_at_training"
            top[other] = entry("sp_t1024" if bwd else "sp_train")
        return top

    def vit_entries(bwd, dtype, route="simt"):
        """The flash entry of ``route`` at the ViT tower's shapes (phase vit),
        under also_at_vit_b32 and also_at_vit_b256."""
        peak = ("bfloat16" if dtype == "bfloat16" else "tf32x3" if route == "tf32"
                else "float32")
        out = {}
        for bb, shape in vit_shapes.items():
            t = vit_timing[(bb, dtype)]["bwd" if bwd else "fwd"]
            bound = _flash_bounds(*shape, peak)[bwd]
            out[f"also_at_vit_b{bb}"] = {
                "ms": t[route], "device_ms": t[f"{route}_device"], "host_ms": t[f"{route}_host"],
                "plain_ms": t["plain"], "bound_ms": bound[0], "bound_by": bound[1],
                "exp_floor_ms": _exp_floor_ms(*shape[:3], exp_per_s)[bwd],
                "library_ms": t["library"], "library_device_ms": t["library_device"],
                "shape": f"(B, H, T, S) = {shape} {dtype}, no mask (the ViT tower)"}
        return out

    def head_dim_entries(bwd, dtype, route="simt"):
        """The flash entry of ``route`` at head dims 4 (the CUDA cores only)
        and 64 (phases kernel and kernel-bwd, (B, H, 36, S), no mask), under
        also_at_h4 and also_at_h64."""
        tm, out = bwd_timing if bwd else timing, {}
        peak = ("bfloat16" if dtype == "bfloat16" else "tf32x3" if route == "tf32"
                else "float32")
        cases = (("h4", (BATCH, 2, 36, 4)),) if route == "simt" else ()
        for case, shape in (*cases, ("h64", (BATCH, 2, 36, 64))):
            t = tm[(case, dtype)]
            bound = _flash_bounds(*shape, peak)[bwd]
            out[f"also_at_{case}"] = {
                "ms": t[route], "device_ms": t[f"{route}_device"],
                "host_ms": t[f"{route}_host"],
                "exp_floor_ms": _exp_floor_ms(*shape[:3], exp_per_s)[bwd],
                "plain_ms": t["plain"], "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": t["library"], "library_device_ms": t["library_device"],
                "shape": f"(B, H, T, S) = {shape} {dtype}, no mask"}
        return out

    measured = {  # name: (launches, max_abs_err, the rest of the entry)
        "flash_attention_fwd": (0, fwd_err["simt"], {
            **flash("simt", 0), **vit_entries(0, "bfloat16"), **head_dim_entries(0, "bfloat16"),
            "float32": {**flash("simt", 0, "float32"), **vit_entries(0, "float32"),
                        **head_dim_entries(0, "float32")},
            "norm_err_float32": fwd_norm[("simt", "float32")], "vit_max_abs_err": vit_err}),
        "flash_attention_bwd": (1, bwd_err["simt"], {
            **flash("simt", 1), **vit_entries(1, "bfloat16"), **head_dim_entries(1, "bfloat16"),
            "float32": {**flash("simt", 1, "float32"), **vit_entries(1, "float32"),
                        **head_dim_entries(1, "float32")},
            "norm_err_float32": bwd_norm[("simt", "float32")], "vit_max_abs_err": vit_err}),
        "flash_attention_fwd_mma": (2, fwd_err["mma"], {
            **flash("mma", 0), **vit_entries(0, "bfloat16", "mma"),
            **head_dim_entries(0, "bfloat16", "mma"), "norm_err": fwd_norm[("mma", "bfloat16")],
            "registered_op_dispatch": dispatch}),
        "flash_attention_bwd_mma": (3, bwd_err["mma"], {
            **flash("mma", 1), **vit_entries(1, "bfloat16", "mma"),
            **head_dim_entries(1, "bfloat16", "mma"), "norm_err": bwd_norm[("mma", "bfloat16")],
            "wrong_dq_norm_err": {n: e for (n, d), e in bwd_control.items()
                                  if d == "bfloat16"}}),
        "flash_attention_fwd_tf32": (12, fwd_err["tf32"], {
            **flash("tf32", 0, "float32"), **vit_entries(0, "float32", "tf32"),
            **head_dim_entries(0, "float32", "tf32"), "norm_err": fwd_norm[("tf32", "float32")]}),
        "flash_attention_bwd_tf32": (13, bwd_err["tf32"], {
            **flash("tf32", 1, "float32"), **vit_entries(1, "float32", "tf32"),
            **head_dim_entries(1, "float32", "tf32"), "norm_err": bwd_norm[("tf32", "float32")],
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
    f32_bounds = {"lc": _qkv_bounds(*QKV_LC, "float32"), "sp": _qkv_bounds(*QKV_SP, "float32")}
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
        if route == "simt":  # float32, the route's own type, at both shapes
            measured[name][2]["float32"] = {
                case: {**entry(qkv_timing[case + "_f32"]),
                       "shape": f"(B, T, E, H) = {shape} float32",
                       "bound_ms": f32_bounds[case][bwd][0],
                       "bound_by": f32_bounds[case][bwd][1]}
                for case, shape in (("lc", QKV_LC), ("sp", QKV_SP))}
    # phase ensemble's stacked checks: the launch for N members against N separate ones
    for (kernel, route), st in stacked.items():
        n, bb, t, e, h = st["shape"]
        for way in ("fwd", "bwd"):
            name = f"fused_{kernel}_{way}" + ("_mma" if route == "mma" else "")
            measured[name][2]["stacked"] = {
                "members": n, "device_ms": st["times"][way][0],
                "separate_device_ms": st["times"][way][1], "max_abs_err": st[way],
                "shape": (f"N = {n} members of " + (f"(N, E, F) = {(bb * t, e, 4 * e)}"
                                                    if kernel == "ffn" else
                                                    f"(B, T, E, H) = {(bb, t, e, h)}")
                          + f" {st['dtype']}")}
    bounds = _kernel_bounds()
    log(f"smoke: every phase passed in {time.perf_counter() - _T0:.1f} s of wall")
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
    if len(sys.argv) == 5 and sys.argv[1] == "--dp-rank":  # one rank of phase dp, tp or stream-dp
        sys.exit(_dp_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
    main()
