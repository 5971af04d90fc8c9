"""multimodal_supernovae_tpu_torch — the PyTorch/CUDA port of
``multimodal_supernovae_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference: every module here mirrors one
of its modules by name and is held against it by ``tests/test_torch_*.py``.
This package imports ``torch`` and never ``jax``.

Ported so far (the serving path, the contrastive, supervised and masked
training paths and their run directories, and training from a ZTF BTS data
directory through the CLIs):
  ops       dense attention and its autograd (the plain versions), the
            flash-attention forward and backward over hand-written CUDA
            kernels in one autograd Function, the losses and metrics
  csrc      CUDA C++ kernel sources, built at first use by ``kernels.build``
  models    sequence encoder (train mode with dropout), ConvMixer image
            tower (flax BatchNorm statistics), meta MLP, CLIP model (all
            four towers, contrastive ``loss_fn``, regression and
            classification heads), the JAX-params -> state_dict bridge,
            run-dir loading
  data      the batch contract, device-resident batching and index plans,
            magnitude/flux noise and image noise and rotation, the
            synthetic generator, the ZTF BTS ingest (a native CSV reader
            in csrc/fastcsv.cpp, a PNG decoder, extinction, transforms),
            the stratified folds and random split, the array cache
  config    the sweep files of configs/ (a YAML reader of its own, the
            grid, the schedulers, the model and trainer config builders)
  training  RAdam + StepLR + freezing, the train/eval steps and epoch
            loops, ``Trainer.fit`` for the contrastive, regression and
            classification tasks with run directories, best-k and last
            checkpoints (BatchNorm buffers included) and resume, the
            sequential sweep runner (``run_sweep``), stacked ensemble
            members, data-parallel training over ranks (``mesh``)
  parallel  the data mesh: a process group a card (torchrun), the
            differentiable all-gather and all-reduce, global BatchNorm
            statistics, the gradient mean
  evaluation ``get_embeddings``, ``predict_supervised``, the probes and
            reports, and the serving artifact (``export_encoder`` /
            ``load_exported`` over ``torch.export``, the kernels' forwards
            as registered ops)
  utils     ``MetricsLogger`` (metrics.jsonl, summary.json), IO helpers,
            seeding, draw sources, device selection, the profiler trace
            and throughput meter, model FLOPs and the H100's MFU
  serving   ``load_live`` (a run directory) and ``load_artifact`` (an
            exported encoder, no model code) served through the port's
            numpy-only dynamic batcher and HTTP daemon
  cli       ``python -m multimodal_supernovae_tpu_torch <command>`` over the
            JAX package's commands (``export-torch`` refuses), each also
            ``python -m multimodal_supernovae_tpu_torch.cli.<name>``
"""

__version__ = "0.1.0"
