"""multimodal_supernovae_tpu_torch — the PyTorch/CUDA port of
``multimodal_supernovae_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference: every module here mirrors one
of its modules by name and is held against it by ``tests/test_torch_*.py``.
This package imports ``torch`` and never ``jax``.

Ported so far (the serving path, the contrastive and supervised training
paths and their run directories):
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
            synthetic generator, the classification head's class weights
  config    the sweep files of configs/ (a YAML reader of its own, the
            grid, the model and trainer config builders)
  training  RAdam + StepLR + freezing, the train/eval steps and epoch
            loops, ``Trainer.fit`` for the contrastive, regression and
            classification tasks with run directories, best-k and last
            checkpoints (BatchNorm buffers included) and resume
  evaluation ``get_embeddings``, ``predict_supervised``
  utils     ``MetricsLogger`` (metrics.jsonl, summary.json)
  serving   ``load_live``: a run directory served through the port's
            numpy-only dynamic batcher and HTTP daemon
  cli       ``python -m multimodal_supernovae_tpu_torch.cli.serve``
"""

__version__ = "0.1.0"
