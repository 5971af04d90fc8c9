"""multimodal_supernovae_tpu_torch — the PyTorch/CUDA port of
``multimodal_supernovae_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference: every module here mirrors one
of its modules by name and is held against it by ``tests/test_torch_*.py``.
This package imports ``torch`` and never ``jax``.

Ported so far (the serving path, eval mode only):
  ops       dense attention (the plain version) and the flash-attention
            forward wrapper over a hand-written CUDA kernel
  csrc      CUDA C++ kernel sources, built at first use by ``kernels.build``
  models    sequence encoder, CLIP model (lightcurve + spectral towers),
            the JAX-params -> state_dict bridge, run-dir loading
  data      the synthetic generator (lightcurve + spectral part)
  serving   ``load_live``: a run directory served through the JAX package's
            numpy-only dynamic batcher and HTTP daemon
  cli       ``python -m multimodal_supernovae_tpu_torch.cli.serve``
"""

__version__ = "0.1.0"
