"""Deterministic seeding (port of multimodal_supernovae_tpu/utils/seed.py).

The JAX version returns a root PRNG key beside the host generator; here the
second stream is a ``torch.Generator`` on the host. Both also seed the
legacy global generators (``np.random``, ``random``) and set
``PYTHONHASHSEED``, so a stray library call is reproducible."""

from __future__ import annotations

import os
import random
from typing import Tuple

import numpy as np
import torch


def set_seed(seed: int = 0) -> Tuple[np.random.Generator, torch.Generator]:
    """(host numpy generator, host torch generator) for the run."""
    np.random.seed(seed)
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return np.random.default_rng(seed), torch.Generator().manual_seed(seed)
