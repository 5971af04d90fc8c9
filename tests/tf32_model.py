"""The TF32 split of csrc/tf32x3.cuh as numpy, shared by the CPU model of the
3xTF32 flash kernels (tests/test_torch_flash_tf32.py) and the card's bit for
bit check of the kernels' own split (tests/test_torch_flash_kernel.py). No
jax: the card's test files import this too."""

import numpy as np


def tf32(a):
    """cvt.rna.tf32.f32 on the int32 view: 10 mantissa bits, to nearest
    with ties away from zero, the 13 low bits cleared."""
    i = np.ascontiguousarray(a, np.float32).view(np.int32)
    return ((i + 0x1000) & -0x2000).view(np.float32)


def split(a):
    """(hi, lo), each a TF32 value, as csrc/tf32x3.cuh:split_tf32."""
    a = np.asarray(a, np.float32)
    hi = tf32(a)
    return hi, tf32(a - hi)
