#!/usr/bin/env python3
"""The float32 fused-QKV backward's D = rowsum(P o dP), read on one CUDA GPU:
the kernel as built from csrc/fused_qkv_bwd.cu (D summed around the dP of
each row's highest-scoring key) beside two variants made from the same
source: D summed around key 0's dP, as csrc/flash_attention_bwd.cu sums it,
and D in one running float32 sum, as the kernel summed it before. For each,
every layer's dx and dWqkv of one float32 maven-lite loss under
MMSN_FUSED_QKV=1 against float64, beside the plain version's
(chip_smoke.py:_qkv_grad_probe), and the near-equal inputs of
tests/test_torch_qkv_attention_kernel.py (_near_equal_errors).

  python3 probe_qkv_d.py       # from the repository root, one GPU

Prints one JSON line {"probe_qkv_d": {variant: {"layers": {"dx": [ratio,
layer], "dwqkv": [...]}, "near_equal": {shape: {output: [kernel, plain]}}}}}
and exits non-zero without CUDA or when a variant does not build.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs
import multimodal_supernovae_tpu_torch.ops.qkv_attention as qkv_mod
from multimodal_supernovae_tpu_torch.kernels.build import CSRC_DIR, NVCC_FLAGS, _nvcc

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
import test_torch_qkv_attention_kernel as qkv_tests  # noqa: E402

SHIFT = "        load_row<S>(V + um * S, r);\n        const float c0 = dot<S>(gh, r);"
VARIANTS = {  # name: the source's D shift replaced by
    "key 0": SHIFT.replace("V + um * S", "V"),
    "running sum": "        const float c0 = 0.f;",
}
NEAR_EQUAL_SHAPES = ((64, 200, 64, 8), (64, 220, 32, 2))


def _variant(tmp: str, name: str, shift: str):
    """The entry point of csrc/fused_qkv_bwd.cu with its D shift replaced."""
    src = (CSRC_DIR / "fused_qkv_bwd.cu").read_text()
    if src.count(SHIFT) != 1:
        raise RuntimeError("csrc/fused_qkv_bwd.cu no longer holds the D shift this probe edits")
    path = os.path.join(tmp, name.replace(" ", "_") + ".cu")
    with open(path, "w") as f:
        f.write(src.replace(SHIFT, shift))
    lib = path[:-3] + ".so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", lib, path],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib).mmsn_fused_qkv_bwd
    fn.argtypes = qkv_mod._ARGTYPES["fused_qkv_bwd"]
    fn.restype = ctypes.c_int
    return fn


def main():
    cs.phase_device()
    built = qkv_mod._entry("fused_qkv_bwd")
    batch = cs._probe_batch()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        entries = {"as built": built}
        entries.update((name, _variant(tmp, name, shift)) for name, shift in VARIANTS.items())
        try:
            for name, fn in entries.items():
                qkv_mod._bound["fused_qkv_bwd"] = fn
                cs.log(f"probe-qkv-d: D {name}")
                layers = cs._qkv_grad_probe(batch)
                near = {str(shape): qkv_tests._near_equal_errors(shape, 40)
                        for shape in NEAR_EQUAL_SHAPES}
                cs.log(f"probe-qkv-d: D {name}: near-equal (kernel, plain) max|x - float64| "
                       f"/ max|float64|: {near}")
                out[name] = {"layers": layers, "near_equal": near}
        finally:
            qkv_mod._bound["fused_qkv_bwd"] = built
    print(json.dumps({"probe_qkv_d": out}), flush=True)


if __name__ == "__main__":
    main()
