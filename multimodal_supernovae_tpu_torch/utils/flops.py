"""Analytic model-FLOP accounting for MFU (port of
multimodal_supernovae_tpu/utils/flops.py).

MFU = (model FLOPs executed per second) / (the card's peak FLOP/s). The
FLOP count is analytic from the architecture (matmul terms only:
elementwise, LayerNorm and softmax are left out, so the share is a slight
lower bound) and a train step costs 3x the forward (one forward and two
backward matmul passes), as in the JAX package.

The peak is the H100's dense peak for the step's compute type, from
NVIDIA's datasheet (the sparse figures halved): bf16 on the tensor cores,
TF32 on the tensor cores (a 3xTF32 kernel spends it three times over), and
float32 on the CUDA cores, which a float32 step's cuBLAS matmuls take
unless ``torch.backends.cuda.matmul.allow_tf32`` is set. The JAX package
divides by the bf16 peak for both dtypes, which holds on a TPU, whose
float32 matmuls run through the MXU at the bf16 rate; on the H100 that
would understate a float32 step's share about 15 times.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# dense peak FLOP/s of one card by compute type
PEAK_FLOPS = {
    "h100 sxm": {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12},
    "h100 pcie": {"bf16": 756e12, "tf32": 378e12, "fp32": 51e12},
    "cpu": {"bf16": 1e11, "tf32": 1e11, "fp32": 1e11},  # nominal, for smoke runs only
}


def transformer_tower_flops(
    seq_len: int, emb: int, depth: int, ff_hidden_mult: int = 4,
    n_out: int = 0,
) -> int:
    """Forward matmul FLOPs for ONE sample through a post-norm tower.

    Per block: q/k/v/unify projections (4 matmuls of (T,e)x(e,e)), the
    attention score/apply pair ((T,T)x(T,e) twice, all heads together), and
    the 2-layer ReLU MLP of width ff_hidden_mult*e. A matmul of (m,k)x(k,n)
    counts 2*m*k*n FLOPs.
    """
    t, e = seq_len, emb
    per_block = (
        4 * 2 * t * e * e          # kqv + unify
        + 2 * 2 * t * t * e        # scores + apply (summed over heads)
        + 2 * 2 * t * e * ff_hidden_mult * e  # ff in + out
    )
    head = 2 * t * e + (2 * e * n_out if n_out else 0)  # embed + projection
    return depth * per_block + head


def clip_train_step_flops(cfg, batch_size: int, t_lc: int, t_sp: int) -> int:
    """Model FLOPs for one optimizer step of the bimodal contrastive
    configuration (fwd + bwd = 3x fwd)."""
    tk, sk = dict(cfg.transformer_kwargs), dict(cfg.transformer_spectral_kwargs)
    fwd = 0
    if "lightcurve" in cfg.combinations:
        fwd += transformer_tower_flops(
            t_lc, tk["emb"], tk["depth"],
            tk.get("ff_hidden_mult", 4), tk["n_out"],
        )
    if "spectral" in cfg.combinations:
        fwd += transformer_tower_flops(
            t_sp, sk["emb"], sk["depth"],
            sk.get("ff_hidden_mult", 4), sk["n_out"],
        )
    return 3 * batch_size * fwd


def compute_type(dtype: torch.dtype = torch.float32) -> str:
    """The type a step's matmuls compute in: 'bf16', 'tf32' (float32 with
    TF32 matmuls allowed) or 'fp32'."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "fp32"


def chip_peak_flops(dtype: torch.dtype = torch.float32,
                    device_name: Optional[str] = None) -> float:
    """Peak FLOP/s of the card (``torch.cuda.get_device_name``, or
    ``device_name``) for ``compute_type(dtype)``; the CPU nominal without a
    card. Raises for a card the table does not hold."""
    if device_name is None:
        device_name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    name = device_name.lower()
    if "h100" in name and "nvl" not in name:
        key = "h100 pcie" if "pcie" in name else "h100 sxm"
    elif name == "cpu":
        key = "cpu"
    else:
        raise ValueError(f"no peak FLOP/s for {device_name!r}: PEAK_FLOPS holds "
                         f"{sorted(PEAK_FLOPS)}")
    return PEAK_FLOPS[key][compute_type(dtype)]


def mfu(step_flops: int, step_time_s: float, n_chips: int = 1,
        dtype: torch.dtype = torch.float32) -> Dict[str, float]:
    peak = chip_peak_flops(dtype) * n_chips
    achieved = step_flops / step_time_s
    return {
        "model_tflops_per_s": achieved / 1e12,
        "peak_tflops_per_s": peak / 1e12,
        "mfu_pct": 100.0 * achieved / peak,
    }
