"""Serve a run directory's embeddings from PyTorch (port of ``load_live``
in multimodal_supernovae_tpu/serving/server.py).

The host side is the JAX package's numpy-only serving code, imported as it
is: ``DynamicBatcher`` coalesces requests onto a fixed device batch and
``EmbedServer`` answers ``/embed``, ``/healthz`` and ``/stats``. Neither
module imports jax. This module supplies the model: ``load_live`` returns a
``ServingModel`` whose ``fn`` runs ``CLIPModel.encode`` on ``device``.

The input contract is the JAX one: ``x_lc, t_lc, mask_lc`` of width
``nband * lc_len`` and ``x_sp, t_sp, mask_sp`` of width ``sp_len``
(float32, float32, bool); one float32 ``(n, enc_dim)`` output per modality.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from multimodal_supernovae_tpu.serving.server import ServingModel

from ..models.clip import MODALITIES
from ..models.factory import load_model

__all__ = ["load_live", "input_spec"]


def input_spec(combinations, nband: int, lc_len: int, sp_len: int) -> Dict:
    """``{field: (trailing shape, dtype)}`` of the fields encode reads."""
    spec = {}
    if "lightcurve" in combinations:
        w = nband * lc_len
        spec.update(x_lc=((w,), "float32"), t_lc=((w,), "float32"),
                    mask_lc=((w,), "bool"))
    if "spectral" in combinations:
        spec.update(x_sp=((sp_len,), "float32"), t_sp=((sp_len,), "float32"),
                    mask_sp=((sp_len,), "bool"))
    return spec


def load_live(run_dir: str, batch_size: int, device="cuda", which: str = "best",
              lc_len: Optional[int] = None,
              sp_len: Optional[int] = None) -> ServingModel:
    """Serve straight from a run directory (``model_config.json`` + a
    reference-layout ``.ckpt``) on ``device``.

    ``fn`` moves the numpy feed to ``device``, runs ``encode`` under
    ``torch.inference_mode()`` (inside ``fn``: the batcher calls it from its
    own thread and inference mode is thread-local) and returns host numpy
    arrays, which the batcher's fetcher needs (it calls ``np.asarray`` on
    each output). The copy back is synchronous."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    model, extra = load_model(run_dir, device, which=which)
    combos = model.cfg.combinations
    spec = input_spec(
        combos, int(extra.get("nband", model.cfg.nband)),
        lc_len or int(extra.get("max_lightcurve_data_len", 100)),
        sp_len or int(extra.get("max_spectral_data_len", 1000)))

    def fn(feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        with torch.inference_mode():
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in feed.items()}
            return [o.float().cpu().numpy() for o in model.encode(batch)]

    return ServingModel(
        fn, spec, batch_size, [m for m in MODALITIES if m in combos],
        meta={"source": "run_dir", "path": run_dir, "which": which,
              "backend": "torch", "device": str(device)},
    )
