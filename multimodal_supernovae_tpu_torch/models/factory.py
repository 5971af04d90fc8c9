"""Rebuild a model from a run directory (port of the run-dir half of
multimodal_supernovae_tpu/models/factory.py).

A servable run directory holds:
  * ``model_config.json``, the JAX package's self-describing sidecar,
    ``{"model": "CLIPModel", "config": {...CLIPConfig fields...},
    "extra": {...}}`` (read with ``json``; no YAML);
  * a reference-layout ``*.ckpt`` (``torch.save`` of ``{"state_dict": ...}``).

A run trained by the JAX package becomes one in two steps: ``mmsn-export-torch``
writes the ``.ckpt`` into an output directory, then the run's
``model_config.json`` is copied beside it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import torch

from .clip import CLIPConfig, CLIPModel

MODEL_CONFIG_SIDECAR = "model_config.json"


def read_model_config(run_dir: str) -> Tuple[CLIPConfig, Dict[str, Any]]:
    """(config, extra) from the run directory's sidecar."""
    path = os.path.join(run_dir, MODEL_CONFIG_SIDECAR)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: copy the JAX run's {MODEL_CONFIG_SIDECAR} "
            "beside its exported .ckpt")
    with open(path) as f:
        payload = json.load(f)
    if payload.get("model") != "CLIPModel":
        raise NotImplementedError(
            f"model family {payload.get('model')!r} is not ported yet "
            "(ROADMAP.md queue 1, items 12-13); the port serves CLIPModel")
    return CLIPConfig.from_dict(payload["config"]), dict(payload.get("extra", {}))


def write_model_config(run_dir: str, model: CLIPModel):
    """Write the sidecar in the JAX package's schema, so either side reads it."""
    cfg = model.cfg
    payload = {
        "model": "CLIPModel",
        "config": dataclasses.asdict(cfg),
        "extra": {"combinations": list(cfg.combinations), "nband": int(cfg.nband),
                  "regression": bool(cfg.regression),
                  "classification": bool(cfg.classification),
                  "n_classes": int(cfg.n_classes)},
    }
    with open(os.path.join(run_dir, MODEL_CONFIG_SIDECAR), "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")


def pick_reference_ckpt(run_dir: str, which: str = "best") -> str:
    """The reference's choice: ``last.ckpt`` for which='last' when present,
    else the smallest-epoch ``epoch=E-...ckpt``, else any ``.ckpt``
    (entries that do not resolve, such as dangling symlinks, are skipped)."""
    ckpts = [f for f in os.listdir(run_dir)
             if f.endswith(".ckpt") and os.path.exists(os.path.join(run_dir, f))]
    if not ckpts:
        raise FileNotFoundError(f"no .ckpt checkpoint in {run_dir}")
    if which == "last" and "last.ckpt" in ckpts:
        return os.path.join(run_dir, "last.ckpt")
    epoch_ckpts = sorted((c for c in ckpts if c.startswith("epoch=")),
                         key=lambda c: int(c.split("=")[1].split("-")[0]))
    return os.path.join(run_dir, epoch_ckpts[0] if epoch_ckpts else ckpts[0])


def load_model(run_dir: str, device="cuda",
               which: str = "best") -> Tuple[CLIPModel, Dict[str, Any]]:
    """(model in eval mode on ``device``, sidecar extra) from a run dir; the
    checkpoint loads with ``strict=True``. Runs on the card unless the caller
    asks for the CPU, and raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    cfg, extra = read_model_config(run_dir)
    model = CLIPModel(cfg)
    ckpt = torch.load(pick_reference_ckpt(run_dir, which), map_location="cpu",
                      weights_only=True)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    return model.to(device).eval(), extra
