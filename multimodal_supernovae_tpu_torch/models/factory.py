"""Rebuild a model from a run directory (port of the run-dir half of
multimodal_supernovae_tpu/models/factory.py).

A servable run directory holds:
  * ``model_config.json``, the JAX package's self-describing sidecar,
    ``{"model": "CLIPModel", "config": {...CLIPConfig fields...},
    "extra": {...}}`` (read with ``json``; no YAML);
  * a reference-layout ``*.ckpt`` (``torch.save`` of ``{"state_dict": ...}``).

``Trainer.fit(run_dir=...)`` writes both (``epoch=E-step=S.ckpt`` for the
best epochs, ``last.ckpt`` for the latest), so a run the port trained serves
as it is. A run trained by the JAX package becomes one in two steps:
``mmsn-export-torch`` writes the ``.ckpt`` into an output directory, then the
run's ``model_config.json`` is copied beside it.

``pick_reference_ckpt(which="best")`` keeps the reference's rule, the
smallest-epoch ``epoch=`` file, which with two kept is the earlier of the two
and not always the better one; ``training.checkpoint.CheckpointManager.
restore(which="best")`` restores the monitored best.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import torch

from ..config.yaml_subset import load as load_yaml
from .clip import CLIPConfig, CLIPModel

MODEL_CONFIG_SIDECAR = "model_config.json"


def load_run_config(run_dir: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(flattened run config, sweep extra_args) of a run directory: its own
    ``config.yaml`` and the parent sweep directory's ``sweep_config.yaml``,
    or, for a run without a sweep directory, the ``extra`` of its
    ``model_config.json`` sidecar."""
    run_cfg = load_yaml(os.path.join(run_dir, "config.yaml"))
    sweep_path = os.path.join(os.path.dirname(os.path.abspath(run_dir)),
                              "sweep_config.yaml")
    sidecar = os.path.join(run_dir, MODEL_CONFIG_SIDECAR)
    if not os.path.exists(sweep_path) and os.path.exists(sidecar):
        with open(sidecar) as f:
            return run_cfg, json.load(f).get("extra", {})
    return run_cfg, load_yaml(sweep_path).get("extra_args", {})


def read_model_config(run_dir: str) -> Tuple[CLIPConfig, Dict[str, Any]]:
    """(config, extra) from the run directory's sidecar."""
    path = os.path.join(run_dir, MODEL_CONFIG_SIDECAR)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: a run dir that Trainer.fit(run_dir=...) wrote has "
            f"one; for a JAX run, copy its {MODEL_CONFIG_SIDECAR} beside the "
            ".ckpt that mmsn-export-torch wrote")
    with open(path) as f:
        payload = json.load(f)
    if payload.get("model") != "CLIPModel":
        raise NotImplementedError(
            f"model family {payload.get('model')!r} is not ported yet "
            "(ROADMAP.md queue 1, items 12-13); the port serves CLIPModel")
    return CLIPConfig.from_dict(payload["config"]), dict(payload.get("extra", {}))


def initialize_from_run_dir(run_dir: str, combinations=None
                            ) -> Tuple[CLIPModel, Dict[str, Any], Dict[str, Any]]:
    """(a model with fresh weights, the run config, the sidecar's extra) from
    a run directory's ``model_config.json``: the exact configuration, no
    sweep directory needed. ``combinations`` rebuilds it with other towers.
    The run config is the run's ``config.yaml`` (empty without one) with
    ``enc_dim`` filled in from the model, as the JAX package fills it.

    Run directories without the sidecar (the reference's own, rebuilt from
    their sweep config) are not ported yet (ROADMAP.md queue 1, item 14)."""
    if not os.path.exists(os.path.join(run_dir, MODEL_CONFIG_SIDECAR)):
        raise NotImplementedError(
            f"{run_dir} has no {MODEL_CONFIG_SIDECAR}: rebuilding a reference run "
            "dir from its sweep config is not ported yet (ROADMAP.md queue 1, item 14)")
    cfg, extra = read_model_config(run_dir)
    if combinations is not None:
        cfg = dataclasses.replace(cfg, combinations=tuple(combinations))
        extra = dict(extra, combinations=list(combinations))
    cfg_path = os.path.join(run_dir, "config.yaml")
    run_cfg = (load_yaml(cfg_path) or {}) if os.path.exists(cfg_path) else {}
    run_cfg.setdefault("enc_dim", int(cfg.enc_dim))
    return CLIPModel(cfg), run_cfg, extra


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
