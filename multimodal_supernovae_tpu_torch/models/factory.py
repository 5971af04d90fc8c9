"""Rebuild a model from a run directory, and the builders of the two-stage
recipe (port of the run-dir and builder halves of
multimodal_supernovae_tpu/models/factory.py).

A servable run directory holds:
  * ``model_config.json``, the JAX package's self-describing sidecar,
    ``{"model": ..., "config": {...}, "extra": {...}}`` for one of three
    families, ``CLIPModel``, ``MaskedLightCurveEncoder`` and ``ClipMLPHead``
    (read with ``json``; no YAML);
  * a reference-layout ``*.ckpt`` (``torch.save`` of ``{"state_dict": ...}``).

``Trainer.fit(run_dir=...)`` writes both (``epoch=E-step=S.ckpt`` for the
best epochs, ``last.ckpt`` for the latest), so a run the port trained serves
as it is. A run trained by the JAX package becomes one in two steps:
``mmsn-export-torch`` writes the ``.ckpt`` into an output directory, then the
run's ``model_config.json`` is copied beside it. A reference run dir, which
has no sidecar, rebuilds from its ``config.yaml`` and the sweep directory's
``sweep_config.yaml`` (``initialize_from_run_dir``).

"Best" means two things. ``pick_reference_ckpt(which="best")``, and so
``load_model``, keeps the reference's rule, the smallest-epoch ``epoch=``
file, which with two kept is the earlier of the two and not always the
better one. ``training.checkpoint.best_ckpt_path`` is the monitored best
(``summary.json``'s ``best_ckpt_epoch``), which the fine-tune builder and
the pretrained-weight surgery load, as the JAX package's
``restore_run_variables(which="best")`` does.

The builders (``masked_model_builder``, ``finetune_model_builder``) return
``builder(run_cfg, extra, nband) -> (model, task, freeze, override)``:
``freeze`` a parameter-path predicate for the optimizer or None,
``override(state_dict) -> state_dict`` the weight surgery or None
(training/experiment.py applies both).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..config.yaml_subset import load as load_yaml
from .clip import CLIPConfig, CLIPModel
from .clip_mlp import ClipMLPConfig, ClipMLPHead
from .pretraining import MaskedEncoderConfig, MaskedLightCurveEncoder

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


# sidecar name: (model class, config class), the JAX package's three families
FAMILIES = {"CLIPModel": (CLIPModel, CLIPConfig),
            "MaskedLightCurveEncoder": (MaskedLightCurveEncoder, MaskedEncoderConfig),
            "ClipMLPHead": (ClipMLPHead, ClipMLPConfig)}


def read_model_config(run_dir: str) -> Tuple[Any, Dict[str, Any]]:
    """(config, extra) from the run directory's sidecar: a ``CLIPConfig``,
    ``MaskedEncoderConfig`` or ``ClipMLPConfig``, as the sidecar names."""
    path = os.path.join(run_dir, MODEL_CONFIG_SIDECAR)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: a run dir that Trainer.fit(run_dir=...) wrote has "
            f"one; for a JAX run, copy its {MODEL_CONFIG_SIDECAR} beside the "
            ".ckpt that mmsn-export-torch wrote")
    with open(path) as f:
        payload = json.load(f)
    if payload.get("model") not in FAMILIES:
        raise ValueError(f"unknown model family {payload.get('model')!r} in {path}: "
                         f"expected one of {sorted(FAMILIES)}")
    cfg_cls = FAMILIES[payload["model"]][1]
    return cfg_cls.from_dict(payload["config"]), dict(payload.get("extra", {}))


def model_of(cfg, generator: Optional[torch.Generator] = None):
    """The model of a config read from a sidecar, with fresh weights."""
    for model_cls, cfg_cls in FAMILIES.values():
        if isinstance(cfg, cfg_cls):
            return model_cls(cfg, generator)
    raise TypeError(f"no model family takes a {type(cfg).__name__}")


def initialize_from_run_dir(run_dir: str, combinations=None
                            ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """(a model with fresh weights, the run config, the extra args) of a run
    directory, as the JAX package's ``initialize_from_run_dir`` rebuilds it.

    A run dir with a ``model_config.json`` sidecar rebuilds from it: the
    exact configuration of any of the three families, no sweep directory
    needed. ``combinations`` rebuilds a ``CLIPModel`` with other towers; a
    masked or ``ClipMLPHead`` run asked for other towers than its own is
    rebuilt from its sweep config instead. The run config is the run's
    ``config.yaml`` (empty without one) with the facts the JAX package fills
    in: ``enc_dim`` from the CLIP config, and for a masked run ``f_mask``
    and ``n_out``.

    A run dir without the sidecar (the reference's own) rebuilds from its
    ``config.yaml`` and the sweep's ``sweep_config.yaml`` (the reference's
    ``initialize_model``: nband 2, the softmax loss): a masked-pretraining
    run (``f_mask``, no ``pretrain_path``) as a ``MaskedLightCurveEncoder``;
    a supervised run with a ``pretrain_path`` as a ``ClipMLPHead`` over the
    CLIP config of the pretrained run, rebuilt the same way; a contrastive
    fine-tune without ``n_out`` as its pretrained run's model; anything else
    through ``build_clip_config``."""
    if os.path.exists(os.path.join(run_dir, MODEL_CONFIG_SIDECAR)):
        cfg, extra = read_model_config(run_dir)
        if combinations is not None:
            if isinstance(cfg, CLIPConfig):
                cfg = dataclasses.replace(cfg, combinations=tuple(combinations))
                extra = dict(extra, combinations=list(combinations))
            elif sorted(combinations) != sorted(extra.get("combinations", [])):
                cfg = None  # other towers: the sweep-schema rebuild below
        if cfg is not None:
            cfg_path = os.path.join(run_dir, "config.yaml")
            run_cfg = (load_yaml(cfg_path) or {}) if os.path.exists(cfg_path) else {}
            base = getattr(cfg, "clip", cfg)
            if hasattr(base, "enc_dim"):
                run_cfg.setdefault("enc_dim", int(base.enc_dim))
            if hasattr(cfg, "f_mask"):
                run_cfg.setdefault("f_mask", float(cfg.f_mask))
                run_cfg.setdefault("n_out", int(cfg.tk().get("n_out", 1)))
            return model_of(cfg), run_cfg, extra
    return _initialize_from_sweep_schema(run_dir, combinations)


def _initialize_from_sweep_schema(run_dir: str, combinations=None):
    """``initialize_from_run_dir`` from ``config.yaml`` and the sweep's
    ``sweep_config.yaml``."""
    from ..config.config import build_clip_config

    run_cfg, extra = load_run_config(run_dir)
    if combinations is not None:
        extra = dict(extra, combinations=list(combinations))
    extra = dict(extra, loss="softmax")
    pretrain = extra.get("pretrain_path")
    if "f_mask" in run_cfg and not pretrain:
        cfg = _masked_config(run_cfg, 2, n_out=int(run_cfg.get("n_out", 1)))
        return MaskedLightCurveEncoder(cfg), run_cfg, extra
    if pretrain and (extra.get("regression") or extra.get("classification")):
        clip_model, _, _ = initialize_from_run_dir(pretrain, combinations=extra["combinations"])
        head = ClipMLPHead(ClipMLPConfig(
            clip=clip_model.cfg, combinations=tuple(extra["combinations"]),
            hidden_dim=int(run_cfg.get("hidden_dim", 32)),
            num_layers=int(run_cfg.get("num_layers", 2)),
            dropout=float(run_cfg.get("dropout", 0.0)),
            regression=bool(extra.get("regression", False)),
            classification=bool(extra.get("classification", False)),
            n_classes=int(extra.get("n_classes", 5))))
        return head, run_cfg, extra
    if pretrain and "n_out" not in run_cfg:
        # a contrastive fine-tune's sweep may leave out the architecture:
        # it is the pretrained run's
        model, _, _ = initialize_from_run_dir(pretrain, combinations=extra["combinations"])
        return model, run_cfg, extra
    return CLIPModel(build_clip_config(run_cfg, extra, nband=2)), run_cfg, extra


def write_model_config(run_dir: str, model) -> bool:
    """Write the sidecar in the JAX package's schema (``dump_model_config``),
    so either side reads it: the family's name, its config and the
    ``extra`` its consumers read. Returns False, writing nothing, for a
    module of no family (its run dir then needs its sweep config)."""
    name = type(model).__name__
    if name not in FAMILIES:
        return False
    cfg = model.cfg
    if name == "MaskedLightCurveEncoder":
        extra = {"combinations": ["lightcurve"], "nband": int(cfg.nband)}
    else:
        extra = {"combinations": list(cfg.combinations),
                 "nband": int(getattr(cfg, "clip", cfg).nband),
                 "regression": bool(cfg.regression),
                 "classification": bool(cfg.classification),
                 "n_classes": int(cfg.n_classes)}
    payload = {"model": name, "config": dataclasses.asdict(cfg), "extra": extra}
    with open(os.path.join(run_dir, MODEL_CONFIG_SIDECAR), "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    return True


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


def load_model(run_dir: str, device="cuda", which: str = "best") -> Tuple[Any, Dict[str, Any]]:
    """(model in eval mode on ``device``, extra) from a run dir: the
    ``CLIPModel``, ``MaskedLightCurveEncoder`` or ``ClipMLPHead`` that
    ``initialize_from_run_dir`` rebuilds (from the sidecar, else from the
    sweep config), from ``pick_reference_ckpt(run_dir, which)`` loaded with
    ``strict=True``. Runs on the card unless the caller asks for the CPU,
    and raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    model, _, extra = initialize_from_run_dir(run_dir)
    ckpt = torch.load(pick_reference_ckpt(run_dir, which), map_location="cpu",
                      weights_only=True)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    return model.to(device).eval(), extra


# -- model builders for the entry points -----------------------------------


def _load_pretrained_params(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict, on the host, of a pretrained port run dir's monitored
    best checkpoint (``training.checkpoint.best_ckpt_path``), or of the
    ``.ckpt`` file ``path``."""
    from ..training.checkpoint import best_ckpt_path

    ckpt = best_ckpt_path(path) if os.path.isdir(path) else path
    return torch.load(ckpt, map_location="cpu", weights_only=True)["state_dict"]


def _seeded(run_cfg: Dict[str, Any]) -> torch.Generator:
    return torch.Generator().manual_seed(int(run_cfg.get("seed", 0)))


def finetune_model_builder(extra: Dict[str, Any]):
    """The fine-tune builder (the JAX package's, for the CLIP fine-tune
    entry point): ``builder(run_cfg, extra, nband) -> (model, task, freeze,
    override)``. The architecture comes from the pretrained run dir
    ``extra["pretrain_path"]`` (its sidecar, with ``extra``'s
    combinations), its monitored best weights load non-strictly through
    ``override(state_dict) -> state_dict``. With ``regression`` or
    ``classification`` the model is a ``ClipMLPHead`` (``hidden_dim``,
    ``num_layers`` and ``dropout`` from the run config, its MLP drawn from
    the run's seed) whose ``clip_model.*`` is merged from the pretrained
    run; otherwise contrastive training continues. ``freeze_backbone``
    freezes both sequence encoders but their projections."""
    from ..training.checkpoint import merge_params_nonstrict
    from ..training.optim import freeze_encoders_except_projection

    pretrain_dir = extra["pretrain_path"]
    regression = bool(extra.get("regression", False))
    classification = bool(extra.get("classification", False))
    freeze = (freeze_encoders_except_projection(["lightcurve_encoder", "spectral_encoder"])
              if extra.get("freeze_backbone") else None)

    def builder(run_cfg, _extra, nband):
        model, _, _ = initialize_from_run_dir(pretrain_dir, combinations=extra["combinations"])
        pre = _load_pretrained_params(pretrain_dir)
        if not (regression or classification):
            return model, "contrastive", freeze, lambda sd: merge_params_nonstrict(sd, pre)
        head = ClipMLPHead(ClipMLPConfig(
            clip=model.cfg, combinations=tuple(extra["combinations"]),
            hidden_dim=int(run_cfg.get("hidden_dim", 32)),
            num_layers=int(run_cfg.get("num_layers", 2)),
            dropout=float(run_cfg.get("dropout", 0.0)), regression=regression,
            classification=classification, n_classes=int(extra.get("n_classes", 5))),
            generator=_seeded(run_cfg))

        def override(sd):
            clip = {k[len("clip_model."):]: v for k, v in sd.items()
                    if k.startswith("clip_model.")}
            merged = merge_params_nonstrict(clip, pre)
            return {**sd, **{"clip_model." + k: v for k, v in merged.items()}}

        return head, "regression" if regression else "classification", freeze, override

    return builder


def masked_model_builder(extra: Dict[str, Any]):
    """The masked-pretraining builder: a ``MaskedLightCurveEncoder`` from the
    grid's ``f_mask`` (0.15 when absent), ``emb``, ``heads``,
    ``transformer_depth``, ``dropout`` and ``time_norm`` keys, n_out 1, its
    weights drawn from the run's seed."""

    def builder(run_cfg, _extra, nband):
        return (MaskedLightCurveEncoder(_masked_config(run_cfg, nband), _seeded(run_cfg)),
                "masked", None, None)

    return builder


def _masked_config(run_cfg: Dict[str, Any], nband: int, n_out: int = 1) -> MaskedEncoderConfig:
    """The masked pretrainer's config from a grid point's ``f_mask`` (0.15
    when absent), ``emb``, ``heads``, ``transformer_depth``, ``dropout`` and
    ``time_norm`` keys."""
    return MaskedEncoderConfig.create(
        f_mask=float(run_cfg.get("f_mask", 0.15)), nband=nband,
        transformer_kwargs={
            "n_out": n_out,
            "emb": int(run_cfg.get("emb", 128)),
            "heads": int(run_cfg.get("heads", 2)),
            "depth": int(run_cfg.get("transformer_depth", 4)),
            "dropout": float(run_cfg.get("dropout", 0.0)),
            "time_norm": float(run_cfg.get("time_norm", 10000.0)),
        })
