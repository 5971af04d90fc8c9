"""One grid point of a sweep: model, task, freezing, weight surgery and
trainer config (port of ``task_of``, ``_build_run`` and
``_default_pretrain_surgery`` in multimodal_supernovae_tpu/training/experiment.py).

The pretrained-weight paths of a sweep's ``extra_args`` name a port run
directory, whose monitored best checkpoint is loaded
(``training.checkpoint.best_ckpt_path``: ``summary.json``'s ``best_ckpt_epoch``),
or one ``.ckpt`` file of such a run; so does ``finetune_model_builder``'s
``pretrain_path``, which must be a run directory (its sidecar gives the
architecture). The surgery is a function of a
state_dict, and the caller applies it::

    model, task, freeze, override, tcfg = _build_run(run_cfg, extra, 2, None, None)
    if override is not None:
        model.load_state_dict(override(model.state_dict()), strict=True)
    Trainer(model, task, tcfg, freeze=freeze, ...).fit(...)

Not ported yet: ``run_sweep``, the sweep directories and the post-fit reports
(ROADMAP.md queue 1, item 16), which need the data ingest and the fold
split (item 17).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..config.config import build_clip_config, build_trainer_config
from ..models.clip import CLIPModel
from ..models.factory import _load_pretrained_params
from .checkpoint import graft_masked_pretrain_into_clip, merge_params_nonstrict
from .optim import freeze_encoder_except_projection, freeze_encoders_except_projection


def task_of(extra: Dict[str, Any]) -> str:
    if extra.get("regression"):
        return "regression"
    if extra.get("classification"):
        return "classification"
    return "contrastive"


def _build_run(run_cfg: Dict[str, Any], extra: Dict[str, Any], nband: int,
               model_builder: Optional[Callable], epochs_override: Optional[int]
               ) -> Tuple[Any, str, Optional[Callable], Optional[Callable], Any]:
    """(model, task, freeze, override, trainer config) for one grid point.
    ``model_builder(run_cfg, extra, nband)`` (models.factory's builders)
    gives the first four; without one the model is a ``CLIPModel`` of the
    grid point, its weights drawn from the run's seed, with the default
    surgery (``_default_pretrain_surgery``)."""
    if model_builder is not None:
        model, task, freeze, override = model_builder(run_cfg, extra, nband)
    else:
        model = CLIPModel(build_clip_config(run_cfg, extra, nband),
                          generator=torch.Generator().manual_seed(int(run_cfg.get("seed", 0))))
        task = task_of(extra)
        freeze, override = _default_pretrain_surgery(run_cfg, extra, model)
    tcfg = build_trainer_config(run_cfg, extra)
    if epochs_override is not None:
        tcfg.epochs = epochs_override
    return model, task, freeze, override, tcfg


def _default_pretrain_surgery(run_cfg, extra, model) -> Tuple[Optional[Callable],
                                                               Optional[Callable]]:
    """The reference's pretrained-weight paths, as (freeze, override):

      * ``pretrain_lc_path`` (with ``freeze_backbone_lc``): a masked
        pretrainer's encoder grafted into the light-curve tower, which is
        then frozen but its projection;
      * ``pretrain_path`` (with ``freeze_backbone``): a CLIP run merged
        non-strictly, both sequence encoders frozen but their projections.

    Either may be None. The checkpoint is read when ``override`` runs."""
    freeze = override = None
    lc_path, clip_path = extra.get("pretrain_lc_path"), extra.get("pretrain_path")
    if lc_path:
        if extra.get("freeze_backbone_lc"):
            freeze = freeze_encoder_except_projection("lightcurve_encoder")

        def override(sd):
            return graft_masked_pretrain_into_clip(sd, _load_pretrained_params(lc_path))
    elif clip_path:
        if extra.get("freeze_backbone"):
            freeze = freeze_encoders_except_projection(
                ["lightcurve_encoder", "spectral_encoder"])

        def override(sd):
            return merge_params_nonstrict(sd, _load_pretrained_params(clip_path))
    return freeze, override
