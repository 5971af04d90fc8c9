"""Sweeps: the sweep directory, the sequential sweep runner, and one grid
point's model, task, freezing, weight surgery and trainer config (port of
multimodal_supernovae_tpu/training/experiment.py).

A sweep writes the JAX package's on-disk contract::

  <analysis>/<sweep_name>/sweep_config.yaml          (JSON, which YAML reads)
  <analysis>/<sweep_name>/run-<k>/config.yaml, {train,val}_filenames.txt,
      model_config.json, metrics.jsonl, summary.json, epoch=*.ckpt, last.ckpt

``run_sweep`` trains the grid points one after another: seed, fold or
random split (``data/folds.py:split_for_run``), model, surgery, then
``Trainer.fit`` on the device asked for. With ``resume`` a grid point whose
run directory holds ``summary.json`` is skipped (the reference's
continue-sweep semantics) and its recorded objective still feeds the
scheduler; an unfinished one continues from its ``last.ckpt``.

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

``parallel_folds`` trains the grid points that differ only in
``foldnumber`` as one stacked program (``training/ensemble.py``), and
``parallel_members`` those that differ in ``seed`` and ``lr`` too, into the
same ``run-<k>`` directories; each member's model is built from its own
seed with ``_build_run``'s surgery, as the sequential loop builds it.

``mesh`` (a ``parallel.mesh.DataMesh``) trains each grid point over the
ranks' ``(data, model)`` mesh (``Trainer(mesh=...)``), or, with
``parallel_folds`` / ``parallel_members``, each group's members over its
data axis (``fit_members(mesh=...)``); every rank walks the same schedule,
since every rank sees the same metrics.

``run_sweep_streaming`` walks a sweep over a sharded cache
(data/streaming.py) through ``Trainer.fit_sharded``.

Not ported yet: the post-fit reports (loss history and retrieval-curve
plots; ROADMAP.md queue 1, item 18b: they need matplotlib, which the GPU
host does not have), so neither runner writes them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config.config import (
    SweepConfig,
    SweepScheduler,
    build_clip_config,
    build_trainer_config,
)
from ..config.yaml_subset import dump as dump_yaml
from ..data.batching import ArrayDataset
from ..data.folds import split_for_run
from ..models.clip import CLIPModel
from ..models.factory import _load_pretrained_params
from ..utils.seed import set_seed
from .checkpoint import graft_masked_pretrain_into_clip, merge_params_nonstrict
from .optim import freeze_encoder_except_projection, freeze_encoders_except_projection
from .trainer import Trainer


def make_sweep_dir(sweep: SweepConfig, analysis_path: str, name: str) -> str:
    """``<analysis_path>/<name>/`` holding ``sweep_config.yaml``, the sweep
    file as read (written as JSON, which YAML readers take)."""
    sweep_dir = os.path.join(analysis_path, name)
    os.makedirs(sweep_dir, exist_ok=True)
    with open(os.path.join(sweep_dir, "sweep_config.yaml"), "w") as f:
        f.write(dump_yaml(sweep.raw))
    return sweep_dir


def completed_summary(run_dir: str) -> Optional[Dict[str, Any]]:
    """The run's ``summary.json`` if the run completed (the trainer writes
    it once, after the last epoch), else None: the continue-sweep marker."""
    path = os.path.join(run_dir, "summary.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _objective_from_summary(summary: Dict[str, Any], sweep: SweepConfig) -> Optional[float]:
    """The sweep objective of a completed run, from its summary, so that a
    resumed random or bayes schedule still observes the skipped run."""
    name = (sweep.metric or {}).get("name", "best_val_loss")
    if summary.get(name) is not None:
        return float(summary[name])
    if summary.get("best_val_loss") is not None:
        return float(summary["best_val_loss"])
    return None


def _skipped_result(run_dir: str, run_cfg, summary: Dict[str, Any]) -> Dict[str, Any]:
    """Result row of a run skipped because it already completed."""
    value = next(
        (v for k, v in summary.items()
         if k.startswith("best_")
         and k not in ("best_epoch", "best_ckpt_epoch", "best_val_loss", "best_auc")
         and v is not None),
        summary.get("best_val_loss"),
    )
    return {
        "run_dir": run_dir,
        "run_cfg": run_cfg,
        "skipped": True,
        "summary": summary,
        "best": {"value": value, "epoch": summary.get("best_epoch", -1)},
        "history": {"train_loss": [], "val_loss": []},
        "epochs_run": 0,
        "wall_time_s": 0.0,
    }


def _sweep_objective(res: Dict[str, Any], sweep: SweepConfig) -> Optional[float]:
    """The value a bayes schedule optimises: the least validation loss for
    ``best_val_loss`` (every shipped config's metric), else the trainer's
    monitored best."""
    name = (sweep.metric or {}).get("name", "best_val_loss")
    if name == "best_val_loss" and res["history"].get("val_loss"):
        return float(np.min(res["history"]["val_loss"]))
    best = res.get("best", {}).get("value")
    return None if best is None else float(best)


def run_sweep(
    sweep: SweepConfig,
    dataset: ArrayDataset,
    nband: int,
    folds,
    sweep_dir: str,
    model_builder: Optional[Callable] = None,
    mesh=None,
    use_wandb: bool = False,
    max_runs: Optional[int] = None,
    epochs_override: Optional[int] = None,
    resume: bool = False,
    parallel_folds: bool = False,
    parallel_members: bool = False,
    device="cuda",
):
    """Train the sweep's grid points in turn into ``sweep_dir/run-<k>`` (the
    wandb.agent loop, script_wandb.py:339) on ``device``; returns the
    per-run result dicts (``Trainer.fit``'s, with ``run_dir`` and
    ``run_cfg``; a skipped run's carries ``skipped`` and its summary).

    ``model_builder(run_cfg, extra, nband) -> (model, task, freeze,
    override)`` builds each model (``models.factory``'s builders); the
    default is a ``CLIPModel`` of the grid point with the default surgery.
    Runs on the card unless ``device`` says otherwise, and raises when CUDA
    is asked for and absent. The post-fit plots of the JAX runner are not
    made (they need matplotlib; ROADMAP.md item 18).

    ``parallel_folds`` groups the grid points that differ only in
    ``foldnumber`` and trains each group as one stacked program
    (``training/ensemble.py``); ``parallel_members`` groups across ``seed``
    and ``lr`` as well. Both need ``method: grid``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    extra = sweep.extra_args
    n_classes = int(extra.get("n_classes", 5))
    results = []
    scheduler = SweepScheduler(sweep, max_runs=max_runs)
    if parallel_folds or parallel_members:
        if use_wandb:
            import warnings

            warnings.warn("parallel folds/members log metrics.jsonl only; --wandb is ignored")
        return _run_sweep_parallel_folds(
            sweep, dataset, nband, folds, sweep_dir, scheduler, model_builder=model_builder,
            epochs_override=epochs_override, resume=resume, device=device, mesh=mesh,
            vary_keys=("foldnumber", "seed", "lr") if parallel_members else ("foldnumber",))
    for k in range(scheduler.n_runs):
        run_cfg = scheduler.suggest()
        if run_cfg is None:
            break
        run_dir = os.path.join(sweep_dir, f"run-{k}")
        if resume:
            summary = completed_summary(run_dir)
            if summary is not None:
                # a finished grid point is not re-walked (no upload, no model),
                # but its recorded objective still feeds the scheduler
                results.append(_skipped_result(run_dir, run_cfg, summary))
                scheduler.observe(run_cfg, _objective_from_summary(summary, sweep))
                continue
        set_seed(int(run_cfg.get("seed", 0)))
        inds_train, inds_val = split_for_run(
            len(dataset), float(extra.get("val_fraction", 0.2)), int(run_cfg.get("seed", 0)),
            folds=folds, foldnumber=run_cfg.get("foldnumber"))
        train_ds, val_ds = dataset.subset(inds_train), dataset.subset(inds_val)

        model, task, freeze, override, tcfg = _build_run(
            run_cfg, extra, nband, model_builder, epochs_override,
            image_size=image_size_of(dataset.arrays))
        if override is not None:
            model.load_state_dict(override(model.state_dict()), strict=True)
        trainer = Trainer(model.to(device), task=task, cfg=tcfg, run_dir=run_dir,
                          mesh=mesh, freeze=freeze, use_wandb=use_wandb,
                          n_classes=n_classes)
        res = trainer.fit(train_ds, val_ds, config_dump=dict(run_cfg), resume=resume)
        res["run_dir"] = run_dir
        res["run_cfg"] = run_cfg
        results.append(res)
        scheduler.observe(run_cfg, _sweep_objective(res, sweep))
    return results


def _run_sweep_parallel_folds(sweep: SweepConfig, dataset: ArrayDataset, nband: int, folds,
                              sweep_dir: str, scheduler: SweepScheduler,
                              model_builder: Optional[Callable] = None,
                              epochs_override: Optional[int] = None, resume: bool = False,
                              device=torch.device("cuda"), mesh=None,
                              vary_keys: Tuple[str, ...] = ("foldnumber",)):
    """The grid points as stacked member groups: grouped by their config
    minus ``vary_keys``, each group trained by one ``fit_members`` call into
    the ``run-<k>`` directories the sequential loop would write, with its
    stacked checkpoint in ``<sweep_dir>/_ensemble-g<i>/``. Under ``resume`` a
    group whose runs all hold ``summary.json`` is skipped; an unfinished one
    continues from its stacked checkpoint. ``mesh``: each group's members
    over the data axis (``fit_members``)."""
    from .ensemble import Member, fit_members

    if sweep.method != "grid":
        raise ValueError("parallel folds/members require method: grid (random/bayes "
                         "schedules depend on sequential observations)")
    extra = sweep.extra_args
    cfgs = []
    while (c := scheduler.suggest()) is not None:
        cfgs.append(c)
    groups: Dict[Any, list] = {}
    for k, run_cfg in enumerate(cfgs):
        key = tuple(sorted((kk, repr(v)) for kk, v in run_cfg.items() if kk not in vary_keys))
        groups.setdefault(key, []).append((k, run_cfg))

    indexed: Dict[int, Dict[str, Any]] = {}
    for gi, group in enumerate(groups.values()):
        if resume:
            summaries = {k: completed_summary(os.path.join(sweep_dir, f"run-{k}"))
                         for k, _ in group}
            if all(s is not None for s in summaries.values()):
                for k, rc in group:  # the whole group completed: skip it
                    indexed[k] = _skipped_result(os.path.join(sweep_dir, f"run-{k}"), rc,
                                                 summaries[k])
                continue
        members, models = [], []
        for k, rc in group:
            seed = int(rc.get("seed", 0))
            set_seed(seed)
            # the sequential loop's split rule, model, seed and surgery
            inds_train, inds_val = split_for_run(
                len(dataset), float(extra.get("val_fraction", 0.2)), seed,
                folds=folds, foldnumber=rc.get("foldnumber"))
            model, task, freeze, override, tcfg = _build_run(
                rc, extra, nband, model_builder, epochs_override,
                image_size=image_size_of(dataset.arrays))
            if override is not None:
                model.load_state_dict(override(model.state_dict()), strict=True)
            if not models:  # the group shares all but vary_keys: the first
                task0, freeze0, tcfg0 = task, freeze, tcfg  # point's stand for all
            models.append(model.to(device))
            members.append(Member(f"run-{k}", seed, inds_train, inds_val,
                                  lr=float(rc["lr"]) if "lr" in rc else None,
                                  config_dump=dict(rc)))
        out = fit_members(models, task0, tcfg0, dataset, members, run_dir=sweep_dir,
                          n_classes=int(extra.get("n_classes", 5)), freeze=freeze0,
                          resume=resume, mesh=mesh,
                          ensemble_dir=os.path.join(sweep_dir, f"_ensemble-g{gi}"))
        for (k, rc), m in zip(group, members):
            res = dict(out["members"][m.name])
            res["run_dir"] = os.path.join(sweep_dir, m.name)
            res["run_cfg"] = rc
            indexed[k] = res
    return [indexed[k] for k in sorted(indexed)]


def run_sweep_streaming(sweep: SweepConfig, train_sds, val_ds: ArrayDataset, nband: int,
                        sweep_dir: str, mesh=None, use_wandb: bool = False,
                        max_runs: Optional[int] = None, epochs_override: Optional[int] = None,
                        resume: bool = False, device="cuda"):
    """``run_sweep`` over a sharded cache (``data.streaming.ShardedDataset``,
    with ``val_ds`` the validation split held out at ingest): each grid
    point's model, task and surgery from ``_build_run``, then
    ``Trainer.fit_sharded`` into ``sweep_dir/run-<k>`` on ``device``. No
    folds: the split is the ingest's. With ``resume`` a completed run is
    skipped (its objective still observed by the scheduler) and an
    unfinished one continues from its ``StreamCursor``. The surgery works on
    the state_dict, so no example batch is drawn. The JAX runner's loss-history
    plot is not made: matplotlib is absent on the GPU host (ROADMAP.md queue
    1, item 18b, the reports). ``mesh`` trains each grid point over the
    ranks (``Trainer.fit_sharded`` under a mesh)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    extra = sweep.extra_args
    image_size = image_size_of(train_sds.load_shard(0).arrays)
    results = []
    scheduler = SweepScheduler(sweep, max_runs=max_runs)
    for k in range(scheduler.n_runs):
        run_cfg = scheduler.suggest()
        if run_cfg is None:
            break
        run_dir = os.path.join(sweep_dir, f"run-{k}")
        if resume:
            summary = completed_summary(run_dir)
            if summary is not None:
                results.append(_skipped_result(run_dir, run_cfg, summary))
                scheduler.observe(run_cfg, _objective_from_summary(summary, sweep))
                continue
        set_seed(int(run_cfg.get("seed", 0)))
        model, task, freeze, override, tcfg = _build_run(
            run_cfg, extra, nband, None, epochs_override, image_size=image_size)
        if override is not None:
            model.load_state_dict(override(model.state_dict()), strict=True)
        trainer = Trainer(model.to(device), task=task, cfg=tcfg, run_dir=run_dir, mesh=mesh,
                          freeze=freeze, use_wandb=use_wandb,
                          n_classes=int(extra.get("n_classes", 5)))
        res = trainer.fit_sharded(train_sds, val_ds, config_dump=dict(run_cfg), resume=resume)
        res["run_dir"] = run_dir
        res["run_cfg"] = run_cfg
        results.append(res)
        scheduler.observe(run_cfg, _sweep_objective(res, sweep))
    return results


def task_of(extra: Dict[str, Any]) -> str:
    if extra.get("regression"):
        return "regression"
    if extra.get("classification"):
        return "classification"
    return "contrastive"


def image_size_of(arrays) -> Optional[int]:
    """The side of a dataset's images (``x_img`` (n, H, W, C)), or None."""
    x = arrays.get("x_img")
    return None if x is None else int(x.shape[1])


def _build_run(run_cfg: Dict[str, Any], extra: Dict[str, Any], nband: int,
               model_builder: Optional[Callable], epochs_override: Optional[int],
               image_size: Optional[int] = None
               ) -> Tuple[Any, str, Optional[Callable], Optional[Callable], Any]:
    """(model, task, freeze, override, trainer config) for one grid point.
    ``model_builder(run_cfg, extra, nband)`` (models.factory's builders)
    gives the first four; without one the model is a ``CLIPModel`` of the
    grid point, its weights drawn from the run's seed, with the default
    surgery (``_default_pretrain_surgery``); ``image_size``, the side of the
    run's images, sizes a ViT tower."""
    if model_builder is not None:
        model, task, freeze, override = model_builder(run_cfg, extra, nband)
    else:
        model = CLIPModel(build_clip_config(run_cfg, extra, nband),
                          generator=torch.Generator().manual_seed(int(run_cfg.get("seed", 0))),
                          image_size=image_size)
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
