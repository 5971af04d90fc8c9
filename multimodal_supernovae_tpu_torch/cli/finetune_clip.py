#!/usr/bin/env python
"""CLIP fine-tuning on real ZTF BTS data from a pretrained run, on the GPU
(port of multimodal_supernovae_tpu/cli/finetune_clip.py, the reference's
finetune_clip.py).

The model is the pretrained run's (``extra_args.pretrain_path``: its
sidecar, the sweep's combinations), its monitored best weights merged in
non-strictly; ``freeze_backbone`` freezes both sequence encoders but their
projections; with ``regression`` or ``classification`` a ``ClipMLPHead``
is trained on it (``models/factory.py:finetune_model_builder``)::

  python -m multimodal_supernovae_tpu_torch.cli.finetune_clip configs/maven_finetune.yaml \\
      --data-dir ZTFBTS/ --spectra-dir ZTFBTS_spectra/

``--device`` defaults to ``cuda``. ``--check`` validates every grid point on
the meta device instead of training (the pretrained run dir's config and
weights are read, and the report counts the entries they fill).
``--parallel-folds``/``--parallel-members`` stack the grid points as
``cli.train`` does, and ``--mesh`` (``--tp N`` for a model axis) under
torchrun trains over the ranks as ``cli.train`` does.
"""

from __future__ import annotations

import argparse
import os

from . import common


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    common.add_sweep_args(ap)
    common.add_parallel_args(ap)
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)

    from ..config import load_sweep
    from ..data.folds import stratified_kfolds
    from ..models.factory import finetune_model_builder
    from ..training.experiment import make_sweep_dir, run_sweep

    sweep = load_sweep(args.config)
    extra = sweep.extra_args
    if args.check:
        common.run_check(args, sweep, 2, 220, model_builder=finetune_model_builder(extra))
    mesh, device = common.join_mesh(args)
    name = os.path.splitext(os.path.basename(args.config))[0]
    sweep_dir = common.main_first(mesh, lambda: make_sweep_dir(sweep, args.analysis_path, name))
    data_dir, spectra_dir = common.data_dirs(ap, args, tuple(extra["combinations"]))
    dataset = common.main_first(mesh, lambda: common.load_cached(
        args.cache_dir, common.ingest_config(data_dir, spectra_dir, extra, 220)))
    kfolds = extra.get("kfolds")
    folds = stratified_kfolds(dataset.arrays["label"], kfolds) if kfolds else None
    results = run_sweep(
        sweep, dataset, 2, folds, sweep_dir, model_builder=finetune_model_builder(extra),
        mesh=mesh, use_wandb=args.wandb, max_runs=args.max_runs or extra.get("nruns"),
        epochs_override=args.epochs, resume=args.resume,
        parallel_folds=args.parallel_folds, parallel_members=args.parallel_members,
        device=device)
    common.finish(results, mesh)


if __name__ == "__main__":
    main()
