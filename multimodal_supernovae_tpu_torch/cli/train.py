#!/usr/bin/env python
"""Train CLIP or a supervised head on real ZTF BTS data on the GPU (port of
multimodal_supernovae_tpu/cli/train.py, the reference's script_wandb.py).

One positional argument: a sweep YAML, or an existing sweep directory under
``--analysis-path`` to continue. The dataset is ingested once (cached in
``--cache-dir``), split by the stratified folds when the sweep has
``kfolds`` and ``foldnumber`` (else by a seeded random split), and every
grid point is trained into ``<analysis>/<sweep>/run-<k>/``::

  python -m multimodal_supernovae_tpu_torch.cli.train configs/maven-lite.yaml \\
      --data-dir ZTFBTS/ --spectra-dir ZTFBTS_spectra/
  python -m multimodal_supernovae_tpu_torch.cli.train analysis/maven-lite --resume

``--device`` defaults to ``cuda`` and training refuses to start without it
(pass ``--device cpu`` for the CPU). ``--check`` validates every grid point
on the meta device instead of training (``training/preflight.py``; no data,
no card). ``--parallel-folds`` trains the folds of each grid point as one
stacked program and ``--parallel-members`` its seeds and learning rates too
(``training/ensemble.py``), into the same run directories.

Over the cards of a host, one process a card (NCCL; gloo for ``--device
cpu``): data parallel, the global batch split over the ranks; with ``--tp
N`` a (ranks / N, N) mesh whose model axis splits the FFNs and the ConvMixer
head (parallel/sharding.py); with ``--parallel-folds`` /
``--parallel-members`` the stacked members spread over the data axis::

  torchrun --nproc-per-node 8 -m multimodal_supernovae_tpu_torch train \
      configs/maven_pretrain.yaml --mesh
  torchrun --nproc-per-node 4 -m multimodal_supernovae_tpu_torch train \
      configs/maven-lite.yaml --mesh --tp 2
  torchrun --nproc-per-node 5 -m multimodal_supernovae_tpu_torch train \
      configs/maven-lite.yaml --mesh --parallel-folds

``--profile-dir D`` writes a ``torch.profiler`` Chrome trace of the whole
sweep into D (one file a rank); it records every operator and kernel, so
keep such runs short (``--epochs 1 --max-runs 1``). The post-fit plots are
not made (ROADMAP.md item 18b).
"""

from __future__ import annotations

import argparse
import contextlib
import os

from . import common


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", help="sweep YAML path or existing sweep dir")
    common.add_sweep_args(ap)
    common.add_parallel_args(ap)
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of training here (short runs)")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)

    from ..config import load_sweep
    from ..data.folds import stratified_kfolds
    from ..training.experiment import make_sweep_dir, run_sweep

    resuming = os.path.isdir(args.config)  # continue an existing sweep
    sweep = load_sweep(os.path.join(args.config, "sweep_config.yaml") if resuming
                       else args.config)
    nband = 2 if "lightcurve" in sweep.extra_args["combinations"] else 1
    if args.check:
        common.run_check(args, sweep, nband, 1000)
    mesh, device = common.join_mesh(args)
    if resuming:
        sweep_dir = args.config
    else:
        name = os.path.splitext(os.path.basename(args.config))[0]
        sweep_dir = common.main_first(
            mesh, lambda: make_sweep_dir(sweep, args.analysis_path, name))

    extra = sweep.extra_args
    combinations = tuple(extra["combinations"])
    data_dir, spectra_dir = common.data_dirs(ap, args, combinations)
    dataset = common.main_first(mesh, lambda: common.load_cached(
        args.cache_dir, common.ingest_config(data_dir, spectra_dir, extra, 1000)))
    kfolds = extra.get("kfolds")
    folds = stratified_kfolds(dataset.arrays["label"], kfolds) if kfolds else None
    if args.profile_dir:
        from ..utils.profiling import profiler_trace

        profile_ctx = profiler_trace(args.profile_dir)
    else:
        profile_ctx = contextlib.nullcontext()
    with profile_ctx:
        results = run_sweep(
            sweep, dataset, nband, folds, sweep_dir, mesh=mesh,
            use_wandb=args.wandb, max_runs=args.max_runs or extra.get("nruns"),
            epochs_override=args.epochs, resume=args.resume,
            parallel_folds=args.parallel_folds, parallel_members=args.parallel_members,
            device=device)
    common.finish(results, mesh)


if __name__ == "__main__":
    main()
