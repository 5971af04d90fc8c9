#!/usr/bin/env python
"""Maven simulation pretraining on the GPU: contrastive CLIP on the
simulated HDF5 corpus (port of multimodal_supernovae_tpu/cli/pretrain_sim.py,
the reference's pretraining_clip_wandb.py).

The dataset is the Photometry/Spectroscopy HDF5 (``extra_args``:
``filename_trainset`` in ``--data-dir``, else in data/sim_data/, sim_data/
or ../data/sim_data/; ``noise``, ``dataset_length``), both bands, read by the
port's own HDF5 reader (``data/hdf5.py``) and ingested once through the
cache (``--cache-dir``, the JAX CLI's key, so either package's cache serves
the other); every grid point trains on a seeded random split at
``val_fraction`` into ``<analysis>/<sweep>/run-<k>/``::

  python -m multimodal_supernovae_tpu_torch.cli.pretrain_sim configs/maven_pretrain.yaml \\
      --data-dir data/sim_data/

Its run directory is what ``cli.finetune_clip`` grafts from
(``extra_args.pretrain_path``): Maven's second stage, on ZTF BTS.
``--device`` defaults to ``cuda`` and training refuses to start without it
(pass ``--device cpu`` for the CPU). ``--resume`` continues each unfinished
run from its last.ckpt and skips finished ones. ``--check`` validates every
grid point on the meta device instead of training (no data, no card).
``--mesh`` (``--tp N`` for a model axis) under torchrun trains over the
ranks as ``cli.train`` does. Not
ported yet: ``--streaming`` (training from a sharded on-disk cache,
ROADMAP.md queue 1, item 17b) raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict

from . import common


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    common.add_sweep_args(ap, spectra=False, data_help=(
        "directory of the simulated HDF5 (default: data/sim_data/, sim_data/ or "
        "../data/sim_data/, the first that exists)"))
    ap.add_argument("--streaming", action="store_true",
                    help="train from a sharded on-disk cache (not ported yet)")
    ap.add_argument("--rows-per-shard", type=int, default=65536,
                    help="streaming cache shard size in rows (not ported yet)")
    return ap


def ingest_config(hdf5_path: str, extra: Dict[str, Any]) -> Dict[str, Any]:
    """The ingest configuration the cache key hashes (the JAX CLI's)."""
    return dict(
        hdf5_path=hdf5_path,
        bands=("r", "g"),  # pretraining_clip_wandb.py:61-74 uses both bands
        n_max_obs=int(extra.get("max_lightcurve_data_len", 100)),
        n_max_obs_spec=int(extra.get("max_spectral_data_len", 220)),
        combinations=tuple(extra["combinations"]),
        noise=bool(extra.get("noise", True)),
        dataset_length=extra.get("dataset_length"),
    )


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)

    from ..config import load_sweep
    from ..data.simulation import ingest_simulation
    from ..training.experiment import make_sweep_dir, run_sweep

    sweep = load_sweep(args.config)
    extra = sweep.extra_args
    if args.check:
        common.run_check(args, sweep, 2, 220)
    if args.streaming:
        raise NotImplementedError(
            "--streaming is not ported yet (ROADMAP.md queue 1, item 17b: data/streaming.py, "
            "Trainer.fit_sharded); the corpus is ingested into host memory without it")
    mesh, device = common.join_mesh(args)

    name = os.path.splitext(os.path.basename(args.config))[0]
    sweep_dir = common.main_first(mesh, lambda: make_sweep_dir(sweep, args.analysis_path, name))
    config = ingest_config(common.sim_path(ap, args, extra), extra)
    dataset = common.main_first(mesh, lambda: common.load_cached(
        args.cache_dir, config, ingest=ingest_simulation))
    results = run_sweep(
        sweep, dataset, 2, None, sweep_dir, mesh=mesh,
        use_wandb=args.wandb, max_runs=args.max_runs or extra.get("nruns"),
        epochs_override=args.epochs, resume=args.resume, device=device)
    common.finish(results, mesh)


if __name__ == "__main__":
    main()
