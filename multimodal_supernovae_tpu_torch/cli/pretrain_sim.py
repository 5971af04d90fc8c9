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
ranks as ``cli.train`` does.

``--streaming`` trains from a sharded on-disk cache instead
(data/streaming.py, ``Trainer.fit_sharded``), for a corpus larger than the
card's memory: the HDF5 is read once, group by group, into
``<cache-dir>/stream-<key>/`` (shards of ``--rows-per-shard`` rows, and the
validation split, ``val_fraction`` of the rows, held out as they pass; the
key is the JAX CLI's, so either package's cache serves the other), and
every grid point trains shard by shard (``run_sweep_streaming``);
``--resume`` continues a cut run from the shard after its last
``StreamCursor``. With ``--mesh`` (and ``--tp N``) under torchrun every rank
streams the same shards and trains its block of each global batch (rank 0
writes the cache and the run directories; a cut run of several ranks
resumes from its last epoch's ``last.ckpt``)::

  python -m multimodal_supernovae_tpu_torch.cli.pretrain_sim configs/maven_pretrain.yaml \\
      --data-dir data/sim_data/ --streaming --rows-per-shard 65536
  torchrun --nproc-per-node 4 -m multimodal_supernovae_tpu_torch pretrain-sim \\
      configs/maven_pretrain.yaml --data-dir data/sim_data/ --streaming --mesh
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
                    help="train from a sharded on-disk cache (Trainer.fit_sharded), for a "
                         "corpus larger than the card's memory; the HDF5 is streamed into "
                         "the cache once")
    ap.add_argument("--rows-per-shard", type=int, default=65536,
                    help="streaming cache shard size (rows)")
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


def stream_cache(cache_dir: str, config: Dict[str, Any], rows_per_shard: int,
                 val_fraction: float):
    """(the ``ShardedDataset``, the validation split) of the streaming cache
    ``<cache_dir>/stream-<key>``, the JAX CLI's directory: read when its
    manifest is there, else written from ``iter_simulation_chunks`` through a
    ``ValHoldout`` (seed 0) and the shard writer."""
    from ..data.cache import cache_key
    from ..data.simulation import iter_simulation_chunks
    from ..data.streaming import (
        MANIFEST,
        ShardedDataset,
        ValHoldout,
        load_val_split,
        save_val_split,
        write_sharded_cache,
    )

    key = cache_key(kind="sim-stream", rows_per_shard=rows_per_shard,
                    val_fraction=val_fraction, **config)
    stream_dir = os.path.join(cache_dir, f"stream-{key}")
    if os.path.exists(os.path.join(stream_dir, MANIFEST)):
        sds, val_ds = ShardedDataset(stream_dir), load_val_split(stream_dir)
        what = "hit"
    else:
        holdout = ValHoldout(val_fraction, seed=0)
        sds = write_sharded_cache(stream_dir, holdout.wrap(iter_simulation_chunks(**config)),
                                  rows_per_shard)
        val_ds = holdout.dataset()
        save_val_split(stream_dir, val_ds)
        what = "written"
    print(f"sharded cache {what}: {len(sds)} train rows in {sds.n_shards} shards + "
          f"{len(val_ds)} val rows ({stream_dir})", flush=True)
    return sds, val_ds


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)

    from ..config import load_sweep
    from ..data.simulation import ingest_simulation
    from ..training.experiment import make_sweep_dir, run_sweep, run_sweep_streaming

    sweep = load_sweep(args.config)
    extra = sweep.extra_args
    if args.check:
        common.run_check(args, sweep, 2, 220)
    mesh, device = common.join_mesh(args)

    name = os.path.splitext(os.path.basename(args.config))[0]
    sweep_dir = common.main_first(mesh, lambda: make_sweep_dir(sweep, args.analysis_path, name))
    config = ingest_config(common.sim_path(ap, args, extra), extra)
    if args.streaming:
        sds, val_ds = common.main_first(mesh, lambda: stream_cache(
            args.cache_dir, config, args.rows_per_shard, float(extra.get("val_fraction", 0.2))))
        results = run_sweep_streaming(
            sweep, sds, val_ds, 2, sweep_dir, mesh=mesh, use_wandb=args.wandb,
            max_runs=args.max_runs or extra.get("nruns"), epochs_override=args.epochs,
            resume=args.resume, device=device)
        common.finish(results, mesh)
        return
    dataset = common.main_first(mesh, lambda: common.load_cached(
        args.cache_dir, config, ingest=ingest_simulation))
    results = run_sweep(
        sweep, dataset, 2, None, sweep_dir, mesh=mesh,
        use_wandb=args.wandb, max_runs=args.max_runs or extra.get("nruns"),
        epochs_override=args.epochs, resume=args.resume, device=device)
    common.finish(results, mesh)


if __name__ == "__main__":
    main()
