"""What the training CLIs share: their arguments, the ``--check``
preflight, the ``(data, model)`` mesh, the data directories and the cached
ingest (ZTF BTS, or a simulated HDF5 corpus).

Under a mesh (``--mesh`` or a torchrun launch; parallel/distributed.py)
rank 0 makes the sweep directory and fills the ingest cache first, and the
other ranks follow once it has (``main_first``); only rank 0 prints the
results."""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Callable, Dict, Optional, Sequence, Tuple


DATA_DIRS = ("ZTFBTS/", "data/ZTFBTS/", "../data/ZTFBTS/")
SPECTRA_DIRS = ("ZTFBTS_spectra/", "data/ZTFBTS_spectra/", "../data/ZTFBTS_spectra/")
SIM_DIRS = ("data/sim_data/", "sim_data/", "../data/sim_data/")
SIM_FILE = "ZTF_Pretrain_5Class.hdf5"  # the reference's filename_trainset


def add_sweep_args(ap: argparse.ArgumentParser, spectra: bool = True,
                   data_help: Optional[str] = None) -> None:
    """The arguments of every training CLI (those of the JAX CLIs, with
    ``--device`` for ``--platform``)."""
    from ..parallel.distributed import add_mesh_args
    from ..training.preflight import add_check_args

    ap.add_argument("--analysis-path", default="./analysis")
    ap.add_argument("--data-dir", default=None, help=data_help or (
        "ZTF BTS directory (default: ZTFBTS/, data/ZTFBTS/ or ../data/ZTFBTS/, the first "
        "that exists)"))
    if spectra:
        ap.add_argument("--spectra-dir", default=None,
                        help="spectra directory (default: ZTFBTS_spectra/ beside ZTFBTS/)")
    ap.add_argument("--cache-dir", default="./data_cache",
                    help="ingest cache (data/cache.py), keyed by the ingest config")
    ap.add_argument("--epochs", type=int, default=None, help="override epochs")
    ap.add_argument("--max-runs", type=int, default=None)
    ap.add_argument("--wandb", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="continue each unfinished run from its last.ckpt; completed "
                         "runs (summary.json present) are skipped")
    add_check_args(ap)
    add_mesh_args(ap)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda; under torchrun each "
                         "rank takes cuda:LOCAL_RANK)")


def add_parallel_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--parallel-folds", action="store_true",
                    help="train the grid points that differ only in foldnumber as one "
                         "stacked program (training/ensemble.py)")
    ap.add_argument("--parallel-members", action="store_true",
                    help="like --parallel-folds, stacking across seed and lr too")


def join_mesh(args: argparse.Namespace):
    """(the ``(data, model)`` mesh or None, the device to train on): the card
    unless ``--device`` says otherwise (raising without one), joined to the
    process group a torchrun launch names
    (``parallel.distributed.mesh_from_args``; ``--tp`` must divide the
    group's size)."""
    from ..parallel.distributed import mesh_from_args
    from ..utils.platform import select_device

    device = select_device(args.device)
    mesh = mesh_from_args(args, device=device)
    return mesh, device if mesh is None else mesh.device


def main_first(mesh, fn: Callable):
    """``fn()`` on rank 0 first, then on the other ranks (which find what it
    wrote: the sweep directory, the ingest cache); just ``fn()`` without a
    mesh."""
    if mesh is None:
        return fn()
    if mesh.is_main:
        out = fn()
        mesh.barrier()
        return out
    mesh.barrier()
    return fn()


def finish(results, mesh=None) -> None:
    """Print the results (rank 0 of a mesh) and leave the process group."""
    if mesh is None or mesh.is_main:
        print_results(results)
    if mesh is not None:
        from ..parallel.distributed import shutdown

        shutdown()


def run_check(args: argparse.Namespace, sweep, nband: int, sp_default: int,
              model_builder: Optional[Callable] = None,
              combinations: Optional[Tuple[str, ...]] = None) -> None:
    """``--check``: preflight every grid point of ``sweep`` on the meta
    device (``training/preflight.py``), print the report and exit 0 when
    every point validated, else 1. Needs no data and no card."""
    from ..training.preflight import run_cli_check

    extra = sweep.extra_args
    sys.exit(run_cli_check(
        sweep, nband=nband, lc_len=2 * int(extra.get("max_lightcurve_data_len", 100)),
        sp_len=int(extra.get("max_spectral_data_len", sp_default)), args=args,
        model_builder=model_builder, combinations=combinations))


def data_dirs(ap: argparse.ArgumentParser, args: argparse.Namespace,
              combinations: Sequence[str]):
    """(data_dir, spectra_dir or None) from the arguments or the defaults."""
    from ..utils.io import get_valid_dir

    if args.data_dir and not os.path.isdir(args.data_dir):
        ap.error(f"--data-dir {args.data_dir} does not exist")
    data_dir = args.data_dir or get_valid_dir(DATA_DIRS)
    spectra_dir = getattr(args, "spectra_dir", None)
    if spectra_dir is None and "spectral" in combinations:
        spectra_dir = get_valid_dir(SPECTRA_DIRS)
    return data_dir, spectra_dir


def sim_path(ap: argparse.ArgumentParser, args: argparse.Namespace, extra: Dict[str, Any],
             dirs: Sequence[str] = SIM_DIRS) -> str:
    """The simulated corpus: ``extra_args.filename_trainset`` in
    ``--data-dir`` or the first of ``dirs`` that exists."""
    from ..utils.io import get_valid_dir

    if args.data_dir and not os.path.isdir(args.data_dir):
        ap.error(f"--data-dir {args.data_dir} does not exist")
    return os.path.join(args.data_dir or get_valid_dir(dirs),
                        extra.get("filename_trainset", SIM_FILE))


def ingest_config(data_dir: str, spectra_dir, extra: Dict[str, Any],
                  sp_default: int) -> Dict[str, Any]:
    """The ingest configuration the cache key hashes (the JAX CLIs')."""
    return dict(
        data_dir=data_dir,
        spectra_dir=spectra_dir,
        combinations=tuple(extra["combinations"]),
        max_data_len_lc=int(extra.get("max_lightcurve_data_len", 100)),
        max_data_len_spec=int(extra.get("max_spectral_data_len", sp_default)),
        n_classes=int(extra.get("n_classes", 5)),
        spectral_rescalefactor=float(extra.get("spectral_rescalefactor", 1e14)),
    )


def load_cached(cache_dir: str, config: Dict[str, Any], ingest: Optional[Callable] = None,
                **key_extra):
    """The dataset ``ingest(**config)`` (by default the ZTF BTS ingest)
    through the ingest cache, keyed by ``config`` and ``key_extra``; prints
    its size and whether the cache hit."""
    from ..data.cache import load_or_ingest

    if ingest is None:
        from ..data.ztfbts import load_ztfbts

        def ingest(**c):
            return load_ztfbts(kfolds=None, **c)[0]

    dataset, hit = load_or_ingest(cache_dir, lambda: ingest(**config), **key_extra, **config)
    print(f"dataset: {len(dataset)} samples (cache={'hit' if hit else 'miss'})", flush=True)
    return dataset


def print_results(results) -> None:
    for r in results:
        print(f"{r['run_dir']}: best {r['best']} epochs={r['epochs_run']} "
              f"wall={r['wall_time_s']:.1f}s", flush=True)
