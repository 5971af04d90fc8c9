#!/usr/bin/env python
"""Masked (MAE-style) light-curve pretraining on one GPU (port of
multimodal_supernovae_tpu/cli/pretrain_masked.py): trains a
``MaskedLightCurveEncoder`` (``models/factory.py:masked_model_builder``)
with the StepLR schedule of the sweep's ``step_size`` and ``gamma``, on the
ZTF BTS light curves (``--source real``) split at random by
``val_fraction``::

  python -m multimodal_supernovae_tpu_torch.cli.pretrain_masked configs/config_grid.yaml \\
      --source real --data-dir ZTFBTS/

``--source sim`` (the simulated HDF5 corpus) raises ``NotImplementedError``:
the port has no HDF5 reader yet (ROADMAP.md item 17; the GPU host has no
h5py). ``--device`` defaults to ``cuda``. ``--check`` validates every grid
point on the meta device instead of training (light curves only).
"""

from __future__ import annotations

import argparse
import os

from . import common


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--source", choices=["sim", "real"], default="sim")
    common.add_sweep_args(ap, spectra=False)
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    common.refuse_unported(args)

    from ..config import load_sweep
    from ..models.factory import masked_model_builder
    from ..training.experiment import make_sweep_dir, run_sweep

    sweep = load_sweep(args.config)
    extra = sweep.extra_args
    if args.check:
        common.run_check(args, sweep, 2, 220, model_builder=masked_model_builder(extra),
                         combinations=("lightcurve",))
    if args.source == "sim":
        raise NotImplementedError(
            "--source sim needs the simulated HDF5 corpus's reader, which is not ported yet "
            "(ROADMAP.md queue 1, item 17: data/simulation.py); use --source real")
    common.check_device(args.device)

    name = os.path.splitext(os.path.basename(args.config))[0] + "-masked"
    sweep_dir = make_sweep_dir(sweep, args.analysis_path, name)
    data_dir, _ = common.data_dirs(ap, args, ("lightcurve",))
    config = dict(data_dir=data_dir, combinations=("lightcurve",),
                  max_data_len_lc=int(extra.get("max_lightcurve_data_len", 100)))
    dataset = common.load_cached(args.cache_dir, config, kind="ztfbts-lc")
    results = run_sweep(
        sweep, dataset, 2, None, sweep_dir, model_builder=masked_model_builder(extra),
        use_wandb=args.wandb, max_runs=args.max_runs or extra.get("nruns"),
        epochs_override=args.epochs, resume=args.resume, device=args.device)
    common.print_results(results)


if __name__ == "__main__":
    main()
