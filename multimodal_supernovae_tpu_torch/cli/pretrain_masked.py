#!/usr/bin/env python
"""Masked (MAE-style) light-curve pretraining on the GPU (port of
multimodal_supernovae_tpu/cli/pretrain_masked.py): trains a
``MaskedLightCurveEncoder`` (``models/factory.py:masked_model_builder``)
with the StepLR schedule of the sweep's ``step_size`` and ``gamma``, on the
light curves of the legacy simulated corpus (``--source sim``, the default:
the ``TransientTable`` HDF5 ``extra_args.filename_trainset`` in
``--data-dir``, else in data/sim_data/ or sim_data/, read by the port's
HDF5 reader) or of ZTF BTS (``--source real``), split at random by
``val_fraction``::

  python -m multimodal_supernovae_tpu_torch.cli.pretrain_masked configs/config_grid.yaml \\
      --source sim --data-dir data/sim_data/
  python -m multimodal_supernovae_tpu_torch.cli.pretrain_masked configs/config_grid.yaml \\
      --source real --data-dir ZTFBTS/

``--device`` defaults to ``cuda``. ``--check`` validates every grid point on
the meta device instead of training (light curves only). ``--mesh``
(``--tp N`` for a model axis) under torchrun trains over the ranks as
``cli.train`` does.
"""

from __future__ import annotations

import argparse
import os

from . import common


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--source", choices=["sim", "real"], default="sim")
    common.add_sweep_args(ap, spectra=False, data_help=(
        "directory of the simulated HDF5 (--source sim; default: data/sim_data/ or "
        "sim_data/) or of ZTF BTS (--source real; default: ZTFBTS/, data/ZTFBTS/ or "
        "../data/ZTFBTS/)"))
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)

    from ..config import load_sweep
    from ..models.factory import masked_model_builder
    from ..training.experiment import make_sweep_dir, run_sweep

    sweep = load_sweep(args.config)
    extra = sweep.extra_args
    if args.check:
        common.run_check(args, sweep, 2, 220, model_builder=masked_model_builder(extra),
                         combinations=("lightcurve",))
    mesh, device = common.join_mesh(args)

    name = os.path.splitext(os.path.basename(args.config))[0] + "-masked"
    sweep_dir = common.main_first(mesh, lambda: make_sweep_dir(sweep, args.analysis_path, name))
    n_max_obs = int(extra.get("max_lightcurve_data_len", 100))
    if args.source == "sim":
        from ..data.simulation import ingest_simulation_lightcurves

        config = dict(hdf5_path=common.sim_path(ap, args, extra, common.SIM_DIRS[:2]),
                      bands=("r", "g"), n_max_obs=n_max_obs,
                      dataset_length=extra.get("dataset_length"))
        dataset = common.main_first(mesh, lambda: common.load_cached(
            args.cache_dir, config, ingest=ingest_simulation_lightcurves, kind="simlc"))
    else:
        data_dir, _ = common.data_dirs(ap, args, ("lightcurve",))
        config = dict(data_dir=data_dir, combinations=("lightcurve",),
                      max_data_len_lc=n_max_obs)
        dataset = common.main_first(mesh, lambda: common.load_cached(
            args.cache_dir, config, kind="ztfbts-lc"))
    results = run_sweep(
        sweep, dataset, 2, None, sweep_dir, model_builder=masked_model_builder(extra),
        mesh=mesh, use_wandb=args.wandb, max_runs=args.max_runs or extra.get("nruns"),
        epochs_override=args.epochs, resume=args.resume, device=device)
    common.finish(results, mesh)


if __name__ == "__main__":
    main()
