#!/usr/bin/env python
"""Batch inference for trained runs, on one GPU (port of
multimodal_supernovae_tpu/cli/infer.py).

Loads a run directory the port can restore (``models/factory.py:load_model``),
streams a ZTF BTS dataset (through the ingest cache) or, with ``--hdf5``, a
simulated Photometry/Spectroscopy corpus (ingested with the run's bands,
lengths and combinations by ``data/simulation.py:ingest_simulation``)
through the frozen model in fixed-shape batches, and writes one ``.npz``
artifact plus a JSON manifest beside it:

  * contrastive CLIP runs: the L2-normalised per-modality embeddings
    (``emb_<modality>``);
  * supervised runs: ``pred`` (the regression value or the class logits)
    and, for classification, ``pred_class``;
  * masked-pretraining runs: ``recon_mse``, the per-sample reconstruction
    error over a random masked span drawn from ``--seed`` (an anomaly
    score).

::

  python -m multimodal_supernovae_tpu_torch.cli.infer analysis/maven-lite/run-0 \\
      --data-dir ZTFBTS/ --spectra-dir ZTFBTS_spectra/ --out run0.npz --split val
  python -m multimodal_supernovae_tpu_torch.cli.infer analysis/maven_pretrain/run-0 \\
      --hdf5 data/sim_data/ZTF_Pretrain_5Class.hdf5 --out sims.npz

``--device`` defaults to ``cuda`` and inference refuses to start without it
(pass ``--device cpu`` for the CPU); the manifest's ``backend`` is the
device's type.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..utils.platform import select_device
from . import common


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", help="trained run directory")
    ap.add_argument("--data-dir", default=None, help="ZTFBTS root")
    ap.add_argument("--spectra-dir", default=None)
    ap.add_argument("--hdf5", default=None,
                    help="simulated HDF5 corpus instead of real data")
    ap.add_argument("--cache-dir", default="./data_cache")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--split", choices=["all", "train", "val"], default="all",
                    help="restrict to the run's own split manifest")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--which", choices=["best", "last"], default="best")
    ap.add_argument("--seed", type=int, default=0,
                    help="mask seed for masked-model anomaly scores")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the inference (default: cuda)")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    select_device(args.device)

    from ..evaluation.embeddings import (
        get_embeddings,
        masked_reconstruction_mse,
        predict_supervised,
    )
    from ..models.factory import load_model, load_run_config
    from ..models.pretraining import MaskedLightCurveEncoder
    from ..training.checkpoint import load_run_sidecars
    from ..utils.io import get_valid_dir, is_subset

    _, extra = load_run_config(args.run_dir)
    combinations = tuple(extra.get("combinations", ("lightcurve",)))
    if args.hdf5:
        from ..data.simulation import ingest_simulation

        dataset = ingest_simulation(
            args.hdf5, bands=("r", "g") if int(extra.get("nband", 2)) == 2 else ("r",),
            n_max_obs=int(extra.get("max_lightcurve_data_len", 100)),
            n_max_obs_spec=int(extra.get("max_spectral_data_len", 220)),
            combinations=combinations)
    else:
        data_dir = args.data_dir or get_valid_dir(common.DATA_DIRS)
        dataset = common.load_cached(args.cache_dir, common.ingest_config(
            data_dir, args.spectra_dir, dict(extra, combinations=combinations), 1000))

    model, _ = load_model(args.run_dir, args.device, which=args.which)
    if args.split != "all":
        _, train_names, val_names = load_run_sidecars(args.run_dir)
        names = train_names if args.split == "train" else val_names
        if not names:
            ap.error(f"run has no {args.split} manifest")
        if dataset.filenames is None or not is_subset(names, dataset.filenames):
            ap.error(f"{args.split} manifest entries missing from the dataset")
        dataset = dataset.subset_by_filenames(names)
    print(f"dataset: {len(dataset)} samples; model: {type(model).__name__}")

    arrays = {}
    manifest = {
        "run_dir": os.path.abspath(args.run_dir),
        "checkpoint": args.which,
        "n_samples": len(dataset),
        "split": args.split,
        "combinations": list(combinations),
        "backend": torch.device(args.device).type,
    }
    if isinstance(model, MaskedLightCurveEncoder):
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        arrays["recon_mse"] = masked_reconstruction_mse(
            model, dataset, generator=gen, batch_size=args.batch_size, device=args.device)
        manifest["task"] = "masked_anomaly_score"
    elif model.cfg.supervised:
        preds = predict_supervised(model, dataset, args.batch_size, args.device)
        arrays["pred"] = preds
        if preds.shape[-1] > 1:  # classification logits
            arrays["pred_class"] = preds.argmax(axis=-1)
            manifest["task"] = "classification"
        else:
            manifest["task"] = "regression"
    else:
        embs, names = get_embeddings(model, dataset, args.batch_size, args.device)
        for e, nm in zip(embs, names):
            arrays[f"emb_{nm}"] = e
        manifest["task"] = "contrastive_embeddings"
        manifest["embedding_dim"] = int(embs[0].shape[-1])

    if dataset.filenames is not None:
        arrays["filenames"] = np.asarray(dataset.filenames)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    with open(os.path.splitext(args.out)[0] + ".json", "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"wrote {args.out}: " + ", ".join(
        f"{k}{list(v.shape)}" for k, v in arrays.items()))


if __name__ == "__main__":
    main()
