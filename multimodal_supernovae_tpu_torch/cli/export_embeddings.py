#!/usr/bin/env python
"""Export frozen embeddings for a dataset from a trained run, on one GPU
(port of multimodal_supernovae_tpu/cli/export_embeddings.py).

Writes one ``.npz`` with the per-modality embeddings (``emb_<modality>``),
the row filenames, redshifts and labels, the hand-off format for
downstream probes and catalogues::

  python -m multimodal_supernovae_tpu_torch.cli.export_embeddings \\
      --run analysis/maven-lite/run-0 --data-dir ZTFBTS/ \\
      --spectra-dir ZTFBTS_spectra/ --out embs.npz

``--device`` defaults to ``cuda`` and the export refuses to start without
it (pass ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.platform import select_device
from . import common


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--spectra-dir", default=None)
    ap.add_argument("--out", default="embeddings.npz")
    ap.add_argument("--split", choices=["all", "train", "val"], default="all",
                    help="restrict to the run's own split manifest")
    ap.add_argument("--which", choices=["best", "last"], default="best")
    ap.add_argument("--max-lc-len", type=int, default=100)
    ap.add_argument("--max-spec-len", type=int, default=1024)
    ap.add_argument("--rescale", type=float, default=1.0)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the embedding pass (default: cuda)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    select_device(args.device)

    from ..data.ztfbts import load_ztfbts
    from ..evaluation.embeddings import get_embeddings
    from ..models.factory import load_model
    from .evaluate import split_datasets

    dataset, _, _ = load_ztfbts(
        args.data_dir,
        args.spectra_dir,
        combinations=("lightcurve", "spectral"),
        max_data_len_lc=args.max_lc_len,
        max_data_len_spec=args.max_spec_len,
        spectral_rescalefactor=args.rescale,
        kfolds=None,
    )
    model, _ = load_model(args.run, args.device, which=args.which)
    if args.split != "all":
        dataset = split_datasets(args.run, dataset)[args.split == "val"]

    embs, names = get_embeddings(model, dataset, args.batch_size, args.device)
    payload = {f"emb_{n}": e for n, e in zip(names, embs)}
    payload["filenames"] = np.asarray(dataset.filenames)
    payload["redshift"] = dataset.arrays["redshift"]
    payload["label"] = dataset.arrays["label"]
    np.savez(args.out, **payload)
    print(
        f"wrote {args.out}: {len(dataset)} rows x "
        f"{[(n, e.shape[1]) for n, e in zip(names, embs)]}"
    )


if __name__ == "__main__":
    main()
