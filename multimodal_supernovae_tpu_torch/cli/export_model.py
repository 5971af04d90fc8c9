#!/usr/bin/env python
"""Export a trained run to a self-contained serving artifact on one GPU (port
of multimodal_supernovae_tpu/cli/export_model.py), through ``torch.export``.

Serializes the frozen encoder (weights baked in) to the bytes of
``torch.export.save`` (evaluation/export.py) plus a JSON manifest of the
input contract; ``cli.serve --artifact`` reloads both without the port's
model code or the run's checkpoint files. No dataset is needed: the example
batch is synthesized at the run config's shapes. Exported from the card, the
artifact holds the hand-written forward kernels as registered ops (the flash
forward in every attention layer, the fused block or the fused QKV attention
under ``MMSN_FUSED_BLOCK=1`` / ``MMSN_FUSED_QKV=1``) and runs on the card::

  python -m multimodal_supernovae_tpu_torch export-model analysis/maven-lite/run-0 \\
      --out model.pt2 --batch-size 256 --check

``--device`` defaults to ``cuda`` and the export refuses to start without it
(pass ``--device cpu`` for an artifact of the plain versions); the
manifest's ``platforms`` is the device's type.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", help="trained run directory (the port's or the reference's)")
    ap.add_argument("--out", required=True,
                    help="artifact path; '<out>.json' gets the manifest")
    ap.add_argument("--batch-size", type=int, default=256,
                    help="the artifact's FIXED batch size (static shapes)")
    ap.add_argument("--lc-len", type=int, default=None,
                    help="PER-BAND light-curve length (the reference's "
                         "max_lightcurve_data_len; total baked band-blocked length = "
                         "lc-len x nband) (default: run config, else 100); must match the "
                         "serving data: --check is shape-self-consistent and cannot catch "
                         "a mismatch")
    ap.add_argument("--sp-len", type=int, default=None,
                    help="spectrum length baked into the artifact (default: run config, "
                         "else 1000, the real-data default of cli.train; sim-pretrain runs "
                         "use 220)")
    ap.add_argument("--image-size", type=int, default=None,
                    help="host-galaxy cutout size (default: run config, else 60, the "
                         "ZTFBTS host PNG size)")
    ap.add_argument("--which", choices=["best", "last"], default="best")
    ap.add_argument("--check", action="store_true",
                    help="reload the artifact and compare against the live model on the "
                         "example batch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to export on (default: cuda)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from ..data.synthetic import make_synthetic_dataset
    from ..evaluation.export import (
        batch_to_dict,
        export_encoder,
        load_exported,
        modality_names,
    )
    from ..models.factory import load_model
    from ..utils.platform import select_device

    device = select_device(args.device)
    model, extra = load_model(args.run_dir, device, which=args.which)
    if not hasattr(model, "encode"):
        sys.exit(
            f"error: {args.run_dir} rebuilds as {type(model).__name__}, which has no "
            "embedding encoder to export. Export the pretrained CLIP backbone run "
            "directory instead (the run's extra_args 'pretrain_path').")

    combos = model.cfg.combinations
    # baked input shapes: flag > run config > the real-data serving defaults
    ds = make_synthetic_dataset(
        n=args.batch_size,
        n_max_lc=args.lc_len or int(extra.get("max_lightcurve_data_len", 100)),
        nband=int(extra.get("nband", 2)),
        n_max_sp=args.sp_len or int(extra.get("max_spectral_data_len", 1000)),
        image_size=args.image_size or int(extra.get("image_size", 60)),
        modalities=combos,
    )
    example = {k: torch.from_numpy(v).to(device) for k, v in ds.arrays.items()}
    feed = batch_to_dict(example, combos)
    data = export_encoder(model, example)
    with open(args.out, "wb") as f:
        f.write(data)

    manifest = {
        "artifact": os.path.basename(args.out),
        "bytes": len(data),
        "platforms": [device.type],
        "batch_size": args.batch_size,
        "input": {k: {"shape": list(v.shape), "dtype": str(ds.arrays[k].dtype)}
                  for k, v in feed.items()},
        "output_modalities": modality_names(model),
        "run_dir": os.path.abspath(args.run_dir),
        "which": args.which,
    }
    with open(args.out + ".json", "w") as f:
        json.dump(manifest, f, indent=2)
    print(json.dumps({k: manifest[k] for k in
                      ("bytes", "platforms", "batch_size", "output_modalities")}))

    if args.check:
        fn, _ = load_exported(data)
        got = fn(feed)
        with torch.inference_mode():
            want = model.encode(example)
        dev = max(float(np.abs(g.float().cpu().numpy() - w.float().cpu().numpy()).max())
                  for g, w in zip(got, want))
        print(f"check: max |artifact - live| = {dev:.3e}")
        if not dev < 1e-4:
            raise AssertionError("exported artifact deviates from the live model")
        print("CHECK OK")


if __name__ == "__main__":
    main()
