#!/usr/bin/env python
"""Embedding server on one GPU: the dynamic-batching HTTP daemon over an
exported artifact or a run directory, served by the PyTorch port (port of
multimodal_supernovae_tpu/cli/serve.py).

  python -m multimodal_supernovae_tpu_torch.cli.serve --artifact model.pt2 --port 8000
  python -m multimodal_supernovae_tpu_torch.cli.serve \\
      --run-dir RUN --batch-size 256 --max-wait-ms 5

``--artifact`` serves ``cli.export_model``'s artifact (the bytes of
``torch.export.save`` with ``<artifact>.json``, its manifest, beside it): no
model code and no checkpoint are loaded, and the batch size is the
artifact's. ``--run-dir`` serves live: RUN holds ``model_config.json`` and a
reference-layout ``*.ckpt``. A run dir that the port's
``Trainer.fit(run_dir=RUN)`` wrote serves as it is (``--which last`` takes
``last.ckpt``; ``best``, the reference's rule, the smallest-epoch ``epoch=``
file of the kept best). For a run trained by the JAX package:
``mmsn-export-torch`` writes the ``.ckpt``, then copy the run's
``model_config.json`` beside it. ``--device`` defaults to ``cuda`` and the
server refuses to start when CUDA is absent; it never falls back to the CPU
on its own (pass ``--device cpu`` for that). Clients are as for the JAX
server: POST npz or JSON to ``/embed``, GET ``/healthz`` and ``/stats``.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact",
                     help="artifact from cli.export_model (expects '<artifact>.json' "
                          "manifest next to it)")
    src.add_argument("--run-dir",
                     help="serve live from a run directory: model_config.json + a .ckpt "
                          "(a port-trained run dir serves as it is)")
    ap.add_argument("--batch-size", type=int, default=256,
                    help="device batch for --run-dir (the --artifact batch is baked into "
                         "the artifact)")
    ap.add_argument("--which", choices=["best", "last"], default="best")
    ap.add_argument("--lc-len", type=int, default=None,
                    help="per-band light-curve length (default: run config, else 100)")
    ap.add_argument("--sp-len", type=int, default=None,
                    help="spectrum length (default: run config, else 1000)")
    ap.add_argument("--image-size", type=int, default=None,
                    help="host-galaxy image side (default: run config, else 60)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="batching window after the first queued request")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 binds an ephemeral port (printed at startup)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-request access logs")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from multimodal_supernovae_tpu_torch.serving import load_artifact, load_live, serve

    if args.artifact:
        model = load_artifact(args.artifact, device=args.device)
    else:
        model = load_live(args.run_dir, args.batch_size, device=args.device,
                          which=args.which, lc_len=args.lc_len, sp_len=args.sp_len,
                          image_size=args.image_size)
    serve(model, host=args.host, port=args.port,
          max_wait_ms=args.max_wait_ms, quiet=args.quiet)


if __name__ == "__main__":
    main()
