#!/usr/bin/env python3
"""The stacked maven-lite train step (training/ensemble.py) with and without
ops/linear.py's chunked rows, on one CUDA GPU.

  python3 probe_ensemble_linear.py        # from the repository root

Writes chip_smoke.py's synthetic ZTF BTS tree (4,702 transients) under
analysis/ (deleted at the end), ingests it with configs/maven-lite.yaml's
ingest config, and times with chip_smoke.py's ``_ensemble_time`` (host clock medians of 6, each
step synchronised, and one profile of 5 steps; against N sequential steps on
the same batches) the stacked step at B = 32, float32, in turns:
N = 5 through torch's own batching rule of ``F.linear`` (``linear``
replaced by ``F.linear`` in models/transformer.py), N = 5, 1 and 8 through
``ops.linear.linear``, then N = 5 through ``F.linear`` again. Prints the card's
name and power limit first; exits non-zero without CUDA.
"""

from __future__ import annotations

import os
import sys
import tempfile
from unittest import mock

import numpy as np
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from multimodal_supernovae_tpu_torch.config import expand_grid, load_sweep  # noqa: E402
from multimodal_supernovae_tpu_torch.data.cache import load_or_ingest  # noqa: E402
from multimodal_supernovae_tpu_torch.data.folds import stratified_kfolds  # noqa: E402


def main():
    card, _ = cs.phase_device()
    os.makedirs("analysis", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="analysis", prefix="linear-") as tmp:
        cs._write_tree(tmp, cs.INGEST_N)
        sweep = load_sweep(cs.MAVEN_LITE)
        config = cs.cli_common.ingest_config(
            os.path.join(tmp, "ZTFBTS"), os.path.join(tmp, "ZTFBTS_spectra"),
            sweep.extra_args, 1000)
        ds, _ = load_or_ingest(os.path.join(tmp, "cache"),
                               lambda: cs.load_ztfbts(kfolds=None, **config)[0], **config)
        folds = stratified_kfolds(np.asarray(ds.arrays["label"]), 5)
        point = next(expand_grid(sweep))
        data = ds.to_device(cs.DEVICE)
        for tag, n, plain in (("plain", 5, True), ("chunked", 5, False), ("chunked", 1, False),
                              ("chunked", 8, False), ("plain", 5, True)):
            points = [dict(point, seed=s, foldnumber=s % 5) for s in range(n)]
            with mock.patch.object(cs.transformer_mod, "linear",
                                   (lambda x, w, b=None: F.linear(x, w, b)) if plain
                                   else cs.transformer_mod.linear):
                members, models, _, _, tcfg = cs._ensemble_members(sweep, points, ds, folds)
                seq = cs._ensemble_members(sweep, points, ds, folds)[1]
                cs._ensemble_time(f"probe {tag} linear", card, members, models, seq, tcfg,
                                  data, cs._tf32_flash(18, 18))
    cs.log("probe: done")


if __name__ == "__main__":
    main()
