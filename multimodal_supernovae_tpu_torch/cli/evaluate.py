#!/usr/bin/env python
"""Batch evaluation of trained runs: probes on frozen embeddings, on one GPU
(port of multimodal_supernovae_tpu/cli/evaluate.py, the reference's
``evaluate_models.py``).

Walks run directories, reloads each model with its exact train/val split
manifests, extracts embeddings, fits Linear and KNN probes (single and
concatenated-pair modality inputs) for redshift regression and 5-way and
3-way classification, and writes the metric pickles and LaTeX tables;
supervised runs are scored on their own head's predictions::

  python -m multimodal_supernovae_tpu_torch.cli.evaluate \\
      --runs analysis/maven-lite/run-0 --label Maven-lite \\
      --data-dir ZTFBTS/ --spectra-dir ZTFBTS_spectra/

``--device`` defaults to ``cuda`` and the evaluation refuses to start
without it (pass ``--device cpu`` for the CPU). The probes run on the host
in numpy (``evaluation/probes.py``). Each run is evaluated on the data of
its own towers (its sidecar's ``combinations``; the JAX CLI loads light
curves and spectra for every run, so there a light-curve-only run whose
split names a transient without a spectrum fails). The plots (confusion
matrices, predicted against true redshift, per-class radar plots) need
matplotlib and are not made (ROADMAP.md item 18b).
"""

from __future__ import annotations

import argparse
import itertools
import os
import pickle
import time

import numpy as np

from ..evaluation.probes import DEFAULT_KNN_KS as KNN_KS
from ..utils.platform import select_device
from . import common

# 5-way class names + plot colors (sorted factorize order)
CLASS_NAMES_5 = {
    0: ("SLSN-I", "tab:purple"),
    1: ("SN II", "tab:blue"),
    2: ("SN IIn", "tab:cyan"),
    3: ("SN Ia", "tab:orange"),
    4: ("SN Ibc", "tab:green"),
}
CLASS_NAMES_3 = {
    0: ("SN II", "tab:blue"),
    1: ("SN Ia", "tab:orange"),
    2: ("SN Ibc", "tab:green"),
}
PLOTS_SKIPPED = ("plots skipped: confusion matrices, predicted-vs-true and radar plots need "
                 "matplotlib (ROADMAP.md item 18b)")


def split_datasets(run_dir, dataset):
    """(train, val) rows of ``dataset`` named by the run's split manifests,
    in the dataset's order; raises when a manifest names a missing row."""
    from ..training.checkpoint import load_run_sidecars

    _, train_names, val_names = load_run_sidecars(run_dir)
    for split, names in (("train", train_names), ("val", val_names)):
        if names is None:
            raise FileNotFoundError(f"{run_dir} has no {split}_filenames.txt")
    return dataset.subset_by_filenames(train_names), dataset.subset_by_filenames(val_names)


def probe_inputs(names, embs_train, embs_val):
    """{combination: (train x, val x)}: each modality, then each pair
    concatenated (evaluate_models.py:269-503)."""
    inputs = {n: (embs_train[i], embs_val[i]) for i, n in enumerate(names)}
    for i, j in itertools.combinations(range(len(names)), 2):
        inputs[f"{names[i]}+{names[j]}"] = (
            np.concatenate([embs_train[i], embs_train[j]], axis=1),
            np.concatenate([embs_val[i], embs_val[j]], axis=1),
        )
    return inputs


def evaluate_run(run_dir, label, run_id, dataset, out, device="cuda", batch_size=256):
    """Probe one run: embeddings from its exact train and val splits,
    Linear/KNN probes on single and paired modality embeddings, both 5-way
    and 3-way. Supervised (regression/classification) runs are scored on
    their own head predictions instead (the reference's process_data_loader
    path, utils.py:608-691, evaluate_models.py:211-267). Runs on the card
    unless ``device`` says otherwise."""
    from ..evaluation.embeddings import get_embeddings, predict_supervised
    from ..evaluation.metrics import calculate_metrics
    from ..models.factory import load_model

    model, _ = load_model(run_dir, device)
    train_ds, val_ds = split_datasets(run_dir, dataset)

    if model.cfg.supervised:
        preds = predict_supervised(model, val_ds, batch_size, device)
        combo = " ".join(model.cfg.combinations)
        if model.cfg.regression:
            m, r = calculate_metrics(
                val_ds.arrays["redshift"], val_ds.arrays["label"], preds[:, 0],
                label, combo, run_id, task="regression",
            )
            out["regression"].append(m)
            out["regression_results"].append(r)
        else:
            m, r = calculate_metrics(
                None, val_ds.arrays["label"], preds.argmax(axis=-1),
                label, combo, run_id, task="classification",
            )
            out["classification"].append(m)
            out["classification_results"].append(r)
        return

    embs_train, names = get_embeddings(model, train_ds, batch_size, device)
    embs_val, _ = get_embeddings(model, val_ds, batch_size, device)
    z = (train_ds.arrays["redshift"], val_ds.arrays["redshift"])
    y = (train_ds.arrays["label"], val_ds.arrays["label"])
    for combo, (xt, xv) in probe_inputs(names, embs_train, embs_val).items():
        for kind, task, pred, (y_true, y_label) in run_probes(xt, xv, z, y):
            m, r = calculate_metrics(y_true, y_label, pred, f"{label}+{kind}", combo,
                                     run_id, task=task)
            out[task].append(m)
            out[task + "_results"].append(r)


def run_probes(xt, xv, z, y):
    """Every probe of one input, in the JAX CLI's order: yields (kind, task,
    prediction, (true values, true labels)) for the linear and KNN
    regressors of redshift ``z`` = (train, val), then, for the 5-way and
    the 3-way labels ``y`` = (train, val), the linear and KNN classifiers.
    The KNN probes share one neighbour search a label set."""
    from ..evaluation.probes import knn_from_neighbours, linear_probe, neighbours

    truth = (z[1], y[1])
    yield "Linear", "regression", linear_probe(xt, z[0], xv, task="regression"), truth
    idx, _ = neighbours(xt, xv, max(KNN_KS))
    for k in KNN_KS:
        yield (f"KNN{k}", "regression",
               knn_from_neighbours(z[0], idx, min(k, len(xt)), "regression"), truth)
    for tag, (xt_c, yt_c, xv_c, yv_c) in (("five", (xt, y[0], xv, y[1])),
                                          ("three", _three_way(xt, y[0], xv, y[1]))):
        if xt_c is None:
            continue
        yield (f"Linear-{tag}", "classification",
               linear_probe(xt_c, yt_c, xv_c, task="classification"), (None, yv_c))
        idx_c = idx if tag == "five" else neighbours(xt_c, xv_c, max(KNN_KS))[0]
        for k in KNN_KS:
            yield (f"KNN{k}-{tag}", "classification",
                   knn_from_neighbours(yt_c, idx_c, min(k, len(xt_c)), "classification"),
                   (None, yv_c))


def near_ties(xt, xv, y, margin: float, gap: float):
    """{kind of ``run_probes``: (n_val,) bool} of the val rows on which that
    probe sits near a tie on these inputs, where another rounding of the
    embeddings may change the prediction: a LinearSVC whose top two
    decisions (two classes: the decision and 0) lie within ``margin``, a KNN
    whose k-th and (k+1)-th squared distances lie within ``gap``. The linear
    regression has none."""
    from ..evaluation.probes import linear_svc, linear_svc_decision, neighbours

    out = {"Linear": np.zeros(len(xv), bool)}

    def knn(xt_, xv_, suffix):
        _, dist = neighbours(xt_, xv_, max(KNN_KS) + 1)
        for k in KNN_KS:
            out[f"KNN{k}{suffix}"] = (dist[:, k] - dist[:, k - 1] <= gap if k < dist.shape[1]
                                      else np.zeros(len(xv_), bool))

    knn(xt, xv, "")
    for tag, (xt_c, yt_c, xv_c, _) in (("five", (xt, y[0], xv, y[1])),
                                       ("three", _three_way(xt, y[0], xv, y[1]))):
        if xt_c is None:
            continue
        d = linear_svc_decision(*linear_svc(xt_c, yt_c)[:2], xv_c)
        top = np.sort(d, axis=1)
        out[f"Linear-{tag}"] = (np.abs(d[:, 0]) if d.shape[1] == 1
                                else top[:, -1] - top[:, -2]) < margin
        if tag == "five":
            out.update({f"KNN{k}-five": out[f"KNN{k}"] for k in KNN_KS})
        else:
            knn(xt_c, xv_c, "-three")
    return out


def _three_way(xt, yt, xv, yv):
    from ..evaluation.metrics import filter_classes_3way

    (xt3,), yt3, _ = filter_classes_3way([xt], yt)
    (xv3,), yv3, _ = filter_classes_3way([xv], yv)
    if len(yt3) == 0 or len(yv3) == 0 or len(np.unique(yt3)) < 2:
        return None, None, None, None
    return xt3, yt3, xv3, yv3


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="+", required=True,
                    help="run directories (each: <sweep>/<run>)")
    ap.add_argument("--labels", nargs="+", default=None)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--spectra-dir", default=None)
    ap.add_argument("--out-dir", default="evaluation_metrics")
    ap.add_argument("--max-lc-len", type=int, default=100)
    ap.add_argument("--max-spec-len", type=int, default=1024)
    ap.add_argument("--rescale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the embedding pass (default: cuda)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    select_device(args.device)

    from ..data.ztfbts import load_ztfbts
    from ..evaluation.reports import metrics_to_latex
    from ..models.factory import load_run_config

    datasets = {}  # towers: the dataset of their modalities

    def dataset_of(run_dir):
        # the sidecar's extra, or the sweep config's extra_args without one
        combos = tuple(load_run_config(run_dir)[1].get("combinations",
                                                       ("lightcurve", "spectral")))
        if combos not in datasets:
            datasets[combos] = load_ztfbts(
                args.data_dir,
                args.spectra_dir if "spectral" in combos else None,
                combinations=combos,
                max_data_len_lc=args.max_lc_len,
                max_data_len_spec=args.max_spec_len,
                spectral_rescalefactor=args.rescale,
                kfolds=None,
            )[0]
        return datasets[combos]

    labels = args.labels or [os.path.basename(os.path.dirname(r)) for r in args.runs]
    out = {"regression": [], "classification": [],
           "regression_results": [], "classification_results": []}
    for run_id, (run_dir, label) in enumerate(zip(args.runs, labels)):
        print(f"evaluating {run_dir} as {label}", flush=True)
        t0 = time.perf_counter()
        evaluate_run(run_dir, label, run_id, dataset_of(run_dir), out, device=args.device)
        print(f"evaluated {run_dir} in {time.perf_counter() - t0:.3f} s", flush=True)

    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "regression_metrics_list.pkl"), "wb") as f:
        pickle.dump(out["regression"], f)
    with open(os.path.join(args.out_dir, "classification_metrics_list.pkl"), "wb") as f:
        pickle.dump(out["classification"], f)

    for table in metrics_to_latex(out["regression"], sort="R2"):
        print(table)
    if out["classification"]:
        for table in metrics_to_latex(out["classification"], sort="mac-f1"):
            print(table)
    print(PLOTS_SKIPPED)
    print(f"wrote metrics to {args.out_dir}")


if __name__ == "__main__":
    main()
