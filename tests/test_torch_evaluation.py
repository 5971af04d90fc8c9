"""The port's evaluation path against the JAX package's on run dirs the port
trains on the fixture tree (``cli.train``, both towers aggregating by the
mean, which the JAX package's ``load_model`` reads): ``evaluate_run`` for
the contrastive and both supervised branches (embeddings within 1e-5,
regression rows within 1e-4, any other difference only on rows the probes
hold near a tie), the evaluate CLI's pickles and tables, and the
``export_embeddings`` and ``infer`` CLIs' artifacts and manifests."""

import json
import os
import pickle
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from fixtures import write_mini_sim_hdf5, write_mini_ztfbts
from multimodal_supernovae_tpu.data import native as jax_native
from multimodal_supernovae_tpu.data.simulation import ingest_simulation as jax_ingest_simulation
from multimodal_supernovae_tpu.data.ztfbts import load_ztfbts as jax_load_ztfbts
from multimodal_supernovae_tpu_torch.cli import evaluate, export_embeddings, infer
from multimodal_supernovae_tpu_torch.cli import pretrain_masked, train
from multimodal_supernovae_tpu_torch.config import load_sweep
from multimodal_supernovae_tpu_torch.config.yaml_subset import dump as dump_yaml
from multimodal_supernovae_tpu_torch.data.simulation import ingest_simulation
from multimodal_supernovae_tpu_torch.data.ztfbts import load_ztfbts
from multimodal_supernovae_tpu_torch.evaluation import (
    get_embeddings,
    masked_reconstruction_mse,
    predict_supervised,
)
from multimodal_supernovae_tpu_torch.models import load_model

REPO = Path(__file__).resolve().parent.parent
SMOKE = REPO / "configs/smoke.yaml"
LC_LEN, SP_LEN, RESCALE = 16, 32, 1e14
EMB_TOL, REG_TOL = 1e-5, 1e-4
SVC_MARGIN, KNN_GAP = 1e-3, 1e-5
KINDS = ("clip", "reg", "cls")


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One run of each kind through the port's cli.train on the CPU, fold 0
    of 3: contrastive, regression and classification heads."""
    root = tmp_path_factory.mktemp("evaluate")
    data_dir, spectra_dir, _ = write_mini_ztfbts(str(root), n=150, seed=5)
    smoke = load_sweep(str(SMOKE)).raw
    params = dict(smoke["parameters"], emb={"values": [16]}, emb_spectral={"values": [16]},
                  foldnumber={"values": [0]})
    common = ["--data-dir", data_dir, "--device", "cpu", "--analysis-path",
              str(root / "analysis"), "--cache-dir", str(root / "cache"), "--epochs", "2"]
    extra = dict(smoke["extra_args"], kfolds=3, max_lightcurve_data_len=LC_LEN // 2,
                 max_spectral_data_len=SP_LEN, spectral_rescalefactor=RESCALE)
    for kind, ex in (("clip", extra), ("reg", dict(extra, regression=True)),
                     ("cls", dict(extra, classification=True)),
                     ("lc_reg", dict(extra, regression=True, combinations=["lightcurve"]))):
        path = root / f"{kind}.yaml"
        path.write_text(dump_yaml(dict(smoke, parameters=params, extra_args=ex)))
        train.main([str(path), "--spectra-dir", spectra_dir, *common])
    grid = root / "masked.yaml"
    grid.write_text(dump_yaml(dict(smoke, parameters=dict(
        params, step_size={"values": [1]}, gamma={"values": [0.5]}, f_mask={"values": [0.2]}),
        extra_args=dict(extra, combinations=["lightcurve"]))))
    pretrain_masked.main([str(grid), "--source", "real", *common])
    runs = {kind: str(root / "analysis" / kind / "run-0") for kind in KINDS + ("lc_reg",)}
    runs["masked"] = str(root / "analysis" / "masked-masked" / "run-0")
    return root, data_dir, spectra_dir, runs


def _datasets(data_dir, spectra_dir):
    kw = dict(combinations=("lightcurve", "spectral"), max_data_len_lc=LC_LEN // 2,
              max_data_len_spec=SP_LEN, spectral_rescalefactor=RESCALE, kfolds=None)
    jax_native.ensure_built()
    return load_ztfbts(data_dir, spectra_dir, **kw)[0], jax_load_ztfbts(
        data_dir, spectra_dir, **kw)[0]


def _near_ties(model_name, combo, embs, names, train_ds, val_ds):
    """The val rows on which the probe ``model_name`` (``<label>+<kind>``) is
    near a tie on the port's embeddings: a top-two LinearSVC margin under
    SVC_MARGIN, or k-th and (k+1)-th distances within KNN_GAP."""
    xt, xv = evaluate.probe_inputs(names, *embs)[combo]
    y = (train_ds.arrays["label"], val_ds.arrays["label"])
    return evaluate.near_ties(xt, xv, y, SVC_MARGIN, KNN_GAP)[model_name.split("+", 1)[1]]


def test_evaluate_run_matches_jax(trained):
    from multimodal_supernovae_tpu.cli.evaluate import evaluate_run as jax_evaluate_run
    from multimodal_supernovae_tpu.evaluation.embeddings import (
        get_embeddings as jax_get_embeddings,
    )
    from multimodal_supernovae_tpu.models.factory import load_model as jax_load_model

    _, data_dir, spectra_dir, runs = trained
    port_ds, jax_ds = _datasets(data_dir, spectra_dir)
    assert port_ds.filenames == jax_ds.filenames
    near_rows = 0
    for run_id, kind in enumerate(KINDS):
        got = {k: [] for k in ("regression", "classification", "regression_results",
                               "classification_results")}
        want = {k: [] for k in got}
        evaluate.evaluate_run(runs[kind], kind, run_id, port_ds, got, device="cpu")
        jax_evaluate_run(runs[kind], kind, run_id, jax_ds, want)
        n_rows = {"clip": (24, 48), "reg": (1, 0), "cls": (0, 1)}[kind]
        assert (len(got["regression"]), len(got["classification"])) == n_rows

        model, _ = load_model(runs[kind], "cpu")
        train_ds, val_ds = evaluate.split_datasets(runs[kind], port_ds)
        if kind == "clip":
            jmodel, variables, *_ = jax_load_model(
                runs[kind], jax_ds.host_batch(np.arange(4)))
            embs = []
            for ds in (train_ds, val_ds):
                mine, names = get_embeddings(model, ds, device="cpu")
                theirs, _ = jax_get_embeddings(jmodel, variables,
                                               jax_ds.subset_by_filenames(ds.filenames))
                for m, t in zip(mine, theirs):
                    assert np.max(np.abs(m - t)) <= EMB_TOL
                embs.append(mine)
        for task in ("regression", "classification"):
            for g, w, gr, wr in zip(got[task], want[task], got[task + "_results"],
                                    want[task + "_results"]):
                assert list(g) == list(w)
                assert (g["Model"], g["Combination"], g["id"]) == (
                    w["Model"], w["Combination"], w["id"])
                np.testing.assert_array_equal(gr["y_true_label"], wr["y_true_label"])
                diff = np.abs(np.asarray(gr["y_pred"], np.float64)
                              - np.asarray(wr["y_pred"], np.float64)) > (
                    REG_TOL * max(1.0, np.max(np.abs(wr["y_pred"])))
                    if task == "regression" else 0)
                if diff.any():
                    assert kind == "clip", (g["Model"], diff.sum())
                    near = _near_ties(g["Model"], g["Combination"], embs, names,
                                      train_ds, val_ds)
                    assert not (diff & ~near).any(), (g["Model"], g["Combination"])
                    near_rows += int(diff.sum())
                    continue
                for k, v in w.items():
                    if isinstance(v, float):
                        tol = REG_TOL if task == "regression" else 1e-12
                        assert abs(g[k] - v) <= tol * max(1.0, abs(v)), (g["Model"], k)
                    else:
                        assert g[k] == v, k
    assert near_rows <= 2


def test_evaluate_cli_writes_the_pickles_and_tables(trained, capsys):
    root, data_dir, spectra_dir, runs = trained
    out_dir = root / "metrics"
    evaluate.main(["--runs", runs["clip"], runs["reg"], "--labels", "clip", "reg",
                   "--data-dir", data_dir, "--spectra-dir", spectra_dir,
                   "--out-dir", str(out_dir), "--max-lc-len", str(LC_LEN // 2),
                   "--max-spec-len", str(SP_LEN), "--rescale", str(RESCALE),
                   "--device", "cpu"])
    printed = capsys.readouterr().out
    port_ds, _ = _datasets(data_dir, spectra_dir)
    want = {k: [] for k in ("regression", "classification", "regression_results",
                            "classification_results")}
    for run_id, kind in enumerate(("clip", "reg")):
        evaluate.evaluate_run(runs[kind], kind, run_id, port_ds, want, device="cpu")
    for task in ("regression", "classification"):
        with open(out_dir / f"{task}_metrics_list.pkl", "rb") as f:
            assert pickle.load(f) == want[task]
    assert evaluate.PLOTS_SKIPPED in printed
    assert printed.count("\\begin{tabular}") == 3  # 4 regression, 8 classification columns
    assert "evaluating" in printed and f"wrote metrics to {out_dir}" in printed


def test_evaluate_cli_reads_a_light_curve_run_on_its_own_towers(trained, capsys):
    """A light-curve-only run trained on transients without a spectrum: the
    port's CLI evaluates it on light curves; the JAX CLI's light curves and
    spectra miss some of its split."""
    from multimodal_supernovae_tpu.cli.evaluate import evaluate_run as jax_evaluate_run

    root, data_dir, spectra_dir, runs = trained
    _, jax_ds = _datasets(data_dir, spectra_dir)
    with open(os.path.join(runs["lc_reg"], "train_filenames.txt")) as f:
        names = f.read().split() + open(os.path.join(runs["lc_reg"],
                                                     "val_filenames.txt")).read().split()
    assert not set(names) <= set(jax_ds.filenames)
    with pytest.raises(AssertionError, match="split not in dataset"):
        jax_evaluate_run(runs["lc_reg"], "lc", 0, jax_ds, {})
    out_dir = root / "lc_metrics"
    evaluate.main(["--runs", runs["lc_reg"], "--data-dir", data_dir, "--spectra-dir",
                   spectra_dir, "--out-dir", str(out_dir), "--max-lc-len", str(LC_LEN // 2),
                   "--rescale", str(RESCALE), "--device", "cpu"])
    with open(out_dir / "regression_metrics_list.pkl", "rb") as f:
        rows = pickle.load(f)
    assert [(r["Model"], r["Combination"]) for r in rows] == [("lc_reg", "lightcurve")]
    assert np.isfinite(rows[0]["L1"])


@pytest.mark.parametrize("main,argv", [
    (evaluate.main, ["--runs", "r", "--data-dir", "d"]),
    (export_embeddings.main, ["--run", "r", "--data-dir", "d"]),
    (infer.main, ["r", "--out", "o.npz"])])
def test_evaluation_clis_refuse_a_missing_card(main, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


def test_evaluate_refuses_a_manifest_name_missing_from_the_dataset(trained):
    _, data_dir, spectra_dir, runs = trained
    port_ds, _ = _datasets(data_dir, spectra_dir)
    short = port_ds.subset(np.arange(len(port_ds) - 5))
    with pytest.raises(ValueError, match="manifest filenames not in dataset"):
        evaluate.evaluate_run(runs["clip"], "clip", 0, short,
                              {k: [] for k in ("regression", "classification")}, "cpu")
    names = ["x", port_ds.filenames[3], port_ds.filenames[1]]
    with pytest.raises(ValueError, match="1 manifest"):
        port_ds.subset_by_filenames(names)
    assert port_ds.subset_by_filenames(names[1:]).filenames == [port_ds.filenames[1],
                                                                port_ds.filenames[3]]


def _jax_cli(monkeypatch, main, argv):
    monkeypatch.setenv("MMSN_COMPILE_CACHE", "0")
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    main()


def test_export_embeddings_matches_jax(trained, monkeypatch):
    from multimodal_supernovae_tpu.cli.export_embeddings import main as jax_main

    root, data_dir, spectra_dir, runs = trained
    common = ["--data-dir", data_dir, "--spectra-dir", spectra_dir, "--max-lc-len",
              str(LC_LEN // 2), "--max-spec-len", str(SP_LEN), "--rescale", str(RESCALE),
              "--split", "val"]
    export_embeddings.main(["--run", runs["clip"], "--out", str(root / "port.npz"),
                            "--device", "cpu", *common])
    _jax_cli(monkeypatch, jax_main, ["--run", runs["clip"], "--out", str(root / "jax.npz"),
                                     *common])
    got, want = np.load(root / "port.npz"), np.load(root / "jax.npz")
    assert sorted(got.files) == sorted(want.files) == [
        "emb_lightcurve", "emb_spectral", "filenames", "label", "redshift"]
    for k in want.files:
        if k.startswith("emb_"):
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
            assert np.max(np.abs(got[k] - want[k])) <= EMB_TOL
        else:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kind,split", [("clip", "val"), ("reg", "all"), ("cls", "train")])
def test_infer_matches_jax(trained, monkeypatch, kind, split):
    from multimodal_supernovae_tpu.cli.infer import main as jax_main

    root, data_dir, spectra_dir, runs = trained
    common = [runs[kind], "--data-dir", data_dir, "--spectra-dir", spectra_dir,
              "--split", split]
    outs = {who: root / f"infer-{kind}-{who}" / "out.npz" for who in ("port", "jax")}
    infer.main([*common, "--out", str(outs["port"]), "--cache-dir", str(root / "c1"),
                "--device", "cpu"])
    _jax_cli(monkeypatch, jax_main, [*common, "--out", str(outs["jax"]), "--cache-dir",
                                     str(root / "c2")])
    got, want = np.load(outs["port"]), np.load(outs["jax"])
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        if k in ("filenames", "pred_class"):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k].shape == want[k].shape
            assert np.max(np.abs(got[k] - want[k])) <= EMB_TOL, k
    manifests = [json.loads(p.with_suffix(".json").read_text()) for p in outs.values()]
    assert list(manifests[0]) == list(manifests[1])
    assert manifests[0]["backend"] == "cpu"
    assert {k: v for k, v in manifests[0].items() if k != "backend"} == {
        k: v for k, v in manifests[1].items() if k != "backend"}


def test_infer_masked_and_supervised_equal_the_direct_calls(trained):
    root, data_dir, spectra_dir, runs = trained
    out = root / "masked" / "scores.npz"
    infer.main([runs["masked"], "--data-dir", data_dir, "--out", str(out), "--seed", "3",
                "--batch-size", "16", "--device", "cpu", "--cache-dir", str(root / "c3")])
    model, _ = load_model(runs["masked"], "cpu")
    lc = load_ztfbts(data_dir, None, ("lightcurve",), LC_LEN // 2, SP_LEN, 5, RESCALE,
                     kfolds=None)[0]
    want = masked_reconstruction_mse(model, lc, generator=torch.Generator().manual_seed(3),
                                     batch_size=16, device="cpu")
    got = np.load(out)
    np.testing.assert_array_equal(got["recon_mse"], want)
    np.testing.assert_array_equal(got["filenames"], lc.filenames)
    assert json.loads(out.with_suffix(".json").read_text())["task"] == "masked_anomaly_score"

    out = root / "cls" / "pred.npz"
    infer.main([runs["cls"], "--data-dir", data_dir, "--spectra-dir", spectra_dir,
                "--out", str(out), "--device", "cpu", "--cache-dir", str(root / "c4")])
    model, _ = load_model(runs["cls"], "cpu")
    ds = load_ztfbts(data_dir, spectra_dir, ("lightcurve", "spectral"), LC_LEN // 2, SP_LEN,
                     5, RESCALE, kfolds=None)[0]
    pred = predict_supervised(model, ds, device="cpu")
    got = np.load(out)
    np.testing.assert_array_equal(got["pred"], pred)
    np.testing.assert_array_equal(got["pred_class"], pred.argmax(axis=-1))


def test_infer_hdf5_equals_get_embeddings(trained):
    """infer --hdf5 on a simulated corpus: the contrastive run's embeddings
    of ingest_simulation of the file with the run's bands, lengths and
    combinations, as get_embeddings gives them, and JAX's ingest of it."""
    root, _, _, runs = trained
    path = write_mini_sim_hdf5(str(root / "sims.h5"), n_per_type=9, lc_len=40, sp_len=80)
    out = root / "sims" / "emb.npz"
    infer.main([runs["clip"], "--hdf5", path, "--out", str(out), "--device", "cpu",
                "--batch-size", "8"])
    kw = dict(bands=("r", "g"), n_max_obs=LC_LEN // 2, n_max_obs_spec=SP_LEN,
              combinations=("lightcurve", "spectral"))
    ds = ingest_simulation(path, **kw)
    want = jax_ingest_simulation(path, **kw)
    for k, v in want.arrays.items():
        np.testing.assert_array_equal(ds.arrays[k], v, err_msg=k)
    model, _ = load_model(runs["clip"], "cpu")
    embs, names = get_embeddings(model, ds, 8, "cpu")
    got = np.load(out)
    assert sorted(got.files) == sorted([f"emb_{n}" for n in names] + ["filenames"])
    for e, n in zip(embs, names):
        np.testing.assert_array_equal(got[f"emb_{n}"], e)
    np.testing.assert_array_equal(got["filenames"], [f"SIM{i:07d}" for i in range(18)])
    manifest = json.loads(out.with_suffix(".json").read_text())
    assert manifest["task"] == "contrastive_embeddings" and manifest["n_samples"] == 18
