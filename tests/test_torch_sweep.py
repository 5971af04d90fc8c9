"""The port's sweep runner and training CLIs against the JAX package's: the
schedulers' suggestions, the sweep directory, the split manifests of a
``cli.train`` run on the fixture tree (``configs/smoke.yaml`` and the
maven-lite grid, cut only in epochs and runs), ``--resume``, the fine-tune
and masked CLIs, the stacked ``--parallel-folds`` / ``--parallel-members``
runs, the supervisor, and the flags whose modules wait."""

import json
import os
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import yaml

from fixtures import write_mini_ztfbts
from multimodal_supernovae_tpu.config.config import SweepConfig as JaxSweepConfig
from multimodal_supernovae_tpu.config.config import SweepScheduler as JaxScheduler
from multimodal_supernovae_tpu.config.config import load_sweep as jax_load_sweep
from multimodal_supernovae_tpu.data import native as jax_native
from multimodal_supernovae_tpu.data.folds import split_for_run as jax_split_for_run
from multimodal_supernovae_tpu.data.folds import stratified_kfolds as jax_kfolds
from multimodal_supernovae_tpu.data.ztfbts import load_ztfbts as jax_load_ztfbts
from multimodal_supernovae_tpu.training.experiment import make_sweep_dir as jax_make_sweep_dir
from multimodal_supernovae_tpu_torch.cli import finetune_clip, pretrain_masked, supervise, train
from multimodal_supernovae_tpu_torch.config import SweepConfig, SweepScheduler, load_sweep
from multimodal_supernovae_tpu_torch.config.yaml_subset import dump as dump_yaml
from multimodal_supernovae_tpu_torch.data import make_synthetic_dataset
from multimodal_supernovae_tpu_torch.training import experiment

REPO = Path(__file__).resolve().parent.parent
SMOKE, MAVEN_LITE = str(REPO / "configs/smoke.yaml"), str(REPO / "configs/maven-lite.yaml")
RUN_FILES = {"config.yaml", "train_filenames.txt", "val_filenames.txt", "model_config.json",
             "metrics.jsonl", "summary.json", "last.ckpt"}


def _objective(cfg):
    return float(sum((i + 1) * (hash(repr(v)) % 97) for i, v in enumerate(cfg.values())) % 101)


@pytest.mark.parametrize("method,max_runs", [("grid", None), ("grid", 4), ("random", 7),
                                             ("bayes", 14), ("bayes", None)])
def test_scheduler_suggests_what_jax_suggests(method, max_runs):
    """The same suggestions for the same observations (bayes: 5 random, then
    TPE picks), over a 4 x 3 x 2 grid."""
    params = {"lr": [1e-3, 3e-4, 1e-4, 3e-5], "emb": [16, 32, 64], "agg": ["mean", "attn"]}
    extra = {"nruns": 9, "sweep_seed": 3}
    metric = {"name": "best_val_loss", "goal": "minimize"}
    seqs = []
    for cfg_cls, sched_cls in ((JaxSweepConfig, JaxScheduler), (SweepConfig, SweepScheduler)):
        sched = sched_cls(cfg_cls(parameters=params, extra_args=extra, method=method,
                                  metric=metric), max_runs=max_runs)
        seq = []
        while (cfg := sched.suggest()) is not None:
            seq.append(cfg)
            sched.observe(cfg, _objective(cfg))
        seqs.append((sched.n_runs, seq))
    assert seqs[0] == seqs[1]
    assert len(seqs[1][1]) == {"grid": 24 if max_runs is None else 4, "random": 7,
                               "bayes": 14 if max_runs else 9}[method]


def test_make_sweep_dir_matches_jax(tmp_path):
    for path in (SMOKE, MAVEN_LITE, str(REPO / "configs/maven_finetune.yaml")):
        name = Path(path).stem
        got = experiment.make_sweep_dir(load_sweep(path), str(tmp_path / "port"), name)
        want = jax_make_sweep_dir(jax_load_sweep(path), str(tmp_path / "jax"), name)
        assert os.path.basename(got) == os.path.basename(want) == name
        assert sorted(os.listdir(got)) == sorted(os.listdir(want)) == ["sweep_config.yaml"]
        with open(os.path.join(got, "sweep_config.yaml")) as f, \
                open(os.path.join(want, "sweep_config.yaml")) as g:
            assert yaml.safe_load(f) == yaml.safe_load(g)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """cli.train on the CPU: smoke.yaml and the maven-lite grid (1 epoch, 2
    runs), then maven-lite again with --resume."""
    root = tmp_path_factory.mktemp("sweep")
    data_dir, spectra_dir, _ = write_mini_ztfbts(str(root), n=40, seed=3)
    common = ["--data-dir", data_dir, "--spectra-dir", spectra_dir, "--device", "cpu",
              "--analysis-path", str(root / "analysis"), "--cache-dir", str(root / "cache"),
              "--epochs", "1", "--max-runs", "2"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for cfg in (SMOKE, MAVEN_LITE):
            train.main([cfg, *common])
    return root, data_dir, spectra_dir, common


def _jax_dataset(config_path, data_dir, spectra_dir):
    jax_native.ensure_built()
    extra = jax_load_sweep(config_path).extra_args
    ds = jax_load_ztfbts(data_dir, spectra_dir, tuple(extra["combinations"]),
                         int(extra.get("max_lightcurve_data_len", 100)),
                         int(extra.get("max_spectral_data_len", 1000)),
                         int(extra.get("n_classes", 5)),
                         float(extra.get("spectral_rescalefactor", 1e14)), kfolds=None)[0]
    return ds, extra


@pytest.mark.parametrize("config", [SMOKE, MAVEN_LITE])
def test_train_cli_writes_jax_split_manifests(trained, config):
    """The sweep directory is make_sweep_dir's plus run-<k>; each run holds
    the run-dir contract, and its manifests are the JAX package's
    split_for_run (the random split for smoke.yaml, the stratified folds for
    maven-lite) of the JAX package's ingest."""
    root, data_dir, spectra_dir, _ = trained
    name = Path(config).stem
    sweep_dir = root / "analysis" / name
    ds, extra = _jax_dataset(config, data_dir, spectra_dir)
    points = list(load_sweep(config).parameters.get("foldnumber", [None]))
    runs = sorted(p for p in os.listdir(sweep_dir) if p.startswith("run-"))
    assert sorted(os.listdir(sweep_dir)) == runs + ["sweep_config.yaml"]
    assert runs == [f"run-{k}" for k in range(min(2, len(points)))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        folds = jax_kfolds(ds.arrays["label"], extra["kfolds"]) if extra.get("kfolds") else None
    for k, run in enumerate(runs):
        files = set(os.listdir(sweep_dir / run))
        assert RUN_FILES <= files and any(f.startswith("epoch=") for f in files)
        tr, va = jax_split_for_run(len(ds), float(extra.get("val_fraction", 0.2)), 0,
                                   folds=folds, foldnumber=points[k])
        for fname, idx in (("train_filenames.txt", tr), ("val_filenames.txt", va)):
            assert (sweep_dir / run / fname).read_text().splitlines() == [
                ds.filenames[i] for i in idx]
        rows = [json.loads(line) for line in open(sweep_dir / run / "metrics.jsonl")]
        assert [r["epoch"] for r in rows] == [0] and np.isfinite(rows[0]["val_loss"])


def test_resume_skips_completed_runs(trained, capsys):
    root, _, _, common = trained
    sweep_dir = root / "analysis" / "maven-lite"
    before = {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in sweep_dir.rglob("*")
              if p.is_file()}
    capsys.readouterr()
    train.main([str(sweep_dir), *common, "--resume"])
    out = capsys.readouterr().out
    after = {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in sweep_dir.rglob("*")
             if p.is_file()}
    assert before == after
    assert "cache=hit" in out and out.count("epochs=0") == 2


def test_finetune_and_masked_clis(trained):
    """cli.finetune_clip from the smoke run (contrastive, then a 3-class
    head with freeze_backbone) and cli.pretrain_masked --source real, on a
    tiny grid each."""
    root, data_dir, spectra_dir, _ = trained
    smoke = load_sweep(SMOKE).raw
    common = ["--data-dir", data_dir, "--device", "cpu", "--analysis-path",
              str(root / "analysis"), "--cache-dir", str(root / "cache"), "--epochs", "1"]
    extra = dict(smoke["extra_args"], pretrain_path=str(root / "analysis/smoke/run-0"),
                 kfolds=3)
    params = dict(smoke["parameters"], foldnumber={"values": [0, 1]},
                  hidden_dim={"values": [8]}, num_layers={"values": [2]})
    for name, ex in (("ft", extra), ("ft_head", dict(extra, classification=True,
                                                     n_classes=3, freeze_backbone=True))):
        path = root / f"{name}.yaml"
        path.write_text(dump_yaml(dict(smoke, parameters=params, extra_args=ex)))
        finetune_clip.main([str(path), "--spectra-dir", spectra_dir, *common,
                            "--max-runs", "2"])
        runs = sorted(os.listdir(root / "analysis" / name))
        assert runs == ["run-0", "run-1", "sweep_config.yaml"]
        rows = [json.loads(line) for line in open(root / "analysis" / name / "run-1" /
                                                  "metrics.jsonl")]
        assert np.isfinite(rows[-1]["train_loss"])
        assert ("f1_val" in rows[-1]) == (name == "ft_head")
    grid = root / "grid.yaml"
    grid.write_text(dump_yaml(dict(smoke, parameters=dict(
        smoke["parameters"], step_size={"values": [1]}, gamma={"values": [0.5]},
        f_mask={"values": [0.2]}), extra_args=dict(smoke["extra_args"],
                                                   combinations=["lightcurve"]))))
    pretrain_masked.main([str(grid), "--source", "real", *common])
    run = root / "analysis" / "grid-masked" / "run-0"
    assert RUN_FILES <= set(os.listdir(run))
    assert json.loads((run / "model_config.json").read_text())["model"] == \
        "MaskedLightCurveEncoder"


@pytest.mark.parametrize("argv", [["--source", "sim"], []], ids=["explicit", "default"])
def test_pretrain_masked_trains_from_a_legacy_sim_file(tmp_path, argv):
    """cli.pretrain_masked --source sim (the default) trains one masked run
    from a legacy TransientTable HDF5 in --data-dir: the run files, the JAX
    CLI's cache key (kind simlc), and a dataset bitwise the JAX package's
    ingest of the file."""
    import h5py

    from multimodal_supernovae_tpu.data.cache import cache_key as jax_cache_key
    from multimodal_supernovae_tpu.data.simulation import (
        ingest_simulation_lightcurves as jax_ingest,
    )
    from multimodal_supernovae_tpu_torch.data.cache import load_dataset

    data_dir = tmp_path / "sim"
    data_dir.mkdir()
    path = str(data_dir / "ZTF_Pretrain_5Class.hdf5")
    rng = np.random.default_rng(2)
    with h5py.File(path, "w") as f:
        for t_type in ("SNIa", "SNII"):
            g = f.create_group(f"TransientTable/{t_type}/model0")
            n, width = 12, 30
            g["MJD"] = np.sort(rng.random((n, width)) * 60, axis=1)
            for band in ("r", "g"):
                mag = 23 + rng.normal(size=(n, width))
                mag[rng.random((n, width)) < 0.15] = 99.0  # not observed
                g[f"mag_{band}"] = mag
            g["mwebv"] = rng.random(n) * 0.1
    smoke = load_sweep(SMOKE).raw
    grid = tmp_path / "grid.yaml"
    grid.write_text(dump_yaml(dict(smoke, parameters=dict(
        smoke["parameters"], step_size={"values": [1]}, gamma={"values": [0.5]},
        f_mask={"values": [0.2]}), extra_args=dict(smoke["extra_args"],
                                                   combinations=["lightcurve"]))))
    cache = tmp_path / "cache"
    pretrain_masked.main([str(grid), *argv, "--data-dir", str(data_dir), "--device", "cpu",
                          "--analysis-path", str(tmp_path / "analysis"), "--cache-dir",
                          str(cache), "--epochs", "1"])
    run = tmp_path / "analysis" / "grid-masked" / "run-0"
    assert RUN_FILES <= set(os.listdir(run))
    assert json.loads((run / "model_config.json").read_text())["model"] == \
        "MaskedLightCurveEncoder"
    config = dict(hdf5_path=path, bands=("r", "g"),
                  n_max_obs=int(smoke["extra_args"]["max_lightcurve_data_len"]),
                  dataset_length=None)
    assert os.listdir(cache) == [jax_cache_key(kind="simlc", **config)]
    got, want = load_dataset(str(cache), os.listdir(cache)[0]), jax_ingest(**config)
    assert sorted(got.arrays) == sorted(want.arrays) and got.filenames == want.filenames
    for k, v in want.arrays.items():
        assert got.arrays[k].dtype == v.dtype
        np.testing.assert_array_equal(got.arrays[k], v, err_msg=k)
    names = [(run / f).read_text().splitlines() for f in ("train_filenames.txt",
                                                          "val_filenames.txt")]
    assert sorted(names[0] + names[1]) == want.filenames


@pytest.mark.parametrize("main,argv,item", [
    (train.main, ["--tp", "2"], "item 15"),
    (train.main, ["--mesh", "--parallel-folds"], "item 15"),
    (finetune_clip.main, ["--tp", "2"], "item 15"),
    (pretrain_masked.main, ["--source", "real", "--tp", "2"], "item 15"),
])
def test_unported_flags_raise_with_their_item(main, argv, item, trained, tmp_path):
    """The flags of ``item`` (ROADMAP item 15d, ported): ``--tp 2`` in one
    process raises the JAX package's indivisibility error in every training
    CLI; ``--mesh --parallel-folds`` trains the stacked group."""
    if "--tp" in argv:
        with pytest.raises(ValueError, match="1 global devices not divisible by model=2"):
            main([SMOKE, *argv, "--device", "cpu"])
        return
    root, data_dir, spectra_dir, _ = trained
    main([SMOKE, *argv, "--data-dir", data_dir, "--spectra-dir", spectra_dir, "--device", "cpu",
          "--analysis-path", str(tmp_path), "--cache-dir", str(root / "cache"), "--epochs", "1"])
    assert RUN_FILES <= set(os.listdir(tmp_path / "smoke" / "run-0"))
    assert "_ensemble-g0" in os.listdir(tmp_path / "smoke")


def test_unported_runners_raise_with_their_item(tmp_path):
    """run_sweep_streaming is ported (item 17b): the smoke sweep over a sharded
    copy of a synthetic set trains run-0 through fit_sharded and a resumed
    walk skips it; over a mesh (item 17c, ported) a one-process mesh trains
    the same run, its shard cursor kept (the ranks' cases:
    tests/test_torch_stream_dp.py)."""
    from multimodal_supernovae_tpu_torch.data.streaming import write_sharded_cache
    from multimodal_supernovae_tpu_torch.parallel.mesh import DataMesh

    sweep = load_sweep(SMOKE)
    ds = make_synthetic_dataset(n=24, seed=0, n_max_lc=8, nband=2, n_max_sp=12,
                                modalities=tuple(sweep.extra_args["combinations"]))
    sds = write_sharded_cache(str(tmp_path / "shards"), iter([ds.arrays]), 10)
    val = ds.subset(np.arange(8))
    sweep_dir = str(tmp_path / "smoke")
    res = experiment.run_sweep_streaming(sweep, sds, val, 2, sweep_dir, epochs_override=1,
                                         max_runs=1, device="cpu")
    assert res[0]["epochs_run"] == 1 and RUN_FILES <= set(os.listdir(res[0]["run_dir"]))
    again = experiment.run_sweep_streaming(sweep, sds, val, 2, sweep_dir, epochs_override=1,
                                           max_runs=1, resume=True, device="cpu")
    assert again[0]["skipped"]
    meshed = experiment.run_sweep_streaming(sweep, sds, val, 2, str(tmp_path / "m"),
                                            epochs_override=1, mesh=DataMesh(0, 1),
                                            max_runs=1, device="cpu")
    assert meshed[0]["history"] == res[0]["history"]
    assert "ckpt_cursor" in os.listdir(meshed[0]["run_dir"])


def _small_maven_lite(path, parameters=None, extra_args=None):
    """configs/maven-lite.yaml at narrow widths and batch 8 (its dropout,
    folds, lr, seed and spectrum length kept), with ``parameters`` and
    ``extra_args`` laid over it."""
    raw = load_sweep(MAVEN_LITE).raw
    narrow = {k: {"values": [v]} for k, v in (("emb", 16), ("heads", 2), ("emb_spectral", 16),
                                              ("transformer_depth", 1), ("batchsize", 8),
                                              ("transformer_depth_spectral", 1))}
    path.write_text(dump_yaml(dict(raw, parameters=dict(raw["parameters"], **narrow,
                                                        **(parameters or {})),
                                   extra_args=dict(raw["extra_args"], **(extra_args or {})))))
    return str(path)


PARALLEL = {  # sweep name: (CLI, flag, the grid's foldnumber / lr / seed values)
    "ml-folds": ("train", "--parallel-folds", {}),
    "ml-members": ("train", "--parallel-members", {"foldnumber": [0, 1],
                                                   "lr": [3.716367614864064e-05, 1e-4],
                                                   "seed": [0, 1]}),
    "ml-finetune": ("finetune_clip", "--parallel-folds", {}),
}


@pytest.fixture(scope="module")
def parallel(trained):
    """The stacked CLIs on the fixture tree (1 epoch): cli.train
    --parallel-folds on the five folds of a small maven-lite, cli.train
    --parallel-members on its lr x seed x 2-fold grid, and cli.finetune_clip
    --parallel-folds from the first fold's run."""
    root, data_dir, spectra_dir, _ = trained
    common = ["--data-dir", data_dir, "--spectra-dir", spectra_dir, "--device", "cpu",
              "--analysis-path", str(root / "parallel"), "--cache-dir", str(root / "cache"),
              "--epochs", "1"]
    out = {}
    for name, (cli, flag, grid) in PARALLEL.items():
        extra = ({"pretrain_path": str(root / "parallel/ml-folds/run-0")}
                 if cli == "finetune_clip" else {"nruns": 8})
        path = _small_maven_lite(root / f"{name}.yaml",
                                 {k: {"values": v} for k, v in grid.items()}, extra)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            {"train": train.main, "finetune_clip": finetune_clip.main}[cli](
                [path, *common, flag])
        out[name] = load_sweep(path)
    return root, common, out


@pytest.mark.parametrize("name", sorted(PARALLEL))
def test_parallel_clis_write_every_member_run_dir(parallel, name):
    """Every grid point of the stacked group has its run dir, with the
    sequential run's files, the port's split rule for its fold and seed, and
    one metrics row carrying the member's share of the throughput."""
    from multimodal_supernovae_tpu_torch.cli.common import ingest_config
    from multimodal_supernovae_tpu_torch.data.cache import cache_key, load_dataset
    from multimodal_supernovae_tpu_torch.data.folds import split_for_run, stratified_kfolds

    root, common, sweeps = parallel
    sweep = sweeps[name]
    sweep_dir = root / "parallel" / name
    points = []
    scheduler = SweepScheduler(sweep, max_runs=sweep.extra_args["nruns"])
    while (cfg := scheduler.suggest()) is not None:
        points.append(cfg)
    runs = sorted(p for p in os.listdir(sweep_dir) if p.startswith("run-"))
    assert runs == sorted(f"run-{k}" for k in range(len(points)))
    assert "_ensemble-g0" in os.listdir(sweep_dir)
    data_dir, spectra_dir = common[1], common[3]
    ds = load_dataset(str(root / "cache"), cache_key(**ingest_config(
        data_dir, spectra_dir, sweep.extra_args, 1000)))
    folds = stratified_kfolds(ds.arrays["label"], 5)
    for k, cfg in enumerate(points):
        run = sweep_dir / f"run-{k}"
        files = set(os.listdir(run))
        assert RUN_FILES <= files and any(f.startswith("epoch=") for f in files)
        assert yaml.safe_load((run / "config.yaml").read_text()) == cfg
        tr, va = split_for_run(len(ds), 0.2, int(cfg["seed"]), folds=folds,
                               foldnumber=cfg["foldnumber"])
        for fname, idx in (("train_filenames.txt", tr), ("val_filenames.txt", va)):
            assert (run / fname).read_text().splitlines() == [ds.filenames[i] for i in idx]
        rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
        assert [r["epoch"] for r in rows] == [0] and np.isfinite(rows[0]["val_loss"])
        assert rows[0]["samples_per_s"] == pytest.approx(
            len(points) * rows[0]["member_samples_per_s"])


def test_parallel_resume_skips_a_finished_group(parallel, capsys):
    root, common, _ = parallel
    sweep_dir = root / "parallel" / "ml-folds"
    before = {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in sweep_dir.rglob("*")
              if p.is_file()}
    capsys.readouterr()
    train.main([str(sweep_dir), *common, "--parallel-folds", "--resume"])
    out = capsys.readouterr().out
    after = {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in sweep_dir.rglob("*")
             if p.is_file()}
    assert before == after
    assert out.count("epochs=0") == 5


def test_train_cli_refuses_a_missing_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main([SMOKE, "--data-dir", str(tmp_path)])


def test_supervise_restarts_with_resume(tmp_path):
    """A child that fails until it is given --resume: one restart, exit 0."""
    marker = tmp_path / "seen"
    code = ("import sys, pathlib; p = pathlib.Path(sys.argv[1]); p.write_text(p.read_text() + "
            "' '.join(sys.argv[2:]) + '|' if p.exists() else ' '.join(sys.argv[2:]) + '|'); "
            "sys.exit(0 if '--resume' in sys.argv else 3)")
    assert supervise.build_restart_cmd(["a", "--resume"], "--resume") == ["a", "--resume"]
    with pytest.raises(SystemExit) as exc:
        supervise.main(["--backoff", "0", "--", sys.executable, "-c", code, str(marker)])
    assert exc.value.code == 0
    assert marker.read_text() == "|--resume|"
