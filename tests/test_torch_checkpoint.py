"""The port's run directories against the JAX package's, on CPU, at a small
size: the run-dir contract (config.yaml that PyYAML reads back, the split
manifests and the model sidecar that the JAX package's readers take), a
port-written run loaded by the JAX package's ``load_model`` (embeddings
within 2e-5), the best-k checkpoints and the two meanings of "best",
resume in process and after SIGKILL (bitwise on the CPU), and the abort on
a non-finite loss.

Run as a script, this file is the SIGKILL test's worker (it imports no jax):
  python tests/test_torch_checkpoint.py --run-dir RUN --epochs 4 --out P.npz
      [--resume] [--kill-at-epoch 2]
"""

import argparse
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

from multimodal_supernovae_tpu_torch.config.yaml_subset import safe_load  # noqa: E402
from multimodal_supernovae_tpu_torch.data import make_synthetic_dataset  # noqa: E402
from multimodal_supernovae_tpu_torch.models import (  # noqa: E402
    CLIPConfig,
    CLIPModel,
    initialize_from_run_dir,
    load_model,
    load_run_config,
    pick_reference_ckpt,
    read_model_config,
)
from multimodal_supernovae_tpu_torch.training import (  # noqa: E402
    Trainer,
    TrainerConfig,
    TrainState,
    build_optimizer,
)
from multimodal_supernovae_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointManager,
    load_params,
    load_run_sidecars,
    save_params,
    save_run_sidecars,
)

SYN = dict(n_max_lc=8, nband=2, n_max_sp=12)
N, N_TRAIN = 28, 20


def _cfg(lc_agg):
    seq = {"n_out": 8, "emb": 16, "heads": 2, "depth": 1, "time_norm": 1000.0,
           "dropout": 0.1}
    return CLIPConfig.create(
        combinations=("lightcurve", "spectral"), enc_dim=8, nband=2,
        logit_scale_init=19.55, loss="softmax",
        transformer_kwargs=dict(seq, agg=lc_agg),
        transformer_spectral_kwargs=dict(seq, agg="mean"))


def _model(seed=0, lc_agg="attn"):
    return CLIPModel(_cfg(lc_agg), generator=torch.Generator().manual_seed(seed))


def _data(seed=0):
    ds = make_synthetic_dataset(n=N, seed=seed, **SYN)
    return ds.subset(np.arange(N_TRAIN)), ds.subset(np.arange(N_TRAIN, N))


def _trainer(model, run_dir, epochs, **kw):
    return Trainer(model, "contrastive", TrainerConfig(
        epochs=epochs, batch_size=8, lr=3e-3, seed=0, noise_level_mag=1.0, **kw),
        run_dir=run_dir)


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """Three epochs of the small model into a run dir. Its light-curve tower
    aggregates by the mean: the JAX package's reference-checkpoint importer
    cannot read an attention aggregation under a tower's prefix
    (``_import_seq_encoder`` looks the query up under the prefix twice)."""
    path = str(tmp_path_factory.mktemp("port_run") / "run-0")
    train_ds, val_ds = _data()
    dump = {"lr": 3e-3, "weight_decay": 5.555e-05, "tiny": 1e-05, "agg": "mean",
            "foldnumber": 0, "combinations": ["lightcurve", "spectral"], "flag": True}
    result = _trainer(_model(lc_agg="mean"), path, 3).fit(train_ds, val_ds,
                                                          config_dump=dump)
    return path, dump, result


def test_run_dir_contract(run_dir):
    """config.yaml reads back with PyYAML (its floats as floats) and with the
    port's reader; the JAX package's sidecar readers take the manifests and
    rebuild the same CLIPConfig; the run's files are all there."""
    import yaml

    from multimodal_supernovae_tpu.models.factory import (
        read_model_config as jax_read_model_config,
    )
    from multimodal_supernovae_tpu.training.checkpoint import (
        load_run_sidecars as jax_load_run_sidecars,
    )

    path, dump, result = run_dir
    with open(os.path.join(path, "config.yaml")) as f:
        text = f.read()
    assert yaml.safe_load(text) == dump
    assert safe_load(text) == dump
    config, train_names, val_names = jax_load_run_sidecars(path)
    assert config == dump
    train_ds, val_ds = _data()
    assert train_names == train_ds.filenames and val_names == val_ds.filenames
    assert load_run_sidecars(path) == (dump, train_names, val_names)

    jax_model, jax_extra = jax_read_model_config(path)
    cfg, extra = read_model_config(path)
    assert extra == jax_extra
    for name in ("combinations", "enc_dim", "logit_scale_init", "nband", "loss",
                 "transformer_kwargs", "transformer_spectral_kwargs", "compute_dtype"):
        assert getattr(jax_model.cfg, name) == getattr(cfg, name), name

    files = sorted(os.listdir(path))
    ckpts = [f for f in files if f.endswith(".ckpt")]
    assert "last.ckpt" in ckpts and len(ckpts) == 3  # the best two and the last
    assert {"config.yaml", "train_filenames.txt", "val_filenames.txt",
            "model_config.json", "metrics.jsonl", "summary.json"} <= set(files)
    rows = _rows(path)
    assert [r["epoch"] for r in rows] == [0, 1, 2]
    assert all("time" in r and r["step"] == r["epoch"] for r in rows)
    with open(os.path.join(path, "summary.json")) as f:
        summary = json.load(f)
    val = [r["val_loss"] for r in rows]
    assert summary["best_val_loss"] == min(val) == summary["best_val_loss"]
    assert summary["best_epoch"] == int(np.argmin(val)) == result["best"]["epoch"]
    assert summary["best_ckpt_epoch"] == result["best_ckpt_epoch"] == summary["best_epoch"]
    assert summary["best_auc"] == max(r["AUC_val"] for r in rows)


def test_run_dir_rebuilds_from_its_own_files(run_dir):
    path, dump, _ = run_dir
    run_cfg, extra = load_run_config(path)
    assert run_cfg == dump and extra["combinations"] == ["lightcurve", "spectral"]
    model, run_cfg, extra = initialize_from_run_dir(path)
    assert model.cfg == read_model_config(path)[0] and run_cfg["enc_dim"] == 8
    model, _, extra = initialize_from_run_dir(path, combinations=["lightcurve"])
    assert model.cfg.combinations == ("lightcurve",) and extra["combinations"] == [
        "lightcurve"]
    # without the sidecar: the reference's layout, rebuilt from config.yaml and
    # the sweep's sweep_config.yaml; the run's checkpoint loads strictly into
    # it and serves what the sidecar rebuild serves
    import shutil

    sweep = os.path.join(os.path.dirname(os.path.dirname(path)), "schema_sweep")
    copy = os.path.join(sweep, "run-0")
    shutil.copytree(path, copy)
    os.remove(os.path.join(copy, "model_config.json"))
    arch = {"n_out": 8, "emb": 16, "heads": 2, "transformer_depth": 1, "time_norm": 1000.0,
            "dropout": 0.1, "logit_scale": 19.55, "enc_dim": 8}
    save_run_sidecars(copy, dict(dump, **arch))
    save_run_sidecars(sweep, {})
    os.replace(os.path.join(sweep, "config.yaml"), os.path.join(sweep, "sweep_config.yaml"))
    with open(os.path.join(sweep, "sweep_config.yaml"), "w") as f:
        json.dump({"extra_args": {"combinations": ["lightcurve", "spectral"]}}, f)
    with pytest.raises(FileNotFoundError):
        initialize_from_run_dir(os.path.dirname(path))  # no config.yaml there
    schema, run_cfg, extra = initialize_from_run_dir(copy)
    assert run_cfg == dict(dump, **arch) and extra["loss"] == "softmax"
    sidecar = read_model_config(path)[0]
    for name in ("combinations", "enc_dim", "logit_scale_init", "nband", "loss",
                 "transformer_kwargs", "transformer_spectral_kwargs"):
        assert getattr(schema.cfg, name) == getattr(sidecar, name), name
    got, _ = load_model(copy, "cpu")
    want, _ = load_model(path, "cpu")
    batch = _data()[1].to_device("cpu")
    with torch.no_grad():
        for a, b in zip(got.encode(batch), want.encode(batch)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_port_run_dir_loads_in_the_jax_package(run_dir):
    """The JAX package's load_model on a port-written run dir: its embeddings
    equal the port's within 2e-5 (a leaf that merge_params_nonstrict skipped
    would keep its fresh initialisation and show here)."""
    import jax.numpy as jnp

    from multimodal_supernovae_tpu.data.synthetic import (
        make_synthetic_dataset as jax_make_synthetic_dataset,
    )
    from multimodal_supernovae_tpu.models.factory import load_model as jax_load_model

    path, _, result = run_dir
    batch = jax_make_synthetic_dataset(n=N, seed=0, **SYN).to_device().take(
        jnp.arange(N_TRAIN, N))
    model, variables, _, extra, train_names, val_names = jax_load_model(
        path, batch, which="last")
    want = [np.asarray(e) for e in model.apply(variables, batch)]
    assert extra["combinations"] == ["lightcurve", "spectral"]
    assert len(train_names) == N_TRAIN and len(val_names) == N - N_TRAIN

    port, _ = load_model(path, "cpu", which="last")
    trained = result["state"].model
    feed = {k: torch.tensor(np.asarray(getattr(batch, k))) for k in
            ("x_lc", "t_lc", "mask_lc", "x_sp", "t_sp", "mask_sp")}
    with torch.no_grad():
        got = [e.numpy() for e in port.encode(feed)]
        live = [e.numpy() for e in trained.encode(feed)]
    for g, w, lv in zip(got, want, live):
        np.testing.assert_array_equal(g, lv)  # last.ckpt holds the final weights
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)


def _state(seed=0):
    model = _model(seed)
    opt, sched = build_optimizer(model.named_parameters(), lr=1e-3, step_size=1,
                                 gamma=0.5)
    return TrainState(model, opt, sched)


def _mark(state, epoch):
    with torch.no_grad():
        state.model.logit_bias.fill_(float(epoch))
    state.step = 10 * epoch


@pytest.mark.parametrize("mode,values,kept", [
    ("min", [3.0, 1.0, 2.0, 0.5, 4.0, 1.0], [3, 1]),
    ("max", [3.0, 1.0, 2.0, 0.5, 4.0, 3.0], [4, 0]),
])
def test_top_k_keeps_the_two_best_and_the_last(tmp_path, mode, values, kept):
    """A scripted val_loss sequence leaves exactly the two best epoch= files
    (ties keep the earlier epoch) and last.ckpt; restore('best') gives the
    best epoch's weights, restore('last') the last's; a manager made after a
    restart reads the set back; load_model's 'best' is the reference's
    smallest-epoch file."""
    run = str(tmp_path)
    mgr = CheckpointManager(run, "val_loss", mode, keep_best=2)
    state = _state()
    for epoch, value in enumerate(values):
        _mark(state, epoch)
        mgr.save(epoch, state, {"val_loss": value, "train_loss": float("nan")})
    files = sorted(f for f in os.listdir(run))
    assert files == sorted([f"epoch={e}-step={10 * e}.ckpt" for e in kept] + ["last.ckpt"])
    assert mgr.best_epoch() == kept[0]

    fresh = _state(seed=1)
    mgr.restore(fresh, which="best")
    assert fresh.model.logit_bias.item() == kept[0] and fresh.step == 10 * kept[0]
    mgr.restore(fresh, which="last")
    assert fresh.model.logit_bias.item() == len(values) - 1
    mgr.restore(fresh, epoch=kept[1])
    assert fresh.model.logit_bias.item() == kept[1]
    with pytest.raises(FileNotFoundError):
        mgr.restore(fresh, epoch=2 if 2 not in kept else 5)

    again = CheckpointManager(run, "val_loss", mode, keep_best=2)
    assert again.best_epoch() == kept[0]
    _mark(state, 9)
    again.save(9, state, {"val_loss": -100.0 if mode == "min" else 100.0})
    assert again.best_epoch() == 9
    assert sorted(os.listdir(run)) == sorted(
        [f"epoch={kept[0]}-step={10 * kept[0]}.ckpt", "epoch=9-step=90.ckpt", "last.ckpt"])

    # the reference's rule: the smallest epoch of the kept files
    with open(os.path.join(run, "model_config.json"), "w") as f:
        json.dump({"model": "CLIPModel", "config": {}}, f)
    assert pick_reference_ckpt(run, "best").endswith(
        f"epoch={min(9, kept[0])}-step={10 * min(9, kept[0])}.ckpt")
    assert pick_reference_ckpt(run, "last").endswith("last.ckpt")


def test_params_round_trip(tmp_path):
    path = str(tmp_path / "params.ckpt")
    model = _model(0)
    save_params(path, model)
    other = load_params(path, _model(5))
    for (n, a), (_, b) in zip(model.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), n


def test_in_process_resume_is_bitwise(tmp_path):
    """Four epochs straight equal two epochs and a resume to four: every
    parameter, every loss, the early-stopping state and the summary."""
    train_ds, val_ds = _data()
    straight_dir, resumed_dir = str(tmp_path / "a"), str(tmp_path / "b")
    straight = _trainer(_model(0), straight_dir, 4).fit(train_ds, val_ds)
    first = _trainer(_model(0), resumed_dir, 2).fit(train_ds, val_ds)
    assert first["epochs_run"] == 2
    resumed = _trainer(_model(7), resumed_dir, 4).fit(train_ds, val_ds, resume=True)

    assert resumed["epochs_run"] == 4 and resumed["state"].step == straight["state"].step
    for (name, a), (_, b) in zip(straight["state"].model.named_parameters(),
                                 resumed["state"].model.named_parameters()):
        assert torch.equal(a, b), name
    for key in ("train_loss", "val_loss"):
        assert resumed["history"][key] == straight["history"][key], key
    assert resumed["best"] == straight["best"]
    assert resumed["best_ckpt_epoch"] == straight["best_ckpt_epoch"]
    for a, b in zip(straight["state"].optimizer.state.values(),
                    resumed["state"].optimizer.state.values()):
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    epochs = [r["epoch"] for r in _rows(resumed_dir)]
    assert epochs == [0, 1, 2, 3]
    with open(os.path.join(straight_dir, "summary.json")) as f:
        want = json.load(f)
    with open(os.path.join(resumed_dir, "summary.json")) as f:
        assert json.load(f) == want
    assert sorted(os.listdir(straight_dir)) == sorted(os.listdir(resumed_dir))

    # a finished run resumed runs no epoch; resume needs a run dir
    done = _trainer(_model(3), resumed_dir, 4).fit(train_ds, val_ds, resume=True)
    assert done["epochs_run"] == 4 and len(_rows(resumed_dir)) == 4
    with pytest.raises(ValueError, match="run_dir"):
        _trainer(_model(3), None, 4).fit(train_ds, val_ds, resume=True)


def test_resume_of_a_stopped_run_stays_stopped(tmp_path):
    train_ds, val_ds = _data()
    run = str(tmp_path / "run")
    first = _trainer(_model(0), run, 30, patience=1).fit(train_ds, val_ds)
    assert first["epochs_run"] < 30
    again = _trainer(_model(0), run, 30, patience=1).fit(train_ds, val_ds, resume=True)
    assert again["epochs_run"] == first["epochs_run"]
    assert len(_rows(run)) == first["epochs_run"]


def _worker_cmd(run_dir, out, **kw):
    cmd = [sys.executable, os.path.abspath(__file__), "--run-dir", run_dir, "--out", out,
           "--epochs", "4"]
    for k, v in kw.items():
        cmd += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return cmd


def test_sigkill_resume_is_bitwise(tmp_path):
    """A worker killed by SIGKILL after epoch 2's metrics row and before that
    epoch's checkpoint lands, relaunched with --resume, ends with the
    parameters of the run that was never stopped; metrics.jsonl holds both
    epoch-2 rows."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    base_out, kill_out = str(tmp_path / "base.npz"), str(tmp_path / "killed.npz")
    subprocess.run(_worker_cmd(str(tmp_path / "base"), base_out), check=True,
                   timeout=120, env=env)
    kill_dir = str(tmp_path / "killed")
    proc = subprocess.run(_worker_cmd(kill_dir, kill_out, kill_at_epoch=2), timeout=120,
                          env=env)
    assert proc.returncode == -signal.SIGKILL
    assert not os.path.exists(kill_out)
    last = torch.load(os.path.join(kill_dir, "last.ckpt"), weights_only=True)
    assert last["epoch"] == 1  # epoch 2 was lost
    subprocess.run(_worker_cmd(kill_dir, kill_out, resume=True), check=True, timeout=120,
                   env=env)
    base, got = np.load(base_out), np.load(kill_out)
    assert sorted(base.files) == sorted(got.files)
    for k in base.files:
        np.testing.assert_array_equal(got[k], base[k], err_msg=k)
    assert [r["epoch"] for r in _rows(kill_dir)] == [0, 1, 2, 2, 3]


def test_non_finite_loss_aborts_with_a_row(tmp_path):
    train_ds, val_ds = _data()
    model = _model(0)
    with torch.no_grad():
        model.logit_scale.fill_(float("nan"))
    run = str(tmp_path / "run")
    with pytest.raises(FloatingPointError, match="non-finite"):
        _trainer(model, run, 3).fit(train_ds, val_ds)
    rows = _rows(run)
    assert len(rows) == 1 and rows[0]["aborted"] == "non-finite loss"
    assert rows[0]["epoch"] == 0 and not np.isfinite(rows[0]["train_loss"])
    assert not [f for f in os.listdir(run) if f.endswith(".ckpt")]


def test_config_yaml_refuses_non_finite_floats(tmp_path):
    with pytest.raises(ValueError, match="non-finite"):
        save_run_sidecars(str(tmp_path), {"lr": float("inf")})


def _worker(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--epochs", type=int, required=True)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--kill-at-epoch", type=int, default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if args.kill_at_epoch is not None:
        from multimodal_supernovae_tpu_torch.utils import logging as port_logging

        real_log = port_logging.MetricsLogger.log

        def log_then_die(self, metrics, step=None):
            real_log(self, metrics, step=step)
            if metrics.get("epoch") == args.kill_at_epoch:
                os.kill(os.getpid(), signal.SIGKILL)

        port_logging.MetricsLogger.log = log_then_die
    train_ds, val_ds = _data()
    result = _trainer(_model(0), args.run_dir, args.epochs).fit(
        train_ds, val_ds, resume=args.resume)
    np.savez(args.out, **{n: p.detach().numpy()
                          for n, p in result["state"].model.named_parameters()})


if __name__ == "__main__":
    _worker(sys.argv[1:])
