"""``python -m multimodal_supernovae_tpu_torch <command>`` and the training
CLIs' --mesh, --tp and --profile-dir on the CPU: the command table against
the JAX package's, the usage text and exit codes, ``train --mesh`` under
``torch.distributed.run --nproc-per-node 2`` (gloo, --device cpu) against
the one-process CLI run, --tp and the stacked members under --mesh, the
preflight's mesh checks string for string against the JAX preflight's, and
a --profile-dir run that trains exactly as one without it."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fixtures import write_mini_ztfbts
from multimodal_supernovae_tpu.cli import COMMANDS as JAX_COMMANDS
from multimodal_supernovae_tpu.config import load_sweep as jax_load_sweep
from multimodal_supernovae_tpu.training.preflight import preflight_sweep as jax_preflight_sweep
from multimodal_supernovae_tpu_torch import cli
from multimodal_supernovae_tpu_torch.cli import train
from multimodal_supernovae_tpu_torch.config import load_sweep
from multimodal_supernovae_tpu_torch.config.yaml_subset import dump as dump_yaml
from multimodal_supernovae_tpu_torch.training import preflight

REPO = Path(__file__).resolve().parent.parent
SMOKE = str(REPO / "configs/smoke.yaml")
CLUSTER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "MMSN_COORDINATOR", "MMSN_NUM_PROCESSES", "MMSN_PROCESS_ID")


@pytest.fixture(autouse=True)
def no_cluster(monkeypatch):
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)


def test_commands_cover_the_jax_commands():
    import importlib

    assert list(cli.COMMANDS) == list(JAX_COMMANDS)
    for name, (module, _) in cli.COMMANDS.items():
        if name in cli.REFUSALS:
            assert module is None
        else:
            assert callable(importlib.import_module(f"{cli.__name__}.{module}").main), name


def test_usage_and_exit_codes(capsys):
    assert cli.main([]) == 0 and cli.main(["--help"]) == 0 and cli.main(["help"]) == 0
    usage = capsys.readouterr().out
    assert usage.startswith("usage: python -m multimodal_supernovae_tpu_torch <command>")
    assert all(f"  {name}" in usage for name in JAX_COMMANDS)
    assert cli.main(["no-such-command"]) == 2
    assert "unknown command 'no-such-command'" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exit_:  # ported: export-model's own usage error
        cli.main(["export-model"])
    assert exit_.value.code == 2 and "export-model" not in cli.REFUSALS
    assert "the following arguments are required: run_dir, --out" in capsys.readouterr().err
    assert cli.main(["export-torch"]) == 2
    err = capsys.readouterr().err
    assert "torch checkpoints already" in err and "mmsn-export-torch" in err


def test_python_dash_m_dispatches(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "multimodal_supernovae_tpu_torch",
                           "fetch-data", str(tmp_path), "--verify-only", "--subset", "spectra"],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 1  # the dispatched command's own code: an empty tree
    assert "no spectra csvs" in proc.stderr and "verify FAILED (spectra)" in proc.stdout


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    data_dir, spectra_dir, _ = write_mini_ztfbts(str(root), n=40, seed=3)
    return ["--data-dir", data_dir, "--spectra-dir", spectra_dir, "--device", "cpu",
            "--epochs", "2"]


def _rows(analysis, name="smoke"):
    with open(os.path.join(analysis, name, "run-0", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_mesh_under_torchrun_equals_the_one_process_run(tree, tmp_path):
    one = str(tmp_path / "one")
    train.main([SMOKE, *tree, "--analysis-path", one, "--cache-dir", str(tmp_path / "c1")])
    two = str(tmp_path / "two")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
         "-m", "multimodal_supernovae_tpu_torch", "train", SMOKE, *tree, "--mesh",
         "--analysis-path", two, "--cache-dir", str(tmp_path / "c2")],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "mesh: {'data': 2, 'model': 1} over 2 process(es), gloo" in proc.stdout
    assert proc.stdout.count("run-0: best") == 1  # rank 0 prints the results
    files = set(os.listdir(os.path.join(two, "smoke", "run-0")))
    assert {"config.yaml", "train_filenames.txt", "val_filenames.txt", "model_config.json",
            "metrics.jsonl", "summary.json", "last.ckpt"} <= files
    got, want = _rows(two), _rows(one)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("train_loss", "val_loss", "AUC_val"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-5, atol=2e-5, err_msg=k)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("argv", [["--tp", "2"], ["--mesh", "--parallel-folds"],
                                  ["--mesh", "--parallel-members"]])
def test_unported_axes_raise_naming_item_15d(argv, tree, tmp_path):
    """The axes ROADMAP item 15d ported: ``--tp 2`` over one process raises
    the JAX package's indivisibility error (a 2-rank model axis needs 2
    processes: tests/test_torch_tp.py); ``--parallel-folds`` /
    ``--parallel-members`` under a one-process ``--mesh`` train the stacked
    group into its run dirs."""
    if "--tp" in argv:
        with pytest.raises(ValueError, match="1 global devices not divisible by model=2"):
            train.main([SMOKE, *argv, "--device", "cpu"])
        return
    analysis = str(tmp_path / "analysis")
    train.main([SMOKE, *tree, *argv, "--analysis-path", analysis,
                "--cache-dir", str(tmp_path / "cache")])
    sweep_dir = os.path.join(analysis, "smoke")
    assert {"run-0", "_ensemble-g0"} <= set(os.listdir(sweep_dir))
    assert len(_rows(analysis)) == 2


def _sweep_with(tmp_path, **params):
    raw = load_sweep(SMOKE).raw
    path = tmp_path / "mesh.yaml"
    path.write_text(dump_yaml(dict(raw, extra_args=dict(raw["extra_args"], nruns=4),
                                   parameters=dict(raw["parameters"], **{
                                       k: {"values": v} for k, v in params.items()}))))
    return str(path)


@pytest.mark.parametrize("argv,shape", [
    (["--mesh", "--check-devices", "8"], {"data": 8, "model": 1}),
    (["--tp", "3", "--check-devices", "6"], {"data": 2, "model": 3}),
    (["--mesh", "--tp", "2", "--check-devices", "8"], {"data": 4, "model": 2}),
])
def test_check_mesh_gives_the_jax_preflight_errors(tmp_path, capsys, argv, shape):
    """Batch 12 over a data axis of 8 (an error), emb 8 and 10 over a model
    axis of 3 (notes): the port's report carries the JAX preflight's
    strings."""
    path = _sweep_with(tmp_path, batchsize=[12, 16], emb=[8, 10])
    with pytest.raises(SystemExit) as code:
        train.main([path, "--check", *argv, "--device", "cpu"])
    out = capsys.readouterr().out
    sweep, jsweep = load_sweep(path), jax_load_sweep(path)
    kw = dict(nband=2, lc_len=32, sp_len=64)
    reports, errors = preflight.preflight_sweep(sweep, mesh_shape=shape, device="cpu", **kw)
    jreports, jerrors = jax_preflight_sweep(jsweep, mesh_shape=shape, **kw)
    assert errors == jerrors
    for r, j in zip(reports, jreports):
        assert [n for n in r["notes"] if n.startswith("tp=")] == \
            [n for n in j["notes"] if n.startswith("tp=")]
    assert code.value.code == (1 if errors else 0)
    for e in errors:
        assert f"ERROR: {e}" in out
    if shape["data"] == 8:
        assert errors == ["run-0: batch_size 12 not divisible by the data mesh axis (8)",
                          "run-2: batch_size 12 not divisible by the data mesh axis (8)"]
    if shape["model"] == 3:
        assert any("tp=3: lightcurve FF hidden 40 not divisible" in n
                   for r in reports for n in r["notes"])


def test_check_mesh_without_devices_says_so(capsys):
    with pytest.raises(SystemExit) as code:
        train.main([SMOKE, "--check", "--mesh", "--device", "cpu"])
    assert code.value.code == 0
    assert "--check: pass --check-devices N" in capsys.readouterr().out


def test_profile_dir_writes_a_trace_and_trains_as_without_it(tree, tmp_path):
    runs = {}
    for tag, extra in (("plain", []), ("profiled", ["--profile-dir", str(tmp_path / "prof")])):
        analysis = str(tmp_path / tag)
        train.main([SMOKE, *tree, "--analysis-path", analysis, "--cache-dir",
                    str(tmp_path / "cache"), *extra])
        runs[tag] = _rows(analysis)
    for g, w in zip(runs["profiled"], runs["plain"]):
        for k in ("train_loss", "val_loss", "AUC_val"):
            assert g[k] == w[k], k
    (trace,) = os.listdir(tmp_path / "prof")
    events = json.loads((tmp_path / "prof" / trace).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::addmm" for e in events)
