"""The port's streaming path against the JAX package's, on the CPU: the
sharded cache (``data/streaming.py``: every ``.npy`` file and the manifest
byte for byte, with shards split across chunk boundaries), ``ValHoldout``
and ``shard_epoch_schedule`` bitwise, ``stream_simulation_to_cache``
bitwise, ``Trainer.fit_sharded``'s loss history against the JAX
``fit_sharded`` (noise 0, dropout 0; trajectories 1e-4), a run cut after a
shard's cursor resumed bitwise equal to an uninterrupted run, the run
directory, and ``cli.pretrain_sim --streaming`` in the JAX CLI's cache
directory with ``--resume`` skipping a finished run."""

import json
import os
import sys
import warnings
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fixtures import write_mini_sim_hdf5
from multimodal_supernovae_tpu.cli import pretrain_sim as jax_pretrain_sim
from multimodal_supernovae_tpu.data import simulation as jax_sim
from multimodal_supernovae_tpu.data import streaming as jax_streaming
from multimodal_supernovae_tpu.models import CLIPConfig as JaxCLIPConfig
from multimodal_supernovae_tpu.models import CLIPModel as JaxCLIPModel
from multimodal_supernovae_tpu.training.trainer import Trainer as JaxTrainer
from multimodal_supernovae_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from multimodal_supernovae_tpu_torch.cli import pretrain_sim
from multimodal_supernovae_tpu_torch.data import simulation, streaming
from multimodal_supernovae_tpu_torch.models import (
    CLIPConfig,
    CLIPModel,
    load_model,
    state_dict_from_jax,
)
from multimodal_supernovae_tpu_torch.parallel.mesh import DataMesh
from multimodal_supernovae_tpu_torch.training import Trainer, TrainerConfig
from multimodal_supernovae_tpu_torch.training import checkpoint as ckpt_mod

REPO = Path(__file__).resolve().parent.parent
MAVEN_PRETRAIN = REPO / "configs" / "maven_pretrain.yaml"
KW = dict(bands=("r", "g"), n_max_obs=12, n_max_obs_spec=16,
          combinations=("lightcurve", "spectral"), noise=True, seed=0)
SEQ = {"n_out": 8, "emb": 8, "heads": 2, "depth": 1, "time_norm": 100.0, "agg": "mean",
       "dropout": 0.0}
CFG = dict(combinations=("lightcurve", "spectral"), enc_dim=8, nband=2, loss="softmax",
           transformer_kwargs=SEQ, transformer_spectral_kwargs=SEQ)


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def chunks_of(sizes, seed=0):
    """Chunks of every canonical dtype (float32 matrices, a bool mask, int32
    labels) with the given row counts."""
    rng = np.random.default_rng(seed)
    out, start = [], 0
    for n in sizes:
        out.append({"x_lc": rng.normal(size=(n, 6)).astype(np.float32),
                    "mask_lc": rng.random((n, 6)) < 0.7,
                    "redshift": np.arange(start, start + n, dtype=np.float32),
                    "label": rng.integers(0, 5, n).astype(np.int32)})
        start += n
    return out


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sim") / "sim.h5")
    return write_mini_sim_hdf5(path, n_per_type=12)


# -- the cache ------------------------------------------------------------------------


@pytest.mark.parametrize("sizes,rows", [((3, 4, 2), 5), ((10,), 3), ((1, 1, 1), 2),
                                        ((7, 7), 7), ((2, 9, 1, 5), 4)],
                         ids=["split", "one-chunk", "tiny-chunks", "exact", "ragged"])
def test_write_sharded_cache_is_jax_bytes(tmp_path, sizes, rows):
    """Every shard file and the manifest byte for byte the JAX writer's; a
    shard takes rows across chunk boundaries; the rows come back in order."""
    jax_streaming.write_sharded_cache(str(tmp_path / "jax"), iter(chunks_of(sizes)), rows)
    sds = streaming.write_sharded_cache(str(tmp_path / "port"), iter(chunks_of(sizes)), rows)
    assert tree_bytes(tmp_path / "port") == tree_bytes(tmp_path / "jax")
    n = sum(sizes)
    assert sds.shard_sizes == [rows] * (n // rows) + ([n % rows] if n % rows else [])
    np.testing.assert_array_equal(sds.materialize().arrays["redshift"],
                                  np.arange(n, dtype=np.float32))
    shard = sds.load_shard(0)
    assert isinstance(shard.arrays["x_lc"], np.memmap) and len(shard) == rows


def test_write_sharded_cache_refusals(tmp_path):
    with pytest.raises(ValueError, match="empty chunk iterator"):
        streaming.write_sharded_cache(str(tmp_path / "a"), iter([]), 4)
    bad = chunks_of((3, 3))
    del bad[1]["label"]
    with pytest.raises(ValueError, match="chunk fields"):
        streaming.write_sharded_cache(str(tmp_path / "b"), iter(bad), 4)


@pytest.mark.parametrize("frac,seed,cap", [(0.25, 3, 50000), (0.5, 0, 20), (0.1, 7, 3)])
def test_val_holdout_is_jax_bitwise(tmp_path, frac, seed, cap):
    """The same rows to validation and to the shards (the cap included), and
    the saved split reloads in either package."""
    def run(mod, where):
        holdout = mod.ValHoldout(frac, seed=seed, cap=cap)
        sds = mod.write_sharded_cache(str(tmp_path / where),
                                      holdout.wrap(iter(chunks_of((40, 60, 17)))), 16)
        val = holdout.dataset()
        mod.save_val_split(str(tmp_path / where), val)
        return sds, val

    (jsds, jval), (sds, val) = run(jax_streaming, "jax"), run(streaming, "port")
    assert tree_bytes(tmp_path / "port") == tree_bytes(tmp_path / "jax")
    for k in jval.arrays:
        np.testing.assert_array_equal(val.arrays[k], jval.arrays[k])
    assert len(val) <= cap
    back = streaming.load_val_split(str(tmp_path / "jax"))
    assert sorted(back.arrays) == sorted(val.arrays)
    for k in val.arrays:
        np.testing.assert_array_equal(back.arrays[k], val.arrays[k])
    assert streaming.load_val_split(str(tmp_path / "nowhere")) is None
    with pytest.raises(ValueError):
        streaming.ValHoldout(1.0)


@pytest.mark.parametrize("sizes,rows,batch", [((16,), 6, 4), ((40, 3), 16, 5),
                                              ((9,), 9, 4), ((30,), 7, 8)],
                         ids=["tail", "two-chunks", "one-shard", "batch-over-tail"])
def test_shard_epoch_schedule_is_jax_bitwise(tmp_path, sizes, rows, batch):
    """Three epochs' shard orders and plans from one generator each, equal to
    JAX's, the generators left in the same state; every plan has the full
    shard's step count and indexes its own shard."""
    jsds = jax_streaming.write_sharded_cache(str(tmp_path / "j"), iter(chunks_of(sizes)), rows)
    sds = streaming.ShardedDataset(str(tmp_path / "j"))
    rj, rp = np.random.default_rng(5), np.random.default_rng(5)
    steps = -(-rows // batch)
    for _ in range(3):
        want = jax_streaming.shard_epoch_schedule(jsds, batch, rj)
        got = streaming.shard_epoch_schedule(sds, batch, rp)
        assert [si for si, _ in got] == [si for si, _ in want]
        for (si, g), (_, w) in zip(got, want):
            assert g.dtype == w.dtype and g.shape == (steps, batch)
            np.testing.assert_array_equal(g, w)
            assert g.max() < sds.shard_sizes[si]
    assert rj.bit_generator.state == rp.bit_generator.state


def test_shard_feed_reads_a_shard_file_into_a_buffer(tmp_path):
    """The card's staging (training/shard_feed.py): each .npy file of a
    shard read straight into a slice of a larger buffer, bitwise np.load's;
    a file that does not fit the buffer raises."""
    from multimodal_supernovae_tpu_torch.training.shard_feed import _read_npy_into

    sds = streaming.write_sharded_cache(str(tmp_path / "c"), iter(chunks_of((7, 5))), 9)
    for k in sds.fields:
        full = np.load(sds.shard_file(0, k))
        buf = torch.from_numpy(np.zeros_like(full))
        out = _read_npy_into(sds.shard_file(1, k), buf[:sds.shard_sizes[1]])
        np.testing.assert_array_equal(out.numpy(), np.load(sds.shard_file(1, k)))
        assert out.data_ptr() == buf.data_ptr()
        with pytest.raises(ValueError, match="does not fit"):
            _read_npy_into(sds.shard_file(0, k), buf[:1])


def test_stream_simulation_to_cache_is_jax_bitwise(h5, tmp_path):
    """The sharded simulation cache byte for byte the JAX one's, and its rows
    the in-memory ingest's."""
    jax_sim.stream_simulation_to_cache(h5, str(tmp_path / "jax"), rows_per_shard=5, **KW)
    sds = simulation.stream_simulation_to_cache(h5, str(tmp_path / "port"),
                                                rows_per_shard=5, **KW)
    assert tree_bytes(tmp_path / "port") == tree_bytes(tmp_path / "jax")
    full = simulation.ingest_simulation(h5, **KW)
    assert sds.shard_sizes == [5, 5, 5, 5, 4] and len(sds) == len(full)
    merged = sds.materialize()
    for k, v in full.arrays.items():
        np.testing.assert_array_equal(merged.arrays[k], v)


# -- fit_sharded ----------------------------------------------------------------------


def _caches(h5, root, rows=6):
    sds = simulation.stream_simulation_to_cache(h5, str(root / "cache"), rows_per_shard=rows,
                                                **KW)
    val = simulation.ingest_simulation(h5, dataset_length=8, **KW)
    return sds, val


def _port_trainer(run_dir, epochs, sd=None, **tkw):
    model = CLIPModel(CLIPConfig.create(**CFG), generator=torch.Generator().manual_seed(0))
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    return Trainer(model, "contrastive", TrainerConfig(
        epochs=epochs, batch_size=4, lr=1e-3, seed=0, **tkw), run_dir=run_dir)


def test_fit_sharded_matches_jax_fit_sharded(h5, tmp_path):
    """Three epochs from the same weights (noise 0, dropout 0): the per-epoch
    train and validation losses within 1e-4 of the JAX fit_sharded's, and
    the final weights within 5e-4."""
    sds, val = _caches(h5, tmp_path)
    jsds = jax_streaming.ShardedDataset(sds.cache_dir)
    jval = jax_sim.ingest_simulation(h5, dataset_length=8, **KW)
    jtrainer = JaxTrainer(JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False, **CFG)),
                          task="contrastive",
                          cfg=JaxTrainerConfig(epochs=3, batch_size=4, lr=1e-3, seed=0),
                          run_dir=str(tmp_path / "jax"))
    jtrainer.set_dataset_size(len(jsds))
    jstate = jtrainer.init_state(jsds.load_shard(0).to_device().take(jnp.arange(4)))
    sd = {k: torch.tensor(v) for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params)).items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jtrainer.fit_sharded(jsds, jval, state=jstate)
    got = _port_trainer(str(tmp_path / "port"), 3, sd).fit_sharded(sds, val)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got["history"][key], want["history"][key],
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    final = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want["state"].params))
    for name, p in got["state"].model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name], rtol=5e-4, atol=5e-4,
                                   err_msg=name)
    assert got["shard_feed"]["prefetch"] is False and got["epochs_run"] == 3


def test_fit_sharded_run_dir(h5, tmp_path):
    """fit's files, with the shards' manifest names and the cursor; the run
    dir loads and its best checkpoint holds the monitored best."""
    sds, val = _caches(h5, tmp_path)
    run_dir = tmp_path / "run"
    res = _port_trainer(str(run_dir), 2).fit_sharded(sds, val)
    files = set(os.listdir(run_dir))
    assert {"config.yaml", "train_filenames.txt", "val_filenames.txt", "model_config.json",
            "metrics.jsonl", "summary.json", "last.ckpt", "ckpt_cursor"} <= files
    assert (run_dir / "train_filenames.txt").read_text().splitlines() == [
        "SHARD00000x6", "SHARD00001x6", "SHARD00002x6", "SHARD00003x6"]
    assert os.listdir(run_dir / "ckpt_cursor") == ["cursor.pt"]
    rows = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
    assert [r["epoch"] for r in rows] == [0, 1]
    summary = json.loads((run_dir / "summary.json").read_text())
    assert summary["best_epoch"] == res["best"]["epoch"]
    cursor = torch.load(run_dir / "ckpt_cursor" / "cursor.pt", weights_only=True)
    assert (cursor["epoch"], cursor["shard_pos"]) == (1, 3)
    assert cursor["losses"].shape == (4, 2) and torch.isfinite(cursor["losses"]).all()
    model, _ = load_model(str(run_dir), "cpu", which="last")
    for name, p in model.state_dict().items():
        torch.testing.assert_close(p, res["state"].model.state_dict()[name], rtol=0, atol=0)


class _Cut(Exception):
    pass


@pytest.mark.parametrize("noise", [0.0, 0.5], ids=["noise0", "noise"])
def test_fit_sharded_midepoch_resume_is_bitwise(h5, tmp_path, monkeypatch, noise):
    """A run cut just after epoch 1's third shard's cursor resumes at the
    fourth and ends bitwise equal to an uninterrupted run: every state_dict
    tensor, the optimizer's moments, the history and the metric rows."""
    sds, val = _caches(h5, tmp_path)
    base = _port_trainer(str(tmp_path / "base"), 3,
                         noise_level_mag=noise).fit_sharded(sds, val)
    real_save = ckpt_mod.StreamCursor.save

    def save_then_die(self, state, epoch, shard_pos, *a, **k):
        real_save(self, state, epoch, shard_pos, *a, **k)
        if (epoch, shard_pos) == (1, 2):
            raise _Cut()

    run_dir = str(tmp_path / "cut")
    monkeypatch.setattr(ckpt_mod.StreamCursor, "save", save_then_die)
    with pytest.raises(_Cut):
        _port_trainer(run_dir, 3, noise_level_mag=noise).fit_sharded(sds, val)
    monkeypatch.setattr(ckpt_mod.StreamCursor, "save", real_save)
    res = _port_trainer(run_dir, 3, noise_level_mag=noise).fit_sharded(sds, val, resume=True)
    assert res["epochs_run"] == 3
    assert res["history"] == base["history"]
    assert [{k: v for k, v in r.items() if k not in ("step_time_s", "samples_per_s")}
            for r in res["metric_rows"]] == [
        {k: v for k, v in r.items() if k not in ("step_time_s", "samples_per_s")}
        for r in base["metric_rows"]]
    want = base["state"].model.state_dict()
    for name, p in res["state"].model.state_dict().items():
        assert torch.equal(p, want[name]), name
    got_opt = res["state"].optimizer.state_dict()["state"]
    want_opt = base["state"].optimizer.state_dict()["state"]
    for i in want_opt:
        for k in want_opt[i]:
            assert torch.equal(got_opt[i][k], want_opt[i][k]), (i, k)


def test_fit_sharded_refusals(h5, tmp_path):
    sds, val = _caches(h5, tmp_path)
    with pytest.raises(ValueError, match="run_dir"):
        _port_trainer(None, 1).fit_sharded(sds, val, resume=True)
    trainer = _port_trainer(None, 1)
    trainer.mesh = DataMesh(0, 3)  # streaming over ranks: the ranks must divide B
    with pytest.raises(ValueError, match=r"global batch 4 is not divisible by the data "
                                         r"mesh axis \(3\)"):
        trainer.fit_sharded(sds, val)


# -- cli.pretrain_sim --streaming -------------------------------------------------------


@pytest.fixture(scope="module")
def stream_runs(tmp_path_factory):
    """A narrow copy of configs/maven_pretrain.yaml streamed from the mini
    corpus by the port's CLI (the CPU) and by the JAX CLI, one epoch, 7 rows
    a shard, each with its own cache directory."""
    root = tmp_path_factory.mktemp("pretrain_sim_stream")
    raw = yaml.safe_load(MAVEN_PRETRAIN.read_text())
    small = {"transformer_depth": 1, "transformer_depth_spectral": 1, "emb": 16,
             "heads": 2, "emb_spectral": 16, "heads_spectral": 2, "batchsize": 4}
    raw["parameters"].update({k: {"values": [v]} for k, v in small.items()})
    raw["extra_args"].update(max_spectral_data_len=20, max_lightcurve_data_len=12,
                             val_fraction=0.2)
    config = root / "maven_pretrain.yaml"
    config.write_text(yaml.safe_dump(raw))
    data_dir = root / "sim"
    data_dir.mkdir()
    write_mini_sim_hdf5(str(data_dir / raw["extra_args"]["filename_trainset"]), n_per_type=12)
    common = [str(config), "--data-dir", str(data_dir), "--epochs", "1", "--streaming",
              "--rows-per-shard", "7"]
    pretrain_sim.main([*common, "--cache-dir", str(root / "cache-port"), "--analysis-path",
                       str(root / "port"), "--device", "cpu"])
    with warnings.catch_warnings(), mock.patch.dict(os.environ, {"MMSN_COMPILE_CACHE": "0"}), \
            mock.patch.object(sys, "argv", ["pretrain_sim.py", *common, "--cache-dir",
                                            str(root / "cache-jax"), "--analysis-path",
                                            str(root / "jax"), "--platform", "cpu"]):
        warnings.simplefilter("ignore")
        jax_pretrain_sim.main()
    return root, common


def test_pretrain_sim_streaming_uses_the_jax_cache_dir(stream_runs):
    """The same stream-<key> directory as the JAX CLI's, its files byte for
    byte; the run's files and the shards' manifest names."""
    root, _ = stream_runs
    names = os.listdir(root / "cache-port")
    assert names == os.listdir(root / "cache-jax") and len(names) == 1
    assert names[0].startswith("stream-")
    assert tree_bytes(root / "cache-port") == tree_bytes(root / "cache-jax")
    run = root / "port" / "maven_pretrain" / "run-0"
    assert {"config.yaml", "model_config.json", "metrics.jsonl", "summary.json", "last.ckpt",
            "ckpt_cursor"} <= set(os.listdir(run))
    sds = streaming.ShardedDataset(str(root / "cache-port" / names[0]))
    assert (run / "train_filenames.txt").read_text().splitlines() == [
        f"SHARD{i:05d}x{n}" for i, n in enumerate(sds.shard_sizes)]
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [r["epoch"] for r in rows] == [0] and np.isfinite(rows[0]["val_loss"])


def test_pretrain_sim_streaming_resume_skips_the_finished_run(stream_runs, capsys):
    root, common = stream_runs
    run_dir = root / "port" / "maven_pretrain" / "run-0"
    before = {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in run_dir.rglob("*")
              if p.is_file()}
    capsys.readouterr()
    pretrain_sim.main([*common, "--cache-dir", str(root / "cache-jax"), "--analysis-path",
                       str(root / "port"), "--device", "cpu", "--resume"])
    out = capsys.readouterr().out
    after = {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in run_dir.rglob("*")
             if p.is_file()}
    assert before == after
    assert "sharded cache hit" in out and "epochs=0" in out
