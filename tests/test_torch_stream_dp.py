"""Streaming over ranks in the port (``Trainer.fit_sharded`` under a mesh) on
the CPU: a 2-rank gloo ``fit_sharded`` over a sharded cache against the
one-process ``fit_sharded`` at the global batch, with every draw on
(magnitude noise 1.0, dropout); a run cut at an epoch boundary and resumed
under the mesh against the uninterrupted run; only rank 0 writes, and no
shard cursor is kept across processes (the JAX package's rule); and
``pretrain-sim --streaming --mesh`` under ``torch.distributed.run`` against
the one-process CLI run; and the 2-rank ``fit_sharded`` against the JAX
package's ``Trainer(mesh=make_mesh(2, 1)).fit_sharded`` on the same cache
and weights (noise 0, dropout 0: the two frameworks draw different numbers).

One spawn of tests/torch_dp_worker.py (no jax) runs every scenario on 2
ranks; the references are fitted here. Tolerances: the data-parallel fit's
(losses rtol = atol = 2e-5, every state_dict entry 5e-5); against the JAX
package the CPU trajectory tolerance, 1e-4 on the losses and the final
weights."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_dp_worker as W
from fixtures import write_mini_sim_hdf5
from multimodal_supernovae_tpu.data import streaming as jax_streaming
from multimodal_supernovae_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic_dataset,
)
from multimodal_supernovae_tpu.models import CLIPConfig as JaxCLIPConfig
from multimodal_supernovae_tpu.models import CLIPModel as JaxCLIPModel
from multimodal_supernovae_tpu.parallel import make_mesh as jax_make_mesh
from multimodal_supernovae_tpu.training.trainer import Trainer as JaxTrainer
from multimodal_supernovae_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from multimodal_supernovae_tpu_torch.cli import pretrain_sim
from multimodal_supernovae_tpu_torch.models import state_dict_from_jax
from multimodal_supernovae_tpu_torch.training import Trainer
from test_torch_cli_umbrella import _free_port
from test_torch_dp import JAX_KW, RANKS, _same_fit

REPO = Path(__file__).resolve().parent.parent
MAVEN_PRETRAIN = REPO / "configs" / "maven_pretrain.yaml"


def _jax_stream_setup(out):
    """The JAX mesh trainer over ``<out>/stream-cache`` (read by the JAX
    package's ``ShardedDataset``), its validation set and initial state."""
    ds = jax_make_synthetic_dataset(n=W.N, seed=0, modalities=("lightcurve", "spectral"),
                                    image_size=12, **W.SYN)
    sds = jax_streaming.ShardedDataset(os.path.join(out, "stream-cache"))
    model = JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False, **W.clip_kwargs(dropout=0.0)))
    trainer = JaxTrainer(model, "contrastive", JaxTrainerConfig(**JAX_KW),
                         mesh=jax_make_mesh(RANKS, 1))
    trainer.set_dataset_size(len(sds))
    state = trainer.init_state(sds.load_shard(0).to_device().take(jnp.arange(8)))
    return trainer, state, sds, ds.subset(np.arange(W.N_TRAIN, W.N))


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("stream_dp"))
    W.write_stream_cache(out)
    trainer, state, sds, val = _jax_stream_setup(out)
    init = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in init.items()},
               os.path.join(out, "jaxmatch.init.pt"))
    W.spawn(out, W.STREAM_SCENARIOS, world=RANKS)
    return out, trainer.fit_sharded(sds, val, state=state)


def test_two_rank_fit_sharded_equals_the_one_process_fit_sharded(stream):
    stream, _ = stream
    ref = W.fit_stream(stream)
    assert len(ref["rows"]) == 2
    for r in range(RANKS):
        _same_fit(W.load(stream, "stream", r), ref)


def test_two_rank_stream_resume_equals_the_uninterrupted_run(stream):
    """B, 2 epochs and then resumed to 3 under the mesh from last.ckpt,
    equals A's 3 epochs on every rank, bitwise; rank 0 alone writes, and
    neither run keeps a shard cursor."""
    stream, _ = stream
    for r in range(RANKS):
        got = W.load(stream, "stream-resume", r)
        full, resumed = got["full"], got["resumed"]
        assert full["history"] == resumed["history"]
        assert len(full["history"]["train_loss"]) == 3
        for k, v in full["state_dict"].items():
            assert torch.equal(resumed["state_dict"][k], v), k
    w0, w1 = (W.load(stream, "stream-resume", r)["writes"] for r in range(RANKS))
    assert w1 == {"ckpt": 0, "sidecars": 0, "logger": 0}
    assert w0["sidecars"] == w0["logger"] == 3 and w0["ckpt"] > 0
    for run in ("stream-A", "stream-B"):
        files = set(os.listdir(os.path.join(stream, run)))
        assert {"config.yaml", "train_filenames.txt", "model_config.json", "metrics.jsonl",
                "summary.json", "last.ckpt"} <= files
        assert "ckpt_cursor" not in files
    with open(os.path.join(stream, "stream-B", "metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1, 2]
    with open(os.path.join(stream, "stream-B", "train_filenames.txt")) as f:
        assert f.read().splitlines() == ["SHARD00000x10", "SHARD00001x10", "SHARD00002x8"]


def test_fit_sharded_under_a_mesh_needs_ranks_that_divide_the_batch(stream):
    from multimodal_supernovae_tpu_torch.data.streaming import ShardedDataset
    from multimodal_supernovae_tpu_torch.parallel import DataMesh

    model, task, tcfg, _, val = W.build("bimodal")
    sds = ShardedDataset(os.path.join(stream[0], "stream-cache"))
    with pytest.raises(ValueError, match=r"global batch 8 is not divisible by the data mesh "
                                         r"axis \(3\)"):
        Trainer(model, task, tcfg, mesh=DataMesh(0, 3)).fit_sharded(sds, val)


def test_two_rank_fit_sharded_matches_the_jax_mesh_fit_sharded(stream):
    """Two epochs over the 3 shards from the JAX package's initial weights:
    each rank's per-epoch losses and AUC, and its final weights, within 1e-4
    of ``Trainer(mesh=make_mesh(2, 1)).fit_sharded``'s (the mesh's shard
    plan, sliced validation plan and epoch loop, held against the
    reference)."""
    out, want = stream
    final = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want["state"].params))
    for r in range(RANKS):
        got = W.load(out, "stream-jaxmatch", r)
        assert len(got["rows"]) == len(want["metric_rows"]) == 2
        for g, w in zip(got["rows"], want["metric_rows"]):
            for k in ("train_loss", "val_loss", "AUC_val"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4, err_msg=k)
        assert sorted(got["state_dict"]) == sorted(final)
        for k, v in got["state_dict"].items():
            np.testing.assert_allclose(v.numpy(), final[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_pretrain_sim_streaming_mesh_under_torchrun_equals_the_one_process_run(tmp_path):
    """``pretrain-sim --streaming --mesh`` on 2 gloo ranks under torchrun: one
    cache (rank 0 writes it), one run dir, the one-process CLI's metrics."""
    raw = yaml.safe_load(MAVEN_PRETRAIN.read_text())
    small = {"transformer_depth": 1, "transformer_depth_spectral": 1, "emb": 16,
             "heads": 2, "emb_spectral": 16, "heads_spectral": 2, "batchsize": 4}
    raw["parameters"].update({k: {"values": [v]} for k, v in small.items()})
    raw["extra_args"].update(max_spectral_data_len=20, max_lightcurve_data_len=12,
                             val_fraction=0.2)
    config = tmp_path / "maven_pretrain.yaml"
    config.write_text(yaml.safe_dump(raw))
    data_dir = tmp_path / "sim"
    data_dir.mkdir()
    write_mini_sim_hdf5(str(data_dir / raw["extra_args"]["filename_trainset"]), n_per_type=12)
    common = [str(config), "--data-dir", str(data_dir), "--epochs", "2", "--streaming",
              "--rows-per-shard", "7", "--device", "cpu"]
    pretrain_sim.main([*common, "--cache-dir", str(tmp_path / "c1"), "--analysis-path",
                       str(tmp_path / "one")])
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
         "-m", "multimodal_supernovae_tpu_torch", "pretrain-sim", *common, "--mesh",
         "--cache-dir", str(tmp_path / "c2"), "--analysis-path", str(tmp_path / "two")],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "mesh: {'data': 2, 'model': 1} over 2 process(es), gloo" in proc.stdout
    assert proc.stdout.count("sharded cache written") == 1
    assert proc.stdout.count("sharded cache hit") == 1
    assert os.listdir(tmp_path / "c2") == os.listdir(tmp_path / "c1")
    run = tmp_path / "two" / "maven_pretrain" / "run-0"
    files = set(os.listdir(run))
    assert {"config.yaml", "model_config.json", "metrics.jsonl", "summary.json",
            "last.ckpt"} <= files and "ckpt_cursor" not in files

    def rows(root):
        with open(root / "maven_pretrain" / "run-0" / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    got, want = rows(tmp_path / "two"), rows(tmp_path / "one")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("train_loss", "val_loss", "AUC_val"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-5, atol=2e-5, err_msg=k)
