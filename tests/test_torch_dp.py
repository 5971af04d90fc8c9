"""Data-parallel training in the port (``Trainer(mesh=...)``) on the CPU: a
2-rank gloo fit against the one-process fit at the global batch, with every
draw on (magnitude noise 1.0, dropout, image noise and turns): the
contrastive (CLIP and SigLIP), trimodal (the global BatchNorm statistics
and running buffers), regression, classification and masked tasks, the
fused opt-ins; resume and run-dir writes; the exit skew; and the 2-rank
fit against the JAX package's ``Trainer(mesh=make_mesh(2, 1))`` (noise 0,
dropout 0: the two frameworks draw different numbers).

One spawn of tests/torch_dp_worker.py (no jax) runs every scenario on 2
ranks; the references are fitted here. Tolerances: JAX
tests/test_dp_equivalence.py's (losses rtol = atol = 2e-5, every
state_dict entry 5e-5); against the JAX package the CPU trajectory
tolerance, relative 1e-4."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as W
from multimodal_supernovae_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic_dataset,
)
from multimodal_supernovae_tpu.models import CLIPConfig as JaxCLIPConfig
from multimodal_supernovae_tpu.models import CLIPModel as JaxCLIPModel
from multimodal_supernovae_tpu.parallel import make_mesh as jax_make_mesh
from multimodal_supernovae_tpu.training.trainer import Trainer as JaxTrainer
from multimodal_supernovae_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from multimodal_supernovae_tpu_torch.models import state_dict_from_jax
from multimodal_supernovae_tpu_torch.parallel import DataMesh
from multimodal_supernovae_tpu_torch.training import Trainer, TrainerConfig

RANKS = 2
LOSS_TOL, PARAM_TOL = 2e-5, 5e-5
FITS = ("bimodal", "sigmoid", "trimodal", "regression", "classification", "masked", "fused")
JAX_KW = dict(epochs=2, batch_size=8, lr=1e-3, noise_level_mag=0.0, seed=0)


def _jax_setup():
    """The JAX mesh trainer over the scenario's synthetic set and its
    initial state (the port's weights come from it)."""
    kw = dict(n=W.N, seed=0, modalities=("lightcurve", "spectral"), image_size=12, **W.SYN)
    ds = jax_make_synthetic_dataset(**kw)
    train, val = ds.subset(np.arange(W.N_TRAIN)), ds.subset(np.arange(W.N_TRAIN, W.N))
    model = JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False, **W.clip_kwargs(dropout=0.0)))
    trainer = JaxTrainer(model, "contrastive", JaxTrainerConfig(**JAX_KW),
                         mesh=jax_make_mesh(RANKS, 1))
    state = trainer.init_state(train.to_device().take(jnp.arange(8)))
    return trainer, state, train, val


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp"))
    trainer, state, train, val = _jax_setup()
    init = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in init.items()},
               os.path.join(out, "jaxmatch.init.pt"))
    W.spawn(out, W.SCENARIOS, world=RANKS)
    return out, trainer.fit(train, val, state=state)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=tol, atol=tol,
                               err_msg=what)


def _same_fit(got, ref):
    for k in ("train_loss", "val_loss"):
        _close(got["history"][k], ref["history"][k], LOSS_TOL, k)
    for g, w in zip(got["rows"], ref["rows"]):
        for k in set(w) - {"step_time_s", "samples_per_s"}:
            _close(g[k], w[k], LOSS_TOL, k)
    assert sorted(got["state_dict"]) == sorted(ref["state_dict"])
    for k, v in ref["state_dict"].items():
        _close(got["state_dict"][k].numpy(), v.numpy(), PARAM_TOL, k)
    assert got["grad_none"] == ref["grad_none"]


@pytest.mark.parametrize("name", FITS)
def test_two_rank_fit_equals_the_one_process_fit(dp, name):
    """Losses, task metrics and every state_dict entry (BatchNorm running
    statistics and counts included) of each rank against one process at
    the global batch, from the same weights and seed."""
    out, _ = dp
    ref = W.fit(name)
    for r in range(RANKS):
        _same_fit(W.load(out, name, r), ref)
    if name == "trimodal":
        running = [k for k in ref["state_dict"] if "running" in k]
        assert len(running) == 2 * 5  # 5 BatchNorms in the small ConvMixer
        model = W.build(name)[0]
        for k in running:  # the running statistics moved off their start
            assert not torch.equal(ref["state_dict"][k], model.state_dict()[k]), k


@pytest.mark.parametrize("name", ["regression", "classification"])
def test_supervised_head_leaves_the_unused_logit_scale_untouched(dp, name):
    """The loss never reaches the CLIP logit scale and bias of a supervised
    head: no gradient on any rank (the gradient all-reduce keeps None), so
    RAdam leaves them at their initial values, as on one process."""
    out, _ = dp
    start = W.build(name)[0].state_dict()
    for r in range(RANKS):
        got = W.load(out, name, r)
        assert got["grad_none"] == ["logit_bias", "logit_scale"]
        for k in ("logit_scale", "logit_bias"):
            assert torch.equal(got["state_dict"][k], start[k]), k


def test_two_rank_resume_equals_the_uninterrupted_run_and_only_rank_0_writes(dp):
    out, _ = dp
    full, resumed = (W.load(out, "resume", 0)[k] for k in ("full", "resumed"))
    assert full["history"] == resumed["history"]
    for k, v in full["state_dict"].items():
        assert torch.equal(resumed["state_dict"][k], v), k
    w0, w1 = W.load(out, "resume", 0)["writes"], W.load(out, "resume", 1)["writes"]
    assert w1 == {"ckpt": 0, "sidecars": 0, "logger": 0}
    assert w0["sidecars"] == w0["logger"] == 3 and w0["ckpt"] > 0
    files = set(os.listdir(os.path.join(out, "resume-B")))
    assert {"config.yaml", "train_filenames.txt", "val_filenames.txt", "model_config.json",
            "metrics.jsonl", "summary.json", "last.ckpt"} <= files
    with open(os.path.join(out, "resume-B", "metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1, 2]


def test_exit_skew_without_a_deadlock(dp):
    """Rank 0 stalls 3 s in its last write; the barrier at the end of fit
    holds rank 1 until then, and both ranks exit 0 (the fixture)."""
    out, _ = dp
    r0, r1 = W.load(out, "skew", 0), W.load(out, "skew", 1)
    assert r0["history"] == r1["history"]
    assert r1["summary_at_return"] and r1["fit_s"] >= 3.0


def test_two_rank_fit_matches_the_jax_mesh_fit(dp):
    out, want = dp
    for r in range(RANKS):
        got = W.load(out, "jaxmatch", r)
        for g, w in zip(got["rows"], want["metric_rows"]):
            for k in ("train_loss", "val_loss", "AUC_val"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4 * (k == "AUC_val"),
                                           err_msg=k)
        assert len(got["rows"]) == len(want["metric_rows"]) == 2


def test_the_ranks_must_divide_the_batch():
    model, task, tcfg, train, val = W.build("bimodal")
    with pytest.raises(ValueError, match=r"global batch 8 is not divisible by the data mesh "
                                         r"axis \(3\)"):
        Trainer(model, task, tcfg, mesh=DataMesh(0, 3)).fit(train, val)
    # a model axis whose ranks do not divide the processes: the JAX package's words
    from multimodal_supernovae_tpu_torch.parallel import make_global_mesh

    with pytest.raises(ValueError, match="1 global devices not divisible by model=2"):
        Trainer(model, task, TrainerConfig(), mesh=make_global_mesh(n_model=2))
