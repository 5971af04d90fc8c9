"""The image and meta towers and the supervised heads through the port's
trainer, run directories, loading, embeddings and serving, on CPU, at a
small size, against the JAX package:

  * a 2-epoch ``Trainer.fit`` of each task (trimodal contrastive, redshift
    regression, 5-class classification) from the same weights on the same
    data against the JAX ``Trainer.fit`` (noise off, rotation off, dropout
    0, so that neither stack draws): per-epoch losses within relative 1e-4,
    the task metrics within 1e-4 (absolute and relative) and the BatchNorm running statistics
    within 5e-4;
  * ``fit(resume=True)`` of a trimodal run (noise, rotation and dropout on)
    bitwise equal to the uninterrupted run;
  * a port-written trimodal run directory opened by the JAX package's
    ``load_model`` (embeddings within 2e-5, BatchNorm statistics equal), and
    a JAX-exported quadrimodal run loaded strictly by the port;
  * ``predict_supervised`` and ``get_embeddings`` against the JAX
    package's, and ``load_live`` serving ``x_img`` and the meta fields.

The sequence towers take the JAX package's positional encoding on both
stacks where the trajectories are compared (tests/test_torch_towers.py says
why).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic_dataset,
)
from multimodal_supernovae_tpu.evaluation.embeddings import (
    get_embeddings as jax_get_embeddings,
)
from multimodal_supernovae_tpu.evaluation.embeddings import (
    predict_supervised as jax_predict_supervised,
)
from multimodal_supernovae_tpu.models.factory import load_model as jax_load_model
from multimodal_supernovae_tpu.models.factory import (
    write_model_config as jax_write_model_config,
)
from multimodal_supernovae_tpu.models.torch_export import export_reference_state_dict
from multimodal_supernovae_tpu.training.optim import build_optimizer as jax_build_optimizer
from multimodal_supernovae_tpu.training.state import TrainState as JaxTrainState
from multimodal_supernovae_tpu.training.trainer import Trainer as JaxTrainer
from multimodal_supernovae_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from multimodal_supernovae_tpu_torch.data import make_synthetic_dataset
from multimodal_supernovae_tpu_torch.evaluation import get_embeddings, predict_supervised
from multimodal_supernovae_tpu_torch.models import (
    CLIPConfig,
    CLIPModel,
    initialize_from_run_dir,
    load_model,
)
from multimodal_supernovae_tpu_torch.serving import input_spec, load_live
from multimodal_supernovae_tpu_torch.training import Trainer, TrainerConfig
from tests.test_torch_towers import (  # noqa: F401  (a fixture)
    QUAD,
    SYN,
    TRI,
    cfg_kwargs,
    jax_setup,
    port_model,
    same_positional_encoding,
)

N, N_TRAIN = 34, 24
TASKS = {
    "contrastive": dict(combinations=TRI),
    "regression": dict(combinations=("lightcurve",), regression=True),
    "classification": dict(combinations=TRI, classification=True, n_classes=5),
}


def _datasets(seed=0):
    kw = dict(n=N, seed=seed, modalities=TRI, **SYN)
    port, jax_ds = make_synthetic_dataset(**kw), jax_make_synthetic_dataset(**kw)
    split = (np.arange(N_TRAIN), np.arange(N_TRAIN, N))
    return [port.subset(i) for i in split], [jax_ds.subset(i) for i in split]


def _trainer_kwargs(**kw):
    return dict(dict(epochs=2, batch_size=8, lr=1e-3, noise_level_img=0.0,
                     noise_level_mag=0.0, rotate_images=False, seed=0), **kw)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_fit_two_epochs_matches_jax_trainer(task, same_positional_encoding):
    (train, val), (jtrain, jval) = _datasets()
    jmodel, variables, _ = jax_setup(n=8, **TASKS[task])
    model = port_model(variables, **TASKS[task])  # before the JAX fit donates them
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                  tx=jax_build_optimizer(lr=1e-3),
                                  batch_stats=variables.get("batch_stats"))
    want = JaxTrainer(jmodel, task, JaxTrainerConfig(**_trainer_kwargs())).fit(
        jtrain, jval, state=jstate)
    got = Trainer(model, task, TrainerConfig(**_trainer_kwargs())).fit(train, val)
    metric = {"contrastive": ["AUC_val1", "AUC_val2", "AUC_val3", "AUC_val_mean"],
              "regression": ["R2_val"], "classification": ["f1_val"]}[task]
    for g, w in zip(got["metric_rows"], want["metric_rows"]):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=0, err_msg=k)
        for k in metric:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4, err_msg=k)
    assert len(got["metric_rows"]) == len(want["metric_rows"]) == 2
    assert got["best"]["epoch"] == want["best"]["epoch"]
    if task != "regression":  # the light-curve-only model has no BatchNorm
        from multimodal_supernovae_tpu_torch.models import state_dict_from_jax

        ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want["state"].params),
                                  jax.tree_util.tree_map(np.asarray,
                                                         want["state"].batch_stats))
        sd = got["state"].model.state_dict()
        for k in (k for k in sd if "running" in k):
            np.testing.assert_allclose(sd[k].numpy(), ref[k], rtol=5e-4, atol=5e-4,
                                       err_msg=k)


def _trimodal_fit(run_dir, epochs, resume=False, seed=0):
    """A trimodal run with every draw on: image and magnitude noise,
    rotation (train and eval), dropout in every tower."""
    seq = dict(cfg_kwargs()["transformer_kwargs"], dropout=0.1)
    cfg = CLIPConfig.create(**cfg_kwargs(
        transformer_kwargs=seq, transformer_spectral_kwargs=seq,
        conv_kwargs=dict(cfg_kwargs()["conv_kwargs"], dropout_prob=0.1)))
    model = CLIPModel(cfg, generator=torch.Generator().manual_seed(seed))
    (train, val), _ = _datasets()
    tcfg = TrainerConfig(**_trainer_kwargs(epochs=epochs, noise_level_img=1.0,
                                           noise_level_mag=1.0, rotate_images=True))
    return Trainer(model, "contrastive", tcfg, run_dir=run_dir).fit(train, val,
                                                                    resume=resume)


def test_trimodal_resume_is_bitwise(tmp_path):
    """3 epochs straight against 2, then a new model and Trainer resumed to 3:
    every tensor of the state_dict (BatchNorm buffers included) and every
    metric row equal, and the run's last.ckpt carries the buffers."""
    straight = _trimodal_fit(str(tmp_path / "A"), 3)
    _trimodal_fit(str(tmp_path / "B"), 2)
    resumed = _trimodal_fit(str(tmp_path / "B"), 3, resume=True, seed=1)
    a, b = straight["state"].model.state_dict(), resumed["state"].model.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    def timeless(rows):
        return [{k: v for k, v in r.items() if k not in ("step_time_s", "samples_per_s")}
                for r in rows]

    assert timeless(resumed["metric_rows"]) == timeless(straight["metric_rows"])
    assert {"AUC_val1", "AUC_val2", "AUC_val3", "AUC_val_mean"} <= set(
        straight["metric_rows"][-1])
    ckpt = torch.load(tmp_path / "B" / "last.ckpt", weights_only=True)
    bn = {k: v for k, v in ckpt["state_dict"].items() if "image_encoder" in k
          and ("running" in k or "num_batches" in k)}
    assert len(bn) == 3 * (1 + 2 * 2)
    assert all(int(v) == 3 * 3 for k, v in bn.items() if "num_batches" in k)
    assert "eval_torch_rng" in ckpt["loop"]


def test_port_trimodal_run_dir_opens_in_jax_load_model(tmp_path):
    run_dir = str(tmp_path / "run")
    result = _trimodal_fit(run_dir, 2)
    model = result["state"].model.eval()
    _, (_, jval) = _datasets()
    jmodel, variables, *_ = jax_load_model(run_dir, jval.to_device().take(jnp.arange(8)),
                                           which="last")
    want = jmodel.apply(variables, jval.to_device(), method=jmodel.encode)
    with torch.no_grad():
        got = model.encode(_datasets()[0][1].to_device("cpu"))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)
    from multimodal_supernovae_tpu_torch.models import state_dict_from_jax

    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables["params"]),
                              jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
            assert not np.allclose(v.numpy(), 0.0 if "mean" in k else 1.0), k


def _jax_exported_run(tmp_path, **kw):
    """A JAX model's weights exported to a reference-layout .ckpt beside its
    model_config.json: what mmsn-export-torch plus the sidecar give."""
    jmodel, variables, jdata = jax_setup(n=12, **kw)
    run_dir = tmp_path / "exported"
    run_dir.mkdir()
    sd = export_reference_state_dict(variables["params"], variables.get("batch_stats"))
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
               run_dir / "epoch=0-step=0.ckpt")
    jax_write_model_config(str(run_dir), jmodel)
    return jmodel, variables, jdata, str(run_dir)


def test_jax_exported_quadrimodal_run_loads_strictly_in_the_port(tmp_path):
    jmodel, variables, jdata, run_dir = _jax_exported_run(tmp_path, combinations=QUAD)
    model, extra = load_model(run_dir, device="cpu")  # strict
    assert extra["combinations"] == list(QUAD)
    fresh, _, _ = initialize_from_run_dir(run_dir)
    assert sorted(fresh.state_dict()) == sorted(model.state_dict())
    want = jmodel.apply(variables, jdata, method=jmodel.encode)
    batch = make_synthetic_dataset(n=12, seed=0, modalities=TRI, **SYN).to_device("cpu")
    with torch.no_grad():
        got = model.encode(batch)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    embs, names = get_embeddings(model, make_synthetic_dataset(
        n=12, seed=0, modalities=TRI, **SYN), batch_size=5, device="cpu")
    jembs, jnames = jax_get_embeddings(jmodel, variables, jax_make_synthetic_dataset(
        n=12, seed=0, modalities=TRI, **SYN), batch_size=5)
    assert names == list(jnames) == list(QUAD)
    for g, w in zip(embs, jembs):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_trainer_takes_the_models_class_count():
    """f1_val averages over the model's own classes: a 3-class model needs
    no n_classes argument, and one that disagrees with its config raises."""
    model = CLIPModel(CLIPConfig.create(**cfg_kwargs(
        combinations=("lightcurve",), classification=True, n_classes=3)))
    cfg = TrainerConfig(epochs=1, batch_size=8)
    assert Trainer(model, "classification", cfg).n_classes == 3
    assert Trainer(model, "classification", cfg, n_classes=3).n_classes == 3
    with pytest.raises(ValueError, match="n_classes=5 disagrees"):
        Trainer(model, "classification", cfg, n_classes=5)


@pytest.mark.parametrize("head", ["regression", "classification"])
def test_predict_supervised_matches_jax(head):
    kw = TASKS[head]
    jmodel, variables, _ = jax_setup(n=8, **kw)
    model = port_model(variables, **kw)
    ds = make_synthetic_dataset(n=11, seed=3, modalities=TRI, **SYN)
    got = predict_supervised(model, ds, batch_size=4, device="cpu")
    want = jax_predict_supervised(jmodel, variables, jax_make_synthetic_dataset(
        n=11, seed=3, modalities=TRI, **SYN), batch_size=4)
    assert got.shape == (11, model.cfg.head_out) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        direct = model.eval()(ds.to_device("cpu"))
    np.testing.assert_allclose(got, direct.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="regression or classification"):
        predict_supervised(port_model(jax_setup(n=8)[1]), ds, device="cpu")


def test_load_live_serves_images_and_meta(tmp_path):
    """The image side comes from the flag, else the sidecar's extra, else 60;
    the meta fields are label (int32) and redshift (float32) per sample; the
    served embeddings equal the loaded model's encode."""
    _, _, _, run_dir = _jax_exported_run(tmp_path, combinations=QUAD)
    served = load_live(run_dir, 4, device="cpu", lc_len=12, sp_len=20, image_size=20)
    spec = served.input_spec
    assert spec["x_img"] == ((20, 20, 3), np.dtype("float32"))
    assert spec["label"] == ((), np.dtype("int32"))
    assert spec["redshift"] == ((), np.dtype("float32"))
    assert served.modalities == list(QUAD)
    ds = make_synthetic_dataset(n=4, seed=5, modalities=TRI, **SYN)
    feed = {k: ds.arrays[k] for k in spec}
    model, _ = load_model(run_dir, device="cpu")
    with torch.no_grad():
        want = model.encode({k: torch.from_numpy(v) for k, v in feed.items()})
    for g, w in zip(served.fn(feed), want):
        np.testing.assert_array_equal(g, w.numpy())
    assert load_live(run_dir, 4, device="cpu").input_spec["x_img"][0] == (60, 60, 3)
    path = os.path.join(run_dir, "model_config.json")
    with open(path) as f:
        sidecar = json.load(f)
    sidecar["extra"]["image_size"] = 32
    with open(path, "w") as f:
        json.dump(sidecar, f)
    assert load_live(run_dir, 4, device="cpu").input_spec["x_img"][0] == (32, 32, 3)
    assert "x_img" not in input_spec(("lightcurve",), 2, 12, 20)
