"""Run directories without a ``model_config.json`` sidecar (the reference's
own layout: ``run-<k>/config.yaml`` beside the sweep's
``sweep_config.yaml``), rebuilt by the port's ``initialize_from_run_dir``
against the JAX package's, on the CPU: the same model family, config,
run config and extra for the first grid point of every shipped config, a
masked-pretraining run, a supervised ``ClipMLPHead`` run over its
pretrained run's CLIP config, a contrastive fine-tune without ``n_out``, a
ViT run, and the ``combinations`` override of a masked and a
``ClipMLPHead`` run that carry a sidecar; and ``load_model`` of a
reference-layout run dir against the JAX ``load_model`` (embeddings within
2e-5; the light-curve tower aggregates by the mean, since the JAX
package's checkpoint importer cannot read an attention aggregation under a
tower prefix, models/factory.py:509 there)."""

import dataclasses
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multimodal_supernovae_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic_dataset,
)
from multimodal_supernovae_tpu.models.factory import (
    initialize_from_run_dir as jax_initialize_from_run_dir,
)
from multimodal_supernovae_tpu.models.factory import load_model as jax_load_model
from multimodal_supernovae_tpu.models.factory import write_model_config as jax_write_model_config
from multimodal_supernovae_tpu_torch.config import expand_grid, load_sweep
from multimodal_supernovae_tpu_torch.data import make_synthetic_dataset
from multimodal_supernovae_tpu_torch.models import (
    CLIPConfig,
    CLIPModel,
    initialize_from_run_dir,
    load_model,
)
from multimodal_supernovae_tpu_torch.training import Trainer, TrainerConfig

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.yaml"))
POINT = {"n_out": 8, "emb": 16, "heads": 2, "transformer_depth": 1, "emb_spectral": 8,
         "transformer_depth_spectral": 2, "time_norm": 1000.0, "lr": 1e-3, "seed": 1}


def reference_run(root: Path, extra, point, name="sweep", sidecar_of=None):
    """``<root>/<name>/run-0`` in the reference's layout: the point's
    config.yaml and the sweep's sweep_config.yaml (written by PyYAML, as the
    reference's are); with ``sidecar_of`` also that JAX model's sidecar."""
    run_dir = root / name / "run-0"
    run_dir.mkdir(parents=True)
    (root / name / "sweep_config.yaml").write_text(yaml.safe_dump(
        {"method": "grid", "parameters": {k: {"values": [v]} for k, v in point.items()},
         "extra_args": extra}))
    (run_dir / "config.yaml").write_text(yaml.safe_dump(point))
    if sidecar_of is not None:
        assert jax_write_model_config(str(run_dir), sidecar_of)
    return str(run_dir)


def plain(cfg):
    """A config as JSON data (tuples and lists alike; nested configs)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def assert_same_rebuild(run_dir, combinations=None):
    got = initialize_from_run_dir(run_dir, combinations=combinations)
    want = jax_initialize_from_run_dir(run_dir, combinations=combinations)
    assert type(got[0]).__name__ == type(want[0]).__name__
    assert plain(got[0].cfg) == plain(want[0].cfg)
    assert got[1] == want[1]
    assert json.loads(json.dumps(got[2])) == json.loads(json.dumps(want[2]))
    return got


@pytest.mark.parametrize("name", CONFIGS)
def test_first_point_of_each_shipped_config(tmp_path, name):
    """The first grid point of configs/<name> (list(expand_grid(...))[0]),
    its pretrain_path pointed at a reference-layout pretrained run."""
    sweep = load_sweep(str(REPO / "configs" / name))
    point = list(expand_grid(sweep))[0]
    extra = dict(sweep.extra_args)
    if extra.get("pretrain_path"):
        pre = load_sweep(str(REPO / "configs" / "maven_pretrain.yaml"))
        extra["pretrain_path"] = reference_run(tmp_path, pre.extra_args,
                                               list(expand_grid(pre))[0], "pretrain")
    model, run_cfg, _ = assert_same_rebuild(reference_run(tmp_path, extra, point))
    assert run_cfg == point
    if "f_mask" in point:
        assert type(model).__name__ == "MaskedLightCurveEncoder"


def test_masked_run(tmp_path):
    point = dict(POINT, f_mask=0.25, dropout=0.1)
    model, _, extra = assert_same_rebuild(
        reference_run(tmp_path, {"combinations": ["lightcurve"]}, point))
    assert type(model).__name__ == "MaskedLightCurveEncoder" and model.cfg.f_mask == 0.25
    assert extra["loss"] == "softmax"


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_supervised_run_over_its_pretrained_run(tmp_path, task):
    """A ClipMLPHead whose CLIP config is the pretrained run's, rebuilt from
    the pretrained run's own reference layout, with the head's keys."""
    pre = reference_run(tmp_path, {"combinations": ["lightcurve", "spectral"]}, POINT,
                        "pretrain")
    extra = {"combinations": ["lightcurve"], "pretrain_path": pre, task: True,
             "n_classes": 3}
    head, _, _ = assert_same_rebuild(reference_run(
        tmp_path, extra, {"hidden_dim": 16, "num_layers": 3, "dropout": 0.2, "lr": 1e-4}))
    assert type(head).__name__ == "ClipMLPHead"
    assert head.cfg.clip.combinations == ("lightcurve",) and head.cfg.num_layers == 3


def test_contrastive_finetune_without_n_out(tmp_path):
    """No architecture keys in the fine-tune's point: the model is the
    pretrained run's (here one with a JAX-written sidecar)."""
    from multimodal_supernovae_tpu.models import CLIPConfig as JaxCLIPConfig
    from multimodal_supernovae_tpu.models import CLIPModel as JaxCLIPModel

    seq = {"n_out": 8, "emb": 8, "heads": 2, "depth": 1, "time_norm": 100.0}
    jmodel = JaxCLIPModel(JaxCLIPConfig.create(
        combinations=("lightcurve", "spectral"), enc_dim=8, nband=2, loss="softmax",
        transformer_kwargs=seq, transformer_spectral_kwargs=seq))
    pre = reference_run(tmp_path, {"combinations": ["lightcurve", "spectral"]}, POINT,
                        "pretrain", sidecar_of=jmodel)
    extra = {"combinations": ["lightcurve", "spectral"], "pretrain_path": pre}
    model, _, _ = assert_same_rebuild(reference_run(tmp_path, extra, {"lr": 1e-5}))
    assert model.cfg.tk() == jmodel.cfg.tk() == dict(
        JaxCLIPConfig.create(transformer_kwargs=seq).transformer_kwargs)


def test_vit_run(tmp_path):
    extra = {"combinations": ["host_galaxy", "lightcurve"], "image_encoder": "vit",
             "vit_use_pallas": False}
    point = dict(POINT, vit_emb=32, vit_heads=2, vit_depth=3, vit_patch_size=5)
    model, _, _ = assert_same_rebuild(reference_run(tmp_path, extra, point))
    assert type(model.image_encoder).__name__ == "ViT" and model.image_encoder.depth == 3


@pytest.mark.parametrize("family", ["masked", "clip_mlp"])
def test_combinations_override_of_a_sidecar_run(tmp_path, family):
    """A masked or ClipMLPHead run that carries a sidecar, asked for other
    towers, rebuilds from its sweep config, as in the JAX package."""
    from multimodal_supernovae_tpu.models import MaskedLightCurveEncoder
    from multimodal_supernovae_tpu.models.clip_mlp import ClipMLPConfig, ClipMLPHead
    from multimodal_supernovae_tpu.models.pretraining import MaskedEncoderConfig

    seq = {"n_out": 8, "emb": 16, "heads": 2, "depth": 1}
    if family == "masked":
        jmodel = MaskedLightCurveEncoder(MaskedEncoderConfig.create(
            f_mask=0.3, nband=2, transformer_kwargs=seq))
        extra, point = {"combinations": ["lightcurve"]}, dict(POINT, f_mask=0.3)
    else:
        pre = reference_run(tmp_path, {"combinations": ["lightcurve", "spectral"]}, POINT,
                            "pretrain")
        clip = jax_initialize_from_run_dir(pre)[0]
        jmodel = ClipMLPHead(ClipMLPConfig(clip=clip.cfg, combinations=("lightcurve",),
                                           hidden_dim=16, num_layers=2, regression=True))
        extra = {"combinations": ["lightcurve"], "pretrain_path": pre, "regression": True}
        point = {"hidden_dim": 16, "num_layers": 2}
    run_dir = reference_run(tmp_path, extra, point, sidecar_of=jmodel)
    assert_same_rebuild(run_dir)  # the sidecar path
    model, _, extra = assert_same_rebuild(run_dir, combinations=["lightcurve", "spectral"])
    assert extra["combinations"] == ["lightcurve", "spectral"]


def test_load_model_of_a_reference_layout_run_matches_jax(tmp_path):
    """A run the port trained, its sidecar removed and a sweep_config.yaml put
    beside it: the port's load_model rebuilds it through the schema path and
    serves the trained weights, and the JAX load_model's embeddings agree
    within 2e-5."""
    seq = {"n_out": 8, "emb": 16, "heads": 2, "depth": 1, "time_norm": 1000.0,
           "agg": "mean", "dropout": 0.0}
    cfg = CLIPConfig.create(combinations=("lightcurve", "spectral"), enc_dim=128, nband=2,
                            logit_scale_init=10.0, loss="softmax", transformer_kwargs=seq,
                            transformer_spectral_kwargs=seq)
    syn = dict(n_max_lc=8, nband=2, n_max_sp=12)
    ds = make_synthetic_dataset(n=24, seed=0, **syn)
    sweep_dir = tmp_path / "sweep"
    run_dir = str(sweep_dir / "run-0")
    point = {"n_out": 8, "emb": 16, "heads": 2, "transformer_depth": 1, "time_norm": 1000.0,
             "agg": "mean", "dropout": 0.0, "lr": 1e-3}
    res = Trainer(CLIPModel(cfg, torch.Generator().manual_seed(0)), "contrastive",
                  TrainerConfig(epochs=2, batch_size=8, lr=1e-3), run_dir=run_dir).fit(
        ds.subset(np.arange(16)), ds.subset(np.arange(16, 24)), config_dump=point)
    os.remove(os.path.join(run_dir, "model_config.json"))
    (sweep_dir / "sweep_config.yaml").write_text(yaml.safe_dump(
        {"extra_args": {"combinations": ["lightcurve", "spectral"]}}))
    model, extra = load_model(run_dir, "cpu", which="last")
    for name in ("combinations", "enc_dim", "logit_scale_init", "nband", "loss",
                 "transformer_kwargs", "transformer_spectral_kwargs"):
        assert getattr(model.cfg, name) == getattr(cfg, name), name
    assert extra["loss"] == "softmax"
    batch = jax_make_synthetic_dataset(n=24, seed=0, **syn).to_device().take(
        jnp.arange(16, 24))
    jmodel, variables, *_ = jax_load_model(run_dir, batch, which="last")
    want = [np.asarray(e) for e in jmodel.apply(variables, batch)]
    feed = {k: torch.tensor(np.asarray(getattr(batch, k))) for k in
            ("x_lc", "t_lc", "mask_lc", "x_sp", "t_sp", "mask_sp")}
    with torch.no_grad():
        got = [e.numpy() for e in model.encode(feed)]
        live = [e.numpy() for e in res["state"].model.eval().encode(feed)]
    for g, w, lv in zip(got, want, live):
        np.testing.assert_array_equal(g, lv)
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)
