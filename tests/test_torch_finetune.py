"""The Maven two-stage recipe in the port against the JAX package's, on CPU,
at a small size:

  * ``ClipMLPHead`` (regression and 5-class; light-curve only and bimodal)
    on converted JAX weights: output and loss within 2e-5, every parameter
    gradient within 5e-4 of its largest; ``predict_supervised`` against
    JAX's;
  * ``merge_params_nonstrict`` (a missing key, a shape mismatch) and
    ``graft_masked_pretrain_into_clip`` equal to JAX's on converted trees;
  * the freeze labels of both predicates equal to JAX's ``freeze_mask``,
    and frozen weights bitwise unchanged after 2 steps with weight decay on;
  * ``ClipMLPHead`` sidecars read across packages both ways, and
    ``load_model`` of a port ClipMLPHead run dir;
  * ``_build_run`` from configs/config_grid.yaml with ``pretrain_lc_path``
    (a port masked run dir, or one of its files), and from
    configs/maven_finetune.yaml with ``pretrain_path`` (a port run of
    configs/maven_pretrain.yaml's first point, at its widths): the weights
    loaded are the monitored best, not the smallest kept epoch.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic_dataset,
)
from multimodal_supernovae_tpu.evaluation.embeddings import (
    predict_supervised as jax_predict_supervised,
)
from multimodal_supernovae_tpu.models import CLIPConfig as JaxCLIPConfig
from multimodal_supernovae_tpu.models import CLIPModel as JaxCLIPModel
from multimodal_supernovae_tpu.models.clip_mlp import ClipMLPConfig as JaxClipMLPConfig
from multimodal_supernovae_tpu.models.clip_mlp import ClipMLPHead as JaxClipMLPHead
from multimodal_supernovae_tpu.models.factory import read_model_config as jax_read_model_config
from multimodal_supernovae_tpu.models.factory import (
    write_model_config as jax_write_model_config,
)
from multimodal_supernovae_tpu.models.pretraining import (
    MaskedEncoderConfig as JaxMaskedEncoderConfig,
)
from multimodal_supernovae_tpu.models.pretraining import (
    MaskedLightCurveEncoder as JaxMaskedLightCurveEncoder,
)
from multimodal_supernovae_tpu.training import checkpoint as jax_checkpoint
from multimodal_supernovae_tpu.training import optim as jax_optim
from multimodal_supernovae_tpu_torch.config import build_clip_config, expand_grid, load_sweep
from multimodal_supernovae_tpu_torch.data import make_synthetic_dataset
from multimodal_supernovae_tpu_torch.evaluation import predict_supervised
from multimodal_supernovae_tpu_torch.models import (
    CLIPConfig,
    CLIPModel,
    ClipMLPConfig,
    ClipMLPHead,
    finetune_model_builder,
    load_model,
    masked_model_builder,
    pick_reference_ckpt,
    read_model_config,
    state_dict_from_jax,
)
from multimodal_supernovae_tpu_torch.serving import load_live
from multimodal_supernovae_tpu_torch.training import (
    Trainer,
    TrainerConfig,
    TrainState,
    best_ckpt_path,
    build_optimizer,
    freeze_encoder_except_projection,
    freeze_encoders_except_projection,
    freeze_mask,
    make_train_step,
)
from multimodal_supernovae_tpu_torch.training.checkpoint import (
    graft_masked_pretrain_into_clip,
    merge_params_nonstrict,
)
from multimodal_supernovae_tpu_torch.training.experiment import _build_run, task_of
from tests.test_torch_towers import same_positional_encoding  # noqa: F401  (a fixture)

SYN = dict(n_max_lc=8, nband=2, n_max_sp=12)
SEQ = {"n_out": 8, "emb": 16, "heads": 2, "depth": 2, "time_norm": 500.0, "agg": "mean",
       "dropout": 0.0}
BI = ("lightcurve", "spectral")
HEADS = {"regression": dict(regression=True), "classification": dict(
    regression=False, classification=True, n_classes=5)}


def clip_kwargs(combinations=BI, **kw):
    return dict(dict(combinations=combinations, enc_dim=8, nband=2, logit_scale_init=19.55,
                     loss="softmax", transformer_kwargs=SEQ,
                     transformer_spectral_kwargs=SEQ), **kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_sd(sd):
    return {k: torch.tensor(v) for k, v in sd.items()}


def _head_cfgs(combinations, head):
    jcfg = JaxClipMLPConfig(clip=JaxCLIPConfig.create(use_pallas=False, **clip_kwargs(
        combinations)), combinations=combinations, hidden_dim=16, **HEADS[head])
    cfg = ClipMLPConfig(clip=CLIPConfig.create(use_pallas=False, **clip_kwargs(combinations)),
                        combinations=combinations, hidden_dim=16, **HEADS[head])
    return jcfg, cfg


def _jax_head(combinations, head, n=12, seed=0):
    jcfg, cfg = _head_cfgs(combinations, head)
    jmodel = JaxClipMLPHead(jcfg)
    jds = jax_make_synthetic_dataset(n=n, seed=seed, **SYN)
    variables = jmodel.init(jax.random.PRNGKey(seed), jds.host_batch(np.arange(4)))
    model = ClipMLPHead(cfg)
    model.load_state_dict(_torch_sd(state_dict_from_jax(_np_tree(variables["params"]))),
                          strict=True)
    return jmodel, variables, jds, model, make_synthetic_dataset(n=n, seed=seed, **SYN)


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("combinations", [("lightcurve",), BI], ids=["lc", "bimodal"])
def test_clip_mlp_head_matches_jax(combinations, head, same_positional_encoding):
    jmodel, variables, jds, model, ds = _jax_head(combinations, head)
    jbatch, batch = jds.to_device(), ds.to_device("cpu")
    want = jmodel.apply(variables, jbatch)
    got = model(batch)
    assert got.shape == (12, 5 if head == "classification" else 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)

    def jax_loss(params):
        return jmodel.apply({"params": params}, jbatch, train=True, method=jmodel.loss_fn,
                            rngs={"dropout": jax.random.PRNGKey(1)})[0]

    want_loss, want_grads = jax.value_and_grad(jax_loss)(variables["params"])
    loss, aux = model.loss_fn(batch, train=True, generator=torch.Generator())
    assert sorted(aux) == (["pred"] if head == "regression" else ["logits"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-5, atol=2e-5)
    ref = state_dict_from_jax(_np_tree(want_grads))
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    # the loss does not reach the logit scale and bias
    assert sorted(grads) == sorted(k for k in ref if not k.startswith("clip_model.logit_"))
    for name, g in grads.items():
        scale = max(float(np.abs(ref[name]).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), ref[name], atol=5e-4 * scale, err_msg=name)
    np.testing.assert_allclose(
        predict_supervised(model, ds, batch_size=5, device="cpu"),
        jax_predict_supervised(jmodel, variables, jds, batch_size=5), atol=2e-5)


def _jax_clip(seed=0, **kw):
    jmodel = JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False, **clip_kwargs(**kw)))
    jds = jax_make_synthetic_dataset(n=4, seed=0, **SYN)
    return jmodel.init(jax.random.PRNGKey(seed), jds.host_batch(np.arange(4)))["params"]


def test_merge_params_nonstrict_matches_jax():
    """The source lacks a key (logit_bias) and its spectral projection has
    another shape (n_out 4): both are kept from the target, as JAX keeps
    them; everything else is the source's. torch's load_state_dict(
    strict=False) would raise on the shape."""
    target = _jax_clip(seed=0)
    source = dict(_jax_clip(seed=1, transformer_spectral_kwargs=dict(SEQ, n_out=4)))
    del source["logit_bias"]
    want = state_dict_from_jax(_np_tree(jax_checkpoint.merge_params_nonstrict(
        dict(target), source)))
    t_sd = _torch_sd(state_dict_from_jax(_np_tree(target)))
    s_sd = _torch_sd(state_dict_from_jax(_np_tree(dict(source, logit_bias=target[
        "logit_bias"]))))
    del s_sd["logit_bias"]
    got = merge_params_nonstrict(t_sd, s_sd)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert torch.equal(got["spectral_encoder.projection.weight"],
                       t_sd["spectral_encoder.projection.weight"])
    assert torch.equal(got["logit_bias"], t_sd["logit_bias"])
    assert torch.equal(got["lightcurve_encoder.embedding_mag.weight"],
                       s_sd["lightcurve_encoder.embedding_mag.weight"])
    model = CLIPModel(CLIPConfig.create(**clip_kwargs()))
    with pytest.raises(RuntimeError, match="size mismatch"):
        model.load_state_dict(s_sd, strict=False)
    model.load_state_dict(got, strict=True)


def test_graft_matches_jax():
    clip = _jax_clip(seed=0, combinations=("lightcurve",))
    masked_model = JaxMaskedLightCurveEncoder(JaxMaskedEncoderConfig.create(
        nband=2, transformer_kwargs={k: SEQ[k] for k in ("emb", "heads", "depth",
                                                          "time_norm")}))
    jds = jax_make_synthetic_dataset(n=4, seed=0, **SYN)
    masked = masked_model.init(jax.random.PRNGKey(3), jds.host_batch(np.arange(4)))["params"]
    want = state_dict_from_jax(_np_tree(jax_checkpoint.graft_masked_pretrain_into_clip(
        dict(clip), masked)))
    clip_sd = _torch_sd(state_dict_from_jax(_np_tree(clip)))
    masked_sd = _torch_sd(state_dict_from_jax(_np_tree(masked), n_out=1))
    got = graft_masked_pretrain_into_clip(clip_sd, masked_sd)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        src = "net." + k[len("lightcurve_encoder."):]
        if k.startswith("lightcurve_encoder.") and ".projection." not in k:
            assert torch.equal(v, masked_sd[src]), k
        else:
            assert torch.equal(v, clip_sd[k]), k


PREDICATES = {
    "lightcurve": (freeze_encoder_except_projection("lightcurve_encoder"),
                   jax_optim.freeze_encoder_except_projection("lightcurve_encoder")),
    "both": (freeze_encoders_except_projection(["lightcurve_encoder", "spectral_encoder"]),
             jax_optim.freeze_encoders_except_projection(
                 ["lightcurve_encoder", "spectral_encoder"])),
}


@pytest.mark.parametrize("family", ["clip", "clip_mlp"])
@pytest.mark.parametrize("which", sorted(PREDICATES))
def test_freeze_labels_match_jax_and_hold_weights(which, family):
    """JAX's labels carried through the weight bridge as 1/0 leaves give each
    port parameter's label; 2 RAdam steps with weight decay leave every
    frozen parameter bitwise as it was and move every other one the loss
    reaches."""
    port_pred, jax_pred = PREDICATES[which]
    if family == "clip":
        params = _jax_clip()
        model = CLIPModel(CLIPConfig.create(**clip_kwargs()))
        model.load_state_dict(_torch_sd(state_dict_from_jax(_np_tree(params))), strict=True)
    else:
        _, variables, _, model, _ = _jax_head(BI, "classification")
        params = variables["params"]
    labels = jax_optim.freeze_mask(params, jax_pred)
    ones = jax.tree_util.tree_map(lambda lab, p: np.full(p.shape, lab == "frozen", np.float32),
                                  labels, params)
    want = {k: "frozen" if v.all() else "train"
            for k, v in state_dict_from_jax(ones).items()}
    assert all(v.all() or not v.any() for v in state_dict_from_jax(ones).values())
    got = freeze_mask(list(model.named_parameters()), port_pred)
    assert got == want
    frozen = sorted(k for k, v in got.items() if v == "frozen")
    assert frozen and any(".projection." in k for k in got if got[k] == "train")

    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt, _ = build_optimizer(model.named_parameters(), lr=1e-2, weight_decay=0.1,
                             freeze=port_pred)
    step = make_train_step(model, 1.0)
    batch = make_synthetic_dataset(n=8, seed=2, **SYN).to_device("cpu")
    state = TrainState(model, opt)
    for _ in range(2):
        state, loss = step(state, batch, torch.Generator().manual_seed(0))
        assert torch.isfinite(loss)
    for k, v in model.named_parameters():
        if k in frozen:
            assert torch.equal(v, before[k]), k
        elif v.grad is not None:  # a head's loss does not reach the logit scale
            assert not torch.equal(v, before[k]), k


def test_clip_mlp_sidecars_across_packages(tmp_path):
    jcfg, cfg = _head_cfgs(BI, "classification")
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    os.makedirs(port_dir)
    os.makedirs(jax_dir)
    from multimodal_supernovae_tpu_torch.models import write_model_config

    assert write_model_config(port_dir, ClipMLPHead(cfg))
    jax_write_model_config(jax_dir, JaxClipMLPHead(jcfg))
    for path in (port_dir, jax_dir):
        got, extra = read_model_config(path)
        jmodel, jextra = jax_read_model_config(path)
        assert got == cfg and extra == jextra
        assert extra == {"combinations": list(BI), "nband": 2, "regression": False,
                         "classification": True, "n_classes": 5}
        want = dataclasses.asdict(jmodel.cfg)
        have = dataclasses.asdict(got)
        clip_fields = set(have["clip"])
        assert {k: v for k, v in want["clip"].items() if k in clip_fields} == have["clip"]
        assert {k: v for k, v in want.items() if k != "clip"} == {
            k: v for k, v in have.items() if k != "clip"}
    with open(os.path.join(port_dir, "model_config.json")) as f:
        assert json.load(f)["model"] == "ClipMLPHead"


def _fit(model, task, run_dir, ds, epochs=3, lr=3e-3, freeze=None, batch_size=8):
    n_val = len(ds) // 4
    train, val = ds.subset(np.arange(len(ds) - n_val)), ds.subset(
        np.arange(len(ds) - n_val, len(ds)))
    tcfg = TrainerConfig(epochs=epochs, batch_size=batch_size, lr=lr, noise_level_mag=1.0)
    return Trainer(model, task, tcfg, run_dir=run_dir, freeze=freeze).fit(train, val), val


def test_clip_mlp_run_dir_loads_and_predicts(tmp_path):
    _, _, _, model, ds = _jax_head(BI, "classification", n=16)
    run_dir = str(tmp_path / "head")
    out, val = _fit(model, "classification", run_dir, ds, epochs=2,
                    freeze=PREDICATES["both"][0])
    assert all(np.isfinite(r["f1_val"]) for r in out["metric_rows"])
    loaded, extra = load_model(run_dir, device="cpu", which="last")
    assert isinstance(loaded, ClipMLPHead) and extra["classification"]
    np.testing.assert_array_equal(
        predict_supervised(loaded, val, device="cpu"),
        predict_supervised(out["state"].model, val, device="cpu"))
    with pytest.raises(ValueError, match="CLIPModel"):
        load_live(run_dir, 4, device="cpu", which="last")


def _best_is_not_smallest(run_dir):
    """The precondition that lets a test tell the two meanings of "best"
    apart: the monitored best is not the smallest kept epoch."""
    best, smallest = best_ckpt_path(run_dir), pick_reference_ckpt(run_dir, "best")
    assert best != smallest, (best, smallest)
    with open(os.path.join(run_dir, "summary.json")) as f:
        epoch = int(json.load(f)["best_ckpt_epoch"])
    assert os.path.basename(best).startswith(f"epoch={epoch}-")
    return torch.load(best, weights_only=True)["state_dict"]


def test_build_run_grafts_the_masked_runs_best(tmp_path):
    """config_grid.yaml's first point: a masked run at its widths (emb 32, 2
    heads, 9 blocks) into run dir M, then the regression grid point with
    ``pretrain_lc_path`` = M (and = M's best file) and
    ``freeze_backbone_lc``: the light-curve tower but its projection is M's
    best ``net.*`` bitwise, and stays so through an epoch."""
    sweep = load_sweep("configs/config_grid.yaml")
    point, extra = next(expand_grid(sweep)), sweep.extra_args
    masked, task, freeze, override = masked_model_builder(extra)(point, extra, 2)
    assert (task, freeze, override, masked.cfg.f_mask) == ("masked", None, None, 0.15)
    assert masked.cfg.tk()["depth"] == 9 and masked.cfg.tk()["emb"] == 32
    ds = make_synthetic_dataset(n=24, seed=1, modalities=("lightcurve",), **SYN)
    m_dir = str(tmp_path / "masked")
    _fit(masked, "masked", m_dir, ds, lr=1e-3)
    best = _best_is_not_smallest(m_dir)
    for path in (m_dir, best_ckpt_path(m_dir)):
        run_extra = dict(extra, pretrain_lc_path=path, freeze_backbone_lc=True)
        model, task, freeze, override, tcfg = _build_run(point, run_extra, 2, None, 1)
        assert task == task_of(run_extra) == "regression" and tcfg.epochs == 1
        fresh = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(override(model.state_dict()), strict=True)
        for k, v in model.state_dict().items():
            if k.startswith("lightcurve_encoder.") and ".projection." not in k:
                assert torch.equal(v, best["net." + k[len("lightcurve_encoder."):]]), k
            else:
                assert torch.equal(v, fresh[k]), k
    grafted = {k: v.clone() for k, v in model.state_dict().items()}
    out, _ = _fit(model, task, None, ds, epochs=1, freeze=freeze)
    assert np.isfinite(out["metric_rows"][0]["R2_val"])
    for k, v in model.state_dict().items():
        moved = not torch.equal(v, grafted[k])
        if k.startswith("lightcurve_encoder.") and ".projection." not in k:
            assert not moved, k
        elif k.startswith(("lightcurve_encoder.projection.", "lightcurve_projection.",
                           "linear.")):
            assert moved, k


def test_build_run_finetunes_from_the_pretrained_best(tmp_path):
    """maven_pretrain.yaml's first point at its widths (LC 64/8/5, SP
    32/2/13) trained 3 epochs into run dir P; then maven_finetune.yaml's
    first point with ``pretrain_path`` = P: through finetune_model_builder
    (contrastive, and a 5-class ClipMLPHead with ``freeze_backbone``) and
    through the default surgery, the initial weights are P's monitored
    best."""
    sweep = load_sweep("configs/maven_pretrain.yaml")
    point, extra = next(expand_grid(sweep)), sweep.extra_args
    pre_cfg = build_clip_config(point, extra, nband=2)
    assert (pre_cfg.tk()["emb"], pre_cfg.tk()["depth"], pre_cfg.tsk()["depth"]) == (64, 5, 13)
    ds = make_synthetic_dataset(n=24, seed=2, **SYN)
    p_dir = str(tmp_path / "pretrain")
    _fit(CLIPModel(pre_cfg, torch.Generator().manual_seed(0)), "contrastive", p_dir, ds,
         lr=3e-4)
    best = _best_is_not_smallest(p_dir)

    fsweep = load_sweep("configs/maven_finetune.yaml")
    fpoint = next(expand_grid(fsweep))
    fextra = dict(fsweep.extra_args, pretrain_path=p_dir)
    model, task, freeze, override, tcfg = _build_run(
        fpoint, fextra, 2, finetune_model_builder(fextra), 2)
    assert (task, freeze, tcfg.epochs, tcfg.batch_size) == ("contrastive", None, 2, 32)
    assert model.cfg == dataclasses.replace(pre_cfg, combinations=BI)
    model.load_state_dict(override(model.state_dict()), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, best[k]), k

    cextra = dict(fextra, classification=True, freeze_backbone=True)
    head, task, freeze, override, _ = _build_run(fpoint, cextra, 2,
                                                 finetune_model_builder(cextra), 1)
    assert isinstance(head, ClipMLPHead) and task == "classification"
    assert head.cfg.clip == model.cfg and head.cfg.dropout == fpoint["dropout"]
    mlp = {k: v.clone() for k, v in head.state_dict().items() if k.startswith("mlp_model.")}
    head.load_state_dict(override(head.state_dict()), strict=True)
    for k, v in head.state_dict().items():
        want = best[k[len("clip_model."):]] if k.startswith("clip_model.") else mlp[k]
        assert torch.equal(v, want), k
    labels = freeze_mask(list(head.named_parameters()), freeze)
    assert {k for k, v in labels.items() if v == "train"} == {
        k for k, _ in head.named_parameters()
        if not k.startswith(("clip_model.lightcurve_encoder.", "clip_model.spectral_encoder."))
        or ".projection." in k}

    # the default surgery: the finetune grid point's own architecture, merged
    model, task, freeze, override, _ = _build_run(fpoint, fextra, 2, None, None)
    assert task == "contrastive" and freeze is None
    model.load_state_dict(override(model.state_dict()), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, best[k]), k
