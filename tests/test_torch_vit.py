"""The port's ViT image tower (models/vit.py) against the JAX package's, on
the CPU, at emb 16, depth 2, 2 heads, patch 5 on 20 x 20 images, from the
same weights (carried by ``state_dict_from_jax``'s ViT branch) and the same
numpy inputs: the tower's forward in float32 (2e-5) and bfloat16 (0.05),
its gradients (5e-4), a trimodal ``CLIPModel`` with a ViT tower (embeddings
and loss 2e-5 in float32, gradients 5e-4), three train steps against the
JAX epoch runner (noise 0, dropout 0, images not rotated; trajectories
1e-4), stacked ViT members (``fit_members``) against sequential runs
(relative 1e-5 an epoch of one step), the converter's round trip, the
sidecar read by either package, a run dir trained, reloaded and served,
the refusals (an image side the patch does not divide, a head dim the flash
backward does not take under ``--check``).

The sequence towers take the JAX package's positional encoding in the
whole-model comparisons (``same_positional_encoding``; tests/test_torch_towers.py
says why).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic_dataset,
)
from multimodal_supernovae_tpu.models import CLIPConfig as JaxCLIPConfig
from multimodal_supernovae_tpu.models import CLIPModel as JaxCLIPModel
from multimodal_supernovae_tpu.models.factory import read_model_config as jax_read_model_config
from multimodal_supernovae_tpu.models.factory import write_model_config as jax_write_model_config
from multimodal_supernovae_tpu.models.vit import ViT as JaxViT
from multimodal_supernovae_tpu.training.optim import build_optimizer as jax_build_optimizer
from multimodal_supernovae_tpu.training.state import TrainState as JaxTrainState
from multimodal_supernovae_tpu.training.step import (
    make_epoch_runner as jax_make_epoch_runner,
)
from multimodal_supernovae_tpu_torch.config import build_clip_config
from multimodal_supernovae_tpu_torch.data import make_synthetic_dataset
from multimodal_supernovae_tpu_torch.models import (
    CLIPConfig,
    CLIPModel,
    ViT,
    load_model,
    read_model_config,
    state_dict_from_jax,
    vit_state_dict,
    write_model_config,
)
from multimodal_supernovae_tpu_torch.serving import load_live
from multimodal_supernovae_tpu_torch.training import (
    Trainer,
    TrainerConfig,
    TrainState,
    build_optimizer,
    make_epoch_runner,
)
from multimodal_supernovae_tpu_torch.training.ensemble import Member, fit_members
from multimodal_supernovae_tpu_torch.training.preflight import preflight_run
from tests.test_torch_towers import same_positional_encoding  # noqa: F401  (a fixture)

VIT = {"emb": 16, "depth": 2, "heads": 2, "patch_size": 5, "mlp_mult": 4, "n_out": 8}
SEQ = {"n_out": 8, "emb": 16, "heads": 2, "depth": 1, "time_norm": 2000.0, "agg": "mean",
       "dropout": 0.0}
SYN = dict(n_max_lc=12, nband=2, n_max_sp=20, image_size=20)
TRI = ("host_galaxy", "lightcurve", "spectral")
BI = ("host_galaxy", "lightcurve")


def _images(n=6, side=20, seed=0):
    return np.random.default_rng(seed).random((n, side, side, 3)).astype(np.float32)


def _jax_vit(dtype=None, **kw):
    model = JaxViT(use_pallas=False, dtype=dtype, **dict(VIT, **kw))
    return model, model.init(jax.random.PRNGKey(0), jnp.asarray(_images()))


def _port_vit(variables, dtype=None, image_size=20, **kw):
    model = ViT(image_size=image_size, dtype=dtype, **dict(VIT, **kw))
    sd = vit_state_dict(jax.tree_util.tree_map(np.asarray, variables["params"]))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_forward_matches_jax(dtype):
    """(B, n_out) float32 out of either dtype; float32 within 2e-5, bf16
    (the blocks in bf16, norm_out and head in float32) within 0.05."""
    jdt, tdt = (None, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jmodel, variables = _jax_vit(jdt)
    x = _images()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_vit(variables, tdt)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (6, VIT["n_out"])
    tol = 2e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_vit_grads_match_jax():
    """jax.grad of a weighted sum of the outputs against the port's
    autograd: every parameter's gradient and the input's within 5e-4."""
    jmodel, variables = _jax_vit()
    x = _images()
    w = np.random.default_rng(1).normal(size=(6, VIT["n_out"])).astype(np.float32)

    def loss(params, xx):
        return jnp.sum(jmodel.apply({"params": params}, xx) * w)

    jgrads, jgx = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    model = _port_vit(variables)
    tx = torch.from_numpy(x).requires_grad_()
    (model(tx) * torch.from_numpy(w)).sum().backward()
    want = vit_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=5e-4, atol=5e-4, err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=5e-4, atol=5e-4)


def test_converter_round_trip():
    """Every JAX leaf lands in exactly one state_dict entry, in torch's
    layout, and a loaded model gives the entries back unchanged; the CLIP
    converter takes the ViT branch where the tree has no patch_bn."""
    _, variables = _jax_vit()
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    sd = vit_state_dict(params, "image_encoder.")
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    np.testing.assert_array_equal(sd["image_encoder.patch_embed.weight"],
                                  params["patch_embed"]["kernel"].T)
    np.testing.assert_array_equal(sd["image_encoder.block_1.norm2.weight"],
                                  params["block_1"]["norm2"]["scale"])
    model = ViT(image_size=20, **VIT)
    model.load_state_dict({k[len("image_encoder."):]: torch.tensor(v) for k, v in sd.items()},
                          strict=True)
    for name, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), sd["image_encoder." + name])
    jmodel, cvars = _jax_clip(BI)
    full = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, cvars["params"]))
    assert "image_encoder.pos_emb" in full and not any("running" in k for k in full)
    _port_clip(cvars, BI)  # loads strictly


def test_pos_emb_takes_the_loaded_token_count():
    """A model built for 60 x 60 loads a 20 x 20 run's pos_emb; an image at
    another patch count, or a side the patch does not divide, raises (the
    JAX tower asserts)."""
    jmodel, variables = _jax_vit()
    model = _port_vit(variables, image_size=60)
    assert model.pos_emb.shape == (1, 16, 16)
    with pytest.raises(ValueError, match="pos_emb holds 16"):
        model(torch.rand(2, 30, 30, 3))
    with pytest.raises(ValueError, match="not divisible by patch_size 5"):
        model(torch.rand(2, 22, 22, 3))
    with pytest.raises(AssertionError, match="not divisible"):
        jmodel.apply(variables, jnp.zeros((2, 22, 22, 3)))
    with pytest.raises(ValueError, match="not divisible by patch_size 10"):
        ViT(image_size=25)


# -- the CLIP model with a ViT tower ------------------------------------------------


def _cfg_kwargs(combinations, **kw):
    return dict(dict(combinations=combinations, enc_dim=8, nband=2, logit_scale_init=19.55,
                     loss="softmax", transformer_kwargs=SEQ, transformer_spectral_kwargs=SEQ,
                     image_encoder="vit", vit_kwargs=dict(VIT, dropout_prob=0.0)), **kw)


def _jax_clip(combinations, n=8, **kw):
    model = JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False, **_cfg_kwargs(combinations,
                                                                               **kw)))
    data = jax_make_synthetic_dataset(n=n, seed=0, modalities=TRI, **SYN).to_device()
    return model, model.init(jax.random.PRNGKey(0), data.take(jnp.arange(n)))


def _port_clip(variables, combinations, **kw):
    model = CLIPModel(CLIPConfig.create(**_cfg_kwargs(combinations, **kw)), image_size=20)
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables["params"]))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return model


def _batches(n=8, seed=0):
    kw = dict(n=n, seed=seed, modalities=TRI, **SYN)
    return (make_synthetic_dataset(**kw).to_device("cpu"),
            jax_make_synthetic_dataset(**kw).to_device().take(jnp.arange(n)))


def test_clip_with_vit_matches_jax(same_positional_encoding):
    """Eval embeddings and the train-mode loss within 2e-5, every
    parameter's gradient within 5e-4, trimodal."""
    jmodel, variables = _jax_clip(TRI)
    batch, jbatch = _batches()
    want = jmodel.apply(variables, jbatch, method=jmodel.encode)
    model = _port_clip(variables, TRI)
    with torch.no_grad():
        got = model.eval().encode(batch)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)

    def loss_of(params):
        return jmodel.apply({"params": params}, jbatch, train=True, method=jmodel.loss_fn)

    (jloss, _), jgrads = jax.value_and_grad(loss_of, has_aux=True)(variables["params"])
    loss, _ = model.train().loss_fn(batch, train=True, generator=torch.Generator())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5, atol=2e-5)
    want_grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    got_grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got_grads) == sorted(want_grads)
    for name, g in got_grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[name], rtol=5e-4, atol=5e-4,
                                   err_msg=name)


def test_bf16_clip_keeps_norm_out_and_head_float32():
    _, variables = _jax_clip(BI)
    model = _port_clip(variables, BI, compute_dtype="bfloat16").eval()
    batch, _ = _batches()
    seen = {}
    for name in ("patch_embed", "block_0", "norm_out", "head"):
        getattr(model.image_encoder, name).register_forward_hook(
            lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
    with torch.no_grad():
        out = model.embed_image(batch["x_img"])
    assert seen == {"patch_embed": torch.bfloat16, "block_0": torch.bfloat16,
                    "norm_out": torch.float32, "head": torch.float32}
    assert out.dtype == torch.float32


def test_three_train_steps_match_the_jax_epoch_runner(same_positional_encoding):
    """Three RAdam steps (lr 1e-3, noise 0, dropout 0, images not rotated):
    the losses within relative 1e-4 of the JAX epoch runner's."""
    jmodel, variables = _jax_clip(BI, n=12)
    data = jax_make_synthetic_dataset(n=12, seed=0, modalities=TRI, **SYN).to_device()
    plan = np.random.default_rng(0).permutation(12).reshape(3, 4).astype(np.int32)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                  tx=jax_build_optimizer(lr=1e-3))
    run = jax_make_epoch_runner(jmodel, rotate_images=False, donate=False)
    _, want = run(jstate, data, jnp.asarray(plan), jax.random.PRNGKey(1))
    model = _port_clip(variables, BI)
    opt, _ = build_optimizer(model.named_parameters(), lr=1e-3)
    _, got = make_epoch_runner(model, rotate_images=False)(
        TrainState(model, opt), make_synthetic_dataset(n=12, seed=0, modalities=TRI,
                                                       **SYN).to_device("cpu"),
        plan, torch.Generator())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_stacked_vit_members_match_sequential_runs():
    """Two members (dropout 0.1, noise on, rotated images) stacked by
    fit_members against each member's own Trainer.fit: one step an epoch, so
    each epoch's train loss is a step's, within relative 1e-5, and the
    final weights within 3e-4."""
    ds = make_synthetic_dataset(n=24, seed=0, modalities=BI, **SYN)
    idx = np.arange(24)
    members = [Member("run-0", 3, idx[:16], idx[16:]),
               Member("run-1", 7, np.concatenate([idx[:8], idx[16:]]), idx[8:16])]
    cfg = TrainerConfig(epochs=3, batch_size=16, lr=3e-3, noise_level_mag=1.0,
                        noise_level_img=0.1)
    kw = _cfg_kwargs(BI, vit_kwargs=dict(VIT, dropout_prob=0.1))
    models = [CLIPModel(CLIPConfig.create(**kw), torch.Generator().manual_seed(m.seed),
                        image_size=20) for m in members]
    res = fit_members([copy.deepcopy(m) for m in models], "contrastive", cfg, ds, members)
    for m, model in zip(members, models):
        c = TrainerConfig(**{**cfg.__dict__, "seed": m.seed})
        seq = Trainer(model, "contrastive", c).fit(ds.subset(m.train_indices),
                                                   ds.subset(m.val_indices))
        par = res["members"][m.name]
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(par["history"][key], seq["history"][key], rtol=1e-5,
                                       atol=0, err_msg=key)
        want = seq["state"].model.state_dict()
        for name, p in par["state"].model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-3, atol=3e-4,
                                       err_msg=name)


# -- sidecars, run dirs, serving ------------------------------------------------------


def test_sidecar_is_read_by_either_package(tmp_path):
    """A ViT run's model_config.json round-trips: the port reads the JAX
    sidecar (vit_kwargs with use_pallas) and the JAX package reads the port's
    into an equal config."""
    jcfg = JaxCLIPConfig.create(**_cfg_kwargs(BI, vit_kwargs=dict(VIT, use_pallas=None)))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    assert jax_write_model_config(str(jdir), JaxCLIPModel(jcfg))
    cfg, _ = read_model_config(str(jdir))
    assert cfg.image_encoder == "vit" and cfg.vk() == dict(VIT, use_pallas=None)
    assert write_model_config(str(pdir), CLIPModel(cfg, image_size=20))
    back, _ = jax_read_model_config(str(pdir))
    assert back.cfg == jcfg
    assert json.loads((pdir / "model_config.json").read_text())["config"] == json.loads(
        (jdir / "model_config.json").read_text())["config"]


def test_vit_run_dir_trains_reloads_and_serves(tmp_path):
    """Two epochs into a run dir; load_model (a model built for 60 x 60 takes
    the 20 x 20 pos_emb) and load_live serve what the trained model
    encodes; the sweep builder sizes the tower from the images."""
    ds = make_synthetic_dataset(n=20, seed=0, modalities=BI, **SYN)
    model = CLIPModel(CLIPConfig.create(**_cfg_kwargs(BI)), torch.Generator().manual_seed(0),
                      image_size=20)
    run_dir = str(tmp_path / "run")
    res = Trainer(model, "contrastive", TrainerConfig(epochs=2, batch_size=8, lr=1e-3),
                  run_dir=run_dir).fit(ds.subset(np.arange(14)), ds.subset(np.arange(14, 20)))
    loaded, _ = load_model(run_dir, "cpu", which="last")
    batch = ds.subset(np.arange(6)).to_device("cpu")
    trained = res["state"].model.eval()
    with torch.no_grad():
        want = trained.encode(batch)
        for g, w in zip(loaded.encode(batch), want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    served = load_live(run_dir, 6, device="cpu", which="last", lc_len=12, image_size=20)
    assert served.input_spec["x_img"][0] == (20, 20, 3)
    out = served.fn({k: ds.arrays[k][:6] for k in served.input_spec})
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g, w.numpy())
    from multimodal_supernovae_tpu_torch.training.experiment import _build_run

    point = {"n_out": 8, "emb": 16, "heads": 2, "transformer_depth": 1, "vit_emb": 16,
             "vit_heads": 2, "vit_depth": 1, "vit_patch_size": 5}
    built = _build_run(point, {"combinations": list(BI), "image_encoder": "vit"}, 2, None,
                       None, image_size=20)[0]
    assert built.image_encoder.pos_emb.shape == (1, 16, 16)


@pytest.mark.parametrize("emb,heads,want", [
    (128, 4, "flash tf32 (3xTF32 tensor cores)"),
    (128, 2, "flash tf32 (3xTF32 tensor cores)"),
    (256, 2, None)], ids=["head-dim-32", "head-dim-64", "head-dim-128"])
def test_check_fails_at_a_head_dim_the_flash_backward_does_not_take(emb, heads, want):
    """--check of a ViT grid point for the card: head dims 128 / 4 = 32 and
    128 / 2 = 64 train on the 3xTF32 tensor-core flash kernels both ways;
    256 / 2 = 128, above the kernels' 64, fails naming the head dim and the
    limit; for the CPU all pass."""
    point = {"n_out": 8, "emb": 16, "heads": 2, "transformer_depth": 1, "vit_emb": emb,
             "vit_heads": heads, "batchsize": 4}
    extra = {"combinations": list(BI), "image_encoder": "vit"}
    if want:
        rep = preflight_run(point, extra, 2, 24, 20)
        assert f"image (ViT): T=36 emb={emb} heads={heads} float32 -> {want}" in rep["notes"]
    else:
        with pytest.raises(ValueError, match="head dim 256 / 2 = 128: the flash kernels take "
                                             "head dims 1 to 64"):
            preflight_run(point, extra, 2, 24, 20)
    rep = preflight_run(point, extra, 2, 24, 20, device="cpu")
    assert any(n.startswith("image (ViT)") and "plain versions (cpu)" in n
               for n in rep["notes"])


def test_build_clip_config_reads_the_vit_keys():
    cfg = build_clip_config({"n_out": 8, "emb": 16, "heads": 2, "transformer_depth": 1,
                             "vit_emb": 64, "vit_heads": 2, "cnn_patch_size": 6},
                            {"combinations": list(BI), "image_encoder": "vit",
                             "vit_use_pallas": True})
    assert cfg.vk() == {"emb": 64, "depth": 6, "heads": 2, "patch_size": 6, "mlp_mult": 4,
                        "n_out": 8, "dropout_prob": 0.0, "use_pallas": True}
    assert CLIPModel(cfg, image_size=12).image_encoder.pos_emb.shape == (1, 4, 64)
