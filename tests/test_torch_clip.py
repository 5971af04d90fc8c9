"""The port's CLIP model against the JAX package's, on CPU: the config
schema, the weight bridge and ``encode`` for the lightcurve + spectral
towers. Tolerances: float32 1e-4 (whole model), bfloat16 0.05.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu.data.batching import Batch
from multimodal_supernovae_tpu.models import CLIPConfig as JaxCLIPConfig
from multimodal_supernovae_tpu.models import CLIPModel as JaxCLIPModel
from multimodal_supernovae_tpu.models.torch_export import export_reference_state_dict
from multimodal_supernovae_tpu_torch.data import make_synthetic_arrays
from multimodal_supernovae_tpu_torch.models import (
    CLIPConfig,
    CLIPModel,
    state_dict_from_jax,
)

FIELDS = ("x_lc", "t_lc", "mask_lc", "x_sp", "t_sp", "mask_sp")


def small_cfg_kwargs(compute_dtype=None):
    lc = {"n_out": 8, "emb": 16, "heads": 2, "depth": 2, "time_norm": 2000.0,
          "agg": "attn", "dropout": 0.0}
    sp = {"n_out": 8, "emb": 16, "heads": 2, "depth": 2, "time_norm": 1800.0,
          "agg": "mean", "dropout": 0.0}
    return dict(combinations=("lightcurve", "spectral"), enc_dim=8, nband=2,
                logit_scale_init=19.55, loss="softmax", transformer_kwargs=lc,
                transformer_spectral_kwargs=sp, compute_dtype=compute_dtype)


def jax_model_and_params(compute_dtype=None, seed=0, feed=None):
    model = JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False,
                                              **small_cfg_kwargs(compute_dtype)))
    feed = feed or small_feed()
    params = model.init(jax.random.PRNGKey(seed), _jax_batch(feed))["params"]
    return model, params


def small_feed(n=6, seed=0):
    a = make_synthetic_arrays(n=n, n_max_lc=12, nband=2, n_max_sp=20, seed=seed)
    return {k: a[k] for k in FIELDS}


def _jax_batch(feed):
    return Batch(**{k: jnp.asarray(v) for k, v in feed.items()})


def torch_model(params, compute_dtype=None):
    model = CLIPModel(CLIPConfig.create(**small_cfg_kwargs(compute_dtype)))
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           state_dict_from_jax(params).items()}, strict=True)
    return model.eval()


def test_config_has_the_jax_fields_and_defaults():
    ours = {f.name: f for f in dataclasses.fields(CLIPConfig)}
    theirs = {f.name: f for f in dataclasses.fields(JaxCLIPConfig)}
    assert list(ours) == list(theirs)
    for name, f in theirs.items():
        assert ours[name].default == f.default, name
    kw = small_cfg_kwargs("bfloat16")
    assert (dataclasses.asdict(CLIPConfig.create(**kw))
            == dataclasses.asdict(JaxCLIPConfig.create(**kw)))


def test_state_dict_from_jax_equals_reference_export():
    _, params = jax_model_and_params()
    ours = state_dict_from_jax(params)
    ref = export_reference_state_dict(params)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_strict_load_covers_every_parameter():
    _, params = jax_model_and_params()
    model = CLIPModel(CLIPConfig.create(**small_cfg_kwargs()))
    sd = state_dict_from_jax(params)
    assert sorted(model.state_dict()) == sorted(sd)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(
            {k: torch.tensor(v) for k, v in sd.items() if k != "logit_bias"},
            strict=True)


@pytest.mark.parametrize("compute_dtype,tol", [(None, 1e-4), ("bfloat16", 0.05)])
def test_encode_matches_jax(compute_dtype, tol):
    feed = small_feed()
    jmodel, params = jax_model_and_params(compute_dtype, feed=feed)
    want = jmodel.apply({"params": params}, _jax_batch(feed), method=jmodel.encode)
    model = torch_model(params, compute_dtype)
    with torch.inference_mode():
        got = model.encode({k: torch.from_numpy(v) for k, v in feed.items()})
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (6, 8)
        np.testing.assert_allclose(torch.linalg.vector_norm(g, dim=-1).numpy(), 1.0,
                                   rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)


def test_seeded_init_is_reproducible():
    cfg = CLIPConfig.create(**small_cfg_kwargs())
    a = CLIPModel(cfg, generator=torch.Generator().manual_seed(3)).state_dict()
    b = CLIPModel(cfg, generator=torch.Generator().manual_seed(3)).state_dict()
    c = CLIPModel(cfg, generator=torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["spectral_encoder.embedding_mag.weight"],
                           c["spectral_encoder.embedding_mag.weight"])
    assert a["logit_scale"].item() == pytest.approx(np.log(19.55))


@pytest.mark.parametrize("kw", [{"combinations": ("host_galaxy", "spectral"),
                                 "image_encoder": "vit"},
                                {"regression": True}])
def test_unported_towers_and_heads_raise(kw):
    """Both are ported: the ViT image tower builds (item 14;
    tests/test_torch_vit.py holds it to the JAX ViT) and embeds a 60 x 60
    image, and an unknown tower still raises; a regression model builds its
    head over both towers."""
    base = small_cfg_kwargs()
    base.update(kw)
    cfg = CLIPConfig.create(**base)
    if cfg.image_encoder == "vit":
        model = CLIPModel(cfg)
        assert model.image_encoder.pos_emb.shape == (1, 36, 128)  # 60 x 60, patch 10
        with torch.no_grad():
            img = model.embed_image(torch.rand(2, 60, 60, 3))
        assert img.shape == (2, cfg.enc_dim) and torch.isfinite(img).all()
        with pytest.raises(ValueError, match="unknown image_encoder"):
            CLIPModel(CLIPConfig.create(**dict(base, image_encoder="resnet")))
        return
    model = CLIPModel(cfg)
    assert model.linear.weight.shape == (1, 2 * cfg.enc_dim)
