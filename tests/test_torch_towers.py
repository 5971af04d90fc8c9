"""The port's image and meta towers and supervised heads against the JAX
package's, on CPU, at a small size, from the same weights (carried by
``state_dict_from_jax``) and the same numpy inputs: the ConvMixer in eval
and train mode (at 20 x 20 and at a side that is not a multiple of the
patch), its BatchNorm running statistics after three train steps (and
``torch.nn.BatchNorm2d``'s own update failing that check), image
augmentation on handed-in draws, tri- and quadrimodal ``encode`` and loss,
the regression and classification losses and gradients, and
``compute_task_metrics``.

Tolerances: float32 2e-5 for the ConvMixer tower and single ops, 1e-4 for
a whole model's embeddings and loss (the sequence towers' summation order),
5e-4 for parameter gradients and for BatchNorm running statistics after
three train steps (they follow parameters that moved under RAdam in two
frameworks).

The gradient tests hand both stacks the same positional encoding, the JAX
package's (``same_positional_encoding``). The two packages' float32
encodings of spectral wavelengths (3000-9000) differ by up to 2.4e-4: a
one-ulp difference in a frequency, times t ~ 9000, moves the sine's
argument. Through the image-spectral pair loss at logit scale 19.55 that
moves the spectral tower's gradients by up to 1.4% of their largest; with
the same encoding every gradient agrees within 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodal_supernovae_tpu.data import augment as jax_augment
from multimodal_supernovae_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic_dataset,
)
from multimodal_supernovae_tpu.models import CLIPConfig as JaxCLIPConfig
from multimodal_supernovae_tpu.models import CLIPModel as JaxCLIPModel
from multimodal_supernovae_tpu.models.convmixer import ConvMixer as JaxConvMixer
from multimodal_supernovae_tpu.models.torch_export import export_reference_state_dict
from multimodal_supernovae_tpu.models.transformer import (
    time_positional_encoding as jax_time_positional_encoding,
)
from multimodal_supernovae_tpu.training.optim import build_optimizer as jax_build_optimizer
from multimodal_supernovae_tpu.training.state import TrainState as JaxTrainState
from multimodal_supernovae_tpu.training.step import (
    make_epoch_runner as jax_make_epoch_runner,
)
from multimodal_supernovae_tpu.training.trainer import (
    compute_task_metrics as jax_compute_task_metrics,
)
from multimodal_supernovae_tpu_torch.data import augment as port_augment
from multimodal_supernovae_tpu_torch.data import make_synthetic_dataset
from multimodal_supernovae_tpu_torch.data.transforms import CLASS_WEIGHTS
from multimodal_supernovae_tpu_torch.models import transformer as port_transformer
from multimodal_supernovae_tpu_torch.models import CLIPConfig, CLIPModel, state_dict_from_jax
from multimodal_supernovae_tpu_torch.models.convert import convmixer_state_dict
from multimodal_supernovae_tpu_torch.models.convmixer import BatchNorm, ConvMixer
from multimodal_supernovae_tpu_torch.training import (
    TrainState,
    build_optimizer,
    compute_task_metrics,
    make_epoch_runner,
)

SYN = dict(n_max_lc=12, nband=2, n_max_sp=20, image_size=20)
SEQ = {"n_out": 8, "emb": 16, "heads": 2, "depth": 1, "time_norm": 2000.0,
       "agg": "mean", "dropout": 0.0}
CONV = {"dim": 8, "depth": 2, "kernel_size": 3, "patch_size": 10, "n_out": 8,
        "dropout_prob": 0.0}
META = {"input_dim": 8, "hidden_dim": 16, "num_layers": 2}
TRI = ("host_galaxy", "lightcurve", "spectral")
QUAD = TRI + ("meta",)


def cfg_kwargs(combinations=TRI, **kw):
    return dict(dict(combinations=combinations, enc_dim=8, nband=2, logit_scale_init=19.55,
                     loss="softmax", transformer_kwargs=SEQ,
                     transformer_spectral_kwargs=SEQ, conv_kwargs=CONV,
                     meta_kwargs=META), **kw)


def jax_setup(n=12, seed=0, **kw):
    """The JAX model, its variables and the device dataset (every modality
    drawn, so the meta fields are there for any combination)."""
    model = JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False, **cfg_kwargs(**kw)))
    data = jax_make_synthetic_dataset(n=n, seed=seed, modalities=TRI, **SYN).to_device()
    variables = model.init(jax.random.PRNGKey(seed), data.take(jnp.arange(min(n, 8))))
    return model, variables, data


def port_model(variables, **kw):
    model = CLIPModel(CLIPConfig.create(**cfg_kwargs(**kw)))
    sd = state_dict_from_jax(variables["params"], variables.get("batch_stats"))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return model


def port_batch(n=12, seed=0):
    return make_synthetic_dataset(n=n, seed=seed, modalities=TRI, **SYN).to_device("cpu")


@pytest.fixture
def same_positional_encoding(monkeypatch):
    """The port's sequence towers take the JAX package's positional encoding
    of the same times (see the module docstring)."""

    def jax_pe(t, d_emb, norm):
        return torch.from_numpy(np.array(jax_time_positional_encoding(
            jnp.asarray(t.cpu().numpy()), d_emb, norm))).to(t.device)

    monkeypatch.setattr(port_transformer, "time_positional_encoding", jax_pe)


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


# -- ConvMixer ------------------------------------------------------------------

def _convmixer_pair(size, seed=0):
    jm = JaxConvMixer(**CONV)
    img = np.random.default_rng(seed).random((6, size, size, 3), dtype=np.float32)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(img))
    # running statistics away from their (0, 1) start, so eval mode reads them
    stats = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.uniform(jax.random.PRNGKey(seed + 1), x.shape),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    tm = ConvMixer(**CONV)
    tm.load_state_dict({k: torch.tensor(v) for k, v in convmixer_state_dict(
        variables["params"], stats).items()}, strict=True)
    return jm, variables, tm, img


@pytest.mark.parametrize("size", [20, 23])
@pytest.mark.parametrize("train", [False, True])
def test_convmixer_matches_jax(size, train):
    """Eval (running statistics) and train (batch statistics, and the
    running statistics it leaves) at a side that is a multiple of the patch
    and one that is not (SAME padding of the patch convolution: 23 -> 3
    patches)."""
    jm, variables, tm, img = _convmixer_pair(size)
    if train:
        want, upd = jm.apply(variables, jnp.asarray(img), train=True,
                             mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jnp.asarray(img))
    got = tm(torch.from_numpy(img), train=train, generator=torch.Generator())
    assert got.shape == (6, CONV["n_out"]) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    if train:
        sd = convmixer_state_dict(variables["params"], upd["batch_stats"])
        for k, v in tm.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), sd[k], rtol=2e-5, atol=2e-5, err_msg=k)
            if "num_batches_tracked" in k:
                assert int(v) == 1, k


def test_convmixer_patch_padding_is_flax_same():
    """23 x 23 at patch 10: flax pads to 30 (3 low, 4 high) for 3 x 3 patches."""
    jm, variables, tm, img = _convmixer_pair(23)
    with torch.no_grad():
        x = torch.from_numpy(img).permute(0, 3, 1, 2)
        got = tm.net[0](x)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(img), jnp.asarray(variables["params"]["patch_embed"]["kernel"]),
        (10, 10), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert got.shape == (6, CONV["dim"], 3, 3)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


class _TorchUpdateBN(BatchNorm):
    """``torch.nn.BatchNorm2d``'s own forward: in train mode it updates the
    running variance with the unbiased batch variance."""

    def forward(self, x, train=False):
        self.train(train)
        return nn.BatchNorm2d.forward(self, x)


def _three_steps(variables, plan, jdata, model):
    """Three train steps (float32, noise 0, no rotation, dropout 0, RAdam lr
    1e-3) on both stacks; returns the JAX state and the port's losses."""
    jmodel = JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False, **cfg_kwargs()))
    tx = jax_build_optimizer(lr=1e-3)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=variables["params"], tx=tx,
                                  batch_stats=variables["batch_stats"])
    run = jax_make_epoch_runner(jmodel, rotate_images=False, donate=False)
    jstate, want = run(jstate, jdata, jnp.asarray(plan), jax.random.PRNGKey(1))
    opt, _ = build_optimizer(model.named_parameters(), lr=1e-3)
    _, got = make_epoch_runner(model, rotate_images=False)(
        TrainState(model, opt), port_batch(), plan, torch.Generator())
    return jstate, want, got


def test_bn_running_stats_after_three_train_steps():
    """Every running mean and variance after three train steps within 5e-4
    of JAX's; with torch.nn.BatchNorm2d's update (unbiased variance, x 24/23
    at B = 6 on a 2 x 2 grid) the variances leave it."""
    _, variables, jdata = jax_setup()
    plan = np.array([[0, 1, 2, 3, 4, 5], [6, 7, 8, 9, 10, 11], [3, 5, 7, 9, 11, 1]])
    model = port_model(variables)
    jstate, want, got = _three_steps(variables, plan, jdata, model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=0)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                              jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    sd = model.state_dict()
    running = [k for k in sd if "running" in k]
    assert len(running) == 2 * (1 + 2 * CONV["depth"])
    for k in running:
        np.testing.assert_allclose(sd[k].numpy(), ref[k], rtol=5e-4, atol=5e-4, err_msg=k)
        assert not np.allclose(sd[k].numpy(), 0.0 if "mean" in k else 1.0), k
    assert all(int(sd[k]) == 3 for k in sd if k.endswith("num_batches_tracked"))

    plain = port_model(variables)
    for m in plain.modules():
        if isinstance(m, BatchNorm):
            m.__class__ = _TorchUpdateBN
    _three_steps(variables, plan, jdata, plain)
    psd = plain.state_dict()
    worst = max(float(np.abs(psd[k].numpy() - ref[k]).max() / np.abs(ref[k]).max())
                for k in running if "running_var" in k)
    assert worst > 5e-3, worst  # the plain update misses by the n / (n - 1) factor


# -- augmentation -----------------------------------------------------------------

@pytest.mark.parametrize("level_img", [0.0, 1.3])
def test_image_augmentation_with_handed_in_draws_matches_jax(level_img):
    """JAX's own uniforms and quarter turns, handed to the port: the noise
    range is level x the biased std of the whole batch, and the images
    rotate even at level 0."""
    jbatch = jax_make_synthetic_dataset(n=7, seed=2, modalities=TRI, **SYN).to_device()
    key = jax.random.PRNGKey(9)
    want = jax_augment.augment_batch(jbatch, key, noise_level_img=level_img,
                                     noise_level_mag=0.7)
    k_noise, k_rot, k_lc, k_sp = jax.random.split(key, 4)
    u = np.array(jax.random.uniform(k_noise, jbatch.x_img.shape, minval=-1.0, maxval=1.0))
    k = np.array(jax.random.randint(k_rot, (7,), 0, 4))
    normals = {"x_lc": torch.from_numpy(np.array(jax.random.normal(k_lc, jbatch.x_lc.shape))),
               "x_sp": torch.from_numpy(np.array(jax.random.normal(k_sp, jbatch.x_sp.shape)))}
    batch = make_synthetic_dataset(n=7, seed=2, modalities=TRI, **SYN).to_device("cpu")
    got = port_augment.augment_batch(batch, None, 0.7, normals, noise_level_img=level_img,
                                     img_uniform=torch.from_numpy(u),
                                     img_k=torch.from_numpy(k))
    for f in ("x_img", "x_lc", "x_sp"):
        np.testing.assert_allclose(got[f].numpy(), np.asarray(getattr(want, f)),
                                   rtol=2e-5, atol=2e-5, err_msg=f)
    assert set(k.tolist()) != {0}  # a real rotation was checked


def test_image_noise_uses_the_biased_std_and_rotation_is_rot90():
    img = torch.from_numpy(np.random.default_rng(0).random((4, 6, 6, 3), dtype=np.float32))
    u = torch.ones_like(img)
    got = port_augment.image_uniform_noise(img, 2.0, uniform=u)
    torch.testing.assert_close(got - img, torch.full_like(img, 2.0 * float(np.std(img.numpy()))))
    k = torch.tensor([0, 1, 2, 3])
    rot = port_augment.random_rot90(img, k=k)
    for i in range(4):
        np.testing.assert_array_equal(rot[i].numpy(), np.rot90(img[i].numpy(), i, axes=(0, 1)))
    a = port_augment.random_rot90(img, torch.Generator().manual_seed(1))
    b = port_augment.random_rot90(img, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        port_augment.random_rot90(img)


# -- whole models ---------------------------------------------------------------------

def _jax_loss(jmodel, variables, jbatch):
    """params -> (train-mode loss, aux), the batch statistics' update
    dropped (a model without BatchNorm has no batch_stats)."""

    def loss_of(p):
        v = dict(variables, params=p)
        if "batch_stats" not in v:
            return jmodel.apply(v, jbatch, train=True, method=jmodel.loss_fn)
        out, _ = jmodel.apply(v, jbatch, train=True, method=jmodel.loss_fn,
                              mutable=["batch_stats"])
        return out

    return loss_of


@pytest.mark.parametrize("combinations", [TRI, QUAD], ids=["trimodal", "quadrimodal"])
def test_encode_loss_and_grads_match_jax(combinations, same_positional_encoding):
    """Eval ``encode`` (1e-4), the train-mode contrastive loss (1e-4) over
    every pair and each parameter's gradient (5e-4); the image and meta
    embeddings are float32 unit vectors."""
    jmodel, variables, jdata = jax_setup(n=10, combinations=combinations)
    jbatch = jdata.take(jnp.arange(10))
    want = jmodel.apply(variables, jbatch, method=jmodel.encode)
    model = port_model(variables, combinations=combinations)
    batch = port_batch(n=10)
    with torch.no_grad():
        got = model.eval().encode(batch)
    assert len(got) == len(combinations)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (10, 8)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)

    (jloss, _), jgrads = jax.value_and_grad(_jax_loss(jmodel, variables, jbatch),
                                            has_aux=True)(variables["params"])
    model.train()
    loss, aux = model.loss_fn(batch, train=True, generator=torch.Generator())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    assert len(aux["embeddings"]) == len(combinations)
    want_grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                                     variables["batch_stats"])
    got_grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got_grads) == sorted(k for k in want_grads if "running" not in k
                                       and "num_batches" not in k)
    for name, g in got_grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[name], rtol=5e-4, atol=5e-4,
                                   err_msg=name)


def test_bf16_keeps_the_image_and_meta_towers_float32():
    _, variables, _ = jax_setup(n=8, combinations=QUAD)
    model = port_model(variables, combinations=QUAD, compute_dtype="bfloat16").eval()
    batch = port_batch(n=8)
    with torch.no_grad():
        img = model.image_encoder(batch["x_img"])
        meta = model.embed_meta(batch["label"], batch["redshift"], normalize=False)
        embs = model.encode(batch)
    assert img.dtype == meta.dtype == torch.float32
    assert [e.dtype for e in embs] == [torch.float32] * 4


HEADS = {
    "regression": dict(combinations=("lightcurve",), regression=True),
    "classification5": dict(combinations=TRI, classification=True, n_classes=5),
    "classification3": dict(combinations=("host_galaxy", "lightcurve"),
                            classification=True, n_classes=3),
}


@pytest.mark.parametrize("head", sorted(HEADS))
def test_supervised_loss_and_grads_match_jax(head, same_positional_encoding):
    """The head over the concatenated unnormalised embeddings: the eval
    output (1e-4), the train loss (MSE on redshift, or cross entropy with
    the reference's class weights) and its gradients (5e-4)."""
    kw = HEADS[head]
    jmodel, variables, jdata = jax_setup(n=10, **kw)
    jbatch = jdata.take(jnp.arange(10))
    if kw.get("n_classes") == 3:  # labels of the 3-way typing
        jbatch = jbatch.replace(label=jbatch.label % 3)
    model = port_model(variables, **kw)
    batch = port_batch(n=10)
    batch["label"] = torch.from_numpy(np.array(jbatch.label))
    want_out = jmodel.apply(variables, jbatch)
    with torch.no_grad():
        got_out = model.eval()(batch)
    assert got_out.shape == (10, model.cfg.head_out)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=1e-4, atol=1e-4)

    (jloss, jaux), jgrads = jax.value_and_grad(_jax_loss(jmodel, variables, jbatch),
                                               has_aux=True)(variables["params"])
    loss, aux = model.train().loss_fn(batch, train=True, generator=torch.Generator())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-5)
    key = "pred" if kw.get("regression") else "logits"
    np.testing.assert_allclose(_np(aux[key]), np.asarray(jaux[key]), rtol=1e-4, atol=1e-4)
    want_grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                                     variables.get("batch_stats"))
    for name, p in model.named_parameters():
        # the logit scale and bias, unused by a head, get no gradient (JAX: zeros)
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want_grads[name], rtol=5e-4, atol=5e-4,
                                   err_msg=name)
    if kw.get("classification"):
        np.testing.assert_array_equal(model.class_weights.numpy(),
                                      CLASS_WEIGHTS[kw["n_classes"]])


def test_state_dict_from_jax_equals_the_reference_export_with_towers():
    _, variables, _ = jax_setup(n=8, combinations=QUAD, classification=True)
    ours = state_dict_from_jax(variables["params"], variables["batch_stats"])
    ref = export_reference_state_dict(variables["params"], variables["batch_stats"])
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    with pytest.raises(ValueError, match="batch_stats"):
        state_dict_from_jax(variables["params"])


# -- task metrics -------------------------------------------------------------------

def test_compute_task_metrics_matches_jax_for_every_task():
    """Three modalities (AUC_val1..3 and their mean), regression R2_val and
    classification f1_val, from stacked (steps, B, ...) aux trimmed to
    n_val = 13 of 2 x 8."""
    rng = np.random.default_rng(4)
    ds = make_synthetic_dataset(n=13, seed=1, modalities=("lightcurve",), n_max_lc=4)
    jds = jax_make_synthetic_dataset(n=13, seed=1, modalities=("lightcurve",), n_max_lc=4)
    embs = [rng.normal(size=(2, 8, 6)).astype(np.float32) for _ in range(3)]
    cases = {
        "contrastive": {"embeddings": embs},
        "regression": {"pred": rng.normal(0.1, 0.05, size=(2, 8)).astype(np.float32)},
        "classification": {"logits": rng.normal(size=(2, 8, 5)).astype(np.float32)},
    }
    for task, aux in cases.items():
        want = jax_compute_task_metrics(task, aux, jds, 13, 5)
        got = compute_task_metrics(task, jax.tree_util.tree_map(torch.from_numpy, aux), ds,
                                   13, 5)
        assert sorted(got) == sorted(want), task
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert sorted(got) == ["f1_val"]
    assert sorted(compute_task_metrics(
        "contrastive", {"embeddings": [torch.from_numpy(e) for e in embs]}, ds, 13)) == [
        "AUC_val1", "AUC_val2", "AUC_val3", "AUC_val_mean"]


def test_convmixer_dropout_defaults_to_half_and_the_builder_passes_dropout():
    """``CLIPConfig.create`` without a ``dropout_prob`` gives the JAX
    ConvMixer's default 0.5; the config builder passes ``dropout``. Dropout
    moves train-mode outputs only."""
    from multimodal_supernovae_tpu_torch.config import build_clip_config

    model = CLIPModel(CLIPConfig.create(combinations=("host_galaxy", "spectral")))
    assert model.image_encoder.rate == 0.5 == JaxConvMixer.dropout_prob
    point = {"n_out": 8, "emb": 16, "heads": 2, "transformer_depth": 1, "dropout": 0.01}
    built = build_clip_config(point, {"combinations": ["host_galaxy", "lightcurve"]})
    assert CLIPModel(built).image_encoder.rate == 0.01
    tower = ConvMixer(**dict(CONV, dropout_prob=0.5))
    port_transformer.init_weights(tower, torch.Generator().manual_seed(0))
    img = torch.from_numpy(np.random.default_rng(1).random((4, 20, 20, 3), dtype=np.float32))
    with torch.no_grad():
        a, b = tower(img), tower(img)
        t1 = tower(img, train=True, generator=torch.Generator().manual_seed(0))
        t2 = tower(img, train=True, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(t1, t2)
