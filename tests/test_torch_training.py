"""The port's training slice against the JAX package's, on CPU, at a small
size: batching and index plans, augmentation with injected noise, the
optimizer, the CLIP loss and its parameter gradients, the train loop's loss
trajectory from the same weights, the trainer, and dropout.

Tolerances: float32 2e-5 for single ops, 1e-4 for the whole model's loss,
5e-4 for parameter gradients, 1e-5 for optimizer updates (RAdam in two
frameworks, a few steps), relative 1e-4 per step for the 20-step loss
trajectory (summation order in XLA and torch drifts over the steps).
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from multimodal_supernovae_tpu.data import augment as jax_augment
from multimodal_supernovae_tpu.data.batching import (
    epoch_indices as jax_epoch_indices,
    tail_valid_mask as jax_tail_valid_mask,
)
from multimodal_supernovae_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic_dataset,
)
from multimodal_supernovae_tpu.models import CLIPConfig as JaxCLIPConfig
from multimodal_supernovae_tpu.models import CLIPModel as JaxCLIPModel
from multimodal_supernovae_tpu.training.optim import build_optimizer as jax_build_optimizer
from multimodal_supernovae_tpu.training.state import TrainState as JaxTrainState
from multimodal_supernovae_tpu.training.step import (
    make_epoch_runner as jax_make_epoch_runner,
)
from multimodal_supernovae_tpu_torch.data import (
    ArrayDataset,
    augment_batch,
    epoch_indices,
    make_synthetic_dataset,
    noise_from_error,
    tail_valid_mask,
    take,
)
from multimodal_supernovae_tpu_torch.models import (
    CLIPConfig,
    CLIPModel,
    MaskedEncoderConfig,
    MaskedLightCurveEncoder,
    state_dict_from_jax,
)
from multimodal_supernovae_tpu_torch.models.transformer import dropout
from multimodal_supernovae_tpu_torch.training import (
    Trainer,
    TrainerConfig,
    TrainState,
    build_optimizer,
    freeze_encoder_except_projection,
    freeze_mask,
    make_epoch_runner,
    make_eval_runner,
)

SYN = dict(n_max_lc=12, nband=2, n_max_sp=20)


def small_cfg_kwargs(loss="softmax", dropout_rate=0.0):
    lc = {"n_out": 8, "emb": 16, "heads": 2, "depth": 2, "time_norm": 2000.0,
          "agg": "attn", "dropout": dropout_rate}
    sp = {"n_out": 8, "emb": 16, "heads": 2, "depth": 2, "time_norm": 1800.0,
          "agg": "mean", "dropout": dropout_rate}
    return dict(combinations=("lightcurve", "spectral"), enc_dim=8, nband=2,
                logit_scale_init=19.55, loss=loss, transformer_kwargs=lc,
                transformer_spectral_kwargs=sp)


def jax_setup(loss="softmax", n=48, seed=0):
    model = JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False, **small_cfg_kwargs(loss)))
    data = jax_make_synthetic_dataset(n=n, seed=seed, **SYN).to_device()
    params = model.init(jax.random.PRNGKey(seed), data.take(jnp.arange(8)))["params"]
    return model, params, data


def torch_model_from(params, loss="softmax", dropout_rate=0.0):
    model = CLIPModel(CLIPConfig.create(**small_cfg_kwargs(loss, dropout_rate)))
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           state_dict_from_jax(params).items()}, strict=True)
    return model


# -- batching -----------------------------------------------------------------

@pytest.mark.parametrize("n,b", [(50, 16), (16, 16), (5, 12), (0, 4)])
@pytest.mark.parametrize("pad", ["wrap", "repeat_last", "drop"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_indices_match_jax(n, b, pad, shuffle):
    got = epoch_indices(n, b, rng=np.random.default_rng(3), shuffle=shuffle, pad=pad)
    want = jax_epoch_indices(n, b, rng=np.random.default_rng(3), shuffle=shuffle, pad=pad)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tail_valid_mask(n, b), jax_tail_valid_mask(n, b))


def test_dataset_take_and_subsets_match_jax():
    ds = make_synthetic_dataset(n=20, seed=2, **SYN)
    jds = jax_make_synthetic_dataset(n=20, seed=2, **SYN)
    assert ds.filenames == jds.filenames
    idx = np.array([3, 3, 0, 19, 7], np.int32)
    got = take(ds.to_device("cpu"), torch.from_numpy(idx))
    want = jds.to_device().take(jnp.asarray(idx))
    assert sorted(got) == sorted(k for k in ds.arrays)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(want, k)), err_msg=k)
    sub, jsub = ds.subset([4, 1]), jds.subset(np.array([4, 1]))
    assert sub.filenames == jsub.filenames == ["ZTFSYN000004", "ZTFSYN000001"]
    assert len(sub) == 2
    for k, v in sub.arrays.items():
        np.testing.assert_array_equal(v, jsub.arrays[k], err_msg=k)
    with pytest.raises(ValueError, match="unknown batch fields"):
        ArrayDataset({"x_lc": np.zeros(3), "bogus": np.zeros(3)})
    with pytest.raises(ValueError, match="inconsistent lengths"):
        ArrayDataset({"x_lc": np.zeros(3), "x_sp": np.zeros(4)})


# -- augmentation ---------------------------------------------------------------

def test_augment_batch_with_injected_noise_matches_jax():
    """The JAX augmentation's own standard-normal draws, handed to the port."""
    jds = jax_make_synthetic_dataset(n=6, seed=4, **SYN)
    jbatch = jds.to_device()
    key = jax.random.PRNGKey(5)
    want = jax_augment.augment_batch(jbatch, key, noise_level_mag=1.3)
    _, _, k_lc, k_sp = jax.random.split(key, 4)
    normals = {"x_lc": np.array(jax.random.normal(k_lc, jbatch.x_lc.shape)),
               "x_sp": np.array(jax.random.normal(k_sp, jbatch.x_sp.shape))}
    batch = make_synthetic_dataset(n=6, seed=4, **SYN).to_device("cpu")
    got = augment_batch(batch, noise_level_mag=1.3,
                        normals={k: torch.from_numpy(v) for k, v in normals.items()})
    for k in ("x_lc", "x_sp"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(getattr(want, k)),
                                   rtol=2e-5, atol=2e-5, err_msg=k)
        assert not np.array_equal(got[k].numpy(), batch[k].numpy())
    for k in ("t_lc", "mask_sp", "err_lc"):
        assert got[k] is batch[k]
    one = noise_from_error(batch["x_lc"], batch["err_lc"], 1.3,
                           normal=torch.from_numpy(normals["x_lc"]))
    torch.testing.assert_close(one, got["x_lc"], rtol=0, atol=0)


def test_augment_batch_draws_from_the_generator():
    batch = make_synthetic_dataset(n=4, seed=1, **SYN).to_device("cpu")
    assert augment_batch(batch, None)["x_lc"] is batch["x_lc"]  # level 0
    a = augment_batch(batch, torch.Generator().manual_seed(7), noise_level_mag=1.0)
    b = augment_batch(batch, torch.Generator().manual_seed(7), noise_level_mag=1.0)
    c = augment_batch(batch, torch.Generator().manual_seed(8), noise_level_mag=1.0)
    torch.testing.assert_close(a["x_sp"], b["x_sp"], rtol=0, atol=0)
    assert not torch.equal(a["x_sp"], c["x_sp"])
    # images rotate by default, at noise level 0 too, with turns drawn from
    # the generator (none given: it raises)
    img = {"x_img": torch.arange(2 * 4 * 4 * 3, dtype=torch.float32).reshape(2, 4, 4, 3)}
    r1 = augment_batch(img, torch.Generator().manual_seed(7))["x_img"]
    r2 = augment_batch(img, torch.Generator().manual_seed(7))["x_img"]
    torch.testing.assert_close(r1, r2, rtol=0, atol=0)
    assert augment_batch(img, None, rotate_images=False)["x_img"] is img["x_img"]
    with pytest.raises(ValueError, match="generator"):
        augment_batch(img, None)


# -- optimizer --------------------------------------------------------------------

class _Tree(nn.Module):
    """Parameters at the paths the freeze predicates look at."""

    def __init__(self, arrays):
        super().__init__()
        self.lightcurve_encoder = nn.ModuleDict({
            "projection": nn.ParameterDict({"kernel": nn.Parameter(torch.tensor(arrays[0]))}),
            "transformer": nn.ParameterDict({"w": nn.Parameter(torch.tensor(arrays[1]))}),
        })
        self.spectral_projection = nn.ParameterDict(
            {"bias": nn.Parameter(torch.tensor(arrays[2]))})


@pytest.mark.parametrize("freeze", [False, True])
def test_build_optimizer_matches_optax(freeze):
    """RAdam with L2 decay and a StepLR staircase (step_size 1 epoch of 3
    steps, gamma 0.5), optionally freezing the light-curve encoder but its
    projection, against the JAX optimizer over 12 steps of the same grads."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(12)]
    pred = freeze_encoder_except_projection("lightcurve_encoder") if freeze else None
    kw = dict(lr=0.01, weight_decay=0.1, step_size=1, gamma=0.5, steps_per_epoch=3,
              freeze=pred)

    def jtree(xs):
        return {"lightcurve_encoder": {"projection": {"kernel": jnp.asarray(xs[0])},
                                       "transformer": {"w": jnp.asarray(xs[1])}},
                "spectral_projection": {"bias": jnp.asarray(xs[2])}}

    jparams = jtree(p0)
    tx = jax_build_optimizer(params=jparams, **kw)
    jstate = tx.init(jparams)
    tree = _Tree(p0)
    names = ["lightcurve_encoder.projection.kernel", "lightcurve_encoder.transformer.w",
             "spectral_projection.bias"]
    opt, sched = build_optimizer(tree.named_parameters(), **kw)
    if freeze:
        assert freeze_mask(tree.named_parameters(), pred) == {
            names[0]: "train", names[1]: "frozen", names[2]: "train"}
    params = dict(tree.named_parameters())
    for g in grads:
        upd, jstate = tx.update(jtree(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for name, gi in zip(names, g):
            params[name].grad = torch.tensor(gi)
        opt.step()
        sched.step()
        want = [jparams["lightcurve_encoder"]["projection"]["kernel"],
                jparams["lightcurve_encoder"]["transformer"]["w"],
                jparams["spectral_projection"]["bias"]]
        for name, w in zip(names, want):
            np.testing.assert_allclose(params[name].detach().numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    assert opt.param_groups[0]["lr"] == pytest.approx(0.01 * 0.5 ** 4)
    if freeze:
        np.testing.assert_array_equal(params[names[1]].detach().numpy(), p0[1])


# -- model loss and gradients --------------------------------------------------------

@pytest.mark.parametrize("loss", ["softmax", "sigmoid"])
def test_loss_fn_and_param_grads_match_jax(loss):
    jmodel, params, data = jax_setup(loss, n=10)
    jbatch = data.take(jnp.arange(10))

    def loss_of(p):
        return jmodel.apply({"params": p}, jbatch, train=True, method=jmodel.loss_fn)

    (want, jaux), jgrads = jax.value_and_grad(loss_of, has_aux=True)(params)
    model = torch_model_from(params, loss)
    batch = make_synthetic_dataset(n=10, seed=0, **SYN).to_device("cpu")
    got, aux = model.loss_fn(batch, train=True, generator=torch.Generator())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=1e-4)
    for g, w in zip(aux["embeddings"], jaux["embeddings"]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    want_grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    got_grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got_grads) == sorted(want_grads)
    for name, w in want_grads.items():
        np.testing.assert_allclose(got_grads[name].numpy(), w, rtol=5e-4, atol=5e-4,
                                   err_msg=name)


def test_train_trajectory_tracks_jax_epoch_runner():
    """20 train steps (float32, dropout 0, noise 0, RAdam lr 1e-3) from the
    same weights over the same index plan: the per-step losses agree to
    relative 1e-4, and the loss falls."""
    jmodel, params, jdata = jax_setup(n=48)
    plan = np.concatenate([
        epoch_indices(48, 16, rng=np.random.default_rng(e), shuffle=True, pad="wrap")
        for e in range(7)])[:20]
    tx = jax_build_optimizer(lr=1e-3)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=params, tx=tx)
    run = jax_make_epoch_runner(jmodel, noise_level_mag=0.0, donate=False)
    _, want = run(jstate, jdata, jnp.asarray(plan), jax.random.PRNGKey(1))

    model = torch_model_from(params)
    opt, sched = build_optimizer(model.named_parameters(), lr=1e-3)
    state = TrainState(model, opt, sched)
    data = make_synthetic_dataset(n=48, seed=0, **SYN).to_device("cpu")
    state, got = make_epoch_runner(model)(state, data, plan, torch.Generator())
    assert state.step == 20 and got.shape == (20,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=0)
    assert got[-5:].mean() < got[:5].mean()


def test_eval_runner_stacks_embeddings_without_grads():
    _, params, _ = jax_setup(n=8)
    model = torch_model_from(params)
    opt, _ = build_optimizer(model.named_parameters(), lr=1e-3)
    data = make_synthetic_dataset(n=20, seed=3, **SYN).to_device("cpu")
    plan = epoch_indices(20, 8, shuffle=False, pad="repeat_last")
    losses, aux = make_eval_runner(model)(TrainState(model, opt), data, plan)
    assert losses.shape == (3,) and not losses.requires_grad
    assert [e.shape for e in aux["embeddings"]] == [(3, 8, 8), (3, 8, 8)]
    with torch.no_grad():
        first, _ = model.loss_fn(take(data, torch.from_numpy(plan[0])))
    torch.testing.assert_close(losses[0], first)


# -- trainer ---------------------------------------------------------------------------

def test_trainer_fit_reports_per_epoch_metrics():
    model = CLIPModel(CLIPConfig.create(**small_cfg_kwargs()),
                      generator=torch.Generator().manual_seed(0))
    ds = make_synthetic_dataset(n=40, seed=0, **SYN)
    trainer = Trainer(model, "contrastive", TrainerConfig(
        epochs=3, batch_size=16, lr=1e-3, noise_level_mag=1.0))
    out = trainer.fit(ds.subset(np.arange(28)), ds.subset(np.arange(28, 40)))
    assert out["epochs_run"] == 3 and len(out["metric_rows"]) == 3
    assert out["state"].step == 3 * 2  # two wrapped batches of 16 per epoch
    for row in out["metric_rows"]:
        for key in ("train_loss", "val_loss", "AUC_val", "step_time_s", "samples_per_s"):
            assert np.isfinite(row[key]), key
        assert 0.0 <= row["AUC_val"] <= 1.0
    assert out["history"]["val_loss"] == [r["val_loss"] for r in out["metric_rows"]]
    assert out["best"]["value"] == min(out["history"]["val_loss"])


def test_trainer_stops_early_and_aborts_on_non_finite_loss():
    model = CLIPModel(CLIPConfig.create(**small_cfg_kwargs()),
                      generator=torch.Generator().manual_seed(1))
    ds = make_synthetic_dataset(n=24, seed=1, **SYN)
    trainer = Trainer(model, "contrastive", TrainerConfig(
        epochs=20, batch_size=8, lr=1e-3, patience=1))
    out = trainer.fit(ds.subset(np.arange(16)), ds.subset(np.arange(16, 24)))
    assert out["epochs_run"] < 20 or out["best"]["epoch"] == 19
    with torch.no_grad():
        model.logit_scale.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite"):
        Trainer(model, "contrastive", TrainerConfig(epochs=1, batch_size=8)).fit(
            ds.subset(np.arange(16)), ds.subset(np.arange(16, 24)))


@pytest.mark.parametrize("kw,match", [
    ({"task": "classification"}, None),
    ({"task": "masked"}, None),
    pytest.param({"mesh": "model axis 2"}, "item 15", id="kw2-item 15"),
    ({"task": "regression"}, None),
])
def test_trainer_raises_for_what_is_not_ported(kw, match):
    """A model axis of 2 over one process raises the JAX package's words
    (item 15d ported it: tests/test_torch_tp.py trains it over 2 ranks, the
    data axis is tests/test_torch_dp.py's); the supervised and masked tasks are ported: one
    epoch of each reports its metric (f1_val, monitored for the maximum, or
    R2_val), a MaskedLightCurveEncoder the validation loss only."""
    task = kw.get("task")
    if task == "masked":
        model = MaskedLightCurveEncoder(MaskedEncoderConfig.create(
            nband=2, transformer_kwargs={"emb": 16, "heads": 2, "depth": 1}))
    else:
        model = CLIPModel(CLIPConfig.create(**small_cfg_kwargs(),
                                            regression=task == "regression",
                                            classification=task == "classification"))
    args = dict(task="contrastive", cfg=TrainerConfig(epochs=1, batch_size=8))
    args.update(kw)
    ds = make_synthetic_dataset(n=8, seed=0, **SYN)
    if match is not None:
        from multimodal_supernovae_tpu_torch.parallel import make_mesh

        with pytest.raises(ValueError, match="1 devices not divisible by model axis 2"):
            Trainer(model, **dict(args, mesh=make_mesh(n_model=2))).fit(ds, ds)
        return
    trainer = Trainer(model, **args)
    row = trainer.fit(ds, ds)["metric_rows"][0]
    if task == "masked":
        assert set(row) == {"epoch", "train_loss", "step_time_s", "samples_per_s",
                            "val_loss"} and np.isfinite(row["val_loss"])
        assert (trainer.monitor, trainer.mode) == ("val_loss", "min")
        return
    metric = {"classification": "f1_val", "regression": "R2_val"}[task]
    assert np.isfinite(row[metric]) and np.isfinite(row["val_loss"])
    assert (trainer.monitor, trainer.mode) == (
        ("f1_val", "max") if task == "classification" else ("val_loss", "min"))


def test_trainer_resume_and_fit_sharded_raise():
    """Resume needs a run directory (tests/test_torch_checkpoint.py resumes
    one), in fit and in the streaming fit
    (tests/test_torch_streaming.py trains it); the streaming fit over a mesh
    (item 17c, ported: tests/test_torch_stream_dp.py) needs data ranks that
    divide the batch, as fit does."""
    from multimodal_supernovae_tpu_torch.parallel.mesh import DataMesh

    trainer = Trainer(CLIPModel(CLIPConfig.create(**small_cfg_kwargs())), "contrastive",
                      TrainerConfig(epochs=1))
    ds = make_synthetic_dataset(n=8, seed=0, **SYN)
    with pytest.raises(ValueError, match="run_dir"):
        trainer.fit(ds, ds, resume=True)
    with pytest.raises(ValueError, match="run_dir"):
        trainer.fit_sharded(ds, ds, resume=True)
    trainer.mesh = DataMesh(0, 3)
    with pytest.raises(ValueError, match=r"global batch 32 is not divisible by the data "
                                         r"mesh axis \(3\)"):
        trainer.fit_sharded(ds, ds)


# -- dropout ---------------------------------------------------------------------------

def test_dropout_changes_train_outputs_only():
    _, params, _ = jax_setup(n=8)
    model = torch_model_from(params, dropout_rate=0.1)
    plain = torch_model_from(params)
    batch = make_synthetic_dataset(n=8, seed=5, **SYN).to_device("cpu")
    with torch.no_grad():
        eval_out = model.encode(batch)
        for a, b in zip(eval_out, plain.encode(batch)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        # no generator is needed in eval mode, and train mode without dropout
        # is eval mode
        for a, b in zip(plain.encode(batch, train=True), eval_out):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        t1 = model.encode(batch, train=True, generator=torch.Generator().manual_seed(0))
        t2 = model.encode(batch, train=True, generator=torch.Generator().manual_seed(0))
        t3 = model.encode(batch, train=True, generator=torch.Generator().manual_seed(1))
    for a, b, c, e in zip(t1, t2, t3, eval_out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.allclose(a, e) and not torch.allclose(a, c)
    with pytest.raises(ValueError, match="Generator"):
        model.encode(batch, train=True)


def test_dropout_matches_flax_semantics():
    """flax nn.Dropout: keep with probability 1 - rate, scale by 1/(1 - rate)."""
    x = torch.full((200, 100), 3.0)
    y = dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 4.0))
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert dropout(x, 0.25, False, None) is x and dropout(x, 0.0, True, None) is x
    assert torch.count_nonzero(dropout(x, 1.0, True, torch.Generator())) == 0
    xb = x.bfloat16()
    assert dropout(xb, 0.5, True, torch.Generator()).dtype == torch.bfloat16
