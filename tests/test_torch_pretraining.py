"""Masked light-curve pretraining in the port against the JAX package's, on
CPU, at a small size:

  * ``random_subset_mask`` and ``contiguous_span_mask`` bit-equal to JAX's
    on JAX's own uniforms, at f_mask 0.15 / 0.2 / 0.3 on full, ragged,
    empty-band and one-observation padding masks;
  * ``MaskedLightCurveEncoder`` on converted JAX weights: ``predict``,
    ``masked_pred`` and the loss within 2e-5, every parameter gradient
    within 5e-4 of its largest, on the same masks;
  * a 3-step masked epoch through the port's epoch runner against the JAX
    epoch runner (the masks' uniforms recomputed from JAX's key splits and
    handed to the port), per-step loss within relative 1e-4;
  * the StepLR lr at each optimizer step against optax's staircase;
  * ``fit(resume=True)`` of a masked run bitwise equal to the straight run;
  * the masked run directory: its sidecar read by the JAX package, the JAX
    package's ``load_model`` on it, and ``masked_reconstruction_mse``
    against JAX's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_supernovae_tpu.data import augment as jax_augment
from multimodal_supernovae_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic_dataset,
)
from multimodal_supernovae_tpu.evaluation.embeddings import (
    masked_reconstruction_mse as jax_masked_reconstruction_mse,
)
from multimodal_supernovae_tpu.models.factory import load_model as jax_load_model
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
from multimodal_supernovae_tpu.training.optim import build_optimizer as jax_build_optimizer
from multimodal_supernovae_tpu.training.state import TrainState as JaxTrainState
from multimodal_supernovae_tpu.training.step import (
    make_epoch_runner as jax_make_epoch_runner,
)
from multimodal_supernovae_tpu_torch.data import augment as port_augment
from multimodal_supernovae_tpu_torch.data import make_synthetic_dataset
from multimodal_supernovae_tpu_torch.evaluation import masked_reconstruction_mse
from multimodal_supernovae_tpu_torch.models import (
    MaskedEncoderConfig,
    MaskedLightCurveEncoder,
    load_model,
    read_model_config,
    state_dict_from_jax,
)
from multimodal_supernovae_tpu_torch.models import pretraining as port_pretraining
from multimodal_supernovae_tpu_torch.training import (
    Trainer,
    TrainerConfig,
    TrainState,
    build_optimizer,
    make_epoch_runner,
)
from tests.test_torch_towers import same_positional_encoding  # noqa: F401  (a fixture)

NBAND, BAND = 2, 10
SYN = dict(n_max_lc=BAND, nband=NBAND, n_max_sp=8, modalities=("lightcurve",))
TK = {"n_out": 1, "emb": 16, "heads": 2, "depth": 2, "time_norm": 500.0, "dropout": 0.0}


def _padding(case, b=6):
    """(B, NBAND * BAND) band-blocked padding masks, valid observations a
    prefix of each band block."""
    n_obs = {"full": [[BAND, BAND]] * b,
             "ragged": [[BAND - i, 3 + i] for i in range(b)],
             "empty band": [[0, 7 - i] for i in range(b)],
             "one observation": [[1, 1 + (i % 2)] for i in range(b)]}[case]
    pm = np.zeros((b, NBAND, BAND), bool)
    for i, counts in enumerate(n_obs):
        for band, n in enumerate(counts):
            pm[i, band, :n] = True
    return pm.reshape(b, NBAND * BAND)


@pytest.mark.parametrize("contiguous", [True, False], ids=["span", "subset"])
@pytest.mark.parametrize("case", ["full", "ragged", "empty band", "one observation"])
@pytest.mark.parametrize("f_mask", [0.15, 0.2, 0.3])
def test_masks_equal_jax_on_its_uniforms(f_mask, case, contiguous):
    pm = _padding(case)
    key = jax.random.PRNGKey(int(f_mask * 100) + len(case))
    if contiguous:
        want = jax_augment.contiguous_span_mask(jnp.asarray(pm), NBAND, f_mask, key)
        u = np.array(jax.random.uniform(key, (pm.shape[0], NBAND)))
        got = port_augment.contiguous_span_mask(torch.from_numpy(pm), NBAND, f_mask,
                                                uniform=torch.from_numpy(u))
    else:
        want = jax_augment.random_subset_mask(jnp.asarray(pm), f_mask, key)
        u = np.array(jax.random.uniform(key, pm.shape))
        got = port_augment.random_subset_mask(torch.from_numpy(pm), f_mask,
                                              uniform=torch.from_numpy(u))
    for g, w, name in zip(got, want, ("keep", "pred")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    keep, pred = (g.numpy() for g in got)
    assert not (keep & pred).any() and ((keep | pred) == pm).all()
    if case != "full" and not contiguous:  # a hidden count of int(n_obs * f_mask)
        np.testing.assert_array_equal(
            pred.sum(1), (pm.sum(1).astype(np.float32) * np.float32(f_mask)).astype(int))


def test_masks_draw_from_a_generator():
    pm = torch.from_numpy(_padding("ragged"))
    for fn in (lambda g: port_augment.contiguous_span_mask(pm, NBAND, 0.3, g),
               lambda g: port_augment.random_subset_mask(pm, 0.3, g)):
        a, b = fn(torch.Generator().manual_seed(3)), fn(torch.Generator().manual_seed(3))
        assert all(torch.equal(x, y) for x, y in zip(a, b)) and a[1].any()
        with pytest.raises(ValueError, match="generator"):
            fn(None)


def _jax_model(contiguous=True, f_mask=0.3, tk=TK):
    return JaxMaskedLightCurveEncoder(JaxMaskedEncoderConfig.create(
        f_mask=f_mask, nband=NBAND, contiguous=contiguous, transformer_kwargs=tk))


def _port_model(params, contiguous=True, f_mask=0.3, tk=TK):
    model = MaskedLightCurveEncoder(MaskedEncoderConfig.create(
        f_mask=f_mask, nband=NBAND, contiguous=contiguous, transformer_kwargs=tk))
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), n_out=tk["n_out"])
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return model


def _datasets(n=12, seed=0):
    kw = dict(n=n, seed=seed, **SYN)
    return make_synthetic_dataset(**kw), jax_make_synthetic_dataset(**kw)


def _mask_uniform(key, b, t, contiguous):
    return np.array(jax.random.uniform(key, (b, NBAND) if contiguous else (b, t)))


@pytest.mark.parametrize("contiguous", [True, False], ids=["span", "subset"])
def test_masked_model_matches_jax(contiguous, same_positional_encoding):
    ds, jds = _datasets()
    jbatch = jds.to_device()
    jmodel = _jax_model(contiguous)
    variables = jmodel.init(jax.random.PRNGKey(0), jbatch)
    model = _port_model(variables["params"], contiguous)
    batch = ds.to_device("cpu")
    key = jax.random.PRNGKey(5)
    b, t = batch["x_lc"].shape
    u = torch.from_numpy(_mask_uniform(key, b, t, contiguous))

    want_pred = jmodel.apply(variables, jbatch.x_lc, jbatch.t_lc, jbatch.mask_lc,
                             method=jmodel.predict)
    got_pred = model.predict(batch["x_lc"], batch["t_lc"], batch["mask_lc"])
    np.testing.assert_allclose(got_pred.detach().numpy(), np.asarray(want_pred), atol=2e-5)
    want = jmodel.apply(variables, jbatch.x_lc, jbatch.t_lc, jbatch.mask_lc, key,
                        method=jmodel.masked_pred)
    got = model.masked_pred(batch["x_lc"], batch["t_lc"], batch["mask_lc"], uniform=u)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].any()
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=2e-5)

    def jax_loss(params):
        return jmodel.apply({"params": params}, jbatch, train=True, key=key,
                            method=jmodel.loss_fn, rngs={"dropout": jax.random.PRNGKey(1)})[0]

    want_loss, want_grads = jax.value_and_grad(jax_loss)(variables["params"])
    loss, aux = model.loss_fn(batch, train=True, uniform=u)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(aux["mask_pred"].numpy(), np.asarray(want[2]))
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want_grads), n_out=1)
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert sorted(grads) == sorted(k for k in ref if not k.startswith("net.projection."))
    assert model.net.projection.weight.grad is None  # the dead layer is never called
    for name, g in grads.items():
        scale = max(float(np.abs(ref[name]).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), ref[name], atol=5e-4 * scale, err_msg=name)


def test_masked_loss_needs_a_draw():
    model = MaskedLightCurveEncoder(MaskedEncoderConfig.create(nband=NBAND, transformer_kwargs=TK))
    batch = _datasets()[0].to_device("cpu")
    with pytest.raises(ValueError, match="generator"):
        model.loss_fn(batch)
    a, _ = model.loss_fn(batch, generator=torch.Generator().manual_seed(0))
    b, _ = model.loss_fn(batch, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.isfinite(a)
    # the dead projection keys: zeros of (n_out, emb), as the JAX exporter writes
    sd = model.state_dict()
    assert sd["net.projection.weight"].shape == (1, TK["emb"])
    assert not sd["net.projection.weight"].any() and not sd["net.projection.bias"].any()


def test_masked_epoch_matches_jax_epoch_runner(monkeypatch, same_positional_encoding):
    """3 steps of masked pretraining (StepLR halving every step, noise off,
    dropout 0) through both epoch runners from the same weights. JAX draws
    each step's mask from key splits (run_epoch: ``key, sub = split(key)``;
    the train step: ``aug, dropout, loss = split(sub, 3)``; the span's
    uniform from the loss key); the port takes those uniforms."""
    ds, jds = _datasets(n=24, seed=1)
    jdata = jds.to_device()
    jmodel = _jax_model()
    params = jmodel.init(jax.random.PRNGKey(2), jdata.take(jnp.arange(8)))["params"]
    model = _port_model(params)
    plan = np.arange(24, dtype=np.int32).reshape(3, 8)[::-1].copy()
    key = jax.random.PRNGKey(7)

    tx = jax_build_optimizer(lr=3e-3, step_size=1, gamma=0.5, steps_per_epoch=1)
    state = JaxTrainState.create(apply_fn=jmodel.apply, params=params, tx=tx)
    _, want = jax_make_epoch_runner(jmodel, noise_level_mag=0.0)(
        state, jdata, jnp.asarray(plan), key)

    draws, k = [], key
    for _ in range(len(plan)):
        k, sub = jax.random.split(k)
        loss_key = jax.random.split(sub, 3)[2]
        draws.append(torch.from_numpy(_mask_uniform(loss_key, 8, 2 * BAND, True)))
    real = port_augment.contiguous_span_mask

    def handed(pm, nband, f_mask, generator=None, uniform=None):
        assert uniform is None
        return real(pm, nband, f_mask, uniform=draws.pop(0))

    monkeypatch.setattr(port_pretraining, "contiguous_span_mask", handed)
    opt, sched = build_optimizer(model.named_parameters(), lr=3e-3, step_size=1, gamma=0.5,
                                 steps_per_epoch=1)
    _, got = make_epoch_runner(model)(TrainState(model, opt, sched), ds.to_device("cpu"),
                                      plan, torch.Generator())
    assert not draws
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=0)


@pytest.mark.parametrize("step_size,gamma,steps_per_epoch", [(2, 0.1, 3), (2, 0.1, 1),
                                                             (1, 0.5, 4)])
def test_steplr_matches_optax_staircase(step_size, gamma, steps_per_epoch):
    """The lr of each optimizer step: torch's StepLR on optimizer steps
    against ``optax.exponential_decay(staircase=True)``, which the JAX
    package builds (config_grid.yaml's point: step_size 2, gamma 0.1)."""
    lr = 5e-4
    param = torch.nn.Parameter(torch.zeros(1))
    opt, sched = build_optimizer([("w", param)], lr=lr, step_size=step_size, gamma=gamma,
                                 steps_per_epoch=steps_per_epoch)
    schedule = optax.exponential_decay(init_value=lr,
                                       transition_steps=step_size * steps_per_epoch,
                                       decay_rate=gamma, staircase=True)
    n = 4 * step_size * steps_per_epoch
    got = []
    for _ in range(n):
        got.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    want = [float(schedule(i)) for i in range(n)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[step_size * steps_per_epoch] == pytest.approx(lr * gamma, rel=1e-6)


def _masked_fit(run_dir, epochs, resume=False, n=40):
    """A masked run with every draw on: magnitude noise, dropout, masks, the
    StepLR staircase."""
    tk = dict(TK, dropout=0.1)
    model = MaskedLightCurveEncoder(MaskedEncoderConfig.create(
        f_mask=0.2, nband=NBAND, transformer_kwargs=tk), torch.Generator().manual_seed(0))
    ds = make_synthetic_dataset(n=n, seed=3, **SYN)
    train, val = ds.subset(np.arange(n - 8)), ds.subset(np.arange(n - 8, n))
    tcfg = TrainerConfig(epochs=epochs, batch_size=8, lr=3e-3, noise_level_mag=1.0,
                         step_size=1, gamma=0.5, seed=0)
    trainer = Trainer(model, "masked", tcfg, run_dir=run_dir)
    return trainer, trainer.fit(train, val, resume=resume), val


def test_masked_resume_is_bitwise(tmp_path):
    """3 epochs straight against 2, then a new model and Trainer resumed to
    3: every tensor of the state_dict, the optimizer's and the scheduler's
    state and the metric rows equal."""
    straight = str(tmp_path / "straight")
    _, a, _ = _masked_fit(straight, 3)
    split = str(tmp_path / "split")
    _masked_fit(split, 2)
    _, b, _ = _masked_fit(split, 3, resume=True)
    assert [r["epoch"] for r in b["metric_rows"]] == [0, 1, 2]
    for ra, rb in zip(a["metric_rows"], b["metric_rows"]):
        for k in ("train_loss", "val_loss"):
            assert ra[k] == rb[k], k
    sa, sb = a["state"], b["state"]
    for k, v in sa.model.state_dict().items():
        assert torch.equal(v, sb.model.state_dict()[k]), k
    assert sa.scheduler.state_dict() == sb.scheduler.state_dict()
    assert sa.optimizer.param_groups[0]["lr"] == sb.optimizer.param_groups[0]["lr"]
    for ka, kb in zip(sa.optimizer.state.values(), sb.optimizer.state.values()):
        assert all(torch.equal(ka[s], kb[s]) for s in ka)
    ca = torch.load(os.path.join(straight, "last.ckpt"), weights_only=True)
    cb = torch.load(os.path.join(split, "last.ckpt"), weights_only=True)
    timing = ("step_time_s", "samples_per_s")
    assert ({k: v for k, v in ca["metrics"].items() if k not in timing}
            == {k: v for k, v in cb["metrics"].items() if k not in timing})
    assert ca["global_step"] == cb["global_step"] == 3 * 4


def test_masked_trainer_reports_val_loss_only(tmp_path):
    trainer, out, _ = _masked_fit(str(tmp_path / "run"), 2)
    assert (trainer.monitor, trainer.mode) == ("val_loss", "min")
    for row in out["metric_rows"]:
        assert set(row) == {"epoch", "train_loss", "step_time_s", "samples_per_s",
                            "val_loss"}
        assert np.isfinite(row["val_loss"]) and row["val_loss"] > 0
    # the lr fell by gamma each epoch (4 steps an epoch)
    assert out["state"].optimizer.param_groups[0]["lr"] == pytest.approx(3e-3 * 0.25)


def test_masked_run_dir_across_packages(tmp_path):
    """A port masked run dir: its sidecar read by both packages to the same
    config; a JAX-written sidecar read by the port; ``load_model`` of both
    packages on it and ``masked_reconstruction_mse`` of each within 1e-5 on
    JAX's per-batch draws; the port's on a generator equal to the in-memory
    model's."""
    run_dir = str(tmp_path / "run")
    trainer, out, val = _masked_fit(run_dir, 2)
    cfg, extra = read_model_config(run_dir)
    jmodel, jextra = jax_read_model_config(run_dir)
    assert extra == jextra == {"combinations": ["lightcurve"], "nband": NBAND}
    assert cfg == MaskedEncoderConfig(**{k: getattr(jmodel.cfg, k) for k in
                                         ("f_mask", "nband", "contiguous",
                                          "transformer_kwargs")})
    jax_dir = str(tmp_path / "jax")
    os.makedirs(jax_dir)
    jax_write_model_config(jax_dir, _jax_model(contiguous=False, f_mask=0.15))
    jcfg, jextra = read_model_config(jax_dir)
    assert jcfg == MaskedEncoderConfig.create(f_mask=0.15, nband=NBAND, contiguous=False,
                                              transformer_kwargs=TK)
    with open(os.path.join(jax_dir, "model_config.json")) as f:
        assert jextra == json.load(f)["extra"]

    model, _ = load_model(run_dir, device="cpu", which="last")
    for k, v in out["state"].model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    jval = jax_make_synthetic_dataset(n=40, seed=3, **SYN).subset(np.arange(32, 40))
    jm, variables, *_ = jax_load_model(run_dir, jval.host_batch(np.arange(4)), which="last")
    key = jax.random.PRNGKey(11)
    want = jax_masked_reconstruction_mse(jm, variables, jval, key, batch_size=4)
    draws, k = [], key
    for _ in range(2):
        k, sub = jax.random.split(k)
        draws.append(torch.from_numpy(_mask_uniform(sub, 4, 2 * BAND, True)))
    got = masked_reconstruction_mse(model, val, uniforms=draws, batch_size=4, device="cpu")
    assert got.shape == (8,) and (got > 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    gen_a = masked_reconstruction_mse(model, val, torch.Generator().manual_seed(0),
                                      batch_size=4, device="cpu")
    gen_b = masked_reconstruction_mse(out["state"].model, val,
                                      torch.Generator().manual_seed(0), batch_size=4,
                                      device="cpu")
    np.testing.assert_array_equal(gen_a, gen_b)
    with pytest.raises(ValueError, match="uniforms"):
        masked_reconstruction_mse(model, val, uniforms=draws[:1], batch_size=4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            masked_reconstruction_mse(model, val, torch.Generator())
