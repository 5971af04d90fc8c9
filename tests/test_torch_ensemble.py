"""The port's stacked ensemble training (training/ensemble.py) on CPU, at a
small size, mirroring tests/test_ensemble.py case by case:

  * against the port's own sequential ``Trainer.fit`` of each member, with
    dropout 0.1 and magnitude noise 1.0 (and, trimodal, image noise and
    rotations), so that every draw goes through the members' generators and
    the draw source: losses within 1e-5, parameters within atol 3e-4 / rtol
    1e-3 (the JAX test's tolerances: vmap batches every reduction, so the
    sums reassociate);
  * against the JAX package at dropout 0 and noise 0 (the two stacks' random
    numbers differ): ``fit_members`` from the same weights, per-epoch losses
    within relative 1e-4; the member plans bitwise; the stacked RAdam
    against ``build_member_lr_optimizer`` and ``torch.optim.RAdam``; the
    parallel sweeps' run dirs, config dumps and split manifests;
  * the flash kernels' vmap rule, with the launch functions replaced by
    their plain versions (the kernels themselves are held on the card by
    chip_smoke.py's phase ensemble); the fused kernels' vmap rules are
    tests/test_torch_fused_vmap.py's.
"""

import copy
import json
import os
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from multimodal_supernovae_tpu.config import load_sweep as jax_load_sweep
from multimodal_supernovae_tpu.data.folds import stratified_kfolds as jax_kfolds
from multimodal_supernovae_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic_dataset,
)
from multimodal_supernovae_tpu.models import CLIPConfig as JaxCLIPConfig
from multimodal_supernovae_tpu.models import CLIPModel as JaxCLIPModel
from multimodal_supernovae_tpu.training.ensemble import Member as JaxMember
from multimodal_supernovae_tpu.training.ensemble import (
    build_member_lr_optimizer as jax_build_member_lr_optimizer,
)
from multimodal_supernovae_tpu.training.ensemble import fit_members as jax_fit_members
from multimodal_supernovae_tpu.training.ensemble import member_train_plan as jax_train_plan
from multimodal_supernovae_tpu.training.ensemble import member_val_plan as jax_val_plan
from multimodal_supernovae_tpu.training.experiment import make_sweep_dir as jax_make_sweep_dir
from multimodal_supernovae_tpu.training.experiment import run_sweep as jax_run_sweep
from multimodal_supernovae_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from multimodal_supernovae_tpu_torch.config import load_sweep
from multimodal_supernovae_tpu_torch.data import make_synthetic_dataset
from multimodal_supernovae_tpu_torch.data.augment import augment_batch
from multimodal_supernovae_tpu_torch.data.folds import stratified_kfolds
from multimodal_supernovae_tpu_torch.models import CLIPConfig, CLIPModel, load_model
from multimodal_supernovae_tpu_torch.models import pick_reference_ckpt
from multimodal_supernovae_tpu_torch.models import state_dict_from_jax
from multimodal_supernovae_tpu_torch.models import transformer as transformer_mod
from multimodal_supernovae_tpu_torch.ops import flash_attention as flash_mod
from multimodal_supernovae_tpu_torch.ops import linear as linear_mod
from multimodal_supernovae_tpu_torch.ops.attention import dense_attention, dense_attention_bwd
from multimodal_supernovae_tpu_torch.training import Trainer, TrainerConfig
from multimodal_supernovae_tpu_torch.training.checkpoint import best_ckpt_path
from multimodal_supernovae_tpu_torch.training.ensemble import (
    Member,
    StackedRAdam,
    fit_members,
    member_train_plan,
    member_val_plan,
    select_members,
    snapshot,
    stack_states,
    unstack_member,
)
from multimodal_supernovae_tpu_torch.training.experiment import make_sweep_dir, run_sweep
from multimodal_supernovae_tpu_torch.training.optim import freeze_encoder_except_projection
from multimodal_supernovae_tpu_torch.utils.draws import DrawSource

REPO = Path(__file__).resolve().parent.parent
SYN = dict(n_max_lc=10, nband=2, n_max_sp=12)
TRI_SYN = dict(SYN, image_size=20)
TRI = ("host_galaxy", "lightcurve", "spectral")


def seq_kwargs(dropout):
    return {"n_out": 8, "emb": 8, "heads": 2, "depth": 1, "time_norm": 1000.0,
            "agg": "mean", "dropout": dropout}


def cfg_kwargs(dropout=0.1, combinations=("lightcurve", "spectral")):
    kw = dict(combinations=combinations, enc_dim=8, nband=2, logit_scale_init=10.0,
              loss="softmax", transformer_kwargs=seq_kwargs(dropout),
              transformer_spectral_kwargs=seq_kwargs(dropout))
    if "host_galaxy" in combinations:
        kw["conv_kwargs"] = {"dim": 8, "depth": 2, "kernel_size": 3, "patch_size": 10,
                             "n_out": 8, "dropout_prob": dropout}
    return kw


def port_model(seed, dropout=0.1, **kw):
    return CLIPModel(CLIPConfig.create(**cfg_kwargs(dropout, **kw)),
                     generator=torch.Generator().manual_seed(seed))


def two_fold_members(n=48, lr=None, seeds=(0, 0)):
    """Two members of equal train size over one dataset (32 train, 16 val)."""
    idx = np.arange(n)
    return [Member("run-0", seeds[0], idx[:32], idx[32:], lr=lr),
            Member("run-1", seeds[1], np.concatenate([idx[:16], idx[32:]]), idx[16:32],
                   lr=lr)]


def sequential_fit(cfg, dataset, member, model, freeze=None, run_dir=None):
    c = TrainerConfig(**{**cfg.__dict__, "seed": member.seed,
                         **({"lr": member.lr} if member.lr is not None else {})})
    return Trainer(model, "contrastive", c, freeze=freeze, run_dir=run_dir).fit(
        dataset.subset(member.train_indices), dataset.subset(member.val_indices))


def assert_state_close(a, b, atol=3e-4, rtol=1e-3):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_allclose(sa[k].float().numpy(), sb[k].float().numpy(),
                                   atol=atol, rtol=rtol, err_msg=k)


def assert_matches_sequential(res, members, seq, atol=3e-4):
    for m in members:
        par, s = res["members"][m.name], seq[m.name]
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(par["history"][key], s["history"][key],
                                       atol=1e-5, rtol=1e-5, err_msg=key)
        assert par["epochs_run"] == s["epochs_run"]
        assert par["best"]["epoch"] == s["best"]["epoch"]
        assert par["best"]["value"] == pytest.approx(s["best"]["value"], abs=1e-5)
        for pr, sr in zip(par["metric_rows"], s["metric_rows"]):
            assert pr["AUC_val"] == pytest.approx(sr["AUC_val"], abs=1e-4)
        assert_state_close(par["state"], s["state"], atol=atol)


def _fit_both(cfg, ds, members, freeze=None, **kw):
    """(fit_members, each member's sequential run, the initial models)."""
    models = [port_model(m.seed, **kw) for m in members]
    res = fit_members([copy.deepcopy(x) for x in models], "contrastive", cfg, ds, members,
                      freeze=freeze)
    seq = {m.name: sequential_fit(cfg, ds, m, copy.deepcopy(x), freeze=freeze)
           for m, x in zip(members, models)}
    return res, seq, models


# -- against the port's sequential runs, every draw on -------------------------


def test_fit_members_matches_sequential_runs():
    ds = make_synthetic_dataset(n=48, seed=0, **SYN)
    members = two_fold_members(seeds=(3, 7))
    cfg = TrainerConfig(epochs=3, batch_size=8, lr=3e-3, noise_level_mag=1.0)
    res, seq, _ = _fit_both(cfg, ds, members)
    assert_matches_sequential(res, members, seq)
    for m in members:
        rows = res["members"][m.name]["metric_rows"]
        assert all(r["samples_per_s"] == pytest.approx(2 * r["member_samples_per_s"])
                   for r in rows)


@pytest.mark.parametrize("schedule", [{}, {"step_size": 1, "gamma": 0.5}],
                         ids=["constant", "steplr"])
def test_member_lrs_match_sequential_lr_runs(schedule):
    """An lr sweep as one program (StackedRAdam), with and without StepLR
    firing between every epoch."""
    ds = make_synthetic_dataset(n=32, seed=1, **SYN)
    idx = np.arange(32)
    members = [Member(f"lr-{i}", 0, idx[:24], idx[24:], lr=lr)
               for i, lr in enumerate([3e-3, 3e-4])]
    cfg = TrainerConfig(epochs=3, batch_size=8, lr=1e-3, noise_level_mag=1.0, **schedule)
    res, seq, _ = _fit_both(cfg, ds, members)
    assert_matches_sequential(res, members, seq)
    a, b = (res["members"][m.name]["state"].model.state_dict() for m in members)
    assert any(not torch.allclose(a[k], b[k]) for k in a)
    for m in members:  # the unstacked optimizer is the sequential one
        got = res["members"][m.name]["state"]
        want = seq[m.name]["state"]
        assert got.optimizer.param_groups[0]["lr"] == want.optimizer.param_groups[0]["lr"]
        if schedule:
            assert got.scheduler.state_dict() == want.scheduler.state_dict()


@pytest.mark.parametrize("lrs", [(None, None), (3e-3, 1e-3)], ids=["folds", "lrs"])
def test_freeze_matches_sequential_and_frozen_leaves_stay(lrs):
    ds = make_synthetic_dataset(n=48, seed=5, **SYN)
    members = two_fold_members(seeds=(0, 1))
    for m, lr in zip(members, lrs):
        m.lr = lr
    cfg = TrainerConfig(epochs=2, batch_size=8, lr=3e-3, noise_level_mag=1.0)
    freeze = freeze_encoder_except_projection("lightcurve_encoder")
    res, seq, models = _fit_both(cfg, ds, members, freeze=freeze)
    assert_matches_sequential(res, members, seq)
    for m, init in zip(members, models):
        sd = res["members"][m.name]["state"].model.state_dict()
        k = "lightcurve_encoder.embedding_mag.weight"
        torch.testing.assert_close(sd[k], init.state_dict()[k], atol=0, rtol=0)
        k = "lightcurve_encoder.projection.weight"
        assert not torch.equal(sd[k], init.state_dict()[k])


def test_early_stop_bookkeeping():
    ds = make_synthetic_dataset(n=32, seed=3, **SYN)
    members = two_fold_members(n=32, seeds=(0, 5))
    for m in members:
        m.train_indices, m.val_indices = np.arange(24), np.arange(24, 32)
    cfg = TrainerConfig(epochs=14, batch_size=8, lr=1e-2, patience=1, noise_level_mag=1.0)
    res, seq, _ = _fit_both(cfg, ds, members)
    for m in members:
        par = res["members"][m.name]
        assert len(par["metric_rows"]) == par["epochs_run"] <= cfg.epochs
    # the at-stop snapshot: training past a member's stop does not leak in
    assert_matches_sequential(res, members, seq)
    runs = [res["members"][m.name]["epochs_run"] for m in members]
    assert len(set(runs)) > 1 or runs[0] < cfg.epochs


def test_wrap_extended_members_warn():
    """A member needing fewer steps takes extra batches (and warns); the
    member of the ensemble-wide step count still equals its sequential run."""
    ds = make_synthetic_dataset(n=48, seed=2, **SYN)
    idx = np.arange(48)
    members = [Member("long", 1, idx[:32], idx[32:]), Member("short", 2, idx[:20], idx[20:])]
    cfg = TrainerConfig(epochs=2, batch_size=8, lr=3e-3, noise_level_mag=1.0)
    with pytest.warns(UserWarning, match=r"\['short'\].*wrap-extended"):
        res, seq, _ = _fit_both(cfg, ds, members)
    assert_matches_sequential(res, members[:1], seq)
    assert res["members"]["short"]["state"].step == res["members"]["long"]["state"].step == 8


def test_stack_unstack_select_roundtrip():
    models = [port_model(i) for i in range(3)]
    state = stack_states(models, [1e-3] * 3)
    snap = snapshot(state)
    for i, m in enumerate(models):
        assert_state_close(unstack_member(snap, i, state), type("S", (), {"model": m}),
                           atol=0, rtol=0)
    doubled = {k: v * 2 for k, v in snap.items()}
    sel = select_members(torch.tensor([True, False, True]), doubled, snap)
    w = "lightcurve_encoder.projection.weight"
    for i, pick in enumerate((True, False, True)):
        want = snap[f"param.{w}"][i] * (2 if pick else 1)
        torch.testing.assert_close(sel[f"param.{w}"][i], want, atol=0, rtol=0)
    assert sel[f"param.{w}"].data_ptr() != snap[f"param.{w}"].data_ptr()


def test_member_plans_respect_membership_and_padding():
    rng = np.random.default_rng(0)
    m = Member("m", 0, np.arange(10, 30), np.arange(0, 7))
    plan = member_train_plan(m, batch_size=8, rng=rng, steps=5)
    assert plan.shape == (5, 8) and set(plan.ravel()) <= set(range(10, 30))
    assert set(plan[:3].ravel()) == set(range(10, 30))
    vplan = member_val_plan(m, batch_size=8, steps=3)
    assert vplan.shape == (3, 8) and set(vplan.ravel()) <= set(range(0, 7))
    assert (vplan[1] == vplan[0]).all() and (vplan[2] == vplan[0]).all()


def test_run_dir_contract_and_load_model(tmp_path):
    """Each member dir holds what a sequential run dir holds, file for file:
    the same sidecars, metric rows, kept epochs and checkpoint payloads, and
    serves through load_model."""
    ds = make_synthetic_dataset(n=48, seed=2, **SYN)
    members = two_fold_members(seeds=(0, 1))
    cfg = TrainerConfig(epochs=3, batch_size=8, lr=3e-3, noise_level_mag=1.0, keep_best=2)
    models = [port_model(m.seed) for m in members]
    res = fit_members([copy.deepcopy(x) for x in models], "contrastive", cfg, ds, members,
                      run_dir=str(tmp_path / "par"))
    for m, x in zip(members, models):
        mdir, sdir = tmp_path / "par" / m.name, tmp_path / "seq" / m.name
        m.config_dump = None
        sequential_fit(cfg, ds, m, x, run_dir=str(sdir))
        assert sorted(os.listdir(mdir)) == sorted(os.listdir(sdir))
        for f in ("train_filenames.txt", "val_filenames.txt", "model_config.json"):
            assert (mdir / f).read_text() == (sdir / f).read_text(), f
        assert yaml.safe_load((mdir / "config.yaml").read_text())["seed"] == m.seed
        rows = [json.loads(line) for line in open(mdir / "metrics.jsonl")]
        srows = [json.loads(line) for line in open(sdir / "metrics.jsonl")]
        assert [r["epoch"] for r in rows] == [r["epoch"] for r in srows]
        assert all("member_samples_per_s" in r for r in rows)
        np.testing.assert_allclose([r["val_loss"] for r in rows],
                                   [r["val_loss"] for r in srows], atol=1e-5)
        summary = json.loads((mdir / "summary.json").read_text())
        assert summary["best_ckpt_epoch"] == res["members"][m.name]["best_ckpt_epoch"]
        for name in (n for n in os.listdir(mdir) if n.endswith(".ckpt")):
            a = torch.load(mdir / name, weights_only=True)
            b = torch.load(sdir / name, weights_only=True)
            assert a.keys() == b.keys() and a["epoch"] == b["epoch"]
            assert a["global_step"] == b["global_step"]
            assert a["lr_schedulers"] == b["lr_schedulers"]
            assert a["optimizer_states"][0]["param_groups"] == \
                b["optimizer_states"][0]["param_groups"]
            sa, sb = a["optimizer_states"][0]["state"], b["optimizer_states"][0]["state"]
            assert sa.keys() == sb.keys()
            for p in sa:
                for key in ("step", "exp_avg", "exp_avg_sq"):
                    torch.testing.assert_close(sa[p][key], sb[p][key], atol=3e-4, rtol=1e-3)
            for k in a["state_dict"]:
                torch.testing.assert_close(a["state_dict"][k], b["state_dict"][k],
                                           atol=3e-4, rtol=1e-3)
            assert a["loop"].keys() == b["loop"].keys()
            assert torch.equal(a["loop"]["torch_rng"], b["loop"]["torch_rng"])
            assert a["loop"]["numpy_rng"] == b["loop"]["numpy_rng"]
        # the monitored best file holds the best snapshot's member
        i = [mm.name for mm in members].index(m.name)
        want = unstack_member(res["best_states"], i, stack_states(models, [cfg.lr] * 2))
        sd = torch.load(best_ckpt_path(str(mdir)), weights_only=True)["state_dict"]
        for k, v in want.model.state_dict().items():
            torch.testing.assert_close(sd[k], v, atol=0, rtol=0)
        model, _ = load_model(str(mdir), device="cpu")
        ref = torch.load(pick_reference_ckpt(str(mdir)), weights_only=True)["state_dict"]
        for k, v in model.state_dict().items():
            torch.testing.assert_close(v, ref[k], atol=0, rtol=0)
        with torch.no_grad():
            embs = model.encode(ds.subset(m.val_indices[:4]).to_device("cpu"))
        assert all(torch.isfinite(e).all() for e in embs)


def test_resume_continues_identically(tmp_path):
    """2 epochs, then resume to 4, equals 4 straight epochs bitwise; resuming
    a finished run trains nothing."""
    ds = make_synthetic_dataset(n=48, seed=6, **SYN)
    cfg4 = TrainerConfig(epochs=4, batch_size=8, lr=3e-3, noise_level_mag=1.0)

    def fit(run_dir, cfg, resume=False):
        members = two_fold_members(seeds=(3, 7))
        return fit_members([port_model(m.seed) for m in members], "contrastive", cfg, ds,
                           members, run_dir=str(tmp_path / run_dir), resume=resume)

    full = fit("full", cfg4)
    fit("resumed", TrainerConfig(**{**cfg4.__dict__, "epochs": 2}))
    res = fit("resumed", cfg4, resume=True)
    for name in ("run-0", "run-1"):
        a, b = full["members"][name], res["members"][name]
        assert a["history"] == b["history"] and a["epochs_run"] == b["epochs_run"] == 4
        assert_state_close(a["state"], b["state"], atol=0, rtol=0)
        ra = (tmp_path / "full" / name / "metrics.jsonl").read_text().splitlines()
        rb = (tmp_path / "resumed" / name / "metrics.jsonl").read_text().splitlines()
        key = [(json.loads(r)["epoch"], json.loads(r)["val_loss"]) for r in ra]
        assert key == [(json.loads(r)["epoch"], json.loads(r)["val_loss"]) for r in rb]
    again = fit("resumed", cfg4, resume=True)
    for name in ("run-0", "run-1"):
        assert again["members"][name]["epochs_run"] == 4
        assert_state_close(again["members"][name]["state"], res["members"][name]["state"],
                           atol=0, rtol=0)


def test_resume_rejects_member_mismatch(tmp_path):
    ds = make_synthetic_dataset(n=48, seed=7, **SYN)
    cfg = TrainerConfig(epochs=1, batch_size=8, lr=3e-3)
    members = two_fold_members(seeds=(0, 1))
    fit_members([port_model(m.seed) for m in members], "contrastive", cfg, ds, members,
                run_dir=str(tmp_path))
    bad = two_fold_members(seeds=(0, 1))
    bad[1] = Member("other-name", 1, bad[1].train_indices, bad[1].val_indices)
    with pytest.raises(RuntimeError, match="member mismatch"):
        fit_members([port_model(m.seed) for m in bad], "contrastive", cfg, ds, bad,
                    run_dir=str(tmp_path), resume=True)


def test_trimodal_batchnorm_statistics_per_member():
    """The image tower's BatchNorm running statistics land in each member's
    row of the stacked buffers: equal to each sequential run's (image noise,
    rotations and dropout on in every tower)."""
    ds = make_synthetic_dataset(n=40, seed=4, modalities=TRI, **TRI_SYN)
    idx = np.arange(40)
    members = [Member("run-0", 0, idx[:24], idx[24:]),
               Member("run-1", 5, idx[16:], idx[:16])]
    cfg = TrainerConfig(epochs=2, batch_size=8, lr=1e-3, noise_level_mag=1.0,
                        noise_level_img=0.1)
    models = [port_model(m.seed, combinations=TRI) for m in members]
    res = fit_members([copy.deepcopy(x) for x in models], "contrastive", cfg, ds, members)
    for m, x in zip(members, models):
        seq = sequential_fit(cfg, ds, m, x)
        par = res["members"][m.name]
        np.testing.assert_allclose(par["history"]["train_loss"], seq["history"]["train_loss"],
                                   atol=1e-5, rtol=1e-5)
        a, b = par["state"].model.state_dict(), seq["state"].model.state_dict()
        stats = [k for k in a if "running" in k or "num_batches" in k]
        assert stats
        for k in stats:
            torch.testing.assert_close(a[k], b[k], atol=3e-4, rtol=1e-3)
        assert not torch.equal(a[stats[0]], x.state_dict()[stats[0]])
    r0, r1 = (res["members"][n]["state"].model.state_dict() for n in ("run-0", "run-1"))
    assert not torch.equal(r0[stats[0]], r1[stats[0]])


def test_draw_source_refuses_what_it_does_not_cover():
    ds = make_synthetic_dataset(n=8, seed=0, **SYN).to_device("cpu")
    with pytest.raises(RuntimeError, match="noise_from_error draws from a generator"):
        augment_batch(ds, DrawSource(), noise_level_mag=1.0)
    x = torch.ones(4, 3)
    with pytest.raises(RuntimeError, match="not covered"):
        transformer_mod.dropout(x, 0.1, True, DrawSource())
    src = DrawSource([((4, 2), 0.9)], [torch.ones(4, 2, dtype=torch.bool)])
    with pytest.raises(RuntimeError, match=r"shape \(4, 3\), keep 0.9\) but"):
        transformer_mod.dropout(x, 0.1, True, src)


# -- against the JAX package, no draws ---------------------------------------------


def _jax_setup(seed, n_probe=8):
    model = JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False, **cfg_kwargs(0.0)))
    data = jax_make_synthetic_dataset(n=n_probe, seed=0, **SYN).to_device()
    variables = model.init(jax.random.PRNGKey(seed), data.take(jax.numpy.arange(n_probe)))
    return model, variables["params"]


def _port_from_jax(params):
    model = CLIPModel(CLIPConfig.create(**cfg_kwargs(0.0)))
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           state_dict_from_jax(params).items()}, strict=True)
    return model


@pytest.mark.parametrize("lrs", [(None, None), (3e-3, 3e-4)], ids=["folds", "lrs"])
def test_fit_members_tracks_jax_fit_members(lrs):
    """From the same weights: JAX initialises each member from
    PRNGKey(seed), so the port's members take those parameters."""
    n = 48
    jds = jax_make_synthetic_dataset(n=n, seed=0, **SYN)
    ds = make_synthetic_dataset(n=n, seed=0, **SYN)
    idx = np.arange(n)
    splits = [(idx[:32], idx[32:]), (np.concatenate([idx[:16], idx[32:]]), idx[16:32])]
    seeds = (3, 7)
    jmembers = [JaxMember(f"run-{i}", s, tr, va, lr=lr)
                for i, ((tr, va), s, lr) in enumerate(zip(splits, seeds, lrs))]
    members = [Member(f"run-{i}", s, tr, va, lr=lr)
               for i, ((tr, va), s, lr) in enumerate(zip(splits, seeds, lrs))]
    jmodel, _ = _jax_setup(0)
    want = jax_fit_members(jmodel, "contrastive", JaxTrainerConfig(
        epochs=3, batch_size=8, lr=1e-3, rotate_images=False), jds, jmembers)
    models = [_port_from_jax(_jax_setup(s)[1]) for s in seeds]
    got = fit_members(models, "contrastive", TrainerConfig(
        epochs=3, batch_size=8, lr=1e-3, rotate_images=False), ds, members)
    for m in members:
        g, w = got["members"][m.name], want["members"][m.name]
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g["history"][key], w["history"][key], rtol=1e-4,
                                       atol=0, err_msg=key)
        assert g["best"]["epoch"] == w["best"]["epoch"]


@pytest.mark.parametrize("n_train,n_val,b,steps,val_steps", [
    (20, 7, 8, 3, 1), (20, 7, 8, 5, 3), (33, 12, 8, 6, 2), (5, 3, 4, 4, 2)])
def test_member_plans_match_jax_bitwise(n_train, n_val, b, steps, val_steps):
    tr, va = np.arange(10, 10 + n_train), np.arange(n_val)
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):
        np.testing.assert_array_equal(
            member_train_plan(Member("m", 0, tr, va), b, rng_a, steps),
            jax_train_plan(JaxMember("m", 0, tr, va), b, rng_b, steps))
    np.testing.assert_array_equal(member_val_plan(Member("m", 0, tr, va), b, val_steps),
                                  jax_val_plan(JaxMember("m", 0, tr, va), b, val_steps))


@pytest.mark.parametrize("wd,schedule", [(0.0, None), (0.01, None), (0.01, (2, 0.5))])
def test_stacked_radam_matches_torch_radam_and_jax(wd, schedule):
    """StackedRAdam's member i against ``torch.optim.RAdam`` (with StepLR) at
    lr_i within relative 1e-6, and against the JAX
    ``build_member_lr_optimizer`` within 1e-5 (tests/test_torch_training.py's
    tolerance for RAdam in two frameworks over a few steps)."""
    rng = np.random.default_rng(0)
    lrs = [2e-3, 5e-4, 1e-2]
    w0 = rng.normal(size=(3, 5, 4)).astype(np.float32)
    grads = [rng.normal(size=w0.shape).astype(np.float32) for _ in range(7)]
    step_size, gamma = schedule or (None, None)
    w = torch.tensor(w0, requires_grad=True)
    opt = StackedRAdam([w], lrs, weight_decay=wd, decay_every=step_size, gamma=gamma)
    for g in grads:
        w.grad = torch.tensor(g)
        opt.step()
    for i, lr in enumerate(lrs):
        wi = torch.tensor(w0[i], requires_grad=True)
        ref = torch.optim.RAdam([wi], lr=lr, weight_decay=wd)
        sched = (torch.optim.lr_scheduler.StepLR(ref, step_size, gamma) if schedule else None)
        for g in grads:
            wi.grad = torch.tensor(g[i])
            ref.step()
            if sched:
                sched.step()
        # elementwise, but the CPU's vector and tail loops split a (3, 5, 4)
        # tensor where they split a (5, 4) one: a few ulps apart
        torch.testing.assert_close(w.detach()[i], wi.detach(), atol=1e-7, rtol=1e-6)
        tx = jax_build_member_lr_optimizer(lr, wd, step_size=step_size, gamma=gamma)
        p = {"w": jax.numpy.asarray(w0[i])}
        st = tx.init(p)
        for g in grads:
            u, st = tx.update({"w": jax.numpy.asarray(g[i])}, st, p)
            p = optax.apply_updates(p, u)
        np.testing.assert_allclose(w.detach()[i].numpy(), np.asarray(p["w"]), atol=1e-5)


def _fold_sweep(tmp_path, kfolds=3, members=False):
    raw = yaml.safe_load((REPO / "configs/smoke.yaml").read_text())
    if members:
        raw["parameters"]["lr"] = {"values": [0.003, 0.001]}
        raw["parameters"]["seed"] = {"values": [0, 1]}
    else:
        raw["parameters"]["foldnumber"] = {"values": list(range(kfolds))}
        raw["extra_args"]["kfolds"] = kfolds
    path = tmp_path / ("member_sweep.yaml" if members else "fold_sweep.yaml")
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.mark.parametrize("members", [False, True], ids=["parallel_folds", "parallel_members"])
def test_run_sweep_parallel_matches_jax_run_dirs(tmp_path, members):
    """``run_sweep(parallel_folds=True)`` / ``(parallel_members=True)``: the
    JAX runner's run dirs, config dumps and split manifests; each run dir
    reloads through ``load_model``; resume skips the finished group."""
    path = _fold_sweep(tmp_path, members=members)
    kw = dict(n=42, n_max_lc=8, nband=2, n_max_sp=64, seed=0)
    ds, jds = make_synthetic_dataset(**kw), jax_make_synthetic_dataset(**kw)
    folds = None if members else stratified_kfolds(ds.arrays["label"], 3)
    jfolds = None if members else jax_kfolds(jds.arrays["label"], 3)
    flag = {"parallel_members" if members else "parallel_folds": True}
    sweep_dir = make_sweep_dir(load_sweep(path), str(tmp_path / "port"), "s")
    got = run_sweep(load_sweep(path), ds, 2, folds, sweep_dir, device="cpu", **flag)
    jdir = jax_make_sweep_dir(jax_load_sweep(path), str(tmp_path / "jax"), "s")
    want = jax_run_sweep(jax_load_sweep(path), jds, 2, jfolds, jdir, **flag)
    assert len(got) == len(want) == (4 if members else 3)
    runs = sorted(p for p in os.listdir(sweep_dir) if p.startswith("run-"))
    assert runs == sorted(p for p in os.listdir(jdir) if p.startswith("run-"))
    assert sorted(p for p in os.listdir(sweep_dir) if p.startswith("_ensemble-")) == \
        sorted(p for p in os.listdir(jdir) if p.startswith("_ensemble-"))
    for g, w in zip(got, want):
        assert os.path.basename(g["run_dir"]) == os.path.basename(w["run_dir"])
        assert g["run_cfg"] == w["run_cfg"]
        for f in ("train_filenames.txt", "val_filenames.txt"):
            assert Path(g["run_dir"], f).read_text() == Path(w["run_dir"], f).read_text()
        assert yaml.safe_load(Path(g["run_dir"], "config.yaml").read_text()) == \
            yaml.safe_load(Path(w["run_dir"], "config.yaml").read_text())
        assert json.loads(Path(g["run_dir"], "summary.json").read_text()).keys() == \
            json.loads(Path(w["run_dir"], "summary.json").read_text()).keys()
        model, _ = load_model(g["run_dir"], device="cpu")
        assert isinstance(model, CLIPModel)
    again = run_sweep(load_sweep(path), ds, 2, folds, sweep_dir, device="cpu", resume=True,
                      **flag)
    assert all(r.get("skipped") for r in again)


def test_run_sweep_parallel_requires_grid(tmp_path):
    path = _fold_sweep(tmp_path, kfolds=2)
    raw = yaml.safe_load(Path(path).read_text())
    raw["method"] = "random"
    Path(path).write_text(yaml.safe_dump(raw))
    ds = make_synthetic_dataset(n=24, n_max_lc=8, nband=2, n_max_sp=64, seed=2)
    with pytest.raises(ValueError, match="grid"):
        run_sweep(load_sweep(path), ds, 2, None, str(tmp_path), parallel_folds=True,
                  device="cpu")


# -- the kernels under vmap ----------------------------------------------------------


@pytest.fixture
def plain_launches(monkeypatch):
    """The flash launch functions replaced by their plain versions, each
    call recorded with its q shape."""
    calls = {"fwd": [], "bwd": []}

    def fwd(q, k, v, key_mask, emb, with_stats):
        calls["fwd"].append((tuple(q.shape), None if key_mask is None else
                             tuple(key_mask.shape), with_stats))
        out = dense_attention(q, k, v, key_mask, emb)
        stats = torch.zeros(*q.shape[:3], 2) if with_stats else None
        return out, stats

    def bwd(q, k, v, key_mask, out, stats, g, emb):
        calls["bwd"].append(tuple(q.shape))
        return dense_attention_bwd(q, k, v, key_mask, g, emb)

    monkeypatch.setattr(flash_mod, "_flash_fwd", fwd)
    monkeypatch.setattr(flash_mod, "flash_attention_bwd", bwd)
    return calls


def _heads(rng, n, b, t, h, s):
    """(N, B, H, T, S) as the encoder makes them: (N, B, T, H, S) transposed."""
    return torch.tensor(rng.normal(size=(n, b, t, h, s)).astype(np.float32)).transpose(2, 3)


@pytest.mark.parametrize("mask", ["batched", "shared", None])
def test_flash_vmap_rule_folds_members_into_the_batch(plain_launches, mask):
    rng = np.random.default_rng(0)
    n, b, t, h, s = 3, 2, 7, 2, 8
    q, k, v = (_heads(rng, n, b, t, h, s).requires_grad_() for _ in range(3))
    m = rng.random((n, b, t)) > 0.3
    m[..., 0] = True
    m = torch.from_numpy(m)
    key_mask = {"batched": m, "shared": m[0], None: None}[mask]
    in_dims = (0, 0, 0, 0 if mask == "batched" else None)

    def f(q, k, v, km):
        return flash_mod.FlashAttention.apply(q, k, v, km, h * s)[0]

    out = torch.func.vmap(f, in_dims=in_dims)(q, k, v, key_mask)
    assert out.shape == (n, b, h, t, s)
    assert plain_launches["fwd"] == [((n * b, h, t, s), None if mask is None else (n * b, t),
                                      True)]
    g = torch.tensor(rng.normal(size=out.shape).astype(np.float32))
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    assert plain_launches["bwd"] == [(n * b, h, t, s)]
    for i in range(n):
        qi, ki, vi = (a.detach()[i].clone().requires_grad_() for a in (q, k, v))
        mi = None if mask is None else (m[i] if mask == "batched" else m[0])
        want = dense_attention(qi, ki, vi, mi, h * s)
        torch.testing.assert_close(out[i], want, atol=1e-6, rtol=1e-6)
        for got, w in zip((dq[i], dk[i], dv[i]), torch.autograd.grad(want, (qi, ki, vi), g[i])):
            torch.testing.assert_close(got, w, atol=1e-6, rtol=1e-6)
    with torch.no_grad():
        ev = torch.func.vmap(lambda q, k, v, km: flash_mod.FlashForward.apply(q, k, v, km, h * s),
                             in_dims=in_dims)(q, k, v, key_mask)
    assert plain_launches["fwd"][-1][2] is False and len(plain_launches["fwd"]) == 2
    torch.testing.assert_close(ev, out.detach(), atol=0, rtol=0)


@pytest.mark.parametrize("rows,bias", [(1024, True), (1024, False), (7 * 40, True)],
                         ids=["chunked", "chunked-no-bias", "one-chunk"])
def test_linear_under_vmap_matches_each_member(rows, bias):
    """ops.linear under vmap (the rows in chunks where they split, the
    weight gradient summed over the chunks) against each member's F.linear
    and its autograd."""
    assert linear_mod.chunks(rows) == (4 if rows == 1024 else 1)
    rng = np.random.default_rng(2)
    n, fin, fout = 3, 8, 6
    x = torch.tensor(rng.normal(size=(n, rows // 4, 4, fin)).astype(np.float32),
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(n, fout, fin)).astype(np.float32), requires_grad=True)
    b = torch.tensor(rng.normal(size=(n, fout)).astype(np.float32), requires_grad=True)
    out = torch.func.vmap(linear_mod.linear, in_dims=(0, 0, 0 if bias else None))(
        x, w, b if bias else None)
    assert out.shape == (n, rows // 4, 4, fout)
    g = torch.tensor(rng.normal(size=out.shape).astype(np.float32))
    grads = torch.autograd.grad(out, (x, w, b) if bias else (x, w), g)
    for i in range(n):
        xi, wi, bi = (a.detach()[i].requires_grad_() for a in (x, w, b))
        want = torch.nn.functional.linear(xi, wi, bi if bias else None)
        torch.testing.assert_close(out[i], want, atol=1e-5, rtol=1e-5)
        wgrads = torch.autograd.grad(want, (xi, wi, bi) if bias else (xi, wi), g[i])
        for got, w_ in zip(grads, wgrads):
            torch.testing.assert_close(got[i], w_, atol=1e-4, rtol=1e-5)


# -- the member axis over a data mesh ---------------------------------------------


@pytest.fixture(scope="module")
def member_axis(tmp_path_factory):
    """tests/torch_dp_worker.py's member scenarios on 2 gloo ranks (a 2 x 1
    mesh), and the unsharded stacked run of the same members here."""
    import torch_dp_worker as W

    out = str(tmp_path_factory.mktemp("members"))
    procs = W.start(out, W.MEMBER_SCENARIOS, world=2)
    try:
        one = str(tmp_path_factory.mktemp("members-one"))
        ref = W.fit_members_on(None, run_dir=one)
    finally:
        W.wait(procs)
    return out, one, ref, W


def test_fit_members_sharded_member_axis(member_axis):
    """4 members over 2 ranks, 2 a rank, as one stacked program each: every
    rank returns every member's results, each within atol = rtol = 1e-5 of
    the unsharded ensemble (JAX test_fit_members_sharded_member_axis), and
    its own members' weights too."""
    out, _, ref, W = member_axis
    for r in range(2):
        got = W.load(out, "members", r)
        assert got["local"] == [f"run-{2 * r}", f"run-{2 * r + 1}"]
        assert list(got["members"]) == list(ref["members"])
        for name, want in ref["members"].items():
            g = got["members"][name]
            for k in ("train_loss", "val_loss"):
                np.testing.assert_allclose(g["history"][k], want["history"][k], rtol=1e-5,
                                           atol=1e-5, err_msg=f"{name} {k}")
            assert (g["epochs_run"], g["best_ckpt_epoch"]) == (want["epochs_run"],
                                                               want["best_ckpt_epoch"])
        for name in got["local"]:
            for k, v in ref["state_dicts"][name].items():
                np.testing.assert_allclose(got["state_dicts"][name][k].numpy(), v.numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=f"{name} {k}")


def test_member_axis_run_dirs_hold_the_one_process_files(member_axis):
    """Each member's run dir holds exactly the unsharded run's files, written
    by the rank that trains it; each data rank's stacked checkpoint is its
    own directory under _ensemble/."""
    out, one, _, W = member_axis
    root = os.path.join(out, "members")
    for k in range(4):
        name = f"run-{k}"
        assert sorted(os.listdir(os.path.join(root, name))) == \
            sorted(os.listdir(os.path.join(one, name)))
        with open(os.path.join(root, name, "metrics.jsonl")) as f, \
                open(os.path.join(one, name, "metrics.jsonl")) as g:
            got, want = [json.loads(x) for x in f], [json.loads(x) for x in g]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-5, atol=1e-5)
    assert sorted(os.listdir(os.path.join(root, "_ensemble"))) == ["data-0", "data-1"]
    for r in range(2):
        assert W.load(out, "members", r)["writes"]["sidecars"] == 2  # its own members


def test_member_axis_resumes_under_the_same_mesh(member_axis):
    """1 epoch, then resumed to 2 under the same 2 x 1 mesh: the
    uninterrupted run's results; a 1-process resume of that run dir raises."""
    out, _, _, W = member_axis
    for r in range(2):
        full, resumed = W.load(out, "members", r), W.load(out, "members-resume", r)
        assert resumed["local"] == full["local"]
        for name, want in full["members"].items():
            assert resumed["members"][name]["history"] == want["history"]
        for name in full["local"]:
            for k, v in full["state_dicts"][name].items():
                assert torch.equal(resumed["state_dicts"][name][k], v), (name, k)
    with pytest.raises(RuntimeError, match=r"another data axis than this run's \(1\)"):
        W.fit_members_on(None, run_dir=os.path.join(out, "members-R"), epochs=3)


def test_member_count_must_divide_by_the_data_axis():
    import torch_dp_worker as W
    from multimodal_supernovae_tpu_torch.parallel import DataMesh

    models, tcfg, ds, members = W.members_setup()
    with pytest.raises(ValueError, match=r"4 members cannot shard over the mesh's 'data' axis "
                                         r"of size 3: the member count must be a multiple"):
        fit_members(models, "contrastive", tcfg, ds, members, mesh=DataMesh(0, 3))
