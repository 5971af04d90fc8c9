"""Tensor parallelism in the port (``parallel/sharding.py``, a ``(data,
model)`` ``DataMesh``) on the CPU: the split rule against the JAX package's
``param_sharding_rules`` through the key bridge; 1 x 2 and 2 x 2 gloo fits
(bimodal CLIP, SigLIP, trimodal with the ConvMixer head's dropout, masked
pretraining, the fused opt-ins) against the one-process fit at the global
batch, with every draw on; every dropout mask of a model rank against the
one-process draw (the head's column-split mask included); the 2 x 2 fit
against JAX ``Trainer(mesh=make_mesh(2, 2))``; a 1 x 2 run dir through
one-process ``load_model`` and resumed under 1 x 2 and under 1 x 1; and the
ensemble member axis over the data axis of a 2 x 2 mesh.

One spawn of tests/torch_dp_worker.py (no jax) a world size runs every
scenario of that mesh; the references are fitted here. Tolerances: JAX
tests/test_dp_equivalence.py's ``test_dp_tp_matches_single_device`` (losses
and every gathered state_dict entry, rtol = atol = 5e-5); against the JAX
package the CPU trajectory tolerance, relative 1e-4; the member axis JAX
tests/test_ensemble.py's 1e-5."""

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
from multimodal_supernovae_tpu.models.pretraining import (
    MaskedEncoderConfig as JaxMaskedEncoderConfig,
)
from multimodal_supernovae_tpu.models.pretraining import (
    MaskedLightCurveEncoder as JaxMaskedLightCurveEncoder,
)
from multimodal_supernovae_tpu.parallel import make_mesh as jax_make_mesh
from multimodal_supernovae_tpu.parallel.sharding import param_sharding_rules
from multimodal_supernovae_tpu.training.trainer import Trainer as JaxTrainer
from multimodal_supernovae_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from multimodal_supernovae_tpu_torch.models import (
    CLIPConfig,
    CLIPModel,
    MaskedEncoderConfig,
    MaskedLightCurveEncoder,
    load_model,
    state_dict_from_jax,
)
from multimodal_supernovae_tpu_torch.parallel import DataMesh, shard_module, spec_for
from multimodal_supernovae_tpu_torch.parallel.sharding import split_dims
from multimodal_supernovae_tpu_torch.training import Trainer, TrainerConfig

TOL = 5e-5
FITS = {2: ("bimodal", "sigmoid", "trimodal", "masked", "fused"),
        4: ("bimodal", "sigmoid", "trimodal", "regression", "masked", "fused")}
MESH = {2: "1x2", 4: "2x2"}
JAX_KW = dict(epochs=2, batch_size=8, lr=1e-3, noise_level_mag=0.0, seed=0)


def _jax_setup():
    """The JAX 2 x 2 mesh trainer over the jaxmatch scenario's synthetic set
    and its initial state (the port's weights come from it)."""
    kw = dict(n=W.N, seed=0, modalities=("lightcurve", "spectral"), image_size=12, **W.SYN)
    ds = jax_make_synthetic_dataset(**kw)
    train, val = ds.subset(np.arange(W.N_TRAIN)), ds.subset(np.arange(W.N_TRAIN, W.N))
    model = JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False, **W.clip_kwargs(dropout=0.0)))
    trainer = JaxTrainer(model, "contrastive", JaxTrainerConfig(**JAX_KW),
                         mesh=jax_make_mesh(2, 2))
    state = trainer.init_state(train.to_device().take(jnp.arange(8)))
    return trainer, state, train, val


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    outs, procs = {}, []
    trainer, state, train, val = _jax_setup()
    for world in (2, 4):  # both meshes at once
        out = str(tmp_path_factory.mktemp(f"tp{world}"))
        if "jaxmatch" in W.TP_SCENARIOS[world]:
            init = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
            torch.save({k: torch.from_numpy(np.array(v)) for k, v in init.items()},
                       os.path.join(out, "jaxmatch.init.pt"))
        procs += W.start(out, W.TP_SCENARIOS[world], world=world, tp=2)
        outs[world] = out
    try:
        want = trainer.fit(train, val, state=state)
    finally:
        W.wait(procs)
    return outs, want


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=tol, atol=tol,
                               err_msg=what)


def _same_fit(got, ref, tol=TOL):
    for k in ("train_loss", "val_loss"):
        _close(got["history"][k], ref["history"][k], tol, k)
    for g, w in zip(got["rows"], ref["rows"]):
        for k in set(w) - {"step_time_s", "samples_per_s"}:
            _close(g[k], w[k], tol, k)
    assert sorted(got["state_dict"]) == sorted(ref["state_dict"])
    for k, v in ref["state_dict"].items():
        assert got["state_dict"][k].shape == v.shape, k
        _close(got["state_dict"][k].numpy(), v.numpy(), tol, k)
    assert got["grad_none"] == ref["grad_none"]


# -- the split rule -----------------------------------------------------------


def _jax_and_port(family):
    """(JAX params, batch_stats, the port model) of a small model of
    ``family``: the LC tower at emb 12 (FF 48: divides by 2 and 3), the SP
    tower at emb 16 (FF 64: by 2 only), the ConvMixer head (1024: by 2)."""
    kw = dict(n=8, seed=0, image_size=12, **W.SYN)
    if family == "masked":
        tk = {"n_out": 8, "emb": 12, "heads": 2, "depth": 2, "time_norm": 2000.0}
        jmodel = JaxMaskedLightCurveEncoder(JaxMaskedEncoderConfig.create(
            nband=2, transformer_kwargs=tk))
        port = MaskedLightCurveEncoder(MaskedEncoderConfig.create(nband=2,
                                                                  transformer_kwargs=tk))
        batch = jax_make_synthetic_dataset(**kw).to_device()
    else:
        ckw = W.clip_kwargs(combinations=W.TRI, transformer_kwargs=W._seq(emb=12, agg="attn"))
        jmodel = JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False, **ckw))
        port = CLIPModel(CLIPConfig.create(**ckw))
        batch = jax_make_synthetic_dataset(modalities=W.TRI, **kw).to_device()
    variables = jmodel.init(jax.random.PRNGKey(0), batch)
    return variables["params"], variables.get("batch_stats"), port


@pytest.mark.parametrize("family", ["trimodal", "masked"])
@pytest.mark.parametrize("n_model", [2, 3])
def test_split_rule_matches_jax_param_sharding_rules(family, n_model):
    """Each state_dict entry splits where, and along the dimension, JAX's
    rule places its flax leaf (a kernel's (in, out) is the weight's (out,
    in)); a width the axis does not divide stays whole; shard_module splits
    exactly those entries."""
    params, stats, port = _jax_and_port(family)
    leaves, tree = jax.tree_util.tree_flatten(params)
    specs = jax.tree_util.tree_leaves(param_sharding_rules(
        params, jax_make_mesh(1, n_model, devices=jax.devices()[:n_model])))
    # every leaf filled with its own number, through the key bridge
    marked = jax.tree_util.tree_unflatten(
        tree, [np.full(np.shape(v), i + 1, np.float32) for i, v in enumerate(leaves)])
    sd = state_dict_from_jax(marked, stats, n_out=8)
    want, split = {}, 0
    for name, value in sd.items():
        leaf = int(np.asarray(value).reshape(-1)[0]) - 1 if np.size(value) else -1
        spec = tuple(specs[leaf].spec) if leaf >= 0 else ()
        dim = None
        if np.ndim(value) == 2 and spec == (None, "model"):
            dim = 0
        elif np.ndim(value) == 2 and spec == ("model", None):
            dim = 1
        elif np.ndim(value) == 1 and spec == ("model",):
            dim = 0
        else:
            assert all(s is None for s in spec), (name, spec)
        want[name] = dim
        split += dim is not None
    assert split > 0
    got = {name: spec_for(name, torch.from_numpy(np.array(v)), n_model)
           for name, v in sd.items()}
    assert got == want
    shard_module(port, DataMesh(0, 1, n_model=n_model))
    assert split_dims(port) == {k: d for k, d in want.items() if d is not None}
    if family == "trimodal":  # the SP tower's FF 64 and the head's 1024 stay whole over 3
        assert any(d is None for k, d in want.items() if k.endswith(".ff.0.weight")) == \
            (n_model == 3)


def test_a_second_split_leaves_the_model_as_it_was():
    """Trainer(mesh=...) twice on one model splits it once: the split
    dimensions and shapes stay; a split over another mesh raises."""
    port, mesh = _jax_and_port("trimodal")[2], DataMesh(0, 1, n_model=2)
    Trainer(port, "contrastive", TrainerConfig(), mesh=mesh)
    dims, shapes = split_dims(port), {k: v.shape for k, v in port.state_dict().items()}
    Trainer(port, "contrastive", TrainerConfig(), mesh=mesh)
    assert split_dims(port) == dims and dims
    assert {k: v.shape for k, v in port.state_dict().items()} == shapes
    with pytest.raises(ValueError, match="already split over another mesh"):
        shard_module(port, DataMesh(0, 1, n_model=2))


# -- fits against one process ----------------------------------------------------


@pytest.mark.parametrize("world,name", [(w, n) for w in FITS for n in FITS[w]],
                         ids=[f"{MESH[w]}-{n}" for w in FITS for n in FITS[w]])
def test_tp_fit_equals_the_one_process_fit(tp, world, name):
    """Losses, task metrics and every gathered state_dict entry (names and
    shapes the one-process model's) of each rank against one process at the
    global batch, from the same weights and seed."""
    outs, _ = tp
    ref = W.fit(name)
    for r in range(world):
        _same_fit(W.load(outs[world], name, r), ref)


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_every_dropout_mask_is_the_one_process_masks_block(tp, world):
    """The E-wide masks are the global draw's rows on every model rank alike;
    the ConvMixer head's mask (column-split: (B / n_data, 1024 / n_model))
    is its row AND column block of the one-process (B, 1024) mask."""
    outs, _ = tp
    ref = W.keep_masks(DataMesh())
    n_data = world // 2
    b = 8 // n_data
    split_seen = 0
    for r in range(world):
        got = W.load(outs[world], "masks", r)["masks"]
        assert len(got) == len(ref)
        d, m = divmod(r, 2)
        for (split, mask), (_, want) in zip(got, ref):
            want = want[d * b:(d + 1) * b]
            if split:
                c = want.shape[-1] // 2
                want = want[..., m * c:(m + 1) * c]
                split_seen += 1
            assert torch.equal(mask, want)
    assert split_seen == world  # one head mask a rank


def test_2x2_fit_matches_the_jax_mesh_fit(tp):
    outs, want = tp
    for r in range(4):
        got = W.load(outs[4], "jaxmatch", r)
        for g, w in zip(got["rows"], want["metric_rows"]):
            for k in ("train_loss", "val_loss", "AUC_val"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4 * (k == "AUC_val"),
                                           err_msg=k)
        assert len(got["rows"]) == len(want["metric_rows"]) == 2


# -- run dirs ------------------------------------------------------------------


def test_1x2_run_dir_loads_whole_in_one_process(tp):
    outs, _ = tp
    run = os.path.join(outs[2], "tp-A")
    model, _ = load_model(run, device="cpu", which="last")
    full = W.load(outs[2], "tp-rundir", 0)["full"]["state_dict"]
    fresh = W.build("bimodal")[0].state_dict()
    sd = model.state_dict()
    assert sorted(sd) == sorted(fresh)
    for k, v in sd.items():
        assert v.shape == fresh[k].shape, k
        assert torch.equal(v, full[k]), k
    ckpt = torch.load(os.path.join(run, "last.ckpt"), weights_only=True)
    moments = ckpt["optimizer_states"][0]["state"]
    shapes = sorted(tuple(s["exp_avg"].shape) for s in moments.values())
    assert shapes == sorted(tuple(p.shape) for p in W.build("bimodal")[0].parameters())


def test_1x2_resume_equals_the_uninterrupted_run(tp):
    outs, _ = tp
    for r in range(2):
        got = W.load(outs[2], "tp-rundir", r)
        full, resumed = got["full"], got["resumed"]
        assert full["history"] == resumed["history"]
        for k, v in full["state_dict"].items():
            assert torch.equal(resumed["state_dict"][k], v), k


def test_1x1_resumes_a_1x2_last_ckpt(tp, tmp_path):
    """One process continues run C (2 epochs under 1 x 2) to 3 epochs: its
    third epoch and final weights within 5e-5 of the 1 x 2 run A's."""
    import shutil

    outs, _ = tp
    run = str(tmp_path / "C")
    shutil.copytree(os.path.join(outs[2], "tp-C"), run)
    model, task, tcfg, train, val = W.build("bimodal")
    tcfg.epochs = 3
    got = W.summarize(Trainer(model, task, tcfg, run_dir=run).fit(train, val, resume=True))
    want = W.load(outs[2], "tp-rundir", 0)["full"]
    _same_fit(got, want)


# -- the member axis under a model axis ------------------------------------------


def test_members_over_the_data_axis_of_a_2x2_mesh(tp, tmp_path):
    """4 members over 2 data ranks, each data group's 2 model ranks repeating
    its members: every rank returns every member's results, equal to the
    unsharded stacked run within 1e-5; each member's weights on the ranks
    that train it; only model rank 0 writes."""
    outs, _ = tp
    ref = W.fit_members_on(None, run_dir=str(tmp_path / "one"))
    for r in range(4):
        got = W.load(outs[4], "members", r)
        d, m = divmod(r, 2)
        assert got["local"] == [f"run-{2 * d}", f"run-{2 * d + 1}"]
        for name, want in ref["members"].items():
            for k in ("train_loss", "val_loss"):
                np.testing.assert_allclose(got["members"][name]["history"][k],
                                           want["history"][k], rtol=1e-5, atol=1e-5)
            assert got["members"][name]["epochs_run"] == want["epochs_run"]
        for name in got["local"]:
            for k, v in ref["state_dicts"][name].items():
                np.testing.assert_allclose(got["state_dicts"][name][k].numpy(), v.numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=k)
        writes = got["writes"]
        assert (sum(writes.values()) == 0) == (m == 1), writes
    for name in ref["members"]:
        assert sorted(os.listdir(os.path.join(outs[4], "members", name))) == \
            sorted(os.listdir(tmp_path / "one" / name))
