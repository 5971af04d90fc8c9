"""The port's data- and tensor-parallel fits, the streaming fit over ranks and
the ensemble member axis, as one rank of a gloo process group on the CPU
(tests/test_torch_dp.py, tests/test_torch_tp.py, tests/test_torch_stream_dp.py
and tests/test_torch_ensemble.py spawn the ranks; it imports no jax).

  python tests/torch_dp_worker.py --rank R --world N --tp M \\
      --init file:///tmp/store --out DIR --scenarios bimodal,trimodal,...

Each scenario builds its model, data and trainer config from fixed seeds
(``build``), the same on every rank and in the single process the test
fits for reference, and writes ``<out>/<scenario>-<rank>.pt``: the
per-epoch metric rows, the final state_dict and what the scenario checks
on its own (files written by each rank, the exit skew).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from multimodal_supernovae_tpu_torch.data import make_synthetic_dataset  # noqa: E402
from multimodal_supernovae_tpu_torch.models import (  # noqa: E402
    CLIPConfig,
    CLIPModel,
    MaskedEncoderConfig,
    MaskedLightCurveEncoder,
)
from multimodal_supernovae_tpu_torch.models import transformer as transformer_mod  # noqa: E402
from multimodal_supernovae_tpu_torch.training import Trainer, TrainerConfig  # noqa: E402

SYN = dict(n_max_lc=12, nband=2, n_max_sp=20)
TRI = ("host_galaxy", "lightcurve", "spectral")
N, N_TRAIN = 40, 28
SCENARIOS = ("bimodal", "sigmoid", "trimodal", "regression", "classification", "masked",
             "fused", "jaxmatch", "resume", "skew")
# the (data, model) meshes' scenarios: 1 x 2 on 2 ranks, 2 x 2 on 4
TP_SCENARIOS = {2: ("bimodal", "sigmoid", "trimodal", "masked", "fused", "masks", "tp-rundir"),
                4: ("bimodal", "sigmoid", "trimodal", "regression", "masked", "fused",
                    "jaxmatch", "masks", "members")}
MEMBER_SCENARIOS = ("members", "members-resume")  # the member axis over 2 x 1
STREAM_SCENARIOS = ("stream", "stream-resume", "stream-jaxmatch")  # fit_sharded over 2 x 1
STREAM_ROWS = 10  # the 28 training rows in shards of 10, 10 and 8
TIMEOUT_S = 120  # a rank's subprocess; its process group's collectives time out at 60 s


def start(out, scenarios, world=2, tp=1):
    """Start ``scenarios`` on ``world`` gloo ranks (subprocesses of this file,
    rendezvous through a FileStore in ``out``) laid out as a (world / tp,
    tp) mesh; ``wait`` collects them."""
    import subprocess

    store = os.path.join(out, "store")
    return [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--world", str(world), "--tp", str(tp),
         "--init", f"file://{store}", "--out", out, "--scenarios", ",".join(scenarios)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


def wait(procs):
    """Raise with the ranks' output unless every rank exits 0 within TIMEOUT_S."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"ranks exited {codes}:\n" + "\n".join(o[-3000:] for o in outs))


def spawn(out, scenarios, world=2, tp=1):
    """``start`` then ``wait``."""
    wait(start(out, scenarios, world, tp))


def load(out, name, rank):
    return torch.load(os.path.join(out, f"{name}-{rank}.pt"), weights_only=False)


def _seq(emb=16, heads=2, depth=2, dropout=0.1, agg="mean", **kw):
    return dict({"n_out": 8, "emb": emb, "heads": heads, "depth": depth,
                 "time_norm": 2000.0, "agg": agg, "dropout": dropout}, **kw)


def clip_kwargs(loss="softmax", dropout=0.1, combinations=("lightcurve", "spectral"), **kw):
    return dict(dict(
        combinations=combinations, enc_dim=8, nband=2, logit_scale_init=19.55, loss=loss,
        transformer_kwargs=_seq(dropout=dropout, agg="attn"),
        transformer_spectral_kwargs=_seq(dropout=dropout),
        conv_kwargs={"dim": 8, "depth": 2, "kernel_size": 3, "patch_size": 4, "n_out": 8,
                     "dropout_prob": dropout}), **kw)


def _split(ds):
    return ds.subset(np.arange(N_TRAIN)), ds.subset(np.arange(N_TRAIN, N))


def build(name: str, seed: int = 0):
    """(model, task, TrainerConfig, train_ds, val_ds) of a scenario, on the
    CPU: every draw on (magnitude noise 1.0, dropout, and for the trimodal
    model image noise and turns), global B = 8."""
    tcfg = dict(epochs=2, batch_size=8, lr=1e-3, noise_level_mag=1.0, seed=seed)
    modalities = ("lightcurve", "spectral")
    gen = torch.Generator().manual_seed(seed)
    task = "contrastive"
    if name in ("bimodal", "resume", "skew"):
        model = CLIPModel(CLIPConfig.create(**clip_kwargs()), generator=gen)
    elif name == "jaxmatch":  # the JAX package's draws differ: no noise, no dropout
        model = CLIPModel(CLIPConfig.create(**clip_kwargs(dropout=0.0)), generator=gen)
        tcfg.update(noise_level_mag=0.0)
    elif name == "sigmoid":
        model = CLIPModel(CLIPConfig.create(**clip_kwargs("sigmoid")), generator=gen)
    elif name == "trimodal":
        modalities = TRI
        model = CLIPModel(CLIPConfig.create(**clip_kwargs(combinations=TRI)), generator=gen)
        tcfg.update(noise_level_img=0.5)
    elif name == "regression":
        task = "regression"
        model = CLIPModel(CLIPConfig.create(**clip_kwargs(regression=True)), generator=gen)
    elif name == "classification":
        task = "classification"
        model = CLIPModel(CLIPConfig.create(**clip_kwargs(classification=True)),
                          generator=gen)
    elif name == "masked":
        task = "masked"
        model = MaskedLightCurveEncoder(MaskedEncoderConfig.create(
            nband=2, transformer_kwargs={"emb": 16, "heads": 2, "depth": 2,
                                         "time_norm": 2000.0, "dropout": 0.1}),
            generator=gen)
    elif name == "fused":
        # the light-curve tower on the fused block, the spectral tower on the
        # fused QKV attention (dropout 0, widths both take)
        lc = _seq(emb=64, heads=4, depth=1, dropout=0.0, use_fused_block=True)
        sp = _seq(emb=64, heads=4, depth=1, dropout=0.0)
        model = CLIPModel(CLIPConfig.create(**clip_kwargs(
            transformer_kwargs=lc, transformer_spectral_kwargs=sp)), generator=gen)
    else:
        raise ValueError(f"unknown scenario {name!r}")
    ds = make_synthetic_dataset(n=N, seed=seed, modalities=modalities,
                                image_size=12, **SYN)
    train, val = _split(ds)
    return model, task, TrainerConfig(**tcfg), train, val


class fused_opt_ins:
    """``MMSN_FUSED_QKV=1`` with the QKV route's device predicate forced
    true, so the CPU takes the fused modules (their plain versions)."""

    def __enter__(self):
        self.env, self.on_card = os.environ.get("MMSN_FUSED_QKV"), transformer_mod._on_card
        os.environ["MMSN_FUSED_QKV"] = "1"
        transformer_mod._on_card = lambda x: True

    def __exit__(self, *exc):
        transformer_mod._on_card = self.on_card
        if self.env is None:
            os.environ.pop("MMSN_FUSED_QKV", None)
        else:
            os.environ["MMSN_FUSED_QKV"] = self.env


def summarize(res) -> dict:
    """A fit's rows and history, its full (gathered) state_dict and the
    parameters the loss did not reach."""
    from multimodal_supernovae_tpu_torch.parallel import gather_state_dict

    model = res["state"].model
    return {"rows": res["metric_rows"], "history": res["history"],
            "state_dict": {k: v.detach().clone() for k, v in gather_state_dict(model).items()},
            "grad_none": sorted(n for n, p in model.named_parameters() if p.grad is None)}


def fit(name: str, mesh=None, run_dir=None, state_dict=None, **tcfg_overrides) -> dict:
    model, task, tcfg, train, val = build(name)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    for k, v in tcfg_overrides.items():
        setattr(tcfg, k, v)
    trainer = Trainer(model, task, tcfg, run_dir=run_dir, mesh=mesh)
    if name == "fused":
        with fused_opt_ins():
            return summarize(trainer.fit(train, val))
    return summarize(trainer.fit(train, val))


class _Writes:
    """Counts the run-directory writes of this process."""

    def __init__(self):
        from multimodal_supernovae_tpu_torch.training import checkpoint, trainer

        self.counts = {"ckpt": 0, "sidecars": 0, "logger": 0}
        save, sidecars, logger = checkpoint._save, trainer.save_run_sidecars, trainer.MetricsLogger

        def counted(key, fn):
            def wrapped(*a, **kw):
                self.counts[key] += 1
                return fn(*a, **kw)
            return wrapped

        checkpoint._save = counted("ckpt", save)
        trainer.save_run_sidecars = counted("sidecars", sidecars)
        trainer.MetricsLogger = counted("logger", logger)


GLOBAL_B, DIM = 12, 8


def global_embeddings(n_modalities=3):
    """The global batch's L2-normalised embeddings, from a fixed seed."""
    rng = np.random.default_rng(0)
    embs = [rng.normal(size=(GLOBAL_B, DIM)).astype(np.float32) for _ in range(n_modalities)]
    return [torch.from_numpy(e / np.linalg.norm(e, axis=-1, keepdims=True)) for e in embs]


def sharded_losses(mesh) -> dict:
    """The sharded CLIP and SigLIP losses of this rank's rows, their
    gradients, and a linear tower's gradients after ``average_gradients``."""
    from multimodal_supernovae_tpu_torch.ops import losses as L

    rows = mesh.block(GLOBAL_B)
    out = {}
    for kind, fn in (("clip", L.clip_loss_multimodal_sharded),
                     ("sigmoid", L.sigmoid_loss_multimodal_sharded)):
        embs = [e[rows].clone().requires_grad_(True) for e in global_embeddings()]
        scale = torch.tensor([2.0, 1.5, 2.5], requires_grad=True)
        bias = torch.tensor(-1.0, requires_grad=True)
        loss = fn(embs, scale, bias, mesh)
        loss.backward()
        out[kind] = {"loss": loss.item(), "grads": [e.grad for e in embs],
                     "scale": scale.grad, "bias": bias.grad}
    # a tower: a linear layer from fixed inputs, its gradient averaged over ranks
    torch.manual_seed(0)
    tower = torch.nn.Linear(DIM, DIM)
    x = [e[rows] for e in global_embeddings(2)]
    loss = L.clip_loss_multimodal_sharded([tower(x[0]), x[1]], torch.tensor(2.0),
                                          torch.tensor(-1.0), mesh)
    loss.backward()
    mesh.average_gradients(tower.parameters())
    out["tower"] = {n: p.grad for n, p in tower.named_parameters()}
    return out


def autograd_collectives(mesh) -> dict:
    """all_gather and all_reduce forward and backward on this rank's rows."""
    w = torch.arange(GLOBAL_B * 2, dtype=torch.float32).reshape(GLOBAL_B, 2)
    x = (torch.arange(GLOBAL_B // mesh.size * 2, dtype=torch.float32).reshape(-1, 2)
         + 100.0 * mesh.rank).requires_grad_(True)
    gathered = mesh.all_gather(x)
    (gathered * w).sum().backward()
    y = x.detach().clone().requires_grad_(True)
    reduced = mesh.all_reduce(y)
    (reduced * w[mesh.block(GLOBAL_B)]).sum().backward()
    return {"gathered": gathered.detach(), "gather_grad": x.grad,
            "reduced": reduced.detach(), "reduce_grad": y.grad,
            "labels": mesh.all_gather(torch.tensor([mesh.rank, 7]))}


def keep_masks(mesh, seed=5) -> list:
    """(split_cols, keep mask) of every dropout draw of one train-mode loss of
    the (sharded) trimodal model on this rank's rows, drawn through
    ``RankRows`` (a one-process mesh: the global draws)."""
    from multimodal_supernovae_tpu_torch.data.batching import take
    from multimodal_supernovae_tpu_torch.parallel import batch_stats_over, shard_module
    from multimodal_supernovae_tpu_torch.utils.draws import RankRows

    model, _, _, train, _ = build("trimodal")
    shard_module(model, mesh)
    seen = []

    class Recording(RankRows):
        def keep_mask(self, x, keep_prob, split_cols=False):
            keep = super().keep_mask(x, keep_prob, split_cols)
            seen.append((split_cols, keep.clone()))
            return keep

    batch = take(train.to_device("cpu"), torch.arange(8)[mesh.block(8)])
    with batch_stats_over(model, mesh):
        model.loss_fn(batch, train=True, mesh=mesh,
                      generator=Recording(torch.Generator().manual_seed(seed), mesh))
    return seen


def members_setup():
    """(models, TrainerConfig, dataset, members) of the member-axis
    scenarios: 4 members of the small CLIP model (dropout and noise on),
    two learning rates, each its own seed and rolled split."""
    from multimodal_supernovae_tpu_torch.training.ensemble import Member

    ds = make_synthetic_dataset(n=32, seed=4, modalities=("lightcurve", "spectral"),
                                image_size=12, **SYN)
    idx = np.arange(32)
    members = [Member(f"run-{i}", i, np.roll(idx, 8 * i)[:24], np.roll(idx, 8 * i)[24:],
                      lr=3e-3 if i % 2 else 1e-3) for i in range(4)]
    models = [CLIPModel(CLIPConfig.create(**clip_kwargs()),
                        generator=torch.Generator().manual_seed(m.seed)) for m in members]
    return models, TrainerConfig(epochs=2, batch_size=8, lr=1e-3, noise_level_mag=1.0), ds, \
        members


def fit_members_on(mesh=None, run_dir=None, **tcfg_overrides) -> dict:
    """``fit_members`` of ``members_setup`` (over ``mesh``'s data axis):
    every member's host results, this rank's members' state_dicts."""
    from multimodal_supernovae_tpu_torch.training.ensemble import fit_members

    models, tcfg, ds, members = members_setup()
    for k, v in tcfg_overrides.items():
        setattr(tcfg, k, v)
    res = fit_members(models, "contrastive", tcfg, ds, members, run_dir=run_dir, mesh=mesh,
                      resume=bool(tcfg_overrides))
    return {"members": {n: {k: r.get(k) for k in ("history", "metric_rows", "best",
                                                   "epochs_run", "best_ckpt_epoch")}
                        for n, r in res["members"].items()},
            "local": res["local"],
            "state_dicts": {n: {k: v.detach().clone() for k, v in
                                res["members"][n]["state"].model.state_dict().items()}
                            for n in res["local"]}}


def _member_writes():
    """Counts this process's writes of member run dirs and stacked checkpoints."""
    from multimodal_supernovae_tpu_torch.training import checkpoint
    from multimodal_supernovae_tpu_torch.training import ensemble as ensemble_mod

    counts = {"ckpt": 0, "sidecars": 0, "logger": 0, "stacked": 0}

    def counted(key, fn):
        def wrapped(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return wrapped

    checkpoint._save = counted("ckpt", checkpoint._save)
    ensemble_mod.save_run_sidecars = counted("sidecars", ensemble_mod.save_run_sidecars)
    ensemble_mod.MetricsLogger = counted("logger", ensemble_mod.MetricsLogger)
    ensemble_mod.EnsembleCheckpoint.save = counted("stacked", ensemble_mod.EnsembleCheckpoint.save)
    return counts


def write_stream_cache(out) -> None:
    """The bimodal scenario's training rows as the sharded cache
    ``<out>/stream-cache`` (data/streaming.py)."""
    from multimodal_supernovae_tpu_torch.data.streaming import write_sharded_cache

    train = build("bimodal")[3]
    write_sharded_cache(os.path.join(out, "stream-cache"), iter([train.arrays]), STREAM_ROWS)


def fit_stream(out, mesh=None, run_dir=None, resume=False, name="bimodal", state_dict=None,
               **tcfg_overrides) -> dict:
    """``fit_sharded`` of the bimodal (or ``name``'s) scenario over
    ``<out>/stream-cache``."""
    from multimodal_supernovae_tpu_torch.data.streaming import ShardedDataset

    model, task, tcfg, _, val = build(name)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    for k, v in tcfg_overrides.items():
        setattr(tcfg, k, v)
    sds = ShardedDataset(os.path.join(out, "stream-cache"))
    trainer = Trainer(model, task, tcfg, run_dir=run_dir, mesh=mesh)
    return summarize(trainer.fit_sharded(sds, val, resume=resume))


def tp_run_dirs(mesh, out) -> dict:
    """The bimodal fit into run dirs: A (3 epochs), B (2, then resumed to 3)
    and C (2 epochs, which the test resumes in one process)."""
    full = fit("bimodal", mesh, run_dir=os.path.join(out, "tp-A"), epochs=3)
    fit("bimodal", mesh, run_dir=os.path.join(out, "tp-B"), epochs=2)
    fit("bimodal", mesh, run_dir=os.path.join(out, "tp-C"), epochs=2)
    model, task, tcfg, train, val = build("bimodal")
    tcfg.epochs = 3
    resumed = summarize(Trainer(model, task, tcfg, run_dir=os.path.join(out, "tp-B"),
                                mesh=mesh).fit(train, val, resume=True))
    return {"full": full, "resumed": resumed}


def run_scenario(name: str, mesh, out: str) -> dict:
    if name == "losses":
        return sharded_losses(mesh)
    if name == "autograd":
        return autograd_collectives(mesh)
    if name == "masks":
        return {"masks": keep_masks(mesh)}
    if name == "tp-rundir":
        return tp_run_dirs(mesh, out)
    if name == "members":
        writes = _member_writes()
        got = fit_members_on(mesh, run_dir=os.path.join(out, "members"))
        return dict(got, writes=writes)
    if name == "members-resume":  # 1 epoch, then resumed to 2, under the same mesh
        fit_members_on(mesh, run_dir=os.path.join(out, "members-R"), epochs=1)
        return fit_members_on(mesh, run_dir=os.path.join(out, "members-R"), epochs=2)
    if name == "stream":
        return fit_stream(out, mesh)
    if name == "stream-resume":  # A 3 epochs; B 2, then resumed to 3 under the same mesh
        writes = _Writes()
        full = fit_stream(out, mesh, run_dir=os.path.join(out, "stream-A"), epochs=3)
        fit_stream(out, mesh, run_dir=os.path.join(out, "stream-B"), epochs=2)
        resumed = fit_stream(out, mesh, run_dir=os.path.join(out, "stream-B"), resume=True,
                             epochs=3)
        return {"full": full, "resumed": resumed, "writes": writes.counts}
    if name == "stream-jaxmatch":
        return fit_stream(out, mesh, name="jaxmatch",
                          state_dict=torch.load(os.path.join(out, "jaxmatch.init.pt")))
    if name == "jaxmatch":
        return fit(name, mesh, state_dict=torch.load(os.path.join(out, "jaxmatch.init.pt")))
    if name == "resume":
        writes = _Writes()
        full = fit("bimodal", mesh, run_dir=os.path.join(out, "resume-A"), epochs=3)
        fit("bimodal", mesh, run_dir=os.path.join(out, "resume-B"), epochs=2)
        model, task, tcfg, train, val = build("bimodal")
        tcfg.epochs = 3
        resumed = summarize(Trainer(model, task, tcfg, run_dir=os.path.join(out, "resume-B"),
                                    mesh=mesh).fit(train, val, resume=True))
        return {"full": full, "resumed": resumed, "writes": writes.counts}
    if name == "skew":
        from multimodal_supernovae_tpu_torch.utils import logging as logging_mod

        run_dir = os.path.join(out, "skew")
        if mesh.rank == 0:  # rank 0 stalls in its last write
            set_summary = logging_mod.MetricsLogger.set_summary

            def slow(self, **kv):
                time.sleep(3.0)
                return set_summary(self, **kv)

            logging_mod.MetricsLogger.set_summary = slow
        t0 = time.perf_counter()
        res = fit("bimodal", mesh, run_dir=run_dir, epochs=1)
        return {"history": res["history"], "fit_s": time.perf_counter() - t0,
                "summary_at_return": os.path.exists(os.path.join(run_dir, "summary.json"))}
    return fit(name, mesh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--tp", type=int, default=1, help="the model axis's size")
    ap.add_argument("--init", required=True, help="the process group's init URL")
    ap.add_argument("--out", required=True)
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args(argv)
    from multimodal_supernovae_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.initialize(args.init, args.world, args.rank, device="cpu",
                           timeout=args.timeout)
    mesh = distributed.make_global_mesh(n_model=args.tp)
    try:
        for name in args.scenarios.split(","):
            torch.save(run_scenario(name, mesh, args.out),
                       os.path.join(args.out, f"{name}-{args.rank}.pt"))
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
