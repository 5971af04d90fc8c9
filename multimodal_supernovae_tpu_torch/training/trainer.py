"""The training loop (port of ``Trainer.fit`` in
multimodal_supernovae_tpu/training/trainer.py, for the contrastive,
regression, classification and masked-pretraining tasks):

  host                          device
  ----                          ------
  epoch index plan       ->     per step: gather the batch from the
  (shuffled, wrapped)             device-resident dataset, augment,
                                  loss, backward, RAdam update
  epoch metrics          <-     per-step losses, eval embeddings /
                                  predictions / logits

Per epoch the host reads the mean train loss (and aborts on a non-finite
one), the validation loss and the task's metrics (``compute_task_metrics``:
the retrieval ``AUC_val`` of two modalities, ``AUC_val1..k`` and
``AUC_val_mean`` of more, ``R2_val``, ``f1_val``; the masked task has the
validation loss only), and stops early when the monitored metric
(``val_loss``/min by default, ``f1_val``/max for classification) has not
improved for ``patience`` epochs. Validation batches with images are
rotated, and masked pretraining's validation masks drawn, from a generator
of the trainer's own; its training masks come from the training generator
with the noise and dropout.

With a ``run_dir`` the run directory is the JAX package's: the sidecars
(``config.yaml``, the split manifests, ``model_config.json``), a
``metrics.jsonl`` row an epoch and ``summary.json`` (utils/logging.py), and
the best ``keep_best`` checkpoints plus ``last.ckpt`` (training/checkpoint.py).
``fit(resume=True)`` continues the run from ``last.ckpt``: the model (its
BatchNorm running statistics included), the optimizer, the scheduler, the
epoch counter, the three random streams (shuffles, training draws,
validation rotations) and the early-stopping state, so that it replays what
the run would have done had it not stopped.

``freeze`` is a predicate over parameter paths (training/optim.py): the
parameters it picks stay out of the optimizer.

``mesh`` (a ``parallel.mesh.DataMesh``, one process a card) trains over a
``(data, model)`` mesh and equals the one-process fit at the global batch:
every rank builds the same global (steps, B) plan from the shared seed and
takes its data rank's block of columns (the JAX ``P(None, DATA_AXIS)``); its
draws come from a ``utils.draws.RankRows`` over the shared generators, so
the noise, the image turns, the dropout and the masked-pretraining masks are
those of the global batch; the losses, validation outputs and BatchNorm
statistics span the global batch and the gradients are averaged over the
data ranks (training/step.py). B must divide by the data ranks. Under a
model axis the model is sharded at construction (``parallel.sharding.
shard_module``: the FFNs and the ConvMixer head split Megatron-style), so
the optimizer's moments are per slice. Only rank 0 writes the run
directory (sidecars, ``metrics.jsonl``, ``summary.json``, checkpoints; the
checkpoints hold the full tensors, gathered over the model group, so a
tensor-parallel run dir loads in one process and resumes under any mesh);
every rank restores ``last.ckpt`` on resume, and a barrier at the end of
``fit`` holds the others until rank 0 has written.

Not ported yet, and raising ``NotImplementedError``: ``fit_sharded``
(ROADMAP.md queue 1, item 17b). Stacked ensemble members train through
``training/ensemble.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.batching import ArrayDataset, epoch_indices
from ..models.factory import write_model_config
from ..ops.metrics import macro_f1, r2_score, retrieval_auc
from ..parallel.mesh import batch_stats_over
from ..parallel.sharding import shard_module
from ..utils.draws import RankRows
from ..utils.logging import MetricsLogger
from .checkpoint import CheckpointManager, save_run_sidecars
from .optim import build_optimizer
from .state import TrainState
from .step import make_epoch_runner, make_eval_runner


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 10
    batch_size: int = 32
    lr: float = 1e-4
    weight_decay: float = 0.0
    patience: int = 10**9  # early-stopping patience (epochs)
    seed: int = 0
    noise_level_img: float = 0.0
    noise_level_mag: float = 0.0
    rotate_images: bool = True  # train and eval batches with images
    # lr schedule (masked pretraining's StepLR)
    step_size: Optional[int] = None
    gamma: Optional[float] = None
    # monitored metric for checkpoints and early stopping: None = val_loss, min
    monitor: Optional[str] = None
    mode: Optional[str] = None  # 'min' | 'max'
    keep_best: int = 2
    eval_every_epochs: int = 1


TASKS = ("contrastive", "regression", "classification", "masked")


class Trainer:
    """Trains a module exposing ``loss_fn(batch, train, generator)`` on the
    device its parameters are on."""

    def __init__(self, model, task: str, cfg: TrainerConfig,
                 run_dir: Optional[str] = None, mesh=None, freeze=None,
                 use_wandb: bool = False, n_classes: Optional[int] = None):
        if task not in TASKS:
            raise ValueError(f"unknown task {task!r}: expected one of {TASKS}")
        if mesh is not None:
            # the full weights every rank built from the shared seed, sliced
            # over the model axis before any optimizer sees them
            shard_module(model, mesh)
        self.model = model
        self.mesh = mesh
        self.task = task
        self.cfg = cfg
        self.run_dir = run_dir
        self.freeze = freeze
        self.use_wandb = use_wandb
        # the classes f1_val averages over are the model's own; the argument
        # (kept for the JAX Trainer's signature) may only restate them
        own = getattr(getattr(model, "cfg", None), "n_classes", None)
        if n_classes is not None and own is not None and n_classes != own:
            raise ValueError(f"n_classes={n_classes} disagrees with the model's "
                             f"config, n_classes={own}")
        self.n_classes = n_classes or own or 5
        # the reference's defaults: classification monitors f1_val (max),
        # every other task val_loss (min)
        monitor, mode = ("f1_val", "max") if task == "classification" else ("val_loss", "min")
        self.monitor = cfg.monitor or monitor
        self.mode = cfg.mode or mode
        # set from the training set size before init_state so epoch-based lr
        # schedules (StepLR) convert to optimizer steps correctly
        self._steps_per_epoch = 1

    def set_dataset_size(self, n_train: int) -> None:
        self._steps_per_epoch = max(1, -(-n_train // self.cfg.batch_size))

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def init_state(self) -> TrainState:
        """The optimizer and scheduler over the model's current weights."""
        cfg = self.cfg
        opt, sched = build_optimizer(
            self.model.named_parameters(), lr=cfg.lr,
            weight_decay=cfg.weight_decay, step_size=cfg.step_size,
            gamma=cfg.gamma, steps_per_epoch=self._steps_per_epoch,
            freeze=self.freeze)
        return TrainState(self.model, opt, sched)

    def _better(self, current: float, best: Optional[float]) -> bool:
        return (best is None or (self.mode == "min" and current < best)
                or (self.mode == "max" and current > best))

    def fit(self, train_ds: ArrayDataset, val_ds: ArrayDataset,
            config_dump: Optional[Dict[str, Any]] = None,
            state: Optional[TrainState] = None, resume: bool = False) -> Dict[str, Any]:
        """Train for ``cfg.epochs`` epochs with early stopping. Returns the
        state, the per-epoch ``history``, ``metric_rows`` (train_loss,
        step_time_s, samples_per_s, val_loss and the task's metrics), ``best``,
        ``epochs_run``, ``wall_time_s`` and, with a run directory,
        ``best_ckpt_epoch``. ``config_dump`` is what ``config.yaml`` records
        (default: the trainer config). ``resume=True`` continues the run in
        ``run_dir`` from its ``last.ckpt`` (from the start when it has none);
        the history, rows and best then cover the whole run."""
        if resume and not self.run_dir:
            raise ValueError("resume=True needs the run_dir of the run to continue")
        mesh = self.mesh
        if mesh is not None:
            mesh.local(self.cfg.batch_size)  # raises unless the ranks divide B
        with batch_stats_over(self.model, mesh):
            if not self.run_dir:
                result = self._fit(train_ds, val_ds, state, resume, None, None)
            else:
                result = self._fit_in_run_dir(train_ds, val_ds, config_dump, state, resume)
        if mesh is not None:
            mesh.barrier()  # rank 0 has written everything before any rank returns
        return result

    def _fit_in_run_dir(self, train_ds, val_ds, config_dump, state, resume):
        cfg = self.cfg
        is_main = self.mesh is None or self.mesh.is_main
        if is_main:
            save_run_sidecars(self.run_dir, config_dump or dataclasses.asdict(cfg),
                              train_ds.filenames, val_ds.filenames)
            write_model_config(self.run_dir, self.model)
        if self.mesh is not None:
            self.mesh.barrier()  # the run dir exists before any rank reads it
        ckpts = CheckpointManager(self.run_dir, self.monitor, self.mode, cfg.keep_best,
                                  write=is_main)
        logger = MetricsLogger(self.run_dir, use_wandb=self.use_wandb) if is_main else None
        try:
            return self._fit(train_ds, val_ds, state, resume, logger, ckpts)
        finally:
            if logger:
                logger.close()

    def _fit(self, train_ds, val_ds, state, resume, logger, ckpts):
        cfg = self.cfg
        device = self.device
        mesh = self.mesh
        rng = np.random.default_rng(cfg.seed)
        generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        eval_generator = torch.Generator(device=device).manual_seed(cfg.seed + 2)
        # a rank's columns of a global plan, and its rows of each global draw
        cols = slice(None) if mesh is None else mesh.block(cfg.batch_size)
        draws = generator if mesh is None else RankRows(generator, mesh)
        eval_draws = eval_generator if mesh is None else RankRows(eval_generator, mesh)
        self.set_dataset_size(len(train_ds))
        train_data = train_ds.to_device(device)
        val_data = val_ds.to_device(device)
        if state is None:
            state = self.init_state()
        history: Dict[str, List[float]] = {"train_loss": [], "val_loss": []}
        metric_rows: List[Dict[str, float]] = []
        best = {"value": None, "epoch": -1}
        since_best = 0
        start_epoch = 0
        if resume:
            restored = ckpts.try_restore_last(state)
            if restored is not None:
                state, last_epoch, loop = restored
                start_epoch = last_epoch + 1
                rng.bit_generator.state = loop["numpy_rng"]
                generator.set_state(loop["torch_rng"])
                if "eval_torch_rng" in loop:
                    eval_generator.set_state(loop["eval_torch_rng"])
                history, metric_rows = loop["history"], loop["metric_rows"]
                best, since_best = loop["best"], loop["since_best"]
        run_epoch = make_epoch_runner(
            self.model, cfg.noise_level_mag, noise_level_img=cfg.noise_level_img,
            rotate_images=cfg.rotate_images, mesh=mesh)
        run_eval = make_eval_runner(self.model, rotate_images=cfg.rotate_images, mesh=mesh)
        # fixed-shape eval plan: sequential, the tail repeats the last sample
        # and is trimmed after flattening
        val_plan = torch.from_numpy(np.ascontiguousarray(epoch_indices(
            len(val_ds), cfg.batch_size, shuffle=False, pad="repeat_last")[:, cols])).to(device)
        n_val = len(val_ds)
        t_start = time.perf_counter()

        epoch = start_epoch - 1  # when already complete, no epochs run
        # a run that had stopped early stays stopped
        epochs = range(start_epoch, cfg.epochs if since_best < cfg.patience else 0)
        for epoch in epochs:
            plan = epoch_indices(len(train_ds), cfg.batch_size, rng=rng,
                                 shuffle=True, pad="wrap")
            t0 = time.perf_counter()
            state, losses = run_epoch(state, train_data, plan[:, cols], draws)
            train_loss = float(losses.mean())  # waits for the epoch's steps
            if not np.isfinite(train_loss):
                if logger:
                    logger.log({"epoch": epoch, "train_loss": train_loss,
                                "aborted": "non-finite loss"}, step=epoch)
                raise FloatingPointError(
                    f"non-finite training loss at epoch {epoch}; last finite "
                    f"epoch metrics: {metric_rows[-1] if metric_rows else None}")
            step_time = (time.perf_counter() - t0) / plan.shape[0]
            history["train_loss"].append(train_loss)
            metrics: Dict[str, float] = {
                "epoch": epoch,
                "train_loss": train_loss,
                "step_time_s": step_time,
                "samples_per_s": plan.shape[1] / max(step_time, 1e-9),
            }
            if epoch % cfg.eval_every_epochs == 0:
                val_losses, aux = run_eval(state, val_data, val_plan, eval_draws)
                metrics["val_loss"] = float(val_losses.mean())
                history["val_loss"].append(metrics["val_loss"])
                metrics.update(compute_task_metrics(self.task, aux, val_ds, n_val,
                                                    self.n_classes))
            metric_rows.append(metrics)
            if logger:
                logger.log(metrics, step=epoch)

            # early stopping on the monitored metric
            if self.monitor in metrics:
                if self._better(metrics[self.monitor], best["value"]):
                    best = {"value": metrics[self.monitor], "epoch": epoch}
                    since_best = 0
                else:
                    since_best += 1
            if ckpts:
                ckpts.save(epoch, state, metrics, loop={
                    "numpy_rng": rng.bit_generator.state,
                    "torch_rng": generator.get_state(),
                    "eval_torch_rng": eval_generator.get_state(),
                    "history": history, "metric_rows": metric_rows,
                    "best": best, "since_best": since_best})
            if since_best >= cfg.patience:  # Lightning's wait_count >= patience
                break

        result = {
            "state": state,
            "history": history,
            "metric_rows": metric_rows,
            "best": best,
            "epochs_run": epoch + 1,
            "wall_time_s": time.perf_counter() - t_start,
        }
        if ckpts:
            result["best_ckpt_epoch"] = ckpts.best_epoch()
        if logger:
            # the run summary of the JAX trainer (the reference's
            # script_wandb.py:248-253)
            summary = {
                f"best_{self.monitor}": best["value"],
                "best_epoch": best["epoch"],
                "best_ckpt_epoch": result["best_ckpt_epoch"],
            }
            if history["val_loss"]:
                summary["best_val_loss"] = float(np.min(history["val_loss"]))
            aucs = [m["AUC_val"] for m in metric_rows if "AUC_val" in m]
            if aucs:
                summary["best_auc"] = float(np.max(aucs))
            logger.set_summary(**summary)
        return result

    def fit_sharded(self, *args, **kwargs):
        raise NotImplementedError(
            "fit_sharded is not ported yet (ROADMAP.md queue 1, item 17b: streaming)")


def compute_task_metrics(task: str, aux: Dict[str, Any], val_ds: ArrayDataset,
                         n_val: int, n_classes: int = 5) -> Dict[str, float]:
    """Per-task validation metrics from the eval loop's stacked auxiliary
    outputs, trimmed to ``n_val`` (the JAX ``compute_task_metrics``):
    contrastive, the retrieval ``AUC_val`` of two modalities, or
    ``AUC_val1..k`` over every pair (i < j, in order) and their mean
    ``AUC_val_mean``; regression, ``R2_val`` against ``val_ds``'s redshift;
    classification, the macro ``f1_val`` of the argmax against its labels;
    masked, none (the validation loss only)."""
    out: Dict[str, float] = {}
    if task == "contrastive":
        embs = [e.reshape(-1, e.shape[-1])[:n_val] for e in aux["embeddings"]]
        if len(embs) == 2:
            out["AUC_val"] = float(retrieval_auc(embs[0], embs[1]))
        else:
            aucs = [float(retrieval_auc(embs[i], embs[j]))
                    for i in range(len(embs) - 1) for j in range(i + 1, len(embs))]
            out.update({f"AUC_val{n + 1}": a for n, a in enumerate(aucs)})
            out["AUC_val_mean"] = float(np.mean(aucs))
    elif task == "regression":
        pred = aux["pred"].reshape(-1)[:n_val]
        true = torch.from_numpy(val_ds.arrays["redshift"][:n_val]).to(pred.device)
        out["R2_val"] = float(r2_score(true, pred))
    elif task == "classification":
        logits = aux["logits"]
        pred = logits.reshape(-1, logits.shape[-1])[:n_val].argmax(dim=-1)
        true = torch.from_numpy(val_ds.arrays["label"][:n_val]).to(pred.device)
        out["f1_val"] = float(macro_f1(true, pred, n_classes))
    return out
