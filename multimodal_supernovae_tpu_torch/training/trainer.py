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

``fit_sharded`` trains over a sharded on-disk cache (data/streaming.py), a
corpus larger than the card's memory, shard by shard: per epoch a shuffled
shard order, each shard's steps over that shard alone on the device, the
next shard's upload under the current one's steps (training/shard_feed.py),
and the validation split on the device throughout; the evaluation,
checkpoint and early-stopping cadence is ``fit``'s. After every shard a
``StreamCursor`` (training/checkpoint.py) records where the epoch stands, and
``fit_sharded(resume=True)`` continues from the next shard. Under a mesh
every rank walks the same shard order and holds each whole shard on its card,
as ``fit`` holds its dataset, and takes its data rank's block of each step's
columns, with ``fit``'s draws, collectives and gradient mean, so the fit
equals the one-process ``fit_sharded`` at the global batch. As in the JAX
package the cursor is kept in one process only: a mesh of several processes
resumes from ``last.ckpt`` at the epoch boundary, with the random streams
(shard orders and draws) of the finished epochs restored from it.

Stacked ensemble members train through ``training/ensemble.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.batching import ArrayDataset, epoch_indices
from ..models.factory import write_model_config
from ..ops.metrics import macro_f1, r2_score, retrieval_auc
from ..parallel.mesh import batch_stats_over
from ..parallel.sharding import shard_module
from ..utils.draws import RankRows
from ..utils.logging import MetricsLogger
from .checkpoint import CheckpointManager, StreamCursor, save_run_sidecars
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

    def _open_run_dir(self, config_dump, train_names, val_names):
        """(checkpoints, logger or None) of the run directory, whose sidecars
        rank 0 (or the one process) writes first; only it writes."""
        is_main = self.mesh is None or self.mesh.is_main
        if is_main:
            save_run_sidecars(self.run_dir, config_dump or dataclasses.asdict(self.cfg),
                              train_names, val_names)
            write_model_config(self.run_dir, self.model)
        if self.mesh is not None:
            self.mesh.barrier()  # the run dir exists before any rank reads it
        ckpts = CheckpointManager(self.run_dir, self.monitor, self.mode, self.cfg.keep_best,
                                  write=is_main)
        logger = MetricsLogger(self.run_dir, use_wandb=self.use_wandb) if is_main else None
        return ckpts, logger

    def _fit_in_run_dir(self, train_ds, val_ds, config_dump, state, resume):
        ckpts, logger = self._open_run_dir(config_dump, train_ds.filenames, val_ds.filenames)
        try:
            return self._fit(train_ds, val_ds, state, resume, logger, ckpts)
        finally:
            if logger:
                logger.close()

    @staticmethod
    def _restore_last(ckpts, state, rng, generator, eval_generator, book):
        """The epoch-boundary resume: ``last.ckpt`` into ``state`` and the
        random streams (the shuffles' ``rng``, the draws, the validation
        draws) and the book as they stood after its epoch. Returns (state,
        the epoch to start at, book); (state, 0, book) without a checkpoint."""
        restored = ckpts.try_restore_last(state)
        if restored is None:
            return state, 0, book
        state, last_epoch, loop = restored
        rng.bit_generator.state = loop["numpy_rng"]
        generator.set_state(loop["torch_rng"])
        if "eval_torch_rng" in loop:
            eval_generator.set_state(loop["eval_torch_rng"])
        return state, last_epoch + 1, {k: loop[k] for k in book}

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
        book = _new_book()
        start_epoch = 0
        if resume:
            state, start_epoch, book = self._restore_last(ckpts, state, rng, generator,
                                                          eval_generator, book)
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

        def rng_states():
            return {"numpy_rng": rng.bit_generator.state, "torch_rng": generator.get_state(),
                    "eval_torch_rng": eval_generator.get_state()}

        def evaluate():
            val_losses, aux = run_eval(state, val_data, val_plan, eval_draws)
            return float(val_losses.mean()), compute_task_metrics(
                self.task, aux, val_ds, n_val, self.n_classes)

        epoch = start_epoch - 1  # when already complete, no epochs run
        # a run that had stopped early stays stopped
        for epoch in range(start_epoch, cfg.epochs if not self._stopped(book) else 0):
            plan = epoch_indices(len(train_ds), cfg.batch_size, rng=rng,
                                 shuffle=True, pad="wrap")
            t0 = time.perf_counter()
            state, losses = run_epoch(state, train_data, plan[:, cols], draws)
            train_loss = float(losses.mean())  # waits for the epoch's steps
            step_time = (time.perf_counter() - t0) / plan.shape[0]
            if self._close_epoch(book, epoch, train_loss, step_time, plan.shape[1], evaluate,
                                 state, logger, ckpts, rng_states):
                break
        return self._result(book, state, epoch, t_start, logger, ckpts)

    def _close_epoch(self, book, epoch: int, train_loss: float, step_time: float,
                     samples: int, evaluate, state, logger, ckpts, rng_states) -> bool:
        """The end of an epoch of ``fit`` or ``fit_sharded``: abort on a
        non-finite loss (after logging a row), append the epoch's metrics
        (on evaluation epochs also ``evaluate()``'s validation loss and task
        metrics) to ``book`` and the log, keep the early-stopping state,
        and save the checkpoints with ``rng_states()`` (taken after the
        evaluation's draws) and ``book`` as their ``loop``. Returns whether
        early stopping ends the run."""
        if not np.isfinite(train_loss):
            if logger:
                logger.log({"epoch": epoch, "train_loss": train_loss,
                            "aborted": "non-finite loss"}, step=epoch)
            rows = book["metric_rows"]
            raise FloatingPointError(
                f"non-finite training loss at epoch {epoch}; last finite "
                f"epoch metrics: {rows[-1] if rows else None}")
        book["history"]["train_loss"].append(train_loss)
        metrics: Dict[str, float] = {
            "epoch": epoch,
            "train_loss": train_loss,
            "step_time_s": step_time,
            "samples_per_s": samples / max(step_time, 1e-9),
        }
        if epoch % self.cfg.eval_every_epochs == 0:
            metrics["val_loss"], task_metrics = evaluate()
            book["history"]["val_loss"].append(metrics["val_loss"])
            metrics.update(task_metrics)
        book["metric_rows"].append(metrics)
        if logger:
            logger.log(metrics, step=epoch)
        # early stopping on the monitored metric
        if self.monitor in metrics:
            if self._better(metrics[self.monitor], book["best"]["value"]):
                book["best"] = {"value": metrics[self.monitor], "epoch": epoch}
                book["since_best"] = 0
            else:
                book["since_best"] += 1
        if ckpts:
            ckpts.save(epoch, state, metrics, loop={**rng_states(), **book})
        return self._stopped(book)

    def _stopped(self, book) -> bool:
        return book["since_best"] >= self.cfg.patience  # Lightning's wait_count >= patience

    def _result(self, book, state, epoch: int, t_start: float, logger, ckpts) -> Dict[str, Any]:
        """A fit's result; with a run directory also the best checkpoint's
        epoch and ``summary.json``."""
        result = {
            "state": state,
            "history": book["history"],
            "metric_rows": book["metric_rows"],
            "best": book["best"],
            "epochs_run": epoch + 1,
            "wall_time_s": time.perf_counter() - t_start,
        }
        if ckpts:
            result["best_ckpt_epoch"] = ckpts.best_epoch()
        if logger:
            self._summarize(logger, result)
        return result

    def _summarize(self, logger, result) -> None:
        """``summary.json``: the run summary of the JAX trainer (the
        reference's script_wandb.py:248-253), also the sweep's mark of a
        completed run."""
        history = result["history"]
        summary = {
            f"best_{self.monitor}": result["best"]["value"],
            "best_epoch": result["best"]["epoch"],
            "best_ckpt_epoch": result["best_ckpt_epoch"],
        }
        if history["val_loss"]:
            summary["best_val_loss"] = float(np.min(history["val_loss"]))
        aucs = [m["AUC_val"] for m in result["metric_rows"] if "AUC_val" in m]
        if aucs:
            summary["best_auc"] = float(np.max(aucs))
        logger.set_summary(**summary)

    def fit_sharded(self, train_sds, val_ds: ArrayDataset,
                    config_dump: Optional[Dict[str, Any]] = None,
                    state: Optional[TrainState] = None, resume: bool = False,
                    prefetch: Optional[bool] = None) -> Dict[str, Any]:
        """``fit`` over ``train_sds`` (a ``data.streaming.ShardedDataset``):
        each epoch walks ``shard_epoch_schedule``'s shuffled shard order,
        one shard on the device at a time with the next one's upload under
        its steps (two at the peak; ``prefetch=False``, or two shards over
        75% of the card's memory, uploads each in its turn). ``val_ds`` stays
        on the device. Returns ``fit``'s result and ``shard_feed``, the
        feed's ``stats()`` (whether prefetch was on, each upload's device ms
        and host staging ms). With a run directory its files are ``fit``'s,
        with ``SHARD{i:05d}x{n}`` as the training manifest's names, and a
        ``StreamCursor`` is saved after every shard; ``resume=True``
        continues from it, at the shard after the last one saved. Under a
        mesh of several processes (the module doc) rank 0 writes the run
        directory, no cursor is kept and ``resume=True`` continues from
        ``last.ckpt``."""
        if resume and not self.run_dir:
            raise ValueError("resume=True needs the run_dir of the run to continue")
        mesh = self.mesh
        if mesh is not None:
            mesh.local(self.cfg.batch_size)  # raises unless the ranks divide B
        with batch_stats_over(self.model, mesh):
            if not self.run_dir:
                result = self._fit_sharded(train_sds, val_ds, state, resume, prefetch,
                                           None, None, None)
            else:
                result = self._fit_sharded_in_run_dir(train_sds, val_ds, config_dump, state,
                                                      resume, prefetch)
        if mesh is not None:
            mesh.barrier()  # rank 0 has written everything before any rank returns
        return result

    def _fit_sharded_in_run_dir(self, train_sds, val_ds, config_dump, state, resume, prefetch):
        mesh = self.mesh
        ckpts, logger = self._open_run_dir(
            config_dump, [f"SHARD{i:05d}x{n}" for i, n in enumerate(train_sds.shard_sizes)],
            val_ds.filenames or [])
        # the JAX package keeps the shard cursor only in one process
        one_process = mesh is None or mesh.size * mesh.n_model == 1
        cursor = StreamCursor(self.run_dir) if one_process else None
        try:
            return self._fit_sharded(train_sds, val_ds, state, resume, prefetch, logger,
                                     ckpts, cursor)
        finally:
            if logger:
                logger.close()

    def _fit_sharded(self, train_sds, val_ds, state, resume, prefetch, logger, ckpts, cursor):
        from ..data.streaming import shard_epoch_schedule
        from .shard_feed import ShardFeed

        cfg = self.cfg
        device = self.device
        mesh = self.mesh
        rng = np.random.default_rng(cfg.seed)
        generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        eval_generator = torch.Generator(device=device).manual_seed(cfg.seed + 2)
        # a rank's columns of each global plan, and its rows of each global draw
        cols = slice(None) if mesh is None else mesh.block(cfg.batch_size)
        draws = generator if mesh is None else RankRows(generator, mesh)
        eval_draws = eval_generator if mesh is None else RankRows(eval_generator, mesh)
        self.set_dataset_size(len(train_sds))
        val_data = val_ds.to_device(device)
        if state is None:
            state = self.init_state()
        feed = ShardFeed(train_sds, device, prefetch)
        n_shards = train_sds.n_shards
        steps_full = -(-train_sds.shard_sizes[0] // cfg.batch_size)
        book = _new_book()
        start_epoch = 0
        resume_mid = None  # (the epoch's start rng state, losses so far, next shard)
        if resume and cursor is None:
            # several processes: fit's epoch-boundary resume; the saved streams
            # are those after the finished epochs' shard orders and draws
            state, start_epoch, book = self._restore_last(ckpts, state, rng, generator,
                                                          eval_generator, book)
        elif resume:
            restored = cursor.try_restore(state)
            if restored is not None:
                state, start_epoch, shard_pos, rows, loop = restored
                generator.set_state(loop["torch_rng"])
                eval_generator.set_state(loop["eval_torch_rng"])
                book = {k: loop[k] for k in book}
                resume_mid = (loop["epoch_numpy_rng"], list(rows[:shard_pos + 1]),
                              shard_pos + 1)
        run_epoch = make_epoch_runner(
            self.model, cfg.noise_level_mag, noise_level_img=cfg.noise_level_img,
            rotate_images=cfg.rotate_images, mesh=mesh)
        run_eval = make_eval_runner(self.model, rotate_images=cfg.rotate_images, mesh=mesh)
        val_plan = torch.from_numpy(np.ascontiguousarray(epoch_indices(
            len(val_ds), cfg.batch_size, shuffle=False, pad="repeat_last")[:, cols])).to(device)
        n_val = len(val_ds)
        t_start = time.perf_counter()

        def rng_states():
            return {"numpy_rng": rng.bit_generator.state, "torch_rng": generator.get_state(),
                    "eval_torch_rng": eval_generator.get_state()}

        def evaluate():
            val_losses, aux = run_eval(state, val_data, val_plan, eval_draws)
            return float(val_losses.mean()), compute_task_metrics(
                self.task, aux, val_ds, n_val, self.n_classes)

        epoch = start_epoch - 1
        try:
            for epoch in range(start_epoch, cfg.epochs if not self._stopped(book) else 0):
                start_shard, epoch_losses = 0, []
                if resume_mid is not None:  # the schedule the cut epoch drew
                    rng.bit_generator.state, epoch_losses, start_shard = resume_mid
                    resume_mid = None
                epoch_rng = rng.bit_generator.state
                schedule = shard_epoch_schedule(train_sds, cfg.batch_size, rng)
                remaining = schedule[start_shard:]
                t0 = time.perf_counter()
                n_steps = 0
                shards = feed.shards([si for si, _ in remaining])
                try:
                    for pos, (_, plan) in enumerate(remaining, start=start_shard):
                        data = next(shards)
                        state, losses = run_epoch(state, data, plan[:, cols], draws)
                        del data  # no reference left: at most two shards on the device
                        epoch_losses.append(losses.cpu().numpy())
                        n_steps += plan.shape[0]
                        if cursor is not None:
                            rows = np.full((n_shards, steps_full), np.nan, np.float32)
                            rows[:pos + 1] = np.stack(epoch_losses)
                            cursor.save(state, epoch, pos, rows,
                                        {**rng_states(), "epoch_numpy_rng": epoch_rng, **book})
                finally:
                    shards.close()
                train_loss = float(np.mean(np.concatenate(epoch_losses)))
                step_time = (time.perf_counter() - t0) / max(n_steps, 1)
                if self._close_epoch(book, epoch, train_loss, step_time, cfg.batch_size,
                                     evaluate, state, logger, ckpts, rng_states):
                    break
        finally:
            feed.close()
        return dict(self._result(book, state, epoch, t_start, logger, ckpts),
                    shard_feed=feed.stats())

def _new_book() -> Dict[str, Any]:
    """A fit's running record: the per-epoch history, the metric rows and
    the early-stopping state (what ``loop`` carries across a resume)."""
    return {"history": {"train_loss": [], "val_loss": []}, "metric_rows": [],
            "best": {"value": None, "epoch": -1}, "since_best": 0}


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
