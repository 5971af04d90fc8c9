"""The training loop (port of ``Trainer.fit`` in
multimodal_supernovae_tpu/training/trainer.py, for the contrastive task
without a run directory):

  host                          device
  ----                          ------
  epoch index plan       ->     per step: gather the batch from the
  (shuffled, wrapped)             device-resident dataset, augment,
                                  loss, backward, RAdam update
  epoch metrics          <-     per-step losses, eval embeddings

Per epoch the host reads the mean train loss (and aborts on a non-finite
one), the validation loss and the retrieval ``AUC_val``, and stops early when
``val_loss`` has not improved for ``patience`` epochs.

Not ported yet, and raising ``NotImplementedError``: run directories,
checkpoints, resume, metric logging and ``fit_sharded`` (ROADMAP.md queue 1,
item 10), a device mesh (item 15), and the supervised and masked tasks
(items 11-12).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.batching import ArrayDataset, epoch_indices
from ..ops.metrics import retrieval_auc
from .optim import build_optimizer
from .state import TrainState
from .step import make_epoch_runner, make_eval_runner

_ITEM10 = "not ported yet (ROADMAP.md queue 1, item 10: trainer and checkpoints)"


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 10
    batch_size: int = 32
    lr: float = 1e-4
    weight_decay: float = 0.0
    patience: int = 10**9  # early stopping on val_loss (epochs)
    seed: int = 0
    noise_level_mag: float = 0.0
    # lr schedule (masked pretraining's StepLR)
    step_size: Optional[int] = None
    gamma: Optional[float] = None
    eval_every_epochs: int = 1


class Trainer:
    """Trains a module exposing ``loss_fn(batch, train, generator)`` on the
    device its parameters are on."""

    def __init__(self, model, task: str, cfg: TrainerConfig,
                 run_dir: Optional[str] = None, mesh=None, freeze=None,
                 use_wandb: bool = False):
        if task != "contrastive":
            raise NotImplementedError(
                f"task {task!r} is not ported yet (ROADMAP.md queue 1, items "
                "11-12: supervised heads and masked pretraining)")
        if run_dir is not None or use_wandb:
            raise NotImplementedError(f"run directories and logging are {_ITEM10}")
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet (ROADMAP.md queue 1, item 15)")
        self.model = model
        self.task = task
        self.cfg = cfg
        self.freeze = freeze
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

    def fit(self, train_ds: ArrayDataset, val_ds: ArrayDataset,
            state: Optional[TrainState] = None, resume: bool = False) -> Dict[str, Any]:
        """Train for ``cfg.epochs`` epochs with early stopping. Returns the
        state, the per-epoch ``history``, ``metric_rows`` (train_loss,
        step_time_s, samples_per_s, val_loss, AUC_val), ``best``,
        ``epochs_run`` and ``wall_time_s``."""
        if resume:
            raise NotImplementedError(f"resume is {_ITEM10}")
        cfg = self.cfg
        device = self.device
        rng = np.random.default_rng(cfg.seed)
        generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)

        self.set_dataset_size(len(train_ds))
        train_data = train_ds.to_device(device)
        val_data = val_ds.to_device(device)
        if state is None:
            state = self.init_state()
        run_epoch = make_epoch_runner(self.model, noise_level_mag=cfg.noise_level_mag)
        run_eval = make_eval_runner(self.model)
        # fixed-shape eval plan: sequential, the tail repeats the last sample
        # and is trimmed after flattening
        val_plan = torch.from_numpy(epoch_indices(
            len(val_ds), cfg.batch_size, shuffle=False, pad="repeat_last")).to(device)
        n_val = len(val_ds)

        history: Dict[str, List[float]] = {"train_loss": [], "val_loss": []}
        metric_rows: List[Dict[str, float]] = []
        best = {"value": None, "epoch": -1}
        since_best = 0
        t_start = time.perf_counter()

        epoch = -1
        for epoch in range(cfg.epochs):
            plan = epoch_indices(len(train_ds), cfg.batch_size, rng=rng,
                                 shuffle=True, pad="wrap")
            t0 = time.perf_counter()
            state, losses = run_epoch(state, train_data, plan, generator)
            train_loss = float(losses.mean())  # waits for the epoch's steps
            if not np.isfinite(train_loss):
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
                val_losses, aux = run_eval(state, val_data, val_plan)
                metrics["val_loss"] = float(val_losses.mean())
                history["val_loss"].append(metrics["val_loss"])
                metrics.update(compute_task_metrics(aux, n_val))
            metric_rows.append(metrics)

            # early stopping on val_loss (the contrastive task's monitor)
            if "val_loss" in metrics:
                current = metrics["val_loss"]
                if best["value"] is None or current < best["value"]:
                    best = {"value": current, "epoch": epoch}
                    since_best = 0
                else:
                    since_best += 1
                if since_best >= cfg.patience:
                    break

        return {
            "state": state,
            "history": history,
            "metric_rows": metric_rows,
            "best": best,
            "epochs_run": epoch + 1,
            "wall_time_s": time.perf_counter() - t_start,
        }

    def fit_sharded(self, *args, **kwargs):
        raise NotImplementedError(f"fit_sharded is {_ITEM10}")


def compute_task_metrics(aux: Dict[str, Any], n_val: int) -> Dict[str, float]:
    """``AUC_val``, the light-curve/spectral retrieval AUC of the eval loop's
    stacked embeddings trimmed to ``n_val`` (the contrastive two-modality
    case of the JAX ``compute_task_metrics``)."""
    lc, sp = (e.reshape(-1, e.shape[-1])[:n_val] for e in aux["embeddings"])
    return {"AUC_val": float(retrieval_auc(lc, sp))}
