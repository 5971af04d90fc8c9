"""Run directories and checkpoints (port of
multimodal_supernovae_tpu/training/checkpoint.py).

A run directory holds:

  * ``config.yaml``: the flattened run config, written as JSON (valid YAML:
    the JAX package's ``yaml.safe_load`` reads it; ``config.yaml_subset.dump``
    keeps its floats readable as floats and refuses non-finite ones);
  * ``train_filenames.txt`` / ``val_filenames.txt``: the split manifests,
    one name a line;
  * ``model_config.json``: the model's sidecar (``models.factory``);
  * ``epoch=E-step=S.ckpt``: the best ``keep_best`` epochs by the monitored
    metric, and ``last.ckpt``: the latest epoch. These are the reference's
    (Lightning's) layout, so ``models.factory.load_model`` here and the JAX
    package's ``load_model`` both read them. Each is a ``torch.save`` of
    tensors and plain containers only (``torch.load(weights_only=True)``
    reads it): ``state_dict`` (parameters and buffers, the image tower's
    BatchNorm running statistics and counts included), ``optimizer_states``
    and ``lr_schedulers`` (one each), ``epoch``, ``global_step``, the
    epoch's finite ``metrics``, and ``loop``, what the trainer needs to
    continue the run as if it had not stopped (its random streams and
    early-stopping state).

A model split over a mesh's model axis (parallel/sharding.py) is saved
whole: the state_dict and the optimizer's moments are gathered over the
model group, so its files are those of the one-process run, and a restore
takes this rank's slices of them, under whatever mesh is running.

Files are written to a temporary name and renamed, so a process killed
mid-save leaves the previous file whole.

Where the JAX package's ``CheckpointManager`` returns ``(state, epoch)``
from ``try_restore_last``, this one returns ``(state, epoch, loop)``: the
JAX trainer re-draws its host random numbers for the completed epochs, this
one restores the generators' states.

The weight surgery of the two-stage recipe works on state_dicts:
``merge_params_nonstrict`` copies what fits, ``graft_masked_pretrain_into_clip``
puts a masked pretrainer's encoder into a CLIP light-curve tower;
``best_ckpt_path`` names the monitored best checkpoint that it loads.

``StreamCursor`` is ``Trainer.fit_sharded``'s resume point within an epoch:
one file, ``<run_dir>/ckpt_cursor/cursor.pt``, rewritten after every shard.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config.yaml_subset import dump as dump_yaml
from ..config.yaml_subset import load as load_yaml
from ..parallel.sharding import (
    gather_optimizer_state,
    gather_state_dict,
    shard_optimizer_state,
    shard_state_dict,
)
from .state import TrainState

CONFIG_NAME = "config.yaml"
LAST_NAME = "last.ckpt"
_EPOCH_FILE = re.compile(r"^epoch=(\d+)-step=(\d+)\.ckpt$")


def save_run_sidecars(run_dir: str, config: Dict[str, Any],
                      train_filenames: Optional[Sequence[str]] = None,
                      val_filenames: Optional[Sequence[str]] = None) -> None:
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, CONFIG_NAME), "w") as f:
        f.write(dump_yaml(dict(config)))
    for name, names in (("train_filenames.txt", train_filenames),
                        ("val_filenames.txt", val_filenames)):
        if names is not None:
            with open(os.path.join(run_dir, name), "w") as f:
                f.writelines(f"{n}\n" for n in names)


def load_run_sidecars(run_dir: str):
    """(config, train filenames or None, val filenames or None)."""
    config = load_yaml(os.path.join(run_dir, CONFIG_NAME))

    def read_names(name):
        path = os.path.join(run_dir, name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]

    return config, read_names("train_filenames.txt"), read_names("val_filenames.txt")


def _save(payload: Dict[str, Any], path: str) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load(path: str) -> Dict[str, Any]:
    """A checkpoint on the host: ``load_state_dict`` copies each tensor to its
    parameter's or state's device, and a generator state stays a CPU tensor."""
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """The best ``keep_best`` epochs by ``monitor`` (``mode`` 'min' or 'max'),
    each an ``epoch=E-step=S.ckpt``, and the latest as ``last.ckpt``.

    An epoch enters the best set while the set has room or when it is
    strictly better than the worst kept one, which is then deleted (ties
    keep the earlier epoch, as Lightning's ``save_top_k`` does). The set is
    read back from the run directory's files, so a manager made after a
    restart continues it. ``write=False`` (the ranks of a data mesh other
    than 0) keeps the same book of the best epochs and writes, and deletes,
    nothing."""

    def __init__(self, run_dir: str, monitor: str = "val_loss", mode: str = "min",
                 keep_best: int = 2, write: bool = True):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.run_dir = run_dir
        self.monitor = monitor
        self.mode = mode
        self.keep_best = keep_best
        self.write = write
        os.makedirs(run_dir, exist_ok=True)
        self._best: Dict[int, Tuple[float, str]] = {}  # epoch: (value, file)
        for name in os.listdir(run_dir):
            m = _EPOCH_FILE.match(name)
            if m:
                value = torch.load(os.path.join(run_dir, name), map_location="cpu",
                                   weights_only=True, mmap=True)["metrics"].get(monitor)
                if value is not None:
                    self._best[int(m.group(1))] = (float(value), name)

    def _rank(self, epoch: int):
        """Sort key: better values first, then earlier epochs."""
        value = self._best[epoch][0]
        return (value if self.mode == "min" else -value, epoch)

    @staticmethod
    def _payload(epoch: int, state: TrainState, metrics: Dict[str, float],
                 loop: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        return {
            "epoch": int(epoch),
            "global_step": int(state.step),
            "state_dict": gather_state_dict(state.model),
            "optimizer_states": [gather_optimizer_state(state.optimizer, state.model)],
            "lr_schedulers": ([] if state.scheduler is None
                              else [state.scheduler.state_dict()]),
            "metrics": metrics,
            "loop": loop or {},
        }

    def save(self, epoch: int, state: TrainState, metrics: Dict[str, Any],
             loop: Optional[Dict[str, Any]] = None) -> None:
        """Write ``last.ckpt`` and, when the epoch makes the best set, its
        ``epoch=`` file. ``metrics`` keep their finite numbers only."""
        metrics = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float)) and math.isfinite(v)}
        # every rank builds it: a model split over a model axis is gathered
        # whole, a collective over the model group
        payload = self._payload(epoch, state, metrics, loop)
        if self.monitor in metrics:
            self._offer(epoch, metrics[self.monitor], state.step, payload)
        if self.write:
            _save(payload, os.path.join(self.run_dir, LAST_NAME))

    def _offer(self, epoch: int, value: float, step: int, payload: Dict[str, Any]):
        old = self._best.pop(epoch, None)  # a re-done epoch replaces its file
        if old is not None and self.write:
            os.remove(os.path.join(self.run_dir, old[1]))
        name = f"epoch={epoch}-step={step}.ckpt"
        self._best[epoch] = (value, name)
        kept = sorted(self._best, key=self._rank)
        if epoch not in kept[:self.keep_best]:
            del self._best[epoch]
            return
        if self.write:
            _save(payload, os.path.join(self.run_dir, name))
        for dropped in kept[self.keep_best:]:
            name = self._best.pop(dropped)[1]
            if self.write:
                os.remove(os.path.join(self.run_dir, name))

    def best_epoch(self) -> Optional[int]:
        return min(self._best, key=self._rank) if self._best else None

    def try_restore_last(self, state: TrainState
                         ) -> Optional[Tuple[TrainState, int, Dict[str, Any]]]:
        """Resume support: ``last.ckpt`` into ``state``; returns (state,
        epoch, loop), or None when the run has no checkpoint yet."""
        if not os.path.exists(os.path.join(self.run_dir, LAST_NAME)):
            return None
        payload = _load(os.path.join(self.run_dir, LAST_NAME))
        return _restore_into(state, payload), payload["epoch"], payload["loop"]

    def restore(self, state: TrainState, epoch: Optional[int] = None,
                which: str = "best") -> TrainState:
        """Restore into ``state``: the monitored best (or the kept ``epoch``)
        for which='best', ``last.ckpt`` for which='last'."""
        if which == "last":
            name = LAST_NAME
            if not os.path.exists(os.path.join(self.run_dir, name)):
                name = None
        else:
            epoch = self.best_epoch() if epoch is None else epoch
            name = self._best[epoch][1] if epoch in self._best else None
        if name is None:
            raise FileNotFoundError(
                f"no '{which}' checkpoint{'' if epoch is None else f' of epoch {epoch}'} "
                f"exists under {self.run_dir}: nothing to restore")
        payload = _load(os.path.join(self.run_dir, name))
        if epoch is not None and payload["epoch"] != epoch:
            raise FileNotFoundError(f"{name} holds epoch {payload['epoch']}, not {epoch}")
        return _restore_into(state, payload)


class StreamCursor:
    """The resume point of ``Trainer.fit_sharded`` after a shard: the model
    (with its buffers), optimizer and scheduler states, the epoch and the
    shard position within it, the in-flight epoch's per-step losses as an
    (n_shards, steps_per_shard) float32 tensor padded with NaN, and ``loop``,
    the trainer's random streams and early-stopping state (the JAX cursor
    replays its key splits; this one stores the generators' states, as
    ``last.ckpt`` does). One file, ``<run_dir>/ckpt_cursor/cursor.pt``,
    written to a temporary name and renamed, so state and bookkeeping never
    tear and only the latest cursor is kept."""

    NAME = "cursor.pt"

    def __init__(self, run_dir: str):
        self.dir = os.path.join(os.path.abspath(run_dir), "ckpt_cursor")
        self.path = os.path.join(self.dir, self.NAME)

    def save(self, state: TrainState, epoch: int, shard_pos: int, losses,
             loop: Dict[str, Any]) -> None:
        payload = CheckpointManager._payload(epoch, state, {}, loop)
        payload["shard_pos"] = int(shard_pos)
        payload["losses"] = torch.as_tensor(losses, dtype=torch.float32)
        os.makedirs(self.dir, exist_ok=True)
        _save(payload, self.path)

    def try_restore(self, state: TrainState):
        """The cursor into ``state``: (state, epoch, shard_pos, losses as a
        numpy array, loop), or None when the run has none yet."""
        if not os.path.exists(self.path):
            return None
        payload = _load(self.path)
        return (_restore_into(state, payload), payload["epoch"], payload["shard_pos"],
                payload["losses"].numpy(), payload["loop"])


def _restore_into(state: TrainState, payload: Dict[str, Any]) -> TrainState:
    """A checkpoint's full tensors into ``state``; a model split over a model
    axis takes this rank's slices, whatever mesh wrote the file."""
    model = state.model
    model.load_state_dict(shard_state_dict(payload["state_dict"], model), strict=True)
    state.optimizer.load_state_dict(shard_optimizer_state(payload["optimizer_states"][0],
                                                          state.optimizer, model))
    if state.scheduler is not None:
        state.scheduler.load_state_dict(payload["lr_schedulers"][0])
    state.step = int(payload["global_step"])
    return state


def best_ckpt_path(run_dir: str) -> str:
    """The monitored best checkpoint of a run dir: the ``epoch=`` file
    of ``summary.json``'s ``best_ckpt_epoch`` (what the JAX package's
    ``restore_run_variables(which="best")`` restores), or, for a run without
    that summary yet, its latest kept ``epoch=`` file. Not
    ``pick_reference_ckpt``'s smallest epoch."""
    kept = {}
    for name in os.listdir(run_dir):
        m = _EPOCH_FILE.match(name)
        if m:
            kept[int(m.group(1))] = name
    if not kept:
        raise FileNotFoundError(f"no epoch= checkpoint in {run_dir}")
    epoch = None
    summary = os.path.join(run_dir, "summary.json")
    if os.path.exists(summary):
        with open(summary) as f:
            epoch = json.load(f).get("best_ckpt_epoch")
    epoch = max(kept) if epoch is None else int(epoch)
    if epoch not in kept:
        raise FileNotFoundError(f"{run_dir}: the best epoch {epoch} has no epoch= file "
                                f"(kept: {sorted(kept)})")
    return os.path.join(run_dir, kept[epoch])


# -- parameters only (evaluation and transfer) ---------------------------------


def save_params(path: str, model: nn.Module) -> None:
    """The model's parameters as a reference-layout ``{"state_dict": ...}``."""
    _save({"state_dict": model.state_dict()}, path)


def load_params(path: str, model: nn.Module) -> nn.Module:
    """``save_params``'s file (or any reference-layout checkpoint) into
    ``model``, strictly."""
    model.load_state_dict(_load(path)["state_dict"], strict=True)
    return model


# -- weight surgery ------------------------------------------------------------


def merge_params_nonstrict(target: Dict[str, torch.Tensor],
                           source: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of ``target`` with every ``source`` tensor whose name it has and
    whose shape matches: the JAX package's ``merge_params_nonstrict`` (the
    reference's ``load_state_dict(strict=False)``, which, unlike torch's,
    skips a shape mismatch instead of raising). The result loads with
    ``strict=True``."""
    out = dict(target)
    for name, value in source.items():
        if name in out and tuple(out[name].shape) == tuple(value.shape):
            out[name] = value
    return out


def graft_masked_pretrain_into_clip(clip_sd: Dict[str, torch.Tensor],
                                    masked_sd: Dict[str, torch.Tensor]
                                    ) -> Dict[str, torch.Tensor]:
    """A CLIP state_dict whose ``lightcurve_encoder.*`` takes a masked
    pretrainer's ``net.*`` (the reference's ``net.``-prefix transfer),
    merged non-strictly. The pretrainer's dead ``net.projection.*`` (absent
    from the JAX tree) and its ``last_layer.*`` are not carried over."""
    encoder = {"lightcurve_encoder." + k[len("net."):]: v for k, v in masked_sd.items()
               if k.startswith("net.") and not k.startswith("net.projection.")}
    return merge_params_nonstrict(clip_sd, encoder)
