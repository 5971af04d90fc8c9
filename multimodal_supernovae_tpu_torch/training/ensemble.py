"""Stacked training of independent runs on one device with ``torch.func.vmap``
(port of multimodal_supernovae_tpu/training/ensemble.py).

The members of one group (the k folds of a grid point, or seeds and learning
rates too) share one architecture. Their parameters and buffers are stacked
along a leading member axis (``torch.func.stack_module_state``), and a train
step is one ``vmap`` of ``model.loss_fn`` through ``functional_call`` over
the stacked leaves, then one ordinary backward and one optimizer step on
those leaves. Every matmul then does N members' work, and the flash kernels'
``vmap`` rule (ops/flash_attention.py) folds the member axis into their batch,
so a stacked step launches each kernel as often as one member's step does.

Semantics: member i trains as ``Trainer.fit`` with ``cfg.seed = m.seed``
would: the same host shuffles (``np.random.default_rng(seed)``), the same
training draws from ``torch.Generator(device).manual_seed(seed + 1)`` and
validation draws from ``seed + 2``, in the same order, the same
early-stopping bookkeeping on its own metrics and the same run directory.
No member can draw inside vmap, so each member's augmentation runs on its
own slice of the batch outside vmap, and its dropout keep masks are drawn
right after from its generator (``utils/draws.py``) and handed in as
batched tensors; the masks' shapes come from one dry run of the forward on
the meta device. The image tower's BatchNorm updates its running statistics
in place, into the member's row of the stacked buffers.

The optimizer is ``torch.optim.RAdam`` over the stacked leaves (coupled L2
decay, StepLR and freezing as training/optim.py builds them: RAdam is
elementwise, so this is each member's own update) when every member has the
config's learning rate, else ``StackedRAdam``, whose learning rate is one
value a member. Members whose train sets need fewer steps than the
ensemble-wide most take extra batches from their own permutation (a
warning says which): they then differ from a sequential run.

With a run directory each member's ``<run_dir>/<name>/`` gets what the
sequential trainer writes, epoch by epoch: the sidecars, ``metrics.jsonl``
(with ``member_samples_per_s`` beside the ensemble's ``samples_per_s``),
the best ``keep_best`` checkpoints and ``last.ckpt`` holding that member's
slice of the model and optimizer state and its random streams, and
``summary.json``. ``<ensemble_dir>`` (default ``<run_dir>/_ensemble``) holds
the stacked state an epoch, its best and at-stop snapshots, the members'
random streams and ``bookkeeping.json``; ``resume=True`` continues from it.
Where the JAX package replays its host random numbers past the completed
epochs, the port restores the generators' states, as its ``Trainer`` does.

With ``mesh`` (a ``parallel.mesh.DataMesh``) the member axis goes over the
mesh's data axis, as the JAX ``P(DATA_AXIS)`` places it: the member count
must be a multiple of n_data, and data rank d trains members [d k, (d + 1)
k) (k = N / n_data) as one stacked program on its own card, with no
collective in a step; the whole dataset is on every rank. The plans are the
whole ensemble's (its most steps), so each member trains as it would in the
one-process stacked run. Members are not split over a model axis: the model
ranks of a data group repeat their group's members. Files: the FIRST MODEL
RANK of data rank d (global rank d * n_model) writes its members'
``<run_dir>/<name>/`` (exactly the one-process run's files) and the stacked
checkpoint ``<ensemble_dir>/data-<d>/`` (``<ensemble_dir>`` itself when
n_data is 1), which a resume under the same mesh reads; every other rank
writes nothing. The members' host results (histories, rows, best, epochs)
are gathered over the data group, so every rank returns every member's;
``state`` and the snapshots are the local members' (``local`` names them).
A barrier stands before the return.

The fused opt-ins (``MMSN_FUSED_BLOCK=1`` / ``use_fused_block``,
``MMSN_FUSED_QKV=1``) work here too: the fused kernels' ``vmap`` rules
(ops/fused_block.py, ops/qkv_attention.py) stack the members' weights and
launch each kernel once a layer for all of them, each way, as the flash
kernels do; the no-grad evaluation pass launches their forwards alone.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
import warnings
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..data.augment import augment_batch
from ..data.batching import ArrayDataset, epoch_indices
from ..models.factory import write_model_config
from ..utils.draws import DrawRecorder, DrawSource, draw_stacked_keep_masks
from ..utils.logging import MetricsLogger
from .checkpoint import CheckpointManager, save_run_sidecars
from .optim import build_optimizer, freeze_mask
from .state import TrainState
from .step import _stack_aux
from .trainer import TrainerConfig, compute_task_metrics


@dataclasses.dataclass
class Member:
    """One independent run of the stacked program. ``train_indices`` and
    ``val_indices`` index the shared dataset; ``lr=None`` takes the
    config's."""

    name: str
    seed: int
    train_indices: np.ndarray
    val_indices: np.ndarray
    lr: Optional[float] = None
    config_dump: Optional[Dict[str, Any]] = None


# -- per-member learning rate -------------------------------------------------


class StackedRAdam(torch.optim.Optimizer):
    """``torch.optim.RAdam`` (coupled L2 ``weight_decay``) over stacked leaves
    whose leading dim is the member axis, with one learning rate a member
    (``lrs``) and StepLR's group-uniform staircase: every ``decay_every``
    optimizer steps each lr is multiplied by ``gamma``, as torch's StepLR
    does. The arithmetic is ``torch.optim.RAdam``'s single-tensor update,
    with the lr a (N, 1, ...) tensor."""

    def __init__(self, params, lrs: Sequence[float], weight_decay: float = 0.0,
                 decay_every: Optional[int] = None, gamma: Optional[float] = None,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        defaults = dict(lrs=[float(lr) for lr in lrs], weight_decay=weight_decay,
                        decay_every=decay_every, gamma=gamma, betas=betas, eps=eps,
                        steps=0)
        super().__init__(params, defaults)

    @staticmethod
    def current_lrs(group) -> List[float]:
        lrs = list(group["lrs"])
        if group["decay_every"] and group["gamma"] is not None:
            for _ in range(group["steps"] // group["decay_every"]):
                lrs = [lr * group["gamma"] for lr in lrs]
        return lrs

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lrs, lr_of = self.current_lrs(group), {}  # one (N,) copy a device and dtype
            beta1, beta2 = group["betas"]
            wd, eps = group["weight_decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                grad, exp_avg, exp_avg_sq = p.grad, state["exp_avg"], state["exp_avg_sq"]
                state["step"] += 1
                step = state["step"].item()
                if wd != 0:
                    grad = grad.add(p, alpha=wd)
                exp_avg.lerp_(grad, 1 - beta1)
                exp_avg_sq.mul_(beta2).addcmul_(grad, grad, value=1 - beta2)
                bias_correction1 = 1 - beta1 ** step
                bias_correction2 = 1 - beta2 ** step
                bias_corrected_exp_avg = exp_avg / bias_correction1
                rho_inf = 2 / (1 - beta2) - 1
                rho_t = rho_inf - 2 * step * (beta2 ** step) / bias_correction2
                key = (p.device, p.dtype)
                if key not in lr_of:
                    lr_of[key] = torch.tensor(lrs, dtype=p.dtype, device=p.device)
                lr = lr_of[key].view(-1, *([1] * (p.dim() - 1)))
                if rho_t > 5.0:
                    rect = ((rho_t - 4) * (rho_t - 2) * rho_inf
                            / ((rho_inf - 4) * (rho_inf - 2) * rho_t)) ** 0.5
                    adaptive_lr = (bias_correction2 ** 0.5) / exp_avg_sq.sqrt().add_(eps)
                    p.add_(bias_corrected_exp_avg * lr * adaptive_lr * rect, alpha=-1.0)
                else:
                    p.add_(bias_corrected_exp_avg * lr, alpha=-1.0)
            group["steps"] += 1


# -- stacking ----------------------------------------------------------------


@dataclasses.dataclass
class StackedState:
    """N members as stacked leaves: ``params`` and ``buffers`` map the
    model's names to (N, ...) tensors; ``model`` is the structure
    ``functional_call`` runs (member 0's module); ``optimizer`` and
    ``scheduler`` step the stacked leaves; ``lrs`` and ``recipe`` (the
    ``build_optimizer`` arguments but the lr) rebuild one member's own
    optimizer (``unstack_member``)."""

    model: nn.Module
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler]
    lrs: List[float]
    recipe: Dict[str, Any]
    step: int = 0

    @property
    def n(self) -> int:
        return len(self.lrs)


def stack_states(models: Sequence[nn.Module], lrs: Sequence[float], *,
                 per_member_lr: Optional[bool] = None, **recipe) -> StackedState:
    """Stack ``models`` (one architecture, on one device) and build the
    optimizer over the stacked leaves: ``torch.optim.RAdam`` with StepLR
    (training/optim.py) when every lr is the same, else ``StackedRAdam``
    (``per_member_lr`` decides instead where given: a data rank's members
    take the whole ensemble's choice). ``recipe``: ``weight_decay``,
    ``step_size``, ``gamma``, ``steps_per_epoch`` and ``freeze``, as
    ``build_optimizer`` takes them."""
    params, buffers = torch.func.stack_module_state(list(models))
    lrs = [float(lr) for lr in lrs]
    named = list(params.items())
    if per_member_lr is None:
        per_member_lr = len(set(lrs)) > 1
    if not per_member_lr:
        opt, sched = build_optimizer(named, lr=lrs[0], **recipe)
    else:
        if recipe.get("freeze") is not None:
            labels = freeze_mask(named, recipe["freeze"])
            named = [(k, p) for k, p in named if labels[k] == "train"]
        step_size, gamma = recipe.get("step_size"), recipe.get("gamma")
        decay_every = (step_size * recipe.get("steps_per_epoch", 1)
                       if step_size is not None and gamma is not None else None)
        opt = StackedRAdam([p for _, p in named], lrs,
                           weight_decay=recipe.get("weight_decay", 0.0),
                           decay_every=decay_every, gamma=gamma)
        sched = None
    return StackedState(models[0], params, buffers, opt, sched, lrs, dict(recipe))


def snapshot(state: StackedState) -> Dict[str, torch.Tensor]:
    """The stacked state as one flat dict of (N, ...) tensors (references,
    not copies): ``param.*``, ``buffer.*``, the RAdam moments ``exp_avg.*`` /
    ``exp_avg_sq.*`` and counts ``opt_step.*`` of each parameter that has
    them, and ``step``, the optimizer steps taken."""
    n = state.n
    dev = next(iter(state.params.values())).device
    out = {f"param.{k}": v.detach() for k, v in state.params.items()}
    out.update({f"buffer.{k}": v for k, v in state.buffers.items()})
    for k, p in state.params.items():
        st = state.optimizer.state.get(p)
        if st:
            out[f"exp_avg.{k}"] = st["exp_avg"]
            out[f"exp_avg_sq.{k}"] = st["exp_avg_sq"]
            out[f"opt_step.{k}"] = torch.full((n,), float(st["step"]), device=dev)
    out["step"] = torch.full((n,), state.step, dtype=torch.int64, device=dev)
    return out


def select_members(mask: torch.Tensor, new: Dict[str, torch.Tensor],
                   old: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per member: where ``mask[i]``, ``new``'s member i, else ``old``'s; a
    fresh tensor for every entry (snapshots never alias the live state)."""

    def sel(a, b):
        return torch.where(mask.to(a.device).view(-1, *([1] * (a.dim() - 1))), a, b)

    return {k: sel(a, old[k]) for k, a in new.items()}


def unstack_member(snap: Dict[str, torch.Tensor], i: int, state: StackedState,
                   into: Optional[TrainState] = None) -> TrainState:
    """Member i of a snapshot as the ``TrainState`` a sequential run of it
    would hold: its own module, and ``build_optimizer``'s RAdam (and
    StepLR) at its lr with its moments, counts and schedule position.
    ``into``, a TrainState of an earlier call, is loaded in place."""
    if into is None:
        model = copy.deepcopy(state.model)
        opt, sched = build_optimizer(model.named_parameters(), lr=state.lrs[i],
                                     **state.recipe)
        into = TrainState(model, opt, sched)
    model, opt, sched = into.model, into.optimizer, into.scheduler
    keys = model.state_dict().keys()
    sd = {}
    for k in keys:
        src = snap.get(f"param.{k}", snap.get(f"buffer.{k}"))
        sd[k] = src[i]
    model.load_state_dict(sd, strict=True)
    step = int(snap["step"][i])
    names = {id(p): k for k, p in model.named_parameters()}
    opt.state.clear()
    for group in opt.param_groups:
        for p in group["params"]:
            k = names[id(p)]
            if f"exp_avg.{k}" in snap:
                opt.state[p] = {
                    "step": torch.tensor(float(snap[f"opt_step.{k}"][i]), dtype=torch.float32),
                    "exp_avg": snap[f"exp_avg.{k}"][i].clone(),
                    "exp_avg_sq": snap[f"exp_avg_sq.{k}"][i].clone(),
                }
    if sched is not None:  # StepLR after ``step`` steps, its lr multiplied as torch does
        lr = state.lrs[i]
        for _ in range(step // sched.step_size):
            lr = lr * sched.gamma
        for group in opt.param_groups:
            group["lr"] = lr
        sched.last_epoch, sched._step_count, sched._last_lr = step, step + 1, [lr]
    into.step = step
    return into


def _restore_live(state: StackedState, payload: Dict[str, Any]) -> None:
    with torch.no_grad():
        for k, v in payload["params"].items():
            state.params[k].copy_(v)
        for k, v in payload["buffers"].items():
            state.buffers[k].copy_(v)
    state.optimizer.load_state_dict(payload["optimizer"])
    if state.scheduler is not None:
        state.scheduler.load_state_dict(payload["scheduler"])
    state.step = int(payload["step"])


# -- plans -------------------------------------------------------------------


def member_train_plan(member: Member, batch_size: int, rng: np.random.Generator,
                      steps: int) -> np.ndarray:
    """One epoch's (steps, batch_size) plan of global indices for a member:
    ``Trainer.fit``'s shuffled, wrap-padded plan through the member's train
    indices, wrap-extended to the ensemble-wide step count."""
    n = len(member.train_indices)
    local = epoch_indices(n, batch_size, rng=rng, shuffle=True, pad="wrap")
    if local.shape[0] < steps:
        flat = local.reshape(-1)
        perm = flat[:n]  # the epoch's permutation
        extra = steps * batch_size - flat.size
        reps = np.concatenate([perm] * (-(-extra // n)))[:extra]
        local = np.concatenate([flat, reps]).reshape(steps, batch_size)
    return np.asarray(member.train_indices, dtype=np.int32)[local]


def member_val_plan(member: Member, batch_size: int, steps: int) -> np.ndarray:
    """The sequential, repeat_last-padded eval plan in global indices, padded
    with whole repeats of its last batch to the ensemble-wide step count
    (the padding is trimmed by the member's number of validation rows)."""
    local = epoch_indices(len(member.val_indices), batch_size, shuffle=False,
                          pad="repeat_last")
    if local.shape[0] < steps:
        pad = np.broadcast_to(local[-1:], (steps - local.shape[0], batch_size))
        local = np.concatenate([local, pad])
    return np.asarray(member.val_indices, dtype=np.int32)[local]


# -- stacked runners -----------------------------------------------------------


class _LossOf(nn.Module):
    """``model.loss_fn`` as a module's forward, for ``functional_call``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch, train: bool, generator):
        return self.model.loss_fn(batch, train=train, generator=generator)


def _gather(data: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(N, B, ...) batches: one ``index_select`` a field by the (N, B) plan row."""
    flat = idx.reshape(-1)
    return {k: v.index_select(0, flat).unflatten(0, tuple(idx.shape))
            for k, v in data.items()}


def _augment_members(batch: Dict[str, torch.Tensor], generators, **kwargs):
    """``augment_batch`` of each member's slice from that member's generator,
    outside vmap; the fields it changed are stacked back."""
    slices = [{k: v[i] for k, v in batch.items()} for i in range(len(generators))]
    parts = [augment_batch(s, g, **kwargs) for s, g in zip(slices, generators)]
    out = dict(batch)
    for k in batch:
        if parts[0][k] is not slices[0][k]:
            out[k] = torch.stack([p[k] for p in parts])
    return out


def _prefixed(state: StackedState):
    return ({f"model.{k}": v for k, v in state.params.items()},
            {f"model.{k}": v for k, v in state.buffers.items()})


def record_keep_masks(wrapper: nn.Module, state: StackedState,
                      batch: Dict[str, torch.Tensor]):
    """The (shape, keep probability) of every dropout draw of one member's
    train-mode loss, in order, from a dry run on the meta device."""
    def meta(t):
        return torch.empty(t.shape[1:], dtype=t.dtype, device="meta")

    params, buffers = _prefixed(state)
    rec = DrawRecorder()
    with torch.no_grad():
        torch.func.functional_call(
            wrapper, ({k: meta(v) for k, v in params.items()},
                      {k: meta(v) for k, v in buffers.items()}),
            ({k: meta(v) for k, v in batch.items()}, True, rec))
    return rec.specs


def make_ensemble_epoch_runner(model: nn.Module, noise_level_mag: float = 0.0, *,
                               noise_level_img: float = 0.0,
                               rotate_images: bool = True) -> Callable:
    """``run_epoch(state, data, plans, generators) -> (state, losses)``: one
    stacked step per column of ``plans`` (N, steps, B) over the shared
    device-resident ``data``, member i drawing from ``generators[i]``;
    ``losses`` is (N, steps) on the device."""
    wrapper = _LossOf(model)
    specs_of = {}

    def member_loss(params, buffers, batch, masks, specs):
        source = DrawSource(specs, masks)
        loss, _ = torch.func.functional_call(wrapper, (params, buffers),
                                             (batch, True, source))
        source.check_consumed()
        return loss

    def run_epoch(state: StackedState, data, plans, generators):
        device = next(iter(data.values())).device
        plans = torch.as_tensor(plans).to(device)
        params, buffers = _prefixed(state)
        losses = []
        for s in range(plans.shape[1]):
            batch = _augment_members(_gather(data, plans[:, s]), generators,
                                     noise_level_mag=noise_level_mag,
                                     noise_level_img=noise_level_img,
                                     rotate_images=rotate_images)
            key = tuple((k, tuple(v.shape)) for k, v in batch.items())
            if key not in specs_of:
                specs_of[key] = record_keep_masks(wrapper, state, batch)
            specs = specs_of[key]
            masks = draw_stacked_keep_masks(specs, generators, device)
            loss = torch.func.vmap(partial(member_loss, specs=specs), randomness="error")(
                params, buffers, batch, masks)
            state.optimizer.zero_grad(set_to_none=True)
            loss.sum().backward()
            state.optimizer.step()
            if state.scheduler is not None:
                state.scheduler.step()
            state.step += 1
            losses.append(loss.detach())
        return state, torch.stack(losses, dim=1)

    return run_epoch


def make_ensemble_eval_runner(model: nn.Module, rotate_images: bool = True) -> Callable:
    """``run_eval(state, data, plans, generators) -> (losses, aux)``: per
    stacked step the members' losses and auxiliary outputs, without
    gradients, images rotated by each member's ``generators[i]``; losses
    (N, steps), aux stacked as (steps, N, ...)."""
    wrapper = _LossOf(model)

    def member_eval(params, buffers, batch):
        return torch.func.functional_call(wrapper, (params, buffers),
                                          (batch, False, DrawSource()))

    def run_eval(state: StackedState, data, plans, generators):
        device = next(iter(data.values())).device
        plans = torch.as_tensor(plans).to(device)
        params, buffers = _prefixed(state)
        losses, auxes = [], []
        with torch.no_grad():
            for s in range(plans.shape[1]):
                batch = _augment_members(_gather(data, plans[:, s]), generators,
                                         rotate_images=rotate_images)
                loss, aux = torch.func.vmap(member_eval, randomness="error")(
                    params, buffers, batch)
                losses.append(loss)
                auxes.append(aux)
        return torch.stack(losses, dim=1), _stack_aux(auxes)

    return run_eval


def _member_aux(aux: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: [a[:, i] for a in v] if isinstance(v, (list, tuple)) else v[:, i]
            for k, v in aux.items()}


# -- the ensemble checkpoint ---------------------------------------------------


class EnsembleCheckpoint:
    """The stacked program's resume point under ``ckpt_dir``: an
    ``epoch-<E>.pt`` an epoch (``torch.save`` of the live stacked state, the
    best and at-stop snapshots and every member's random streams) and
    ``bookkeeping.json`` (the host-side early-stopping state, the epoch,
    ``have_best`` / ``have_last``), each written to a temporary name and
    renamed, the state first; the two newest epoch files are kept, so a
    crash between the two writes leaves the previous epoch whole."""

    def __init__(self, ckpt_dir: str):
        self.dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.dir, f"epoch-{epoch}.pt")

    def save(self, epoch: int, state: StackedState, best, last,
             streams: Dict[str, Any], book: Dict[str, Any]) -> None:
        payload = {
            "cur": {"params": {k: v.detach() for k, v in state.params.items()},
                    "buffers": state.buffers,
                    "optimizer": state.optimizer.state_dict(),
                    "scheduler": (None if state.scheduler is None
                                  else state.scheduler.state_dict()),
                    "step": state.step},
            "best": best, "last": last, "streams": streams,
        }
        tmp = self._path(epoch) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(epoch))
        book = dict(book, epoch=epoch, have_best=best is not None,
                    have_last=last is not None)
        tmp = os.path.join(self.dir, "bookkeeping.json.tmp")
        with open(tmp, "w") as f:
            json.dump(book, f)
        os.replace(tmp, os.path.join(self.dir, "bookkeeping.json"))
        for name in os.listdir(self.dir):
            if name.startswith("epoch-") and name.endswith(".pt"):
                e = int(name[len("epoch-"):-len(".pt")])
                if e < epoch - 1:
                    os.remove(os.path.join(self.dir, name))

    def try_restore(self):
        """(payload, book), or None when no complete checkpoint exists."""
        path = os.path.join(self.dir, "bookkeeping.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            book = json.load(f)
        ckpt = self._path(int(book["epoch"]))
        if not os.path.exists(ckpt):
            raise RuntimeError(
                f"ensemble bookkeeping points at epoch {book['epoch']} but {ckpt} is "
                f"missing: the run dir is inconsistent; delete {self.dir} to restart")
        return torch.load(ckpt, map_location="cpu", weights_only=True), book


def _to(tree, device):
    if tree is None:
        return None
    return {k: v.to(device) for k, v in tree.items()}


def _same_layout(ensemble_dir: str, n_data: int) -> None:
    """Raise when ``ensemble_dir`` holds a stacked checkpoint written under
    another data axis than ``n_data``: it resumes under its own mesh."""
    if not os.path.isdir(ensemble_dir):
        return
    one = os.path.exists(os.path.join(ensemble_dir, "bookkeeping.json"))
    ranks = [int(name[len("data-"):]) for name in os.listdir(ensemble_dir)
             if name.startswith("data-")
             and os.path.exists(os.path.join(ensemble_dir, name, "bookkeeping.json"))]
    if (ranks and n_data == 1) or (n_data > 1 and (one or any(d >= n_data for d in ranks))):
        raise RuntimeError(
            f"{ensemble_dir} holds a stacked checkpoint of another data axis than this "
            f"run's ({n_data}): resume it under the mesh that wrote it")


# -- the stacked fit -------------------------------------------------------------


def fit_members(models: Sequence[nn.Module], task: str, cfg: TrainerConfig,
                dataset: ArrayDataset, members: Sequence[Member],
                run_dir: Optional[str] = None, n_classes: Optional[int] = None,
                freeze=None, resume: bool = False,
                ensemble_dir: Optional[str] = None, mesh=None) -> Dict[str, Any]:
    """Train ``members`` as one stacked program; ``models[i]`` is member i's
    model with its initial weights (its seed's, after any surgery), all on
    one device. Per member this is ``Trainer(models[i], task, cfg with
    seed=m.seed, freeze=freeze).fit(dataset.subset(m.train_indices),
    dataset.subset(m.val_indices))``, with the run directory
    ``<run_dir>/<m.name>/``.

    Returns ``{"members": {name: {history, metric_rows, best, epochs_run,
    wall_time_s, state (its TrainState), best_ckpt_epoch with a run dir}},
    "wall_time_s", "states" (the final snapshot: each early-stopped member
    at its stop epoch), "best_states" (the best snapshot, or None), "local"
    (the names of this rank's members, all of them without a mesh)}``.
    ``mesh``: the member axis over the data axis (the module doc)."""
    if not members:
        raise ValueError("no members")
    if len(models) != len(members):
        raise ValueError(f"{len(models)} models for {len(members)} members")
    names = [m.name for m in members]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate member names: {names}")
    for m in members:
        if len(m.train_indices) == 0 or len(m.val_indices) == 0:
            raise ValueError(
                f"member {m.name} has an empty "
                f"{'train' if len(m.train_indices) == 0 else 'val'} index set: every "
                "member needs at least one sample per split")
    n_all = len(members)
    n_data = 1 if mesh is None else mesh.size
    if n_all % n_data:
        raise ValueError(
            f"{n_all} members cannot shard over the mesh's 'data' axis of size {n_data}: "
            "the member count must be a multiple of the axis size (members are placed "
            "whole, one or more per device)")
    # the ensemble-wide step counts, whichever members this rank trains
    own_steps = [-(-len(m.train_indices) // cfg.batch_size) for m in members]
    steps = max(own_steps)
    short = [m.name for m, s in zip(members, own_steps) if s != steps]
    if short:
        warnings.warn(
            f"members {short} need fewer steps than the ensemble-wide {steps} per epoch "
            "and are wrap-extended with extra batches from their own permutation: their "
            "trajectories will not match a sequential run exactly (equal-sized folds "
            "avoid this)")
    val_steps = max(-(-len(m.val_indices) // cfg.batch_size) for m in members)
    writes = mesh is None or mesh.model_rank == 0
    all_members = list(members)
    all_lrs = {cfg.lr if m.lr is None else float(m.lr) for m in members}
    if mesh is not None:  # this data rank's members
        k = n_all // n_data
        local = slice(mesh.data_rank * k, (mesh.data_rank + 1) * k)
        members, models = list(members)[local], list(models)[local]
    n = len(members)
    model0 = models[0]
    device = next(model0.parameters()).device
    own = getattr(getattr(model0, "cfg", None), "n_classes", None)
    n_classes = n_classes or own or 5
    d_monitor, d_mode = ("f1_val", "max") if task == "classification" else ("val_loss", "min")
    monitor, mode = cfg.monitor or d_monitor, cfg.mode or d_mode
    val_steps_i = [-(-len(m.val_indices) // cfg.batch_size) for m in members]
    n_val_i = [len(m.val_indices) for m in members]
    val_subsets = [dataset.subset(m.val_indices) for m in members]

    # each member's random streams: Trainer.fit's
    rngs = [np.random.default_rng(m.seed) for m in members]
    gens = [torch.Generator(device=device).manual_seed(m.seed + 1) for m in members]
    eval_gens = [torch.Generator(device=device).manual_seed(m.seed + 2) for m in members]

    lrs = [cfg.lr if m.lr is None else float(m.lr) for m in members]
    state = stack_states(models, lrs, per_member_lr=len(set(all_lrs)) > 1,
                         weight_decay=cfg.weight_decay,
                         step_size=cfg.step_size, gamma=cfg.gamma,
                         steps_per_epoch=steps, freeze=freeze)

    loggers: List[Optional[MetricsLogger]] = [None] * n
    ckpts: List[Optional[CheckpointManager]] = [None] * n
    if run_dir:
        for i, m in enumerate(members):
            mdir = os.path.join(run_dir, m.name)
            fns = dataset.filenames
            if writes:
                save_run_sidecars(
                    mdir, m.config_dump or dataclasses.asdict(
                        dataclasses.replace(cfg, seed=m.seed, lr=lrs[i])),
                    None if fns is None else [fns[j] for j in m.train_indices],
                    None if fns is None else [fns[j] for j in m.val_indices])
                write_model_config(mdir, models[i])
                loggers[i] = MetricsLogger(mdir)
            ckpts[i] = CheckpointManager(mdir, monitor, mode, cfg.keep_best, write=writes)

    data = dataset.to_device(device)
    run_epoch = make_ensemble_epoch_runner(
        model0, cfg.noise_level_mag, noise_level_img=cfg.noise_level_img,
        rotate_images=cfg.rotate_images)
    run_eval = make_ensemble_eval_runner(model0, rotate_images=cfg.rotate_images)
    val_plans = np.stack([member_val_plan(m, cfg.batch_size, val_steps) for m in members])

    history = [{"train_loss": [], "val_loss": []} for _ in members]
    metric_rows: List[List[Dict[str, float]]] = [[] for _ in members]
    best = [{"value": None, "epoch": -1} for _ in members]
    since_best = np.zeros(n, dtype=int)
    active = np.ones(n, dtype=bool)
    epochs_run = np.zeros(n, dtype=int)
    # best-so-far and at-stop snapshots, on the device; never aliases of the
    # live state (select_members makes new tensors)
    best_snap = last_snap = None
    t_start = time.perf_counter()

    if ensemble_dir is None and run_dir:
        ensemble_dir = os.path.join(run_dir, "_ensemble")
    if ensemble_dir and resume:
        _same_layout(ensemble_dir, n_data)
    if ensemble_dir and n_data > 1:
        ensemble_dir = os.path.join(ensemble_dir, f"data-{mesh.data_rank}")
    ens_ckpt = EnsembleCheckpoint(ensemble_dir) if ensemble_dir else None
    start_epoch = 0
    if resume and ens_ckpt is not None:
        restored = ens_ckpt.try_restore()
        if restored is not None:
            payload, book = restored
            if book.get("names") != names:
                raise RuntimeError(f"resume member mismatch: checkpoint has "
                                   f"{book.get('names')}, run has {names}")
            _restore_live(state, payload["cur"])
            best_snap = _to(payload["best"], device) if book["have_best"] else None
            last_snap = _to(payload["last"], device) if book["have_last"] else None
            streams = payload["streams"]
            for i in range(n):
                rngs[i].bit_generator.state = streams["numpy_rng"][i]
                gens[i].set_state(streams["torch_rng"][i])
                eval_gens[i].set_state(streams["eval_torch_rng"][i])
            history, metric_rows, best = book["history"], book["metric_rows"], book["best"]
            since_best = np.asarray(book["since_best"], dtype=int)
            active = np.asarray(book["active"], dtype=bool)
            epochs_run = np.asarray(book["epochs_run"], dtype=int)
            start_epoch = int(book["epoch"]) + 1

    member_states: List[Optional[TrainState]] = [None] * n
    epoch = start_epoch - 1
    for epoch in (range(start_epoch, cfg.epochs) if active.any() else range(0)):
        plans = np.stack([member_train_plan(m, cfg.batch_size, rngs[i], steps)
                          for i, m in enumerate(members)])
        t0 = time.perf_counter()
        state, losses = run_epoch(state, data, plans, gens)
        losses = losses.cpu().numpy()  # waits for the epoch's steps
        step_time = (time.perf_counter() - t0) / steps
        do_eval = epoch % cfg.eval_every_epochs == 0
        if do_eval:
            val_losses, aux = run_eval(state, data, val_plans, eval_gens)
            val_losses = val_losses.cpu().numpy()

        improved = np.zeros(n, dtype=bool)
        stopped = np.zeros(n, dtype=bool)
        for i, m in enumerate(members):
            if not active[i]:
                continue
            train_loss = float(losses[i].mean())
            if not np.isfinite(train_loss):
                raise FloatingPointError(
                    f"non-finite training loss for member {m.name} at epoch {epoch}")
            history[i]["train_loss"].append(train_loss)
            metrics: Dict[str, float] = {
                "epoch": epoch,
                "train_loss": train_loss,
                "step_time_s": step_time,
                # every member advances together: the ensemble's samples per
                # second, and this member's share
                "samples_per_s": n_all * cfg.batch_size / max(step_time, 1e-9),
                "member_samples_per_s": cfg.batch_size / max(step_time, 1e-9),
            }
            if do_eval:
                metrics["val_loss"] = float(val_losses[i, :val_steps_i[i]].mean())
                history[i]["val_loss"].append(metrics["val_loss"])
                metrics.update(compute_task_metrics(task, _member_aux(aux, i),
                                                    val_subsets[i], n_val_i[i], n_classes))
            metric_rows[i].append(metrics)
            if loggers[i]:
                loggers[i].log(metrics, step=epoch)
            epochs_run[i] = epoch + 1
            if monitor in metrics:
                current = metrics[monitor]
                if (best[i]["value"] is None or (mode == "min" and current < best[i]["value"])
                        or (mode == "max" and current > best[i]["value"])):
                    best[i] = {"value": current, "epoch": epoch}
                    since_best[i] = 0
                    improved[i] = True
                else:
                    since_best[i] += 1
                if since_best[i] >= cfg.patience:
                    active[i] = False
                    stopped[i] = True

        live = snapshot(state)
        if improved.any():
            best_snap = select_members(torch.from_numpy(improved), live,
                                       live if best_snap is None else best_snap)
        if stopped.any():
            last_snap = select_members(torch.from_numpy(stopped), live,
                                       live if last_snap is None else last_snap)
        for i, m in enumerate(members):
            if ckpts[i] is None or not (active[i] or stopped[i]):
                continue
            member_states[i] = unstack_member(live, i, state, into=member_states[i])
            ckpts[i].save(epoch, member_states[i], metric_rows[i][-1], loop={
                "numpy_rng": rngs[i].bit_generator.state,
                "torch_rng": gens[i].get_state(),
                "eval_torch_rng": eval_gens[i].get_state(),
                "history": history[i], "metric_rows": metric_rows[i],
                "best": best[i], "since_best": int(since_best[i])})
        if ens_ckpt is not None and writes:
            ens_ckpt.save(
                epoch, state, best_snap, last_snap,
                {"numpy_rng": [r.bit_generator.state for r in rngs],
                 "torch_rng": [g.get_state() for g in gens],
                 "eval_torch_rng": [g.get_state() for g in eval_gens]},
                {"names": names, "history": history, "metric_rows": metric_rows,
                 "best": best, "since_best": since_best.tolist(),
                 "active": active.tolist(), "epochs_run": epochs_run.tolist()})
        if not active.any():
            break

    # each member's final state: the live one, or its at-stop snapshot
    live = snapshot(state)
    final = live if last_snap is None else select_members(
        torch.from_numpy(active), live, last_snap)
    results: Dict[str, Any] = {"members": {},
                               "wall_time_s": time.perf_counter() - t_start}
    for i, m in enumerate(members):
        res: Dict[str, Any] = {
            "history": history[i], "metric_rows": metric_rows[i], "best": best[i],
            "epochs_run": int(epochs_run[i]),
            # every member shares the ensemble's wall clock
            "wall_time_s": results["wall_time_s"],
            "state": unstack_member(final, i, state),
        }
        if ckpts[i] is not None:
            res["best_ckpt_epoch"] = ckpts[i].best_epoch()
            summary = {f"best_{monitor}": best[i]["value"], "best_epoch": best[i]["epoch"],
                       "best_ckpt_epoch": res["best_ckpt_epoch"]}
            if history[i]["val_loss"]:
                summary["best_val_loss"] = float(np.min(history[i]["val_loss"]))
            aucs = [r["AUC_val"] for r in metric_rows[i] if "AUC_val" in r]
            if aucs:
                summary["best_auc"] = float(np.max(aucs))
            if loggers[i]:
                loggers[i].set_summary(**summary)
                loggers[i].close()
        results["members"][m.name] = res
    results["states"] = final
    results["best_states"] = best_snap
    results["local"] = [m.name for m in members]
    if mesh is not None:
        host = {name: {k: v for k, v in r.items() if k != "state"}
                for name, r in results["members"].items()}
        for part in mesh.gather_objects(host):
            for name, r in part.items():
                results["members"].setdefault(name, r)
        results["members"] = {m.name: results["members"][m.name] for m in all_members}
        mesh.barrier()  # every member's files are written before any rank returns
    return results
