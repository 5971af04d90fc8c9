"""Train and eval steps and whole-epoch loops (port of
multimodal_supernovae_tpu/training/step.py).

The dataset lives on the device as a dict of tensors and an epoch is a
Python loop over a (steps, batch_size) index plan: each step gathers its
batch on the device (``take``), augments it, computes the loss, runs the
backward and applies the optimizer. Per-step losses stay on the device
until the caller reads them, so the loop does not wait for the device.

Under data parallelism (``mesh``, a ``parallel.mesh.DataMesh``) each rank
runs the step on its block of the global batch's rows with a
``utils.draws.RankRows`` in place of the generator; ``model.loss_fn``
all-gathers its outputs, so the loss is the global batch's, and the
gradients are averaged over the ranks (one flattened all-reduce) before the
optimizer steps.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..data.augment import augment_batch
from ..data.batching import take
from .state import TrainState


def make_train_step(model, noise_level_mag: float = 0.0, *,
                    noise_level_img: float = 0.0, rotate_images: bool = True,
                    mesh=None) -> Callable:
    """One optimizer step: augment -> ``model.loss_fn`` -> backward -> update.

    Returns ``train_step(state, batch, generator) -> (state, loss)``; the
    noise, the image rotations and the dropout masks are drawn from
    ``generator``. A train-mode loss also moves the image tower's BatchNorm
    running statistics. With ``mesh`` the loss spans the global batch and
    the gradients are averaged over the ranks."""
    loss_kw = {} if mesh is None else {"mesh": mesh}

    def train_step(state: TrainState, batch, generator: torch.Generator):
        batch = augment_batch(batch, generator, noise_level_mag,
                              noise_level_img=noise_level_img,
                              rotate_images=rotate_images)
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = model.loss_fn(batch, train=True, generator=generator, **loss_kw)
        loss.backward()
        if mesh is not None:
            mesh.average_gradients(model.parameters())
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        return state, loss.detach()

    return train_step


def _plan_on(index_plan, device) -> torch.Tensor:
    return torch.as_tensor(index_plan).to(device)


def make_epoch_runner(model, noise_level_mag: float = 0.0, *,
                      noise_level_img: float = 0.0, rotate_images: bool = True,
                      mesh=None) -> Callable:
    """``run_epoch(state, data, index_plan, generator) -> (state, losses)``:
    one train step per row of ``index_plan`` over the device-resident
    ``data``; ``losses`` is a (steps,) tensor on the device."""
    step = make_train_step(model, noise_level_mag, noise_level_img=noise_level_img,
                           rotate_images=rotate_images, mesh=mesh)

    def run_epoch(state: TrainState, data: Dict[str, torch.Tensor], index_plan,
                  generator: torch.Generator) -> Tuple[TrainState, torch.Tensor]:
        device = next(iter(data.values())).device
        losses = []
        for idx in _plan_on(index_plan, device):
            state, loss = step(state, take(data, idx), generator)
            losses.append(loss)
        return state, torch.stack(losses)

    return run_epoch


def _stack_aux(auxes: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-step aux dicts -> one dict stacked over steps (lists stay lists
    of stacked tensors, one per modality)."""
    out = {}
    for key, first in auxes[0].items():
        if isinstance(first, (list, tuple)):
            out[key] = [torch.stack([a[key][i] for a in auxes])
                        for i in range(len(first))]
        else:
            out[key] = torch.stack([a[key] for a in auxes])
    return out


def make_eval_runner(model, rotate_images: bool = True, mesh=None) -> Callable:
    """``run_eval(state, data, index_plan, generator=None) -> (losses, aux)``:
    per-step loss and the model's auxiliary outputs (embeddings, pred or
    logits), stacked over steps, in eval mode and without gradients.

    Images are rotated (``rotate_images``), with the turns drawn from
    ``generator``, as the JAX eval runner does: the reference validates on
    loaders that rotate images at noise level 0. ``generator`` also goes to
    ``model.loss_fn``, where masked pretraining draws its validation masks
    (the JAX runner hands each step a fresh key); a model without images or
    masks draws nothing from it and may run without one. With ``mesh`` the
    losses and the auxiliary outputs are the global batch's."""
    loss_kw = {} if mesh is None else {"mesh": mesh}

    def run_eval(state: TrainState, data: Dict[str, torch.Tensor], index_plan,
                 generator: Optional[torch.Generator] = None):
        device = next(iter(data.values())).device
        losses, auxes = [], []
        with torch.no_grad():
            for idx in _plan_on(index_plan, device):
                batch = augment_batch(take(data, idx), generator,
                                      rotate_images=rotate_images)
                loss, aux = model.loss_fn(batch, train=False, generator=generator,
                                          **loss_kw)
                losses.append(loss)
                auxes.append(aux)
        return torch.stack(losses), _stack_aux(auxes)

    return run_eval
