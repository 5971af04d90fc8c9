"""The optimizer, its StepLR schedule and parameter freezing (port of
multimodal_supernovae_tpu/training/optim.py).

  * RAdam with torch's L2 ``weight_decay`` (its default, not decoupled):
    the decay is added to the gradient before the adaptive update, which is
    what ``optax.add_decayed_weights`` ahead of ``optax.radam`` computes
    (tests/test_optim_parity.py pins the two against each other);
  * StepLR as a staircase on optimizer steps: the lr is multiplied by
    ``gamma`` every ``step_size * steps_per_epoch`` steps, as the JAX
    ``optax.exponential_decay(staircase=True)`` does;
  * freezing through the same parameter-path predicates: a path is the
    parameter's dotted name split into a tuple. Frozen parameters are left
    out of the optimizer, so they get no update and no decay.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

Path = Tuple[str, ...]


def build_optimizer(
    params: Iterable[Tuple[str, nn.Parameter]],
    lr: float,
    weight_decay: float = 0.0,
    step_size: Optional[int] = None,
    gamma: Optional[float] = None,
    steps_per_epoch: int = 1,
    freeze: Optional[Callable[[Path], bool]] = None,
) -> Tuple[torch.optim.Optimizer, Optional[torch.optim.lr_scheduler.LRScheduler]]:
    """RAdam over ``params`` (``module.named_parameters()``) with L2 weight
    decay, and a StepLR scheduler to step once per optimizer step when both
    ``step_size`` (epochs) and ``gamma`` are given (else None). ``freeze``
    is a predicate over parameter paths: True leaves the parameter out."""
    params = list(params)
    if freeze is not None:
        labels = freeze_mask(params, freeze)
        params = [(n, p) for n, p in params if labels[n] == "train"]
    # RAdam's weight_decay is L2 (coupled) unless decoupled_weight_decay=True
    opt = torch.optim.RAdam([p for _, p in params], lr=lr, weight_decay=weight_decay)
    sched = None
    if step_size is not None and gamma is not None:
        sched = torch.optim.lr_scheduler.StepLR(
            opt, step_size=step_size * steps_per_epoch, gamma=gamma)
    return opt, sched


def freeze_mask(params: Iterable[Tuple[str, nn.Parameter]],
                frozen_pred: Callable[[Path], bool]) -> Dict[str, str]:
    """Label each parameter 'frozen' or 'train' by its path predicate."""
    return {name: "frozen" if frozen_pred(tuple(name.split("."))) else "train"
            for name, _ in params}


def freeze_encoder_except_projection(encoder_name: str) -> Callable[[Path], bool]:
    """Freeze every parameter under ``encoder_name`` except its final
    ``projection`` layer."""

    def pred(path: Path) -> bool:
        return encoder_name in path and "projection" not in path

    return pred


def freeze_encoders_except_projection(encoder_names: Sequence[str]) -> Callable[[Path], bool]:
    """The same for several encoders (both sequence towers of a pretrained
    CLIP model)."""
    names = set(encoder_names)

    def pred(path: Path) -> bool:
        return bool(names.intersection(path)) and "projection" not in path

    return pred
