from .optim import (
    build_optimizer,
    freeze_encoder_except_projection,
    freeze_encoders_except_projection,
    freeze_mask,
)
from .checkpoint import best_ckpt_path
from .state import TrainState
from .step import (
    make_epoch_runner,
    make_eval_runner,
    make_train_step,
)
from .trainer import Trainer, TrainerConfig, compute_task_metrics

__all__ = [
    "TrainState",
    "Trainer",
    "TrainerConfig",
    "best_ckpt_path",
    "build_optimizer",
    "compute_task_metrics",
    "freeze_encoder_except_projection",
    "freeze_encoders_except_projection",
    "freeze_mask",
    "make_epoch_runner",
    "make_eval_runner",
    "make_train_step",
]
