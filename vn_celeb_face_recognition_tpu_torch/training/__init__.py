"""The training layer: losses, optimizers, checkpoints, the trainers and
the online-aug step ``aug_step`` (counterpart of the JAX package's
``training/``, its classification trainers; detector training is not
ported yet)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .losses import LOSSES, METRICS, accuracy, neg_log_llhood
from .optim import make_lr_scheduler, make_optimizer
from .trainer import (
    AugClassificationTrainer,
    BaseTrainer,
    ClassificationTrainer,
)

__all__ = [
    "neg_log_llhood",
    "accuracy",
    "LOSSES",
    "METRICS",
    "make_optimizer",
    "make_lr_scheduler",
    "save_checkpoint",
    "load_checkpoint",
    "BaseTrainer",
    "ClassificationTrainer",
    "AugClassificationTrainer",
]
