"""The training layer: losses, optimizers, checkpoints, the trainers, the
online-aug step ``aug_step`` and RetinaFace detector training
(``detector``: synthetic scenes, the SSD train step and its evaluations;
the loss is in the submodule ``multibox_loss``). Counterpart of the JAX
package's ``training/``."""

from .checkpoint import load_checkpoint, save_checkpoint
from .detector import (
    conf_sparsity,
    detection_recall,
    make_detection_train_step,
    make_eval_fns,
    probe_crop_landmarks,
    synth_batch,
    synth_scene,
    template_landmarks,
)
from .losses import LOSSES, METRICS, accuracy, neg_log_llhood
from .optim import make_adamw_cosine, make_lr_scheduler, make_optimizer
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
    "make_adamw_cosine",
    "save_checkpoint",
    "load_checkpoint",
    "BaseTrainer",
    "ClassificationTrainer",
    "AugClassificationTrainer",
    "template_landmarks",
    "probe_crop_landmarks",
    "synth_scene",
    "synth_batch",
    "make_detection_train_step",
    "make_eval_fns",
    "conf_sparsity",
    "detection_recall",
]
