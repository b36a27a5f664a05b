"""Name -> component registries for config-driven construction.

Counterpart of ``vn_celeb_face_recognition_tpu/registry.py``: a config's
``name`` strings resolve here, and an unknown name fails with the list of
valid ones.
"""

from . import data as _data
from .training import trainer as _trainer
from .training.losses import LOSSES, METRICS

DATASETS = {
    "VNCelebDataset": _data.VNCelebDataset,
    "VNCelebEmbDataset": _data.VNCelebEmbDataset,
}

TRAINERS = {
    "ClassificationTrainer": _trainer.ClassificationTrainer,
    "AugClassificationTrainer": _trainer.AugClassificationTrainer,
}


def _lookup(table, what, name):
    if name not in table:
        raise KeyError(f"Unknown {what} '{name}'; have {sorted(table)}")
    return table[name]


def build_dataset(name, **kwargs):
    return _lookup(DATASETS, "dataset", name)(**kwargs)


def build_trainer(name, *args, **kwargs):
    return _lookup(TRAINERS, "trainer", name)(*args, **kwargs)


def get_loss(name):
    return _lookup(LOSSES, "loss", name)


def get_metric(name):
    return _lookup(METRICS, "metric", name)
