"""Checkpoint reading (the read side of the JAX package's
``training/checkpoint.py``).

A JAX checkpoint is one pickle of a dict: ``arch``, ``epoch``,
``state_dict`` (the model's flax variables as nested numpy dicts),
``optimizer``, ``monitor_best`` and ``config``. ``load_checkpoint`` reads
it with ``pickle``; ``load_state_dict_from_jax`` loads its variables into a
port module through ``models.convert.state_dict_from_jax``. The JAX
package's orbax checkpoints (directories) need orbax, which the port does
not use, so they are refused. Writing checkpoints comes with the trainers.

Unpickling runs code from the file: read only checkpoints you made.
"""

import os
import pickle

from ..models.convert import state_dict_from_jax


def load_checkpoint(path):
    """The checkpoint dict of a one-pickle JAX checkpoint file."""
    path = str(path)
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint, which needs orbax; "
            "the port reads only the one-pickle checkpoint format (save it "
            "with backend='pickle')")
    with open(path, "rb") as fp:
        return pickle.load(fp)


def load_state_dict_from_jax(module, state_dict):
    """Load JAX variables (``{"params": ..., "batch_stats": ...}`` numpy
    dicts, e.g. a checkpoint's ``state_dict``) into ``module``, strictly.
    Returns the module."""
    module.load_state_dict(state_dict_from_jax(state_dict), strict=True)
    return module
