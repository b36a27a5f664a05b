"""Checkpoint save / load / resume (counterpart of the JAX package's
``training/checkpoint.py``).

A checkpoint is one pickle of a dict, the JAX package's format: ``arch``,
``epoch``, ``state_dict`` (the model's variables as nested numpy dicts in
the flax layout, ``models.convert.state_dict_to_jax``), ``optimizer``,
``monitor_best`` and ``config``. The JAX package's ``load_checkpoint`` +
``restore_variables`` therefore read the weights of a model the port
trained, and the port reads the JAX package's checkpoints.

The port writes its optimizer as torch's ``state_dict`` with numpy arrays
in place of tensors, and adds ``trainer_state`` (the scheduler, the
trainer's generator, the loader's shuffle state and the early-stop
count), so that a resumed run continues exactly as an uninterrupted one.
A JAX checkpoint's ``optimizer`` is the optax state of the JAX package's
``make_optimizer``; ``restore_optimizer`` maps its learning rate, Adam's
moments and step count, or SGD's momentum trace, onto torch's optimizer.
The JAX package's orbax checkpoints (directories) need orbax, which the
port does not use, so they are refused.

Unpickling runs code from the file: read only checkpoints you made.
"""

import os
import pickle

import numpy as np
import torch

from ..models.convert import state_dict_from_jax, state_dict_to_jax


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_torch(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return tree


def save_checkpoint(path, *, arch, epoch, model, optimizer, monitor_best,
                    config, trainer_state=None):
    """Write ``model``'s weights (flax layout), ``optimizer``'s torch
    state and the run's bookkeeping to ``path`` as one pickle."""
    state = {
        "arch": arch,
        "epoch": int(epoch),
        "state_dict": state_dict_to_jax(model),
        "optimizer": _to_numpy(optimizer.state_dict()),
        "monitor_best": float(monitor_best),
        "config": config,
    }
    if trainer_state is not None:
        state["trainer_state"] = _to_numpy(trainer_state)
    with open(str(path), "wb") as fp:
        pickle.dump(state, fp)


def load_checkpoint(path):
    """The checkpoint dict of a one-pickle checkpoint file."""
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


def trainer_state_from(checkpoint):
    """The checkpoint's ``trainer_state`` with tensors restored, or None
    for a checkpoint without one (the JAX package's)."""
    state = checkpoint.get("trainer_state")
    return None if state is None else _to_torch(state)


def _optax_slots(opt_state):
    """(learning rate, Adam's (count, mu, nu) or None, SGD's trace or
    None) of the optax state the JAX package's ``make_optimizer``
    builds."""
    lr = float(np.asarray(opt_state["hyperparams"]["learning_rate"]))
    adam = trace = None
    for entry in opt_state["inner_state"].values():
        if "mu" in entry:
            adam = (int(np.asarray(entry["count"])), entry["mu"], entry["nu"])
        elif "trace" in entry:
            trace = entry["trace"]
    return lr, adam, trace


def restore_optimizer(optimizer, model, opt_state, batch_stats=None):
    """Load a checkpoint's ``optimizer`` entry into ``optimizer``, built
    over ``model.parameters()``: torch's own state as saved, or the optax
    state of a JAX checkpoint (its learning rate, and Adam's moments and
    count or SGD's momentum trace, moved to the torch layout)."""
    if "param_groups" in opt_state:
        optimizer.load_state_dict(_to_torch(opt_state))
        return optimizer
    if "inner_state" not in opt_state:
        raise ValueError("the checkpoint's optimizer entry is neither a "
                         "torch nor an optax state")
    lr, adam, trace = _optax_slots(opt_state)
    extra = {} if not batch_stats else {"batch_stats": batch_stats}

    def torch_keyed(tree):
        return state_dict_from_jax({"params": tree, **extra})

    names = [name for name, _ in model.named_parameters()]
    sd = optimizer.state_dict()
    state = {}
    if isinstance(optimizer, torch.optim.Adam):
        if adam is None:
            raise ValueError("an Adam optimizer needs Adam's moments; the "
                             "checkpoint has none")
        count, mu, nu = adam
        mu, nu = torch_keyed(mu), torch_keyed(nu)
        if count:
            state = {i: {"step": torch.tensor(float(count)),
                         "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                     for i, n in enumerate(names)}
    elif isinstance(optimizer, torch.optim.SGD):
        if trace is not None:
            buf = torch_keyed(trace)
            state = {i: {"momentum_buffer": buf[n]}
                     for i, n in enumerate(names)}
    else:
        raise ValueError(f"cannot map an optax state onto "
                         f"{type(optimizer).__name__}")
    for group in sd["param_groups"]:
        group["lr"] = lr
    optimizer.load_state_dict({"state": state,
                               "param_groups": sd["param_groups"]})
    return optimizer
