"""Optimizers and learning-rate schedulers from a config block.

Counterpart of ``vn_celeb_face_recognition_tpu/training/optim.py``, which
reproduces torch's optimizers in optax; here they are torch's own:

* ``make_optimizer("Adam" | "SGD", args, params)``: ``torch.optim.Adam``
  and ``torch.optim.SGD``. Their weight decay is an L2 term added to the
  gradient before the moment updates (not decoupled AdamW), as the JAX
  chain ``add_decayed_weights -> scale_by_adam`` computes it.
* ``make_lr_scheduler("ReduceLROnPlateau" | "MultiStepLR", args,
  optimizer)``: torch's schedulers. The trainer steps ReduceLROnPlateau on
  the validation loss each epoch and MultiStepLR once an epoch.
  MultiStepLR multiplies the rate by ``gamma`` at each milestone only. The
  JAX trainer passes the current rate as the base to its ``MultiStepLR``
  every epoch, so there the rate shrinks by ``gamma`` every epoch after
  the first milestone; the port does not reproduce that.
"""

import torch

_OPTIMIZER_ARGS = {
    "Adam": ("lr", "weight_decay", "betas", "eps"),
    "SGD": ("lr", "momentum", "weight_decay"),
}


def make_optimizer(name, args, params):
    """The torch optimizer a config's ``optimizer`` block names, over
    ``params``. The JAX package's defaults apply: lr 1e-3, no weight
    decay, Adam betas (0.9, 0.999) and eps 1e-8, SGD without momentum."""
    if name not in _OPTIMIZER_ARGS:
        raise ValueError(f"Unknown optimizer '{name}'; have "
                         f"{sorted(_OPTIMIZER_ARGS)}")
    unknown = set(args) - set(_OPTIMIZER_ARGS[name])
    if unknown:
        raise ValueError(f"{name}: unsupported arguments {sorted(unknown)}")
    args = dict(args)
    lr = float(args.pop("lr", 1e-3))
    if name == "Adam":
        return torch.optim.Adam(
            params, lr=lr, betas=tuple(args.get("betas", (0.9, 0.999))),
            eps=args.get("eps", 1e-8),
            weight_decay=args.get("weight_decay", 0.0))
    return torch.optim.SGD(params, lr=lr,
                           momentum=args.get("momentum", 0.0),
                           weight_decay=args.get("weight_decay", 0.0))


def make_lr_scheduler(name, args, optimizer):
    """torch's ``ReduceLROnPlateau`` or ``MultiStepLR`` on ``optimizer``
    from a config's ``lr_scheduler`` block (``verbose`` is dropped)."""
    args = {k: v for k, v in args.items() if k != "verbose"}
    if name == "ReduceLROnPlateau":
        return torch.optim.lr_scheduler.ReduceLROnPlateau(optimizer, **args)
    if name == "MultiStepLR":
        return torch.optim.lr_scheduler.MultiStepLR(optimizer, **args)
    raise ValueError(f"Unknown lr scheduler '{name}'; have "
                     "['MultiStepLR', 'ReduceLROnPlateau']")


def get_current_lr(optimizer):
    return float(optimizer.param_groups[0]["lr"])


def set_current_lr(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer
