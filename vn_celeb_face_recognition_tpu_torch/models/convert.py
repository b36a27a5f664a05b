"""JAX/flax variables <-> the port's torch ``state_dict``.

``state_dict_from_jax`` is a numpy-only mirror of
``vn_celeb_face_recognition_tpu.models.torch_convert.flax_to_torch_state_dict``
(it imports nothing from JAX), so weights held by the JAX package load
into the port's modules and both packages compute on the same numbers.
``state_dict_to_jax`` is its inverse: the port's weights as the nested
numpy dicts of the flax layout, the form the JAX package's checkpoints
hold, so a checkpoint the port writes is one both packages read.

Rules: conv kernels [kh, kw, I, O] -> weight [O, I, kh, kw]; dense
kernels [I, O] -> weight [O, I]; BatchNorm scale/bias and batch_stats
mean/var -> weight/bias/running_mean/running_var; PReLU alpha -> weight.
"""

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def state_dict_from_jax(variables_np):
    """Nested ``{"params": ..., "batch_stats": ...}`` numpy dicts ->
    flat torch-keyed ``{key: torch.Tensor}`` (f32 copies)."""
    params = variables_np.get("params", {})
    batch_stats = variables_np.get("batch_stats", {})
    bn_scopes = {path[:-1] for path, _ in _flatten(batch_stats)}

    out = {}
    for path, value in _flatten(batch_stats):
        key = ".".join(path[:-1])
        leaf = path[-1]
        if leaf == "mean":
            out[key + ".running_mean"] = np.asarray(value)
        elif leaf == "var":
            out[key + ".running_var"] = np.asarray(value)
        else:
            raise ValueError(f"Unhandled batch_stats leaf: {path}")
    for path, value in _flatten(params):
        scope, leaf = path[:-1], path[-1]
        key = ".".join(scope)
        value = np.asarray(value)
        if leaf == "scale":
            if scope not in bn_scopes:
                raise ValueError(f"scale outside BatchNorm at {path}")
            out[key + ".weight"] = value
        elif leaf == "kernel":
            if value.ndim == 4:
                out[key + ".weight"] = np.transpose(value, (3, 2, 0, 1))
            elif value.ndim == 2:
                out[key + ".weight"] = np.transpose(value, (1, 0))
            else:
                raise ValueError(
                    f"Unhandled kernel shape {value.shape} at {path}")
        elif leaf == "bias":
            out[key + ".bias"] = value
        elif leaf == "alpha":
            out[key + ".weight"] = value  # PReLU slope vector
        else:
            raise ValueError(f"Unhandled flax param leaf: {path}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
            for k, v in out.items()}


def _nest(tree, dotted, value):
    *scope, leaf = dotted.split(".")
    for key in scope:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def state_dict_to_jax(module_or_state_dict):
    """A port module (or its torch-keyed ``state_dict``) -> nested
    ``{"params": ..., "batch_stats": ...}`` numpy f32 dicts in the flax
    layout; ``batch_stats`` only when the module has BatchNorm. BatchNorm
    scopes are told by their running statistics, and a 1-d ``weight``
    outside them is a PReLU slope. ``num_batches_tracked`` has no flax
    counterpart and is dropped."""
    sd = (module_or_state_dict.state_dict()
          if isinstance(module_or_state_dict, torch.nn.Module)
          else module_or_state_dict)
    sd = {k: np.array(v.detach().cpu().to(torch.float32).numpy()
                      if isinstance(v, torch.Tensor) else v,
                      dtype=np.float32, copy=True)
          for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    bn_scopes = {k[:-len(".running_mean")] for k in sd
                 if k.endswith(".running_mean")}
    params, batch_stats = {}, {}
    for key, value in sd.items():
        scope, leaf = key.rsplit(".", 1)
        if leaf in ("running_mean", "running_var"):
            _nest(batch_stats, f"{scope}.{leaf[len('running_'):]}", value)
        elif scope in bn_scopes:
            if leaf not in ("weight", "bias"):
                raise ValueError(f"Unhandled BatchNorm entry: {key}")
            _nest(params, f"{scope}.{'scale' if leaf == 'weight' else leaf}",
                  value)
        elif leaf == "bias":
            _nest(params, key, value)
        elif leaf == "weight" and value.ndim == 4:
            _nest(params, f"{scope}.kernel", np.transpose(value, (2, 3, 1, 0)))
        elif leaf == "weight" and value.ndim == 2:
            _nest(params, f"{scope}.kernel", np.ascontiguousarray(value.T))
        elif leaf == "weight" and value.ndim == 1:
            _nest(params, f"{scope}.alpha", value)  # PReLU slope vector
        else:
            raise ValueError(f"Unhandled torch state_dict entry: {key} "
                             f"{value.shape}")
    out = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out
