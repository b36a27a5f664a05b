"""JAX/flax variables -> the port's torch ``state_dict``.

A numpy-only mirror of
``vn_celeb_face_recognition_tpu.models.torch_convert.flax_to_torch_state_dict``
(it imports nothing from JAX), so weights held by the JAX package load
into the port's modules and both packages compute on the same numbers.

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
