"""Seeded weights for the benchmark's networks, made on the device.

A network's weights come from the run's seed and the network's role in
the configuration, drawn on the device in float32 (the type the program
serves them in) in three calls, over the keys in sorted order:

- ``randn`` for every convolution and linear weight, normal with variance
  ``1 / fan_in`` (flax's lecun-normal);
- ``randn`` for every bias, BatchNorm shift and running mean, normal with
  standard deviation ``SHIFT_STD``, and for the spread of every BatchNorm
  scale;
- ``rand`` for every BatchNorm running variance, log-uniform on
  ``VAR_RANGE``, and every PReLU slope, uniform on ``SLOPE_RANGE``.

A BatchNorm's scale is ``sqrt(var) * (1 + SCALE_STD * z)``, so each
channel leaves the layer at about the size it came in, whatever its
variance; the small variances make the ``eps`` under the root count. So
a fold or a layer that drops a shift, a mean, a bias or the ``eps``, or
takes a slope from another channel, gives other answers than the
reference. A configuration may then fill or scale named tensors (its
``init``), each such change listed under its ``assumed``. The same (seed,
role) gives the same tensors, so the reference regenerates them rather
than reading the program's.
"""

import fnmatch

import numpy as np
import torch
from torch import nn

ROLES = ("detector", "encoder", "classifier", "emotion")


def role_seed(seed, role):
    """A 63-bit generator seed from the run's seed and the role."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1),
                                 ROLES.index(role)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


SHIFT_STD = 0.1
SCALE_STD = 0.1
VAR_RANGE = (1e-4, 1.5)
SLOPE_RANGE = (0.05, 0.45)


@torch.no_grad()
def seeded_state(make, spec, seed, role, device):
    """A state_dict for the keys and shapes of the module ``make(spec)``
    builds, as the module docstring says; ``spec["init"]``, if any, is
    ``{"fill": {pattern: value}, "scale": {pattern: factor}}`` over the
    keys (fnmatch patterns)."""
    with torch.device("meta"):
        module = make(spec)
    init = spec.get("init")
    owners = dict(module.named_modules())
    state = module.state_dict()
    kinds = {}
    for key in state:
        owner, _, leaf = key.rpartition(".")
        m = owners[owner]
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            kinds[key] = {"weight": "scale", "bias": "normal",
                          "running_mean": "normal",
                          "running_var": "variance"}.get(leaf, "zero")
        elif isinstance(m, nn.PReLU):
            kinds[key] = "slope"
        elif isinstance(m, (nn.Conv2d, nn.Linear)) and leaf == "weight":
            kinds[key] = "lecun"
        elif leaf == "bias":
            kinds[key] = "normal"
        else:
            kinds[key] = "zero"
    gen = torch.Generator(device=device)
    gen.manual_seed(role_seed(seed, role))

    def draw(kind_set, sampler):
        """One call of ``sampler`` for every key of ``kind_set``'s kinds,
        split in sorted key order (the draw does not hang on registration
        order)."""
        keys = sorted(k for k in state if kinds[k] in kind_set)
        flat = sampler(sum(state[k].numel() for k in keys))
        off, parts = 0, {}
        for key in keys:
            n = state[key].numel()
            parts[key] = flat[off:off + n].reshape(state[key].shape)
            off += n
        return parts

    lecun = draw({"lecun"}, lambda n: torch.randn(n, generator=gen,
                                                  device=device))
    normal = draw({"normal", "scale"}, lambda n: torch.randn(
        n, generator=gen, device=device))
    uniform = draw({"variance", "slope"}, lambda n: torch.rand(
        n, generator=gen, device=device))
    lo, hi = np.log(VAR_RANGE[0]), np.log(VAR_RANGE[1])
    out = {}
    for key, t in state.items():
        kind = kinds[key]
        if kind == "lecun":
            out[key] = lecun[key] * (t.numel() // t.shape[0]) ** -0.5
        elif kind == "normal":
            out[key] = normal[key] * SHIFT_STD
        elif kind == "variance":
            out[key] = torch.exp(lo + (hi - lo) * uniform[key])
        elif kind == "slope":
            a, b = SLOPE_RANGE
            out[key] = a + (b - a) * uniform[key]
        else:
            out[key] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    for key in state:  # a scale keeps its channel's size: sqrt(var)
        if kinds[key] == "scale":
            var = out[key.rpartition(".")[0] + ".running_var"]
            out[key] = var.sqrt() * (1.0 + SCALE_STD * normal[key])
    for pattern, value in (init or {}).get("fill", {}).items():
        for key in fnmatch.filter(out, pattern):
            out[key].fill_(value)
    for pattern, factor in (init or {}).get("scale", {}).items():
        for key in fnmatch.filter(out, pattern):
            out[key].mul_(factor)
    return {k: out[k] for k in state}


def read_npz(path, device):
    """A torch-keyed state_dict saved as ``.npz`` -> f32 tensors."""
    with np.load(path) as z:
        return {k.removeprefix("module."): torch.from_numpy(
            np.array(z[k], dtype=np.float32)).to(device) for k in z.files}


def on_device(make, device, state):
    """``make()`` built without drawing its default initial weights (on
    the meta device), then given ``state`` on ``device``; in eval mode."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device)
    module.load_state_dict(state)
    return module.eval()

