"""Shared NCHW building blocks with the torch reference's state_dict keys.

Counterpart of ``vn_celeb_face_recognition_tpu/models/layers.py``.
Modules hold f32 parameters and compute in the dtype of their input:
the functional helpers cast each parameter to the activation dtype at
use (BatchNorm keeps its f32 statistics, as flax does).

BatchNorm follows the module's mode. In eval mode it normalises with the
running statistics. In train mode it has flax's ``nn.BatchNorm``
semantics: it normalises with the batch's mean and biased variance (in
f32), and updates the running statistics as ``running = (1 - m) running +
m batch`` with torch's momentum ``m`` (flax momentum 1 - m), the variance
biased too; ``F.batch_norm(training=True)`` would update it with the
unbiased one, n / (n - 1) larger.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


def conv(m: nn.Conv2d, x):
    return F.conv2d(x, _cast(m.weight, x.dtype), _cast(m.bias, x.dtype),
                    m.stride, m.padding, m.dilation, m.groups)


def linear(m: nn.Linear, x):
    return F.linear(x, _cast(m.weight, x.dtype), _cast(m.bias, x.dtype))


def prelu(m: nn.PReLU, x):
    return F.prelu(x, _cast(m.weight, x.dtype))


def batch_norm(m, x):
    """BatchNorm with f32 statistics and affine terms (mixed precision when
    ``x`` is bf16): the running statistics in eval mode, the batch's in
    train mode (then the running ones are updated, as flax does)."""
    if not m.training:
        return F.batch_norm(x, m.running_mean, m.running_var, m.weight,
                            m.bias, False, 0.0, m.eps)
    c = x.shape[1]
    n = x.numel() // c
    # momentum 1 gives this batch's mean and unbiased variance
    dtype = torch.promote_types(x.dtype, torch.float32)
    mean = torch.zeros(c, dtype=dtype, device=x.device)
    var = torch.ones(c, dtype=dtype, device=x.device)
    out = F.batch_norm(x, mean, var, m.weight, m.bias, True, 1.0, m.eps)
    with torch.no_grad():
        m.running_mean.mul_(1.0 - m.momentum).add_(mean, alpha=m.momentum)
        m.running_var.mul_(1.0 - m.momentum).add_(var * ((n - 1) / n),
                                                  alpha=m.momentum)
    return out


def dropout(x, p, generator):
    """Zero each element with probability ``p`` and scale the rest by
    1 / (1 - p), the mask drawn from ``generator``."""
    if p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


def max_pool_ceil(x, window, stride, ceil_mode=True):
    """Max pool over NCHW with torch's ceil-mode semantics: the last
    partial window is included, never one that starts in the padding."""
    return F.max_pool2d(x, window, stride, ceil_mode=ceil_mode)


class BasicConv2d(nn.Module):
    """Conv(bias=False) + BatchNorm(eps=1e-3) + ReLU."""

    def __init__(self, in_planes, out_planes, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_planes, out_planes, kernel_size,
                              stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_planes, eps=0.001, momentum=0.1)

    def forward(self, x):
        return F.relu(batch_norm(self.bn, conv(self.conv, x)))


def coerce_dtype(d):
    """A config's dtype (None, a torch dtype, or its name such as
    ``"bfloat16"``) -> a torch dtype; None is float32."""
    if d is None:
        return torch.float32
    if isinstance(d, torch.dtype):
        return d
    dtype = getattr(torch, str(d), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {d!r}")
    return dtype


def read_state_dict(path):
    """A torch-keyed state_dict from a local ``.npz`` or a torch ``.pth`` /
    ``.pt`` file (read with ``weights_only=True``; a ``state_dict`` entry
    is taken when the file holds a training checkpoint), as f32 tensors,
    with a DataParallel ``module.`` prefix dropped."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            sd = {k: np.array(z[k]) for k in z.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    return {k.removeprefix("module."):
            (v.to(torch.float32) if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.array(v, dtype=np.float32)))
            for k, v in sd.items()}


def load_npz(net, path):
    """Load a torch-keyed npz state_dict into ``net`` (strict; a
    DataParallel ``module.`` prefix is dropped)."""
    net.load_state_dict(read_state_dict(path), strict=True)
    return net


def seeded_init_(module, generator):
    """Deterministic random init from an explicit ``torch.Generator``:
    He-normal conv/linear weights, zero biases, identity BatchNorm,
    PReLU slopes 0.25. Returns the module."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)
    return module
