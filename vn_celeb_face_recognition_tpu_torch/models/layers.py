"""Shared NCHW building blocks with the torch reference's state_dict keys.

Counterpart of ``vn_celeb_face_recognition_tpu/models/layers.py``.
Modules hold f32 parameters and compute in the dtype of their input:
the functional helpers cast each parameter to the activation dtype at
use (BatchNorm keeps its f32 statistics, as flax does).
"""

import torch
import torch.nn.functional as F
from torch import nn


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


def conv(m: nn.Conv2d, x):
    return F.conv2d(x, _cast(m.weight, x.dtype), _cast(m.bias, x.dtype),
                    m.stride, m.padding)


def linear(m: nn.Linear, x):
    return F.linear(x, _cast(m.weight, x.dtype), _cast(m.bias, x.dtype))


def prelu(m: nn.PReLU, x):
    return F.prelu(x, _cast(m.weight, x.dtype))


def batch_norm(m, x):
    """Inference BatchNorm with f32 running statistics and affine terms
    (mixed precision when ``x`` is bf16)."""
    return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias,
                        False, 0.0, m.eps)


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
