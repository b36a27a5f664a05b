"""torchvision-style ResNet Bottleneck blocks, NCHW.

Counterpart of ``vn_celeb_face_recognition_tpu/models/resnet_common.py``
with torch's keys (``conv1..3``, ``bn1..3``, ``downsample.0/1``). Modules
hold f32 parameters and compute in the dtype of their input.
"""

import torch.nn.functional as F
from torch import nn

from .layers import batch_norm, conv


class BottleneckDownsample(nn.Sequential):
    """1x1 strided conv + BatchNorm on the residual path."""

    def __init__(self, inplanes, features, stride):
        super().__init__(
            nn.Conv2d(inplanes, features, 1, stride, bias=False),
            nn.BatchNorm2d(features))

    def forward(self, x):
        return batch_norm(self[1], conv(self[0], x))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, has_downsample=False):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (BottleneckDownsample(inplanes, planes * 4, stride)
                           if has_downsample else None)

    def forward(self, x):
        out = F.relu(batch_norm(self.bn1, conv(self.conv1, x)))
        out = F.relu(batch_norm(self.bn2, conv(self.conv2, out)))
        out = batch_norm(self.bn3, conv(self.conv3, out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResLayer(nn.Sequential):
    """``blocks`` Bottlenecks; block 0 strides and, where the width or
    stride changes, downsamples the residual."""

    def __init__(self, planes, blocks, stride, inplanes):
        needs_ds = stride != 1 or inplanes != planes * 4
        super().__init__(
            Bottleneck(inplanes, planes, stride, needs_ds),
            *[Bottleneck(planes * 4, planes) for _ in range(1, blocks)])
