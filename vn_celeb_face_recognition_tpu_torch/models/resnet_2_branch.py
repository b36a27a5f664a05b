"""2-branch emotion ResNet-50: class head (emotion tags) + projection.

Counterpart of ``vn_celeb_face_recognition_tpu/models/resnet_2_branch.py``
with torch's keys: a ResNet-50 trunk, a global mean over the last map,
then two f32 linear heads, ``fc`` (``num_classes`` tags) and ``proj``
(``num_projections`` wide, 300 in the published net).

``forward(faces)`` takes [K, 112, 112, 3] aligned faces in 0-255 and
returns (x_cls, x_proj): the JAX net's ``apply`` on
``imagenet_normalize(area_resize(faces, 224) / 255)``. The resize,
normalisation and stem run as kernel K7 (``ops.emotion_stem``); layer1's
blocks 1-2 and layer2's blocks 1-3 run as kernel K8 (``ops.bottleneck``);
block 0 of each layer, layer3/4 and the heads are cuDNN/cuBLAS.

``forward_normalized(x)`` is the JAX net's ``apply`` itself: it takes
NHWC input already through that transform (faces of any size, resized by
the caller: the engine's ``emotion_size``) and runs the stem as the net's
own conv, BatchNorm, ReLU and max pool in cuDNN; the trunk after the stem
is ``forward``'s, K8 included (it takes any map size).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bottleneck import bottleneck_chain
from ..ops.emotion_stem import emotion_stem
from .layers import batch_norm, conv, linear
from .resnet_common import ResLayer


class ResNet2Branch(nn.Module):
    def __init__(self, layers=(3, 4, 6, 3), num_classes=1000,
                 num_projections=300, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = tuple(layers)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = ResLayer(64, layers[0], 1, 64)
        self.layer2 = ResLayer(128, layers[1], 2, 256)
        self.layer3 = ResLayer(256, layers[2], 2, 512)
        self.layer4 = ResLayer(512, layers[3], 2, 1024)
        self.fc = nn.Linear(2048, num_classes)
        self.proj = nn.Linear(2048, num_projections)

    def forward(self, faces, dtype=None):
        """``dtype`` (default: the net's own) is the compute dtype of the
        stem's output and so of the trunk after it."""
        return self._trunk(emotion_stem(self.conv1, self.bn1, faces,
                                        dtype or self.dtype))

    def forward_normalized(self, x, dtype=None):
        """``dtype`` (default: the net's own) is the compute dtype of the
        stem and the trunk after it."""
        x = x.to(dtype or self.dtype).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(batch_norm(self.bn1, conv(self.conv1, x))),
                         3, 2, 1)
        return self._trunk(x.permute(0, 2, 3, 1))

    def _trunk(self, x):
        """The stem's NHWC output -> (x_cls, x_proj)."""
        x = x.permute(0, 3, 1, 2)
        for layer in (self.layer1, self.layer2):
            x = layer[0](x)
            x = bottleneck_chain(list(layer)[1:], x.permute(0, 2, 3, 1))
            x = x.permute(0, 3, 1, 2)
        x = self.layer4(self.layer3(x))
        x = x.to(torch.float32).mean(dim=(2, 3))
        return linear(self.fc, x), linear(self.proj, x)


def resnet_2branch_50(**kwargs):
    return ResNet2Branch(layers=(3, 4, 6, 3), **kwargs)
