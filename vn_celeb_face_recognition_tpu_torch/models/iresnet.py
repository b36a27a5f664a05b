"""iresnet (ArcFace) 112x112 -> 512-d embedding encoder, NCHW.

Counterpart of ``vn_celeb_face_recognition_tpu/models/iresnet.py`` with
the torch reference's keys: IBasicBlock = BN-Conv-BN-PReLU-Conv(stride)-BN
plus the residual (1x1-conv downsample where needed), BN eps 2e-5, no
pooling before ``fc`` (a channel-major flatten of the 7x7 map) to
``num_features``, then the BatchNorm1d ``features``; with ``n_classes``, a
``logits`` Linear and ``log_softmax``. Dropout is inactive at inference and
omitted.

Dtype contract: parameters stay f32; the trunk computes in ``dtype``;
the flatten, ``fc``, ``features`` and ``logits`` run in f32.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import batch_norm, conv, linear, prelu

_DEPTH_LAYERS = {34: (3, 4, 6, 3), 50: (3, 4, 14, 3), 100: (3, 13, 30, 3)}
_BN_EPS = 2e-5


def _bn(c):
    return nn.BatchNorm2d(c, eps=_BN_EPS)


class Downsample(nn.Sequential):
    def __init__(self, inplanes, planes, stride):
        super().__init__(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                         _bn(planes))

    def forward(self, x):
        return batch_norm(self[1], conv(self[0], x))


class IBasicBlock(nn.Module):
    def __init__(self, inplanes, planes, stride=1, has_downsample=False):
        super().__init__()
        self.bn1 = _bn(inplanes)
        self.conv1 = nn.Conv2d(inplanes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.prelu = nn.PReLU(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn3 = _bn(planes)
        self.downsample = (Downsample(inplanes, planes, stride)
                           if has_downsample else None)

    def forward(self, x):
        out = conv(self.conv1, batch_norm(self.bn1, x))
        out = prelu(self.prelu, batch_norm(self.bn2, out))
        out = batch_norm(self.bn3, conv(self.conv2, out))
        identity = x if self.downsample is None else self.downsample(x)
        return out + identity


class Layer(nn.Sequential):
    def __init__(self, planes, blocks, stride, inplanes):
        needs_ds = stride != 1 or inplanes != planes
        super().__init__(
            IBasicBlock(inplanes, planes, stride, needs_ds),
            *[IBasicBlock(planes, planes) for _ in range(1, blocks)])


class IResNet(nn.Module):
    """[N, 3, 112, 112] standardised faces -> [N, num_features] f32, or
    with ``n_classes`` the [N, n_classes] log-probabilities."""

    def __init__(self, layers, num_features=512, n_classes=None,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.bn1 = _bn(64)
        self.prelu = nn.PReLU(64)
        self.layer1 = Layer(64, layers[0], 2, 64)
        self.layer2 = Layer(128, layers[1], 2, 64)
        self.layer3 = Layer(256, layers[2], 2, 128)
        self.layer4 = Layer(512, layers[3], 2, 256)
        self.bn2 = _bn(512)
        self.fc = nn.Linear(512 * 7 * 7, num_features)  # 7x7 at 112 px
        self.features = nn.BatchNorm1d(num_features, eps=_BN_EPS)
        self.logits = (nn.Linear(num_features, n_classes)
                       if n_classes is not None else None)

    def forward(self, x):
        x = x.to(self.dtype)
        x = prelu(self.prelu, batch_norm(self.bn1, conv(self.conv1, x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = batch_norm(self.bn2, x)
        # NCHW flatten is the channel-major order the fc weights expect
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        x = batch_norm(self.features, linear(self.fc, x))
        if self.logits is not None:
            x = F.log_softmax(linear(self.logits, x), dim=-1)
        return x


def iresnet34(**kwargs):
    return IResNet(_DEPTH_LAYERS[34], **kwargs)


def iresnet50(**kwargs):
    return IResNet(_DEPTH_LAYERS[50], **kwargs)


def iresnet100(**kwargs):
    return IResNet(_DEPTH_LAYERS[100], **kwargs)
