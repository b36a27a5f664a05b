"""SE-IR ResNet encoder (``resnet101``) and the ArcMargin head, NCHW.

Counterpart of ``vn_celeb_face_recognition_tpu/models/resnet_encoder.py``
with the torch state_dict keys its flax names imply (``layerN.i.bn0``,
``se.fc.0``, ``downsample.0/1``, ``prelu.weight``, ``fc``, ``bn3``): the stem
is a VALID 3x3 conv, BatchNorm, a scalar PReLU and a 2x2/2 max pool; then
four ``IRLayer``s at strides 1, 2, 2 and 2 of BN-Conv-BN-PReLU-Conv-BN-SE
blocks whose one PReLU runs twice; the head is ``bn2``, dropout 0.5 in
train mode, a channel-major flatten, ``fc`` to 512, the BatchNorm1d
``bn3`` and an L2 normalisation with the norm clipped at 1e-12. BatchNorm
has flax's momentum 0.9 (torch's 0.1) and eps 1e-5, and flax's train-mode
semantics (``layers.batch_norm``). f32 only, as the JAX module.

``fc``'s input width follows the input size, as flax infers it at init:
112 px faces give 7x7x512 = 25,088 inputs, 160 px ones 10x10x512 = 51,200.
``fc`` is therefore a ``nn.LazyLinear``: it takes its width from a loaded
state_dict, or at the first forward from the flattened trunk, and is
then seeded from ``torch.Generator`` seed ``FC_SEED``. ``img_size`` is kept
where the JAX constructors take it, and is unused there too.

Seeded weights have flax's lecun-normal variance (1 / fan_in), as the JAX
package initialises the module: with He-normal (2 / fan_in) the 33 blocks
are chaotic, and a relative change of 1e-6 in the input turns the
embedding by a cosine of 0.993.
"""

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from .layers import batch_norm, conv, dropout, read_state_dict, seeded_init_

DROPOUT = 0.5
FC_SEED = 0
INIT_SCALE = 1.0  # seeded_init_'s variance scale: lecun-normal


class ScalarPReLU(nn.PReLU):
    """``nn.PReLU()``: one slope shared by every channel (weight [1])."""

    def __init__(self):
        super().__init__(num_parameters=1, init=0.25)


class SEFc(nn.Sequential):
    """The excitation MLP, keys ``0`` (Linear), ``1`` (PReLU), ``2``
    (Linear); ``3`` is the sigmoid."""

    def __init__(self, channel, reduction=16):
        super().__init__(nn.Linear(channel, channel // reduction),
                         ScalarPReLU(),
                         nn.Linear(channel // reduction, channel),
                         nn.Sigmoid())


class SE(nn.Module):
    def __init__(self, channel, reduction=16):
        super().__init__()
        self.fc = SEFc(channel, reduction)

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class IRDownsample(nn.Sequential):
    """1x1 strided conv + BatchNorm on the residual path."""

    def __init__(self, inplanes, planes, stride):
        super().__init__(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                         nn.BatchNorm2d(planes))

    def forward(self, x):
        return batch_norm(self[1], conv(self[0], x))


class IRBlock(nn.Module):
    def __init__(self, inplanes, planes, stride=1, has_downsample=False,
                 use_se=True):
        super().__init__()
        self.bn0 = nn.BatchNorm2d(inplanes)
        self.conv1 = nn.Conv2d(inplanes, inplanes, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(inplanes)
        # the reference applies the same PReLU after bn1 and after the sum
        self.prelu = ScalarPReLU()
        self.conv2 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.se = SE(planes) if use_se else None
        self.downsample = (IRDownsample(inplanes, planes, stride)
                           if has_downsample else None)

    def forward(self, x):
        out = conv(self.conv1, batch_norm(self.bn0, x))
        out = self.prelu(batch_norm(self.bn1, out))
        out = batch_norm(self.bn2, conv(self.conv2, out))
        if self.se is not None:
            out = self.se(out)
        residual = x if self.downsample is None else self.downsample(x)
        return self.prelu(out + residual)


class IRLayer(nn.Sequential):
    """``blocks`` IRBlocks; block 0 strides and, where the width or stride
    changes, downsamples the residual."""

    def __init__(self, planes, blocks, stride, inplanes, use_se):
        needs_ds = stride != 1 or inplanes != planes
        super().__init__(
            IRBlock(inplanes, planes, stride, needs_ds, use_se),
            *[IRBlock(planes, planes, 1, False, use_se)
              for _ in range(1, blocks)])


class ResNetSE(nn.Module):
    """[N, 3, H, W] f32 faces -> [N, 512] unit-norm embeddings."""

    def __init__(self, layers=(3, 4, 23, 3), use_se=True, im_size=112):
        super().__init__()
        self.im_size = im_size  # unused, as in the JAX module
        self.conv1 = nn.Conv2d(3, 64, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.prelu = ScalarPReLU()
        self.layer1 = IRLayer(64, layers[0], 1, 64, use_se)
        self.layer2 = IRLayer(128, layers[1], 2, 64, use_se)
        self.layer3 = IRLayer(256, layers[2], 2, 128, use_se)
        self.layer4 = IRLayer(512, layers[3], 2, 256, use_se)
        self.bn2 = nn.BatchNorm2d(512)
        self.fc = nn.LazyLinear(512)  # the width of the input (docstring)
        self.bn3 = nn.BatchNorm1d(512)

    def requires_grad_(self, requires_grad=True):
        """``nn.Module.requires_grad_``, which the lazy ``fc`` refuses
        before it has its width; the flag set here outlives that."""
        for p in self.parameters():
            p.requires_grad = requires_grad
        return self

    def trunk(self, x):
        """The stem, the four layers and ``bn2``: [N, 512, h, w]."""
        x = self.prelu(batch_norm(self.bn1, conv(self.conv1, x)))
        x = F.max_pool2d(x, 2, 2)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return batch_norm(self.bn2, x)

    def head(self, x):
        """[N, 512, h, w] (after dropout) -> the normalised embeddings;
        ``fc`` takes its width here on the first call without weights."""
        x = x.reshape(x.shape[0], -1)  # NCHW flatten: channel-major
        if isinstance(self.fc.weight, nn.UninitializedParameter):
            self.fc.initialize_parameters(x)
            seeded_init_(self.fc, torch.Generator().manual_seed(FC_SEED),
                         INIT_SCALE)
        x = batch_norm(self.bn3, self.fc(x))
        return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    def forward(self, x, generator=None):
        """In train mode dropout draws its mask from ``generator``."""
        x = self.trunk(x)
        if self.training:
            x = dropout(x, DROPOUT, generator)
        return self.head(x)


def resnet101(use_se=True, pretrained=False, img_size=112, cp_path=None):
    return ResNetSE(layers=(3, 4, 23, 3), use_se=use_se, im_size=img_size)


def build_resnet_se(use_se=True, pretrained=False, img_size=112,
                    cp_path=None, weights_path=None):
    """The registry's ``resnet101``: weights from the first of
    ``weights_path`` and ``cp_path`` that exists (a torch-keyed ``.npz`` by
    key, or a torch checkpoint read with ``weights_only=True``), loaded
    strictly; else seeded (lecun-normal, ``torch.Generator`` seed 0;
    ``fc`` when it takes its width). Nothing is downloaded."""
    module = seeded_init_(resnet101(use_se=use_se, img_size=img_size),
                          torch.Generator().manual_seed(0), INIT_SCALE)
    for path in (weights_path, cp_path):
        if path and os.path.exists(path):
            module.load_state_dict(read_state_dict(path), strict=True)
            break
    return module


class ArcMarginModel(nn.Module):
    """Additive angular margin head: ``margin_s * cos(theta + margin_m)``
    on the target class, ``margin_s * cos(theta)`` elsewhere; a function
    of (embeddings [N, emb_size], labels [N]) -> [N, num_classes]. The
    weight [num_classes, emb_size] is xavier-uniform from a
    ``torch.Generator`` (seed 0 unless ``reset_parameters`` is given
    one)."""

    def __init__(self, num_classes, emb_size=512, margin_m=0.5,
                 margin_s=64.0, easy_margin=False):
        super().__init__()
        self.num_classes = num_classes
        self.margin_m = margin_m
        self.margin_s = margin_s
        self.easy_margin = easy_margin
        self.weight = nn.Parameter(torch.empty(num_classes, emb_size))
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator):
        bound = math.sqrt(6.0 / sum(self.weight.shape))
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, x, label):
        x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        w = self.weight / self.weight.norm(dim=-1,
                                           keepdim=True).clamp_min(1e-12)
        cosine = x @ w.T
        sine = torch.sqrt(torch.clamp(1.0 - cosine ** 2, 0.0, 1.0))
        m = self.margin_m
        phi = cosine * math.cos(m) - sine * math.sin(m)
        if self.easy_margin:
            phi = torch.where(cosine > 0, phi, cosine)
        else:
            th, mm = math.cos(math.pi - m), math.sin(math.pi - m) * m
            phi = torch.where(cosine > th, phi, cosine - mm)
        # a label outside [0, num_classes) has no target, as jax's one_hot
        one_hot = (label[:, None] == torch.arange(
            self.num_classes, device=label.device)).to(cosine.dtype)
        return (one_hot * phi + (1.0 - one_hot) * cosine) * self.margin_s
