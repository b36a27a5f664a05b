"""InceptionResnetV1 (FaceNet) 512-d face embedding encoder, NCHW.

Counterpart of ``vn_celeb_face_recognition_tpu/models/inception_resnet_v1.py``
with the torch reference's attribute names, so the published state_dicts
load with ``load_state_dict(strict=True)``: stem convs -> 5x Block35(0.17)
-> Mixed_6a -> 10x Block17(0.10) -> Mixed_7a -> 5x Block8(0.20) ->
Block8(no ReLU) -> global average pool -> dropout -> Linear(1792->512,
no bias) -> BatchNorm1d(eps 1e-3) -> L2 normalise, or with ``classify``
the ``logits`` Linear(512 -> num_classes) on the BatchNorm's output and
log_softmax.

In train mode the BatchNorms use the batch's statistics and update their
running ones (``layers.batch_norm``, flax's semantics), and dropout
(``dropout_prob``) drops pooled features with a mask drawn from the
``generator`` given to ``forward``; in eval mode neither happens.

Dtype contract: parameters stay f32; the trunk and ``last_linear``
compute in ``dtype``; ``last_bn``, the L2 norm or the logits, and
everything after them run in f32.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    BasicConv2d,
    batch_norm,
    conv,
    dropout,
    linear,
    max_pool_ceil,
)


class Block35(nn.Module):
    def __init__(self, scale=1.0):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(256, 32, 1)
        self.branch1 = nn.Sequential(BasicConv2d(256, 32, 1),
                                     BasicConv2d(32, 32, 3, padding=1))
        self.branch2 = nn.Sequential(BasicConv2d(256, 32, 1),
                                     BasicConv2d(32, 32, 3, padding=1),
                                     BasicConv2d(32, 32, 3, padding=1))
        self.conv2d = nn.Conv2d(96, 256, 1)

    def forward(self, x):
        out = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)],
                        dim=1)
        return F.relu(conv(self.conv2d, out) * self.scale + x)


class Block17(nn.Module):
    def __init__(self, scale=1.0):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(896, 128, 1)
        self.branch1 = nn.Sequential(
            BasicConv2d(896, 128, 1),
            BasicConv2d(128, 128, (1, 7), padding=(0, 3)),
            BasicConv2d(128, 128, (7, 1), padding=(3, 0)))
        self.conv2d = nn.Conv2d(256, 896, 1)

    def forward(self, x):
        out = torch.cat([self.branch0(x), self.branch1(x)], dim=1)
        return F.relu(conv(self.conv2d, out) * self.scale + x)


class Block8(nn.Module):
    def __init__(self, scale=1.0, no_relu=False):
        super().__init__()
        self.scale = scale
        self.no_relu = no_relu
        self.branch0 = BasicConv2d(1792, 192, 1)
        self.branch1 = nn.Sequential(
            BasicConv2d(1792, 192, 1),
            BasicConv2d(192, 192, (1, 3), padding=(0, 1)),
            BasicConv2d(192, 192, (3, 1), padding=(1, 0)))
        self.conv2d = nn.Conv2d(384, 1792, 1)

    def forward(self, x):
        out = torch.cat([self.branch0(x), self.branch1(x)], dim=1)
        out = conv(self.conv2d, out) * self.scale + x
        return out if self.no_relu else F.relu(out)


class Mixed6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(256, 384, 3, stride=2)
        self.branch1 = nn.Sequential(
            BasicConv2d(256, 192, 1),
            BasicConv2d(192, 192, 3, padding=1),
            BasicConv2d(192, 256, 3, stride=2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x),
                          max_pool_ceil(x, 3, 2, ceil_mode=False)], dim=1)


class Mixed7a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = nn.Sequential(BasicConv2d(896, 256, 1),
                                     BasicConv2d(256, 384, 3, stride=2))
        self.branch1 = nn.Sequential(BasicConv2d(896, 256, 1),
                                     BasicConv2d(256, 256, 3, stride=2))
        self.branch2 = nn.Sequential(BasicConv2d(896, 256, 1),
                                     BasicConv2d(256, 256, 3, padding=1),
                                     BasicConv2d(256, 256, 3, stride=2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          max_pool_ceil(x, 3, 2, ceil_mode=False)], dim=1)


class InceptionResnetV1(nn.Module):
    """[N, 3, S, S] standardised faces -> [N, 512] unit-norm f32
    embeddings, or with ``classify`` [N, num_classes] f32
    log-probabilities."""

    def __init__(self, classify=False, num_classes=None, dropout_prob=0.6,
                 dtype=torch.float32):
        super().__init__()
        if classify and not num_classes:
            raise ValueError("a classify head needs num_classes")
        self.dtype = dtype
        self.dropout_prob = float(dropout_prob)
        self.conv2d_1a = BasicConv2d(3, 32, 3, stride=2)
        self.conv2d_2a = BasicConv2d(32, 32, 3)
        self.conv2d_2b = BasicConv2d(32, 64, 3, padding=1)
        self.conv2d_3b = BasicConv2d(64, 80, 1)
        self.conv2d_4a = BasicConv2d(80, 192, 3)
        self.conv2d_4b = BasicConv2d(192, 256, 3, stride=2)
        self.repeat_1 = nn.Sequential(*[Block35(0.17) for _ in range(5)])
        self.mixed_6a = Mixed6a()
        self.repeat_2 = nn.Sequential(*[Block17(0.10) for _ in range(10)])
        self.mixed_7a = Mixed7a()
        self.repeat_3 = nn.Sequential(*[Block8(0.20) for _ in range(5)])
        self.block8 = Block8(no_relu=True)
        self.last_linear = nn.Linear(1792, 512, bias=False)
        self.last_bn = nn.BatchNorm1d(512, eps=0.001, momentum=0.1)
        self.logits = nn.Linear(512, num_classes) if classify else None

    def forward(self, x, generator=None):
        x = x.to(self.dtype)
        x = self.conv2d_1a(x)
        x = self.conv2d_2a(x)
        x = self.conv2d_2b(x)
        x = max_pool_ceil(x, 3, 2, ceil_mode=False)
        x = self.conv2d_3b(x)
        x = self.conv2d_4a(x)
        x = self.conv2d_4b(x)
        x = self.repeat_1(x)
        x = self.mixed_6a(x)
        x = self.repeat_2(x)
        x = self.mixed_7a(x)
        x = self.repeat_3(x)
        x = self.block8(x)
        x = x.mean(dim=(2, 3))
        if self.training:
            x = dropout(x, self.dropout_prob, generator)
        x = linear(self.last_linear, x).to(torch.float32)
        x = batch_norm(self.last_bn, x)
        if self.logits is not None:
            return F.log_softmax(linear(self.logits, x), dim=-1)
        return F.normalize(x, dim=-1, eps=1e-12)
