"""Plain PyTorch forward passes of the benchmark's networks, in NCHW with
stock ``torch.nn`` layers and the published state_dict keys.

Each follows the published architecture (the torch reference code the
repo mirrors): RetinaFace on MobileNetV1-0.25 (insightface / biubug6
Pytorch_Retinaface ``cfg_mnet``), the ArcFace iresnet100, FaceNet's
InceptionResnetV1 and MTCNN's P/R/O-Nets (facenet-pytorch), the embedding
MLP, and the 2-branch ResNet-50 emotion net (torchvision Bottlenecks with
a tag head and a projection head). Nothing here imports the program under
test; the benchmark runs these in float32 with TF32 off.
"""

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# RetinaFace, MobileNetV1-0.25 (cfg_mnet)
# ---------------------------------------------------------------------------

MNET_STAGES = (
    (("conv_bn", 3, 8, 2), ("conv_dw", 8, 16, 1), ("conv_dw", 16, 32, 2),
     ("conv_dw", 32, 32, 1), ("conv_dw", 32, 64, 2), ("conv_dw", 64, 64, 1)),
    (("conv_dw", 64, 128, 2),) + (("conv_dw", 128, 128, 1),) * 5,
    (("conv_dw", 128, 256, 2), ("conv_dw", 256, 256, 1)),
)
RETINA_MEANS = (104.0, 117.0, 123.0)


class ConvBN(nn.Sequential):
    def __init__(self, cin, cout, stride=1, leaky=0.0, kernel=3, padding=1,
                 act=True):
        super().__init__(nn.Conv2d(cin, cout, kernel, stride, padding,
                                   bias=False), nn.BatchNorm2d(cout))
        self.leaky, self.act = leaky, act

    def forward(self, x):
        x = self[1](self[0](x))
        if not self.act:
            return x
        return F.leaky_relu(x, self.leaky) if self.leaky else F.relu(x)


class ConvDW(nn.Sequential):
    def __init__(self, cin, cout, stride):
        super().__init__(
            nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False),
            nn.BatchNorm2d(cin), nn.LeakyReLU(0.1),
            nn.Conv2d(cin, cout, 1, bias=False), nn.BatchNorm2d(cout),
            nn.LeakyReLU(0.1))


def mnet_stage(specs):
    return nn.Sequential(*[ConvBN(ci, co, s, leaky=0.1) if kind == "conv_bn"
                           else ConvDW(ci, co, s)
                           for kind, ci, co, s in specs])


class MnetBody(nn.Module):
    def __init__(self):
        super().__init__()
        self.stage1, self.stage2, self.stage3 = (mnet_stage(s)
                                                 for s in MNET_STAGES)

    def forward(self, x):
        s1 = self.stage1(x)
        s2 = self.stage2(s1)
        return s1, s2, self.stage3(s2)


class FPN(nn.Module):
    def __init__(self, cins, cout):
        super().__init__()
        leaky = 0.1 if cout <= 64 else 0.0
        self.output1 = ConvBN(cins[0], cout, 1, leaky, 1, 0)
        self.output2 = ConvBN(cins[1], cout, 1, leaky, 1, 0)
        self.output3 = ConvBN(cins[2], cout, 1, leaky, 1, 0)
        self.merge1 = ConvBN(cout, cout, 1, leaky)
        self.merge2 = ConvBN(cout, cout, 1, leaky)

    def forward(self, feats):
        o1, o2, o3 = (m(f) for m, f in zip(
            (self.output1, self.output2, self.output3), feats))
        o2 = self.merge2(o2 + F.interpolate(o3, size=o2.shape[2:],
                                            mode="nearest-exact"))
        o1 = self.merge1(o1 + F.interpolate(o2, size=o1.shape[2:],
                                            mode="nearest-exact"))
        return o1, o2, o3


class SSH(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        leaky = 0.1 if cout <= 64 else 0.0
        self.conv3X3 = ConvBN(cin, cout // 2, act=False)
        self.conv5X5_1 = ConvBN(cin, cout // 4, leaky=leaky)
        self.conv5X5_2 = ConvBN(cout // 4, cout // 4, act=False)
        self.conv7X7_2 = ConvBN(cout // 4, cout // 4, leaky=leaky)
        self.conv7x7_3 = ConvBN(cout // 4, cout // 4, act=False)

    def forward(self, x):
        c5_1 = self.conv5X5_1(x)
        return F.relu(torch.cat([
            self.conv3X3(x), self.conv5X5_2(c5_1),
            self.conv7x7_3(self.conv7X7_2(c5_1))], dim=1))


class Head(nn.Module):
    def __init__(self, cin, dims, anchors=2):
        super().__init__()
        self.dims = dims
        self.conv1x1 = nn.Conv2d(cin, anchors * dims, 1)

    def forward(self, x):
        out = self.conv1x1(x).permute(0, 2, 3, 1)
        return out.reshape(out.shape[0], -1, self.dims)


class HeadList(nn.ModuleList):
    def __init__(self, cin, dims):
        super().__init__([Head(cin, dims) for _ in range(3)])

    def forward(self, feats):
        return torch.cat([h(f) for h, f in zip(self, feats)], dim=1)


class RetinaFaceMnet(nn.Module):
    """uint8 frames [N, H, W, 3] -> (loc [N, A, 4], conf [N, A, 2]
    softmax, landmarks [N, A, 10])."""

    def __init__(self):
        super().__init__()
        self.body = MnetBody()
        self.fpn = FPN((64, 128, 256), 64)
        self.ssh1, self.ssh2, self.ssh3 = SSH(64, 64), SSH(64, 64), SSH(64, 64)
        self.BboxHead = HeadList(64, 4)
        self.ClassHead = HeadList(64, 2)
        self.LandmarkHead = HeadList(64, 10)

    def forward(self, frames):
        mean = torch.tensor(RETINA_MEANS, device=frames.device)
        x = (frames.float() - mean).permute(0, 3, 1, 2)
        f = self.fpn(self.body(x))
        f = (self.ssh1(f[0]), self.ssh2(f[1]), self.ssh3(f[2]))
        return (self.BboxHead(f), torch.softmax(self.ClassHead(f), dim=-1),
                self.LandmarkHead(f))


# ---------------------------------------------------------------------------
# iresnet100 (ArcFace)
# ---------------------------------------------------------------------------

IRESNET_LAYERS = {34: (3, 4, 6, 3), 50: (3, 4, 14, 3), 100: (3, 13, 30, 3)}


def _ibn(c):
    return nn.BatchNorm2d(c, eps=2e-5)


class IBasicBlock(nn.Module):
    def __init__(self, cin, planes, stride, downsample):
        super().__init__()
        self.bn1 = _ibn(cin)
        self.conv1 = nn.Conv2d(cin, planes, 3, 1, 1, bias=False)
        self.bn2 = _ibn(planes)
        self.prelu = nn.PReLU(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn3 = _ibn(planes)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, planes, 1, stride, bias=False), _ibn(planes))
            if downsample else None)

    def forward(self, x):
        out = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(
            self.bn1(x))))))
        return out + (x if self.downsample is None else self.downsample(x))


class IResNet(nn.Module):
    """Standardised faces [N, 3, 112, 112] -> [N, num_features]."""

    def __init__(self, depth=100, num_features=512):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.bn1 = _ibn(64)
        self.prelu = nn.PReLU(64)
        cin = 64
        for i, (planes, blocks) in enumerate(zip(
                (64, 128, 256, 512), IRESNET_LAYERS[depth])):
            layer = [IBasicBlock(cin, planes, 2, True)]
            layer += [IBasicBlock(planes, planes, 1, False)
                      for _ in range(1, blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
            cin = planes
        self.bn2 = _ibn(512)
        self.fc = nn.Linear(512 * 7 * 7, num_features)
        self.features = nn.BatchNorm1d(num_features, eps=2e-5)

    def forward(self, x):
        x = self.prelu(self.bn1(self.conv1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.bn2(x).flatten(1)
        return self.features(self.fc(x))


# ---------------------------------------------------------------------------
# InceptionResnetV1 (FaceNet)
# ---------------------------------------------------------------------------


class BasicConv2d(nn.Module):
    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Block35(nn.Module):
    def __init__(self, scale):
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
                        1)
        return F.relu(self.conv2d(out) * self.scale + x)


class Block17(nn.Module):
    def __init__(self, scale):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(896, 128, 1)
        self.branch1 = nn.Sequential(
            BasicConv2d(896, 128, 1),
            BasicConv2d(128, 128, (1, 7), padding=(0, 3)),
            BasicConv2d(128, 128, (7, 1), padding=(3, 0)))
        self.conv2d = nn.Conv2d(256, 896, 1)

    def forward(self, x):
        out = torch.cat([self.branch0(x), self.branch1(x)], 1)
        return F.relu(self.conv2d(out) * self.scale + x)


class Block8(nn.Module):
    def __init__(self, scale=1.0, relu=True):
        super().__init__()
        self.scale, self.relu = scale, relu
        self.branch0 = BasicConv2d(1792, 192, 1)
        self.branch1 = nn.Sequential(
            BasicConv2d(1792, 192, 1),
            BasicConv2d(192, 192, (1, 3), padding=(0, 1)),
            BasicConv2d(192, 192, (3, 1), padding=(1, 0)))
        self.conv2d = nn.Conv2d(384, 1792, 1)

    def forward(self, x):
        out = torch.cat([self.branch0(x), self.branch1(x)], 1)
        out = self.conv2d(out) * self.scale + x
        return F.relu(out) if self.relu else out


class Mixed6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(256, 384, 3, stride=2)
        self.branch1 = nn.Sequential(BasicConv2d(256, 192, 1),
                                     BasicConv2d(192, 192, 3, padding=1),
                                     BasicConv2d(192, 256, 3, stride=2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x),
                          F.max_pool2d(x, 3, 2)], 1)


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
                          F.max_pool2d(x, 3, 2)], 1)


class InceptionResnetV1(nn.Module):
    """Standardised faces [N, 3, S, S] -> [N, 512] unit-norm embeddings."""

    def __init__(self):
        super().__init__()
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
        self.block8 = Block8(relu=False)
        self.last_linear = nn.Linear(1792, 512, bias=False)
        self.last_bn = nn.BatchNorm1d(512, eps=1e-3)

    def forward(self, x):
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.conv2d_4b(self.conv2d_4a(self.conv2d_3b(x)))
        x = self.mixed_7a(self.repeat_2(self.mixed_6a(self.repeat_1(x))))
        x = self.block8(self.repeat_3(x)).mean(dim=(2, 3))
        return F.normalize(self.last_bn(self.last_linear(x)), dim=-1)


# ---------------------------------------------------------------------------
# The embedding classifier
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """Embeddings -> log-probabilities (the dropout is off at inference)."""

    def __init__(self, input_dim, num_classes):
        super().__init__()
        self.dense_1 = nn.Linear(input_dim, 2048)
        self.dense_2 = nn.Linear(2048, num_classes)

    def forward(self, x):
        return F.log_softmax(self.dense_2(F.relu(self.dense_1(x))), dim=-1)


# ---------------------------------------------------------------------------
# 2-branch ResNet-50 (emotion tags)
# ---------------------------------------------------------------------------


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, downsample):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None
                             else self.downsample(x)))


class ResNet2Branch(nn.Module):
    """ImageNet-normalised faces [N, 3, S, S] -> (tag logits, projection)."""

    def __init__(self, num_classes, num_projections, layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for i, (planes, blocks, stride) in enumerate(zip(
                (64, 128, 256, 512), layers, (1, 2, 2, 2))):
            layer = [Bottleneck(cin, planes, stride, True)]
            layer += [Bottleneck(planes * 4, planes, 1, False)
                      for _ in range(1, blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
            cin = planes * 4
        self.fc = nn.Linear(2048, num_classes)
        self.proj = nn.Linear(2048, num_projections)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = x.mean(dim=(2, 3))
        return self.fc(x), self.proj(x)


# ---------------------------------------------------------------------------
# MTCNN's P/R/O-Nets
# ---------------------------------------------------------------------------


def _flatten_whc(x):
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 10, 3), nn.PReLU(10)
        self.conv2, self.prelu2 = nn.Conv2d(10, 16, 3), nn.PReLU(16)
        self.conv3, self.prelu3 = nn.Conv2d(16, 32, 3), nn.PReLU(32)
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        x = F.max_pool2d(self.prelu1(self.conv1(x)), 2, 2, ceil_mode=True)
        x = self.prelu3(self.conv3(self.prelu2(self.conv2(x))))
        return self.conv4_2(x), torch.softmax(self.conv4_1(x), dim=1)


class RNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 28, 3), nn.PReLU(28)
        self.conv2, self.prelu2 = nn.Conv2d(28, 48, 3), nn.PReLU(48)
        self.conv3, self.prelu3 = nn.Conv2d(48, 64, 2), nn.PReLU(64)
        self.dense4, self.prelu4 = nn.Linear(576, 128), nn.PReLU(128)
        self.dense5_1 = nn.Linear(128, 2)
        self.dense5_2 = nn.Linear(128, 4)

    def forward(self, x):
        x = F.max_pool2d(self.prelu1(self.conv1(x)), 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.prelu2(self.conv2(x)), 3, 2, ceil_mode=True)
        x = self.prelu3(self.conv3(x))
        x = self.prelu4(self.dense4(_flatten_whc(x)))
        return self.dense5_2(x), torch.softmax(self.dense5_1(x), dim=1)


class ONet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 32, 3), nn.PReLU(32)
        self.conv2, self.prelu2 = nn.Conv2d(32, 64, 3), nn.PReLU(64)
        self.conv3, self.prelu3 = nn.Conv2d(64, 64, 3), nn.PReLU(64)
        self.conv4, self.prelu4 = nn.Conv2d(64, 128, 2), nn.PReLU(128)
        self.dense5, self.prelu5 = nn.Linear(1152, 256), nn.PReLU(256)
        self.dense6_1 = nn.Linear(256, 2)
        self.dense6_2 = nn.Linear(256, 4)
        self.dense6_3 = nn.Linear(256, 10)

    def forward(self, x):
        x = F.max_pool2d(self.prelu1(self.conv1(x)), 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.prelu2(self.conv2(x)), 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.prelu3(self.conv3(x)), 2, 2, ceil_mode=True)
        x = self.prelu5(self.dense5(_flatten_whc(self.prelu4(
            self.conv4(x)))))
        return (self.dense6_2(x), self.dense6_3(x),
                torch.softmax(self.dense6_1(x), dim=1))
