"""RetinaFace single-shot face detector (MobileNetV1-0.25 trunk), NCHW.

Counterpart of ``vn_celeb_face_recognition_tpu/models/retinaface.py``:
the same MobileNetV1-0.25 body, FPN, SSH and heads with the torch
reference's state_dict keys, so the vendored torch-keyed
``retinaface_mnet025.npz`` loads straight into ``load_state_dict``. The
detector keeps the JAX package's fixed-capacity inference: priors once
per frame size, conf > ``conf_thres``, per-frame top ``nms_cap``, decode
after the top-k, exact NMS (+1 area convention), ``vis_thres``, then the
top ``out_cap`` faces per frame.

The net takes the uint8 frames: stage 1 of the body runs through kernel
K6 (``ops.planar_s1``), which subtracts the channel means itself; stages
2-3, FPN, SSH and heads are cuDNN convolutions. Only ``cfg_mnet`` is
ported; the ResNet-50 body is later work.
"""

import os

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as B
from ..ops.nms import check_set_caps
from ..ops.planar_s1 import STAGE1_SPECS, mnet_stage1
from ..utils.device import select_device
from .layers import batch_norm, conv, load_npz

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WEIGHTS_NPZ = os.path.join(_REPO_ROOT, "vn_celeb_face_recognition_tpu",
                           "models", "weights", "retinaface_mnet025.npz")

# per-channel means the net subtracts from the frames (BGR order of the
# reference's cv2 input)
CHANNELS_SUBTRACT = (104.0, 117.0, 123.0)

cfg_mnet = {
    "name": "mobilenet0.25",
    "min_sizes": [[16, 32], [64, 128], [256, 512]],
    "steps": [8, 16, 32],
    "variance": [0.1, 0.2],
    "clip": False,
    "in_channel": 32,
    "out_channel": 64,
}


def _leaky(x, slope):
    return F.leaky_relu(x, slope) if slope else F.relu(x)


class ConvBN(nn.Sequential):
    """Conv(bias=False) + BatchNorm (+ LeakyReLU): keys ``0``, ``1``."""

    def __init__(self, cin, cout, stride=1, leaky=0.0, kernel=3, padding=1,
                 relu=True):
        super().__init__(
            nn.Conv2d(cin, cout, kernel, stride, padding, bias=False),
            nn.BatchNorm2d(cout))
        self.leaky = leaky
        self.relu = relu

    def forward(self, x):
        x = batch_norm(self[1], conv(self[0], x))
        return _leaky(x, self.leaky) if self.relu else x


class ConvDW(nn.Sequential):
    """Depthwise 3x3 + BN + LeakyReLU, pointwise 1x1 + BN + LeakyReLU:
    keys ``0``, ``1``, ``3``, ``4`` (``2`` and ``5`` hold no weights)."""

    def __init__(self, cin, cout, stride, leaky=0.1):
        super().__init__(
            nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False),
            nn.BatchNorm2d(cin), nn.LeakyReLU(leaky),
            nn.Conv2d(cin, cout, 1, bias=False),
            nn.BatchNorm2d(cout), nn.LeakyReLU(leaky))
        self.leaky = leaky

    def forward(self, x):
        x = _leaky(batch_norm(self[1], conv(self[0], x)), self.leaky)
        return _leaky(batch_norm(self[4], conv(self[3], x)), self.leaky)


def mobilenet_stage(specs):
    return nn.Sequential(*[
        ConvBN(cin, cout, stride, leaky=0.1) if kind == "conv_bn"
        else ConvDW(cin, cout, stride) for kind, cin, cout, stride in specs])


_S2_SPECS = (("conv_dw", 64, 128, 2),) + (("conv_dw", 128, 128, 1),) * 5
_S3_SPECS = (("conv_dw", 128, 256, 2), ("conv_dw", 256, 256, 1))


class MobileNetV1Body(nn.Module):
    """The three stages the FPN taps (keys ``stage1..3``)."""

    def __init__(self):
        super().__init__()
        self.stage1 = mobilenet_stage(STAGE1_SPECS)
        self.stage2 = mobilenet_stage(_S2_SPECS)
        self.stage3 = mobilenet_stage(_S3_SPECS)

    def forward(self, frames, dtype):
        """frames [N, H, W, 3] uint8 -> the three NCHW stage outputs in
        ``dtype``; stage 1 is kernel K6."""
        s1 = mnet_stage1(self.stage1, frames, CHANNELS_SUBTRACT, dtype)
        s1 = s1.permute(0, 3, 1, 2)
        s2 = self.stage2(s1)
        return s1, s2, self.stage3(s2)


class FPN(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        leaky = 0.1 if out_channels <= 64 else 0.0
        self.output1 = ConvBN(in_channels[0], out_channels, 1, leaky, 1, 0)
        self.output2 = ConvBN(in_channels[1], out_channels, 1, leaky, 1, 0)
        self.output3 = ConvBN(in_channels[2], out_channels, 1, leaky, 1, 0)
        self.merge1 = ConvBN(out_channels, out_channels, 1, leaky)
        self.merge2 = ConvBN(out_channels, out_channels, 1, leaky)

    def forward(self, inputs):
        o1 = self.output1(inputs[0])
        o2 = self.output2(inputs[1])
        o3 = self.output3(inputs[2])
        # half-pixel nearest, as jax.image.resize(method="nearest")
        up3 = F.interpolate(o3, size=o2.shape[2:], mode="nearest-exact")
        o2 = self.merge2(o2 + up3)
        up2 = F.interpolate(o2, size=o1.shape[2:], mode="nearest-exact")
        o1 = self.merge1(o1 + up2)
        return [o1, o2, o3]


class SSH(nn.Module):
    def __init__(self, in_channel, out_channel):
        super().__init__()
        leaky = 0.1 if out_channel <= 64 else 0.0
        half, quarter = out_channel // 2, out_channel // 4
        self.conv3X3 = ConvBN(in_channel, half, relu=False)
        self.conv5X5_1 = ConvBN(in_channel, quarter, leaky=leaky)
        self.conv5X5_2 = ConvBN(quarter, quarter, relu=False)
        self.conv7X7_2 = ConvBN(quarter, quarter, leaky=leaky)
        self.conv7x7_3 = ConvBN(quarter, quarter, relu=False)

    def forward(self, x):
        c3 = self.conv3X3(x)
        c5_1 = self.conv5X5_1(x)
        c5 = self.conv5X5_2(c5_1)
        c7 = self.conv7x7_3(self.conv7X7_2(c5_1))
        return F.relu(torch.cat([c3, c5, c7], dim=1))


class Head(nn.Module):
    """1x1 conv head -> [N, H*W*anchors, dims] f32."""

    def __init__(self, in_channels, dims, num_anchors=2):
        super().__init__()
        self.dims = dims
        self.conv1x1 = nn.Conv2d(in_channels, num_anchors * dims, 1)

    def forward(self, x):
        out = conv(self.conv1x1, x).permute(0, 2, 3, 1)
        return out.reshape(out.shape[0], -1, self.dims).to(torch.float32)


class HeadList(nn.ModuleList):
    def __init__(self, in_channels, dims, n=3):
        super().__init__([Head(in_channels, dims) for _ in range(n)])

    def forward(self, features):
        return torch.cat([h(f) for h, f in zip(self, features)], dim=1)


class RetinaFaceNet(nn.Module):
    """mobilenet0.25 RetinaFace: [N, H, W, 3] uint8 frames -> (loc [N, A,
    4], softmax conf [N, A, 2], landmarks [N, A, 10]), all f32; the
    convolutions run in ``dtype``."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        c_in, c_out = cfg_mnet["in_channel"], cfg_mnet["out_channel"]
        self.body = MobileNetV1Body()
        self.fpn = FPN([c_in * 2, c_in * 4, c_in * 8], c_out)
        self.ssh1 = SSH(c_out, c_out)
        self.ssh2 = SSH(c_out, c_out)
        self.ssh3 = SSH(c_out, c_out)
        self.BboxHead = HeadList(c_out, 4)
        self.ClassHead = HeadList(c_out, 2)
        self.LandmarkHead = HeadList(c_out, 10)

    def forward(self, frames):
        fpn = self.fpn(list(self.body(frames, self.dtype)))
        features = [self.ssh1(fpn[0]), self.ssh2(fpn[1]), self.ssh3(fpn[2])]
        loc = self.BboxHead(features)
        conf = torch.softmax(self.ClassHead(features), dim=-1)
        return loc, conf, self.LandmarkHead(features)


class RetinaFace:
    """Batched RetinaFace detector: every face of a frame above
    ``vis_thres``, up to ``out_cap``.

    Constructor arguments mirror the JAX package's ``RetinaFace``;
    ``dtype`` is the compute dtype of the net (heads and decode stay
    f32) and ``device`` where it runs (the card unless ``"cpu"`` is
    asked for; a missing card raises). Without ``weights_path`` the net
    keeps PyTorch's default initialisation.
    """

    def __init__(self, backbone_cfg="cfg_mnet", conf_thres=0.02,
                 topk_bf_nms=5000, nms_thres=0.4, vis_thres=0.6,
                 nms_cap=1024, weights_path=None, dtype=torch.float32,
                 device="cuda"):
        if backbone_cfg not in ("cfg_mnet", cfg_mnet):
            raise NotImplementedError(
                f"only cfg_mnet is ported, got {backbone_cfg!r}")
        self.cfg = cfg_mnet
        self.conf_thres = conf_thres
        self.nms_thres = nms_thres
        self.vis_thres = vis_thres
        self.nms_cap = min(nms_cap, topk_bf_nms)
        self.out_cap = 16  # the engine's per-frame face capacity
        self.device = select_device(device)
        check_set_caps(self.device.type, nms_cap=self.nms_cap)
        self.net = RetinaFaceNet(dtype)
        if weights_path:
            load_npz(self.net, weights_path)
        self.net.to(self.device).eval()
        self._prior_cache = {}

    def priors(self, h, w):
        if (h, w) not in self._prior_cache:
            self._prior_cache[(h, w)] = torch.from_numpy(B.make_priors(
                (h, w), self.cfg["min_sizes"], self.cfg["steps"],
                self.cfg["clip"])).to(self.device)
        return self._prior_cache[(h, w)]

    @torch.no_grad()
    def infer_padded(self, frames):
        """frames [B, H, W, 3] uint8 on the detector's device -> (boxes
        [B, nms_cap, 4] px, scores [B, nms_cap], points [B, nms_cap, 5,
        2] px, valid [B, nms_cap]) after NMS, before ``vis_thres``."""
        b, h, w = frames.shape[:3]
        loc, conf, landms = self.net(frames)
        score = conf[..., 1]
        idx, still = B.top_k_select(score, score > self.conf_thres,
                                    self.nms_cap)
        # decode after the top-k: elementwise per anchor, so exact
        var = self.cfg["variance"]
        pr = self.priors(h, w)[idx]
        scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                             device=frames.device)
        bx = B.decode_boxes(_take(loc, idx), pr, var) * scale
        pt = B.decode_landmarks(_take(landms, idx), pr, var)
        pt = pt.reshape(b, -1, 5, 2) * scale[:2]
        sc = torch.gather(score, 1, idx)
        keep = B.batched_nms_keep_mask(bx, sc, still, self.nms_thres,
                                       offset=1.0)
        return bx, sc, pt, still & keep

    @torch.no_grad()
    def detect_padded(self, frames):
        """The engine's detector contract: (boxes [B, K, 4], scores
        [B, K], points [B, K, 5, 2], valid [B, K]) with K = ``out_cap``
        top detections at or above ``vis_thres``."""
        boxes, scores, points, valid = self.infer_padded(frames)
        valid = valid & (scores >= self.vis_thres)
        idx, still = B.top_k_select(scores, valid, self.out_cap)
        return (_take(boxes, idx), torch.gather(scores, 1, idx),
                _take(points, idx), still)


def _take(a, idx):
    """Rows ``idx`` [B, k] of a [B, N, ...] tensor."""
    ix = idx.reshape(idx.shape + (1,) * (a.dim() - 2))
    return torch.gather(a, 1, ix.expand(idx.shape + a.shape[2:]))
