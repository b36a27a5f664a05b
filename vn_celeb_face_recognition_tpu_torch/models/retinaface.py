"""RetinaFace single-shot face detector (MobileNetV1-0.25 or ResNet-50
trunk), NCHW.

Counterpart of ``vn_celeb_face_recognition_tpu/models/retinaface.py``:
the same bodies (``cfg_mnet``: MobileNetV1-0.25; ``cfg_re50``: the
torchvision ResNet-50 trunk tapped at layer2-4), FPN, SSH and heads with
the torch reference's state_dict keys, so the vendored torch-keyed
``retinaface_mnet025.npz`` loads straight into ``load_state_dict``. The
detector keeps the JAX package's fixed-capacity inference: priors once
per frame size, conf > ``conf_thres``, per-frame top ``nms_cap``, decode
after the top-k, exact NMS (+1 area convention), ``vis_thres``, then the
top ``out_cap`` faces per frame for the engine (``detect_padded``), or
every face, up to ``keep_top_k``, as numpy lists for the host API
(``inference``).

The net takes the uint8 frames. On ``cfg_mnet`` in eval mode, stage 1 of
the body runs through kernel K6 (``ops.planar_s1``), which subtracts the
channel means itself; in train mode (detector training,
``training.detector``) it runs as the stage's cuDNN modules with batch
statistics. Stages 2-3 are cuDNN convolutions. On ``cfg_re50`` the means are
subtracted in torch and the whole trunk is cuDNN convolutions (the
``models.resnet_common`` Bottlenecks; the JAX package runs its re50 in
XLA, not through its bottleneck kernel). FPN, SSH and heads are cuDNN
convolutions on both.
"""

import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as B
from ..ops.nms import check_set_caps
from ..ops.planar_s1 import STAGE1_SPECS, mnet_stage1
from ..utils.device import select_device
from .layers import batch_norm, conv, load_npz, seeded_init_
from .resnet_common import ResLayer

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WEIGHTS_NPZ = os.path.join(_REPO_ROOT, "vn_celeb_face_recognition_tpu",
                           "models", "weights", "retinaface_mnet025.npz")

# per-channel means the net subtracts from the frames (BGR order of the
# reference's cv2 input)
CHANNELS_SUBTRACT = (104.0, 117.0, 123.0)
INIT_SCALE = 1.0  # seeded_init_'s variance scale: flax's lecun-normal

cfg_mnet = {
    "name": "mobilenet0.25",
    "min_sizes": [[16, 32], [64, 128], [256, 512]],
    "steps": [8, 16, 32],
    "variance": [0.1, 0.2],
    "clip": False,
    "in_channel": 32,
    "out_channel": 64,
}

cfg_re50 = {
    "name": "Resnet50",
    "min_sizes": [[16, 32], [64, 128], [256, 512]],
    "steps": [8, 16, 32],
    "variance": [0.1, 0.2],
    "clip": False,
    "in_channel": 256,
    "out_channel": 256,
}

CONFIGS = {"cfg_mnet": cfg_mnet, "cfg_re50": cfg_re50}


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
        ``dtype``. In eval mode stage 1 is kernel K6, which folds the
        running statistics into its weights. In train mode it is the
        stage's own modules on the frames minus the channel means, with
        batch statistics and running-statistic updates (K6 computes the
        eval-mode function only, and has no backward)."""
        if self.training:
            sub = torch.tensor(CHANNELS_SUBTRACT, dtype=torch.float32,
                               device=frames.device)
            x = (frames.to(torch.float32) - sub).permute(0, 3, 1, 2)
            s1 = self.stage1(x.to(dtype))
        else:
            s1 = mnet_stage1(self.stage1, frames, CHANNELS_SUBTRACT, dtype)
            s1 = s1.permute(0, 3, 1, 2)
        s2 = self.stage2(s1)
        return s1, s2, self.stage3(s2)


class ResNet50Body(nn.Module):
    """The torchvision ResNet-50 trunk (keys ``conv1``, ``bn1``,
    ``layer1..4``): conv 7x7/2, BN, ReLU, max pool 3x3/2 (pad 1), then
    3, 4, 6 and 3 Bottlenecks, tapped at layer2, layer3 and layer4."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = ResLayer(64, 3, 1, 64)
        self.layer2 = ResLayer(128, 4, 2, 256)
        self.layer3 = ResLayer(256, 6, 2, 512)
        self.layer4 = ResLayer(512, 3, 2, 1024)

    def forward(self, frames, dtype):
        """frames [N, H, W, 3] uint8 -> the three NCHW taps in ``dtype``;
        the channel means are subtracted in f32 first, in the frames'
        channel order, as the JAX package does."""
        sub = torch.tensor(CHANNELS_SUBTRACT, dtype=torch.float32,
                           device=frames.device)
        x = (frames.to(torch.float32) - sub).permute(0, 3, 1, 2).to(dtype)
        x = F.relu(batch_norm(self.bn1, conv(self.conv1, x)))
        x = F.max_pool2d(x, 3, 2, 1)
        c2 = self.layer2(self.layer1(x))
        c3 = self.layer3(c2)
        return c2, c3, self.layer4(c3)


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
    """RetinaFace on ``cfg`` (``cfg_mnet`` or ``cfg_re50``): [N, H, W, 3]
    uint8 frames -> (loc [N, A, 4], conf [N, A, 2], landmarks [N, A, 10]),
    all f32; the convolutions run in ``dtype``. ``conf`` is the softmax,
    or the raw class logits when ``phase`` is ``"train"`` (what the
    MultiBox loss takes). BatchNorm and the mnet's stage 1 follow the
    module's mode (``train()`` / ``eval()``), not ``phase``."""

    def __init__(self, dtype=torch.float32, cfg=cfg_mnet, phase="test"):
        super().__init__()
        self.dtype = dtype
        self.phase = phase
        c_in, c_out = cfg["in_channel"], cfg["out_channel"]
        self.body = (ResNet50Body() if cfg["name"] == "Resnet50"
                     else MobileNetV1Body())
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
        conf = self.ClassHead(features)
        if self.phase != "train":
            conf = torch.softmax(conf, dim=-1)
        return loc, conf, self.LandmarkHead(features)


class RetinaFace:
    """Batched RetinaFace detector: every face of a frame above
    ``vis_thres``, up to ``out_cap``.

    Constructor arguments mirror the JAX package's ``RetinaFace``, so
    ``cfg/detection/retina_face.json`` builds it as it is; ``backbone_cfg``
    is ``"cfg_mnet"``, ``"cfg_re50"`` or such a dict. Weights load from
    the first of ``weights_path`` and ``checkpoint_path`` that exists (a
    torch-keyed ``.npz`` or a torch ``.pth``); without one the net is
    seeded as the JAX package inits it: lecun-normal weights, zero biases,
    identity BatchNorm (``layers.seeded_init_``, ``torch.Generator`` seed
    0), so every build of a config holds the same weights. ``phase`` goes
    to the net, as in the JAX package (``"train"``: raw logits as scores).
    ``backbone_path`` is accepted and unused, and so is
    ``planar_stage1``: it chose the JAX package's stage-1 formulation, and
    here the mnet's stage 1 always runs through kernel K6 on the card. ``keep_top_k``
    caps the faces ``inference`` returns per image. ``dtype`` is the
    compute dtype of the net (heads and decode stay f32) and ``device``
    where it runs (the card unless ``"cpu"`` is asked for; a missing card
    raises).
    """

    def __init__(self, backbone_cfg="cfg_mnet", phase="test",
                 backbone_path=None, conf_thres=0.02, topk_bf_nms=5000,
                 keep_top_k=750, nms_thres=0.4, vis_thres=0.6,
                 checkpoint_path=None, nms_cap=1024, weights_path=None,
                 dtype=torch.float32, planar_stage1=None, device="cuda"):
        self.cfg = (CONFIGS[backbone_cfg] if isinstance(backbone_cfg, str)
                    else backbone_cfg)
        self.phase = phase
        self.conf_thres = conf_thres
        self.keep_top_k = keep_top_k
        self.nms_thres = nms_thres
        self.vis_thres = vis_thres
        self.nms_cap = min(nms_cap, topk_bf_nms)
        self.out_cap = 16  # the engine's per-frame face capacity
        self.device = select_device(device)
        check_set_caps(self.device.type, nms_cap=self.nms_cap)
        self.net = RetinaFaceNet(dtype, self.cfg, phase)
        paths = [p for p in (weights_path, checkpoint_path) if p]
        found = [p for p in paths if os.path.exists(p)]
        if found:
            load_npz(self.net, found[0])
        else:
            if paths:
                warnings.warn(f"RetinaFace: no weights at {paths}; the net "
                              "is seeded", stacklevel=2)
            seeded_init_(self.net, torch.Generator().manual_seed(0),
                         INIT_SCALE)
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
        bx = B.decode_boxes(B.take_rows(loc, idx), pr, var) * scale
        pt = B.decode_landmarks(B.take_rows(landms, idx), pr, var)
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
        return (B.take_rows(boxes, idx), torch.gather(scores, 1, idx),
                B.take_rows(points, idx), still)


    def inference(self, rgb_images, landmark=True):
        """The JAX package's host API: an RGB image [H, W, 3] uint8 or a
        list of equal-sized ones -> per image (boxes [n, 4], scores [n][,
        landmarks [n, 5, 2]]) numpy lists, each image's faces by descending
        score, at most ``keep_top_k``, at or above ``vis_thres``."""
        single = not isinstance(rgb_images, (list, tuple)) and \
            np.asarray(rgb_images).ndim == 3
        if single:
            rgb_images = [rgb_images]
        imgs = np.stack([np.asarray(im, dtype=np.uint8) for im in rgb_images])
        frames = torch.from_numpy(imgs).to(self.device)
        boxes, scores, landms, valid = (
            t.cpu().numpy() for t in self.infer_padded(frames))
        ret_dets, ret_scores, ret_landms = [], [], []
        for i in range(imgs.shape[0]):
            v = valid[i]
            bx, sc, pt = boxes[i][v], scores[i][v], landms[i][v]
            order = np.argsort(sc)[::-1][:self.keep_top_k]
            bx, sc, pt = bx[order], sc[order], pt[order]
            chosen = sc >= self.vis_thres
            ret_dets.append(bx[chosen])
            ret_scores.append(sc[chosen])
            ret_landms.append(pt[chosen])
        if landmark:
            return ret_dets, ret_scores, ret_landms
        return ret_dets, ret_scores

    def eval(self):
        return self
