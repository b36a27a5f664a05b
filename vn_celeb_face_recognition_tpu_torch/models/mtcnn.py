"""MTCNN cascade face detector: batched, capacity-bounded, NCHW nets.

Counterpart of ``vn_celeb_face_recognition_tpu/models/mtcnn.py``: the same
nets, thresholds, box math and per-stage capacities. Data-dependent box
counts are fixed capacities with validity masks: top-K per pyramid scale
after PNet, ``cross_cap`` before the cross-scale NMS, ``rnet_cap`` into
stage 2, ``onet_cap`` into stage 3 and ``out_cap`` final faces per frame.
On the card every TPU kernel of the cascade has its CUDA counterpart:
K4 (``ops.crop``) builds one integral image per chunk; stage 1 reads every
pyramid level of every frame from it through K2 (``ops.pyramid_pnet``) in
one launch, every NMS is K3 (``ops.nms``), the 24 and 48 px crops are K4's
pools (one per stage) and the RNet/ONet trunks are K5
(``ops.crops_net``).

The host API (``detect``, ``inference``, ``select_boxes``, ``extract``,
``__call__``, ``extract_face``) takes numpy frames or lists of them, as
the JAX package's does, and needs no PIL: ``extract_face`` resizes with
the PIL-exact bilinear filter of ``utils.frames`` and ``extract`` writes
PNGs with ``utils.frames.write_png``.

Weights: the published torch-keyed ``{p,r,o}net.npz`` vendored in the JAX
package, read by file path with ``numpy.load`` (the port imports nothing
from the JAX package), or those of ``weights_dir`` (``load_mtcnn_weights``).
"""

import os
import warnings

import numpy as np
import torch
from torch import nn

from ..ops import boxes as B
from ..ops.crop import crop_area_pool, integral_image
from ..ops.crops_net import ONET_SPEC, RNET_SPEC, crop_net_trunk
from ..ops.nms import check_set_caps
from ..ops.pyramid_pnet import normalize, pyramid_pnet
from ..utils.device import select_device
from ..utils.frames import resize_bilinear, write_png
from ..utils.tracing import annotate
from .layers import (
    conv,
    linear,
    max_pool_ceil,
    prelu,
    read_state_dict,
    seeded_init_,
)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WEIGHTS_DIR = os.path.join(
    _REPO_ROOT, "vn_celeb_face_recognition_tpu", "models", "weights_mtcnn")


NETS = ("pnet", "rnet", "onet")


# ---------------------------------------------------------------------------
# The three cascade networks (NCHW; compute in the input's dtype)
# ---------------------------------------------------------------------------


def _flatten_whc(x):
    """Flatten NCHW in the reference's (N, W, H, C) order."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    """Proposal net: fully-convolutional 12x12 face scorer."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 10, 3)
        self.prelu1 = nn.PReLU(10)
        self.conv2 = nn.Conv2d(10, 16, 3)
        self.prelu2 = nn.PReLU(16)
        self.conv3 = nn.Conv2d(16, 32, 3)
        self.prelu3 = nn.PReLU(32)
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        x = prelu(self.prelu1, conv(self.conv1, x))
        x = max_pool_ceil(x, 2, 2)
        x = prelu(self.prelu2, conv(self.conv2, x))
        x = prelu(self.prelu3, conv(self.conv3, x))
        a = torch.softmax(conv(self.conv4_1, x), dim=1)
        b = conv(self.conv4_2, x)
        return b, a


class RNet(nn.Module):
    """Refinement net on 24x24 crops."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 28, 3)
        self.prelu1 = nn.PReLU(28)
        self.conv2 = nn.Conv2d(28, 48, 3)
        self.prelu2 = nn.PReLU(48)
        self.conv3 = nn.Conv2d(48, 64, 2)
        self.prelu3 = nn.PReLU(64)
        self.dense4 = nn.Linear(576, 128)
        self.prelu4 = nn.PReLU(128)
        self.dense5_1 = nn.Linear(128, 2)
        self.dense5_2 = nn.Linear(128, 4)

    def forward(self, x):
        # conv1 .. prelu2 through kernel K5 (NHWC in and out)
        x = crop_net_trunk(self, x.permute(0, 2, 3, 1), RNET_SPEC)
        x = max_pool_ceil(x.permute(0, 3, 1, 2), 3, 2)
        x = prelu(self.prelu3, conv(self.conv3, x))
        x = prelu(self.prelu4, linear(self.dense4, _flatten_whc(x)))
        a = torch.softmax(linear(self.dense5_1, x), dim=1)
        b = linear(self.dense5_2, x)
        return b, a


class ONet(nn.Module):
    """Output net on 48x48 crops; adds 5-point landmarks."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3)
        self.prelu1 = nn.PReLU(32)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.prelu2 = nn.PReLU(64)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.prelu3 = nn.PReLU(64)
        self.conv4 = nn.Conv2d(64, 128, 2)
        self.prelu4 = nn.PReLU(128)
        self.dense5 = nn.Linear(1152, 256)
        self.prelu5 = nn.PReLU(256)
        self.dense6_1 = nn.Linear(256, 2)
        self.dense6_2 = nn.Linear(256, 4)
        self.dense6_3 = nn.Linear(256, 10)

    def forward(self, x):
        # conv1 .. prelu2 through kernel K5 (NHWC in and out)
        x = crop_net_trunk(self, x.permute(0, 2, 3, 1), ONET_SPEC)
        x = max_pool_ceil(x.permute(0, 3, 1, 2), 3, 2)
        x = prelu(self.prelu3, conv(self.conv3, x))
        x = max_pool_ceil(x, 2, 2)
        x = prelu(self.prelu4, conv(self.conv4, x))
        x = prelu(self.prelu5, linear(self.dense5, _flatten_whc(x)))
        a = torch.softmax(linear(self.dense6_1, x), dim=1)
        b = linear(self.dense6_2, x)
        c = linear(self.dense6_3, x)
        return b, c, a


# ---------------------------------------------------------------------------
# Cascade box math
# ---------------------------------------------------------------------------


def load_mtcnn_weights(weights_dir=None):
    """The three nets' torch-keyed state_dicts from ``weights_dir`` (default
    the vendored ``WEIGHTS_DIR``), as the JAX package's
    ``load_mtcnn_variables`` finds them: each net from ``{net}.npz``, else
    from ``{net}.pt`` (``layers.read_state_dict``). Returns ``{net:
    state_dict}``, or None when the directory lacks a net's file."""
    d = WEIGHTS_DIR if weights_dir is None else str(weights_dir)
    paths = {}
    for net in NETS:
        found = [p for p in (os.path.join(d, net + ext)
                             for ext in (".npz", ".pt")) if os.path.isfile(p)]
        if not found:
            return None
        paths[net] = found[0]
    return {net: read_state_dict(path) for net, path in paths.items()}


def _stage1_boxes(score, reg, scale, threshold):
    """Dense PNet outputs -> candidate boxes (generateBoundingBox).
    score [B, hc, wc], reg [B, hc, wc, 4]."""
    b, hc, wc = score.shape
    dev = score.device
    jj = torch.arange(wc, dtype=torch.float32, device=dev)[None, :]
    ii = torch.arange(hc, dtype=torch.float32, device=dev)[:, None]
    # a tensor divisor (a fill, no copy): CUDA divides a tensor by a Python
    # number as a multiply by its reciprocal, whose floor differs by one at
    # exact multiples; so the card computes the CPU's boxes
    scale = torch.full((), scale, dtype=torch.float32, device=dev)
    q1x = torch.floor((2.0 * jj + 1.0) / scale).expand(hc, wc)
    q1y = torch.floor((2.0 * ii + 1.0) / scale).expand(hc, wc)
    q2x = torch.floor((2.0 * jj + 12.0) / scale).expand(hc, wc)
    q2y = torch.floor((2.0 * ii + 12.0) / scale).expand(hc, wc)
    boxes = torch.stack([q1x, q1y, q2x, q2y], dim=-1).reshape(1, -1, 4)
    boxes = boxes.expand(b, -1, -1)
    score = score.reshape(b, -1)
    return boxes, score, reg.reshape(b, -1, 4), score >= threshold


def _stage1_bbreg(boxes, reg):
    """Stage-1 regression without the +1 width convention."""
    regw = boxes[..., 2] - boxes[..., 0]
    regh = boxes[..., 3] - boxes[..., 1]
    return torch.stack([
        boxes[..., 0] + reg[..., 0] * regw,
        boxes[..., 1] + reg[..., 1] * regh,
        boxes[..., 2] + reg[..., 2] * regw,
        boxes[..., 3] + reg[..., 3] * regh,
    ], dim=-1)


def _take(idx, *arrays):
    """Gather rows ``idx`` [B, k] from each [B, K, ...] array."""
    out = []
    for a in arrays:
        ix = idx.reshape(idx.shape + (1,) * (a.dim() - 2))
        out.append(torch.gather(a, 1, ix.expand(idx.shape + a.shape[2:])))
    return out


def _cap(k, score, valid, *arrays):
    """Keep the top-k rows by score among valid rows, per frame."""
    idx, still = B.top_k_select(score, valid, k)
    return (still, *_take(idx, score, *arrays))


def _pad_rows(a, k, fill):
    padn = k - a.shape[1]
    if padn <= 0:
        return a
    pad = torch.full((a.shape[0], padn) + a.shape[2:], fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad], dim=1)


def _max_count(valid):
    return valid.sum(dim=-1).max().to(torch.int32)


class MTCNN:
    """Batched MTCNN detector: every face of a frame, up to ``out_cap``.

    Constructor arguments mirror the JAX package's ``MTCNN``; ``dtype``
    is the compute dtype of all three stages (stage 1 included, as the
    JAX package's; box math and scores stay f32) and ``device`` where the
    nets live: the card unless ``"cpu"`` is asked
    for (a missing card raises). ``image_size``, ``margin``,
    ``post_process``, ``select_largest``, ``selection_method`` and
    ``keep_all`` shape the host API's selection and face extraction.
    ``weights_dir`` (default: the vendored weights) holds the nets'
    ``{p,r,o}net.npz`` or ``.pt`` files; a directory without all three
    gives the nets a seeded initialisation (``layers.seeded_init_``, seed
    0) and a warning, where the JAX package silently initialises them at
    random.
    """

    _BASE_CAPS = {
        "pnet_cap_per_scale": 448,
        "cross_cap": 512,
        "rnet_cap": 256,
        "onet_cap": 128,
    }
    _BASE_CAP_AREA = 640.0 * 640.0
    _SAT_STAGES = ("pnet_cap_per_scale", "cross_cap", "rnet_cap",
                   "onet_cap", "out_cap")

    def __init__(self, image_size=160, margin=0, min_face_size=20,
                 thresholds=(0.6, 0.7, 0.7), factor=0.709, post_process=True,
                 select_largest=True, selection_method=None, keep_all=False,
                 pnet_cap_per_scale=None, cross_cap=None, rnet_cap=None,
                 onet_cap=None, out_cap=64, dtype=torch.float32,
                 device="cuda", weights_dir=None):
        self.image_size = image_size
        self.margin = margin
        self.post_process = post_process
        self.select_largest = select_largest
        self.keep_all = keep_all
        self.selection_method = selection_method or (
            "largest" if select_largest else "probability")
        self.min_face_size = min_face_size
        self.thresholds = tuple(thresholds)
        self.factor = factor
        self.pnet_cap_per_scale = pnet_cap_per_scale
        self.cross_cap = cross_cap
        self.rnet_cap = rnet_cap
        self.onet_cap = onet_cap
        self.out_cap = out_cap
        self.dtype = dtype
        self.device = select_device(device)
        # every cap but out_cap sizes an NMS set
        check_set_caps(self.device.type,
                       pnet_cap_per_scale=pnet_cap_per_scale,
                       cross_cap=cross_cap, rnet_cap=rnet_cap,
                       onet_cap=onet_cap)
        self.pnet, self.rnet, self.onet = PNet(), RNet(), ONet()
        weights = load_mtcnn_weights(weights_dir)
        if weights is None and weights_dir is None:
            raise FileNotFoundError(f"no MTCNN weights in {WEIGHTS_DIR}")
        for name in NETS:
            net = getattr(self, name)
            if weights is None:
                seeded_init_(net, torch.Generator().manual_seed(0))
            else:
                net.load_state_dict(weights[name], strict=True)
            net.to(self.device).eval()
        if weights is None:
            warnings.warn(f"no {{p,r,o}}net .npz or .pt weights in "
                          f"{weights_dir}; the MTCNN nets are seeded",
                          stacklevel=2)
        self._last_caps = None

    # -- scale pyramid ----------------------------------------------------

    def _scales(self, h, w):
        m = 12.0 / self.min_face_size
        minl = min(h, w) * m
        scales = []
        scale = m
        while minl >= 12.0:
            scales.append(scale)
            scale *= self.factor
            minl *= self.factor
        return scales

    # -- capacity profile -------------------------------------------------

    def capacity_profile(self, h, w):
        """Effective per-stage caps for an ``h`` x ``w`` frame: explicit
        knobs verbatim; auto knobs scale the 640x640 base profile with
        frame area (multiple of 64, clamped at 8x)."""
        area_scale = min(max(1.0, (h * w) / self._BASE_CAP_AREA), 8.0)
        caps = {}
        for name, base in self._BASE_CAPS.items():
            explicit = getattr(self, name)
            if explicit is not None:
                caps[name] = int(explicit)
            elif area_scale <= 1.0:
                caps[name] = base
            else:
                caps[name] = int(-(-base * area_scale // 64) * 64)
        caps["out_cap"] = int(self.out_cap)
        return caps

    def warn_capacity_saturation(self, sat_counts, hw=None):
        """Warn for every stage whose pre-cap valid count reached its cap
        (the top-k cap then drops the lowest-score candidates). Returns
        the list of (stage, count, cap)."""
        counts = np.asarray(torch.as_tensor(sat_counts).cpu()).reshape(-1)
        if hw is not None:
            cap_map = self.capacity_profile(int(hw[0]), int(hw[1]))
        else:
            cap_map = self._last_caps or self.capacity_profile(0, 0)
        saturated = []
        for name, count in zip(self._SAT_STAGES, counts):
            if int(count) >= cap_map[name]:
                saturated.append((name, int(count), cap_map[name]))
        for name, count, cap in saturated:
            warnings.warn(
                f"MTCNN capacity saturated: {count} candidates hit "
                f"{name}={cap} — detections may be truncated; raise the "
                "cap.", RuntimeWarning, stacklevel=3)
        return saturated

    # -- the cascade ------------------------------------------------------

    @torch.no_grad()
    def detect_padded(self, frames):
        """frames: [B, H, W, 3] uint8 (or 0-255 float) tensor on the
        detector's device. Returns (boxes [B, out_cap, 4], scores
        [B, out_cap], points [B, out_cap, 5, 2], valid [B, out_cap] bool,
        sat_counts [5] int32), with the caps of ``capacity_profile``."""
        batch, h, w = frames.shape[:3]
        caps = self.capacity_profile(h, w)
        self._last_caps = caps
        k1, kx = caps["pnet_cap_per_scale"], caps["cross_cap"]
        k2, k3, kout = caps["rnet_cap"], caps["onet_cap"], caps["out_cap"]
        thr = self.thresholds
        with annotate("mtcnn.stage1"):
            # K4: the integral image, shared by stage 1 and both crop stages
            integ = integral_image(frames)
            dev = frames.device
            sat_s1 = torch.zeros((), dtype=torch.int32, device=dev)

            # ---- stage 1: pyramid + PNet (K2) + per-scale NMS(0.5) ----
            scales = self._scales(h, w)
            sizes = [(int(h * s + 1), int(w * s + 1)) for s in scales]
            maps = pyramid_pnet(self.pnet, frames, sizes, integ=integ,
                                dtype=self.dtype)
            per_scale = []
            for scale, (probs1, reg) in zip(scales, maps):
                boxes, score, reg, valid = _stage1_boxes(probs1, reg,
                                                         scale, thr[0])
                if valid.shape[-1] >= k1:
                    sat_s1 = torch.maximum(sat_s1, _max_count(valid))
                valid, score, boxes, reg = _cap(k1, score, valid, boxes,
                                                reg)
                per_scale.append((_pad_rows(boxes, k1, 0.0),
                                  _pad_rows(score, k1, 0.0),
                                  _pad_rows(reg, k1, 0.0),
                                  _pad_rows(valid, k1, False)))
            ns = len(scales)
            boxes, score, reg, valid = (torch.stack(t, dim=1)
                                        for t in zip(*per_scale))
            keep = B.batched_nms_keep_mask(
                boxes.reshape(batch * ns, k1, 4),
                score.reshape(batch * ns, k1),
                valid.reshape(batch * ns, k1), 0.5).reshape(batch, ns, k1)
            valid = (valid & keep).reshape(batch, ns * k1)
            boxes = boxes.reshape(batch, ns * k1, 4)
            score = score.reshape(batch, ns * k1)
            reg = reg.reshape(batch, ns * k1, 4)

        with annotate("mtcnn.rnet"):
            # ---- cross-scale cap + NMS(0.7) + cap to rnet capacity ----
            sat_cross = _max_count(valid)
            valid, score, boxes, reg = _cap(kx, score, valid, boxes, reg)
            valid = valid & B.batched_nms_keep_mask(boxes, score, valid, 0.7)
            sat_rnet = _max_count(valid)
            valid, score, boxes, reg = _cap(k2, score, valid, boxes, reg)
            boxes = B.rerec(_stage1_bbreg(boxes, reg))

            # ---- stage 2: 24x24 crops + RNet ----
            crops = crop_area_pool(integ, B.clamp_boxes(boxes, w, h), 24)
            r_reg, r_prob = self._apply(self.rnet,
                                        crops.reshape(-1, 24, 24, 3))
            r_score = r_prob[:, 1].reshape(batch, -1)
            r_reg = r_reg.reshape(batch, -1, 4)
            valid = valid & (r_score > thr[1])
            valid = valid & B.batched_nms_keep_mask(boxes, r_score, valid,
                                                    0.7)
            boxes = B.rerec(B.bbreg(boxes, r_reg))
            sat_onet = _max_count(valid)
            valid, score, boxes = _cap(k3, r_score, valid, boxes)

        with annotate("mtcnn.onet"):
            # ---- stage 3: 48x48 crops + ONet ----
            crops = crop_area_pool(integ, B.clamp_boxes(boxes, w, h), 48)
            o_reg, o_landm, o_prob = self._apply(
                self.onet, crops.reshape(-1, 48, 48, 3))
            o_score = o_prob[:, 1].reshape(batch, -1)
            o_reg = o_reg.reshape(batch, -1, 4)
            o_landm = o_landm.reshape(batch, -1, 10)
            valid = valid & (o_score > thr[2])

            # landmarks decode before bbreg, on the unclamped boxes
            bw = boxes[..., 2] - boxes[..., 0] + 1.0
            bh = boxes[..., 3] - boxes[..., 1] + 1.0
            pts_x = (bw[..., None] * o_landm[..., :5] + boxes[..., 0:1]
                     - 1.0)
            pts_y = (bh[..., None] * o_landm[..., 5:10] + boxes[..., 1:2]
                     - 1.0)
            points = torch.stack([pts_x, pts_y], dim=-1)  # [B, K, 5, 2]

            boxes = B.bbreg(boxes, o_reg)
            valid = valid & B.batched_nms_keep_mask(
                boxes, o_score, valid, 0.7, offset=1.0, min_mode=True)
            sat_out = _max_count(valid)
            valid, score, boxes, points = _cap(kout, o_score, valid, boxes,
                                               points)
            sat = torch.stack([sat_s1, sat_cross, sat_rnet, sat_onet,
                               sat_out])
        return boxes, score, points, valid, sat

    def _apply(self, net, crops_nhwc):
        """Run R/ONet on NHWC crops in the compute dtype; f32 outputs."""
        x = normalize(crops_nhwc).permute(0, 3, 1, 2).to(self.dtype)
        return tuple(o.to(torch.float32) for o in net(x))

    # -- host API (the JAX package's models/mtcnn.py:766-966) -------------

    @staticmethod
    def _as_batch(img):
        """ndarray or list input -> (array [B, H, W, 3] uint8, batch_mode)."""
        if isinstance(img, (list, tuple)):
            arrs = [np.asarray(x, dtype=np.uint8) for x in img]
            if any(a.shape != arrs[0].shape for a in arrs):
                raise ValueError("MTCNN batch processing only compatible "
                                 "with equal-dimension images.")
            return np.stack(arrs), True
        arr = np.asarray(img, dtype=np.uint8)
        if arr.ndim == 3:
            return arr[None], False
        return arr, True

    def detect(self, img, landmarks=False):
        """Boxes and probabilities (and 5-point landmarks) of every face,
        per image, ordered by area when ``select_largest`` else by
        probability; an image without faces gets empty lists."""
        imgs, batch_mode = self._as_batch(img)
        frames = torch.from_numpy(np.ascontiguousarray(imgs)).to(self.device)
        b_boxes, b_score, b_points, b_valid, sat = (
            t.cpu().numpy() for t in self.detect_padded(frames))
        self.warn_capacity_saturation(sat, hw=imgs.shape[1:3])
        boxes_out, probs_out, points_out = [], [], []
        for i in range(imgs.shape[0]):
            v = b_valid[i]
            if not v.any():
                boxes_out.append([])
                probs_out.append([])
                points_out.append([])
                continue
            bx, sc, pt = b_boxes[i][v], b_score[i][v], b_points[i][v]
            if self.select_largest:
                order = np.argsort(
                    (bx[:, 2] - bx[:, 0]) * (bx[:, 3] - bx[:, 1]))[::-1]
            else:
                order = np.argsort(sc)[::-1]
            boxes_out.append(bx[order])
            probs_out.append(sc[order])
            points_out.append(pt[order])
        if batch_mode:  # numpy's object arrays, as the JAX package builds
            out = tuple(np.array(x, dtype=object)
                        for x in (boxes_out, probs_out, points_out))
        else:
            out = (boxes_out[0], probs_out[0], points_out[0])
        return out if landmarks else out[:2]

    def inference(self, rgb_image, landmark=True):
        return self.detect(rgb_image, landmark)

    def select_boxes(self, all_boxes, all_probs, all_points, imgs,
                     method="probability", threshold=0.9,
                     center_weight=2.0):
        """One face per image by ``method``: "largest", "probability",
        "center_weighted_size" or "largest_over_threshold"."""
        batch_mode = isinstance(imgs, (list, tuple)) or (
            isinstance(imgs, np.ndarray) and imgs.ndim == 4)
        if not batch_mode:
            imgs, all_boxes = [imgs], [all_boxes]
            all_probs, all_points = [all_probs], [all_points]
        sel_boxes, sel_probs, sel_points = [], [], []
        for boxes, points, probs, img in zip(all_boxes, all_points,
                                             all_probs, imgs):
            boxes, probs = np.asarray(boxes), np.asarray(probs)
            points = np.asarray(points)
            if len(boxes) == 0:
                sel_boxes.append(None)
                sel_probs.append([None])
                sel_points.append(None)
                continue
            area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            if method == "largest":
                order = np.argsort(area)[::-1]
            elif method == "probability":
                order = np.argsort(probs)[::-1]
            elif method == "center_weighted_size":
                img_arr = np.asarray(img)
                center = (img_arr.shape[1] / 2, img_arr.shape[0] / 2)
                centers = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2,
                                    (boxes[:, 1] + boxes[:, 3]) / 2], axis=1)
                off2 = np.sum((centers - center) ** 2, axis=1)
                order = np.argsort(area - off2 * center_weight)[::-1]
            elif method == "largest_over_threshold":
                mask = probs > threshold
                if mask.sum() == 0:
                    sel_boxes.append(None)
                    sel_probs.append([None])
                    sel_points.append(None)
                    continue
                boxes, probs, points = boxes[mask], probs[mask], points[mask]
                order = np.argsort((boxes[:, 2] - boxes[:, 0])
                                   * (boxes[:, 3] - boxes[:, 1]))[::-1]
            else:
                raise ValueError(f"Unknown selection method '{method}'")
            sel_boxes.append(boxes[order][[0]])
            sel_probs.append(probs[order][[0]])
            sel_points.append(points[order][[0]])
        if batch_mode:
            return (np.array(sel_boxes, dtype=object),
                    np.array(sel_probs, dtype=object),
                    np.array(sel_points, dtype=object))
        return sel_boxes[0], sel_probs[0][0], sel_points[0]

    def extract(self, img, batch_boxes, save_path=None):
        """Faces cropped with ``margin`` and resized to ``image_size``
        (float [S, S, 3], or [n, S, S, 3] with ``keep_all``), standardised
        when ``post_process``. ``save_path`` writes the unstandardised
        crops as PNG; extra faces get a ``_<i>`` suffix."""
        imgs, batch_mode = self._as_batch(img)
        if not batch_mode:
            batch_boxes = [batch_boxes]
        if isinstance(save_path, str):
            save_path = [save_path]
        if save_path is None:
            save_path = [None] * imgs.shape[0]
        faces = []
        for i, box_im in enumerate(batch_boxes):
            if box_im is None or len(box_im) == 0:
                faces.append(None)
                continue
            box_im = np.asarray(box_im, dtype=np.float32)
            if not self.keep_all:
                box_im = box_im[[0]]
            face_list = []
            for j, box in enumerate(box_im):
                face = extract_face(imgs[i], box, self.image_size,
                                    self.margin)
                path_im = save_path[i]
                if path_im is not None:
                    if j > 0:
                        stem, ext = os.path.splitext(path_im)
                        path_im = f"{stem}_{j + 1}{ext}"
                    os.makedirs(os.path.dirname(os.path.abspath(path_im)),
                                exist_ok=True)
                    write_png(path_im,
                              np.clip(face, 0, 255).astype(np.uint8))
                if self.post_process:
                    face = (face - 127.5) / 128.0
                face_list.append(face)
            faces.append(np.stack(face_list) if self.keep_all
                         else face_list[0])
        return faces if batch_mode else faces[0]

    def __call__(self, img, save_path=None, return_prob=False,
                 extract_face_flag=True):
        batch_boxes, batch_probs, batch_points = self.detect(img,
                                                             landmarks=True)
        if not self.keep_all:
            batch_boxes, batch_probs, batch_points = self.select_boxes(
                batch_boxes, batch_probs, batch_points, img,
                method=self.selection_method)
        faces = (self.extract(img, batch_boxes, save_path)
                 if extract_face_flag else None)
        if return_prob:
            return faces, batch_boxes, batch_probs
        return faces, batch_boxes

    def eval(self):
        return self


def extract_face(img, box, image_size=160, margin=0):
    """Crop + margin + PIL-exact bilinear resize on the host.
    img: uint8 [H, W, 3]; returns float32 [S, S, 3]."""
    margin_px = [
        margin * (box[2] - box[0]) / (image_size - margin),
        margin * (box[3] - box[1]) / (image_size - margin),
    ] if margin else [0, 0]
    h, w = img.shape[:2]
    x1 = int(max(box[0] - margin_px[0] / 2, 0))
    y1 = int(max(box[1] - margin_px[1] / 2, 0))
    x2 = int(min(box[2] + margin_px[0] / 2, w))
    y2 = int(min(box[3] + margin_px[1] / 2, h))
    crop = np.ascontiguousarray(img[y1:y2, x1:x2])
    return resize_bilinear(crop, (image_size, image_size)).astype(np.float32)
