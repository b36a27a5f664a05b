"""FAN 68-point face landmark network (2D-FAN), NCHW.

Counterpart of ``vn_celeb_face_recognition_tpu/models/fan.py`` with the
released face_alignment state_dict keys, so a torch-keyed ``.npz`` of the
published 2DFAN-4 loads with ``load_state_dict`` as it is:

  * ``ConvBlock``: BN-ReLU-conv3x3 three times (out/2, out/4 and out/4
    channels), concatenated, plus the skip (``DownsampleSkip``, the
    BN-ReLU-conv1x1 ``downsample.0``/``downsample.2``, where the channel
    counts differ);
  * ``HourGlass``: depth-4 recursive encoder/decoder, 2x2 average pool on
    the way down, x2 nearest-neighbour upsampling on the way up;
  * ``FAN``: the 7x7/2 stem and ``conv2``-``conv4``, then ``num_modules``
    stacked hourglasses, each with its heatmap head ``l<i>`` and the
    ``bl<i>``/``al<i>`` re-entry into the trunk.

The geometry works on a batch of faces: ``box_center_scale`` (the
face_alignment box convention), ``crop_face_window`` (the square window of
side 200 * scale around the centre, resampled to 256 px with bilinear
weights, zero outside the image) and ``decode_heatmaps`` (argmax, the
quarter-pixel shift towards the larger neighbour, and the inverse crop
transform, kept sub-pixel). The JAX package computes the crop as two dense
hat-matrix products over the whole image; here each output row and column
gathers its two source rows and columns with the same weights, so a 12 MP
photo costs the window's pixels, not the photo's.

Dtype contract: parameters stay f32; the network computes in ``dtype``
(BatchNorm with its f32 statistics) and returns f32 heatmaps.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import batch_norm, coerce_dtype, conv, read_state_dict, \
    seeded_init_

RESOLUTION = 256


def _conv3x3(in_planes, out_planes):
    return nn.Conv2d(in_planes, out_planes, 3, 1, 1, bias=False)


class DownsampleSkip(nn.Sequential):
    """The torch ``nn.Sequential(BatchNorm2d, ReLU, Conv2d 1x1)`` skip:
    keys ``0`` and ``2``."""

    def __init__(self, in_planes, out_planes):
        super().__init__(nn.BatchNorm2d(in_planes), nn.ReLU(True),
                         nn.Conv2d(in_planes, out_planes, 1, 1, bias=False))

    def forward(self, x):
        return conv(self[2], F.relu(batch_norm(self[0], x)))


class ConvBlock(nn.Module):
    def __init__(self, in_planes, out_planes):
        super().__init__()
        half, quarter = out_planes // 2, out_planes // 4
        self.bn1 = nn.BatchNorm2d(in_planes)
        self.conv1 = _conv3x3(in_planes, half)
        self.bn2 = nn.BatchNorm2d(half)
        self.conv2 = _conv3x3(half, quarter)
        self.bn3 = nn.BatchNorm2d(quarter)
        self.conv3 = _conv3x3(quarter, quarter)
        self.downsample = (DownsampleSkip(in_planes, out_planes)
                           if in_planes != out_planes else None)

    def forward(self, x):
        out1 = conv(self.conv1, F.relu(batch_norm(self.bn1, x)))
        out2 = conv(self.conv2, F.relu(batch_norm(self.bn2, out1)))
        out3 = conv(self.conv3, F.relu(batch_norm(self.bn3, out2)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.cat((out1, out2, out3), 1) + residual


class HourGlass(nn.Module):
    """Depth-``depth`` recursive hourglass over ``features`` channels:
    ``b1_<n>``, ``b2_<n>``, ``b3_<n>`` at each level ``n`` and
    ``b2_plus_1`` at the bottom."""

    def __init__(self, depth=4, features=256):
        super().__init__()
        self.depth = depth
        for n in range(depth, 0, -1):
            self.add_module(f"b1_{n}", ConvBlock(features, features))
            self.add_module(f"b2_{n}", ConvBlock(features, features))
            if n == 1:
                self.add_module("b2_plus_1", ConvBlock(features, features))
            self.add_module(f"b3_{n}", ConvBlock(features, features))

    def _level(self, n, x):
        up1 = self._modules[f"b1_{n}"](x)
        low1 = self._modules[f"b2_{n}"](F.avg_pool2d(x, 2, stride=2))
        if n > 1:
            low2 = self._level(n - 1, low1)
        else:
            low2 = self.b2_plus_1(low1)
        low3 = self._modules[f"b3_{n}"](low2)
        return up1 + F.interpolate(low3, scale_factor=2, mode="nearest")

    def forward(self, x):
        return self._level(self.depth, x)


class FAN(nn.Module):
    """[N, 3, H, W] faces in [0, 1] -> the list of ``num_modules`` f32
    heatmap sets [N, 68, H/4, W/4]."""

    def __init__(self, num_modules=4, dtype=torch.float32):
        super().__init__()
        self.num_modules = num_modules
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass())
            self.add_module(f"top_m_{i}", ConvBlock(256, 256))
            self.add_module(f"conv_last{i}", nn.Conv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", nn.BatchNorm2d(256))
            self.add_module(f"l{i}", nn.Conv2d(256, 68, 1))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", nn.Conv2d(256, 256, 1))
                self.add_module(f"al{i}", nn.Conv2d(68, 256, 1))

    def forward(self, x):
        m = self._modules
        x = F.relu(batch_norm(self.bn1, conv(self.conv1, x.to(self.dtype))))
        x = F.avg_pool2d(self.conv2(x), 2, stride=2)
        previous = self.conv4(self.conv3(x))
        outputs = []
        for i in range(self.num_modules):
            ll = m[f"top_m_{i}"](m[f"m{i}"](previous))
            ll = F.relu(batch_norm(m[f"bn_end{i}"],
                                   conv(m[f"conv_last{i}"], ll)))
            tmp_out = conv(m[f"l{i}"], ll)
            outputs.append(tmp_out.to(torch.float32))
            if i < self.num_modules - 1:
                previous = (previous + conv(m[f"bl{i}"], ll)
                            + conv(m[f"al{i}"], tmp_out))
        return outputs


# ---------------------------------------------------------------------------
# Crop and decode, over a leading axis of faces
# ---------------------------------------------------------------------------


def box_center_scale(boxes):
    """xyxy boxes [..., 4] -> (centres [..., 2], scales [...]) in
    face_alignment's convention: the centre moved up by 12% of the box
    height, scale = (w + h) / 195."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    cx = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cy = (boxes[..., 1] + boxes[..., 3]) / 2.0
    cy = cy - (boxes[..., 3] - boxes[..., 1]) * 0.12
    scale = ((boxes[..., 2] - boxes[..., 0])
             + (boxes[..., 3] - boxes[..., 1])) / 195.0
    return torch.stack([cx, cy], dim=-1), scale


def _taps(positions, size):
    """The two nonzero weights of the hat function max(0, 1 - |p - i|)
    over i in [0, size): (i0, w0, i1, w1) for i0 = floor(p) and i1 = i0 +
    1, each weight 0 where its index lies outside, indices clamped."""
    i0 = torch.floor(positions)
    i1 = i0 + 1.0
    w0 = 1.0 - (positions - i0)
    w1 = 1.0 - (i1 - positions)
    w0 = torch.where((i0 >= 0) & (i0 < size), w0, 0.0)
    w1 = torch.where((i1 >= 0) & (i1 < size), w1, 0.0)
    return (i0.clamp(0, size - 1).long(), w0, i1.clamp(0, size - 1).long(),
            w1)


def crop_face_window(images, centers, scales, resolution=RESOLUTION):
    """images [N, H, W, C] (uint8, read as value / 255, or float) ->
    [N, resolution, resolution, C] f32: the square of side 200 * scale
    around each centre, bilinear, zero outside the image (the reference
    pads its integer crop with zeros too)."""
    n, h, w = images.shape[:3]
    dev = images.device
    centers = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    scales = torch.as_tensor(scales, dtype=torch.float32, device=dev)
    side = (200.0 * scales)[:, None]
    o = (torch.arange(resolution, dtype=torch.float32, device=dev)
         + 0.5) / resolution
    ys = centers[:, 1:2] - side / 2.0 + o * side - 0.5
    xs = centers[:, 0:1] - side / 2.0 + o * side - 0.5
    faces = torch.arange(n, device=dev)

    def rows(idx):
        r = images[faces[:, None], idx].to(torch.float32)
        return r / 255.0 if images.dtype == torch.uint8 else r

    y0, wy0, y1, wy1 = _taps(ys, h)
    out = (wy0[:, :, None, None] * rows(y0)
           + wy1[:, :, None, None] * rows(y1))  # [N, res, W, C]
    x0, wx0, x1, wx1 = _taps(xs, w)
    lines = torch.arange(resolution, device=dev)[None, :, None]
    return (wx0[:, None, :, None] * out[faces[:, None, None], lines,
                                        x0[:, None, :]]
            + wx1[:, None, :, None] * out[faces[:, None, None], lines,
                                          x1[:, None, :]])


def decode_heatmaps(heatmaps, centers, scales):
    """[N, 68, H, W] heatmaps -> [N, 68, 2] image-coordinate landmarks, as
    face_alignment's get_preds_fromhm: the first argmax, a 0.25 px shift
    towards the larger neighbour on each axis (only strictly inside the
    map; sign(0) = 0), the half-pixel correction, then the inverse crop
    transform (sub-pixel, where the reference truncates to integers)."""
    n, c, hh, ww = heatmaps.shape
    flat = heatmaps.reshape(n, c, hh * ww)
    idx = torch.argmax(flat, dim=-1)  # the first maximum, as jnp.argmax
    px, py = idx % ww, idx // ww

    def at(y, x):
        return flat.gather(-1, (y * ww + x)[..., None])[..., 0]

    sx = torch.sign(at(py, (px + 1).clamp(max=ww - 1))
                    - at(py, (px - 1).clamp(min=0)))
    sy = torch.sign(at((py + 1).clamp(max=hh - 1), px)
                    - at((py - 1).clamp(min=0), px))
    inside = (px > 0) & (px < ww - 1) & (py > 0) & (py < hh - 1)
    fx = px.to(torch.float32) + torch.where(inside, 0.25 * sx, 0.0)
    fy = py.to(torch.float32) + torch.where(inside, 0.25 * sy, 0.0)
    fx, fy = fx + 0.5, fy + 0.5
    centers = torch.as_tensor(centers, dtype=torch.float32,
                              device=heatmaps.device)
    side = (200.0 * torch.as_tensor(scales, dtype=torch.float32,
                                    device=heatmaps.device))[:, None]
    ix = (fx / ww) * side + centers[:, 0:1] - side / 2.0
    iy = (fy / hh) * side + centers[:, 1:2] - side / 2.0
    return torch.stack([ix, iy], dim=-1)


def reduce_to_5_points(points68):
    """68 -> the 5 canonical points (eye centres, nose tip, mouth corners)
    and the geometric sanity gate: returns (dst [5, 2], ok)."""
    from ..pipeline.recognition import landmarks_geometrically_sane

    p = np.asarray(points68, np.float32)
    dst = np.stack([p[36:42].mean(axis=0), p[42:48].mean(axis=0), p[33],
                    p[48], p[54]])
    return dst, bool(landmarks_geometrically_sane(dst))


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------


class FANLandmarker:
    """68-point landmarks for face boxes: numpy in, numpy out; crop, FAN
    and decode run on ``device`` (the card unless ``"cpu"`` is passed).

    Args:
      num_modules: stacked hourglasses (the published 2DFAN-4 has 4).
      weights_path: a torch-keyed ``.npz`` (or ``.pth``) of the released
        state_dict, loaded strictly (``num_batches_tracked`` may be
        absent); a path that does not exist warns and seeds.
      state_dict: torch-keyed weights to load in place of a file.
      dtype: compute dtype (None or "float32", or "bfloat16").
    """

    def __init__(self, num_modules=4, weights_path=None, state_dict=None,
                 dtype=None, device="cuda"):
        from ..utils.device import select_device

        self.device = select_device(device)
        net = FAN(num_modules=num_modules, dtype=coerce_dtype(dtype))
        if state_dict is None and weights_path and os.path.exists(
                weights_path):
            state_dict = read_state_dict(weights_path)
        if state_dict is None:
            if weights_path:
                print(f"Warning: FAN weights '{weights_path}' not found; the "
                      "landmarker is randomly initialised.")
            seeded_init_(net, torch.Generator().manual_seed(0))
        else:
            net.load_state_dict(state_dict, strict=True)
        self.net = net.to(self.device).eval()

    @torch.no_grad()
    def landmarks_for_boxes(self, images_u8, boxes):
        """images_u8 [N, H, W, 3] uint8 (one face region each, zero
        padding allowed: it reads as the crop's own zero border), boxes
        [N, 4] xyxy in image coordinates -> [N, 68, 2] f32 landmarks."""
        images = torch.from_numpy(np.ascontiguousarray(images_u8, np.uint8))
        centers, scales = box_center_scale(np.asarray(boxes, np.float32))
        centers, scales = centers.to(self.device), scales.to(self.device)
        crops = crop_face_window(images.to(self.device), centers, scales)
        heatmaps = self.net(crops.permute(0, 3, 1, 2))[-1]
        return decode_heatmaps(heatmaps, centers, scales).cpu().numpy()

    def get_landmarks(self, rgb_image, detected_box=None):
        """One face image -> [[68, 2]], like face_alignment's
        get_landmarks; the whole image is the face box when none is
        given."""
        img = np.ascontiguousarray(rgb_image)
        h, w = img.shape[:2]
        if detected_box is None:
            detected_box = [0.0, 0.0, float(w), float(h)]
        return [self.landmarks_for_boxes(
            img[None], np.asarray(detected_box, np.float32)[None])[0]]


def build_fan(num_modules=4, weights_path=None, dtype=None, device="cuda"):
    """Registry factory."""
    return FANLandmarker(num_modules=num_modules, weights_path=weights_path,
                         dtype=dtype, device=device)
