"""Image resampling, warping and normalisation on NHWC tensors.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/image.py``. Public
functions keep the JAX package's NHWC layout so the parity tests compare
like with like.

* ``area_resize`` / ``pyramid_area_resize``: adaptive-average-pool resize
  as two matmuls against the exact pooling matrices (``_area_weights``).
* ``grouped_crop_area_resize`` / ``batched_crop_area_resize``: integer
  crop + adaptive average pool (kernel K4, ``ops.crop``), bit-exact on
  uint8-valued input, grouped per frame or over a flat face set.
* ``crop_resize_bilinear`` / ``batched_crop_resize``: integer crop +
  bilinear sampling at the pool cells' centres, clamped to the box (plain
  torch gathers, as the JAX package computes them outside any kernel).
* ``warp_affine`` / ``batched_warp_affine``: cv2 ``BORDER_CONSTANT``
  bilinear warp, border per tap, tap validity from the unclipped floor.
"""

import math
from functools import lru_cache

import numpy as np
import torch

from . import crop as _crop


@lru_cache(maxsize=256)
def _area_weights(in_size: int, out_size: int):
    """[out_size, in_size] row-stochastic pooling matrix (NumPy, cached;
    treat as read-only).

    torch's adaptive_avg_pool2d averages the full pixels in
    [floor(o*in/out), ceil((o+1)*in/out)) with equal weight.
    """
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for o in range(out_size):
        p0 = (o * in_size) // out_size
        p1 = -((-(o + 1) * in_size) // out_size)  # ceil
        p1 = min(max(p1, p0 + 1), in_size)
        w[o, p0:p1] = 1.0 / (p1 - p0)
    return w


def _weights(in_size, out_size, like):
    return torch.from_numpy(_area_weights(in_size, out_size)).to(
        device=like.device, dtype=like.dtype)


def area_resize(images, out_hw):
    """Adaptive-average-pool resize of NHWC (or HWC) images."""
    squeeze = images.dim() == 3
    if squeeze:
        images = images[None]
    _, h, w, _ = images.shape
    oh, ow = out_hw
    wh = _weights(h, oh, images)
    ww = _weights(w, ow, images)
    out = torch.einsum("oh,nhwc->nowc", wh, images)
    out = torch.einsum("pw,nowc->nopc", ww, out)
    return out[0] if squeeze else out


def pyramid_planes(images, sizes):
    """All pyramid levels of an exact area resize, channel-planar:
    ``images`` [N, H, W, C] -> list of [N, C, oh, ow].

    The row contractions of every level run as one [sum(oh), H] matmul
    against each plane; per-level column matmuls finish each level.
    """
    n, h, w, c = images.shape
    wrow = torch.from_numpy(np.concatenate(
        [_area_weights(h, oh) for oh, _ in sizes], axis=0)).to(
            device=images.device, dtype=images.dtype)
    planes = images.permute(0, 3, 1, 2)
    rows = torch.matmul(wrow, planes)  # [N, C, sum(oh), W]
    outs, off = [], 0
    for oh, ow in sizes:
        wcol = _weights(w, ow, images)
        outs.append(torch.matmul(rows[:, :, off:off + oh, :], wcol.t()))
        off += oh
    return outs


def pyramid_area_resize(images, sizes):
    """``images`` [N, H, W, C] -> list of NHWC levels [N, oh, ow, C]."""
    return [lvl.permute(0, 2, 3, 1)
            for lvl in pyramid_planes(images, sizes)]


# ---------------------------------------------------------------------------
# Integer crop + bilinear resample
# ---------------------------------------------------------------------------


def _bilinear_gather(images, bi, yy, xx, lo_y, hi_y, lo_x, hi_x):
    """Sample images [B, H, W, C] at rows ``bi`` and float coordinates
    yy/xx [K, S, S], clamped to the inclusive float bounds [K, 1, 1];
    returns [K, S, S, C]."""
    yy = torch.minimum(torch.maximum(yy, lo_y), hi_y)
    xx = torch.minimum(torch.maximum(xx, lo_x), hi_x)
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    wy = (yy - y0)[..., None]
    wx = (xx - x0)[..., None]
    h, w = images.shape[1:3]
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    top = images[bi, y0i, x0i] * (1.0 - wx) + images[bi, y0i, x1i] * wx
    bot = images[bi, y1i, x0i] * (1.0 - wx) + images[bi, y1i, x1i] * wx
    return top * (1.0 - wy) + bot * wy


def batched_crop_resize(images, boxes, image_idx, size):
    """Crop a padded face set's (1-based, inclusive, integer-valued float)
    xyxy boxes [K, 4] out of images [B, H, W, C] (row ``image_idx`` [K])
    and resize each to [size, size, C]: bilinear samples at the area-pool
    cell centres, clamped to the crop window ``imgs[y1-1:y2, x1-1:x2]``.
    Returns [K, size, size, C] f32."""
    images = images.to(torch.float32)
    boxes = boxes.to(device=images.device, dtype=torch.float32)
    x1, y1, x2, y2 = (boxes[:, i, None, None] for i in range(4))
    # a tensor divisor (a fill, no copy): CUDA divides by a Python number
    # as a multiply by its reciprocal (an ulp off); the CPU divides
    size_t = torch.full((), float(size), device=images.device)
    sy = (y2 - y1 + 1.0) / size_t
    sx = (x2 - x1 + 1.0) / size_t
    i = torch.arange(size, dtype=torch.float32, device=images.device)
    src_y = (y1 - 1.0) + (i[:, None] + 0.5) * sy - 0.5  # [K, S, 1]
    src_x = (x1 - 1.0) + (i[None, :] + 0.5) * sx - 0.5  # [K, 1, S]
    k = boxes.shape[0]
    yy = src_y.expand(k, size, size)
    xx = src_x.expand(k, size, size)
    bi = image_idx.to(device=images.device, dtype=torch.int64)[:, None, None]
    return _bilinear_gather(images, bi, yy, xx, y1 - 1.0, y2 - 1.0,
                            x1 - 1.0, x2 - 1.0)


def crop_resize_bilinear(img, box, size):
    """One image [H, W, C] and one box [4] -> [size, size, C]
    (``batched_crop_resize`` of a single face)."""
    idx = torch.zeros(1, dtype=torch.int64, device=img.device)
    return batched_crop_resize(img[None], box[None], idx, size)[0]


# ---------------------------------------------------------------------------
# Integer crop + adaptive average pool
# ---------------------------------------------------------------------------


def grouped_crop_area_resize(images, boxes, size):
    """Exact integer crop ``imgs[y1-1:y2, x1-1:x2]`` + adaptive average
    pool to (size, size), grouped per frame: images [B, H, W, 3]
    (uint8-valued), boxes [B, K, 4] 1-based inclusive integer-valued
    floats -> [B, K, S, S, 3] f32. Kernel K4 on the card, its plain
    version on the CPU (``ops.crop``)."""
    return _crop.grouped_crop_area_resize(images, boxes, size)


def batched_crop_area_resize(images, boxes, image_idx, size, integral=None):
    """``grouped_crop_area_resize`` over a flat face set: boxes [K, 4] with
    the same count of faces per frame (K % B == 0) and ``image_idx`` [K]
    block-ordered (faces of frame 0 first, then frame 1, ...), the layout
    of the capacity-padded cascade; ``image_idx`` is therefore not read.
    ``integral`` is accepted, as the JAX package accepts it, and ignored.
    Returns [K, size, size, 3] f32: kernel K4 (integral image, then the
    pool) for CUDA tensors, its plain version for CPU tensors."""
    b, k = images.shape[0], boxes.shape[0]
    if b == 0 or k % b:
        raise ValueError(f"{k} boxes do not split evenly over {b} frames")
    grouped = _crop.grouped_crop_area_resize(
        images, boxes.reshape(b, k // b, 4), size)
    return grouped.reshape(k, size, size, images.shape[-1])


# ---------------------------------------------------------------------------
# Affine warp (face alignment)
# ---------------------------------------------------------------------------


def invert_affine(m):
    """Invert [..., 2, 3] affine matrices (returns [..., 2, 3])."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    inv_a = d / det
    inv_b = -b / det
    inv_c = -c / det
    inv_d = a / det
    inv_tx = -(inv_a * tx + inv_b * ty)
    inv_ty = -(inv_c * tx + inv_d * ty)
    return torch.stack([torch.stack([inv_a, inv_b, inv_tx], -1),
                        torch.stack([inv_c, inv_d, inv_ty], -1)], -2)


def batched_warp_affine(images, image_idx, mats, out_hw, border_value=0.0):
    """Warp a padded face set with forward (src->dst, cv2 convention)
    affine maps: images [B, H, W, C], image_idx [K], mats [K, 2, 3] ->
    [K, out_h, out_w, C], bilinear with a constant border.

    Each of the four bilinear taps falling outside the image contributes
    ``border_value`` (cv2 ``BORDER_CONSTANT``); validity comes from the
    unclipped floor so a far-out point never borrows a clipped in-range
    neighbour.
    """
    out_h, out_w = out_hw
    _, h, w, _ = images.shape
    dev = images.device
    inv = invert_affine(mats.to(torch.float32))
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    inv = inv[:, :, :, None, None]
    src_x = inv[:, 0, 0] * xx + inv[:, 0, 1] * yy + inv[:, 0, 2]
    src_y = inv[:, 1, 0] * xx + inv[:, 1, 1] * yy + inv[:, 1, 2]
    y0 = torch.floor(src_y)
    x0 = torch.floor(src_x)
    wy = (src_y - y0)[..., None]
    wx = (src_x - x0)[..., None]
    vy0 = (y0 >= 0.0) & (y0 <= h - 1.0)
    vy1 = (y0 >= -1.0) & (y0 <= h - 2.0)
    vx0 = (x0 >= 0.0) & (x0 <= w - 1.0)
    vx1 = (x0 >= -1.0) & (x0 <= w - 2.0)
    y0i = torch.clamp(y0, 0.0, h - 1.0).to(torch.int64)
    x0i = torch.clamp(x0, 0.0, w - 1.0).to(torch.int64)
    y1i = torch.clamp(y0 + 1.0, 0.0, h - 1.0).to(torch.int64)
    x1i = torch.clamp(x0 + 1.0, 0.0, w - 1.0).to(torch.int64)
    bi = image_idx.to(torch.int64)[:, None, None]
    border = torch.tensor(border_value, dtype=images.dtype, device=dev)

    def tap(yi, xi, valid):
        return torch.where(valid[..., None], images[bi, yi, xi], border)

    v00 = tap(y0i, x0i, vy0 & vx0)
    v01 = tap(y0i, x1i, vy0 & vx1)
    v10 = tap(y1i, x0i, vy1 & vx0)
    v11 = tap(y1i, x1i, vy1 & vx1)
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def warp_affine(img, m, out_hw, border_value=0.0):
    """Single image: img [H, W, C], m [2, 3] -> [out_h, out_w, C]."""
    idx = torch.zeros(1, dtype=torch.int64, device=img.device)
    return batched_warp_affine(img[None], idx, m[None], out_hw,
                               border_value)[0]


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------


def fixed_image_standardization(x):
    """(x - 127.5) / 128."""
    return (x - 127.5) / 128.0


def prewhiten(x):
    """Mean/std whitening of ``x`` as one image: (x - mean) / std, the
    population std floored at 1 / sqrt(x.numel())."""
    mean = x.mean()
    std = x.std(correction=0)
    return (x - mean) / torch.clamp(std, min=1.0 / math.sqrt(x.numel()))


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(x):
    """NHWC float in [0, 1] -> ImageNet-normalised, in x's dtype."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std
