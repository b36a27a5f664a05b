"""Online augmentation on the device: ``facenet_aug``.

Counterpart of ``facenet_aug`` in ``vn_celeb_face_recognition_tpu/ops/
augment.py``: rotate by deg ~ U(-10, 10) about the image centre, pad by 2
and crop ``out_size`` at offsets y0, x0 in {0..h + 4 - out_size}, flip
left-right with probability 0.5, then ``fixed_image_standardization``.

The rotation and the crop together are one similarity, so each image is
warped once by kernel K1 (``ops.warp``): the frames form reads the uint8
batch directly (each image is its own window), the windows form takes a
float batch. Where the sequential crop would read the 2 px zero pad, the
folded warp samples real pixels; that band is masked to 0, as the JAX
package's ``facenet_aug_batch`` masks it. The flip is not a similarity
(its determinant is -1) and stays a flip of the warped image.

* ``facenet_aug_params(gen, b, h, w, out_size)`` draws the geometry from
  ``gen`` on its device and folds it as the JAX ``_facenet_aug_params``
  does: (mats [b, 2, 3] forward src -> dst, offs [b, 2] the crop origin
  (oy, ox) in the unpadded image, flip [b] bool);
* ``facenet_aug_warp(images, mats, offs, flip, out_size)``: the warp,
  pad-band mask and flip, in pixel units;
* ``facenet_aug_apply(...)``: that, standardised;
* ``facenet_aug(gen, images, out_size=None)``: draw, then apply.

The eight photometric augmenters of ``rank1_vn_celeb_aug`` are not
ported yet (ROADMAP.md, A.6).
"""

import math

import torch

from .image import fixed_image_standardization
from .warp import similarity_warp, similarity_warp_frames

# facenet_aug's geometry, fixed by its definition: the zero pad around the
# image before the crop, and the rotation range in degrees
PADDING = 2
DEGREES = 10.0


def facenet_aug_params(gen, b, h, w, out_size):
    """Draw ``b`` images' facenet_aug geometry from ``gen`` (on its
    device): deg ~ U(-DEGREES, DEGREES); crop offsets in the padded image
    y0 in {0..h + 2 PADDING - out_size} (x0 likewise), flip ~
    Bernoulli(0.5). Returns (mats [b, 2, 3] f32, the rotation about the
    centre then the crop as one forward map; offs [b, 2] int64, (y0, x0)
    - PADDING; flip [b] bool)."""
    dev = gen.device
    max_y = h + 2 * PADDING - out_size
    max_x = w + 2 * PADDING - out_size
    if max_y < 0 or max_x < 0:
        raise ValueError(f"crop {out_size} does not fit {h}x{w} padded by "
                         f"{PADDING}")
    deg = torch.rand(b, generator=gen, device=dev) * (2 * DEGREES) - DEGREES
    y0 = torch.randint(0, max_y + 1, (b,), generator=gen, device=dev)
    x0 = torch.randint(0, max_x + 1, (b,), generator=gen, device=dev)
    flip = torch.rand(b, generator=gen, device=dev) < 0.5
    return fold_facenet_aug(deg, y0, x0, h, w) + (flip,)


def fold_facenet_aug(deg, y0, x0, h, w):
    """Rotation by ``deg`` about the centre, then the crop at (y0, x0) of
    the padded plane, as one forward similarity per image, in f32 as the
    JAX ``_facenet_aug_params`` computes it. Returns (mats [b, 2, 3],
    offs [b, 2] = (y0, x0) - PADDING)."""
    rad = deg.to(torch.float32) * math.pi / 180.0
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos, sin = torch.cos(rad), torch.sin(rad)
    # the crop at offset (y0, x0) of the padded plane is a translation by
    # -(offset - PADDING) after the centre rotation
    tx = cx - cos * cx + sin * cy - (x0.to(torch.float32) - PADDING)
    ty = cy - sin * cx - cos * cy - (y0.to(torch.float32) - PADDING)
    mats = torch.stack([torch.stack([cos, -sin, tx], -1),
                        torch.stack([sin, cos, ty], -1)], 1)
    offs = torch.stack([y0 - PADDING, x0 - PADDING], -1).to(torch.int64)
    return mats, offs


def facenet_aug_warp(images, mats, offs, flip, out_size):
    """images [B, H, W, 3] (uint8 through K1's frames form, float through
    its windows form; square) -> [B, S, S, 3] f32 in pixel units: the
    folded warp, the pad band zeroed and the flipped images mirrored."""
    b, h, w, _ = images.shape
    if h != w:
        raise ValueError(f"facenet_aug warps square images through K1, got "
                         f"{h}x{w}")
    dev = images.device
    mats = mats.to(device=dev, dtype=torch.float32)
    if images.dtype == torch.uint8:
        zeros = torch.zeros(b, dtype=torch.int32, device=dev)
        idx = torch.arange(b, dtype=torch.int32, device=dev)
        out = similarity_warp_frames(images, idx, zeros, zeros, h, mats,
                                     out_size)
    else:
        out = similarity_warp(images, mats, out_size)
    offs = offs.to(dev)
    ys = torch.arange(out_size, device=dev)[None, :]
    row_ok = (ys + offs[:, :1] >= 0) & (ys + offs[:, :1] < h)
    col_ok = (ys + offs[:, 1:] >= 0) & (ys + offs[:, 1:] < w)
    band = (row_ok[:, :, None] & col_ok[:, None, :])[..., None]
    out = torch.where(band, out, torch.zeros((), device=dev))
    flip = flip.to(dev)[:, None, None, None]
    return torch.where(flip, out.flip(2), out)


def facenet_aug_apply(images, mats, offs, flip, out_size):
    """``facenet_aug_warp``, then ``fixed_image_standardization``."""
    return fixed_image_standardization(
        facenet_aug_warp(images, mats, offs, flip, out_size))


def facenet_aug(gen, images, out_size=None):
    """facenet_aug of a batch [B, H, W, 3] with geometry drawn from
    ``gen``; ``out_size`` None keeps the input size (a +-2 px jitter)."""
    b, h, w, _ = images.shape
    if out_size is None:
        out_size = h
    mats, offs, flip = facenet_aug_params(gen, b, h, w, out_size)
    return facenet_aug_apply(images, mats, offs, flip, out_size)
