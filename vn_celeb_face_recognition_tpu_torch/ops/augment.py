"""Online augmentation on the device: ``facenet_aug`` and
``rank1_vn_celeb_aug``.

Counterparts of the pipelines in ``vn_celeb_face_recognition_tpu/ops/
augment.py``. Each is split in two: a draw, ``*_params(gen, b)``, which
takes the parameters of ``b`` images from a ``torch.Generator`` on its
device, and an apply, which computes the batch from those parameters.

``facenet_aug``: rotate by deg ~ U(-10, 10) about the image centre, pad by 2
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

``rank1_vn_celeb_aug``: flip left-right with probability 0.5; with
probability 0.8 apply one of eight photometric augmenters, chosen
uniformly; then ``prewhiten``. The augmenters act on float images in
[0, 255] with the JAX package's arithmetic (not imgaug's):

* grayscale: blend towards the 0.299 / 0.587 / 0.114 luma by alpha ~ U(0, 1);
* hue and saturation: shifts ~ U(-20, 20) / 255 in HSV, the hue wrapped
  (a floor modulo), the saturation clipped, no clip after the way back;
* add ~ U(-20, 20) and multiply ~ U(0.5, 1.5): one value a channel with
  probability 0.5, else one for the image; clipped to [0, 255];
* gaussian blur: sigma ~ U(0, 2) floored at 1e-3, a 9-tap separable
  kernel normalised to 1, zero padding (the borders darken), no clip;
* contrast: (x - 127.5) alpha + 127.5, alpha ~ U(0.5, 2) a channel or
  for the image, clipped;
* sharpen and emboss: a 3x3 matrix applied as a zero-padded
  cross-correlation (``F.conv2d``; the emboss matrix is not symmetric),
  blended by alpha ~ U(0, 0.5), clipped.

``*_params(gen, b)`` / ``*_apply(images, params)`` exist for each
augmenter (``grayscale``, ``hue_saturation``, ``add``, ``multiply``,
``gaussian_blur``, ``contrast``, ``sharpen``, ``emboss``; ``RANK1_OPS``
in the JAX package's order) and for the pipeline
(``rank1_vn_celeb_aug_params`` / ``_apply``); ``rank1_vn_celeb_aug(gen,
images)`` draws, then applies. The batch is grouped by augmenter and
each augmenter runs once on its group.
"""

import math

import torch
import torch.nn.functional as F

from .image import fixed_image_standardization, prewhiten
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


# ---------------------------------------------------------------------------
# rank1_vn_celeb_aug
# ---------------------------------------------------------------------------

# the ranges of the JAX package's augmenters
SHIFT = 20.0  # hue/saturation (in 1/255 units), add
MULTIPLY = (0.5, 1.5)
SIGMA = (0.0, 2.0)
BLUR_RADIUS = 4
CONTRAST = (0.5, 2.0)
ALPHA = (0.0, 0.5)  # sharpen and emboss
LIGHTNESS = (0.7, 1.3)
STRENGTH = (0.0, 1.5)
FLIP_P, APPLY_P = 0.5, 0.8


def rgb_to_hsv(rgb):
    """RGB in [0, 1] -> HSV in [0, 1], on the last axis. Where two
    channels share the maximum the hue takes r's formula, then g's; it is
    0 where the channels are equal."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12),
                    torch.zeros((), device=rgb.device))
    safe_delta = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0.0, torch.zeros((), device=rgb.device), h)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv):
    """HSV in [0, 1] -> RGB, on the last axis (no clip)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    # the sextant picks each channel from (v, q, p, t)
    sextant = torch.remainder(i.to(torch.int64), 6)
    table = torch.stack([v, q, p, t], dim=-1)
    pick = torch.tensor([[0, 3, 2], [1, 0, 2], [2, 0, 3], [2, 1, 0],
                         [3, 2, 0], [0, 2, 1]], device=hsv.device)
    return torch.gather(table, -1, pick[sextant])


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) \
        + lo


def _per_channel_or_image(gen, b, lo, hi):
    """[b, 3]: with probability 0.5 one value ~ U(lo, hi) a channel, else
    one for the image."""
    per_channel = torch.rand(b, generator=gen, device=gen.device) < 0.5
    channels = _uniform(gen, (b, 3), lo, hi)
    image = _uniform(gen, (b, 1), lo, hi)
    return torch.where(per_channel[:, None], channels, image)


def _image(v):
    """[n] or [n, C] per-image values, broadcast over [n, H, W, C]."""
    return v[:, None, None, None] if v.dim() == 1 else v[:, None, None, :]


def grayscale_params(gen, b):
    return {"alpha": _uniform(gen, (b,), 0.0, 1.0)}


def grayscale_apply(images, p):
    alpha = _image(p["alpha"])
    gray = (0.299 * images[..., 0] + 0.587 * images[..., 1]
            + 0.114 * images[..., 2])[..., None]
    return (1.0 - alpha) * images + alpha * gray


def hue_saturation_params(gen, b):
    return {"hue": _uniform(gen, (b,), -SHIFT, SHIFT),
            "saturation": _uniform(gen, (b,), -SHIFT, SHIFT)}


def hue_saturation_apply(images, p):
    hsv = rgb_to_hsv(torch.clamp(images / 255.0, 0.0, 1.0))
    h = torch.remainder(hsv[..., 0] + (p["hue"] / 255.0)[:, None, None], 1.0)
    s = torch.clamp(hsv[..., 1] + (p["saturation"] / 255.0)[:, None, None],
                    0.0, 1.0)
    return hsv_to_rgb(torch.stack([h, s, hsv[..., 2]], dim=-1)) * 255.0


def add_params(gen, b):
    return {"add": _per_channel_or_image(gen, b, -SHIFT, SHIFT)}


def add_apply(images, p):
    return torch.clamp(images + _image(p["add"]), 0.0, 255.0)


def multiply_params(gen, b):
    return {"mul": _per_channel_or_image(gen, b, *MULTIPLY)}


def multiply_apply(images, p):
    return torch.clamp(images * _image(p["mul"]), 0.0, 255.0)


def gaussian_blur_params(gen, b):
    return {"sigma": _uniform(gen, (b,), *SIGMA)}


def gaussian_kernels(sigma):
    """[n] sigmas -> [n, 2 BLUR_RADIUS + 1] normalised gaussian taps."""
    x = torch.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, dtype=torch.float32,
                     device=sigma.device)
    k = torch.exp(-0.5 * (x / sigma[:, None]) ** 2)
    return k / k.sum(dim=1, keepdim=True)


def _per_image_conv(images, weight, padding):
    """Each image's channels through its own single-channel filter:
    images [n, H, W, C], weight [n, kh, kw] -> [n, H, W, C] (a
    cross-correlation, zero padding)."""
    n, h, w, c = images.shape
    x = images.permute(0, 3, 1, 2).reshape(1, n * c, h, w)
    wt = weight.repeat_interleave(c, dim=0)[:, None]
    out = F.conv2d(x, wt, padding=padding, groups=n * c)
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1)


def gaussian_blur_apply(images, p):
    k = gaussian_kernels(torch.clamp(p["sigma"], min=1e-3))
    out = _per_image_conv(images, k[:, :, None], (BLUR_RADIUS, 0))
    return _per_image_conv(out, k[:, None, :], (0, BLUR_RADIUS))


def contrast_params(gen, b):
    return {"alpha": _per_channel_or_image(gen, b, *CONTRAST)}


def contrast_apply(images, p):
    return torch.clamp((images - 127.5) * _image(p["alpha"]) + 127.5, 0.0,
                       255.0)


def conv3x3_per_channel(images, kernels):
    """images [n, H, W, C], kernels [n, 3, 3]: every channel of image i
    cross-correlated with kernels[i], zero padded."""
    return _per_image_conv(images, kernels, 1)


def sharpen_params(gen, b):
    return {"alpha": _uniform(gen, (b,), *ALPHA),
            "lightness": _uniform(gen, (b,), *LIGHTNESS)}


def sharpen_kernels(lightness):
    """[n] -> [n, 3, 3]: -1 around a centre of 8 + lightness."""
    k = torch.full((lightness.shape[0], 3, 3), -1.0, device=lightness.device)
    k[:, 1, 1] = 8.0 + lightness
    return k


def emboss_params(gen, b):
    return {"alpha": _uniform(gen, (b,), *ALPHA),
            "strength": _uniform(gen, (b,), *STRENGTH)}


def emboss_kernels(strength):
    """[n] -> [n, 3, 3]: [[-1-s, -s, 0], [-s, 1, s], [0, s, 1+s]]."""
    s = strength
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([
        torch.stack([-1.0 - s, 0.0 - s, zero], -1),
        torch.stack([0.0 - s, one, 0.0 + s], -1),
        torch.stack([zero, 0.0 + s, 1.0 + s], -1)], 1)


def _blend(images, effect, alpha):
    alpha = _image(alpha)
    return torch.clamp((1.0 - alpha) * images + alpha * effect, 0.0, 255.0)


def sharpen_apply(images, p):
    sharp = conv3x3_per_channel(images, sharpen_kernels(p["lightness"]))
    return _blend(images, sharp, p["alpha"])


def emboss_apply(images, p):
    embossed = conv3x3_per_channel(images, emboss_kernels(p["strength"]))
    return _blend(images, embossed, p["alpha"])


# (name, draw, apply) in the order of the JAX package's _RANK1_OPS
RANK1_OPS = (
    ("grayscale", grayscale_params, grayscale_apply),
    ("hue_saturation", hue_saturation_params, hue_saturation_apply),
    ("add", add_params, add_apply),
    ("multiply", multiply_params, multiply_apply),
    ("gaussian_blur", gaussian_blur_params, gaussian_blur_apply),
    ("contrast", contrast_params, contrast_apply),
    ("sharpen", sharpen_params, sharpen_apply),
    ("emboss", emboss_params, emboss_apply),
)


def rank1_vn_celeb_aug_params(gen, b):
    """Draw ``b`` images' rank1 parameters from ``gen`` (on its device):
    ``flip`` [b] bool ~ Bernoulli(0.5), ``apply`` [b] bool ~
    Bernoulli(0.8), ``op`` [b] int64 ~ U{0..7} (an index into
    ``RANK1_OPS``), and ``ops``, every augmenter's parameters for all
    ``b`` images (each image uses those of its ``op``)."""
    dev = gen.device
    flip = torch.rand(b, generator=gen, device=dev) < FLIP_P
    apply = torch.rand(b, generator=gen, device=dev) < APPLY_P
    op = torch.randint(0, len(RANK1_OPS), (b,), generator=gen, device=dev)
    ops = [draw(gen, b) for _, draw, _ in RANK1_OPS]
    return {"flip": flip, "apply": apply, "op": op, "ops": ops}


def rank1_vn_celeb_aug_apply(images, params):
    """images [B, H, W, 3] (any real or uint8 dtype, in [0, 255]) ->
    [B, H, W, 3] f32: the flip, then each image's augmenter where
    ``apply`` is set, then ``prewhiten`` per image."""
    dev = images.device
    x = images.to(torch.float32)
    flip, apply, op = (params[k].to(dev) for k in ("flip", "apply", "op"))
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    # group the images by augmenter (the last group takes none): one copy
    # of the group sizes to the host, then one call of each augmenter
    n_ops = len(RANK1_OPS)
    key = torch.where(apply, op, torch.full_like(op, n_ops))
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=n_ops + 1).tolist()
    out = x.clone()
    start = 0
    for (_, _, fn), p, n in zip(RANK1_OPS, params["ops"], counts):
        if n:
            idx = order[start:start + n]
            out[idx] = fn(x[idx], {k: v.to(dev)[idx] for k, v in p.items()})
        start += n
    return torch.vmap(prewhiten)(out)


def rank1_vn_celeb_aug(gen, images):
    """rank1_vn_celeb_aug of a batch [B, H, W, 3] with parameters drawn
    from ``gen``."""
    return rank1_vn_celeb_aug_apply(
        images, rank1_vn_celeb_aug_params(gen, images.shape[0]))
