"""K4: exact grouped integer crop + adaptive average pool.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/crop_pallas.py``
(``grouped_crop_area_resize_pallas``) and of the XLA
``ops/image.grouped_crop_area_resize``: integer crops
``img[y1-1:y2, x1-1:x2]`` of many boxes per frame, pooled to S x S as
torch's ``adaptive_avg_pool2d`` does, bit-exact on uint8 pixels.

Both versions read an int32 integral image with four corner reads per
output cell. ``integral_image`` builds it (two launches of
``csrc/crop_area_pool.cu`` for CUDA tensors: band totals, then one scan
that writes each entry once; ``torch.cumsum`` for CPU tensors); the
cascade builds it once per chunk and hands it to PNet's pyramid (K2) and
both crop stages. ``crop_area_pool`` pools: the plain version computes the
cell bounds here in f32, as the reference does (``pool_tables``); the
kernel (one launch for CUDA tensors) computes the same f32 arithmetic
itself from the boxes.

Frames of any size are taken. The prefix sums wrap modulo 2**32 (a
frame of more than 8,421,504 pixels overflows int32), and the four-corner
difference is taken modulo 2**32 as well, so it equals the cell's true
sum whenever that sum fits in int32: a cell of at most 8,421,504 pixels
of 255. A 24-cell pool of a whole 4032x3024 frame sums at most
168 x 126 x 255, about 5.4 M, per cell.
"""

import ctypes

import torch

from ..utils import kernels

BAND = 64  # rows a band of the integral-image scan (csrc kBand)


def wrap_int32(t):
    """int64 -> int32 modulo 2**32 (two's complement), without relying on
    how a cast treats values out of range."""
    return (torch.remainder(t + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def _area_pool_bounds(lo, hi, size):
    """Adaptive-pool cell bounds along one axis, computed in f32 exactly
    as the reference does. lo/hi: [K] 1-based inclusive crop bounds.
    Returns (p0, p1) [K, size] absolute 0-based pixel bounds (floats)."""
    o = torch.arange(size, dtype=torch.float32, device=lo.device)
    extent = hi - lo + 1.0
    r0 = torch.floor(o[None, :] * extent[:, None] / size)
    r1 = torch.ceil((o[None, :] + 1.0) * extent[:, None] / size)
    r1 = torch.minimum(torch.maximum(r1, r0 + 1.0), extent[:, None])
    return lo[:, None] - 1.0 + r0, lo[:, None] - 1.0 + r1


def _clamped_index(p, size):
    return torch.clamp(p, 0.0, float(size)).to(torch.int32)


def pool_tables(boxes, size, h, w):
    """boxes [B, K, 4] -> the kernel's cell tables: (y0, y1, x0, x1)
    [B*K, S] int32 integral-image bounds clamped to the frame (an empty
    or inverted cell gets y1 = y0 or x1 = x0) and (wy, wx) [B*K, S] f32
    unclamped cell extents."""
    flat = boxes.reshape(-1, 4).to(torch.float32)
    py0, py1 = _area_pool_bounds(flat[:, 1], flat[:, 3], size)
    px0, px1 = _area_pool_bounds(flat[:, 0], flat[:, 2], size)
    y0 = _clamped_index(py0, h)
    y1 = torch.maximum(_clamped_index(py1, h), y0)
    x0 = _clamped_index(px0, w)
    x1 = torch.maximum(_clamped_index(px1, w), x0)
    return (y0, y1, x0, x1), (py1 - py0, px1 - px0)


def _check_frames(images):
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be [B, H, W, 3], got "
                         f"{tuple(images.shape)}")


# ---------------------------------------------------------------------------
# The integral image
# ---------------------------------------------------------------------------


def integral_image_plain(images):
    """Zero-padded 2-D prefix sums [B, H, W, 3] -> [B, H+1, W+1, 3] int32
    of uint8-valued pixels, wrapped modulo 2**32 (summed in int64, then
    wrapped), as the kernel's uint32 scans leave them."""
    _check_frames(images)
    px = torch.round(images.to(torch.float32)).to(torch.int64)
    s = wrap_int32(torch.cumsum(torch.cumsum(px, dim=1), dim=2))
    return torch.nn.functional.pad(s, (0, 0, 1, 0, 1, 0))


def integral_image_kernel(images):
    """The same prefix sums from the CUDA kernel's two launches, band
    totals and the band scan (CUDA tensors; uint8, or uint8-valued floats
    that are rounded first)."""
    _check_frames(images)
    if images.dtype != torch.uint8:
        images = torch.round(images.to(torch.float32)).to(torch.uint8)
    images = images.contiguous()
    kernels.require_cuda_tensor(images, "images", torch.uint8)
    b, h, w, _ = images.shape
    integ = torch.empty((b, h + 1, w + 1, 3), dtype=torch.int32,
                        device=images.device)
    if b == 0 or h == 0 or w == 0:
        return integ.zero_()
    # the band totals: every band's but the last (one for a one-band frame)
    bands = -(-h // BAND)
    totals = torch.empty(b * max(bands - 1, 1) * w * 3, dtype=torch.int32,
                         device=images.device)
    lib = kernels.library()
    stream = torch.cuda.current_stream(images.device).cuda_stream
    launched = ctypes.c_int(0)
    err = lib.vn_integral_image(images.data_ptr(), integ.data_ptr(),
                                totals.data_ptr(), b, h, w, stream,
                                ctypes.byref(launched))
    kernels.count_launch("crop_area_resize", launched.value)
    kernels.check_cuda(err, "vn_integral_image")
    return integ


def integral_image(images):
    """[B, H, W, 3] uint8-valued frames -> [B, H+1, W+1, 3] int32. CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if images.is_cuda:
        return integral_image_kernel(images)
    if images.device.type != "cpu":
        raise ValueError(f"unsupported device {images.device}")
    return integral_image_plain(images)


# ---------------------------------------------------------------------------
# Crop + pool
# ---------------------------------------------------------------------------


def _check_boxes(integ, boxes):
    if integ.dim() != 4 or integ.shape[-1] != 3 or integ.dtype != torch.int32:
        raise ValueError("integ must be an int32 [B, H+1, W+1, 3] integral "
                         "image")
    if boxes.dim() != 3 or boxes.shape[0] != integ.shape[0] \
            or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [{integ.shape[0]}, K, 4], got "
                         f"{tuple(boxes.shape)}")


def crop_area_pool_plain(integ, boxes, size):
    """Integral image [B, H+1, W+1, 3] int32 + boxes [B, K, 4] (1-based
    inclusive integer-valued floats, ``clamp_boxes`` output) ->
    [B, K, S, S, 3] f32: four corner reads per cell, their difference
    modulo 2**32 (the true cell sum, since it fits in int32), then the
    f32 division by the unclamped cell area the reference performs."""
    _check_boxes(integ, boxes)
    b, k = boxes.shape[:2]
    h, w = integ.shape[1] - 1, integ.shape[2] - 1
    (y0, y1, x0, x1), (wy, wx) = pool_tables(boxes, size, h, w)
    y0, y1, x0, x1 = (t.to(torch.int64) for t in (y0, y1, x0, x1))
    bi = torch.arange(b, device=integ.device).repeat_interleave(k)
    bi = bi[:, None, None]
    ya, yb = y0[:, :, None], y1[:, :, None]
    xa, xb = x0[:, None, :], x1[:, None, :]

    def corner(y, x):
        return integ[bi, y, x].to(torch.int64)

    sums = wrap_int32(corner(yb, xb) - corner(ya, xb) - corner(yb, xa)
                      + corner(ya, xa))  # [BK, S, S, 3]
    norm = (wy[:, :, None] * wx[:, None, :])[..., None]
    out = sums.to(torch.float32) / torch.clamp(norm, min=1.0)
    return out.reshape(b, k, size, size, 3)


def crop_area_pool_kernel(integ, boxes, size):
    """The same pool from one launch of the CUDA kernel, which computes
    the cell bounds of ``pool_tables`` from the boxes itself (CUDA tensors
    only)."""
    _check_boxes(integ, boxes)
    b, k = boxes.shape[:2]
    h, w = integ.shape[1] - 1, integ.shape[2] - 1
    integ = integ.contiguous()
    kernels.require_cuda_tensor(integ, "integ", torch.int32)
    boxes = boxes.to(torch.float32).contiguous()
    kernels.require_cuda_tensor(boxes, "boxes")
    if boxes.data_ptr() % 16:  # the kernel reads a box as one float4
        boxes = boxes.clone()
    out = torch.empty((b, k, size, size, 3), dtype=torch.float32,
                      device=integ.device)
    if b * k == 0:
        return out
    lib = kernels.library()
    stream = torch.cuda.current_stream(integ.device).cuda_stream
    err = lib.vn_crop_area_pool(integ.data_ptr(), boxes.data_ptr(),
                                out.data_ptr(), b, k, h, w, size, stream)
    kernels.check_cuda(err, "vn_crop_area_pool")
    kernels.count_launch("crop_area_resize")
    return out


def crop_area_pool(integ, boxes, size):
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    if integ.is_cuda:
        return crop_area_pool_kernel(integ, boxes, size)
    if integ.device.type != "cpu":
        raise ValueError(f"unsupported device {integ.device}")
    return crop_area_pool_plain(integ, boxes, size)


def grouped_crop_area_resize_plain(images, boxes, size):
    """Exact integer crop ``imgs[y1-1:y2, x1-1:x2]`` + adaptive average
    pool to (size, size), grouped per frame, in plain torch.

    images: [B, H, W, 3] uint8-valued; boxes: [B, K, 4] 1-based inclusive
    integer-valued floats (``clamp_boxes`` output). Returns
    [B, K, S, S, 3] f32."""
    return crop_area_pool_plain(integral_image_plain(images), boxes, size)


def grouped_crop_area_resize(images, boxes, size):
    """images [B, H, W, 3] (uint8-valued), boxes [B, K, 4] ->
    [B, K, S, S, 3] f32: the integral image and the pool, each through
    its kernel for CUDA tensors and its plain version for CPU tensors."""
    return crop_area_pool(integral_image(images), boxes, size)
