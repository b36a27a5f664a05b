"""K1: per-face similarity warp into aligned faces.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/warp_pallas.py``
(``batched_similarity_warp_pallas``). The CUDA kernel is
``csrc/similarity_warp.cu``; it computes the exact bilinear
``warp_affine`` rather than the TPU kernel's 3-shear factorisation.

Two forms of one kernel:

* ``similarity_warp(windows, mats, S)``: f32 windows [K, N, N, 3], one per
  face, as the TPU kernel takes them;
* ``similarity_warp_frames(frames, image_idx, oy, ox, win, mats, S)``: the
  uint8 frames [B, H, W, 3] and, per face, a frame index and the origin of
  its ``win`` x ``win`` window. It equals cutting the windows, casting them
  to f32 and warping them, bit for bit, without the window stack.

Each takes its plain PyTorch version for CPU tensors only and launches the
kernel for CUDA tensors. ``footprint_boxes`` is the kernel's rule for the
source box that each output tile stages in shared memory;
``kernel_footprint_boxes`` reads the same boxes from the kernel's own code
on the card, so the two can be held equal.
"""

import functools

import torch

from ..utils import kernels
from .image import batched_warp_affine, invert_affine

TILE = 16  # output tile side
# bytes of one stage buffer, by source type: csrc/similarity_warp.cu's
# Stage<T>::kBytes, held equal through kernel_footprint_boxes
STAGE_BYTES = {torch.uint8: 14 * 1024, torch.float32: 22 * 1024}


def _check(windows, mats):
    if windows.dim() != 4 or windows.shape[1] != windows.shape[2] \
            or windows.shape[3] != 3:
        raise ValueError(f"windows must be [K, N, N, 3], got "
                         f"{tuple(windows.shape)}")
    if mats.shape != (windows.shape[0], 2, 3):
        raise ValueError(f"mats must be [K, 2, 3], got {tuple(mats.shape)}")


def _check_frames(frames, image_idx, oy, ox, win, mats):
    if frames.dim() != 4 or frames.shape[3] != 3:
        raise ValueError(f"frames must be [B, H, W, 3], got "
                         f"{tuple(frames.shape)}")
    k = mats.shape[0]
    if mats.shape != (k, 2, 3):
        raise ValueError(f"mats must be [K, 2, 3], got {tuple(mats.shape)}")
    for name, t in (("image_idx", image_idx), ("oy", oy), ("ox", ox)):
        if t.shape != (k,):
            raise ValueError(f"{name} must be [{k}], got {tuple(t.shape)}")
    if not 2 <= win <= min(frames.shape[1], frames.shape[2]):
        raise ValueError(f"window side {win} does not fit frames "
                         f"{tuple(frames.shape[1:3])}")


def cut_windows(frames, image_idx, oy, ox, win):
    """[B, H, W, 3] frames -> the [K, win, win, 3] f32 windows at
    ``frames[image_idx, oy:oy + win, ox:ox + win]``."""
    ar = torch.arange(win, device=frames.device)
    idx, oy, ox = (t.to(torch.int64) for t in (image_idx, oy, ox))
    return frames[idx[:, None, None], oy[:, None, None] + ar[None, :, None],
                  ox[:, None, None] + ar[None, None, :]].to(torch.float32)


def similarity_warp_plain(windows, mats, out_size):
    """windows [K, N, N, 3] f32, mats [K, 2, 3] -> [K, S, S, 3] f32 with
    ``ops.image.batched_warp_affine``, one window per face."""
    _check(windows, mats)
    idx = torch.arange(windows.shape[0], device=windows.device)
    return batched_warp_affine(windows.to(torch.float32), idx, mats,
                               (out_size, out_size))


def similarity_warp_frames_plain(frames, image_idx, oy, ox, win, mats,
                                 out_size):
    """The frames form as the cut + cast + windows-form warp."""
    _check_frames(frames, image_idx, oy, ox, win, mats)
    return similarity_warp_plain(cut_windows(frames, image_idx, oy, ox, win),
                                 mats, out_size)


def _launch(src, image_idx, oy, ox, mats, out_size, n_img, h, w, win):
    k = mats.shape[0]
    strips = -(-out_size // TILE)  # one thread block per strip of a face
    if k * strips > 2 ** 31 - 1:
        raise ValueError(f"at most {(2 ** 31 - 1) // strips} faces of "
                         f"{out_size} px per launch, got {k}")
    mats = mats.to(torch.float32).contiguous()
    kernels.require_cuda_tensor(mats, "mats", torch.float32)
    if mats.device != src.device:
        raise ValueError("the source and mats must be on the same device")
    out = torch.empty((k, out_size, out_size, 3), dtype=torch.float32,
                      device=src.device)
    lib = kernels.library()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    ptrs = [None if t is None else t.data_ptr()
            for t in (image_idx, oy, ox)]
    err = lib.vn_similarity_warp(src.data_ptr(), int(src.dtype == torch.uint8),
                                 *ptrs, mats.data_ptr(), out.data_ptr(), k,
                                 n_img, h, w, win, out_size, stream)
    kernels.check_cuda(err, "vn_similarity_warp")
    kernels.count_launch("similarity_warp")
    return out


def similarity_warp_kernel(windows, mats, out_size):
    """The windows form through the CUDA kernel (CUDA tensors only)."""
    _check(windows, mats)
    k, n = windows.shape[0], windows.shape[1]
    windows = windows.to(torch.float32).contiguous()
    kernels.require_cuda_tensor(windows, "windows", torch.float32)
    return _launch(windows, None, None, None, mats, out_size, k, n, n, n)


def similarity_warp_frames_kernel(frames, image_idx, oy, ox, win, mats,
                                  out_size):
    """The frames form through the CUDA kernel (CUDA tensors only):
    uint8 frames, int origins (clamped into the frame on the card)."""
    _check_frames(frames, image_idx, oy, ox, win, mats)
    frames = frames.contiguous()
    kernels.require_cuda_tensor(frames, "frames", torch.uint8)
    per_face = [t.to(device=frames.device, dtype=torch.int32).contiguous()
                for t in (image_idx, oy, ox)]
    b, h, w = frames.shape[:3]
    return _launch(frames, *per_face, mats, out_size, b, h, w, int(win))


def similarity_warp(windows, mats, out_size):
    """windows [K, N, N, 3], mats [K, 2, 3] -> [K, S, S, 3] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    if windows.is_cuda:
        return similarity_warp_kernel(windows, mats, out_size)
    if windows.device.type != "cpu":
        raise ValueError(f"unsupported device {windows.device}")
    return similarity_warp_plain(windows, mats, out_size)


def similarity_warp_frames(frames, image_idx, oy, ox, win, mats, out_size):
    """frames [B, H, W, 3] uint8, per face image_idx, oy, ox [K] (the window
    ``frames[i, oy:oy + win, ox:ox + win]`` lies inside the frame) and
    mats [K, 2, 3] (window -> face) -> [K, S, S, 3] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    if frames.is_cuda:
        return similarity_warp_frames_kernel(frames, image_idx, oy, ox, win,
                                             mats, out_size)
    if frames.device.type != "cpu":
        raise ValueError(f"unsupported device {frames.device}")
    return similarity_warp_frames_plain(frames, image_idx, oy, ox, win, mats,
                                        out_size)


@torch.no_grad()
def footprint_boxes(mats, out_size, win, src_dtype=torch.uint8):
    """The source box each output tile of the kernel stages.

    The kernel inverts each face's matrix, maps the tile's four corner
    pixels with the warp's own rounded arithmetic, and takes the floor of
    the smallest and largest coordinate, widened by one pixel each side
    (taps x0 = floor(sx) and x0 + 1, and a margin against rounding), then
    clipped to the window with fmin/fmax, which drop NaN: a NaN matrix
    gives the box [0, 0]. The box is staged when its rows, each padded to
    an odd number of whole aligned 16-byte chunks, fit a stage buffer;
    otherwise every tap of the tile reads device memory. Valid taps
    outside a staged box also read device memory.

    mats [K, 2, 3] -> (boxes [K, T, T, 4] int64 as (by0, by1, bx0, bx1),
    staged [K, T, T] bool), T = ceil(out_size / 16)."""
    inv = invert_affine(mats.to(torch.float32))
    t = -(-out_size // TILE)
    lo = torch.arange(t, dtype=torch.float32) * TILE
    hi = torch.clamp(lo + TILE, max=out_size) - 1.0
    corners = [(xs, ys) for ys in (lo, hi) for xs in (lo, hi)]

    def coord(row, xs, ys):
        i0, i1, i2 = (inv[:, row, j, None, None] for j in range(3))
        return (i0 * xs[None, None, :] + i1 * ys[None, :, None]) + i2

    hm1 = float(win - 1)

    def span(row):
        vals = [coord(row, xs, ys) for xs, ys in corners]
        low = functools.reduce(torch.fmin, vals)
        high = functools.reduce(torch.fmax, vals)
        zero = torch.zeros((), dtype=torch.float32)
        top = torch.tensor(hm1, dtype=torch.float32)
        a = torch.fmin(torch.fmax(torch.floor(low) - 1.0, zero), top)
        b = torch.fmin(torch.fmax(torch.floor(high) + 2.0, zero), top)
        a = a.to(torch.int64)
        return a, torch.maximum(b.to(torch.int64), a)

    by0, by1 = span(1)
    bx0, bx1 = span(0)
    elem = torch.tensor([], dtype=src_dtype).element_size()
    pitch = ((bx1 - bx0 + 1) * 3 // (16 // elem) + 2) | 1
    staged = (by1 - by0 + 1) * pitch <= STAGE_BYTES[src_dtype] // 16
    return torch.stack([by0, by1, bx0, bx1], -1), staged


@torch.no_grad()
def kernel_footprint_boxes(mats, out_size, win, src_dtype=torch.uint8):
    """``footprint_boxes`` as the kernel computes it (CUDA tensors only):
    the same (boxes, staged), from the box rule and stage sizes of
    ``csrc/similarity_warp.cu``. A check, not a step of the warp: it
    counts no launch."""
    if src_dtype not in STAGE_BYTES:
        raise ValueError(f"the kernel stages uint8 or f32, not {src_dtype}")
    mats = mats.to(torch.float32).contiguous()
    kernels.require_cuda_tensor(mats, "mats", torch.float32)
    t = -(-out_size // TILE)
    out = torch.empty((mats.shape[0], t, t, 5), dtype=torch.int32,
                      device=mats.device)
    stream = torch.cuda.current_stream(mats.device).cuda_stream
    err = kernels.library().vn_similarity_warp_boxes(
        mats.data_ptr(), int(src_dtype == torch.uint8), out.data_ptr(),
        mats.shape[0], win, out_size, stream)
    kernels.check_cuda(err, "vn_similarity_warp_boxes")
    return out[..., :4].to(torch.int64), out[..., 4].bool()
