"""Plain PyTorch face alignment for the benchmark's reference: a fixed
window around each face box, the least-squares similarity (Umeyama, closed
form in 2-D) from the window's landmarks onto the canonical 5-point
template, and a bilinear warp of the window with a zero border (cv2's
``warpAffine`` with ``BORDER_CONSTANT``).
"""

import torch

# the canonical 5-point template of a 112 x 112 face (ArcFace's)
TEMPLATE_112 = ((38.2946, 51.6963), (73.5318, 51.5014), (56.0252, 71.7366),
                (41.5493, 92.3655), (70.7299, 92.2041))


def window_origins(boxes, win, h, w):
    """Top-left corners (x, y) [K, 2] of the ``win`` x ``win`` windows
    centred on the boxes [K, 4], rounded and kept inside the frame."""
    cx = (boxes[:, 0] + boxes[:, 2]) * 0.5
    cy = (boxes[:, 1] + boxes[:, 3]) * 0.5
    ox = torch.clamp(torch.round(cx - win / 2), 0, w - win)
    oy = torch.clamp(torch.round(cy - win / 2), 0, h - win)
    return torch.stack([ox, oy], -1)


def similarity(src, dst):
    """[K, 5, 2] points -> [K, 2, 3] rotation + scale + translation that
    maps ``src`` onto ``dst`` in the least-squares sense."""
    dst = dst.to(src).expand_as(src)
    sm, dm = src.mean(1), dst.mean(1)
    s, d = src - sm[:, None], dst - dm[:, None]
    den = torch.clamp((s * s).sum((1, 2)), min=1e-12)
    a = (s * d).sum((1, 2)) / den
    b = (s[..., 0] * d[..., 1] - s[..., 1] * d[..., 0]).sum(1) / den
    tx = dm[:, 0] - (a * sm[:, 0] - b * sm[:, 1])
    ty = dm[:, 1] - (b * sm[:, 0] + a * sm[:, 1])
    return torch.stack([torch.stack([a, -b, tx], -1),
                        torch.stack([b, a, ty], -1)], 1)


def invert(mats):
    """Inverse maps of [K, 2, 3] affine maps."""
    a, b, tx = mats[:, 0, 0], mats[:, 0, 1], mats[:, 0, 2]
    c, d, ty = mats[:, 1, 0], mats[:, 1, 1], mats[:, 1, 2]
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    return torch.stack([
        torch.stack([ia, ib, -(ia * tx + ib * ty)], -1),
        torch.stack([ic, id_, -(ic * tx + id_ * ty)], -1)], 1)


def source_coords(mats, size):
    """Where each pixel of a ``size`` x ``size`` face samples its window:
    (x, y), each [K, size, size]."""
    inv = invert(mats)[:, :, :, None, None]
    grid = torch.arange(size, dtype=torch.float32, device=mats.device)
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")
    return (inv[:, 0, 0] * xx + inv[:, 0, 1] * yy + inv[:, 0, 2],
            inv[:, 1, 0] * xx + inv[:, 1, 1] * yy + inv[:, 1, 2])


def warp(windows, mats, size):
    """Windows [K, N, N, 3] f32 and forward maps [K, 2, 3] (window ->
    face) -> faces [K, size, size, 3]: each output pixel samples the
    window at the inverse map, bilinear, a tap outside the window reading
    0."""
    k, n = windows.shape[:2]
    sx, sy = source_coords(mats, size)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    kk = torch.arange(k, device=windows.device)[:, None, None]

    def tap(yi, xi):
        ok = (yi >= 0) & (yi <= n - 1) & (xi >= 0) & (xi <= n - 1)
        v = windows[kk, yi.clamp(0, n - 1).long(), xi.clamp(0, n - 1).long()]
        return torch.where(ok[..., None], v, torch.zeros_like(v))

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def align(frames, frame_idx, boxes, points, win=224, size=112):
    """Faces [K, size, size, 3] f32 (0-255) cut from uint8 ``frames``
    [B, H, W, 3] at the detections (frame_idx [K], boxes [K, 4], points
    [K, 5, 2] in frame pixels)."""
    h, w = frames.shape[1:3]
    win = min(win, h, w)
    org = window_origins(boxes, win, h, w)
    oi = torch.nan_to_num(org).long()
    ar = torch.arange(win, device=frames.device)
    fi = frame_idx.long()[:, None, None]
    windows = frames[fi, oi[:, 1, None, None] + ar[None, :, None],
                     oi[:, 0, None, None] + ar[None, None, :]].float()
    if size != 112:
        raise ValueError(f"the template is for 112 px faces, not {size}")
    template = torch.tensor(TEMPLATE_112, dtype=torch.float32,
                            device=frames.device)
    mats = similarity(points - org[:, None, :], template)
    return warp(windows, mats, size)
