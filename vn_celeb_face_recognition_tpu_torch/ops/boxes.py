"""Box math and exact greedy NMS on padded, fixed-capacity box sets.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/boxes.py``. Every
candidate set is padded to a fixed K with a validity mask.
"""

import math

import numpy as np
import torch


def pairwise_iou(boxes_a, boxes_b, offset=0.0, min_mode=False):
    """IoU between [..., N, 4] and [..., M, 4] xyxy boxes -> [..., N, M].

    ``offset=1.0`` is the +1 pixel-area convention of MTCNN's stage 3;
    ``min_mode`` divides the intersection by the smaller area."""
    area_a = (boxes_a[..., 2] - boxes_a[..., 0] + offset) * (
        boxes_a[..., 3] - boxes_a[..., 1] + offset)
    area_b = (boxes_b[..., 2] - boxes_b[..., 0] + offset) * (
        boxes_b[..., 3] - boxes_b[..., 1] + offset)
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + offset, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    if min_mode:
        denom = torch.minimum(area_a[..., :, None], area_b[..., None, :])
    else:
        denom = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(denom, min=1e-12)


def batched_nms_keep_mask(boxes, scores, valid, iou_thr, offset=0.0,
                          min_mode=False):
    """Exact greedy NMS keep mask for each row of a batch.

    boxes [N, K, 4], scores [N, K], valid [N, K] bool -> keep [N, K] bool
    in the original row order. Priority is descending score with ties
    broken by lower index; box j suppresses box i when j has priority,
    is kept, and iou(j, i) > iou_thr (strict).

    Greedy NMS is the unique fixpoint of
    ``keep = valid & ~any_j(sup[j, i] & keep[j])``; iterating from
    ``keep = valid`` reaches it after as many sweeps as the longest
    suppression chain (a handful in practice), each sweep one batched
    matrix-vector product. Each convergence check reads one flag on the
    host.
    """
    n, k = scores.shape
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    s = torch.where(valid, scores, neg_inf)
    iou = pairwise_iou(boxes, boxes, offset=offset, min_mode=min_mode)
    idx = torch.arange(k, device=scores.device)
    higher = (s[:, :, None] > s[:, None, :]) | (
        (s[:, :, None] == s[:, None, :]) & (idx[:, None] < idx[None, :]))
    sup = (higher & (iou > iou_thr) & valid[:, :, None]).to(torch.float32)
    keep = valid
    for _ in range(k + 1):
        hits = torch.bmm(keep.to(torch.float32)[:, None, :], sup)[:, 0]
        new_keep = valid & ~(hits > 0.0)
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def nms_keep_mask(boxes, scores, valid, iou_thr, offset=0.0, min_mode=False):
    """Single-set form: boxes [K, 4], scores [K], valid [K] -> keep [K]."""
    return batched_nms_keep_mask(boxes[None], scores[None], valid[None],
                                 iou_thr, offset, min_mode)[0]


def top_k_select(values, mask, k):
    """Top-k by value among masked entries along the last axis.

    Returns (indices [..., k], valid [..., k]). A stable descending sort
    orders ties by lower index, as ``jax.lax.top_k`` does (``torch.topk``
    leaves ties unordered). k is clamped to the axis length."""
    k = min(int(k), values.shape[-1])
    neg_inf = torch.tensor(float("-inf"), dtype=values.dtype,
                           device=values.device)
    masked = torch.where(mask, values, neg_inf)
    top_vals, top_idx = torch.sort(masked, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[..., :k], top_idx[..., :k]
    return top_idx, top_vals > neg_inf


def bbreg(boxes, reg):
    """P/R/O-net box regression with the +1 width convention."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return torch.stack([
        boxes[..., 0] + reg[..., 0] * w,
        boxes[..., 1] + reg[..., 1] * h,
        boxes[..., 2] + reg[..., 2] * w,
        boxes[..., 3] + reg[..., 3] * h,
    ], dim=-1)


def rerec(boxes):
    """Square boxes around their centre."""
    h = boxes[..., 3] - boxes[..., 1]
    w = boxes[..., 2] - boxes[..., 0]
    side = torch.maximum(w, h)
    x1 = boxes[..., 0] + w * 0.5 - side * 0.5
    y1 = boxes[..., 1] + h * 0.5 - side * 0.5
    return torch.stack([x1, y1, x1 + side, y1 + side], dim=-1)


def clamp_boxes(boxes, width, height):
    """Truncate to int and clamp into [1, w] x [1, h]; returns float boxes
    holding the clamped integer coordinates."""
    b = torch.trunc(boxes)
    x1 = torch.clamp(b[..., 0], min=1.0)
    y1 = torch.clamp(b[..., 1], min=1.0)
    x2 = torch.clamp(b[..., 2], max=float(width))
    y2 = torch.clamp(b[..., 3], max=float(height))
    return torch.stack([x1, y1, x2, y2], dim=-1)


# ---------------------------------------------------------------------------
# SSD-style priors (RetinaFace anchors) and their decode
# ---------------------------------------------------------------------------


def make_priors(image_size, min_sizes, steps, clip=False):
    """Prior boxes (cx, cy, w, h), normalised, as a [N, 4] f32 ndarray:
    cell-major, min-size-minor within each stride level."""
    im_h, im_w = image_size
    levels = []
    for k, step in enumerate(steps):
        fm_h, fm_w = math.ceil(im_h / step), math.ceil(im_w / step)
        ii, jj = np.meshgrid(np.arange(fm_h, dtype=np.float32),
                             np.arange(fm_w, dtype=np.float32),
                             indexing="ij")
        cx = (jj + 0.5) * step / im_w
        cy = (ii + 0.5) * step / im_h
        per_size = [np.stack([cx, cy, np.full_like(cx, m / im_w),
                              np.full_like(cy, m / im_h)],
                             axis=-1).reshape(-1, 4)
                    for m in min_sizes[k]]
        levels.append(np.stack(per_size, axis=1).reshape(-1, 4))
    priors = np.concatenate(levels, axis=0).astype(np.float32)
    return np.clip(priors, 0.0, 1.0) if clip else priors


def decode_boxes(loc, priors, variances):
    """SSD box offsets [..., 4] against priors (cx, cy, w, h) -> xyxy in
    [0, 1]."""
    centers = priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:]
    sizes = priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    tl = centers - sizes / 2.0
    return torch.cat([tl, tl + sizes], dim=-1)


def decode_landmarks(pre, priors, variances):
    """5-point landmark offsets [..., 10] -> [..., 10] in [0, 1]."""
    pts = pre.reshape(pre.shape[:-1] + (5, 2))
    out = (priors[..., None, :2]
           + pts * variances[0] * priors[..., None, 2:])
    return out.reshape(pre.shape)
