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
    """Exact greedy NMS keep mask for each row of a batch: boxes
    [N, K, 4], scores [N, K], valid [N, K] bool -> keep [N, K] bool.
    Kernel K3 on the card, its plain version on the CPU
    (``ops.nms.nms_keep_mask``)."""
    from .nms import nms_keep_mask as k3

    return k3(boxes, scores, valid, iou_thr, offset, min_mode)


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


def gather_rows(arrays, idx):
    """Rows ``idx`` of every [K, ...] tensor of a nest of dicts, lists and
    tuples (named tuples included), in the same nest; None stays None."""
    if arrays is None:
        return None
    if isinstance(arrays, dict):
        return {k: gather_rows(v, idx) for k, v in arrays.items()}
    if isinstance(arrays, tuple) and hasattr(arrays, "_fields"):
        return type(arrays)(*(gather_rows(a, idx) for a in arrays))
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(gather_rows(a, idx) for a in arrays)
    return arrays[idx]


def take_rows(a, idx):
    """Rows ``idx`` [B, k] of a [B, N, ...] tensor -> [B, k, ...]."""
    ix = idx.reshape(idx.shape + (1,) * (a.dim() - 2))
    return torch.gather(a, 1, ix.expand(idx.shape + a.shape[2:]))


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


# ---------------------------------------------------------------------------
# Train-time matching of ground truth to priors (detector training)
# ---------------------------------------------------------------------------


def jaccard(boxes_a, boxes_b):
    """Plain IoU (offset 0) between [..., N, 4] and [..., M, 4] xyxy boxes,
    the overlap that matching ranks priors by."""
    return pairwise_iou(boxes_a, boxes_b, offset=0.0, min_mode=False)


def point_form(priors):
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    half = priors[..., 2:] / 2.0
    return torch.cat([priors[..., :2] - half, priors[..., :2] + half], dim=-1)


def encode_boxes(matched, priors, variances):
    """SSD box encoding of matched xyxy boxes against priors (cx, cy, w,
    h): the inverse of ``decode_boxes``."""
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2.0 - priors[..., :2]
    g_cxcy = g_cxcy / (variances[0] * priors[..., 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / priors[..., 2:]
    return torch.cat([g_cxcy, torch.log(g_wh) / variances[1]], dim=-1)


def encode_landmarks(matched, priors, variances):
    """5-point landmarks [..., 10] encoded against priors: the inverse of
    ``decode_landmarks``."""
    pts = matched.reshape(matched.shape[:-1] + (5, 2))
    g = (pts - priors[..., None, :2]) / (variances[0] * priors[..., None, 2:])
    return g.reshape(matched.shape[:-1] + (10,))


def match_priors(truths, labels, landms, priors, variances, threshold,
                 truths_valid=None):
    """Assign ground truth to priors over a padded, batched GT set.

    Args:
      truths: [B, G, 4] xyxy boxes, normalised (padded rows arbitrary).
      labels: [B, G] int (1 a face, -1 a face without landmarks).
      landms: [B, G, 10] landmarks, normalised.
      priors: [P, 4] (cx, cy, w, h).
      variances: (0.1, 0.2).
      threshold: the IoU from which a prior is a positive.
      truths_valid: [B, G] bool, the real rows (all when None).

    Returns (loc_t [B, P, 4], conf_t [B, P] int, landm_t [B, P, 10]):
    encoded regression targets, the class of each prior (0 background)
    and encoded landmarks. Each prior takes its best GT (ties to the
    lower index); a GT whose best prior overlaps it by more than 0.2 also
    claims that prior outright, and where two GT share a best prior the
    higher GT index wins (done as a loop over G, so the order does not
    hang on a scatter with repeated indices).
    """
    b, g = truths.shape[:2]
    if truths_valid is None:
        truths_valid = torch.ones((b, g), dtype=torch.bool,
                                  device=truths.device)
    overlaps = jaccard(truths, point_form(priors))  # [B, G, P]
    overlaps = torch.where(truths_valid[..., None], overlaps,
                           torch.full_like(overlaps, -1.0))
    best_prior_idx = torch.argmax(overlaps, dim=2)             # [B, G]
    best_prior_overlap = torch.amax(overlaps, dim=2)           # [B, G]
    best_truth_overlap = torch.amax(overlaps, dim=1)           # [B, P]
    best_truth_idx = torch.argmax(overlaps, dim=1)             # [B, P]
    gt_keep = truths_valid & (best_prior_overlap > 0.2)
    prior_ids = torch.arange(priors.shape[0], device=truths.device)
    for j in range(g):
        hit = (prior_ids == best_prior_idx[:, j:j + 1]) & gt_keep[:, j:j + 1]
        best_truth_overlap = torch.where(
            hit, torch.full_like(best_truth_overlap, 2.0), best_truth_overlap)
        best_truth_idx = torch.where(
            hit, torch.full_like(best_truth_idx, j), best_truth_idx)
    conf = torch.gather(labels, 1, best_truth_idx)
    conf = torch.where(best_truth_overlap < threshold,
                       torch.zeros_like(conf), conf)
    loc_t = encode_boxes(take_rows(truths, best_truth_idx), priors,
                         variances)
    landm_t = encode_landmarks(take_rows(landms, best_truth_idx), priors,
                               variances)
    return loc_t, conf, landm_t
