"""Plain PyTorch face detection for the benchmark's reference: RetinaFace
(priors, decode, exact greedy NMS, the visibility threshold and the
per-frame cap) and the MTCNN cascade (area pyramid, PNet, per-scale and
cross-scale NMS, 24 and 48 px area crops, RNet, ONet), with the
fixed capacities and stable top-k that the benchmark's configurations
state. Written from the published detectors (Pytorch_Retinaface,
facenet-pytorch) and independent of the program under test.

Both return the final faces per frame and the candidates the last stage
scored (before its NMS), which the comparison uses to judge a detection
whose score ties another's.
"""

import math

import torch
import torch.nn.functional as F


def stable_topk(values, mask, k):
    """Indices of the top ``k`` masked entries of the last axis, ties to the
    lower index, and whether each pick was a masked entry."""
    k = min(int(k), values.shape[-1])
    masked = torch.where(mask, values, torch.full_like(values, -math.inf))
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return idx[..., :k], vals[..., :k] > -math.inf


def take(a, idx):
    """Rows ``idx`` [B, k] of [B, N, ...]."""
    ix = idx.reshape(idx.shape + (1,) * (a.dim() - 2))
    return torch.gather(a, 1, ix.expand(idx.shape + a.shape[2:]))


def iou(a, b, offset=0.0, min_mode=False):
    """[..., N, 4] x [..., M, 4] xyxy -> [..., N, M]."""
    area_a = ((a[..., 2] - a[..., 0] + offset)
              * (a[..., 3] - a[..., 1] + offset))
    area_b = ((b[..., 2] - b[..., 0] + offset)
              * (b[..., 3] - b[..., 1] + offset))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + offset, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    if min_mode:
        den = torch.minimum(area_a[..., :, None], area_b[..., None, :])
    else:
        den = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(den, min=1e-12)


def greedy_nms(boxes, scores, valid, thr, offset=0.0, min_mode=False):
    """Greedy NMS over each row: visit the valid boxes by descending score
    (ties to the lower index), keep one unless a kept box overlaps it by
    more than ``thr``. boxes [N, K, 4] -> keep [N, K] in the input order."""
    n, k = scores.shape
    if k == 0:
        return valid.clone()
    order = stable_topk(scores, valid, k)[0]
    b = take(boxes, order)
    v = take(valid, order)
    ov = iou(b, b, offset, min_mode) > thr
    later = torch.ones(k, k, dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    ov &= later
    keep = torch.zeros_like(v)
    dead = torch.zeros_like(v)
    for r in range(k):
        cur = v[:, r] & ~dead[:, r]
        if not bool(cur.any()):
            if not bool(v[:, r:].any()):
                break
            continue
        keep[:, r] = cur
        dead |= cur[:, None] & ov[:, r]
    out = torch.zeros_like(keep)
    return out.scatter(1, order, keep)


# ---------------------------------------------------------------------------
# RetinaFace
# ---------------------------------------------------------------------------

MNET_MIN_SIZES = ((16, 32), (64, 128), (256, 512))
MNET_STEPS = (8, 16, 32)
MNET_VARIANCE = (0.1, 0.2)


def priors(h, w, device):
    """Anchors (cx, cy, w, h) normalised, cell-major per level, the two
    min sizes of a cell adjacent."""
    out = []
    for sizes, step in zip(MNET_MIN_SIZES, MNET_STEPS):
        fh, fw = math.ceil(h / step), math.ceil(w / step)
        cy, cx = torch.meshgrid(
            (torch.arange(fh, dtype=torch.float64) + 0.5) * step / h,
            (torch.arange(fw, dtype=torch.float64) + 0.5) * step / w,
            indexing="ij")
        per = [torch.stack([cx, cy, torch.full_like(cx, s / w),
                            torch.full_like(cy, s / h)], -1) for s in sizes]
        out.append(torch.stack(per, 2).reshape(-1, 4))
    return torch.cat(out).to(device=device, dtype=torch.float32)


@torch.no_grad()
def retinaface(net, frames, conf_thres, nms_cap, nms_thres, vis_thres,
               out_cap):
    """frames [B, H, W, 3] uint8 -> dict of the final faces ``boxes``
    [B, out_cap, 4], ``scores``, ``points`` [B, out_cap, 5, 2], ``valid``,
    and the candidates ``cand_*`` (the decoded top ``nms_cap`` above
    ``conf_thres``, before NMS)."""
    b, h, w = frames.shape[:3]
    loc, conf, landm = net(frames)
    score = conf[..., 1]
    idx, still = stable_topk(score, score > conf_thres, nms_cap)
    pr = priors(h, w, frames.device)[idx]
    var0, var1 = MNET_VARIANCE
    scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                         device=frames.device)
    lo = take(loc, idx)
    ctr = pr[..., :2] + lo[..., :2] * var0 * pr[..., 2:]
    size = pr[..., 2:] * torch.exp(lo[..., 2:] * var1)
    boxes = torch.cat([ctr - size / 2, ctr + size / 2], -1) * scale
    pts = take(landm, idx).reshape(b, -1, 5, 2)
    pts = (pr[..., None, :2] + pts * var0 * pr[..., None, 2:]) * scale[:2]
    sc = torch.gather(score, 1, idx)
    valid = still & greedy_nms(boxes, sc, still, nms_thres, offset=1.0)
    valid &= sc >= vis_thres
    top, ok = stable_topk(sc, valid, out_cap)
    return {"boxes": take(boxes, top), "scores": torch.gather(sc, 1, top),
            "points": take(pts, top), "valid": ok,
            "cand_boxes": boxes, "cand_scores": sc, "cand_points": pts,
            "cand_valid": still}


# ---------------------------------------------------------------------------
# MTCNN
# ---------------------------------------------------------------------------

BASE_CAPS = {"pnet_cap_per_scale": 448, "cross_cap": 512, "rnet_cap": 256,
             "onet_cap": 128}
BASE_AREA = 640.0 * 640.0


def mtcnn_caps(h, w, args):
    """Per-stage capacities: the explicit ones, else the 640x640 base
    scaled by frame area (multiples of 64, at most 8x)."""
    scale = min(max(1.0, h * w / BASE_AREA), 8.0)
    caps = {}
    for name, base in BASE_CAPS.items():
        cap = args.get(name)
        if cap is not None:
            caps[name] = int(cap)
        elif scale <= 1.0:
            caps[name] = base
        else:
            caps[name] = int(-(-base * scale // 64) * 64)
    caps["out_cap"] = int(args.get("out_cap", 64))
    return caps


def mtcnn_scales(h, w, min_face_size, factor):
    m = 12.0 / min_face_size
    minl = min(h, w) * m
    scales, s = [], m
    while minl >= 12.0:
        scales.append(s)
        s *= factor
        minl *= factor
    return scales


def _norm(x):
    return (x - 127.5) * 0.0078125


def _bbreg(boxes, reg, plus=1.0):
    w = boxes[..., 2] - boxes[..., 0] + plus
    h = boxes[..., 3] - boxes[..., 1] + plus
    return torch.stack([boxes[..., 0] + reg[..., 0] * w,
                        boxes[..., 1] + reg[..., 1] * h,
                        boxes[..., 2] + reg[..., 2] * w,
                        boxes[..., 3] + reg[..., 3] * h], -1)


def _rerec(boxes):
    h = boxes[..., 3] - boxes[..., 1]
    w = boxes[..., 2] - boxes[..., 0]
    side = torch.maximum(w, h)
    x1 = boxes[..., 0] + w * 0.5 - side * 0.5
    y1 = boxes[..., 1] + h * 0.5 - side * 0.5
    return torch.stack([x1, y1, x1 + side, y1 + side], -1)


def _clamp(boxes, w, h):
    b = torch.trunc(boxes)
    return torch.stack([torch.clamp(b[..., 0], min=1.0),
                        torch.clamp(b[..., 1], min=1.0),
                        torch.clamp(b[..., 2], max=float(w)),
                        torch.clamp(b[..., 3], max=float(h))], -1)


def area_crops(integ, boxes, size):
    """Integer crops ``frame[y1-1:y2, x1-1:x2]`` pooled to ``size`` x
    ``size`` by averaging each adaptive-pool cell (its bounds in f32 from
    the crop extent; the sum over the cell clamped to the frame, divided by
    the unclamped cell area). integ: [B, H+1, W+1, 3] float64 prefix sums;
    boxes [B, K, 4] -> [B, K, S, S, 3] f32."""
    b, k = boxes.shape[:2]
    h, w = integ.shape[1] - 1, integ.shape[2] - 1
    flat = boxes.reshape(-1, 4)
    o = torch.arange(size, dtype=torch.float32, device=boxes.device)

    def bounds(lo, hi):
        ext = hi - lo + 1.0
        r0 = torch.floor(o[None] * ext[:, None] / size)
        r1 = torch.ceil((o[None] + 1.0) * ext[:, None] / size)
        r1 = torch.minimum(torch.maximum(r1, r0 + 1.0), ext[:, None])
        return lo[:, None] - 1.0 + r0, lo[:, None] - 1.0 + r1

    py0, py1 = bounds(flat[:, 1], flat[:, 3])
    px0, px1 = bounds(flat[:, 0], flat[:, 2])

    def index(p, n):
        return torch.clamp(p, 0.0, float(n)).long()

    y0, x0 = index(py0, h), index(px0, w)
    y1 = torch.maximum(index(py1, h), y0)
    x1 = torch.maximum(index(px1, w), x0)
    bi = torch.arange(b, device=boxes.device).repeat_interleave(k)[:, None,
                                                                   None]
    ya, yb = y0[:, :, None], y1[:, :, None]
    xa, xb = x0[:, None, :], x1[:, None, :]
    sums = (integ[bi, yb, xb] - integ[bi, ya, xb] - integ[bi, yb, xa]
            + integ[bi, ya, xa])
    area = ((py1 - py0)[:, :, None] * (px1 - px0)[:, None, :])[..., None]
    out = sums.to(torch.float32) / torch.clamp(area, min=1.0)
    return out.reshape(b, k, size, size, 3)


def _pad(a, k, fill):
    n = k - a.shape[1]
    if n <= 0:
        return a
    return torch.cat([a, torch.full((a.shape[0], n) + a.shape[2:], fill,
                                    dtype=a.dtype, device=a.device)], 1)


def _cap(k, score, valid, *arrays):
    idx, ok = stable_topk(score, valid, k)
    return (ok, torch.gather(score, 1, idx), *(take(a, idx) for a in arrays))


@torch.no_grad()
def mtcnn(nets, frames, args):
    """frames [B, H, W, 3] uint8 -> dict of the final faces (``boxes``,
    ``scores``, ``points``, ``valid``, out_cap a frame) and the ONet
    stage's candidates (every crop it scored, before its threshold and
    its NMS: ``cand_*``), and how many candidates RNet and ONet were given
    (``n_rnet``, ``n_onet``). ``nets``: (pnet, rnet, onet); ``args``: the
    detector's arguments (min_face_size, thresholds, factor, caps)."""
    pnet, rnet, onet = nets
    b, h, w = frames.shape[:3]
    dev = frames.device
    thr = tuple(args.get("thresholds", (0.6, 0.7, 0.7)))
    caps = mtcnn_caps(h, w, args)
    k1, kx = caps["pnet_cap_per_scale"], caps["cross_cap"]
    k2, k3, kout = caps["rnet_cap"], caps["onet_cap"], caps["out_cap"]
    img = frames.permute(0, 3, 1, 2).to(torch.float32)
    integ = F.pad(frames.to(torch.float64).cumsum(1).cumsum(2),
                  (0, 0, 1, 0, 1, 0))

    # stage 1: every pyramid level, candidates capped per scale
    scales = mtcnn_scales(h, w, args.get("min_face_size", 20),
                          args.get("factor", 0.709))
    per_scale = []
    for s in scales:
        lvl = F.adaptive_avg_pool2d(img, (int(h * s + 1), int(w * s + 1)))
        reg, prob = pnet(_norm(lvl))
        score = prob[:, 1]
        hc, wc = score.shape[1:]
        st = torch.full((), s, dtype=torch.float32, device=dev)
        jj = torch.arange(wc, dtype=torch.float32, device=dev)[None, :]
        ii = torch.arange(hc, dtype=torch.float32, device=dev)[:, None]
        boxes = torch.stack([
            torch.floor((2 * jj + 1) / st).expand(hc, wc),
            torch.floor((2 * ii + 1) / st).expand(hc, wc),
            torch.floor((2 * jj + 12) / st).expand(hc, wc),
            torch.floor((2 * ii + 12) / st).expand(hc, wc)],
            -1).reshape(1, -1, 4).expand(b, -1, -1)
        score = score.reshape(b, -1)
        reg = reg.permute(0, 2, 3, 1).reshape(b, -1, 4)
        valid, score, boxes, reg = _cap(k1, score, score >= thr[0], boxes,
                                        reg)
        per_scale.append((_pad(boxes, k1, 0.0), _pad(score, k1, 0.0),
                          _pad(reg, k1, 0.0), _pad(valid, k1, False)))
    ns = len(scales)
    boxes, score, reg, valid = (torch.stack(t, 1) for t in zip(*per_scale))
    keep = greedy_nms(boxes.reshape(b * ns, k1, 4),
                      score.reshape(b * ns, k1),
                      valid.reshape(b * ns, k1), 0.5)
    valid = (valid.reshape(b * ns, k1) & keep).reshape(b, ns * k1)
    boxes, score = boxes.reshape(b, -1, 4), score.reshape(b, -1)
    reg = reg.reshape(b, -1, 4)

    # across scales
    valid, score, boxes, reg = _cap(kx, score, valid, boxes, reg)
    valid &= greedy_nms(boxes, score, valid, 0.7)
    valid, score, boxes, reg = _cap(k2, score, valid, boxes, reg)
    boxes = _rerec(_bbreg(boxes, reg, plus=0.0))

    # stage 2
    n_rnet = valid.sum()
    crops = area_crops(integ, _clamp(boxes, w, h), 24).reshape(-1, 24, 24, 3)
    r_reg, r_prob = rnet(_norm(crops).permute(0, 3, 1, 2))
    r_score = r_prob[:, 1].reshape(b, -1)
    valid &= r_score > thr[1]
    valid &= greedy_nms(boxes, r_score, valid, 0.7)
    boxes = _rerec(_bbreg(boxes, r_reg.reshape(b, -1, 4)))
    valid, score, boxes = _cap(k3, r_score, valid, boxes)

    # stage 3
    n_onet = valid.sum()
    crops = area_crops(integ, _clamp(boxes, w, h), 48).reshape(-1, 48, 48, 3)
    o_reg, o_landm, o_prob = onet(_norm(crops).permute(0, 3, 1, 2))
    o_score = o_prob[:, 1].reshape(b, -1)
    o_landm = o_landm.reshape(b, -1, 10)
    scored = valid.clone()
    valid &= o_score > thr[2]
    bw = boxes[..., 2] - boxes[..., 0] + 1.0
    bh = boxes[..., 3] - boxes[..., 1] + 1.0
    points = torch.stack([bw[..., None] * o_landm[..., :5]
                          + boxes[..., 0:1] - 1.0,
                          bh[..., None] * o_landm[..., 5:]
                          + boxes[..., 1:2] - 1.0], -1)
    boxes = _bbreg(boxes, o_reg.reshape(b, -1, 4))
    cand = {"cand_boxes": boxes, "cand_scores": o_score,
            "cand_points": points, "cand_valid": scored}
    valid &= greedy_nms(boxes, o_score, valid, 0.7, offset=1.0,
                        min_mode=True)
    valid, score, boxes, points = _cap(kout, o_score, valid, boxes, points)
    return {"boxes": boxes, "scores": score, "points": points,
            "valid": valid, "n_rnet": n_rnet, "n_onet": n_onet, **cand}
