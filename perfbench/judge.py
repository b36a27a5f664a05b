"""The comparison that decides ``correct``: the program's outputs for a
chunk against the plain reference run on the same frames.

Detection: the reference detects on the chunk's frames. Each of the
program's faces is matched to the reference's nearest candidate of the
same frame (the last stage's candidates, before its NMS, scored within
``MARGIN`` of the threshold or above), and ``det_gap_px`` is the largest
gap, in pixels, between the two boxes' corners and landmarks; a program
face that no such candidate overlaps by half (IoU) is ``det_extra``, and a
reference face scored ``MARGIN`` above the threshold that no program face
overlaps by half is ``det_missed``. ``score_gap`` is the gap of the
matched scores.

Alignment, embedding, classification and emotion are judged face by face
at the program's own detections (boxes and landmarks, outputs of the
program that the reference reads only to judge them): the reference cuts
the window, solves the similarity, warps, embeds, classifies and tags each
face itself. ``embed_gap`` is the relative L2 gap of the embeddings;
``logp_gap`` the widest gap, in nats, between the program's
log-probabilities (its classifier's last call, kept by ``LastCall``; the
row whose input is the face's embedding) and the reference's, over all
classes; ``class_gap`` the log-probability by which the program's class
lies below the reference's best, and ``class_excess`` how far that
exceeds twice the face's ``logp_gap``: a class that is the argmax of the
program's own log-probabilities never does, so any excess is a wrong
class; ``prob_gap`` the relative gap of the class probability; ``emotion_gap`` the probability by which a tag the program
ranks k-th lies below the reference's k-th; ``emotion_prob_gap`` the gap of
the tags' probabilities, and ``emotion_rel_gap`` that gap over the
reference's probability of the tag.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference import align as ref_align


MARGIN = 0.05  # score band around a threshold in which a face may flip
FRAME_BLOCK = 32  # frames the reference detects at once
FACE_BLOCK = 64  # faces the reference embeds at once
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class LastCall(nn.Module):
    """The program's classifier, keeping its last call's input and output
    (device tensors, no copy) for the judge."""

    def __init__(self, inner):
        super().__init__()
        self.inner, self.last = inner, None

    def forward(self, x, *args, **kwargs):
        y = self.inner(x, *args, **kwargs)
        self.last = (x, y)
        return y


def face_rows(inputs, embeddings):
    """For each embedding, the first row of the classifier's ``inputs``
    equal to it bit for bit, or -1."""
    first = {}
    for k, row in enumerate(inputs):
        first.setdefault(row.tobytes(), k)
    return np.array([first.get(e.tobytes(), -1) for e in embeddings])


def _quantile(x, q):
    return float(np.quantile(x, q)) if len(x) else 0.0


@torch.no_grad()
def detect_blocks(detector, frames):
    """The reference detector over a chunk, FRAME_BLOCK frames at a time;
    a dict of host arrays (and ``n_rnet``/``n_onet`` summed)."""
    parts = [detector(frames[i:i + FRAME_BLOCK])
             for i in range(0, frames.shape[0], FRAME_BLOCK)]
    out = {}
    for key in parts[0]:
        vals = [p[key] for p in parts]
        if vals[0].dim() == 0:
            out[key] = int(sum(int(v) for v in vals))
        else:
            out[key] = torch.cat(vals).cpu().numpy()
    return out


def _iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter,
                              1e-12)


def judge_detection(prog, ref, thr):
    """Gaps and counts of the program's valid faces against the
    reference's (see the module docstring); ``thr`` is the last stage's
    threshold."""
    gaps, sgaps = [], []
    missed = extra = 0
    for i in range(prog["valid"].shape[0]):
        pv = prog["valid"][i]
        pb, pp, ps = (prog[k][i][pv] for k in ("boxes", "points", "scores"))
        cv = ref["cand_valid"][i] & (ref["cand_scores"][i] >= thr - MARGIN)
        cb, cp, cs = (ref[k][i][cv] for k in ("cand_boxes", "cand_points",
                                              "cand_scores"))
        if len(pb):
            if len(cb):
                dist = np.maximum(
                    np.abs(pb[:, None] - cb[None]).max(-1),
                    np.abs(pp[:, None] - cp[None]).max((-1, -2)))
                near = dist.argmin(1)
                ok = _iou(pb, cb)[np.arange(len(pb)), near] >= 0.5
                gaps += list(dist[np.arange(len(pb)), near][ok])
                sgaps += list(np.abs(ps - cs[near])[ok])
                extra += int((~ok).sum())
            else:
                extra += len(pb)
        rv = ref["valid"][i] & (ref["scores"][i] >= thr + MARGIN)
        rb = ref["boxes"][i][rv]
        if len(rb):
            hit = (_iou(rb, pb).max(1) >= 0.5) if len(pb) else np.zeros(
                len(rb), bool)
            missed += int((~hit).sum())
    return {"det_missed": missed, "det_extra": extra,
            "det_gap_px": float(max(gaps, default=0.0)),
            "det_gap_px_p50": _quantile(gaps, 0.5),
            "score_gap": float(max(sgaps, default=0.0)),
            "score_gap_p50": _quantile(sgaps, 0.5),
            "matched": len(gaps)}


@torch.no_grad()
def judge_faces(prog, frames, refs, emotion_spec, device):
    """Embedding, class and emotion gaps of the program's valid faces
    against the reference's, computed at the program's detections."""
    fi, fj = np.nonzero(prog["valid"])
    n = len(fi)
    out = {"faces": n}
    if n == 0:
        return out
    idx = torch.from_numpy(fi).to(device)
    boxes = torch.from_numpy(prog["boxes"][fi, fj]).to(device)
    points = torch.from_numpy(prog["points"][fi, fj]).to(device)
    rows = face_rows(prog["cls_in"], prog["embeddings"][fi, fj])
    lp_rows = np.concatenate([prog["logp"], np.full(
        (1, prog["logp"].shape[1]), np.nan, np.float32)])  # row -1: none
    emb_gap, cls_gap, p_gap, e_gap, ep_gap, er_gap = [], [], [], [], [], []
    lp_gap, excess = [], []
    for s in range(0, n, FACE_BLOCK):
        sl = slice(s, s + FACE_BLOCK)
        faces = ref_align.align(frames, idx[sl], boxes[sl], points[sl])
        x = ((faces - 127.5) / 128.0).permute(0, 3, 1, 2)
        e_ref = refs["encoder"](x)
        e_prog = torch.from_numpy(prog["embeddings"][fi[sl], fj[sl]]).to(
            device)
        emb_gap.append((e_prog - e_ref).norm(dim=-1)
                       / e_ref.norm(dim=-1).clamp(min=1e-30))
        logp = refs["classifier"](e_ref)
        pred = torch.from_numpy(prog["pred"][fi[sl], fj[sl]]).to(device)
        lp = logp.gather(1, pred[:, None].long())[:, 0]
        # in float64, where these differences of float32 values are exact
        ref64 = logp.double()
        cls64 = ref64.max(-1).values - ref64.gather(
            1, pred[:, None].long())[:, 0]
        prog64 = torch.from_numpy(lp_rows[rows[sl]]).to(device).double()
        gap64 = torch.nan_to_num((prog64 - ref64).abs().max(-1).values,
                                 nan=float("inf"))
        cls_gap.append(cls64)
        lp_gap.append(gap64)
        excess.append((cls64 - 2.0 * gap64).clamp(min=0.0))
        prob = torch.from_numpy(prog["prob"][fi[sl], fj[sl]]).to(device)
        p_gap.append((prob - lp.exp()).abs() / lp.exp())
        if emotion_spec is not None:
            size = emotion_spec["size"]
            y = F.adaptive_avg_pool2d(faces.permute(0, 3, 1, 2),
                                      (size, size)) / 255.0
            mean = torch.tensor(IMAGENET_MEAN, device=device)[:, None, None]
            std = torch.tensor(IMAGENET_STD, device=device)[:, None, None]
            probs = torch.softmax(refs["emotion"]((y - mean) / std)[0], -1)
            k = emotion_spec["topk"]
            best = torch.sort(probs, -1, descending=True).values[:, :k]
            tags = torch.from_numpy(prog["emotion_idx"][fi[sl], fj[sl]]).to(
                device).long()
            at = probs.gather(1, tags)
            e_gap.append((best - at).max(-1).values)
            tp = torch.from_numpy(prog["emotion_prob"][fi[sl], fj[sl]]).to(
                device)
            ep_gap.append((tp - at).abs().max(-1).values)
            er_gap.append(((tp - at).abs() / at).max(-1).values)
    cat = lambda v: torch.cat(v).cpu().numpy()  # noqa: E731
    emb, cls_, pg = cat(emb_gap), cat(cls_gap), cat(p_gap)
    out.update(embed_gap=float(emb.max()),
               embed_gap_p50=_quantile(emb, 0.5),
               class_gap=float(cls_.max()), prob_gap=float(pg.max()),
               logp_gap=float(cat(lp_gap).max()),
               class_excess=float(cat(excess).max()))
    if emotion_spec is not None:
        er = cat(er_gap)
        out.update(emotion_gap=float(cat(e_gap).max()),
                   emotion_prob_gap=float(cat(ep_gap).max()),
                   emotion_rel_gap=float(er.max()),
                   emotion_rel_gap_p50=_quantile(er, 0.5))
    return out


def judge_chunk(prog, frames_np, refs, thr, emotion_spec, device):
    """Every number of one chunk: ``prog`` holds the program's outputs as
    host arrays, ``frames_np`` the chunk it was handed."""
    frames = torch.from_numpy(frames_np).to(device)
    ref = detect_blocks(refs["detector"], frames)
    nums = judge_detection(prog, ref, thr)
    nums.update(judge_faces(prog, frames, refs, emotion_spec, device))
    nums["n_rnet"] = ref.get("n_rnet")
    nums["n_onet"] = ref.get("n_onet")
    return nums


def merge(chunks):
    """The numbers of several chunks: counts added, gaps by their worst,
    medians by their mean."""
    out = {}
    for key in chunks[0]:
        vals = [c[key] for c in chunks if c.get(key) is not None]
        if not vals:
            continue
        if key in ("det_missed", "det_extra", "matched", "faces", "n_rnet",
                   "n_onet"):
            out[key] = int(sum(vals))
        elif key.endswith("_p50"):
            out[key] = float(np.mean(vals))
        else:
            out[key] = float(max(vals))
    return out
