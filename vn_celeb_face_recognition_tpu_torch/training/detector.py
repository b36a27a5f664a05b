"""RetinaFace detector training: synthetic scenes and the SSD train step.

Counterpart of ``vn_celeb_face_recognition_tpu/training/detector.py``.
The scenes are the repo's face crops pasted at random scales and places
on flat grey, noise or gradient backgrounds, with exact box and 5-point
landmark ground truth; drawn from the same ``numpy.random.Generator``
calls in the same order and resized as PIL resizes (``utils.frames.
resize_bicubic``), they equal the JAX package's scenes bit for bit.

A train step is the train-phase net in train mode (raw class logits,
batch statistics, stage 1 through its modules: no kernel), prior
matching on the device over the padded ground truth of the batch, the
MultiBox loss, backward and the optimizer step. The evaluations run the
same net in eval mode, as the detector runs it: stage 1 through kernel
K6, NMS through kernel K3.
"""

import contextlib

import numpy as np
import torch

from ..ops import boxes as B
from ..utils import kernels
from ..utils.frames import resize_bicubic
from .multibox_loss import multibox_loss

# 5-point alignment template of a 112x112 face chip
# (pipeline/align.py center_point_dict["(112, 112)"]): the landmarks of
# a crop where the MTCNN probe finds no face
_TEMPLATE_112 = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    dtype=np.float32,
)


def template_landmarks(crop_px):
    """The template's 5 points scaled to a ``crop_px``-square face crop."""
    return _TEMPLATE_112 / 112.0 * float(crop_px)


def probe_crop_landmarks(crops, mtcnn=None, device="cuda"):
    """5-point landmarks of each face crop by the published-weight MTCNN
    (``min_face_size=40``; on the card, kernels K2-K5), the template
    where it finds no face. Returns [N, 5, 2] float32 in crop pixels."""
    if mtcnn is None:
        from ..models import MTCNN

        mtcnn = MTCNN(min_face_size=40, keep_all=False, device=device)
    out = []
    for crop in crops:
        boxes, _, points = mtcnn.detect(crop, landmarks=True)
        if boxes is None or len(boxes) == 0 or points is None:
            out.append(template_landmarks(crop.shape[0]))
        else:
            out.append(np.asarray(points[0], np.float32))
    return np.stack(out)


def synth_scene(rng, size, crops, crop_landmarks, max_faces, min_px=48,
                max_px=224):
    """One synthetic frame with exact detection ground truth.

    Returns (frame u8 [S, S, 3], boxes f32 [G, 4] xyxy px, landms f32
    [G, 10] px, valid bool [G]) with G = ``max_faces``. The background is
    flat grey, uniform noise or a smooth gradient; each face's size and
    place are uniform within bounds."""
    mode = rng.integers(0, 3)
    if mode == 0:
        frame = np.full((size, size, 3), rng.integers(50, 160),
                        dtype=np.uint8)
    elif mode == 1:
        frame = rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)
    else:
        ramp = np.linspace(rng.integers(0, 100), rng.integers(120, 255),
                           size)
        axis = rng.integers(0, 2)
        plane = ramp[:, None] if axis == 0 else ramp[None, :]
        frame = np.broadcast_to(
            plane[..., None], (size, size, 3)).astype(np.uint8).copy()

    g = int(rng.integers(1, max_faces + 1))
    boxes = np.zeros((max_faces, 4), np.float32)
    landms = np.zeros((max_faces, 10), np.float32)
    valid = np.zeros((max_faces,), bool)
    hi = min(max_px, size - 2)
    for i in range(g):
        px = int(rng.integers(min_px, hi + 1))
        x0 = int(rng.integers(0, size - px))
        y0 = int(rng.integers(0, size - px))
        j = int(rng.integers(0, len(crops)))
        frame[y0:y0 + px, x0:x0 + px] = resize_bicubic(crops[j], (px, px))
        boxes[i] = (x0, y0, x0 + px, y0 + px)
        scale = px / float(crops[j].shape[0])
        pts = crop_landmarks[j] * scale + np.array([x0, y0], np.float32)
        landms[i] = pts.reshape(-1)
        valid[i] = True
    return frame, boxes, landms, valid


def synth_batch(rng, batch, size, crops, crop_landmarks, max_faces=6, **kw):
    """A batch of synthetic scenes: (frames u8 [B, S, S, 3], boxes [B, G,
    4], labels int32 [B, G], landms [B, G, 10], valid [B, G]), the boxes
    and landmarks normalised by ``size``, as ``match_priors`` takes them."""
    frames = np.empty((batch, size, size, 3), np.uint8)
    boxes = np.empty((batch, max_faces, 4), np.float32)
    landms = np.empty((batch, max_faces, 10), np.float32)
    valid = np.empty((batch, max_faces), bool)
    for b in range(batch):
        frames[b], boxes[b], landms[b], valid[b] = synth_scene(
            rng, size, crops, crop_landmarks, max_faces, **kw)
    labels = valid.astype(np.int32)  # 1: a face with landmarks
    return frames, boxes / size, labels, landms / size, valid


def make_detection_train_step(net, priors, variances, optimizer,
                              scheduler=None, match_thresh=0.35,
                              neg_pos_ratio=7.0, loc_weight=2.0):
    """One detector train step on ``net``, a ``phase="train"``
    ``RetinaFaceNet`` (raw class logits); the match threshold, mining
    ratio and box weight default to the cfg_mnet recipe.

    ``step(frames, truths, labels, landms, valid)`` takes tensors on the
    net's device (uint8 frames [B, S, S, 3] and ``synth_batch``'s ground
    truth), runs the forward in train mode, matches on the device, takes
    the loss, its backward, the optimizer step and then ``scheduler``'s,
    and returns the loss dict as 0-d tensors without waiting for the
    device."""
    if net.phase != "train":
        raise ValueError("the train step needs a phase='train' net (raw "
                         f"class logits), got phase={net.phase!r}")
    priors = torch.as_tensor(priors, dtype=torch.float32)

    def step(frames, truths, labels, landms, valid):
        net.train()
        pri = priors.to(frames.device)
        optimizer.zero_grad(set_to_none=True)
        loc, conf, landm = net(frames)
        with torch.no_grad():
            targets = B.match_priors(truths, labels, landms, pri, variances,
                                     match_thresh, valid)
        losses = multibox_loss((loc, conf, landm), targets,
                               neg_pos_ratio=neg_pos_ratio,
                               loc_weight=loc_weight)
        losses["loss"].backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {k: v.detach() for k, v in losses.items()}

    return step


@contextlib.contextmanager
def evaluating(net):
    """``net`` in eval mode with softmax scores for the duration, then
    back in its mode and phase. Kernel K6's cached weight folds are
    dropped first: they key on tensor versions, which some optimizers'
    in-place writes leave as they were."""
    was_training, phase = net.training, net.phase
    kernels.forget_folds(net)
    net.eval()
    net.phase = "test"
    try:
        with torch.no_grad():
            yield net
    finally:
        net.phase = phase
        net.train(was_training)


def make_eval_fns(rf):
    """(conf_fn, detect_fn) on the detector ``rf`` (a ``RetinaFace``
    whose ``net`` may be the net under training): conf_fn(frames) -> the
    face scores [B, A]; detect_fn(frames) -> ``rf.detect_padded(frames)``
    (K6, then K3; ``vis_thres``, ``out_cap``). Both run the net in eval
    mode."""

    def conf_fn(frames):
        with evaluating(rf.net) as net:
            return net(frames)[1][..., 1]

    def detect_fn(frames):
        with evaluating(rf.net):
            return rf.detect_padded(frames)

    return conf_fn, detect_fn


def _on(rf, frames_u8):
    return torch.from_numpy(np.ascontiguousarray(frames_u8)).to(rf.device)


def conf_sparsity(rf, frames_u8, conf_thres=None, conf_fn=None):
    """Mean anchors a frame above the confidence filter: the candidate
    count NMS sees (every anchor, with random weights)."""
    conf_thres = rf.conf_thres if conf_thres is None else conf_thres
    conf_fn = conf_fn or make_eval_fns(rf)[0]
    score = conf_fn(_on(rf, frames_u8)).cpu().numpy()
    return float((score > conf_thres).sum(axis=1).mean())


def detection_recall(rf, frames_u8, gt_boxes, gt_valid, iou=0.5,
                     detect_fn=None):
    """Share of the ground-truth faces (px boxes [B, G, 4], valid [B, G])
    that a detection of the full detect path (decode, top-k, NMS,
    ``vis_thres``) overlaps by IoU >= ``iou``."""
    detect_fn = detect_fn or make_eval_fns(rf)[1]
    boxes, _, _, valid = (t.cpu().numpy()
                          for t in detect_fn(_on(rf, frames_u8)))
    hit = 0
    total = 0
    for b in range(frames_u8.shape[0]):
        det = boxes[b][valid[b]]
        for g in np.nonzero(gt_valid[b])[0]:
            total += 1
            gt = gt_boxes[b, g]
            if det.size == 0:
                continue
            x1 = np.maximum(det[:, 0], gt[0])
            y1 = np.maximum(det[:, 1], gt[1])
            x2 = np.minimum(det[:, 2], gt[2])
            y2 = np.minimum(det[:, 3], gt[3])
            inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
            a_det = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
            a_gt = (gt[2] - gt[0]) * (gt[3] - gt[1])
            if (inter / (a_det + a_gt - inter + 1e-9)).max() >= iou:
                hit += 1
    return hit / max(total, 1)
