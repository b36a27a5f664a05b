"""K3: exact greedy NMS keep mask over a batch of padded box sets.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/nms_pallas.py``
(``nms_keep_mask_pallas``) and of the XLA ``ops/boxes.batched_nms_keep_mask``
the JAX cascade runs. Every NMS of the port (the cascade's four and
RetinaFace's) goes through ``nms_keep_mask``: for CUDA tensors it is one
launch of ``csrc/nms_keep.cu`` (one thread block per set, a rank count
and a greedy scan in shared memory, no host sync); for CPU tensors it is
``nms_keep_mask_plain``, the fixpoint sweeps below.
"""

import torch

from ..utils import kernels
from .boxes import pairwise_iou

# the kernel keeps 30 bytes per box in shared memory (227 KB a block)
MAX_K = 7680


def check_set_caps(device_type, **caps):
    """Raise ``ValueError`` when a detector built for the card (``device_type``
    ``"cuda"``) is given an explicit cap (a keyword here, None when the cap
    is automatic) that sizes an NMS set beyond ``MAX_K`` boxes: the kernel
    would refuse that set at the first chunk. The plain version, and so a
    detector on the CPU, takes sets of any size, as the JAX package does."""
    if device_type != "cuda":
        return
    over = {name: int(cap) for name, cap in caps.items()
            if cap is not None and int(cap) > MAX_K}
    if over:
        raise ValueError(f"{over}: on the card an NMS set holds at most "
                         f"ops.nms.MAX_K = {MAX_K} boxes")


def _check(boxes, scores, valid):
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [N, K, 4], got {tuple(boxes.shape)}")
    if scores.shape != boxes.shape[:2] or valid.shape != boxes.shape[:2]:
        raise ValueError(
            f"scores and valid must be {tuple(boxes.shape[:2])}, got "
            f"{tuple(scores.shape)} and {tuple(valid.shape)}")


def nms_keep_mask_plain(boxes, scores, valid, iou_thr, offset=0.0,
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
    _check(boxes, scores, valid)
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


def nms_keep_mask_kernel(boxes, scores, valid, iou_thr, offset=0.0,
                         min_mode=False):
    """The same keep mask from one launch of the CUDA kernel (CUDA
    tensors only)."""
    _check(boxes, scores, valid)
    n, k = scores.shape
    if k > MAX_K:
        raise ValueError(f"at most {MAX_K} boxes per set, got {k}")
    boxes = boxes.to(torch.float32).contiguous()
    scores = scores.to(torch.float32).contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    for name, t in (("boxes", boxes), ("scores", scores),
                    ("valid", valid_u8)):
        kernels.require_cuda_tensor(t, name)
    if scores.device != boxes.device or valid_u8.device != boxes.device:
        raise ValueError("boxes, scores and valid must be on one device")
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    if n == 0 or k == 0:
        return keep
    lib = kernels.library()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = lib.vn_nms_keep_mask(boxes.data_ptr(), scores.data_ptr(),
                               valid_u8.data_ptr(), keep.data_ptr(), n, k,
                               float(iou_thr), float(offset),
                               int(bool(min_mode)), stream)
    kernels.check_cuda(err, "vn_nms_keep_mask")
    kernels.count_launch("nms_keep_mask")
    return keep


def nms_keep_mask(boxes, scores, valid, iou_thr, offset=0.0, min_mode=False):
    """boxes [N, K, 4], scores [N, K], valid [N, K] -> keep [N, K] bool.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    if boxes.is_cuda:
        return nms_keep_mask_kernel(boxes, scores, valid, iou_thr, offset,
                                    min_mode)
    if boxes.device.type != "cpu":
        raise ValueError(f"unsupported device {boxes.device}")
    return nms_keep_mask_plain(boxes, scores, valid, iou_thr, offset,
                               min_mode)
