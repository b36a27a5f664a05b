"""K3: exact greedy NMS keep mask over a batch of padded box sets.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/nms_pallas.py``
(``nms_keep_mask_pallas``) and of the XLA ``ops/boxes.batched_nms_keep_mask``
the JAX cascade runs. Every NMS of the port (the cascade's four and
RetinaFace's) goes through ``nms_keep_mask``: for CUDA tensors it is one
launch of ``csrc/nms_keep.cu``, no host sync; for CPU tensors it is
``nms_keep_mask_plain``, the fixpoint sweeps below.

The kernel runs one thread block per set. It compacts the valid, non-NaN
rows into a list of 64-bit keys (descending score bits, then the row) by
a block prefix sum; checks in one pass whether that list is already in
priority order, as the sets that come out of a top-k are, and sorts it
with a bitonic network only when it is not; then runs the greedy scan
in tiles of 32 ranks: from per-rank masks of the overlapping earlier
ranks in each tile, built up front, one warp settles a tile's keep bits
with warp votes, then the whole block tests the later ranks against the
tile's kept boxes. It keeps 29 bytes a box in shared memory (box 16, key
8, tile mask 4, suppressed flag 1), so a set holds at most ``MAX_K`` boxes.
"""

import torch

from ..utils import kernels
from .boxes import pairwise_iou

# the kernel keeps 29 bytes a box in shared memory, plus 772 bytes of
# tile buffers (227 KB a block); the automatic caps stay under this
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
    valid = valid.contiguous()  # bool: one byte, 0 or 1, read as it is
    for name, t, dtype in (("boxes", boxes, None), ("scores", scores, None),
                           ("valid", valid, torch.bool)):
        kernels.require_cuda_tensor(t, name, dtype)
    if scores.device != boxes.device or valid.device != boxes.device:
        raise ValueError("boxes, scores and valid must be on one device")
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    if n == 0 or k == 0:
        return keep
    lib = kernels.library()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = lib.vn_nms_keep_mask(boxes.data_ptr(), scores.data_ptr(),
                               valid.data_ptr(), keep.data_ptr(), n, k,
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
