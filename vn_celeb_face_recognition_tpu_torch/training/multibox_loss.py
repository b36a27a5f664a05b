"""SSD MultiBox loss of RetinaFace training.

Counterpart of ``vn_celeb_face_recognition_tpu/training/multibox_loss.py``:
smooth-L1 box regression (weighted by ``loc_weight``), softmax confidence
with hard negative mining at ``neg_pos_ratio`` negatives a positive, and
smooth-L1 landmark regression on the positives that carry landmarks.
"""

import torch
import torch.nn.functional as F


def smooth_l1(x):
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


@torch.no_grad()
def mined_negatives(ce, pos, neg_pos_ratio):
    """[B, P] bool: the negatives whose loss ranks below ``neg_pos_ratio``
    x the image's positives (at most P - 1), by descending ``ce``; ties go
    to the lower anchor index, as a stable sort gives them."""
    neg_scores = torch.where(pos, torch.full_like(ce, float("-inf")), ce)
    n_pos = pos.sum(dim=1).to(torch.float32)
    # truncated toward zero, as an int32 cast does
    n_neg = torch.clamp((neg_pos_ratio * n_pos).to(torch.int32),
                        max=pos.shape[1] - 1)
    order = torch.argsort(-neg_scores, dim=1, stable=True)
    ranks = torch.arange(pos.shape[1], device=ce.device)
    in_top = ranks[None, :] < n_neg[:, None]
    picked = torch.zeros_like(pos).scatter_(1, order, in_top)
    return picked & ~pos


def multibox_loss(predictions, targets, neg_pos_ratio=7.0, loc_weight=2.0):
    """Args:
      predictions: (loc [B, P, 4], conf_logits [B, P, 2], landm [B, P, 10]).
      targets: (loc_t [B, P, 4], conf_t [B, P] int, landm_t [B, P, 10])
        from ``ops.boxes.match_priors``; conf_t 0 background, 1 a face,
        -1 a face without landmarks.

    Returns dict(loss, loss_loc, loss_conf, loss_landm) of 0-d tensors.
    """
    loc, conf, landm = predictions
    loc_t, conf_t, landm_t = targets

    pos_landm = conf_t > 0
    pos = conf_t != 0
    n_pos = torch.clamp(pos.sum().to(torch.float32), min=1.0)
    n_pos_landm = torch.clamp(pos_landm.sum().to(torch.float32), min=1.0)

    loss_landm = (smooth_l1(landm - landm_t).sum(-1)
                  * pos_landm).sum() / n_pos_landm
    loss_loc = (smooth_l1(loc - loc_t).sum(-1) * pos).sum() / n_pos

    logp = F.log_softmax(conf, dim=-1)
    ce = -torch.gather(logp, -1, pos.long()[..., None])[..., 0]
    chosen = pos | mined_negatives(ce.detach(), pos, neg_pos_ratio)
    loss_conf = (ce * chosen).sum() / n_pos

    return {
        "loss": loc_weight * loss_loc + loss_conf + loss_landm,
        "loss_loc": loss_loc,
        "loss_conf": loss_conf,
        "loss_landm": loss_landm,
    }
