"""Closed-form Umeyama similarity transform, batched over faces.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/similarity.py``. In
2-D the least-squares similarity (rotation, isotropic scale,
translation) has a closed form: with demeaned points, s*cos and s*sin
are the normalised dot and cross correlations.
"""

import torch


def umeyama_similarity(src, dst):
    """Least-squares similarity mapping src -> dst.

    src: [..., N, 2] (e.g. detected landmarks); dst: [..., N, 2] or
    [N, 2] (e.g. the canonical template, broadcast over faces).
    Returns [..., 2, 3] with dst ~= M[:, :2] @ src + M[:, 2].
    """
    dst = dst.to(src.dtype).expand_as(src)
    src_mean = src.mean(dim=-2)
    dst_mean = dst.mean(dim=-2)
    src_c = src - src_mean[..., None, :]
    dst_c = dst - dst_mean[..., None, :]

    den = torch.clamp((src_c ** 2).sum(dim=(-2, -1)), min=1e-12)
    a = (src_c * dst_c).sum(dim=(-2, -1)) / den
    b = (src_c[..., 0] * dst_c[..., 1]
         - src_c[..., 1] * dst_c[..., 0]).sum(dim=-1) / den

    tx = dst_mean[..., 0] - (a * src_mean[..., 0] - b * src_mean[..., 1])
    ty = dst_mean[..., 1] - (b * src_mean[..., 0] + a * src_mean[..., 1])
    row0 = torch.stack([a, -b, tx], dim=-1)
    row1 = torch.stack([b, a, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)
