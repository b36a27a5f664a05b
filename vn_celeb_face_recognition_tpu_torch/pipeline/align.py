"""Face alignment: canonical 5-point templates per output size (the
published ArcFace/insightface coordinates) and the similarity warp onto
them. Counterpart of ``vn_celeb_face_recognition_tpu/pipeline/align.py``.

* ``align_crops(crops, landmarks, template, out_size)``: every face of a
  call in one warp. Each crop is zero-padded into an N x N f32 window (the
  crop at its origin, N the largest crop side of the call), the Umeyama
  similarity maps its landmarks onto the template, and one launch of K1's
  windows form (``ops.warp.similarity_warp``) warps every window. The
  padding is zero where ``warp_affine`` puts its zero border, so this is
  the JAX package's per-crop warp exactly.
* ``alignment(img, src, dst, w, h)``: the single-face API with the
  reference's argument order, through ``align_crops``.
* ``align_faces_batch(images, image_idx, landmarks, template, out_size)``:
  float frames and a padded face set in, the JAX package's batched
  alignment: the batched Umeyama solve, then ``ops.image``'s
  ``batched_warp_affine`` (plain torch gathers, as in the JAX package).

Both round integer crops and clip them to 0-255 in their dtype, as the
JAX package does (``torch.round`` rounds half to even, as ``np.round``).
"""

import numpy as np
import torch

from ..ops.image import batched_warp_affine
from ..ops.similarity import umeyama_similarity
from ..ops.warp import similarity_warp
from ..utils.device import select_device

center_point_dict = {
    "(96, 112)": np.array([
        [30.2946, 51.6963],
        [65.5318, 51.5014],
        [48.0252, 71.7366],
        [33.5493, 92.3655],
        [62.7299, 92.2041],
    ], dtype=np.float32),
    "(112, 112)": np.array([
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ], dtype=np.float32),
    "(150, 150)": np.array([
        [51.287415, 69.23612],
        [98.48009, 68.97509],
        [75.03375, 96.075806],
        [55.646385, 123.7038],
        [94.72754, 123.48763],
    ], dtype=np.float32),
    "(160, 160)": np.array([
        [54.706573, 73.85186],
        [105.045425, 73.573425],
        [80.036, 102.48086],
        [59.356144, 131.95071],
        [101.04271, 131.72014],
    ], dtype=np.float32),
    "(224, 224)": np.array([
        [76.589195, 103.3926],
        [147.0636, 103.0028],
        [112.0504, 143.4732],
        [83.098595, 184.731],
        [141.4598, 184.4082],
    ], dtype=np.float32),
}


def pad_windows(crops):
    """K crops [h_i, w_i, 3] of one dtype -> [K, N, N, 3] numpy windows,
    each crop at its window's origin and zero elsewhere, N the largest
    crop side."""
    n = max(max(np.shape(c)[:2]) for c in crops)
    windows = np.zeros((len(crops), n, n, 3), np.asarray(crops[0]).dtype)
    for window, crop in zip(windows, crops):
        h, w = np.shape(crop)[:2]
        window[:h, :w] = crop
    return windows


def align_crops(crops, landmarks, template, out_size, device="cuda"):
    """Warp each crop so its landmarks land on ``template``.

    crops: K arrays [h_i, w_i, 3] (uint8 or float, one dtype); landmarks:
    [K, 5, 2] in each crop's coordinates; template: [5, 2] in the output
    face; out_size: (w, h). Runs on ``device`` (the card unless ``"cpu"``
    is asked for). Returns [K, h, w, 3] numpy in the crops' dtype.
    """
    out_w, out_h = int(out_size[0]), int(out_size[1])
    if len(crops) == 0:
        return np.zeros((0, out_h, out_w, 3), np.uint8)
    dev = select_device(device)
    windows = pad_windows(crops)
    dtype = windows.dtype
    windows = torch.from_numpy(windows).to(dev).to(torch.float32)
    lms = torch.as_tensor(np.asarray(landmarks, np.float32), device=dev)
    tpl = torch.as_tensor(np.asarray(template, np.float32), device=dev)
    mats = umeyama_similarity(lms, tpl)
    # a square warp of side max(w, h), cut to h x w: each output pixel
    # depends on its own coordinates only
    out = similarity_warp(windows, mats, max(out_w, out_h))[:, :out_h, :out_w]
    if np.issubdtype(dtype, np.integer):
        out = torch.clamp(torch.round(out), 0, 255)
    return out.cpu().numpy().astype(dtype)


def alignment(cv_img, src, dst, dst_w, dst_h, device="cuda"):
    """Warp ``cv_img`` [H, W, 3] so the detected landmarks ``dst`` land on
    the canonical template ``src`` (the reference's argument order).
    Returns [dst_h, dst_w, 3] in the image's dtype."""
    return align_crops([np.asarray(cv_img)], np.asarray(dst)[None], src,
                       (dst_w, dst_h), device=device)[0]


def align_faces_batch(images, image_idx, landmarks, template, out_size,
                      device="cuda"):
    """Warp every face of a padded set so its landmarks land on
    ``template``.

    images: [B, H, W, 3] float frames; image_idx: [K] frame of each face;
    landmarks: [K, 5, 2] in frame coordinates; template: [5, 2];
    out_size: (w, h). Arrays or tensors; runs on ``device`` (the card
    unless ``"cpu"`` is asked for). Returns a [K, h, w, 3] f32 tensor on
    that device."""
    dev = select_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    mats = umeyama_similarity(torch.as_tensor(landmarks, **f32),
                              torch.as_tensor(template, **f32))
    return batched_warp_affine(
        torch.as_tensor(images, **f32),
        torch.as_tensor(image_idx, dtype=torch.int64, device=dev), mats,
        (int(out_size[1]), int(out_size[0])))
