"""Named transforms, as batched functions on NHWC float tensors.

Counterpart of ``vn_celeb_face_recognition_tpu/data/transforms.py``. A
transform is ``fn(images, rng=None) -> float32 batch`` on the caller's
device; ``rng`` is a ``torch.Generator`` on that device, ignored by the
deterministic transforms.

Registered names (the JAX package's):
  default      -- (x - 127.5) / 128                (fix_std)
  facenet_aug  -- rotate +-10, random-crop pad 2, hflip, fix_std
                  (``ops.augment.facenet_aug``: one K1 warp a batch; a
                  uint8 batch is read as it is)
  rank1_aug    -- flip + one of eight photometric augmenters + prewhiten
                  (``ops.augment.rank1_vn_celeb_aug``)
  emotion_inf  -- area-resize 224, /255, ImageNet normalise
  prewhiten    -- per-image mean/std whitening
  none         -- no transform
"""

import torch

from ..ops.augment import facenet_aug, rank1_vn_celeb_aug
from ..ops.image import (
    area_resize,
    fixed_image_standardization,
    imagenet_normalize,
    prewhiten,
)


def transform_default(images, rng=None):
    return fixed_image_standardization(images.to(torch.float32))


def transform_facenet_aug(images, rng):
    if rng is None:
        raise ValueError("facenet_aug draws from a torch.Generator; got None")
    return facenet_aug(rng, images)


def transform_rank1_aug(images, rng):
    if rng is None:
        raise ValueError("rank1_aug draws from a torch.Generator; got None")
    return rank1_vn_celeb_aug(rng, images.to(torch.float32))


def transform_emotion_inf(images, rng=None):
    x = area_resize(images.to(torch.float32), (224, 224)) / 255.0
    return imagenet_normalize(x)


def transform_prewhiten(images, rng=None):
    return torch.vmap(prewhiten)(images.to(torch.float32))


transforms_dict = {
    "default": transform_default,
    "facenet_aug": transform_facenet_aug,
    "rank1_aug": transform_rank1_aug,
    "emotion_inf": transform_emotion_inf,
    "prewhiten": transform_prewhiten,
    "none": None,
}


def get_transform(name):
    if name is None or name == "none":
        return None
    if name not in transforms_dict:
        raise KeyError(
            f"Unknown transform '{name}'; have {sorted(transforms_dict)}")
    return transforms_dict[name]


def with_resize(transform_fn, size):
    """Prepend an area resize to ``size`` x ``size``."""

    def wrapped(images, rng=None):
        resized = area_resize(images.to(torch.float32), (size, size))
        return transform_fn(resized, rng)

    return wrapped
