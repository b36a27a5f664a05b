"""Named transforms, as batched functions on NHWC float tensors.

Counterpart of ``vn_celeb_face_recognition_tpu/data/transforms.py``. A
transform is ``fn(images, rng=None) -> float32 batch`` on the caller's
device; ``rng`` is ignored by the deterministic transforms.

Registered names (the JAX package's):
  default      -- (x - 127.5) / 128                (fix_std)
  emotion_inf  -- area-resize 224, /255, ImageNet normalise
  prewhiten    -- per-image mean/std whitening
  facenet_aug, rank1_aug -- training augmentations, not ported yet
  none         -- no transform
"""

import torch

from ..ops.image import (
    area_resize,
    fixed_image_standardization,
    imagenet_normalize,
    prewhiten,
)


def transform_default(images, rng=None):
    return fixed_image_standardization(images.to(torch.float32))


def _training_only(name):
    def transform(images, rng=None):
        raise NotImplementedError(
            f"the {name!r} transform is a training augmentation; it is "
            "ported with the online augmentation (ROADMAP.md A.6)")

    transform.__name__ = f"transform_{name}"
    return transform


transform_facenet_aug = _training_only("facenet_aug")
transform_rank1_aug = _training_only("rank1_aug")


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
