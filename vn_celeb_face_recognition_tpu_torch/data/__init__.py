"""Datasets, the fixed-shape loader and the named transforms (counterpart
of the JAX package's ``data/``)."""

from .datasets import VNCelebDataset, VNCelebEmbDataset
from .loader import DataLoader, prefetch_to_device
from .transforms import get_transform, transforms_dict

__all__ = [
    "VNCelebDataset",
    "VNCelebEmbDataset",
    "DataLoader",
    "prefetch_to_device",
    "transforms_dict",
    "get_transform",
]
