"""Datasets over the VN-celeb manifest layout.

Counterpart of ``vn_celeb_face_recognition_tpu/data/datasets.py``, with
its on-disk formats: a JSON manifest ``{label: [image_name, ...]}`` next
to a flat directory of images (or of the per-image ``<stem>.npz``
512-d embeddings that ``find_embedding`` writes). Samples come back as
numpy (uint8 HWC RGB images, f32 embeddings); normalisation and
augmentation run on the device in the trainer's step.

Images are decoded by ``utils.frames.read_image`` (PNG in Python, JPEG
through the port's IO runtime, or cv2 where it does not build), not PIL: grey, palette and alpha PNGs
come out as the RGB that ``Image.convert("RGB")`` gives.
"""

from copy import deepcopy
from pathlib import Path

import numpy as np

from ..utils.frames import read_image
from ..utils.io import read_json


class VNCelebDataset:
    """(image uint8 [H, W, 3], int label, path str) triples."""

    def __init__(self, data_dir, label_file, transforms=None):
        self.data_dir = Path(data_dir)
        self.label_dict = read_json(label_file)
        self.transforms = transforms  # name of a device-side transform
        self.n_samples = sum(len(v) for v in self.label_dict.values())
        self.n_classes = len(self.label_dict.keys())
        self.img_names, self.labels = self._get_list_samples_labels()

    def _get_list_samples_labels(self):
        samples, labels = [], []
        for k, v in self.label_dict.items():
            sample_for_cls = deepcopy(v)
            sample_for_cls.sort()
            samples += sample_for_cls
            labels += len(sample_for_cls) * [int(k)]
        return samples, labels

    def __len__(self):
        return self.n_samples

    def __getitem__(self, index):
        img_path = self.data_dir / self.img_names[index]
        return read_image(str(img_path)), self.labels[index], str(img_path)


class VNCelebEmbDataset(VNCelebDataset):
    """(embedding float32 [D], int label, path str) triples from npz."""

    def __getitem__(self, index):
        emb_name = self.img_names[index].split(".")[0]
        emb_path = self.data_dir / "{}.npz".format(emb_name)
        with np.load(str(emb_path)) as z:
            emb = z["arr_0"].astype(np.float32)
        return emb, self.labels[index], str(emb_path)
