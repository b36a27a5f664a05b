"""The embedding classifier head: Linear(input_dim -> 2048) -> ReLU ->
Dropout(dropout_prob) -> Linear(2048 -> num_classes) -> log_softmax.
Counterpart of ``vn_celeb_face_recognition_tpu/models/mlp.py``.

Dropout acts in train mode only, with its mask drawn from the
``generator`` passed to ``forward`` (the trainer's, on the input's
device); in eval mode the module computes the two layers alone.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import linear


def dropout(x, p, generator):
    """Zero each element with probability ``p`` and scale the rest by
    1 / (1 - p), the mask drawn from ``generator``."""
    if p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


class MLPModel(nn.Module):
    def __init__(self, input_dim, num_classes, dropout_prob=0.5):
        super().__init__()
        self.dropout_prob = float(dropout_prob)
        self.dense_1 = nn.Linear(input_dim, 2048)
        self.dense_2 = nn.Linear(2048, num_classes)

    def forward(self, x, generator=None):
        x = F.relu(linear(self.dense_1, x))
        if self.training:
            x = dropout(x, self.dropout_prob, generator)
        return F.log_softmax(linear(self.dense_2, x), dim=-1)
