"""The embedding classifier head: Linear(input_dim -> 2048) -> ReLU ->
Dropout(dropout_prob) -> Linear(2048 -> num_classes) -> log_softmax.
Counterpart of ``vn_celeb_face_recognition_tpu/models/mlp.py``.

Dropout acts in train mode only, with its mask drawn from the
``generator`` passed to ``forward`` (the trainer's, on the input's
device); in eval mode the module computes the two layers alone.
"""

import torch.nn.functional as F
from torch import nn

from .layers import dropout, linear


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
