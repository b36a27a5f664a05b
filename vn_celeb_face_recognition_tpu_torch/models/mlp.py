"""The embedding classifier head: Linear(input_dim -> 2048) -> ReLU ->
Linear(2048 -> num_classes) -> log_softmax (dropout is a no-op at
inference). Counterpart of ``vn_celeb_face_recognition_tpu/models/mlp.py``.
"""

import torch.nn.functional as F
from torch import nn

from .layers import linear


class MLPModel(nn.Module):
    def __init__(self, input_dim, num_classes):
        super().__init__()
        self.dense_1 = nn.Linear(input_dim, 2048)
        self.dense_2 = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = F.relu(linear(self.dense_1, x))
        return F.log_softmax(linear(self.dense_2, x), dim=-1)
