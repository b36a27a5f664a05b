"""The embedding classifier head: Linear(input_dim -> 2048) -> ReLU ->
Dropout(dropout_prob) -> Linear(2048 -> num_classes) -> log_softmax.
Counterpart of ``vn_celeb_face_recognition_tpu/models/mlp.py``.

Dropout acts in train mode only, with its mask drawn from the
``generator`` passed to ``forward`` (the trainer's, on the input's
device); in eval mode the module computes the two layers alone.

Sharded over a mesh's model axis (``parallel.shard_mlp`` sets ``mesh``),
the forward is Megatron's column -> row pairing: ``copy_to_model`` ->
this rank's ``dense_1`` block -> ReLU -> dropout on the local block (its
columns of the global mask) -> the ``dense_2`` partial product ->
``reduce_from_model`` -> + the whole bias -> log_softmax.
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
        self.mesh = None

    def forward(self, x, generator=None):
        mesh = self.mesh
        if mesh is not None and mesh.n_model > 1:
            return self._forward_sharded(x, generator, mesh)
        x = F.relu(linear(self.dense_1, x))
        if self.training:
            x = dropout(x, self.dropout_prob, generator)
        return F.log_softmax(linear(self.dense_2, x), dim=-1)

    def _forward_sharded(self, x, generator, mesh):
        from ..parallel.collectives import copy_to_model, reduce_from_model

        x = F.relu(linear(self.dense_1, copy_to_model(x, mesh)))
        if self.training:
            x = dropout(x, self.dropout_prob, generator,
                        cols=(mesh.m, mesh.n_model))
        w2 = self.dense_2.weight.to(x.dtype)
        y = reduce_from_model(F.linear(x, w2), mesh)
        return F.log_softmax(y + self.dense_2.bias.to(x.dtype), dim=-1)
