"""Multi-device execution: a ('data', 'model') process-group mesh, its
sharding helpers, the launcher and the DP x TP train step. Counterpart of
``vn_celeb_face_recognition_tpu/parallel/``, in PyTorch's idiom: one
process per device under ``torch.distributed`` (NCCL on cards, gloo on
the CPU)."""

from .collectives import GlobalBatchNorm
from .launch import LaunchError, launch
from .mesh import (
    Mesh,
    data_sharding,
    gather_mlp,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
    shard_mlp,
)
from .train_dp import make_dp_train_step

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated_sharding",
    "shard_batch",
    "make_dp_train_step",
    "launch",
    "LaunchError",
    "Mesh",
    "replicate",
    "shard_mlp",
    "gather_mlp",
    "GlobalBatchNorm",
]
