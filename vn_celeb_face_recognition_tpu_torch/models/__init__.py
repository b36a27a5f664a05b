"""NCHW ``nn.Module``s with the torch reference's state_dict keys."""

from .iresnet import IResNet, iresnet34, iresnet50, iresnet100
from .mlp import MLPModel
from .resnet_2_branch import ResNet2Branch, resnet_2branch_50
from .retinaface import RetinaFace, RetinaFaceNet

__all__ = [
    "IResNet",
    "iresnet34",
    "iresnet50",
    "iresnet100",
    "MLPModel",
    "ResNet2Branch",
    "resnet_2branch_50",
    "RetinaFace",
    "RetinaFaceNet",
]
