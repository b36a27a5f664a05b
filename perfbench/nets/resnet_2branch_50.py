"""The 2-branch ResNet-50 emotion net (tag and projection heads), seeded."""

from perfbench import counts
from perfbench.reference import nets
from perfbench.weights import on_device, seeded_state

KIND = "emotion"


def _reference_module(spec):
    return nets.ResNet2Branch(**spec["args"])


def _state(spec, seed, device):
    return seeded_state(_reference_module, spec, seed, "emotion", device)


def program(spec, dtype, device, seed):
    from vn_celeb_face_recognition_tpu_torch.models import (
        resnet_2branch_50,
    )

    return on_device(lambda: resnet_2branch_50(dtype=dtype, **spec["args"]),
                     device, _state(spec, seed, device))


def reference(spec, seed, device):
    return on_device(lambda: _reference_module(spec), device,
                     _state(spec, seed, device))


def flops(spec, ctx):
    """Model FLOPs on one face, at the emotion net's input size."""
    return counts.model_flops(counts.meta_module(
        lambda: _reference_module(spec)), 1, 3, spec["size"], spec["size"])
