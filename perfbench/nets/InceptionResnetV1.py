"""FaceNet's InceptionResnetV1 embedding encoder, seeded."""

from perfbench import counts
from perfbench.reference import nets
from perfbench.weights import on_device, seeded_state

KIND = "encoder"


def _reference_module(spec):
    return nets.InceptionResnetV1(**spec["args"])


def _state(spec, seed, device):
    return seeded_state(_reference_module, spec, seed, "encoder", device)


def program(spec, dtype, device, seed):
    from vn_celeb_face_recognition_tpu_torch.models import (
        InceptionResnetV1,
    )

    return on_device(lambda: InceptionResnetV1(dtype=dtype, **spec["args"]),
                     device,
                     _state(spec, seed, device))


def reference(spec, seed, device):
    return on_device(lambda: _reference_module(spec), device,
                     _state(spec, seed, device))


def flops(spec, ctx):
    """Model FLOPs on one face, at the engine's face size."""
    size = ctx.cfg["engine"]["target_fs"]
    return counts.model_flops(counts.meta_module(
        lambda: _reference_module(spec)), 1, 3, size, size)
