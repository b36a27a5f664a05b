"""The embedding classifier (two linear layers, log-softmax), seeded."""

from perfbench import counts
from perfbench.reference import nets
from perfbench.weights import on_device, seeded_state

KIND = "classifier"


def _reference_module(spec):
    return nets.MLP(**spec["args"])


def _state(spec, seed, device):
    return seeded_state(_reference_module, spec, seed, "classifier", device)


def program(spec, dtype, device, seed):
    from vn_celeb_face_recognition_tpu_torch.models import MLPModel

    return on_device(lambda: MLPModel(**spec["args"]), device,
                     _state(spec, seed, device))


def reference(spec, seed, device):
    return on_device(lambda: _reference_module(spec), device,
                     _state(spec, seed, device))


def flops(spec, ctx):
    """Model FLOPs on one face's embedding."""
    return counts.model_flops(counts.meta_module(
        lambda: _reference_module(spec)), 1, spec["args"]["input_dim"])
