"""A run on the CPU at a small size (two 2-frame chunks, 8 or 16 face
slots, the published widths), with the chip check skipped: sound, it is
correct; with the program's bfloat16 path (the control) or with the timed
path broken underneath, ``correct`` comes out false."""

import pytest
import torch

from perfbench import harness

SMALL = {"chunk_frames": 2, "pool_chunks": 2,
         "engine": {"target_fs": 112, "face_window": 224,
                    "face_cap": [8, 16]}}
CELLS = ["retinaface_arcface.crowd", "mtcnn_facenet.crowd"]


def small_run(cell, dtype=None):
    torch.set_num_threads(2)
    return harness.run(cell, 2 ** 31 + 101, 0.5, device="cpu",
                       dtype=dtype, overrides=SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = small_run(cell)
    assert res["correct"], res["checks"]
    assert res["judged"]["faces"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    assert not small_run(cell, dtype="bfloat16")["correct"]


def half_the_faces_left_out(monkeypatch):
    """The encoder embeds every other face of its batch; the faces left
    out get the mean of those."""
    from vn_celeb_face_recognition_tpu_torch.models.inception_resnet_v1 \
        import InceptionResnetV1
    from vn_celeb_face_recognition_tpu_torch.models.iresnet import IResNet

    for cls in (IResNet, InceptionResnetV1):
        forward = cls.forward

        def half(self, x, *args, _forward=forward, **kwargs):
            y = _forward(self, x[0::2], *args, **kwargs)
            out = y.mean(0, keepdim=True).repeat(x.shape[0], 1)
            out[0::2] = y
            return out

        monkeypatch.setattr(cls, "forward", half)


def a_class_altered(monkeypatch):
    """The classifier's answer for its first face moves to another
    class."""
    from vn_celeb_face_recognition_tpu_torch.models.mlp import MLPModel

    forward = MLPModel.forward

    def altered(self, x, *args, **kwargs):
        logp = forward(self, x, *args, **kwargs)
        logp[0] = torch.roll(logp[0], 1)
        return logp

    monkeypatch.setattr(MLPModel, "forward", altered)


def a_box_altered(monkeypatch):
    """The detector's first face of every frame moves 4 px right."""
    from vn_celeb_face_recognition_tpu_torch.models.mtcnn import MTCNN
    from vn_celeb_face_recognition_tpu_torch.models.retinaface import (
        RetinaFace,
    )

    for cls in (MTCNN, RetinaFace):
        detect = cls.detect_padded

        def moved(self, frames, _detect=detect):
            out = list(_detect(self, frames))
            out[0] = out[0].clone()
            out[0][:, 0, 0::2] += 4.0
            out[2] = out[2].clone()
            out[2][:, 0, :, 0] += 4.0
            return tuple(out)

        monkeypatch.setattr(cls, "detect_padded", moved)


def batch_norm_shift_dropped(monkeypatch):
    """Every BatchNorm of the encoders and the emotion net leaves out its
    shift (beta), as a fold that forgets it would."""
    import torch.nn.functional as F
    from vn_celeb_face_recognition_tpu_torch.models import (
        inception_resnet_v1, iresnet, resnet_2_branch,
    )

    def no_shift(m, x):
        return F.batch_norm(x, m.running_mean, m.running_var, m.weight, None,
                            False, 0.0, m.eps)

    for mod in (inception_resnet_v1, iresnet, resnet_2_branch):
        monkeypatch.setattr(mod, "batch_norm", no_shift)


def the_second_class_named(monkeypatch):
    """The engine names each face's second-best class, with that class's
    probability; the classifier's log-probabilities are left as they
    are."""
    from vn_celeb_face_recognition_tpu_torch.pipeline import engine

    class SecondArgmax:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def argmax(x, dim):
            return torch.topk(x, 2, dim=dim).indices.select(dim, 1)

    monkeypatch.setattr(engine, "torch", SecondArgmax())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [half_the_faces_left_out, a_class_altered,
                                   a_box_altered, batch_norm_shift_dropped,
                                   the_second_class_named])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = small_run(cell)
    assert not res["correct"], res["checks"]
