"""The port's RetinaFace ``cfg_re50`` (``ResNet50Body``: the torchvision
ResNet-50 trunk tapped at layer2-4, FPN and SSH at 256 channels) against
the JAX package on the CPU. The repo has no fitted re50 weights, so both
packages run the port's seeded net (``RetinaFace``'s seeded init: the
JAX package's lecun-normal weights and identity BatchNorm), carried into
flax by ``models.convert``. Its box and landmark offsets reach ~100, so
its boxes lie far off the frame; where the decode or the library is
tested, its offset heads are scaled by ``chip_smoke.shrink_re50_offsets``
and the boxes lie near their priors, inside the frame.

Tolerances: head outputs within rtol 1e-3 and atol 1e-4 (the JAX
package's mnet head test's, ``tests/test_retinaface_parity.py``) at 96
and 128 px; at 640 px within atol 1e-3, its re50 test's: there 1 of
134,400 values (~0.016) misses atol 1e-4 by 3.1e-5. The seeded net's scores nearly
tie (many round to 1.0 in f32), so the detector's decode, top-k, NMS,
``keep_top_k`` and ``vis_thres`` are compared by feeding both packages'
detectors the same head outputs (the flax net's): equal face counts and
scores, boxes and landmarks within 1e-2 px."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.models import retinaface as JR
from vn_celeb_face_recognition_tpu_torch import models as PM
from vn_celeb_face_recognition_tpu_torch.cli import demo_image as t_image
from vn_celeb_face_recognition_tpu_torch.models import retinaface as TR
from vn_celeb_face_recognition_tpu_torch.models.convert import (
    state_dict_from_jax,
    state_dict_to_jax,
)
from vn_celeb_face_recognition_tpu_torch.pipeline import center_point_dict
from vn_celeb_face_recognition_tpu_torch.pipeline import recognition as TRec
from vn_celeb_face_recognition_tpu_torch.pipeline.engine import (
    FusedRecognitionEngine,
)
from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames

from chip_smoke import shrink_re50_offsets
from test_torch_cli import cli_args, files  # noqa: F401
from torch_shared import two_threads  # noqa: F401 (autouse)

SUB = np.array(TR.CHANNELS_SUBTRACT, np.float32)


@pytest.fixture(scope="module")
def re50():
    """(the port's seeded re50 detector, the flax net, its variables on the
    same weights)."""
    det = TR.RetinaFace(backbone_cfg="cfg_re50", device="cpu")
    jnet = JR.RetinaFaceNet(backbone="Resnet50", out_channel=256)
    return det, jnet, state_dict_to_jax(det.net)


@pytest.fixture(scope="module")
def re50_near(re50):
    """``re50`` with its offset heads shrunk: boxes inside the frame."""
    det = TR.RetinaFace(backbone_cfg="cfg_re50", device="cpu")
    shrink_re50_offsets(torch, det.net)
    return det, re50[1], state_dict_to_jax(det.net)


def heads(jnet, jvars, frames):
    loc, conf, ldm = jnet.apply(jvars, jnp.asarray(
        frames.astype(np.float32) - SUB))
    return np.asarray(loc), np.asarray(conf), np.asarray(ldm)


@pytest.mark.parametrize("size", [96, 128, pytest.param(
    640, marks=pytest.mark.slow)])
def test_re50_head_outputs_match_flax(re50, size):
    """The port's net takes the uint8 frames and subtracts the channel
    means in torch before conv1; flax takes the subtracted frames."""
    det, jnet, jvars = re50
    frames = build_frames(2, size, 1, size // 2)
    want = heads(jnet, jvars, frames)
    with torch.no_grad():
        got = [t.numpy() for t in det.net(torch.from_numpy(frames))]
    n_anchors = sum((size // s) ** 2 * 2 for s in (8, 16, 32))
    for g, w, dims in zip(got, want, (4, 2, 10)):
        assert g.shape == (2, n_anchors, dims) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-3,
                                   atol=1e-4 if size < 640 else 1e-3)


def test_re50_keys_match_flax_and_convert_round_trips(re50):
    """The body's keys (``body.conv1``, ``body.bn1``,
    ``body.layerN.i.{conv,bn}1..3``, ``downsample.0/1``) are flax's, and
    state_dict_to_jax inverts state_dict_from_jax, bit for bit."""
    det, jnet, jvars = re50
    init = jax.tree_util.tree_map(np.asarray, jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    keys = {k for k in det.net.state_dict()
            if not k.endswith("num_batches_tracked")}
    assert keys == set(state_dict_from_jax(init))
    assert {"body.conv1.weight", "body.bn1.running_mean",
            "body.layer4.2.conv3.weight", "body.layer2.0.downsample.1.weight",
            "fpn.output3.0.weight", "ssh3.conv7x7_3.1.running_var"} <= keys
    back = state_dict_to_jax(state_dict_from_jax(init))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(init)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(init)):
        np.testing.assert_array_equal(a, b)


class _FixedJaxNet:
    def __init__(self, outputs):
        self.outputs = tuple(jnp.asarray(o) for o in outputs)

    def apply(self, variables, x, train=False):
        return self.outputs


@pytest.mark.parametrize("thresholds", [
    {}, {"vis_thres": 0.9, "keep_top_k": 5}, {"nms_thres": 0.2,
                                              "nms_cap": 64}],
    ids=["defaults", "vis0.9-top5", "nms0.2-cap64"])
def test_re50_inference_matches_jax_on_the_same_head_outputs(
        re50_near, tmp_path, thresholds):
    """Both detectors built from the same torch-keyed .npz and fed the flax
    net's head outputs on 2 frames of 128 px: equal face counts and
    scores, boxes and landmarks within 1e-2 px."""
    det, jnet, jvars = re50_near
    path = str(tmp_path / "re50.npz")
    np.savez(path, **{k: v.numpy() for k, v in det.net.state_dict().items()
                      if not k.endswith("num_batches_tracked")})
    frames = build_frames(2, 128, 1, 64)
    outputs = heads(jnet, jvars, frames)
    jdet = JR.RetinaFace(backbone_cfg="cfg_re50", weights_path=path,
                         **thresholds)
    jdet.net = _FixedJaxNet(outputs)
    tdet = TR.RetinaFace(backbone_cfg="cfg_re50", weights_path=path,
                         device="cpu", **thresholds)
    for k, v in det.net.state_dict().items():
        assert torch.equal(tdet.net.state_dict()[k], v), k
    tdet.net = lambda x: tuple(torch.from_numpy(np.array(o)) for o in outputs)
    want = jdet.inference(list(frames))
    got = tdet.inference(list(frames))
    assert [len(b) for b in got[0]] == [len(b) for b in want[0]]
    assert sum(len(b) for b in got[0]) > 0
    for g, w, tol in zip(got, want, (1e-2, 0.0, 1e-2)):
        for gi, wi in zip(g, w):
            np.testing.assert_allclose(gi, wi, rtol=0, atol=tol)


def test_seeded_re50_is_deterministic_and_calibrated():
    """Every build seeds the same weights, as the JAX package inits its
    net: lecun-normal convolutions (std 1/sqrt(fan_in)) and identity
    BatchNorm, with which the decode of a 640 px frame of faces is finite;
    a dict config and the name give the same net."""
    a = TR.RetinaFace(backbone_cfg="cfg_re50", device="cpu")
    b = TR.RetinaFace(backbone_cfg=TR.cfg_re50, device="cpu")
    assert isinstance(a.net.body, TR.ResNet50Body)
    for k, v in a.net.state_dict().items():
        assert torch.equal(b.net.state_dict()[k], v), k
    bn = a.net.body.layer3[0].bn2
    assert float(bn.running_var.min()) == float(bn.running_var.max()) == 1.0
    w = a.net.body.layer3[0].conv2.weight.detach()
    assert abs(float(w.std()) * (w[0].numel() ** 0.5) - 1.0) < 0.01
    boxes, scores, _ = a.inference(build_frames(1, 640, 4)[0])
    assert len(boxes[0]) > 0 and np.isfinite(boxes[0]).all()
    with pytest.raises(KeyError):
        TR.RetinaFace(backbone_cfg="cfg_re18", device="cpu")


def test_re50_runs_the_library_and_the_engine(re50_near):
    """The recognition library (parallel_detect_and_align, recognize_celeb)
    and the fused engine take the re50 detector as they take mnet: 112 px
    faces, one name a kept face, the engine's capped boxes."""
    det, _, _ = re50_near
    det.keep_top_k = 3
    try:
        frames = build_frames(2, 160, 1, 80)
        faces, boxes = TRec.parallel_detect_and_align(
            list(frames), det, center_point_dict["(112, 112)"],
            (112, 112))
        assert [len(f) for f in faces] == [len(b) for b in boxes]
        assert 0 < sum(len(f) for f in faces) <= 6
        assert all(f.shape == (112, 112, 3) for fs in faces for f in fs)
        enc = TRec.Encoder(PM.build_model("iresnet34"), device="cpu")
        clf = TRec.Classifier(PM.build_model("MLPModel", input_dim=512,
                                             num_classes=5), device="cpu")
        names = TRec.recognize_celeb(faces, None, enc, clf, None,
                                     {i: f"P{i}" for i in range(5)}, 0.0)
        assert [len(n) for n in names] == [len(f) for f in faces]
    finally:
        det.keep_top_k = 750
    engine = FusedRecognitionEngine(
        det, PM.build_model("iresnet34"), PM.build_model(
            "MLPModel", input_dim=512, num_classes=5), target_fs=112,
        face_cap=8)
    out = engine.process(build_frames(2, 160, 1, 80))
    assert out["boxes"].shape[:2] == (2, det.out_cap)
    assert torch.isfinite(out["boxes"]).all()


def test_demo_image_takes_a_re50_detector_json(tmp_path, files):  # noqa: F811
    """demo_image's -det RetinaFace -dargs <json> with cfg_re50 and no
    weights: the detector is seeded (offset heads shrunk, as the fixture's)
    and the image is recognised."""
    with open("cfg/detection/retina_face.json") as fp:
        cfg = json.load(fp)
    cfg.update(backbone_cfg="cfg_re50", keep_top_k=2)
    del cfg["weights_path"]
    path = tmp_path / "re50.json"
    path.write_text(json.dumps(cfg))
    parser = t_image.build_arg_parser()
    args = cli_args(parser, files, detection="RetinaFace",
                    detection_args=str(path), device="cpu",
                    target_face_size=160)
    models = t_image.setup_models(args)
    assert models[1].cfg is TR.cfg_re50
    shrink_re50_offsets(torch, models[1].net)
    names, boxes, _, _ = t_image.recognize_image(
        args, models, build_frames(1, 256, 1, 128)[0])
    assert 0 < len(names) == len(boxes) <= 2
