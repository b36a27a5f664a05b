"""The production slice as a whole: the port's FusedRecognitionEngine with
RetinaFace (fitted weights), a shallow iresnet, the 2-branch emotion head
and an MLP, on the CPU, against the JAX FusedRecognitionEngine on the
same frames and weights.

The JAX engine warps faces with its 3-shear TPU formulation by default;
the port computes the exact bilinear warp (kernel K1), so the JAX engine
is given the JAX package's exact ``warp_affine`` here, as the K1 parity
tests do. Its emotion stem and bottleneck kernels (K7, K8) and its
stage-1 kernel (K6) run in interpret mode where a case turns them on."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import vn_celeb_face_recognition_tpu.pipeline.engine as jengine_mod
from vn_celeb_face_recognition_tpu.models import iresnet as JI
from vn_celeb_face_recognition_tpu.models import retinaface as JR
from vn_celeb_face_recognition_tpu.models import resnet_2branch_50 as jres50
from vn_celeb_face_recognition_tpu.models.mlp import MLPModel as JMLP
from vn_celeb_face_recognition_tpu.ops.image import warp_affine
from vn_celeb_face_recognition_tpu_torch.models import IResNet, MLPModel
from vn_celeb_face_recognition_tpu_torch.models import mtcnn as TM
from vn_celeb_face_recognition_tpu_torch.models import retinaface as TR
from vn_celeb_face_recognition_tpu_torch.pipeline.engine import (
    FusedRecognitionEngine as TEngine,
)
from vn_celeb_face_recognition_tpu_torch.utils import kernels
from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames

from test_torch_emotion import emotion_pair
from test_torch_encoder import load_pair
from torch_shared import two_threads  # noqa: F401 (autouse)

SHALLOW = (1, 1, 1, 1)
N_CLASSES, TAGS, TOPK = 40, 17, 6
FACE_CAP = 12  # < 2 frames x out_cap 16 slots, so compaction runs


def exact_warp(windows, mats, fs):
    return jax.vmap(lambda img, m: warp_affine(img, m, (fs, fs)))(windows,
                                                                  mats)


@pytest.fixture(scope="module")
def setup():
    frames = build_frames(2, 192, 4, 80)
    enc, enc_vars = load_pair(IResNet(SHALLOW), seed=31)
    clf, clf_vars = load_pair(MLPModel(512, N_CLASSES), seed=32)
    emo, emo_vars = emotion_pair(seed=33, num_classes=TAGS)
    engine = TEngine(TR.RetinaFace(weights_path=TR.WEIGHTS_NPZ,
                                   device="cpu"),
                     enc, clf, target_fs=112, face_cap=FACE_CAP, emotion=emo,
                     emotion_topk=TOPK)
    before = kernels.launch_counts()
    got = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in engine.process(frames).items()}
    assert kernels.launch_counts() == before  # CPU: plain versions only
    return frames, engine, got, (enc_vars, clf_vars, emo_vars)


@pytest.mark.parametrize("flags", [
    {},
    {"planar_stage1": True, "fused_emotion_stem": True},
    {"fused_bottlenecks": True},
], ids=["xla", "planar_s1+fused_stem", "fused_bottlenecks"])
def test_production_engine_matches_jax_engine(setup, flags, monkeypatch):
    frames, _, got, (enc_vars, clf_vars, emo_vars) = setup
    monkeypatch.setattr(jengine_mod, "batched_similarity_warp", exact_warp)
    flags = dict(flags)
    jdet = JR.RetinaFace(weights_path=TR.WEIGHTS_NPZ,
                         planar_stage1=flags.pop("planar_stage1", None))
    jeng = jengine_mod.FusedRecognitionEngine(
        jdet, JI.IResNet(layers=SHALLOW), enc_vars, JMLP(512, N_CLASSES),
        clf_vars, target_fs=112, face_cap=FACE_CAP,
        emotion=jres50(num_classes=TAGS), emotion_variables=emo_vars,
        emotion_topk=TOPK, **flags)
    for flag in ("fused_emotion_stem", "fused_bottlenecks"):
        assert getattr(jeng, flag) == bool(flags.get(flag))
    want = jax.device_get(jeng.process(frames))
    v = np.asarray(want["valid"])
    assert v.sum() >= 4
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], atol=1e-3)
    e, r = got["embeddings"][v], want["embeddings"][v]
    cos = (e * r).sum(-1) / (np.linalg.norm(e, axis=-1)
                             * np.linalg.norm(r, axis=-1))
    assert cos.min() > 0.9999, cos
    np.testing.assert_array_equal(got["pred"][v], want["pred"][v])
    assert got["emotion_idx"].shape == (2, 16, TOPK)
    np.testing.assert_array_equal(got["emotion_idx"][v],
                                  want["emotion_idx"][v])
    np.testing.assert_allclose(got["emotion_prob"][v],
                               want["emotion_prob"][v], rtol=5e-3,
                               atol=5e-4)
    assert "sat_counts" not in got  # RetinaFace reports no saturation


def test_identify_returns_emotion_per_face(setup):
    _, engine, got, _ = setup
    out = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in got.items()}
    names = {label: f"P{label}" for label in range(N_CLASSES)}
    results = engine.identify(out, names, 0.0)
    assert len(results) == 2
    for i, (frame_names, boxes, idx, prob) in enumerate(results):
        v = got["valid"][i]
        assert len(frame_names) == len(boxes) == len(idx) == len(prob) \
            == v.sum()
        assert frame_names == [f"P{p}" for p in got["pred"][i][v]]
        for j, k in enumerate(np.nonzero(v)[0]):
            np.testing.assert_array_equal(idx[j], got["emotion_idx"][i][k])
            assert np.all(np.diff(prob[j]) <= 0) and prob[j].shape == (TOPK,)


class _NoSaturation:
    """An MTCNN that reports saturation counts but cannot warn."""

    def __init__(self, det):
        self.device, self.out_cap = det.device, det.out_cap
        self.detect_padded = det.detect_padded


def test_engine_is_detector_agnostic(setup):
    """identify warns about saturation only where the detector reports
    counts and can warn: a 4-tuple detector (RetinaFace) and a 5-tuple
    one without ``warn_capacity_saturation`` both run; MTCNN still
    warns."""
    frames, engine, got, _ = setup
    enc, clf = engine.encoder, engine.classifier
    mtcnn = TM.MTCNN(min_face_size=20, device="cpu", pnet_cap_per_scale=4,
                     out_cap=4)
    for det, warns in ((engine.detector, False), (_NoSaturation(mtcnn), False),
                       (mtcnn, True)):
        eng = TEngine(det, enc, clf, target_fs=112)
        out = eng.process(frames[:1])
        assert ("sat_counts" in out) == (det is not engine.detector)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            results = eng.identify(out, {}, 0.0)
        assert len(results) == 1 and len(results[0]) == 2
        saturated = any("capacity saturated" in str(w.message)
                        for w in caught)
        assert saturated == warns
