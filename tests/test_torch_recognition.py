"""The port's recognition library (``pipeline.recognition``, ``pipeline.align``,
``data.transforms``, ``training.checkpoint``, the model registry,
``RetinaFace.inference`` and ``utils.tracing``) against the JAX package's, on
the CPU, on seeded numpy inputs and on the same weights (JAX variables
converted into the port's modules). Each test states its tolerance."""

import json
import os

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.data import transforms as JT
from vn_celeb_face_recognition_tpu.models import mtcnn as JM
from vn_celeb_face_recognition_tpu.models import retinaface as JR
from vn_celeb_face_recognition_tpu.models.inception_resnet_v1 import (
    InceptionResnetV1 as JEnc,
)
from vn_celeb_face_recognition_tpu.models.mlp import MLPModel as JMLP
from vn_celeb_face_recognition_tpu.models.resnet_2_branch import (
    ResNet2Branch as JResNet2Branch,
)
from vn_celeb_face_recognition_tpu.pipeline import align as JA
from vn_celeb_face_recognition_tpu.pipeline import recognition as JRec
from vn_celeb_face_recognition_tpu.training.checkpoint import save_checkpoint
from vn_celeb_face_recognition_tpu.utils import tracing as JTr
from vn_celeb_face_recognition_tpu_torch import models as TMods
from vn_celeb_face_recognition_tpu_torch.data import transforms as TT
from vn_celeb_face_recognition_tpu_torch.models import mtcnn as TM
from vn_celeb_face_recognition_tpu_torch.models import retinaface as TR
from vn_celeb_face_recognition_tpu_torch.models.inception_resnet_v1 import (
    InceptionResnetV1 as TEnc,
)
from vn_celeb_face_recognition_tpu_torch.models.mlp import MLPModel as TMLP
from vn_celeb_face_recognition_tpu_torch.ops.image import warp_affine
from vn_celeb_face_recognition_tpu_torch.ops.similarity import (
    umeyama_similarity,
)
from vn_celeb_face_recognition_tpu_torch.pipeline import align as TA
from vn_celeb_face_recognition_tpu_torch.pipeline import recognition as TRec
from vn_celeb_face_recognition_tpu_torch.training import checkpoint as TC
from vn_celeb_face_recognition_tpu_torch.utils import kernels
from vn_celeb_face_recognition_tpu_torch.utils import tracing as TTr
from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames

from test_torch_emotion import emotion_pair
from test_torch_encoder import load_pair

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = os.path.join(REPO_ROOT, "meta_data", "face_recognition")
TEMPLATE = TA.center_point_dict["(112, 112)"]
CAPS = dict(min_face_size=50, pnet_cap_per_scale=128, cross_cap=256,
            rnet_cap=64, onet_cap=32, out_cap=8)
N_CLASSES, TAGS = 10, 17


@pytest.fixture(scope="module")
def frames():
    return list(build_frames(2, 256, 4, 100))


def _max_level_diff(a, b):
    return int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())


# ---------------------------------------------------------------------------
# transforms, tracing, registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["default", "emotion_inf", "prewhiten"])
def test_transforms_match_jax(name):
    """The inference transforms on seeded NHWC batches, at 1e-5."""
    x = np.random.default_rng(3).uniform(0, 255, (3, 40, 36, 3)).astype(
        np.float32)
    want = np.asarray(JT.get_transform(name)(jnp.asarray(x), None))
    got = TT.get_transform(name)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    resized = TT.with_resize(TT.get_transform(name), 20)(torch.from_numpy(x))
    want = np.asarray(JT.with_resize(JT.get_transform(name), 20)(
        jnp.asarray(x), None))
    np.testing.assert_allclose(resized.numpy(), want, rtol=1e-5, atol=1e-5)


def test_transform_registry():
    assert set(TT.transforms_dict) == set(JT.transforms_dict)
    assert TT.get_transform("none") is None and TT.get_transform(None) is None
    with pytest.raises(KeyError):
        TT.get_transform("nope")
    # facenet_aug and rank1_aug are training augmentations: they draw from
    # a generator
    for name in ("facenet_aug", "rank1_aug"):
        with pytest.raises(ValueError, match="Generator"):
            TT.transforms_dict[name](torch.zeros((1, 8, 8, 3)), None)
        out = TT.transforms_dict[name](
            torch.zeros((1, 8, 8, 3), dtype=torch.uint8),
            torch.Generator().manual_seed(0))
        assert out.shape == (1, 8, 8, 3) and out.dtype == torch.float32


def test_stage_timer_format_matches_jax(tmp_path):
    """StageTimer's report and log lines equal the JAX package's for the
    same totals; trace() writes a torch.profiler trace, and is a no-op
    without a directory."""
    timers = (JTr.StageTimer(), TTr.StageTimer())
    for t in timers:
        for name, secs in (("detect", 0.0123456), ("align", 1.5),
                           ("detect", 0.02), ("embed", 12.345678)):
            t.totals[name] += secs
            t.counts[name] += 1
    assert timers[0].report() == timers[1].report()
    lines = [[], []]
    for t, out in zip(timers, lines):
        t.log(out.append)
    assert lines[0] == lines[1] and len(lines[1]) == 3
    timer = TTr.StageTimer()
    with TTr.trace(str(tmp_path)), TTr.timed_stage(timer, "stage"):
        torch.ones(4).sum()
    assert os.path.exists(tmp_path / "trace.json")
    assert timer.counts["stage"] == 1
    with TTr.trace(None), TTr.timed_stage(None, "untimed"):
        pass


def test_registry_resolves_the_jax_names(monkeypatch, tmp_path):
    """build_model and build_detector resolve every JAX registry name and
    its configs; resnet101 raises NotImplementedError; pretrained weights
    come from local files only, else a seeded initialisation (the same
    weights on every build) after a warning."""
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    monkeypatch.chdir(REPO_ROOT)
    mlp = TMods.build_model("MLPModel", input_dim=512, num_classes=7)
    assert isinstance(mlp, TMLP) and mlp.dense_2.out_features == 7
    assert not mlp.training
    torch.testing.assert_close(
        TMods.build_model("MLPModel", input_dim=512,
                          num_classes=7).state_dict(), mlp.state_dict())
    enc = TMods.build_model("InceptionResnetV1", dtype="bfloat16")
    assert isinstance(enc, TEnc) and enc.dtype == torch.bfloat16
    for depth in (34, 50, 100):
        net = TMods.build_model(f"iresnet{depth}", progress=True)
        assert len(net.layer3) == {34: 6, 50: 14, 100: 30}[depth]
    with open("cfg/embedding/iresnet100_enc.json") as fp:
        TMods.build_model("iresnet100", **json.load(fp))  # warns, seeds
    with open("cfg/emotion/resnet50_2_branch.json") as fp:
        emo = TMods.build_model("resnet_2branch_50", **json.load(fp))
    assert emo.fc.out_features == 690
    # a local .pth of the emotion net loads into a fresh build
    path = str(tmp_path / "emo.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               emo.state_dict().items()}}, path)
    emo2 = TMods.build_model("resnet_2branch_50", num_classes=690,
                             checkpoint_path=path)
    torch.testing.assert_close(emo2.state_dict(), emo.state_dict())
    with pytest.raises(NotImplementedError, match="A.10"):
        TMods.build_model("resnet101")
    with pytest.raises(KeyError):
        TMods.build_model("nope")
    jnames = {"MLPModel", "InceptionResnetV1", "iresnet34", "iresnet50",
              "iresnet100", "resnet101", "resnet_2branch_50"}
    assert jnames <= set(TMods._BUILDERS)
    for name, cfg in (("MTCNN", "mtcnn.json"),
                      ("RetinaFace", "retina_face.json")):
        with open(os.path.join("cfg", "detection", cfg)) as fp:
            args = json.load(fp)
        det = TMods.build_detector(name, device="cpu", **args)
        assert det.device == torch.device("cpu")
    assert det.keep_top_k == 750 and det.phase == "test"
    with pytest.raises(KeyError):
        TMods.build_detector("nope")


def test_wrappers_default_to_the_card():
    """The library's models run on the card unless the CPU is asked for:
    with no card visible, building one with no device raises."""
    assert TRec.Classifier.build(8, 3, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; the no-card contract is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRec.Classifier.build(8, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.alignment(np.zeros((8, 8, 3), np.uint8), TEMPLATE, TEMPLATE,
                     112, 112)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_load_model_classify_matches_jax(tmp_path):
    """A classifier checkpoint that the JAX save_checkpoint wrote, and a
    torch .pth of the same MLP, give the JAX classifier's outputs (1e-5);
    an orbax directory raises a clear error."""
    mlp, jvars = load_pair(TMLP(32, 5), seed=11)
    path = str(tmp_path / "model_best.ckpt")
    save_checkpoint(path, arch="MLPModel", epoch=3, variables=jvars,
                    opt_state={}, monitor_best=0.5, config={})
    x = np.random.default_rng(5).normal(size=(6, 32)).astype(np.float32)
    jclf = JRec.Classifier(JMLP(input_dim=32, num_classes=5), jvars)
    want = jclf(x)
    got = TRec.load_model_classify(
        path, TRec.Classifier.build(32, 5, device="cpu"))(x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    cp = TC.load_checkpoint(path)
    assert cp["epoch"] == 3 and cp["arch"] == "MLPModel"
    pth = str(tmp_path / "mlp.pth")
    torch.save(mlp.state_dict(), pth)
    got = TRec.Classifier.build(32, 5, checkpoint_path=pth, device="cpu")(x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="orbax"):
        TC.load_checkpoint(str(tmp_path))


# ---------------------------------------------------------------------------
# host-side helpers
# ---------------------------------------------------------------------------


def _log_probs(gen, n, n_classes, labels):
    """Log-probabilities [n, n_classes] whose argmax is a label drawn from
    ``labels`` and whose top probability is spread over (0.05, 1)."""
    pred = gen.choice(labels, n)
    top = gen.uniform(0.05, 0.999, n)
    rest = gen.dirichlet(np.ones(n_classes - 1), n) * (1 - top)[:, None]
    rest = np.minimum(rest, top[:, None] * 0.9)
    probs = np.insert(rest, 0, top, axis=1)
    for i in range(n):  # move the top probability to its label
        probs[i] = np.roll(probs[i], pred[i])
    return np.log(probs).astype(np.float32)


@pytest.mark.parametrize("table", ["dataframe", "dict"])
@pytest.mark.parametrize("per_class", [False, True], ids=["float", "dict"])
def test_identify_person_matches_jax(table, per_class):
    """Names equal to JAX's with the real 1,020-class name table (98
    names) and per-class thresholds, as a DataFrame and as a dict."""
    df = pd.read_csv(os.path.join(META, "label2name_1020_cls.txt"))
    with open(os.path.join(META, "local_thresholds.json")) as fp:
        thresholds = json.load(fp) if per_class else 0.5
    gen = np.random.default_rng(9)
    labels = np.concatenate([df["label"].to_numpy(),
                             gen.integers(0, 1020, 50)])
    logp = _log_probs(gen, 200, 1020, labels)
    want = JRec.identify_person(logp, None, df, thresholds)
    names = df if table == "dataframe" else dict(zip(df["label"], df["name"]))
    got = TRec.identify_person(logp, None, names, thresholds)
    assert got == want
    known = [n for n in got if n != "Unknown"]
    assert 10 < len(known) < len(got)


def test_find_emotion_matches_jax():
    """Equal top-k indices; probabilities at 1e-6."""
    logits = np.random.default_rng(2).normal(0, 3, (7, TAGS)).astype(
        np.float32)

    def model(x):
        return logits, None

    want = JRec.find_emotion(None, model, topk=6)
    got = TRec.find_emotion(None, model, topk=6)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)


def test_box_and_landmark_helpers_match_jax():
    """get_face_from_boxes (with and without the gate, boxes off the
    image), move_landmark_to_box and landmarks_geometrically_sane equal
    the JAX package's."""
    gen = np.random.default_rng(4)
    img = gen.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    xy = gen.uniform(-30, 110, (40, 2))
    boxes = np.concatenate([xy, xy + gen.uniform(-5, 60, (40, 2))], 1)
    for req in (None, {"min_dim": 15, "box_ratio": 1.5}):
        want = JRec.get_face_from_boxes(img, boxes, req)
        got = TRec.get_face_from_boxes(img, boxes, req)
        assert got[1] == want[1] and len(want[1]) > (5 if req is None else 2)
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(g, w)
    pts = gen.normal(0, 10, (60, 5, 2)) + TEMPLATE
    sane = []
    for box, lm in zip(boxes, pts):
        np.testing.assert_array_equal(TRec.move_landmark_to_box(box, lm),
                                      JRec.move_landmark_to_box(box, lm))
        want = JRec.landmarks_geometrically_sane(lm)
        assert TRec.landmarks_geometrically_sane(lm) == want
        sane.append(want)
    assert any(sane) and not all(sane)


def test_draw_helpers_match_jax():
    gen = np.random.default_rng(6)
    img = gen.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    boxes = [np.array([10.3, 12.0, 70.9, 80.2]), np.array([90, 5, 150, 60])]
    names = ["Suboi", "Unknown"]
    want = JRec.draw_boxes_on_image(img, boxes, names)
    got = TRec.draw_boxes_on_image(img, boxes, names)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, img)
    tags = [["happy", "sad"], ["calm"]]
    probs = [np.float32([0.7, 0.2]), np.float32([0.9])]
    np.testing.assert_array_equal(
        TRec.draw_emotions(got.copy(), boxes, tags, probs),
        JRec.draw_emotions(want.copy(), boxes, tags, probs))


# ---------------------------------------------------------------------------
# alignment
# ---------------------------------------------------------------------------


def _crops_and_landmarks(seed, k=6):
    """``k`` uint8 crops of different sizes, each with landmarks: the
    112 px template mapped into the crop by a random similarity."""
    gen = np.random.default_rng(seed)
    crops, lms = [], []
    for _ in range(k):
        h, w = gen.integers(60, 180, 2)
        crops.append(gen.integers(0, 256, (h, w, 3), dtype=np.uint8))
        s = min(h, w) / 112.0 * gen.uniform(0.6, 1.0)
        th = gen.uniform(-0.4, 0.4)
        rot = s * np.array([[np.cos(th), -np.sin(th)],
                            [np.sin(th), np.cos(th)]])
        lm = TEMPLATE @ rot.T + gen.uniform(0, 0.2, 2) * [w, h]
        lms.append(lm + gen.normal(0, 1.5, (5, 2)))
    return crops, np.asarray(lms, np.float32)


def test_align_crops_matches_jax_alignment():
    """One align_crops call over crops of different sizes against JAX's
    alignment per crop: uint8 within 1 level. With f32 crops (no rounding)
    the padded-window form equals the plain per-crop warp exactly."""
    crops, lms = _crops_and_landmarks(7)
    before = kernels.launch_counts()
    got = TA.align_crops(crops, lms, TEMPLATE, (112, 112), device="cpu")
    assert kernels.launch_counts() == before  # CPU: the plain version
    assert got.dtype == np.uint8 and got.shape == (len(crops), 112, 112, 3)
    for crop, lm, face in zip(crops, lms, got):
        want = JA.alignment(crop, TEMPLATE, lm, 112, 112)
        assert _max_level_diff(face, want) <= 1
    floats = [c.astype(np.float32) for c in crops]
    got = TA.align_crops(floats, lms, TEMPLATE, (112, 112), device="cpu")
    assert got.dtype == np.float32
    mats = umeyama_similarity(torch.from_numpy(lms),
                              torch.from_numpy(TEMPLATE))
    for crop, m, face in zip(floats, mats, got):
        plain = warp_affine(torch.from_numpy(crop), m, (112, 112)).numpy()
        np.testing.assert_array_equal(face, plain)
    assert TA.align_crops([], np.zeros((0, 5, 2)), TEMPLATE, (112, 112),
                          device="cpu").shape == (0, 112, 112, 3)


@pytest.mark.parametrize("size", ["(112, 112)", "(96, 112)", "(160, 160)"])
def test_alignment_matches_jax(size):
    """The single-face API, square and not: uint8 within 1 level."""
    crops, lms = _crops_and_landmarks(8, k=2)
    tpl = TA.center_point_dict[size]
    w, h = (int(v) for v in size.strip("()").split(", "))
    for crop, lm in zip(crops, lms):
        got = TA.alignment(crop, tpl, lm, w, h, device="cpu")
        want = JA.alignment(crop, tpl, lm, w, h)
        assert got.shape == want.shape == (h, w, 3)
        assert _max_level_diff(got, want) <= 1


# ---------------------------------------------------------------------------
# detectors and the detect-and-align paths
# ---------------------------------------------------------------------------


def _same_boxes(got, want, atol):
    assert [len(b) for b in got] == [len(b) for b in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=0)


def test_retinaface_inference_matches_jax(frames, monkeypatch):
    """RetinaFace built from cfg/detection/retina_face.json with
    keep_top_k 3 (fewer than the 4 faces a frame, so it cuts): boxes and
    landmarks within 1e-2 px, scores within 1e-5, single image and list."""
    monkeypatch.chdir(REPO_ROOT)
    with open("cfg/detection/retina_face.json") as fp:
        args = dict(json.load(fp), keep_top_k=3)
    jdet = JR.RetinaFace(**args)
    tdet = TMods.build_detector("RetinaFace", device="cpu", **args)
    want = jdet.inference(frames, landmark=True)
    got = tdet.inference(frames, landmark=True)
    assert [len(b) for b in want[0]] == [3, 3]
    for g, w, tol in zip(got, want, (1e-2, 1e-5, 1e-2)):
        _same_boxes(g, w, tol)
    one = tdet.inference(frames[1], landmark=False)
    assert len(one) == 2
    _same_boxes(one[0], want[0][1:], 1e-2)


@pytest.fixture(scope="module")
def detectors():
    return {"MTCNN": (JM.MTCNN(**CAPS), TM.MTCNN(device="cpu", **CAPS)),
            "RetinaFace": (JR.RetinaFace(weights_path=TR.WEIGHTS_NPZ),
                           TR.RetinaFace(weights_path=TR.WEIGHTS_NPZ,
                                         device="cpu"))}


@pytest.mark.parametrize("path", ["parallel", "sequential"])
@pytest.mark.parametrize("det", ["MTCNN", "RetinaFace"])
def test_detect_and_align_matches_jax(frames, detectors, det, path):
    """Both detect-and-align paths on 2 frames of 256 px: equal face
    counts, chosen boxes within 1e-2 px, aligned uint8 faces within 1
    level. On the CPU no kernel launches."""
    jdet, tdet = detectors[det]
    args = (TEMPLATE, (112, 112))
    if path == "sequential":
        args += ({"min_dim": 40, "box_ratio": 2.0},)
    jfn = getattr(JRec, f"{path}_detect_and_align")
    tfn = getattr(TRec, f"{path}_detect_and_align")
    want_faces, want_boxes = jfn(frames, jdet, *args)
    before = kernels.launch_counts()
    timer = TTr.StageTimer()
    got_faces, got_boxes = tfn(frames, tdet, *args, timer=timer)
    assert kernels.launch_counts() == before
    assert set(timer.counts) == {"detect", "align"}
    assert [len(f) for f in got_faces] == [len(f) for f in want_faces]
    assert sum(len(f) for f in got_faces) >= 6
    _same_boxes(got_boxes, want_boxes, 1e-2)
    for gf, wf in zip(got_faces, want_faces):
        for g, w in zip(gf, wf):
            assert g.dtype == np.uint8 and g.shape == (112, 112, 3)
            assert _max_level_diff(g, w) <= 1
    one_faces, _ = tfn(frames[0], tdet, *args)
    assert len(one_faces) == 1 and len(one_faces[0]) == len(got_faces[0])


def test_fan_branch_is_not_ported(frames, detectors):
    with pytest.raises(NotImplementedError, match="A.9"):
        TRec.sequential_detect_and_align(
            frames, detectors["MTCNN"][1], TEMPLATE, (112, 112),
            fa_model=object())


# ---------------------------------------------------------------------------
# recognition and emotion
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def aligned(frames, detectors):
    faces, _ = TRec.parallel_detect_and_align(
        frames, detectors["RetinaFace"][1], TEMPLATE, (112, 112))
    return faces


def test_recognize_celeb_matches_jax(aligned):
    """InceptionResnetV1 (full depth) + MLP on the aligned faces of 2
    frames, with the default transform: embeddings and log-probabilities
    within 1e-4 in f32 and equal names per frame."""
    enc, enc_vars = load_pair(TEnc(), seed=21)
    mlp, mlp_vars = load_pair(TMLP(512, N_CLASSES), seed=22)
    names = {i: f"celeb_{i}" for i in range(0, N_CLASSES, 2)}
    df = pd.DataFrame({"label": list(names), "name": list(names.values())})
    jenc = JRec.Encoder(JEnc(), enc_vars)
    jclf = JRec.Classifier(JMLP(input_dim=512, num_classes=N_CLASSES),
                           mlp_vars)
    tenc = TRec.Encoder(enc, device="cpu")
    tclf = TRec.Classifier(mlp, device="cpu")
    want = JRec.recognize_celeb(aligned, None, jenc, jclf, None, df, 0.0)
    timer = TTr.StageTimer()
    got = TRec.recognize_celeb(aligned, None, tenc, tclf, None, names, 0.0,
                               timer=timer)
    assert got == want and [len(n) for n in got] == [4, 4]
    assert set(timer.counts) == {"embed", "classify"}
    faces = np.stack([f for x in aligned for f in x]).astype(np.float32)
    emb = TRec.find_embedding(faces, tenc)
    np.testing.assert_allclose(emb, JRec.find_embedding(faces, jenc),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tclf(emb), jclf(emb), rtol=1e-4, atol=1e-4)
    assert TRec.recognize_celeb([[], []], None, tenc, tclf, None, names,
                                0.0) == [[], []]


def test_recognize_emotion_matches_jax(aligned):
    """The 2-branch emotion net (layers 1,1,1,1) on the 112 px aligned
    faces, through the emotion_inf transform: logits within 1e-4 in f32,
    equal top-1 tags, probabilities within 1e-5; 96 px faces (the net's
    own stem after the transform) within 1e-4 too; other transforms
    raise."""
    net, jvars = emotion_pair(seed=23, num_classes=TAGS, layers=(1, 1, 1, 1))
    jemo = JRec.EmotionModel(JResNet2Branch(layers=(1, 1, 1, 1),
                                            num_classes=TAGS), jvars)
    temo = TRec.EmotionModel(net, device="cpu")

    def tag(i):
        return f"tag{i}"

    map_func = np.vectorize(tag)
    want_tags, want_probs = JRec.recognize_emotion(aligned, None, jemo, None,
                                                   map_func, topk=6)
    got_tags, got_probs = TRec.recognize_emotion(aligned, None, temo, None,
                                                 map_func, topk=6)
    for gt, wt, gp, wp in zip(got_tags, want_tags, got_probs, want_probs):
        np.testing.assert_array_equal(gt[:, 0], wt[:, 0])
        np.testing.assert_allclose(gp, wp, rtol=1e-5, atol=1e-5)
    faces = np.stack([f for x in aligned for f in x]).astype(np.float32)
    np.testing.assert_allclose(temo(faces)[0], jemo(faces)[0], rtol=1e-4,
                               atol=1e-4)
    small = np.random.default_rng(24).uniform(0, 255, (2, 96, 96, 3)).astype(
        np.float32)
    np.testing.assert_allclose(temo(small)[0], jemo(small)[0], rtol=1e-4,
                               atol=1e-4)
    temo.transform = TT.transforms_dict["default"]
    with pytest.raises(ValueError, match="emotion_inf"):
        temo(faces)
    assert TRec.recognize_emotion([[]], None, temo, None, map_func) == (
        [[]], [[]])
