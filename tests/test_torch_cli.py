"""The port's CLIs (``cli.demo_image``, ``cli.demo_video``,
``cli.celeb_statistic``, ``cli.find_embedding``), their host IO
(``utils.frames.read_image``, ``native.loader``, ``utils.io``) and the
emotion model on faces of any size, against the JAX package's repo-root CLIs
and native runtime, on the CPU at small sizes (MTCNN at image_size 160,
frames of 240x320). Models that both sides run share their weights (the port's
modules, converted into JAX variables). Each test states its tolerance."""

import ast
import csv
import json
import os
import random
import struct
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import celeb_statistic as j_stat
import demo_image as j_image
import demo_video as j_video
from vn_celeb_face_recognition_tpu import native as j_native
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
from vn_celeb_face_recognition_tpu.pipeline import recognition as JRec
from vn_celeb_face_recognition_tpu_torch.cli import celeb_statistic as t_stat
from vn_celeb_face_recognition_tpu_torch.cli import demo_image as t_image
from vn_celeb_face_recognition_tpu_torch.cli import demo_video as t_video
from vn_celeb_face_recognition_tpu_torch.cli import find_embedding as t_emb
from vn_celeb_face_recognition_tpu_torch.models import mtcnn as TM
from vn_celeb_face_recognition_tpu_torch.models import resnet_2_branch as TRN
from vn_celeb_face_recognition_tpu_torch.models import retinaface as TR
from vn_celeb_face_recognition_tpu_torch.models.inception_resnet_v1 import (
    InceptionResnetV1 as TEnc,
)
from vn_celeb_face_recognition_tpu_torch.models.mlp import MLPModel as TMLP
from vn_celeb_face_recognition_tpu_torch.native import loader
from vn_celeb_face_recognition_tpu_torch.pipeline import recognition as TRec
from vn_celeb_face_recognition_tpu_torch.utils import frames as F
from vn_celeb_face_recognition_tpu_torch.utils import io as TIO
from vn_celeb_face_recognition_tpu_torch.utils import kernels

from test_torch_emotion import emotion_pair
from test_torch_encoder import load_pair
from toy_data import toy_face_files
from torch_shared import jax_runtime  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLASSES, TAGS = 16, 17
DET_ARGS = {"image_size": 160, "keep_all": True, "min_face_size": 40}


# ---------------------------------------------------------------------------
# fixtures: a clip, the CLIs' files, models on shared weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes at once, and torch's default of one thread per core in
    each of them oversubscribes the CPU (this module's CPU forwards ran
    ~30x slower so). Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def face_image():
    from PIL import Image

    return np.asarray(Image.open(toy_face_files()[0]).convert("RGB").resize(
        (160, 160)), dtype=np.uint8)


def write_clip(path, face_image, fps=8.0, n=8):
    """The 8-frame MJPG clip of the JAX pipeline tests: a 160 px face
    drifting right over a flat 240x320 background."""
    h, w = 240, 320
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"),
                             fps, (w, h))
    assert writer.isOpened()
    bgr_face = cv2.cvtColor(face_image, cv2.COLOR_RGB2BGR)
    for t in range(n):
        frame = np.full((h, w, 3), 60, dtype=np.uint8)
        x0 = 20 + 4 * t
        frame[40:200, x0:x0 + 160] = bgr_face
        writer.write(frame)
    writer.release()
    return str(path)


@pytest.fixture(scope="module")
def clip(tmp_path_factory, face_image):
    return write_clip(tmp_path_factory.mktemp("clip") / "clip.avi",
                      face_image)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    label2name = root / "label2name.csv"
    with open(label2name, "w") as f:
        f.write("label,name\n")
        for i in range(N_CLASSES):
            f.write(f"{i},Person_{i}\n")
    (root / "enc.json").write_text(json.dumps({"pretrained": None}))
    (root / "det.json").write_text(json.dumps(DET_ARGS))
    (root / "emt.json").write_text(json.dumps(
        {"pretrained": False, "num_classes": TAGS, "checkpoint_path": None}))
    return {"root": root, "label2name": str(label2name),
            "enc_cfg": str(root / "enc.json"),
            "det_cfg": str(root / "det.json"),
            "emt_cfg": str(root / "emt.json")}


def cli_args(parser, files, **overrides):
    """The CLIs' defaults with the test's files, like the JAX pipeline
    tests' ``make_args``."""
    args = parser.parse_args([])
    args.label2name = files["label2name"]
    args.encoder_args = files["enc_cfg"]
    args.detection_args = files["det_cfg"]
    args.emotion_args = files["emt_cfg"]
    args.encoder = "InceptionResnetV1"
    args.detection = "MTCNN"
    args.num_classes = N_CLASSES
    args.classify_model = ""
    args.inference_method = "par_fd_vs_aln"
    args.log_step = 100
    args.recog_threshold = 0.0
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


@pytest.fixture(scope="module")
def shared():
    """(port models, JAX models) as each package's ``setup_models`` returns
    them, on the same weights: MTCNN (the vendored weights), a full-depth
    InceptionResnetV1, an MLP of 16 classes and a shallow emotion net of
    17 tags."""
    enc, enc_vars = load_pair(TEnc(), seed=31)
    mlp, mlp_vars = load_pair(TMLP(512, N_CLASSES), seed=32)
    emo, emo_vars = emotion_pair(seed=33, num_classes=TAGS,
                                 layers=(1, 1, 1, 1))
    names = {i: f"Person_{i}" for i in range(N_CLASSES)}
    df = pd.DataFrame({"label": list(names), "name": list(names.values())})
    tags = {i: f"tag{i}" for i in range(TAGS)}
    port = (names, TM.MTCNN(device="cpu", **DET_ARGS),
            TRec.Encoder(enc, device="cpu"), TRec.Classifier(mlp, device="cpu"),
            TRec.EmotionModel(emo, device="cpu"), tags)
    jax_models = (df, JM.MTCNN(**DET_ARGS), JRec.Encoder(JEnc(), enc_vars),
                  JRec.Classifier(JMLP(input_dim=512, num_classes=N_CLASSES),
                                  mlp_vars),
                  JRec.EmotionModel(JResNet2Branch(layers=(1, 1, 1, 1),
                                                   num_classes=TAGS),
                                    emo_vars), tags)
    return port, jax_models


def read_tracker(path):
    with open(path, newline="") as fp:
        return list(csv.DictReader(fp))


def assert_same_tracker(got_path, want_path, atol=1e-4):
    """Equal columns, rows, names, times, frame indices and emotion tags;
    normalised boxes within ``atol``."""
    got, want = read_tracker(got_path), read_tracker(want_path)
    with open(got_path) as g, open(want_path) as w:
        assert g.readline() == w.readline()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for col in ("Time", "Names", "Frame_idx", "Emotion"):
            assert g.get(col) == w.get(col), col
        gb, wb = ast.literal_eval(g["Bboxes"]), ast.literal_eval(w["Bboxes"])
        assert len(gb) == len(wb)
        for a, b in zip(gb, wb):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    return got


# ---------------------------------------------------------------------------
# host IO
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fps,n_frames,frame_idxes",
                         [(8.0, 4, None), (8.0, 3, [1, 3, 6]),
                          (7.5, 2, [1, 2, 4])])
def test_frame_chunks_match_jax(tmp_path, face_image, fps, n_frames,
                                frame_idxes):
    """The IO runtime's reader under ``frame_chunks`` against the JAX CLI's
    native reader: equal chunks, RGB frames equal to JAX's BGR frames
    flipped, bit for bit, equal [time, count] infos, and the same
    ``count % fps`` sampling (a float fps included)."""
    path = write_clip(tmp_path / "clip.avi", face_image, fps=fps)
    want = list(j_video.frame_chunks(path, n_frames, frame_idxes,
                                     use_native=True))
    got = list(t_video.frame_chunks(path, n_frames, frame_idxes))
    assert len(got) == len(want) > 0
    for (gf, gi), (wf, wi) in zip(got, want):
        assert gi == wi
        assert len(gf) == len(wf) <= n_frames
        for g, w in zip(gf, wf):
            assert g.dtype == np.uint8 and g.shape == (240, 320, 3)
            np.testing.assert_array_equal(g, w[..., ::-1])
    counts = [i[1] for _, infos in got for i in infos]
    if frame_idxes is None:
        assert counts == list(range(1, 9))
    else:
        assert counts == [c for c in range(1, 9)
                          if any(c % fps == i for i in frame_idxes)]


def test_frame_chunks_raise_reader_errors(tmp_path):
    """A file the runtime cannot open raises in the consumer."""
    bad = tmp_path / "not_a_video.avi"
    bad.write_bytes(b"no video here")
    with pytest.raises(IOError, match="cannot open video"):
        list(t_video.frame_chunks(str(bad), 4))


@pytest.mark.parametrize("kind", ["color_q90", "color_q60", "grey"])
def test_jpeg_decode_matches_jax_native(tmp_path, kind):
    """read_image on a JPEG (the runtime's libjpeg decode) is bit-exact to
    the JAX package's native decode_image_file."""
    gen = np.random.default_rng(1)
    img = gen.integers(0, 256, (45, 61, 3), dtype=np.uint8)
    img = cv2.GaussianBlur(img, (5, 5), 0)
    path = str(tmp_path / "x.jpg")
    if kind == "grey":
        cv2.imwrite(path, img[..., 0])
    else:
        cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY,
                                int(kind[-2:])])
    got = F.read_image(path)
    assert got.dtype == np.uint8 and got.shape == (45, 61, 3)
    want = j_native.decode_image_file(path, 61, 45)
    np.testing.assert_array_equal(got, want)


def _png_modes(rgb):
    """PIL images of every 8-bit colour type cv2 reads, from ``rgb``."""
    from PIL import Image

    base = Image.fromarray(rgb)
    alpha = np.random.default_rng(2).integers(0, 256, rgb.shape[:2],
                                              dtype=np.uint8)
    rgba = Image.fromarray(np.dstack([rgb, alpha]))
    return {"grey": base.convert("L"), "grey_alpha": rgba.convert("LA"),
            "palette": base.convert("P"), "rgb": base, "rgba": rgba}


@pytest.mark.parametrize("mode", ["grey", "grey_alpha", "palette",
                                  "palette_trns", "rgb", "rgba"])
def test_read_png_matches_cv2(tmp_path, mode):
    """read_png of every 8-bit colour type equals cv2.imread(IMREAD_COLOR)
    turned to RGB: grey replicated, palette looked up, alpha dropped."""
    rgb = np.random.default_rng(3).integers(0, 256, (33, 47, 3),
                                            dtype=np.uint8)
    path = str(tmp_path / "x.png")
    if mode == "palette_trns":
        _png_modes(rgb)["palette"].save(path, transparency=5)
    else:
        _png_modes(rgb)[mode].save(path)
    want = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    for got in (F.read_png(path), F.read_image(path)):
        assert got.dtype == np.uint8 and got.shape == (33, 47, 3)
        np.testing.assert_array_equal(got, want)


def _png(ihdr, raw):
    return (b"\x89PNG\r\n\x1a\n" + F._png_chunk(b"IHDR", ihdr)
            + F._png_chunk(b"IDAT", zlib.compress(raw))
            + F._png_chunk(b"IEND", b""))


def test_read_png_refuses_interlace_and_16_bit(tmp_path):
    """Adam7 interlace, 16-bit and sub-8-bit depths raise a clear
    ValueError; so does a file that is neither PNG nor JPEG."""
    cases = {
        "adam7": (struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1), "Adam7"),
        "16bit": (struct.pack(">IIBBBBB", 4, 4, 16, 2, 0, 0, 0), "bit depth"),
        "4bit": (struct.pack(">IIBBBBB", 4, 4, 4, 3, 0, 0, 0), "bit depth"),
    }
    for name, (ihdr, match) in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(_png(ihdr, bytes(200)))
        with pytest.raises(ValueError, match=match):
            F.read_png(str(path))
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        F.read_image(deep)
    other = tmp_path / "x.gif"
    other.write_bytes(b"GIF89a" + bytes(10))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        F.read_image(str(other))


@pytest.mark.parametrize("size", [(160, 160), (112, 112), (61, 45),
                                  (20, 33)])
def test_resize_half_pixel_matches_jax_native(tmp_path, size):
    """find_embedding --image_size's resize is bit-exact to the JAX native
    runtime's vn_resize_bilinear (through decode_image_file), up and
    down."""
    rgb = np.random.default_rng(4).integers(0, 256, (45, 61, 3),
                                            dtype=np.uint8)
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, rgb[..., ::-1])
    want = j_native.decode_image_file(path, *size)
    got = F.resize_bilinear_half_pixel(F.read_png(path), size)
    np.testing.assert_array_equal(got, want)


def test_io_runtime_build_errors_name_the_header(tmp_path, monkeypatch):
    """A source whose header is missing raises at build time with the
    compiler's output and the header's name; nothing falls back."""
    if loader.shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    src = tmp_path / "src"
    src.mkdir()
    (src / "probe.cpp").write_text("#include <no_such_header_xyz.h>\n")
    monkeypatch.setattr(loader, "SRC_DIR", str(src))
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setitem(loader.LIBRARIES, "probe",
                        ("probe.cpp", [], ["no_such_header_xyz.h"], {}))
    with pytest.raises(RuntimeError,
                       match="header no_such_header_xyz.h not found"):
        loader.build("probe")
    monkeypatch.undo()
    # the real library builds once: a second build finds it current
    path = loader.build("image_io")
    stamp = os.stat(path).st_mtime_ns
    assert loader.build("image_io") == path
    assert os.stat(path).st_mtime_ns == stamp


def test_label2name_and_json_helpers_match_jax(tmp_path):
    """read_label2name equals the pandas table the JAX CLI reads, as a
    dict; write_json writes the JAX package's bytes; the time format is
    JAX's."""
    from vn_celeb_face_recognition_tpu.utils import io as JIO
    from vn_celeb_face_recognition_tpu.utils import misc as JMisc
    from vn_celeb_face_recognition_tpu_torch.utils import misc as TMisc

    for name in ("label2name.txt", "label2name_1020_cls.txt",
                 "label2name_16_cls.txt"):
        path = os.path.join(REPO_ROOT, "meta_data", "face_recognition", name)
        df = pd.read_csv(path)
        assert TIO.read_label2name(path) == dict(zip(df["label"].tolist(),
                                                     df["name"].tolist()))
    content = {"1": {"interval": ("0.0h:0.0m:0.12s", "x"), "v": [1.5, []]}}
    TIO.write_json(str(tmp_path / "a.json"), content, log=False)
    JIO.write_json(str(tmp_path / "b.json"), content, log=False)
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    assert TIO.read_json(str(tmp_path / "a.json")) == json.loads(
        (tmp_path / "b.json").read_text())
    for sec in (0.0, 0.125, 59.995, 61.0, 3725.37, 86399.999):
        assert TMisc.convert_sec_to_max_time_quantity(sec) == \
            JMisc.convert_sec_to_max_time_quantity(sec)
    bad = tmp_path / "bad.csv"
    bad.write_text("id,who\n1,x\n")
    with pytest.raises(ValueError, match="label"):
        TIO.read_label2name(str(bad))


# ---------------------------------------------------------------------------
# tracker.json
# ---------------------------------------------------------------------------


def _write_tracker(path, n_rows=23):
    """A tracker.csv as process_video writes it, with an Emotion column,
    rows without faces, times that are not exact binary fractions and
    names seen a varying number of times."""
    gen = np.random.default_rng(5)
    people = ["Suboi", "Hoai Linh", "Unknown", "Ribi Sachi"]
    lines = ["Time,Names,Frame_idx,Bboxes,Emotion\n"]
    for r in range(n_rows):
        count = 1 + 5 * r + int(gen.integers(0, 4))
        k = 0 if r in (2, 11) else int(gen.integers(1, 4))
        names = [people[int(i)] for i in gen.integers(0, 4, k)]
        boxes = [[float(v) for v in gen.uniform(0, 1, 4)] for _ in range(k)]
        tags = [[str(t) for t in gen.choice(["happy", "calm", "sad"], 2)]
                for _ in range(k)]
        lines.append(",".join([str(count / 29.97), '"' + str(names) + '"',
                               str(count), '"' + str(boxes) + '"',
                               '"' + str(tags) + '"']) + "\n")
    with open(path, "w") as fp:
        fp.write("".join(lines))


@pytest.mark.parametrize("mode", ["dynamic", "fixed"])
def test_tracker_json_matches_jax(tmp_path, mode):
    """The port's tracker.json export (csv module) equals the JAX CLI's
    (pandas) byte for byte on the same tracker.csv, with an Emotion column
    and empty rows; and without the Emotion column."""
    path = str(tmp_path / "tracker.csv")
    _write_tracker(path)
    df = pd.read_csv(path)
    for with_emotion in (True, False):
        table = t_stat.TrackerTable.read(path)
        want_df = df if with_emotion else df.drop(columns=["Emotion"])
        if not with_emotion:
            table = t_stat.TrackerTable(
                table.columns[:4], [r[:4] for r in table._rows])
        got_js, want_js = str(tmp_path / "got.json"), str(tmp_path / "w.json")
        if mode == "dynamic":
            for n_itv, n_appear in ((3, 2), (5, 1), (1, 4)):
                got = t_stat.export_json_stat_dynamic_itv(
                    table, got_js, n_itv, n_appear, "Unknown")
                want = j_stat.export_json_stat_dynamic_itv(
                    want_df, want_js, n_itv, n_appear, "Unknown")
                assert got == want
                assert open(got_js).read() == open(want_js).read()
        else:
            for n_rows, n_appear in ((4, 1), (10, 2), (40, 1)):
                got = t_stat.export_json_stat_fixed_itv(
                    table, got_js, n_rows, n_appear, "Unknown")
                want = j_stat.export_json_stat_fixed_itv(
                    want_df, want_js, n_rows, n_appear, "Unknown")
                assert got == want
                assert open(got_js).read() == open(want_js).read()
    assert any(got[k]["celebrities"] for k in got)
    assert len(t_stat.TrackerTable.read(path)) == 23


# ---------------------------------------------------------------------------
# the emotion model on faces of any size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [112, 160])
def test_emotion_model_any_face_size_matches_jax(size, monkeypatch):
    """EmotionModel at 112 px (through K7's function) and at 160 px (the
    emotion_inf transform, then the net's own stem) against the JAX
    EmotionModel on shared weights: equal top-1 and probabilities within
    5e-3 (logits within 1e-3)."""
    net, jvars = emotion_pair(seed=41, num_classes=TAGS, layers=(3, 4, 1, 1))
    jemo = JRec.EmotionModel(JResNet2Branch(layers=(3, 4, 1, 1),
                                            num_classes=TAGS), jvars)
    jemo.transform = JT.transforms_dict["emotion_inf"]
    temo = TRec.EmotionModel(net, device="cpu")
    temo.transform = TRec.transforms_dict["emotion_inf"]
    stems = []
    real_stem = TRN.emotion_stem
    monkeypatch.setattr(TRN, "emotion_stem",
                        lambda *a: stems.append(1) or real_stem(*a))
    faces = np.random.default_rng(size).uniform(
        0, 255, (3, size, size, 3)).astype(np.float32)
    got, want = temo(faces)[0], jemo(faces)[0]
    assert stems == ([1] if size == 112 else [])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    idx = np.vectorize(int)
    got_tags, got_p = TRec.find_emotion(faces, temo, topk=6)
    want_tags, want_p = JRec.find_emotion(faces, jemo, topk=6)
    np.testing.assert_array_equal(idx(got_tags)[:, 0], want_tags[:, 0])
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=5e-3)


# ---------------------------------------------------------------------------
# the video loop against the JAX CLI's
# ---------------------------------------------------------------------------


def run_both(tmp_path, files, shared_models, clip_path, frame_idxes=None,
             track_bbox=True, threshold=0.0, **flags):
    """process_video of the JAX CLI and of the port on the same clip,
    models, threshold and flags; returns the (port, JAX) tracker paths."""
    paths = []
    for side, video_md, image_md, models in (
            ("jax", j_video, j_image, shared_models[1]),
            ("port", t_video, t_image, shared_models[0])):
        parser = video_md.build_arg_parser()
        args = cli_args(parser, files, video_path=clip_path,
                        output_tracker=str(tmp_path / f"{side}.csv"),
                        output_frame=str(tmp_path / f"{side}_frames"),
                        n_frames=3, **flags)
        fs = (args.target_face_size, args.target_face_size)
        processed, _ = video_md.process_video(
            args, models, fs, t_video.center_point_dict[str(fs)], threshold,
            frame_idxes, track_bbox)
        assert processed > 0
        paths.append(args.output_tracker)
    return paths[1], paths[0]


@pytest.mark.parametrize("method,emotion", [("par_fd_vs_aln", True),
                                            ("seq_fd_vs_aln", False)])
def test_process_video_library_matches_jax(tmp_path, files, shared, clip,
                                           method, emotion):
    """The library path (MTCNN + InceptionResnetV1 + MLP, shared weights;
    with the emotion net on the parallel path) on the 8-frame clip, in
    chunks of 3 with -fidx sampling: the port's tracker.csv has JAX's
    header, rows, names, times, frame indices and emotion tags, and boxes
    within 1e-4 (normalised). No kernel launches on the CPU."""
    before = kernels.launch_counts()
    got, want = run_both(tmp_path, files, shared, clip, [1, 2, 3, 5, 6, 7],
                         inference_method=method, recog_emotion=emotion)
    assert kernels.launch_counts() == before
    rows = assert_same_tracker(got, want)
    assert [r["Frame_idx"] for r in rows] == ["1", "2", "3", "5", "6", "7"]
    assert sum(bool(ast.literal_eval(r["Names"])) for r in rows) >= 4
    if emotion:
        tags = [ast.literal_eval(r["Emotion"]) for r in rows]
        assert any(tags) and all(len(t) == 6 for row in tags for t in row)


def test_process_video_fused_engine_matches_jax(tmp_path, files, shared,
                                                clip):
    """--fused_engine with --recog_emotion and --face_cap 8 (MTCNN, shared
    weights, f32):
    the port's engine writes JAX's engine's tracker rows (names, times,
    frame indices, emotion tags; boxes within 1e-4)."""
    got, want = run_both(tmp_path, files, shared, clip, None,
                         fused_engine=True, recog_emotion=True, face_cap=8)
    rows = assert_same_tracker(got, want)
    assert sum(bool(ast.literal_eval(r["Names"])) for r in rows) >= 4


def test_fused_engine_runs_emotion_in_compute_dtype(shared, face_image,
                                                    monkeypatch):
    """build_fused_engine with --compute_dtype bfloat16 runs the emotion
    net in bf16, as the JAX engine casts its emotion input to the compute
    dtype, whatever the net's own dtype."""
    dtypes = []
    real_stem = TRN.emotion_stem
    monkeypatch.setattr(TRN, "emotion_stem",
                        lambda *a: dtypes.append(a[3]) or real_stem(*a))
    frame = np.full((1, 240, 320, 3), 60, dtype=np.uint8)
    frame[0, 40:200, 60:220] = face_image
    port = shared[0]
    assert port[4].module.dtype == torch.float32
    for dtype, want in ((None, torch.float32), ("bfloat16", torch.bfloat16)):
        engine = t_video.build_fused_engine(port, (112, 112),
                                            compute_dtype=dtype, face_cap=2)
        out = engine.process_adaptive(frame)
        assert out["emotion_prob"].dtype == torch.float32
        assert dtypes[-1] == want


@pytest.fixture(scope="module")
def retina_shared(shared):
    """``shared`` with RetinaFace (the vendored fitted weights) as the
    detector."""
    port, jax_models = shared
    return ((port[0], TR.RetinaFace(weights_path=TR.WEIGHTS_NPZ, device="cpu"),
             *port[2:]),
            (jax_models[0], JR.RetinaFace(weights_path=TR.WEIGHTS_NPZ),
             *jax_models[2:]))


def test_process_video_retinaface_emotion_matches_jax(tmp_path, files,
                                                      retina_shared, clip):
    """The production flow's flags on the clip: RetinaFace, par_fd_vs_aln,
    --recog_emotion, per-class thresholds and -fidx: the port's tracker
    rows are JAX's (boxes within 1e-4)."""
    thresholds = {str(i): 0.05 * (i % 3) for i in range(N_CLASSES)}
    got, want = run_both(tmp_path, files, retina_shared, clip, [1, 2, 4, 6],
                         threshold=thresholds, recog_emotion=True,
                         detection="RetinaFace")
    rows = assert_same_tracker(got, want)
    assert [r["Frame_idx"] for r in rows] == ["1", "2", "4", "6"]
    assert all(ast.literal_eval(r["Names"]) for r in rows)


# ---------------------------------------------------------------------------
# demo_image and find_embedding
# ---------------------------------------------------------------------------


def test_demo_image_main_matches_jax(tmp_path, files, shared, face_image,
                                     monkeypatch):
    """demo_image.main of the port (-dv cpu) and of the JAX CLI on the same
    PNG and shared weights, with --recog_emotion at -tg_fs 160: equal
    names, boxes within 1e-4 px, and the annotated pictures (both drawn by
    cv2, emotion tags included) equal."""
    method, face_size, emotion = "par_fd_vs_aln", 160, True
    frame = np.full((240, 320, 3), 60, dtype=np.uint8)
    frame[40:200, 60:220] = face_image
    img = str(tmp_path / "input.png")
    F.write_png(img, frame)
    monkeypatch.setattr(j_image, "setup_models", lambda args: shared[1])
    monkeypatch.setattr(t_image, "setup_models", lambda args: shared[0])
    flags = dict(inference_method=method, target_face_size=face_size,
                 recog_emotion=emotion)
    jargs = cli_args(j_image.build_arg_parser(), files, image_path=img,
                     output_path=str(tmp_path / "jax.png"), **flags)
    want_names, want_boxes = j_image.main(jargs)
    argv = ["-dv", "cpu", "-i", img, "-o", str(tmp_path / "port.png"),
            "--inference_method", method, "-tg_fs", str(face_size)]
    got_names, got_boxes = t_image.main(
        argv + (["--recog_emotion"] if emotion else []))
    assert got_names == want_names and len(got_names) == 1
    np.testing.assert_allclose(np.asarray(got_boxes, np.float32),
                               np.asarray(want_boxes, np.float32), rtol=0,
                               atol=1e-4)
    got_img = cv2.imread(str(tmp_path / "port.png"))
    np.testing.assert_array_equal(got_img, cv2.imread(str(tmp_path /
                                                          "jax.png")))
    assert not np.array_equal(got_img, frame[..., ::-1])


@pytest.fixture(scope="module")
def embedding_dir(tmp_path_factory):
    """40 face PNGs of 96 and 80 px: the repo's 20 faces (resized down), and
    each mirrored, named so the two sets interleave in file order."""
    root = tmp_path_factory.mktemp("faces")
    for i, path in enumerate(toy_face_files()):
        side = 96 if i % 3 else 80
        img = F.resize_bicubic(F.read_png(path), (side, side))
        F.write_png(str(root / f"{i:02d}a.png"), img)
        F.write_png(str(root / f"{i:02d}b.png"),
                    np.ascontiguousarray(img[:, ::-1]))
    return root


def test_find_embedding_keeps_file_order(tmp_path, embedding_dir,
                                         monkeypatch):
    """find_embedding -w none -bz 6 on 40 PNGs, decoded by 4 threads that
    each sleep a random 0-20 ms, three times: every <stem>.npz holds its
    own file's embedding (within 1e-4 of that file alone, resized to the
    first image's size with PIL's bilinear filter), the tail batch padded."""
    files = sorted(os.listdir(embedding_dir))
    assert len(files) == 40
    sizes = {F.read_png(str(embedding_dir / f)).shape for f in files}
    assert len(sizes) == 2  # the resize path runs
    encoder = t_emb.build_encoder("InceptionResnetV1", "none", "cpu")
    first = F.read_png(str(embedding_dir / files[0]))
    target = (first.shape[1], first.shape[0])
    want = {}
    for f in files:
        img = F.read_png(str(embedding_dir / f))
        if img.shape != first.shape:
            img = F.resize_bilinear(img, target)
        want[f] = img
    stack = np.stack([want[f] for f in files]).astype(np.float32)
    ref = np.concatenate([encoder(stack[i:i + 10])
                          for i in range(0, 40, 10)])
    real_read = t_emb.read_image
    rng = random.Random(0)
    lock = threading.Lock()

    def slow_read(path):
        with lock:
            delay = rng.uniform(0.0, 0.02)
        time.sleep(delay)
        return real_read(path)

    monkeypatch.setattr(t_emb, "read_image", slow_read)
    original_pool = t_emb.ThreadPoolExecutor
    monkeypatch.setattr(t_emb, "ThreadPoolExecutor",
                        lambda n: original_pool(4))
    for rep in range(3):
        out = tmp_path / f"emb{rep}"
        assert t_emb.main(["-d", str(embedding_dir), "-o", str(out), "-bz",
                           "6", "-w", "none", "-dv", "cpu"]) == 40
        assert sorted(os.listdir(out)) == sorted(
            f.split(".")[0] + ".npz" for f in files)
        for i, f in enumerate(files):
            with np.load(out / (f.split(".")[0] + ".npz")) as z:
                got = z["arr_0"]
            np.testing.assert_allclose(got, ref[i], rtol=0, atol=1e-4,
                                       err_msg=f"rep {rep}: {f}")


# ---------------------------------------------------------------------------
# the entry points as a user runs them
# ---------------------------------------------------------------------------


def _common_argv(files):
    return ["-dv", "cpu", "-l2n", files["label2name"], "-nc",
            str(N_CLASSES), "-m", "", "-eargs", files["enc_cfg"], "-dargs",
            files["det_cfg"], "-emtargs", files["emt_cfg"],
            "--inference_method", "par_fd_vs_aln"]


def test_video_clis_write_the_jax_files(tmp_path, files, clip):
    """demo_video.main and celeb_statistic.main with -dv cpu, models built
    from the flags' files: tracker.csv with JAX's columns and a row per
    sampled frame, frame_<idx>.png for -sfr, tracker.json; a second
    celeb_statistic run reuses the tracker.csv (fixed intervals)."""
    tracker = tmp_path / "tracker.csv"
    t_video.main(_common_argv(files) + [
        "-vp", clip, "-ot", str(tracker), "-of", str(tmp_path / "frames"),
        "--n_frames", "4", "-sfr"])
    rows = read_tracker(tracker)
    assert list(rows[0]) == ["Time", "Names", "Frame_idx", "Bboxes"]
    assert [r["Frame_idx"] for r in rows] == [str(i) for i in range(1, 9)]
    assert sorted(os.listdir(tmp_path / "frames")) == sorted(
        f"frame_{i}.png" for i in range(1, 9))
    stat_tracker = tmp_path / "stat.csv"
    js = tmp_path / "tracker.json"
    argv = _common_argv(files) + [
        "-vp", clip, "-ot", str(stat_tracker), "-jst", str(js),
        "--n_frames", "4", "-fidx", "1", "3", "-nvi", "2", "-tap", "1",
        "--track_bbox"]
    t_stat.main(argv)
    rows = read_tracker(stat_tracker)
    assert list(rows[0]) == ["Time", "Names", "Frame_idx", "Bboxes"]
    assert [r["Frame_idx"] for r in rows] == ["1", "3"]
    for r in rows:
        names = ast.literal_eval(r["Names"])
        boxes = ast.literal_eval(r["Bboxes"])
        assert len(names) == len(boxes)
        assert all(0.0 <= v <= 1.0 for b in boxes for v in b)
    stats = json.loads(js.read_text())
    assert sorted(stats) == ["1", "2"]
    seen = {n for r in rows for n in ast.literal_eval(r["Names"])}
    assert set(stats["1"]["celebrities"]) | set(
        stats["2"]["celebrities"]) == seen - {"Unknown"}
    os.remove(js)
    t_stat.main(argv + ["--statistic_mode", "fixed_itv"])  # reuses the csv
    assert sorted(json.loads(js.read_text())) == ["1"]


def test_clis_refuse_to_run_without_a_card(tmp_path, files, clip):
    """Without -dv every entry point asks for the card and, with none
    visible, raises before it builds a model or reads an input."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; the no-card contract is moot")
    calls = ((t_image.main, ["-i", "missing.png"]),
             (t_video.main, ["-vp", clip]),
             (t_stat.main, ["-vp", clip]),
             (t_emb.main, ["-d", str(tmp_path)]))
    for main, argv in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert os.listdir(tmp_path) == []


def test_cli_options_that_are_not_ported_raise(files, shared):
    """--n_devices other than 1 outside the processes that process_video
    launches (the sharded engine needs their mesh; its tests are in
    tests/test_torch_parallel_engine.py), --fused_engine with RetinaFace, and
    -ov without cv2 raise with the reason (--fan_weights is ported: its
    test is in tests/test_torch_dataset_tools.py)."""
    with pytest.raises(SystemExit, match="parallel.launch"):
        t_video.build_fused_engine(shared[0], (112, 112), n_devices=2)
    retina = (shared[0][0], TR.RetinaFace(device="cpu"), *shared[0][2:])
    with pytest.raises(SystemExit, match="MTCNN"):
        t_video.build_fused_engine(retina, (112, 112))
    code = ("import sys; sys.modules['cv2'] = None\n"
            "from vn_celeb_face_recognition_tpu_torch.cli import demo_video\n"
            "try:\n"
            "    demo_video.export_video_face_recognition('.', 25.0, 'x.mp4')\n"
            "except ImportError as exc:\n"
            "    assert 'cv2' in str(exc), exc\n"
            "    print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=dict(os.environ, PYTHONPATH=REPO_ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip() == "ok", proc.stderr
