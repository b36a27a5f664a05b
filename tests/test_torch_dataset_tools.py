"""The port's dataset-preparation CLIs (``cli.crop_face``, ``cli.align_face``,
``cli.split_train_val``) and its FAN landmark branch in the recognition
library and ``cli.demo_image`` against the JAX package and the repo-root
CLIs, on the CPU: the vendored MTCNN weights, a 1-module FAN on
numpy-seeded weights shared by both packages, small images. Each test states
its tolerance."""

import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import align_face as j_align
import crop_face as j_crop
import demo_image as j_image
import split_train_val as j_split
from vn_celeb_face_recognition_tpu.models import fan as JF
from vn_celeb_face_recognition_tpu.models import mtcnn as JM
from vn_celeb_face_recognition_tpu.models.torch_convert import (
    convert_state_dict,
)
from vn_celeb_face_recognition_tpu.pipeline import recognition as JRec
from vn_celeb_face_recognition_tpu_torch import models as TMods
from vn_celeb_face_recognition_tpu_torch.cli import align_face as t_align
from vn_celeb_face_recognition_tpu_torch.cli import crop_face as t_crop
from vn_celeb_face_recognition_tpu_torch.cli import demo_image as t_image
from vn_celeb_face_recognition_tpu_torch.cli import split_train_val as t_split
from vn_celeb_face_recognition_tpu_torch.models import fan as TF
from vn_celeb_face_recognition_tpu_torch.models import mtcnn as TM
from vn_celeb_face_recognition_tpu_torch.pipeline import center_point_dict
from vn_celeb_face_recognition_tpu_torch.pipeline import recognition as TRec
from vn_celeb_face_recognition_tpu_torch.utils import kernels
from vn_celeb_face_recognition_tpu_torch.utils.frames import (
    build_frames,
    face_files,
)

from test_torch_cli import cli_args, face_image, files, shared
from test_torch_encoder import random_state_dict

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MTCNN_JSON = os.path.join(REPO_ROOT, "cfg", "detection", "mtcnn.json")
with open(MTCNN_JSON) as _fp:
    MTCNN_CFG = json.load(_fp)
TEMPLATE = center_point_dict["(112, 112)"]
ENV = dict(os.environ, PYTHONPATH=REPO_ROOT, JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    test processes at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fan_pair(tmp_path_factory):
    """(port landmarker, JAX landmarker, .npz path): a 1-module FAN on the
    same numpy-seeded weights, the port's loaded from a torch-keyed
    .npz."""
    sd = random_state_dict(TF.FAN(num_modules=1), seed=41)
    path = tmp_path_factory.mktemp("fan") / "fan1.npz"
    np.savez(path, **sd)
    port = TF.FANLandmarker(num_modules=1, weights_path=str(path),
                            device="cpu")
    return port, JF.FANLandmarker(num_modules=1,
                                  variables=convert_state_dict(sd)), str(path)


@pytest.fixture(scope="module")
def mtcnn_pair():
    return JM.MTCNN(**MTCNN_CFG), TM.MTCNN(device="cpu", **MTCNN_CFG)


def lenient_gate(monkeypatch):
    """Seeded FAN landmarks seldom pass the geometric gate: wrap
    reduce_to_5_points in both packages to accept while still running
    it."""
    for mod in (JF, TF):
        real = mod.reduce_to_5_points
        monkeypatch.setattr(mod, "reduce_to_5_points",
                            lambda pts, real=real: (real(pts)[0], True))


def one_module_landmarkers(monkeypatch):
    """The CLIs build the 4-module landmarker of --fan_weights; make both
    packages build a 1-module one, so the test's .npz fits."""
    for mod in (JF, TMods):
        monkeypatch.setattr(mod, "FANLandmarker", functools.partial(
            mod.FANLandmarker, num_modules=1))


def _max_level_diff(a, b):
    return int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())


# ---------------------------------------------------------------------------
# inputs: face PNGs, a frame with two faces, a faceless image, a broken file
# ---------------------------------------------------------------------------


def _two_faces():
    frame = np.full((200, 400, 3), 90, np.uint8)
    for i, path in enumerate(face_files()[3:5]):
        face = cv2.resize(cv2.imread(path), (150, 150))
        frame[25:175, 30 + 200 * i:180 + 200 * i] = face
    return frame


def _faceless():
    yy, xx = np.mgrid[0:150, 0:170]
    return np.stack([yy, xx, (yy + xx) // 2], -1).astype(np.uint8)


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    """Three face PNGs of data/, a two-face frame, a faceless image and a
    file that is no image."""
    root = tmp_path_factory.mktemp("raw")
    for i, path in enumerate(face_files()[:3]):
        shutil.copy(path, root / f"face{i}.png")
    cv2.imwrite(str(root / "two_faces.png"), _two_faces())
    cv2.imwrite(str(root / "blank.png"), _faceless())
    (root / "broken.png").write_bytes(b"not an image")
    return str(root)


@pytest.fixture(scope="module")
def align_dir(tmp_path_factory):
    """The aligner's inputs: two face PNGs, the two-face frame and the
    faceless image."""
    root = tmp_path_factory.mktemp("to_align")
    for i, path in enumerate(face_files()[5:7]):
        shutil.copy(path, root / f"face{i}.png")
    cv2.imwrite(str(root / "two_faces.png"), _two_faces())
    cv2.imwrite(str(root / "blank.png"), _faceless())
    return str(root)


def _same_outputs(got_dir, want_dir, levels):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and names
    for name in names:
        got = cv2.imread(os.path.join(got_dir, name))
        want = cv2.imread(os.path.join(want_dir, name))
        assert got.shape == want.shape, name
        assert _max_level_diff(got, want) <= levels, name


def _read(path):
    with open(path) as fp:
        return fp.read()


# ---------------------------------------------------------------------------
# crop_face
# ---------------------------------------------------------------------------


def test_crop_face_matches_jax(tmp_path, raw_dir, mtcnn_pair):
    """crop_face, the port through ``python -m`` with -dv cpu, the JAX
    CLI's function with its MTCNN: the same crops bit for bit, equal
    unknown.txt and many_boxes.txt; then a rerun of the port skips every
    crop it wrote and returns the JAX stats' counts."""
    jout, pout = tmp_path / "jax", tmp_path / "port"
    jout.mkdir()
    with open(tmp_path / "j_unknown.txt", "w") as unknown, \
            open(tmp_path / "j_many.txt", "w") as many:
        want = j_crop.crop_face(raw_dir, str(jout), mtcnn_pair[0], unknown,
                                many)
    assert want == {"total": 6, "no_face": 2, "many_faces": 1, "skipped": 0}
    argv = ["-dv", "cpu", "-id", raw_dir, "-od", str(pout), "-nf",
            str(tmp_path / "unknown.txt"), "-mf", str(tmp_path / "many.txt"),
            "-dargs", MTCNN_JSON]
    proc = subprocess.run(
        [sys.executable, "-m", "vn_celeb_face_recognition_tpu_torch.cli."
         "crop_face", *argv], cwd=tmp_path, env=ENV, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Many face images: 1." in proc.stdout
    _same_outputs(pout, jout, levels=0)
    for mine, theirs in (("unknown.txt", "j_unknown.txt"),
                         ("many.txt", "j_many.txt")):
        assert _read(tmp_path / mine) == _read(tmp_path / theirs)
    assert _read(tmp_path / "unknown.txt").count("\n") == 2
    again = t_crop.main(argv)
    assert again == dict(want, skipped=4, many_faces=0)


# ---------------------------------------------------------------------------
# align_face
# ---------------------------------------------------------------------------


def test_align_face_mtcnn_matches_jax(tmp_path, align_dir, mtcnn_pair):
    """align_face with MTCNN's landmarks, the port's main with -dv cpu
    against the JAX CLI's function: the same files, aligned faces within 1
    level, the faceless image's blur sweep ending in the INTER_CUBIC
    fallback bit for bit, equal unknown.txt."""
    jout, pout = tmp_path / "jax", tmp_path / "port"
    jout.mkdir()
    with open(tmp_path / "j_unknown.txt", "w") as unknown:
        j_align.align_face(align_dir, str(jout), (112, 112), mtcnn_pair[0],
                           TEMPLATE, unknown)
    got = t_align.main(["-dv", "cpu", "-id", align_dir, "-od", str(pout),
                        "-as", "112", "112", "-nf",
                        str(tmp_path / "unknown.txt"), "-dargs",
                        MTCNN_JSON])
    assert got == {"total": 4, "no_face": 1}
    _same_outputs(pout, jout, levels=1)
    assert _read(tmp_path / "unknown.txt") == _read(
        tmp_path / "j_unknown.txt") == os.path.join(align_dir,
                                                    "blank.png") + "\n"
    np.testing.assert_array_equal(cv2.imread(str(pout / "blank.png")),
                                  cv2.imread(str(jout / "blank.png")))


@pytest.mark.parametrize("gate", ["real", "lenient"])
def test_align_face_fan_matches_jax(tmp_path, align_dir, mtcnn_pair,
                                    fan_pair, gate, monkeypatch):
    """align_face with FAN's landmarks (1 module, shared seeded weights):
    with the real gate (seeded landmarks seldom pass: the blur sweep runs
    FAN on each blurred image), and with the gate made lenient in both
    packages, the port through main --fan_weights. The same files, within
    1 level, equal unknown.txt."""
    jout, pout = tmp_path / "jax", tmp_path / "port"
    jout.mkdir()
    port_fan, jax_fan, npz = fan_pair
    if gate == "lenient":
        lenient_gate(monkeypatch)
    with open(tmp_path / "j_unknown.txt", "w") as unknown:
        j_align.align_face(align_dir, str(jout), (112, 112), mtcnn_pair[0],
                           TEMPLATE, unknown, fa_model=jax_fan)
    if gate == "lenient":
        one_module_landmarkers(monkeypatch)
        got = t_align.main(["-dv", "cpu", "-id", align_dir, "-od",
                            str(pout), "-as", "112", "112", "-nf",
                            str(tmp_path / "unknown.txt"), "-dargs",
                            MTCNN_JSON, "--fan_weights", npz])
        assert got == {"total": 4, "no_face": 0}
    else:
        pout.mkdir()
        with open(tmp_path / "unknown.txt", "w") as unknown:
            got = t_align.align_face(align_dir, str(pout), (112, 112),
                                     mtcnn_pair[1], TEMPLATE, unknown,
                                     fa_model=port_fan)
    _same_outputs(pout, jout, levels=1)
    assert _read(tmp_path / "unknown.txt") == _read(tmp_path /
                                                     "j_unknown.txt")
    assert got["no_face"] == _read(tmp_path / "unknown.txt").count("\n")


def test_dataset_clis_refuse_to_run_without_a_card(tmp_path, raw_dir):
    """Without -dv, crop_face and align_face ask for the card and, with none
    visible, raise before they make a directory or read an input."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; the no-card contract is moot")
    for main, extra in ((t_crop.main, []),
                        (t_align.main, ["-as", "112", "112"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-id", raw_dir, "-od", str(tmp_path / "out"), *extra])
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# the FAN branch of the library and of demo_image
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gate", ["real", "lenient"])
def test_sequential_fan_matches_jax(mtcnn_pair, fan_pair, gate,
                                    monkeypatch):
    """sequential_detect_and_align with fa_model on 2 frames of 256 px with
    4 faces each: JAX runs FAN once a face, the port once a call. Equal
    face counts (every face kept with the lenient gate), boxes within
    1e-2 px, aligned faces within 1 level; no kernel launches on the
    CPU."""
    frames = list(build_frames(2, 256, 4, 100))
    caps = dict(min_face_size=50, pnet_cap_per_scale=128, cross_cap=256,
                rnet_cap=64, onet_cap=32, out_cap=8)
    port_fan, jax_fan, _ = fan_pair
    if gate == "lenient":
        lenient_gate(monkeypatch)
    args = (TEMPLATE, (112, 112), {"min_dim": 40, "box_ratio": 2.0})
    want_faces, want_boxes = JRec.sequential_detect_and_align(
        frames, JM.MTCNN(**caps), *args, fa_model=jax_fan)
    before = kernels.launch_counts()
    got_faces, got_boxes = TRec.sequential_detect_and_align(
        frames, TM.MTCNN(device="cpu", **caps), *args, fa_model=port_fan)
    assert kernels.launch_counts() == before
    assert [len(f) for f in got_faces] == [len(f) for f in want_faces]
    if gate == "lenient":
        assert [len(f) for f in got_faces] == [4, 4]
    for g, w in zip(got_boxes, want_boxes):
        np.testing.assert_allclose(np.asarray(g, np.float32).reshape(-1, 4),
                                   np.asarray(w, np.float32).reshape(-1, 4),
                                   rtol=0, atol=1e-2)
    for gf, wf in zip(got_faces, want_faces):
        for g, w in zip(gf, wf):
            assert g.shape == (112, 112, 3) and _max_level_diff(g, w) <= 1


def test_demo_image_fan_matches_jax(tmp_path, files, shared, face_image,
                                    fan_pair, monkeypatch):
    """demo_image.main --fan_weights with seq_fd_vs_aln, the port's (-dv
    cpu) and the JAX CLI's on the same PNG, shared models and FAN weights
    (1 module), the lenient gate in both: equal names, boxes within 1e-4
    px, equal annotated pictures."""
    lenient_gate(monkeypatch)
    one_module_landmarkers(monkeypatch)
    npz = fan_pair[2]
    frame = np.full((240, 320, 3), 60, dtype=np.uint8)
    frame[40:200, 60:220] = face_image
    img = str(tmp_path / "input.png")
    cv2.imwrite(img, frame[..., ::-1])
    monkeypatch.setattr(j_image, "setup_models", lambda args: shared[1])
    monkeypatch.setattr(t_image, "setup_models", lambda args: shared[0])
    jargs = cli_args(j_image.build_arg_parser(), files, image_path=img,
                     output_path=str(tmp_path / "jax.png"),
                     inference_method="seq_fd_vs_aln", fan_weights=npz)
    want_names, want_boxes = j_image.main(jargs)
    got_names, got_boxes = t_image.main([
        "-dv", "cpu", "-i", img, "-o", str(tmp_path / "port.png"),
        "--inference_method", "seq_fd_vs_aln", "--fan_weights", npz])
    assert got_names == want_names and len(got_names) == 1
    np.testing.assert_allclose(np.asarray(got_boxes, np.float32),
                               np.asarray(want_boxes, np.float32), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port.png")),
                                  cv2.imread(str(tmp_path / "jax.png")))


def test_demo_image_fan_model_is_built_on_the_cli_device():
    """build_fan_model: no landmarker without --fan_weights; with it, one on
    -dv in --fan_dtype (a missing file warns and seeds, as in JAX)."""
    parser = t_image.build_arg_parser()
    args = parser.parse_args(["-dv", "cpu"])
    assert t_image.build_fan_model(args) is None
    args = parser.parse_args(["-dv", "cpu", "--fan_weights", "missing.npz",
                              "--fan_dtype", "bfloat16"])
    fan = t_image.build_fan_model(args)
    assert fan.device == torch.device("cpu")
    assert fan.net.dtype == torch.bfloat16 and fan.net.num_modules == 4


# ---------------------------------------------------------------------------
# split_train_val
# ---------------------------------------------------------------------------


LABEL_SETS = {
    "int": ["10", "2", "10", "7", "2", "2", "33", "10"],
    "str": ["bo", "al", "bo", "cy", "al", "al", "dan", "bo"],
    "float": ["1.5", "10", "1.5", "2.25", "10", "10", "3", "1.5"],
}


def _describe(path, labels):
    with open(path, "w") as fp:
        fp.write("image,label\n")
        for i, label in enumerate(labels):
            fp.write(f"img_{i}.png,{label}\n")


@pytest.mark.parametrize("kind", sorted(LABEL_SETS))
def test_split_functions_match_jax(tmp_path, kind):
    """create_file_describe_ds (csv in place of pandas) and
    split_train_val: the same JSON files, byte for byte, for integer labels
    (sorted numerically: 2 before 10), string and float labels; each
    label's images in row order."""
    _describe(tmp_path / "train.csv", LABEL_SETS[kind])
    for mod, tag in ((j_split, "jax"), (t_split, "port")):
        labels = mod.create_file_describe_ds(str(tmp_path / "train.csv"),
                                             str(tmp_path / f"{tag}.json"))
        mod.split_train_val(str(tmp_path / f"{tag}.json"),
                            str(tmp_path / f"{tag}_train.json"),
                            str(tmp_path / f"{tag}_val.json"))
        assert mod.remap_sequence_key(labels) == t_split.remap_sequence_key(
            labels)
    for name in ("{}.json", "{}_train.json", "{}_val.json"):
        assert _read(tmp_path / name.format("port")) == _read(
            tmp_path / name.format("jax"))
    if kind == "int":
        got = json.loads(_read(tmp_path / "port.json"))
        assert list(got) == ["2", "7", "10", "33"]
        assert got["10"] == ["img_0.png", "img_2.png", "img_7.png"]


def test_split_train_val_cli_matches_jax_with_the_remap_collision(tmp_path):
    """``python -m ...cli.split_train_val --remap_key`` and the repo-root
    CLI, defaults otherwise, in two directories: the same files byte for
    byte. -d train.csv and -tr train.json both name train_remap.json, so
    the train manifest's remap overwrites the describe file's in both
    (ROADMAP C8)."""
    for tag, cmd in (("jax", [os.path.join(REPO_ROOT, "split_train_val.py")]),
                     ("port", ["-m", "vn_celeb_face_recognition_tpu_torch."
                               "cli.split_train_val"])):
        work = tmp_path / tag
        work.mkdir()
        _describe(work / "train.csv", LABEL_SETS["int"])
        proc = subprocess.run([sys.executable, *cmd, "--remap_key"],
                              cwd=work, env=ENV, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["train.csv", "train.json", "train_remap.json",
                     "val.json", "val_remap.json", "vn_celeb.json"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "jax" /
                                                        name), name
    train = json.loads(_read(tmp_path / "port" / "train.json"))
    labels = json.loads(_read(tmp_path / "port" / "vn_celeb.json"))
    remap = json.loads(_read(tmp_path / "port" / "train_remap.json"))
    assert remap == t_split.remap_sequence_key(train)
    assert remap != t_split.remap_sequence_key(labels)
