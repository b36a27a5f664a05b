"""The port's readers of JPEG and video (``utils.frames.read_image``,
``cli.demo_video.frame_chunks``) and their choice between the IO runtime
(``native.loader``) and cv2, against the JAX package's readers (its native
runtime and its cv2 producer), on the CPU. Inputs are written here with cv2
from the repo's face crops: 20 frames of 320x240 as an MJPG ``.avi`` and an
``mp4v`` ``.mp4``, and JPEGs at two qualities and in grey.

Tolerance: both readers decode these files identically here (max abs diff
0, measured at these shapes with this machine's libjpeg, libav and cv2), so
frames are held equal, with equal chunk counts, frame indices, times and
fps. A build "made to fail" replaces ``loader.build`` by one that raises the
error a missing header gives; the loader's caches are reset around each
such test."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import demo_video as j_video
from vn_celeb_face_recognition_tpu import native as j_native
from vn_celeb_face_recognition_tpu_torch import data as PD
from vn_celeb_face_recognition_tpu_torch.cli import celeb_statistic as t_stat
from vn_celeb_face_recognition_tpu_torch.cli import demo_video as t_video
from vn_celeb_face_recognition_tpu_torch.cli import find_embedding as t_emb
from vn_celeb_face_recognition_tpu_torch.native import loader
from vn_celeb_face_recognition_tpu_torch.utils import frames as F

from test_torch_cli import (  # noqa: F401
    REPO_ROOT,
    _common_argv,
    files,
    read_tracker,
)
from torch_shared import jax_runtime, two_threads  # noqa: F401 (autouse)

FPS, N_VIDEO = 25.0, 20
CONTAINERS = {"avi": "MJPG", "mp4": "mp4v"}


@pytest.fixture(scope="module")
def frames():
    """20 RGB frames of 240x320 with two rows of faces."""
    return F.build_frames(N_VIDEO, 320, 4)[:, 40:280]


@pytest.fixture(scope="module")
def videos(tmp_path_factory, frames):
    root = tmp_path_factory.mktemp("videos")
    out = {}
    for ext, fourcc in CONTAINERS.items():
        path = str(root / f"clip.{ext}")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), FPS,
                                 (320, 240))
        assert writer.isOpened()
        for f in frames:
            writer.write(np.ascontiguousarray(f[..., ::-1]))
        writer.release()
        out[ext] = path
    return out


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory, frames):
    root = tmp_path_factory.mktemp("jpegs")
    out = {}
    for kind, img, q in (("q90", frames[0], 90), ("q60", frames[1], 60),
                         ("grey", frames[2][..., 0], 90)):
        path = str(root / f"{kind}.jpg")
        bgr = img if img.ndim == 2 else img[..., ::-1]
        assert cv2.imwrite(path, bgr, [cv2.IMWRITE_JPEG_QUALITY, q])
        out[kind] = path
    return out


@pytest.fixture()
def fresh_loader(monkeypatch):
    """The loader with no library loaded, no failure kept and no choice
    printed yet."""
    monkeypatch.setattr(loader, "_LIBS", {})
    monkeypatch.setattr(loader, "_FAILED", {})
    monkeypatch.setattr(loader, "_ANNOUNCED", set())


@pytest.fixture()
def no_runtime(fresh_loader, monkeypatch):
    """A machine without the runtime's headers: every build raises what a
    missing header gives. Returns the names the builds were asked for."""
    calls = []

    def build(name):
        calls.append(name)
        header = loader.LIBRARIES[name][2][0]
        raise RuntimeError(f"IO runtime {name}: header {header} not found; "
                           f"g++ ... \nfatal error: {header}: No such file")

    monkeypatch.setattr(loader, "build", build)
    return calls


def all_chunks(chunks):
    """(frames [n, H, W, 3], infos, frames per chunk) of a chunk stream."""
    chunks = list(chunks)
    return (np.stack([f for fr, _ in chunks for f in fr]),
            [i for _, infos in chunks for i in infos],
            [len(fr) for fr, _ in chunks])


# ---------------------------------------------------------------------------
# read_image
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_native", [None, True, False])
@pytest.mark.parametrize("kind", ["q90", "q60", "grey"])
def test_read_image_jpeg_matches_jax_readers(jpegs, kind, use_native,
                                             fresh_loader, capsys):
    """Each reader's RGB equals the JAX native decode and the JAX
    demo_image's cv2.imread turned to RGB, bit for bit; the choice is on
    stderr."""
    path = jpegs[kind]
    got = F.read_image(path, use_native=use_native)
    assert got.dtype == np.uint8 and got.shape == (240, 320, 3)
    np.testing.assert_array_equal(got, j_native.decode_image_file(path, 320,
                                                                  240))
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR)[
        ..., ::-1])
    reader = "cv2" if use_native is False else "the IO runtime"
    assert f"JPEG images: read by {reader}" in capsys.readouterr().err


def test_read_image_png_ignores_the_reader_choice(tmp_path, frames):
    path = str(tmp_path / "x.png")
    F.write_png(path, frames[3])
    for use_native in (None, True, False):
        np.testing.assert_array_equal(F.read_image(path, use_native),
                                      frames[3])


# ---------------------------------------------------------------------------
# frame_chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_native", [None, True, False])
@pytest.mark.parametrize("ext", list(CONTAINERS))
def test_frame_chunks_match_jax_readers(videos, ext, use_native,
                                        fresh_loader, capsys):
    """frame_chunks by each reader against the JAX CLI's producer of the
    same kind (None takes the runtime here on both sides): equal chunks,
    infos and fps, RGB frames equal to JAX's BGR flipped; and both of the
    port's readers give the same frames."""
    got, infos, sizes = all_chunks(t_video.frame_chunks(
        videos[ext], 8, use_native=use_native))
    jax_native = use_native is not False
    want, want_infos, want_sizes = all_chunks(j_video.frame_chunks(
        videos[ext], 8, use_native=jax_native))
    assert sizes == want_sizes == [8, 8, 4]
    assert infos == want_infos == [[c / FPS, c] for c in range(1, 21)]
    np.testing.assert_array_equal(got, want[..., ::-1])
    other, other_infos, _ = all_chunks(t_video.frame_chunks(
        videos[ext], 8, use_native=not jax_native))
    assert other_infos == infos
    np.testing.assert_array_equal(other, got)
    reader = "the IO runtime" if jax_native else "cv2"
    assert f"video frames: read by {reader}" in capsys.readouterr().err


@pytest.mark.parametrize("ext", list(CONTAINERS))
def test_frame_chunks_cv2_sampling_matches_jax(videos, ext):
    """-fidx sampling through cv2: the counts with ``count % fps`` in the
    indices, as the JAX cv2 producer keeps them."""
    idx = [1, 3, 6, 16]
    got, infos, _ = all_chunks(t_video.frame_chunks(videos[ext], 3, idx,
                                                    use_native=False))
    want, want_infos, _ = all_chunks(j_video.frame_chunks(
        videos[ext], 3, idx, use_native=False))
    assert [c for _, c in infos] == [1, 3, 6, 16]
    assert infos == want_infos
    np.testing.assert_array_equal(got, want[..., ::-1])


def test_frame_chunks_cv2_raises_on_a_file_it_cannot_open(tmp_path):
    bad = tmp_path / "not_a_video.avi"
    bad.write_bytes(b"no video here")
    with pytest.raises(IOError, match="cannot open video"):
        list(t_video.frame_chunks(str(bad), 4, use_native=False))


# ---------------------------------------------------------------------------
# the choice when the runtime does not build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what", ["image", "video"])
def test_use_native_true_raises_the_build_error(what, jpegs, videos,
                                                no_runtime):
    if what == "image":
        with pytest.raises(RuntimeError, match="header jpeglib.h not found"):
            F.read_image(jpegs["q90"], use_native=True)
    else:
        with pytest.raises(RuntimeError,
                           match="header libavcodec/avcodec.h not found"):
            list(t_video.frame_chunks(videos["avi"], 4, use_native=True))


@pytest.mark.parametrize("what", ["image", "video"])
def test_without_the_runtime_none_takes_cv2_and_says_why(
        what, jpegs, videos, frames, no_runtime, capsys):
    """use_native=None reads through cv2, equal to use_native=False, and
    prints the reader and the runtime's build error once a process."""
    if what == "image":
        got = F.read_image(jpegs["q90"])
        np.testing.assert_array_equal(got, F.read_image(jpegs["q90"], False))
        F.read_image(jpegs["q60"])
        reason = "header jpeglib.h not found"
        line = "JPEG images: read by cv2: the IO runtime is not available"
    else:
        got, infos, _ = all_chunks(t_video.frame_chunks(videos["avi"], 8))
        want, want_infos, _ = all_chunks(t_video.frame_chunks(
            videos["avi"], 8, use_native=False))
        np.testing.assert_array_equal(got, want)
        assert infos == want_infos
        list(t_video.frame_chunks(videos["mp4"], 8))
        reason = "header libavcodec/avcodec.h not found"
        line = "video frames: read by cv2: the IO runtime is not available"
    err = capsys.readouterr().err
    assert err.count(line) == 1 and reason in err, err


def test_available_tries_the_build_once_and_keeps_the_reason(no_runtime):
    assert not loader.available("video_io")
    assert not loader.available("video_io")
    with pytest.raises(RuntimeError, match="libavcodec/avcodec.h not found"):
        loader.library("video_io")
    assert no_runtime == ["video_io"]
    assert loader.unavailable_reason("video_io") == (
        "IO runtime video_io: header libavcodec/avcodec.h not found")
    assert loader.unavailable_reason("image_io") is None


_BUILD_AT_ONCE = """
import ctypes, os, sys, time
from vn_celeb_face_recognition_tpu_torch.native import loader
loader.BUILD_DIR, ready, go = sys.argv[1:4]
open(ready, "w").close()
while not os.path.exists(go):
    time.sleep(0.01)
path = loader.build("image_io")
ctypes.CDLL(path).vn_decode_jpeg
print(path)
"""


def test_two_processes_build_the_runtime_at_once(tmp_path):
    """Two processes that start the IO runtime's build at once in an empty
    build directory (several test workers or CLIs on a fresh checkout)
    both return a library that loads with its functions, at one path,
    beside the source's hash stamp: each compiles to a name of its own and
    renames the library, then the stamp, into place."""
    if loader.shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    build = tmp_path / "build"
    go = tmp_path / "go"
    procs = []
    for i in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _BUILD_AT_ONCE, str(build),
             str(tmp_path / f"ready{i}"), str(go)], cwd=REPO_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + 120
    while not all((tmp_path / f"ready{i}").exists() for i in range(2)):
        assert time.monotonic() < deadline, "the processes did not start"
        time.sleep(0.05)
    go.touch()
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lib = str(build / "libvn_image_io.so")
    assert [o.strip() for o, _ in outs] == [lib, lib]
    source, link, _, _ = loader.LIBRARIES["image_io"]
    assert (build / "libvn_image_io.so.sha256").read_text() == \
        loader._digest(source, link)
    assert not list(build.glob("*.tmp"))


@pytest.mark.parametrize("missing", ["header", "library"])
def test_the_reason_names_the_missing_header_or_library(tmp_path, monkeypatch,
                                                        fresh_loader,
                                                        missing):
    """A real g++ build that lacks a header or a library: available() is
    False and the reason names what is missing."""
    if loader.shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    src = tmp_path / "src"
    src.mkdir()
    if missing == "header":
        (src / "probe.cpp").write_text("#include <no_such_header_xyz.h>\n")
        link, want = [], "header no_such_header_xyz.h not found"
    else:
        (src / "probe.cpp").write_text("int vn_probe() { return 1; }\n")
        link, want = ["-lno_such_lib_xyz"], "library libno_such_lib_xyz not found"
    monkeypatch.setattr(loader, "SRC_DIR", str(src))
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setitem(loader.LIBRARIES, "probe",
                        ("probe.cpp", link, ["no_such_header_xyz.h"], {}))
    assert not loader.available("probe")
    assert want in loader.unavailable_reason("probe")


@pytest.mark.parametrize("what", ["image", "video"])
def test_neither_reader_raises_naming_both(what, jpegs, videos, no_runtime,
                                           monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 fails
    with pytest.raises(RuntimeError) as info:
        if what == "image":
            F.read_image(jpegs["q90"])
        else:
            list(t_video.frame_chunks(videos["avi"], 4))
    msg = str(info.value)
    assert "IO runtime" in msg and "not found" in msg and "cv2" in msg, msg


# ---------------------------------------------------------------------------
# the CLIs and the dataset on a machine without the runtime
# ---------------------------------------------------------------------------


def test_video_clis_read_a_file_through_cv2(tmp_path, files, videos,
                                            no_runtime, monkeypatch):
    """demo_video.main and celeb_statistic.main (-dv cpu) on the .avi
    without the runtime write the tracker.csv of a run with it."""
    runs = {}
    for label in ("cv2", "runtime"):
        if label == "runtime":
            monkeypatch.undo()
        out = tmp_path / label
        t_video.main(_common_argv(files) + [
            "-vp", videos["avi"], "-ot", str(out / "video.csv"), "-of",
            str(out / "frames"), "--n_frames", "8"])
        t_stat.main(_common_argv(files) + [
            "-vp", videos["avi"], "-ot", str(out / "stat.csv"), "-jst",
            str(out / "stat.json"), "--n_frames", "4", "-fidx", "1", "3",
            "-nvi", "1", "-tap", "1", "--track_bbox"])
        runs[label] = [read_tracker(out / f) for f in ("video.csv",
                                                       "stat.csv")]
        runs[label].append(json.loads((out / "stat.json").read_text()))
    assert no_runtime == ["video_io"]
    video, stat, js = runs["cv2"]
    assert [r["Frame_idx"] for r in video] == [str(c) for c in range(1, 21)]
    assert [r["Frame_idx"] for r in stat] == ["1", "3"]
    assert runs["cv2"] == runs["runtime"]


def test_jpeg_inputs_read_through_cv2(tmp_path, frames, no_runtime,
                                      monkeypatch):
    """find_embedding.main and VNCelebDataset on JPEG faces without the
    runtime give what they give with it: equal embeddings and images."""
    src = tmp_path / "faces"
    src.mkdir()
    faces = [np.ascontiguousarray(frames[i, 20:140, 20:140]) for i in
             range(3)]
    for i, f in enumerate(faces):
        cv2.imwrite(str(src / f"{i}_0.jpg"), f[..., ::-1])
    (tmp_path / "labels.json").write_text(json.dumps(
        {str(i): [f"{i}_0.jpg"] for i in range(3)}))
    got = {}
    for label in ("cv2", "runtime"):
        if label == "runtime":
            monkeypatch.undo()
        out = tmp_path / f"emb_{label}"
        t_emb.main(["-dv", "cpu", "-d", str(src), "-o", str(out), "-bz",
                    "2", "-w", "none"])
        ds = PD.VNCelebDataset(str(src), str(tmp_path / "labels.json"))
        got[label] = ([np.load(out / f"{i}_0.npz")["arr_0"]
                       for i in range(3)], [ds[i][0] for i in range(3)])
    assert no_runtime == ["image_io"]
    for a, b in zip(*(got[k][0] for k in got)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(*(got[k][1] for k in got)):
        np.testing.assert_array_equal(a, b)
    assert os.listdir(tmp_path / "emb_cv2")
