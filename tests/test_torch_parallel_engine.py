"""The port's FusedRecognitionEngine, the recognition library's Encoder
and ``cli.demo_video`` / ``cli.celeb_statistic`` sharded over a data mesh
of gloo processes (``parallel.launch``, 120 s limit, one torch thread a
process; the functions they run are in tests/torch_parallel_workers.py),
against the JAX package's mesh on the 8 virtual CPU devices of
tests/conftest.py and against the port's one-process runs.

The setting is tests/test_torch_engine.py's (MTCNN at min_face_size 50
on 256 px frames of pasted faces, where the two packages' cascades agree;
the JAX pyramid in XLA, not its Pallas kernel in interpret mode)
with tests/test_engine.py's tiny encoder and a 16-class MLP. On the CPU
the JAX engine warps by its 3-shear factorisation, so its valid slots,
boxes and overflow are compared to the JAX mesh engine, and predictions
and embeddings to the JAX package's functions composed with the exact
warp over the global selection (what the mesh engine computes). Each test
states its tolerance.
"""

import ast
import csv
import functools
import json
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn
import jax
import jax.numpy as jnp

import torch_parallel_workers as W
from torch_shared import once_a_run
from vn_celeb_face_recognition_tpu.models import mtcnn as JM
from vn_celeb_face_recognition_tpu.models.mlp import MLPModel as JMLP
from vn_celeb_face_recognition_tpu.ops.image import (
    fixed_image_standardization,
    warp_affine,
)
from vn_celeb_face_recognition_tpu.ops.similarity import umeyama_similarity
from vn_celeb_face_recognition_tpu.parallel import make_mesh as j_mesh
from vn_celeb_face_recognition_tpu.pipeline.align import (
    center_point_dict as j_templates,
)
from vn_celeb_face_recognition_tpu.pipeline.engine import (
    FusedRecognitionEngine as JEngine,
)
from vn_celeb_face_recognition_tpu.pipeline.recognition import _JitApply
from vn_celeb_face_recognition_tpu_torch.cli import celeb_statistic as t_stat
from vn_celeb_face_recognition_tpu_torch.cli import demo_video as t_video
from vn_celeb_face_recognition_tpu_torch.models.convert import (
    state_dict_from_jax,
)
from vn_celeb_face_recognition_tpu_torch.parallel import launch
from vn_celeb_face_recognition_tpu_torch.pipeline.recognition import Encoder
from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames


LAUNCH = dict(timeout=120, threads=1)
DET = dict(min_face_size=50, pnet_cap_per_scale=128, cross_cap=256,
           rnet_cap=64, onet_cap=32, out_cap=8)
CLASSES = 16
CAP = 16  # below the chunk's 32 faces: the selection decides which stay


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class TinyEnc(nn.Module):
    """tests/test_engine.py's encoder (W.TinyEnc is the port's)."""

    @nn.compact
    def __call__(self, x, train=False):
        x = nn.Conv(8, (3, 3), strides=(4, 4))(x)
        return nn.Dense(512)(jnp.mean(x, axis=(1, 2)))


def port_enc_state(enc_vars):
    tree = jax.tree_util.tree_map(np.asarray, enc_vars)["params"]
    return {"conv.weight": np.ascontiguousarray(
                np.transpose(tree["Conv_0"]["kernel"], (3, 2, 0, 1))),
            "conv.bias": np.array(tree["Conv_0"]["bias"]),
            "dense.weight": np.ascontiguousarray(tree["Dense_0"]["kernel"].T),
            "dense.bias": np.array(tree["Dense_0"]["bias"])}


def jax_composition(frames, det, enc_vars, clf_vars, face_cap, fs=112,
                    win=224):
    """The chunk from JAX package functions on the cascade's outputs
    ``det`` (the JAX mesh engine's boxes, scores, points and valid
    slots), with the exact warp and the global top-``face_cap`` selection
    (ties to the lower slot)."""
    b, h, w = frames.shape[:3]
    boxes, score, points, valid = (jnp.asarray(det[k]) for k in (
        "boxes", "scores", "points", "valid"))
    k = boxes.shape[1]
    selkey = valid.reshape(-1).astype(jnp.float32) * 2.0 + score.reshape(-1)
    _, sel = jax.lax.top_k(selkey, face_cap)
    flat_pts = points.reshape(b * k, 5, 2)[sel]
    flat_boxes = boxes.reshape(b * k, 4)[sel]
    image_idx = jnp.repeat(jnp.arange(b, dtype=jnp.int32), k)[sel]
    frames_f = jnp.asarray(frames, jnp.float32)
    win = min(win, h, w)
    cx = (flat_boxes[:, 0] + flat_boxes[:, 2]) * 0.5
    cy = (flat_boxes[:, 1] + flat_boxes[:, 3]) * 0.5
    ox = jnp.clip(jnp.round(cx - win / 2), 0, w - win)
    oy = jnp.clip(jnp.round(cy - win / 2), 0, h - win)
    windows = jax.vmap(lambda i, y, x: jax.lax.dynamic_slice(
        frames_f, (i, y.astype(jnp.int32), x.astype(jnp.int32), 0),
        (1, win, win, 3))[0])(image_idx, oy, ox)
    local_pts = flat_pts - jnp.stack([ox, oy], axis=-1)[:, None, :]
    template = jnp.asarray(j_templates[str((fs, fs))])
    mats = jax.vmap(lambda lm: umeyama_similarity(lm, template))(local_pts)
    faces = jax.vmap(lambda img, m: warp_affine(img, m, (fs, fs)))(
        windows, mats)
    emb = TinyEnc().apply(enc_vars, fixed_image_standardization(faces))
    logp = JMLP(512, CLASSES).apply(clf_vars, emb)
    sel = np.asarray(sel)
    emb_full = np.zeros((b * k, 512), np.float32)
    emb_full[sel] = np.asarray(emb)
    pred_full = np.zeros(b * k, np.int64)
    pred_full[sel] = np.asarray(jnp.argmax(logp, -1))
    return {"valid": np.asarray(valid), "boxes": np.asarray(boxes),
            "embeddings": emb_full.reshape(b, k, 512),
            "pred": pred_full.reshape(b, k)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the tests compare, computed once a run
    (``torch_shared.once_a_run``: numpy and plain Python)."""
    return once_a_run(tmp_path_factory, "parallel_engine_runs", compute_runs)


def compute_runs():
    """One launch of 2 (the sharded engine's chunks, the adaptive retry,
    the Encoder apply), started first in a thread; meanwhile the JAX mesh
    engine, the JAX composition and the port's one-process runs go here."""
    frames = build_frames(8, 256, 4, face_px=100)
    # faces in the first data block's frames only
    lopsided = frames.copy()
    lopsided[4:] = 90
    key = jax.random.PRNGKey(0)
    enc_vars = TinyEnc().init(key, jnp.zeros((1, 112, 112, 3)))
    clf_vars = JMLP(512, CLASSES).init(key, jnp.zeros((1, 512)))
    enc_state = port_enc_state(enc_vars)
    clf_state = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, clf_vars)).items()}
    # standardised faces' range
    enc_x = np.random.default_rng(3).uniform(
        -1, 1, size=(23, 32, 32, 3)).astype(np.float32)
    chunks = [("capped", frames, CAP), ("ragged", frames[:7], CAP)]
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(launch, W.engine_checks, 2, "cpu", chunks,
                           enc_state, clf_state, DET, (lopsided, [2, 32], 1),
                           enc_x, **LAUNCH)
        jeng = JEngine(JM.MTCNN(fused_pyramid_pnet=False, **DET), TinyEnc(),
                       enc_vars, JMLP(512, CLASSES), clf_vars, target_fs=112,
                       mesh=j_mesh(n_data=2, n_model=1), face_cap=CAP)
        jax_mesh = jax.device_get(jeng.process(frames))
        composed = jax_composition(frames, jax_mesh, enc_vars, clf_vars, CAP)
        apply = _JitApply(TinyEnc(), enc_vars,
                          mesh=j_mesh(n_data=2, n_model=1))(enc_x)
        one = {name: W.outputs_np(W.make_engine(
            None, enc_state, clf_state, DET, face_cap=cap).process(f))
            for name, f, cap in chunks}
        eng = W.make_engine(None, enc_state, clf_state, DET,
                            face_cap=[2, 32], face_hint=1)
        one["adaptive"] = W.outputs_np(eng.process_adaptive(lopsided))
        one["encoder"] = Encoder(W.tiny_enc(enc_state), device="cpu")(enc_x)
        port = port.result()
    return {"port": port, "one": one, "jax_mesh": jax_mesh,
            "composed": composed, "jax_apply": apply}


def assert_outputs_equal(got, want, atol=1e-5):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"].astype(bool)
    np.testing.assert_array_equal(got["pred"][v], want["pred"][v])
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], atol=atol)
    np.testing.assert_allclose(got["embeddings"][v], want["embeddings"][v],
                               atol=atol)


def test_sharded_engine_matches_jax_mesh_engine(runs):
    """8 frames of 4 faces over a data mesh of 2, face_cap 16 (32 valid
    faces): every rank returns the whole chunk. Against the JAX engine on
    a mesh of 2: equal valid slots and overflow (16, on every rank), boxes
    within 1e-2 px; against the JAX composition over the global selection:
    equal predictions at every valid slot (0 where a face was dropped) and
    embeddings within 1e-4; against the port's one-process engine: equal,
    boxes and embeddings within 1e-5."""
    want, ref = runs["jax_mesh"], runs["composed"]
    ranks = runs["port"]["capped"]
    assert int(ref["valid"].sum()) == 32
    v = ref["valid"].astype(bool)
    for got in ranks:
        np.testing.assert_array_equal(got["valid"], np.asarray(want["valid"]))
        np.testing.assert_allclose(got["boxes"][v],
                                   np.asarray(want["boxes"])[v], atol=1e-2)
        assert int(got["face_cap_overflow"]) == int(
            want["face_cap_overflow"]) == 16
        np.testing.assert_array_equal(got["pred"][v], ref["pred"][v])
        np.testing.assert_allclose(got["embeddings"][v],
                                   ref["embeddings"][v], atol=1e-4)
        assert_outputs_equal(got, runs["one"]["capped"])
        assert got["_face_cap_used"] == CAP


def test_sharded_engine_ragged_chunk(runs):
    """A 7-frame chunk on 2 data ranks is padded with a blank frame to 8
    (4 frames a rank) and sliced back: 7 frames out on every rank, equal
    to the one-process engine's run of the 7 frames."""
    for got in runs["port"]["ragged"]:
        assert got["valid"].shape == (7, DET["out_cap"])
        assert got["embeddings"].shape == (7, DET["out_cap"], 512)
        assert_outputs_equal(got, runs["one"]["ragged"])
        assert int(got["face_cap_overflow"]) == int(
            runs["one"]["ragged"]["face_cap_overflow"])


def test_sharded_adaptive_retry_that_one_rank_triggers(runs):
    """Faces in rank 0's frames only, buckets [2, 32], hint 1: the first
    pass runs at 2 and both ranks see the same global overflow (rank 1
    holds no valid face of its own, so a per-rank count would say 0); the
    retry runs on both ranks together at 32, and its outputs equal the
    one-process process_adaptive; observe() leaves the same hint on both
    ranks."""
    ranks = runs["port"]["adaptive"]
    nvalid = int(runs["one"]["adaptive"]["valid"].sum())
    assert nvalid >= 12
    assert int(runs["one"]["adaptive"]["valid"][4:].sum()) == 0
    for r in ranks:
        assert r["first"]["_face_cap_used"] == 2
        assert int(r["first"]["face_cap_overflow"]) == nvalid - 2
        assert r["out"]["_face_cap_used"] == 32
        assert int(r["out"]["face_cap_overflow"]) == 0
        assert r["hint"] == nvalid
        assert_outputs_equal(r["out"], runs["one"]["adaptive"])


def test_sharded_encoder_apply_with_ragged_n(runs):
    """The library's Encoder with mesh= on 23 faces over 2 ranks (padded to
    24 with copies of the first, applied a block a rank, gathered, cut to
    23): every rank's output equals JAX's _JitApply on a mesh of 2 and the
    one-process Encoder within rtol 1e-5, atol 1e-5."""
    want, one = runs["jax_apply"], runs["one"]["encoder"]
    for got in runs["port"]["encoder"]:
        assert got.shape == (23, 512)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The CLIs' inputs of tests/test_torch_cli.py: a label2name table of
    16 classes, a seeded encoder, MTCNN at min_face_size 40, and the
    8-frame MJPG clip of a 160 px face drifting over 240x320."""
    import cv2

    from toy_data import toy_face_files

    root = tmp_path_factory.mktemp("cli")
    (root / "label2name.csv").write_text(
        "label,name\n" + "".join(f"{i},Person_{i}\n" for i in range(16)))
    (root / "enc.json").write_text(json.dumps({"pretrained": None}))
    (root / "det.json").write_text(json.dumps(
        {"image_size": 160, "keep_all": True, "min_face_size": 40}))
    face = cv2.resize(cv2.imread(toy_face_files()[0]), (160, 160),
                      interpolation=cv2.INTER_AREA)
    writer = cv2.VideoWriter(str(root / "clip.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 8.0, (320, 240))
    for t in range(8):
        frame = np.full((240, 320, 3), 60, dtype=np.uint8)
        frame[40:200, 20 + 4 * t:180 + 4 * t] = face
        writer.write(frame)
    writer.release()
    return {name: str(root / name) for name in
            ("label2name.csv", "enc.json", "det.json", "clip.avi")}


def assert_same_json(got, want, atol=1e-4):
    """Equal JSON trees, numbers within ``atol``."""
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert_same_json(got[k], want[k], atol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_same_json(a, b, atol)
    elif isinstance(want, float):
        assert abs(got - want) <= atol
    else:
        assert got == want


def read_rows(path):
    with open(path, newline="") as fp:
        return list(csv.DictReader(fp))


def test_video_clis_n_devices_2_match_one_process(tmp_path, files, monkeypatch):
    """celeb_statistic.main --fused_engine --n_devices 2 -dv cpu (two gloo
    processes, its launch given a 120 s limit here; --n_frames 3 makes a
    ragged last chunk of 2, --face_cap 4,16 compaction and retries) writes
    a tracker.csv and tracker.json equal to demo_video.main's --n_devices 1
    run and the JSON made from it: the same rows, names, times and frame
    indices, boxes within 1e-4 (normalised), the same JSON (its boxes within
    1e-4)."""
    monkeypatch.setattr(t_video, "launch", functools.partial(launch,
                                                             **LAUNCH))
    common = ["-dv", "cpu", "-l2n", files["label2name.csv"], "-nc", "16",
              "-m", "", "-eargs", files["enc.json"], "-dargs",
              files["det.json"], "--inference_method", "par_fd_vs_aln",
              "-vp", files["clip.avi"],
              "--n_frames", "3", "--fused_engine", "--face_cap", "4,16",
              "-of", str(tmp_path / "frames")]
    stat = ["-nvi", "2", "-tap", "1", "--track_bbox"]
    one, two = tmp_path / "one.csv", tmp_path / "two.csv"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t_video.main(common + ["-ot", str(one)])
        t_stat.main(common + stat + ["-ot", str(two), "-jst",
                                     str(tmp_path / "two.json"),
                                     "--n_devices", "2"])
        t_stat.main(common + stat + ["-ot", str(one), "-jst",
                                     str(tmp_path / "one.json")])
    got, want = read_rows(two), read_rows(one)
    assert list(got[0]) == ["Time", "Names", "Frame_idx", "Bboxes"]
    assert [r["Frame_idx"] for r in got] == [str(i) for i in range(1, 9)]
    seen = 0
    for g, w in zip(got, want):
        for col in ("Time", "Names", "Frame_idx"):
            assert g[col] == w[col], col
        gb, wb = ast.literal_eval(g["Bboxes"]), ast.literal_eval(w["Bboxes"])
        assert len(gb) == len(wb)
        seen += len(gb)
        if gb:
            np.testing.assert_allclose(gb, wb, atol=1e-4)
    assert seen >= 8
    assert_same_json(json.loads((tmp_path / "two.json").read_text()),
                     json.loads((tmp_path / "one.json").read_text()))
