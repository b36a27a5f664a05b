"""The last of the JAX package's surface on the port, on the CPU against the
JAX package: the engine's ``emotion_size``, the emotion head's
``num_projections``, ``MTCNN(weights_dir=)``, the library helpers of
``ops/image``, ``ops/boxes`` and ``pipeline/align``, the host helpers of
``utils`` and the ``false_prediction_vlz`` CLI. Inputs are made with numpy
from a seed; each test states its tolerance."""

import hashlib
import json
import os
import pickle
import shutil
import subprocess
import sys
from collections import namedtuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import false_prediction_vlz as j_vlz
import vn_celeb_face_recognition_tpu.pipeline.engine as jengine_mod
from vn_celeb_face_recognition_tpu.models import iresnet as JI
from vn_celeb_face_recognition_tpu.models import mtcnn as JM
from vn_celeb_face_recognition_tpu.models.mlp import MLPModel as JMLP
from vn_celeb_face_recognition_tpu.models.resnet_2_branch import (
    ResNet2Branch as JResNet2Branch,
)
from vn_celeb_face_recognition_tpu.ops import boxes as JB
from vn_celeb_face_recognition_tpu.ops import image as JImg
from vn_celeb_face_recognition_tpu.pipeline import align as JAlign
from vn_celeb_face_recognition_tpu.utils import io as j_io
from vn_celeb_face_recognition_tpu.utils import misc as j_misc
from vn_celeb_face_recognition_tpu_torch import models as TMods
from vn_celeb_face_recognition_tpu_torch.cli import false_prediction_vlz as t_vlz
from vn_celeb_face_recognition_tpu_torch.models import IResNet, MLPModel
from vn_celeb_face_recognition_tpu_torch.models import mtcnn as TM
from vn_celeb_face_recognition_tpu_torch.models.convert import (
    state_dict_from_jax,
    state_dict_to_jax,
)
from vn_celeb_face_recognition_tpu_torch.models.layers import (
    read_state_dict,
    seeded_init_,
)
from vn_celeb_face_recognition_tpu_torch.ops import boxes as TB
from vn_celeb_face_recognition_tpu_torch.ops import image as TImg
from vn_celeb_face_recognition_tpu_torch.pipeline import align as TAlign
from vn_celeb_face_recognition_tpu_torch.pipeline.engine import (
    FusedRecognitionEngine as TEngine,
)
from vn_celeb_face_recognition_tpu_torch.utils import download as t_download
from vn_celeb_face_recognition_tpu_torch.utils import io as t_io
from vn_celeb_face_recognition_tpu_torch.utils import kernels
from vn_celeb_face_recognition_tpu_torch.utils import misc as t_misc
from vn_celeb_face_recognition_tpu_torch.utils.frames import (
    build_frames,
    face_files,
    read_png,
)

from test_torch_emotion import emotion_pair
from test_torch_encoder import load_pair

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# min_face_size 50 (scale 12/50), as tests/test_torch_engine.py: at 12/40
# the JAX engine's jitted stage 1 divides by the scale as a multiply by its
# reciprocal, whose floor differs by 1 px at exact multiples (ROADMAP C9)
DET = dict(min_face_size=50, pnet_cap_per_scale=64, cross_cap=128,
           rnet_cap=32, onet_cap=16, out_cap=4)
# layer1/layer2 keep a block after the first, so K8's tails are on the path
EMO_LAYERS = (2, 2, 1, 1)
TAGS, TOPK = 9, 4


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    test processes at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _exact_warp(windows, mats, fs):
    """The JAX package's exact ``warp_affine`` in place of the JAX engine's
    3-shear warp, as tests/test_torch_production.py gives it."""
    return jax.vmap(lambda img, m: JImg.warp_affine(img, m, (fs, fs)))(
        windows, mats)


# ---------------------------------------------------------------------------
# The engine at emotion_size != 224
# ---------------------------------------------------------------------------


def test_engine_emotion_size_matches_jax_engine(monkeypatch):
    """emotion_size 64: the port's engine (area resize, ImageNet
    normalisation, the net's own stem, K8's plain tails) against the JAX
    engine on one 160 px frame: valid equal, boxes within 1e-2 px,
    emotion tags equal and their probabilities within 5e-3."""
    frames = build_frames(1, 160, 2, face_px=64)
    enc, enc_vars = load_pair(IResNet((1, 1, 1, 1)), seed=51)
    clf, clf_vars = load_pair(MLPModel(512, 10), seed=52)
    emo, emo_vars = emotion_pair(seed=53, num_classes=TAGS,
                                 layers=EMO_LAYERS)
    engine = TEngine(TM.MTCNN(device="cpu", **DET), enc, clf,
                     emotion=emo, emotion_size=64, emotion_topk=TOPK)
    assert engine.emotion_size == 64
    before = kernels.launch_counts()
    got = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in engine.process(frames).items()}
    assert kernels.launch_counts() == before  # CPU: plain versions only

    monkeypatch.setattr(jengine_mod, "batched_similarity_warp", _exact_warp)
    jeng = jengine_mod.FusedRecognitionEngine(
        JM.MTCNN(**DET), JI.IResNet(layers=(1, 1, 1, 1)), enc_vars,
        JMLP(512, 10), clf_vars, target_fs=112,
        emotion=JResNet2Branch(layers=EMO_LAYERS, num_classes=TAGS),
        emotion_variables=emo_vars, emotion_size=64, emotion_topk=TOPK)
    assert not jeng.fused_emotion_stem and not jeng.fused_bottlenecks
    want = jax.device_get(jeng.process(frames))
    v = np.asarray(want["valid"])
    assert v.sum() >= 1
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], atol=1e-2)
    assert got["emotion_idx"].shape == (1, DET["out_cap"], TOPK)
    np.testing.assert_array_equal(got["emotion_idx"][v],
                                  want["emotion_idx"][v])
    np.testing.assert_allclose(got["emotion_prob"][v],
                               want["emotion_prob"][v], atol=5e-3)


# ---------------------------------------------------------------------------
# The emotion head at num_projections != 300
# ---------------------------------------------------------------------------


def test_emotion_head_num_projections_matches_flax():
    """num_projections 128: build_model sizes ``proj`` as asked, and a
    shallow net's (x_cls, x_proj) on 64 px input equal the flax module's on
    the weights ``models.convert`` carries over, within 1e-4; the carried
    weights convert back unchanged."""
    full = TMods.build_model("resnet_2branch_50", num_classes=7,
                             num_projections=128)
    assert full.proj.out_features == 128 and full.fc.out_features == 7
    net = TMods.ResNet2Branch((1, 1, 1, 1), num_classes=7,
                              num_projections=128)
    seeded_init_(net, torch.Generator().manual_seed(5))
    net.eval()
    jvars = state_dict_to_jax(net)
    assert jvars["params"]["proj"]["kernel"].shape == (2048, 128)
    back = state_dict_from_jax(jvars)
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    x = np.random.default_rng(6).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    jnet = JResNet2Branch(layers=(1, 1, 1, 1), num_classes=7,
                          num_projections=128)
    want_cls, want_proj = jax.jit(jnet.apply)(jvars, jnp.asarray(x))
    with torch.no_grad():
        got_cls, got_proj = net.forward_normalized(torch.from_numpy(x))
    assert got_proj.shape == (2, 128)
    np.testing.assert_allclose(got_proj.numpy(), np.asarray(want_proj),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# MTCNN(weights_dir=)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mtcnn_frame():
    return torch.from_numpy(build_frames(1, 128, 1, face_px=72))


def _detections(det, frame):
    with torch.no_grad():
        return [t.numpy() for t in det.detect_padded(frame)]


def test_mtcnn_weights_dir_pt_files_equal_the_default(tmp_path,
                                                       mtcnn_frame):
    """A directory of ``.pt`` files written from the vendored npz gives the
    default's detections exactly; the JAX loader reads the same directory;
    a net's ``.npz`` is preferred to its ``.pt``."""
    for net in TM.NETS:
        sd = read_state_dict(os.path.join(TM.WEIGHTS_DIR, f"{net}.npz"))
        torch.save(sd, tmp_path / f"{net}.pt")
    cfg = dict(device="cpu", min_face_size=40, out_cap=4)
    want = _detections(TM.MTCNN(**cfg), mtcnn_frame)
    got = _detections(TM.MTCNN(weights_dir=str(tmp_path), **cfg),
                      mtcnn_frame)
    assert want[3].sum() >= 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jvars = JM.load_mtcnn_variables(str(tmp_path))
    assert jvars is not None and set(jvars) == set(TM.NETS)
    # an .npz beside the .pt wins, as in the JAX loader
    seeded = TM.PNet()
    seeded_init_(seeded, torch.Generator().manual_seed(9))
    np.savez(tmp_path / "pnet.npz",
             **{k: v.numpy() for k, v in seeded.state_dict().items()})
    mixed = TM.MTCNN(weights_dir=str(tmp_path), **cfg)
    for k, v in seeded.state_dict().items():
        torch.testing.assert_close(mixed.pnet.state_dict()[k], v)


def test_mtcnn_weights_dir_without_weights_warns_and_seeds(tmp_path,
                                                           mtcnn_frame,
                                                           monkeypatch):
    """A directory missing a net's weights seeds the nets with
    ``layers.seeded_init_`` and warns, and the cascade runs; without
    ``weights_dir`` the vendored weights stay required."""
    torch.save(read_state_dict(os.path.join(TM.WEIGHTS_DIR, "pnet.npz")),
               tmp_path / "pnet.pt")  # rnet and onet missing
    with pytest.warns(UserWarning, match="seeded"):
        det = TM.MTCNN(device="cpu", weights_dir=str(tmp_path), out_cap=4)
    assert JM.load_mtcnn_variables(str(tmp_path)) is None
    want = TM.RNet()
    seeded_init_(want, torch.Generator().manual_seed(0))
    for k, v in want.state_dict().items():
        torch.testing.assert_close(det.rnet.state_dict()[k], v)
    boxes, _, _, valid = _detections(det, mtcnn_frame)[:4]
    assert boxes.shape == (1, 4, 4) and valid.shape == (1, 4)
    monkeypatch.setattr(TM, "WEIGHTS_DIR", str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError, match="no MTCNN weights"):
        TM.MTCNN(device="cpu")


# ---------------------------------------------------------------------------
# The library helpers: crops, gather_rows, align_faces_batch
# ---------------------------------------------------------------------------


def _crop_case(seed, b=2, per=3, h=37, w=45):
    """uint8-valued f32 frames and per-frame blocks of integer 1-based
    inclusive boxes, some reaching past the frame or inverted."""
    gen = np.random.default_rng(seed)
    images = gen.integers(0, 256, (b, h, w, 3)).astype(np.float32)
    x1 = gen.integers(-3, w - 2, b * per)
    y1 = gen.integers(-3, h - 2, b * per)
    x2 = x1 + gen.integers(-1, 30, b * per)
    y2 = y1 + gen.integers(-1, 30, b * per)
    boxes = np.stack([x1, y1, x2, y2], -1).astype(np.float32)
    idx = np.repeat(np.arange(b, dtype=np.int32), per)
    return images, boxes, idx


@pytest.mark.parametrize("size", [24, 48])
def test_batched_crop_area_resize_equals_jax(size):
    """The flat interface over K4's plain version is exactly the JAX
    function on uint8-valued frames (boxes clamped as the cascade clamps
    them); K % B != 0 raises."""
    images, boxes, idx = _crop_case(size)
    h, w = images.shape[1:3]
    boxes = np.array(JB.clamp_boxes(jnp.asarray(boxes), w, h))
    want = jax.jit(JImg.batched_crop_area_resize, static_argnums=3)(
        jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(idx), size)
    before = kernels.launch_counts()
    got = TImg.batched_crop_area_resize(torch.from_numpy(images),
                                        torch.from_numpy(boxes),
                                        torch.from_numpy(idx), size,
                                        integral="ignored")
    assert kernels.launch_counts() == before  # CPU: the plain version
    assert got.shape == (6, size, size, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="split evenly"):
        TImg.batched_crop_area_resize(torch.from_numpy(images),
                                      torch.from_numpy(boxes[:5]),
                                      torch.from_numpy(idx[:5]), size)


def test_crop_resize_bilinear_and_batched_crop_resize_match_jax():
    """Bilinear crops at cell centres, clamped to the box: the batched form
    and the one-face form within 1e-4 of the JAX functions."""
    images, boxes, idx = _crop_case(3)
    idx = idx[::-1].copy()  # any order of frames
    want = jax.jit(JImg.batched_crop_resize, static_argnums=3)(
        jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(idx), 20)
    got = TImg.batched_crop_resize(torch.from_numpy(images),
                                   torch.from_numpy(boxes),
                                   torch.from_numpy(idx), 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    one = TImg.crop_resize_bilinear(torch.from_numpy(images[1]),
                                    torch.from_numpy(boxes[2]), 9)
    want1 = jax.jit(JImg.crop_resize_bilinear, static_argnums=2)(
        jnp.asarray(images[1]), jnp.asarray(boxes[2]), 9)
    np.testing.assert_allclose(one.numpy(), np.asarray(want1), rtol=1e-4,
                               atol=1e-4)


def test_gather_rows_equals_jax():
    """Nests of dicts, lists, tuples and named tuples: the same rows, the
    same nest."""
    gen = np.random.default_rng(8)
    Pair = namedtuple("Pair", "a b")
    f32 = np.float32
    tree = {"boxes": gen.normal(size=(7, 4)).astype(f32),
            "more": [gen.integers(0, 9, (7,)).astype(np.int32),
                     (gen.normal(size=(7, 2, 3)).astype(f32), None)],
            "pair": Pair(np.arange(7, dtype=np.int32),
                         gen.normal(size=(7, 5)).astype(f32))}
    idx = np.array([6, 0, 3, 3])
    want = JB.gather_rows(jax.tree_util.tree_map(jnp.asarray, tree),
                          jnp.asarray(idx))
    got = TB.gather_rows(
        jax.tree_util.tree_map(torch.from_numpy, tree), torch.from_numpy(idx))
    assert isinstance(got["pair"], Pair) and got["more"][1][1] is None
    assert (jax.tree_util.tree_structure(want)
            == jax.tree_util.tree_structure(
                jax.tree_util.tree_map(lambda t: t.numpy(), got)))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_align_faces_batch_matches_jax():
    """Batched Umeyama + the batched warp on float frames: within the 0.01
    that tests/test_ops_image.py pins for the warp, at a square and a
    non-square template size."""
    gen = np.random.default_rng(12)
    images = gen.uniform(0, 255, (2, 90, 80, 3)).astype(np.float32)
    idx = np.array([1, 0, 1], np.int32)
    tpl = JAlign.center_point_dict["(112, 112)"]
    landmarks = (tpl[None] * gen.uniform(0.4, 0.6, (3, 1, 1))
                 + gen.uniform(5, 30, (3, 1, 2))
                 + gen.normal(0, 1.5, (3, 5, 2))).astype(np.float32)
    for key, size in (("(112, 112)", (112, 112)), ("(96, 112)", (96, 112))):
        tpl = TAlign.center_point_dict[key]
        want = JAlign.align_faces_batch(jnp.asarray(images), jnp.asarray(idx),
                                        jnp.asarray(landmarks), tpl, size)
        got = TAlign.align_faces_batch(images, idx, landmarks, tpl, size,
                                       device="cpu")
        assert got.shape == (3, size[1], size[0], 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.01)


# ---------------------------------------------------------------------------
# The host helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["convert_ds_folder_2_def_structure",
                                  "convert_id_ds_2_def_structure"])
def test_dataset_flatteners_write_the_jax_files(tmp_path, name, capsys):
    """The flat copies and the label CSV, byte for byte, and the printed
    line."""
    root = tmp_path / "ds"
    for label, files in (("1", ["a.png", "b.png"]), ("3", ["c.png"]),
                         ("12", ["d.jpg"])):
        (root / label).mkdir(parents=True)
        for f in files:
            (root / label / f).write_bytes(f"{label}/{f}".encode())
    (root / "3" / "sub").mkdir()  # a directory is skipped
    out = {}
    for pkg, mod in (("jax", j_misc), ("port", t_misc)):
        getattr(mod, name)(str(root), str(tmp_path / pkg),
                           str(tmp_path / f"{pkg}.csv"))
        out[pkg] = capsys.readouterr().out.replace(pkg, "<pkg>")
    assert out["jax"] == out["port"]
    assert (tmp_path / "jax.csv").read_bytes() == (
        tmp_path / "port.csv").read_bytes()
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(
        os.listdir(tmp_path / "port")) and len(os.listdir(tmp_path / "jax")) == 4
    for f in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "jax" / f).read_bytes() == (
            tmp_path / "port" / f).read_bytes()


def test_plot_train_val_loss_draws_the_jax_png(tmp_path, capsys):
    """The port's plot of a trainer's log_loss.txt has the JAX plot's
    pixels; without matplotlib it raises an ImportError naming it."""
    import matplotlib.pyplot as plt

    log = tmp_path / "log_loss.txt"
    t_io.append_log_to_file(str(log), ["Epoch", "Train_loss",
                                       "Validation_loss"])
    for e, (tr, va) in enumerate([(2.5, 2.7), (1.25, 1.9), (0.7, 1.4),
                                  (0.41, 1.45)]):
        t_io.append_log_to_file(str(log), [str(e), repr(tr), repr(va)])
    pngs = {}
    for pkg, mod in (("jax", j_misc), ("port", t_misc)):
        plt.close("all")
        mod.plot_train_val_loss(str(log), str(tmp_path / f"{pkg}.png"))
        pngs[pkg] = read_png(str(tmp_path / f"{pkg}.png"))
    plt.close("all")
    assert "Plot train and val loss to" in capsys.readouterr().out
    np.testing.assert_array_equal(pngs["port"], pngs["jax"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(ImportError, match="matplotlib"):
            t_misc.plot_train_val_loss(str(log), str(tmp_path / "x.png"))


def test_save_pickle_round_trips(tmp_path):
    obj = {"a": [1, 2.5, "x"], "b": np.arange(4)}
    t_io.save_pickle(str(tmp_path / "p.pkl"), obj)
    for load in (t_io.load_pickle, j_io.load_pickle):
        back = load(str(tmp_path / "p.pkl"))
        assert back["a"] == obj["a"]
        np.testing.assert_array_equal(back["b"], obj["b"])
    j_io.save_pickle(str(tmp_path / "j.pkl"), obj)
    assert (tmp_path / "j.pkl").read_bytes() == (
        tmp_path / "p.pkl").read_bytes()


def test_download_url_to_file_checks_the_name_hash(tmp_path):
    """file:// URLs only: the sha256 prefix in the file's name is checked;
    a mismatch raises and leaves no temporary file."""
    payload = np.random.default_rng(2).bytes(3000)
    src = tmp_path / "src.bin"
    src.write_bytes(payload)
    digest = hashlib.sha256(payload).hexdigest()
    good = tmp_path / "out" / f"weights-{digest[:8]}.bin"
    got = t_download.download_url_to_file(src.as_uri(), str(good),
                                          progress=False)
    assert got == str(good) and good.read_bytes() == payload
    bad = tmp_path / "out" / "weights-0123abcd.bin"
    with pytest.raises(RuntimeError, match="invalid hash value"):
        t_download.download_url_to_file(src.as_uri(), str(bad),
                                        progress=False)
    assert sorted(os.listdir(tmp_path / "out")) == [good.name]
    plain = tmp_path / "out2" / "plain.bin"  # no tag in the name
    t_download.download_url_to_file(src.as_uri(), str(plain), progress=False)
    assert plain.read_bytes() == payload


# ---------------------------------------------------------------------------
# false_prediction_vlz
# ---------------------------------------------------------------------------


def test_false_prediction_vlz_cli_writes_the_jax_figures(tmp_path, capsys):
    """The port's CLI, run as a module with jax, pandas and cv2 absent (and
    imported with PIL absent too: only matplotlib, when it draws, imports
    PIL), against the repo-root CLI on data/'s PNGs and a small
    result.csv: the same file names, printed lines and PNG pixels."""
    files = face_files()[:4]
    manifest = {str(c): [os.path.basename(f)] for c, f in enumerate(files)}
    desc = tmp_path / "vn_celeb.json"
    desc.write_text(json.dumps(manifest))
    rows = [(files[0], 0, 0, 0.97), (files[1], 1, 3, 0.5123),
            (files[2], 2, 1, 0.25), (files[3], 3, 3, 0.88)]
    result = tmp_path / "result.csv"
    t_io.save_csv(rows, str(result),
                  columns=["Path", "Target", "Prediction", "Probability"])
    container = os.path.dirname(files[0])
    j_vlz.visualize_false_prediction(str(result), manifest, container,
                                     str(tmp_path / "jax"))
    want_out = capsys.readouterr().out
    code = (
        "import importlib, runpy, sys\n"
        "for absent in ('jax', 'flax', 'pandas', 'PIL', 'cv2'):\n"
        "    sys.modules[absent] = None\n"
        "importlib.import_module('vn_celeb_face_recognition_tpu_torch.cli."
        "false_prediction_vlz')\n"
        "del sys.modules['PIL']\n"
        "sys.argv = ['false_prediction_vlz', '-rp', sys.argv[1], '-dcrf',\n"
        "            sys.argv[2], '-icnt', sys.argv[3], '-ocnt', sys.argv[4]]\n"
        "runpy.run_module('vn_celeb_face_recognition_tpu_torch.cli."
        "false_prediction_vlz', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax',"
        " 'pandas', 'cv2') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code, str(result), str(desc), container,
         str(tmp_path / "port")], cwd=REPO_ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == want_out
    assert want_out.count("Save visualization for sample at") == 2
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["vlz_for_sample_0.png", "vlz_for_sample_1.png"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        np.testing.assert_array_equal(read_png(str(tmp_path / "port" / name)),
                                      read_png(str(tmp_path / "jax" / name)))
