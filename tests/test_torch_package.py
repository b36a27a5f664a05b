"""Packaging contracts of the PyTorch port: it imports no JAX, reads the
face PNGs without PIL, selects devices without falling back, and its
kernel wrappers dispatch on the tensor's device."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vn_celeb_face_recognition_tpu_torch.utils import frames as F
from vn_celeb_face_recognition_tpu_torch.utils import kernels
from vn_celeb_face_recognition_tpu_torch.utils.device import select_device

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "vn_celeb_face_recognition_tpu_torch"


def _port_modules():
    mods = []
    root = os.path.join(REPO_ROOT, PKG)
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO_ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_without_jax_or_flax():
    mods = _port_modules()
    assert f"{PKG}.pipeline.engine" in mods and len(mods) >= 15
    for mod in ("models.retinaface", "models.iresnet",
                "models.resnet_2_branch", "ops.planar_s1",
                "ops.emotion_stem", "ops.bottleneck", "ops.nms", "ops.crop",
                "ops.crops_net"):
        assert f"{PKG}.{mod}" in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'vn_celeb_face_recognition_tpu') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_png_reader_equals_pil():
    from PIL import Image

    files = F.face_files()
    assert len(files) == 20
    for f in files:
        want = np.asarray(Image.open(f).convert("RGB"))
        got = F.read_png(f)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_build_frames_equals_bench_build_frames():
    """The PIL-free frames (numpy bicubic resize) are the bench's frames,
    byte for byte."""
    sys.path.insert(0, REPO_ROOT)
    import bench

    for args in ((3, 640, 4), (2, 256, 4, 100)):
        np.testing.assert_array_equal(F.build_frames(*args),
                                      bench.build_frames(*args))


def test_select_device():
    assert select_device("cpu") == torch.device("cpu")
    assert select_device("CPU") == torch.device("cpu")
    with pytest.raises(ValueError):
        select_device("tpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; the no-card contract is moot")
    for name in ("cuda", "cuda:0", "GPU"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            select_device(name)


def test_kernel_build_bookkeeping(tmp_path, monkeypatch):
    """Sources are hashed for rebuilds; a missing nvcc raises (no
    fallback); counters reset."""
    assert {os.path.basename(s) for s in kernels._sources()} >= {
        "pyramid_pnet.cu", "similarity_warp.cu", "mnet_stage1.cu",
        "emotion_stem.cu", "bottleneck_chain.cu", "nms_keep.cu",
        "crop_area_pool.cu", "crop_net_trunk.cu", "launch.cuh", "mma.cuh"}
    digest = kernels.sources_hash()
    assert digest == kernels.sources_hash() and len(digest) == 64
    # every device function chip_smoke.py times a kernel by is a grid in
    # the sources (K6's and K7's bf16 tensor-core grids among them)
    sys.path.insert(0, REPO_ROOT)
    from chip_smoke import KERNEL_GRIDS

    sources = "".join(open(s).read() for s in kernels._sources())
    grids = {g for names in KERNEL_GRIDS.values() for g in names}
    assert {"segment_mma", "emotion_stem_mma"} <= grids
    for grid in grids:
        assert re.search(rf"[\s*]{grid}\w*\(", sources), grid
    assert set(kernels.launch_counts()) == {
        "pnet_chain", "similarity_warp", "mnet_stage1", "emotion_stem",
        "bottleneck_chain", "nms_keep_mask", "crop_area_resize",
        "crop_net_trunk"}
    assert set(kernels.SIGNATURES) == {
        "vn_similarity_warp", "vn_similarity_warp_boxes", "vn_pyramid_pnet",
        "vn_mnet_stage1",
        "vn_emotion_stem", "vn_bottleneck_block", "vn_nms_keep_mask",
        "vn_integral_image", "vn_crop_area_pool", "vn_crop_net_trunk"}
    kernels.count_launch("pnet_chain")
    assert kernels.launch_counts()["pnet_chain"] >= 1
    before = kernels.launch_counts()["mnet_stage1"]
    kernels.count_launch("mnet_stage1", 3)  # one per grid launched
    assert kernels.launch_counts()["mnet_stage1"] == before + 3
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernels.find_nvcc()


def test_kernel_wrappers_never_fall_back():
    """The wrappers take the plain versions only for CPU tensors: the
    kernel entry points refuse CPU tensors before touching the library,
    and a tensor on any other non-CUDA device raises."""
    from vn_celeb_face_recognition_tpu_torch.models.mtcnn import PNet
    from vn_celeb_face_recognition_tpu_torch.ops import pyramid_pnet as K2
    from vn_celeb_face_recognition_tpu_torch.ops import warp as K1

    windows = torch.zeros((2, 16, 16, 3))
    mats = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]] * 2)
    frames = torch.zeros((1, 60, 60, 3), dtype=torch.uint8)
    sizes = [(30, 30)]
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        K1.similarity_warp_kernel(windows, mats, 8)
    for dtype in (torch.float32, torch.bfloat16):  # both grids
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            K2.pyramid_pnet_kernel(PNet(), frames, sizes, dtype=dtype)
    with pytest.raises(ValueError, match="unsupported device"):
        K1.similarity_warp(windows.to("meta"), mats.to("meta"), 8)
    with pytest.raises(ValueError, match="unsupported device"):
        K2.pyramid_pnet(PNet(), frames.to("meta"), sizes)
    assert kernels.launch_counts() == before
    assert K1.similarity_warp(windows, mats, 8).shape == (2, 8, 8, 3)
    (probs, reg), = K2.pyramid_pnet(PNet(), frames, sizes,
                                    dtype=torch.bfloat16)
    assert probs.shape == (1, 10, 10) and reg.dtype == torch.float32
    assert kernels.launch_counts() == before


def test_new_kernel_wrappers_never_fall_back():
    """K3-K8: the kernel entry points refuse CPU tensors before touching
    the library, a non-CUDA, non-CPU tensor raises, and CPU tensors take
    the plain versions without counting a launch."""
    from vn_celeb_face_recognition_tpu_torch.models.mtcnn import ONet, RNet
    from vn_celeb_face_recognition_tpu_torch.models.resnet_2_branch import (
        ResNet2Branch,
    )
    from vn_celeb_face_recognition_tpu_torch.ops import crop as K4
    from vn_celeb_face_recognition_tpu_torch.ops import crops_net as K5
    from vn_celeb_face_recognition_tpu_torch.ops import nms as K3
    from vn_celeb_face_recognition_tpu_torch.models.retinaface import (
        RetinaFaceNet,
    )
    from vn_celeb_face_recognition_tpu_torch.ops import bottleneck as K8
    from vn_celeb_face_recognition_tpu_torch.ops import emotion_stem as K7
    from vn_celeb_face_recognition_tpu_torch.ops import planar_s1 as K6

    stage1 = RetinaFaceNet().body.stage1.eval()
    emo = ResNet2Branch(layers=(2, 2, 1, 1), num_classes=3).eval()
    frames = torch.zeros((1, 24, 40, 3), dtype=torch.uint8)
    faces = torch.zeros((2, 112, 112, 3))
    blocks = list(emo.layer1)[1:]
    x = torch.zeros((1, 6, 5, 256))
    sub = (104.0, 117.0, 123.0)
    boxes = torch.tensor([[[1.0, 1.0, 9.0, 9.0], [2.0, 2.0, 9.0, 9.0]]])
    scores = torch.tensor([[0.9, 0.8]])
    valid = torch.ones((1, 2), dtype=torch.bool)
    integ = K4.integral_image(frames)
    calls = (
        (K3.nms_keep_mask_kernel, K3.nms_keep_mask,
         lambda f, t: f(t, scores.to(t.device), valid.to(t.device), 0.5),
         boxes),
        (K4.integral_image_kernel, K4.integral_image, lambda f, t: f(t),
         frames),
        (K4.crop_area_pool_kernel, K4.crop_area_pool,
         lambda f, t: f(t, boxes.to(t.device), 24), integ),
        (K5.crop_net_trunk_kernel, K5.crop_net_trunk,
         lambda f, t: f(RNet(), t, K5.RNET_SPEC), torch.zeros((2, 24, 24, 3))),
        (K5.crop_net_trunk_kernel, K5.crop_net_trunk,
         lambda f, t: f(ONet(), t, K5.ONET_SPEC), torch.zeros((1, 48, 48, 3))),
        (K6.mnet_stage1_kernel, K6.mnet_stage1,
         lambda f, t: f(stage1, t, sub, torch.float32), frames),
        (K6.mnet_stage1_kernel, K6.mnet_stage1,  # the tensor-core grids
         lambda f, t: f(stage1, t, sub, torch.bfloat16), frames),
        (K7.emotion_stem_kernel, K7.emotion_stem,
         lambda f, t: f(emo.conv1, emo.bn1, t, torch.float32), faces),
        (K7.emotion_stem_kernel, K7.emotion_stem,
         lambda f, t: f(emo.conv1, emo.bn1, t, torch.bfloat16), faces),
        (K8.bottleneck_chain_kernel, K8.bottleneck_chain,
         lambda f, t: f(blocks, t), x),
    )
    before = kernels.launch_counts()
    for kernel, wrapper, call, t in calls:
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            call(kernel, t)
        with pytest.raises(ValueError, match="unsupported device"):
            call(wrapper, t.to("meta"))
        assert call(wrapper, t).device.type == "cpu"
    assert kernels.launch_counts() == before
    assert K6.mnet_stage1(stage1, frames, sub, torch.float32).shape == (
        1, 3, 5, 64)
    assert K3.nms_keep_mask(boxes, scores, valid, 0.5).tolist() == [
        [True, False]]
    assert K4.crop_area_pool(integ, boxes, 24).shape == (1, 2, 24, 24, 3)


def test_detectors_default_to_the_card():
    """MTCNN and RetinaFace run on the card unless the CPU is asked
    for: with no card visible, constructing either with no device
    raises instead of falling back."""
    from vn_celeb_face_recognition_tpu_torch.models.mtcnn import MTCNN
    from vn_celeb_face_recognition_tpu_torch.models.retinaface import (
        RetinaFace,
    )

    assert MTCNN(device="cpu").device == torch.device("cpu")
    assert RetinaFace(device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; the no-card contract is moot")
    for detector in (MTCNN, RetinaFace):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            detector()
