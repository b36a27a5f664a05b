"""Limits of the port's MTCNN cascade kernels against the JAX package, on
the CPU: K4 (crop + area pool) on a frame whose int32 prefix sums
overflow, and K3's set cap at the detectors' constructors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.ops import boxes as JB
from vn_celeb_face_recognition_tpu.ops import image as JI
from vn_celeb_face_recognition_tpu_torch.models import mtcnn as TM
from vn_celeb_face_recognition_tpu_torch.models import retinaface as TR
from vn_celeb_face_recognition_tpu_torch.ops import crop as K4
from vn_celeb_face_recognition_tpu_torch.ops import nms as K3

# more pixels than the int32 sums of 255-valued pixels held exactly before
# the sums wrapped: 3000 x 3000 > 8,421,504, and 9 M x 250 > 2**31
BIG_H, BIG_W = 3000, 3000


@pytest.fixture(scope="module")
def big_frame():
    """One mostly white frame (pixels 250-255) and four boxes: the whole
    frame, a large one crossing the bottom-right corner, a band along the
    last rows, a small one near the far corner."""
    gen = np.random.default_rng(41)
    img = gen.integers(250, 256, (1, BIG_H, BIG_W, 3)).astype(np.uint8)
    img[0, 100:300, 200:500] = gen.integers(0, 256, (200, 300, 3))
    raw = np.array([[[1, 1, BIG_W, BIG_H],
                     [1200, 900, BIG_W + 40, BIG_H + 25],
                     [10, BIG_H - 60, BIG_W - 7, BIG_H],
                     [BIG_W - 90, BIG_H - 70, BIG_W - 3, BIG_H - 2]]],
                   np.float32)
    boxes = np.array(JB.clamp_boxes(jnp.asarray(raw), BIG_W, BIG_H))
    return img, boxes


@pytest.mark.parametrize("size", [24, 48])
def test_crop_big_frame_matches_jax_bit_exact(big_frame, size):
    """ops.crop.grouped_crop_area_resize takes a frame of more than
    8,421,504 pixels whose int32 prefix sums overflow, and equals the JAX
    package's (mask-GEMM) grouped_crop_area_resize bit for bit."""
    img, boxes = big_frame
    want = np.asarray(JI.grouped_crop_area_resize(
        jnp.asarray(img.astype(np.float32)), jnp.asarray(boxes), size))
    got = K4.grouped_crop_area_resize(torch.from_numpy(img),
                                      torch.from_numpy(boxes), size).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_wrapped_integral_image_pools_as_int64(big_frame):
    """The integral image wraps modulo 2**32 (as the kernel's uint32 band
    scan leaves it) and still pools to the cell sums of an int64
    integral image, on a frame whose int32 prefix sums overflow."""
    img, boxes = big_frame
    integ = K4.integral_image(torch.from_numpy(img)).numpy()
    # the kernel's values: uint32 prefix sums along x and y
    scan = np.cumsum(np.cumsum(img.astype(np.uint32), axis=2,
                               dtype=np.uint32), axis=1, dtype=np.uint32)
    np.testing.assert_array_equal(integ[:, 1:, 1:], scan.view(np.int32))
    assert (integ[:, 0] == 0).all() and (integ[:, :, 0] == 0).all()
    wide = np.zeros((1, BIG_H + 1, BIG_W + 1, 3), np.int64)
    wide[:, 1:, 1:] = np.cumsum(np.cumsum(img.astype(np.int64), 1), 2)
    assert wide.max() > 2 ** 31 - 1 and integ.min() < 0  # it did wrap
    for size in (24, 48):
        (y0, y1, x0, x1), (wy, wx) = K4.pool_tables(
            torch.from_numpy(boxes), size, BIG_H, BIG_W)
        ya, yb = y0.numpy()[:, :, None], y1.numpy()[:, :, None]
        xa, xb = x0.numpy()[:, None, :], x1.numpy()[:, None, :]
        im = wide[0]
        sums = im[yb, xb] - im[ya, xb] - im[yb, xa] + im[ya, xa]
        norm = np.maximum(wy.numpy()[:, :, None] * wx.numpy()[:, None, :],
                          np.float32(1.0))[..., None]
        want = (sums.astype(np.float32) / norm).reshape(1, 4, size, size, 3)
        got = K4.crop_area_pool(torch.from_numpy(integ),
                                torch.from_numpy(boxes), size).numpy()
        np.testing.assert_array_equal(got, want)


def test_nms_set_cap_check():
    """check_set_caps raises for the card above ops.nms.MAX_K and passes
    for the CPU (the plain version takes any K, as JAX does)."""
    K3.check_set_caps("cuda", cross_cap=K3.MAX_K, rnet_cap=None)
    with pytest.raises(ValueError, match="MAX_K"):
        K3.check_set_caps("cuda", cross_cap=K3.MAX_K + 1, rnet_cap=None)
    with pytest.raises(ValueError, match="nms_cap"):
        K3.check_set_caps("cuda", nms_cap=10000)
    K3.check_set_caps("cpu", cross_cap=K3.MAX_K + 1, nms_cap=10000)


def test_detectors_take_any_cap_on_the_cpu():
    """CPU construction keeps taking caps above MAX_K, as JAX does."""
    det = TM.MTCNN(device="cpu", pnet_cap_per_scale=K3.MAX_K + 64,
                   cross_cap=K3.MAX_K * 2)
    assert det.capacity_profile(640, 640)["cross_cap"] == K3.MAX_K * 2
    rdet = TR.RetinaFace(device="cpu", nms_cap=K3.MAX_K + 1,
                         topk_bf_nms=K3.MAX_K + 1)
    assert rdet.nms_cap == K3.MAX_K + 1
