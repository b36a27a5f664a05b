"""Parity of the PyTorch port's ops against the JAX package, on the CPU.

Inputs come from a numpy seed and go to both packages; comparisons are
in f32. Exact functions stay exact: NMS keep sets, top-k indices and the
integer crop + area pool.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.ops import boxes as JB
from vn_celeb_face_recognition_tpu.ops import image as JI
from vn_celeb_face_recognition_tpu.ops.similarity import (
    umeyama_similarity as j_umeyama,
)
from vn_celeb_face_recognition_tpu.ops.warp_pallas import (
    batched_similarity_warp_pallas,
)
from vn_celeb_face_recognition_tpu_torch.ops import boxes as TB
from vn_celeb_face_recognition_tpu_torch.ops import image as TI
from vn_celeb_face_recognition_tpu_torch.ops.similarity import (
    umeyama_similarity as t_umeyama,
)
from vn_celeb_face_recognition_tpu_torch.ops.warp import (
    similarity_warp,
    similarity_warp_plain,
)
from vn_celeb_face_recognition_tpu_torch.utils import kernels

from test_warp_fast import smooth_image
from test_warp_pallas import _mat
from torch_shared import two_threads  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _random_boxes(gen, shape, lo=0.0, hi=100.0):
    xy = gen.uniform(lo, hi, shape + (2,))
    wh = gen.uniform(2.0, 40.0, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("offset,min_mode", [(0.0, False), (1.0, False),
                                             (1.0, True)])
def test_pairwise_iou(offset, min_mode):
    gen = np.random.default_rng(0)
    a = _random_boxes(gen, (17,))
    b = _random_boxes(gen, (23,))
    want = np.asarray(JB.pairwise_iou(jnp.asarray(a), jnp.asarray(b),
                                      offset, min_mode))
    got = TB.pairwise_iou(_t(a), _t(b), offset, min_mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("offset,min_mode,thr", [(0.0, False, 0.5),
                                                 (0.0, False, 0.7),
                                                 (1.0, True, 0.7)])
def test_nms_keep_sets_equal(offset, min_mode, thr):
    """Keep sets are EQUAL, including score ties (index tie-break),
    padded rows and the +1 / Min variant of stage 3."""
    gen = np.random.default_rng(1)
    for trial in range(8):
        boxes = _random_boxes(gen, (3, 48))
        scores = gen.uniform(0, 1, (3, 48)).astype(np.float32)
        scores[:, :6] = scores[:, 6:12]  # exact ties
        scores[:, 20:24] = 1.0
        valid = gen.uniform(size=(3, 48)) < 0.8
        want = np.asarray(JB.batched_nms_keep_mask(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
            thr, offset, min_mode))
        got = TB.batched_nms_keep_mask(_t(boxes), _t(scores), _t(valid),
                                       thr, offset, min_mode).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        single = TB.nms_keep_mask(_t(boxes[0]), _t(scores[0]), _t(valid[0]),
                                  thr, offset, min_mode).numpy()
        np.testing.assert_array_equal(single, want[0])


def test_top_k_select_orders_ties_like_jax():
    gen = np.random.default_rng(2)
    vals = gen.integers(0, 5, (4, 40)).astype(np.float32)  # many ties
    mask = gen.uniform(size=(4, 40)) < 0.6
    for k in (7, 40, 64):
        got_i, got_v = TB.top_k_select(_t(vals), _t(mask), k)
        for r in range(4):
            want_i, want_v = JB.top_k_select(jnp.asarray(vals[r]),
                                             jnp.asarray(mask[r]), k)
            np.testing.assert_array_equal(got_i[r].numpy(),
                                          np.asarray(want_i))
            np.testing.assert_array_equal(got_v[r].numpy(),
                                          np.asarray(want_v))


def test_box_utilities():
    gen = np.random.default_rng(3)
    boxes = _random_boxes(gen, (5, 9), lo=-30.0, hi=250.0)
    reg = gen.normal(0, 0.2, (5, 9, 4)).astype(np.float32)
    np.testing.assert_allclose(
        TB.bbreg(_t(boxes), _t(reg)).numpy(),
        np.asarray(JB.bbreg(jnp.asarray(boxes), jnp.asarray(reg))),
        rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        TB.rerec(_t(boxes)).numpy(),
        np.asarray(JB.rerec(jnp.asarray(boxes))), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(
        TB.clamp_boxes(_t(boxes), 200, 180).numpy(),
        np.asarray(JB.clamp_boxes(jnp.asarray(boxes), 200, 180)))


def test_umeyama_similarity():
    gen = np.random.default_rng(4)
    dst = gen.uniform(30, 90, (5, 2)).astype(np.float32)
    src = gen.uniform(0, 224, (16, 5, 2)).astype(np.float32)
    got = t_umeyama(_t(src), _t(dst)).numpy()
    for i in range(16):
        want = np.asarray(j_umeyama(jnp.asarray(src[i]), jnp.asarray(dst)))
        np.testing.assert_allclose(got[i], want, atol=1e-5)


def test_area_resize_and_pyramid():
    gen = np.random.default_rng(5)
    imgs = gen.uniform(0, 255, (2, 61, 74, 3)).astype(np.float32)
    for out_hw in ((24, 24), (30, 41), (90, 100)):
        np.testing.assert_allclose(
            TI.area_resize(_t(imgs), out_hw).numpy(),
            np.asarray(JI.area_resize(jnp.asarray(imgs), out_hw)),
            atol=1e-4)
    sizes = [(44, 53), (31, 37), (22, 27), (15, 19)]
    got = TI.pyramid_area_resize(_t(imgs), sizes)
    want = JI.pyramid_area_resize(jnp.asarray(imgs), sizes)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("size", [24, 48])
def test_grouped_crop_area_resize_bit_exact(size):
    """Integer crops + adaptive average pool are bit-identical, for boxes
    inside, across and off the frame edge and for degenerate boxes."""
    gen = np.random.default_rng(6 + size)
    imgs = gen.integers(0, 256, (2, 90, 110, 3)).astype(np.float32)
    raw = _random_boxes(gen, (2, 12), lo=-40.0, hi=130.0)
    raw[:, 0] = [150.0, 160.0, 150.0, 170.0]  # right of the frame
    raw[:, 1] = [30.0, 30.0, 30.4, 30.9]      # one-pixel wide
    boxes = np.asarray(JB.clamp_boxes(jnp.asarray(raw), 110, 90))
    want = np.asarray(JI.grouped_crop_area_resize(
        jnp.asarray(imgs), jnp.asarray(boxes), size))
    got = TI.grouped_crop_area_resize(_t(imgs), _t(boxes), size).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_warp_affine_matches_jax():
    gen = np.random.default_rng(7)
    img = gen.uniform(0, 255, (60, 70, 3)).astype(np.float32)
    for deg, s, t in ((0.0, 1.0, (0.0, 0.0)), (17.0, 0.8, (5.0, -3.0)),
                      (-120.0, 1.3, (40.0, 10.0)), (200.0, 0.5, (-9, 30))):
        th = np.deg2rad(deg)
        m = np.array([[np.cos(th) * s, -np.sin(th) * s, t[0]],
                      [np.sin(th) * s, np.cos(th) * s, t[1]]], np.float32)
        want = np.asarray(JI.warp_affine(jnp.asarray(img), jnp.asarray(m),
                                         (48, 52)))
        got = TI.warp_affine(_t(img), _t(m), (48, 52)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(
        TI.invert_affine(_t(m)).numpy(),
        np.asarray(JI.invert_affine(jnp.asarray(m))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        TI.fixed_image_standardization(_t(img)).numpy(),
        np.asarray(JI.fixed_image_standardization(jnp.asarray(img))))


@pytest.mark.parametrize(
    "degs", [(0.0, 9.0, -17.0, 44.0), (61.0, 100.0, 178.0, -130.0),
             (45.0, -45.0, 135.0, -135.0)])
def test_similarity_warp_matches_pallas_warp(rng, degs):
    """The port's K1 (here its plain version) against the TPU kernel in
    interpret mode, within the bounds tests/test_warp_pallas.py pins for
    that kernel against the exact warp."""
    from scipy.ndimage import binary_erosion

    img = smooth_image(rng)
    ms = np.stack([_mat(d) for d in degs])
    windows = np.stack([img] * len(degs)).astype(np.float32)
    want = np.asarray(batched_similarity_warp_pallas(
        jnp.asarray(windows), jnp.asarray(ms), 112, interpret=True))
    before = kernels.launch_counts()
    got = similarity_warp(_t(windows), _t(ms), 112).numpy()
    # on CPU tensors the wrapper takes the plain version, no launch
    assert kernels.launch_counts() == before
    np.testing.assert_array_equal(
        got, similarity_warp_plain(_t(windows), _t(ms), 112).numpy())
    for i, d in enumerate(degs):
        interior = (want[i].sum(-1) > 1) & (got[i].sum(-1) > 1)
        interior = binary_erosion(interior, iterations=3)
        assert interior.mean() > 0.2, f"deg={d}: mostly off-window"
        diff = np.abs(want[i] - got[i])[interior]
        assert diff.mean() < 2.0, f"deg={d}: mean {diff.mean()}"
        assert np.percentile(diff, 99) < 14.0, f"deg={d}"
