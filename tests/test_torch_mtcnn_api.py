"""The port's MTCNN host API (detect, inference, select_boxes, extract,
__call__, extract_face) against the JAX package's, on the CPU, and the
PIL-free image helpers it needs (PIL-exact bilinear resize, PNG writer).
Frames and boxes come from numpy seeds and the repo's face images."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image

from vn_celeb_face_recognition_tpu.models import mtcnn as JM
from vn_celeb_face_recognition_tpu_torch.models import mtcnn as TM
from vn_celeb_face_recognition_tpu_torch.utils import frames as F
from torch_shared import two_threads  # noqa: F401 (autouse)

CAPS = dict(min_face_size=50, pnet_cap_per_scale=128, cross_cap=256,
            rnet_cap=64, onet_cap=32, out_cap=8)


@pytest.fixture(scope="module")
def pair():
    frames = F.build_frames(2, 256, 4, face_px=100)
    frames[1, 128:] = 90  # two faces in the second frame
    jdet = JM.MTCNN(fused_pyramid_pnet=True, image_size=96, **CAPS)
    tdet = TM.MTCNN(device="cpu", image_size=96, **CAPS)
    return frames, jdet, tdet


def _configure(dets, **attrs):
    for d in dets:
        for k, v in attrs.items():
            setattr(d, k, v)


def _same_lists(got, want, rtol=1e-3, atol=1e-2):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("select_largest", [True, False])
def test_detect_matches_jax(pair, select_largest):
    """Per-image boxes, probabilities and landmarks in the same order, for
    a batch and for a single image; ``inference`` is detect with
    landmarks."""
    frames, jdet, tdet = pair
    _configure((jdet, tdet), select_largest=select_largest)
    want = jdet.detect(list(frames), landmarks=True)
    got = tdet.detect(list(frames), landmarks=True)
    assert [len(b) for b in got[0]] == [len(b) for b in want[0]] == [4, 2]
    for g, w, tol in zip(got, want, (1e-2, 1e-5, 1e-2)):
        _same_lists(g, w, atol=tol)
    one = tdet.detect(frames[1])
    assert len(one) == 2
    _same_lists(one[0], want[0][1])
    inf = tdet.inference(frames[1])
    _same_lists(inf[2], want[2][1])
    blank = tdet.detect(np.full((64, 64, 3), 90, np.uint8), landmarks=True)
    assert blank == ([], [], [])


def _boxes_for_selection():
    gen = np.random.default_rng(3)
    imgs = gen.integers(0, 256, (3, 90, 120, 3)).astype(np.uint8)
    boxes, probs, points = [], [], []
    for n in (5, 0, 3):
        xy = gen.uniform(0, 80, (n, 2))
        wh = gen.uniform(5, 40, (n, 2))
        boxes.append(np.concatenate([xy, xy + wh], 1).astype(np.float32)
                     if n else [])
        probs.append(gen.uniform(0.7, 1.0, n).astype(np.float32)
                     if n else [])
        points.append(gen.uniform(0, 100, (n, 5, 2)).astype(np.float32)
                      if n else [])
    probs[2][:] = [0.95, 0.5, 0.6]
    return imgs, boxes, probs, points


@pytest.mark.parametrize("method", ["largest", "probability",
                                    "center_weighted_size",
                                    "largest_over_threshold"])
def test_select_boxes_matches_jax(pair, method):
    """Each selection method picks the same face, batched (with an image
    without faces) and for a single image."""
    _, jdet, tdet = pair
    imgs, boxes, probs, points = _boxes_for_selection()
    want = jdet.select_boxes(boxes, probs, points, list(imgs), method=method)
    got = tdet.select_boxes(boxes, probs, points, list(imgs), method=method)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == object
        for gi, wi in zip(g, w):
            if wi is None or (isinstance(wi, list) and wi == [None]):
                assert gi is None or list(gi) == [None]
            else:
                np.testing.assert_array_equal(gi, wi)
    single = tdet.select_boxes(boxes[0], probs[0], points[0], imgs[0],
                               method=method)
    want1 = jdet.select_boxes(boxes[0], probs[0], points[0], imgs[0],
                              method=method)
    np.testing.assert_array_equal(single[0], want1[0])
    assert single[1] == want1[1]
    with pytest.raises(ValueError):
        tdet.select_boxes(boxes, probs, points, list(imgs), method="nope")


@pytest.mark.parametrize("keep_all", [False, True])
def test_extract_matches_jax(pair, tmp_path, keep_all):
    """The same boxes give the same faces (margin, PIL-exact bilinear
    resize, standardisation) and the same saved PNGs."""
    frames, jdet, tdet = pair
    _configure((jdet, tdet), keep_all=keep_all, margin=14,
               post_process=True)
    gen = np.random.default_rng(4)
    xy = gen.uniform(-10, 200, (2, 3, 2))
    boxes = np.concatenate([xy, xy + gen.uniform(20, 90, (2, 3, 2))],
                           -1).astype(np.float32)
    paths = [[str(tmp_path / f"{tag}{i}.png") for i in range(2)]
             for tag in ("j", "t")]
    want = jdet.extract(list(frames), list(boxes), paths[0])
    got = tdet.extract(list(frames), list(boxes), paths[1])
    single = tdet.extract(frames[0], boxes[0][:1])
    _configure((jdet, tdet), keep_all=False, margin=0)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == ((3, 96, 96, 3) if keep_all else (96, 96, 3))
    saved = sorted(p.name for p in tmp_path.iterdir())
    assert len(saved) == (12 if keep_all else 4)
    for name in saved:
        if name.startswith("t"):
            np.testing.assert_array_equal(
                F.read_png(str(tmp_path / name)),
                np.asarray(Image.open(tmp_path / ("j" + name[1:]))))
    np.testing.assert_array_equal(single, want[0][:1] if keep_all
                                  else want[0])


def test_call_matches_jax(pair):
    """__call__ (detect, select the largest face, extract) returns the same
    boxes and probabilities, and equal faces wherever the integer crop
    boxes agree."""
    frames, jdet, tdet = pair
    want = jdet(list(frames), return_prob=True)
    got = tdet(list(frames), return_prob=True)
    agree = 0
    for gf, wf, gb, wb in zip(got[0], want[0], got[1], want[1]):
        np.testing.assert_allclose(gb.astype(np.float32),
                                   wb.astype(np.float32), rtol=1e-3,
                                   atol=1e-2)
        assert gf.shape == wf.shape == (96, 96, 3)
        if np.array_equal(np.trunc(gb.astype(np.float64)),
                          np.trunc(wb.astype(np.float64))):
            np.testing.assert_array_equal(gf, wf)
            agree += 1
    assert agree >= 1
    _same_lists(got[2], want[2], atol=1e-5)
    faces, boxes = tdet(frames[0])
    assert faces.shape == (96, 96, 3) and boxes.shape == (1, 4)
    assert tdet(frames[0], extract_face_flag=False)[0] is None


def test_bilinear_resize_and_png_writer_equal_pil(tmp_path):
    """resize_bilinear is PIL's BILINEAR resize bit for bit, up and down;
    write_png files read back unchanged through PIL and read_png;
    extract_face equals the JAX package's (PIL) version."""
    gen = np.random.default_rng(5)
    for h, w, s in ((37, 53, 160), (120, 90, 96), (13, 200, 24), (1, 5, 7)):
        img = gen.integers(0, 256, (h, w, 3)).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize((s, s),
                                                      Image.BILINEAR))
        np.testing.assert_array_equal(F.resize_bilinear(img, (s, s)), want)
        path = str(tmp_path / f"{h}x{w}.png")
        F.write_png(path, img)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
        np.testing.assert_array_equal(F.read_png(path), img)
    img = gen.integers(0, 256, (80, 100, 3)).astype(np.uint8)
    box = np.array([10.7, -3.2, 70.1, 66.9], np.float32)
    np.testing.assert_array_equal(TM.extract_face(img, box, 64, 10),
                                  JM.extract_face(img, box, 64, 10))
