"""The port's FAN (``models/fan.py``: the network, the crop and decode
geometry, ``FANLandmarker``) against the JAX package's, on the CPU, on the
same weights: numpy-seeded torch-keyed weights carried into JAX variables by
the JAX converter and back by ``models.convert.state_dict_from_jax``. Each
test states its tolerance."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.models import fan as JF
from vn_celeb_face_recognition_tpu.models.torch_convert import (
    assert_tree_compatible,
    convert_state_dict,
)
from vn_celeb_face_recognition_tpu_torch import models as TMods
from vn_celeb_face_recognition_tpu_torch.models import fan as TF
from vn_celeb_face_recognition_tpu_torch.models.convert import (
    state_dict_from_jax,
)

from test_torch_encoder import load_pair, random_state_dict


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    test processes at once); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def _close_to_max(got, want, rel):
    """|got - want| <= rel * max|want| everywhere."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_planes,out_planes", [(8, 16), (16, 16)])
def test_conv_block_matches_jax(in_planes, out_planes):
    """ConvBlock at narrow widths, with and without the DownsampleSkip:
    f32 within 1e-5 of max|out|."""
    block, jvars = load_pair(TF.ConvBlock(in_planes, out_planes), seed=3)
    assert (block.downsample is None) == (in_planes == out_planes)
    x = np.random.default_rng(4).normal(size=(2, 12, 10, in_planes)).astype(
        np.float32)
    want = JF.ConvBlock(in_planes, out_planes).apply(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = block(torch.from_numpy(_nchw(x)))
    _close_to_max(got.numpy(), _nchw(want), 1e-5)


def test_downsample_skip_matches_jax():
    """The torch Sequential(BatchNorm2d, ReLU, Conv1x1) skip, keys 0 and 2:
    f32 within 1e-5 of max|out|."""
    skip, jvars = load_pair(TF.DownsampleSkip(8, 24), seed=5)
    assert set(skip.state_dict()) >= {"0.running_mean", "2.weight"}
    x = np.random.default_rng(6).normal(size=(3, 7, 9, 8)).astype(np.float32)
    want = JF.DownsampleSkip(24).apply(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = skip(torch.from_numpy(_nchw(x)))
    _close_to_max(got.numpy(), _nchw(want), 1e-5)


def test_hourglass_matches_jax():
    """A depth-2 hourglass of 16 channels (average pool down, nearest x2
    up): f32 within 1e-5 of max|out|."""
    hg, jvars = load_pair(TF.HourGlass(depth=2, features=16), seed=7)
    assert "b2_plus_1.conv1.weight" in hg.state_dict()
    assert "b1_2.bn1.running_var" in hg.state_dict()
    x = np.random.default_rng(8).normal(size=(2, 16, 12, 16)).astype(
        np.float32)
    want = JF.HourGlass(depth=2, features=16).apply(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = hg(torch.from_numpy(_nchw(x)))
    _close_to_max(got.numpy(), _nchw(want), 1e-5)


@pytest.fixture(scope="module")
def fan2():
    """A full-width 2-module FAN on numpy-seeded weights, as the port's
    module and as JAX variables."""
    return load_pair(TF.FAN(num_modules=2), seed=11)


def test_state_dict_from_jax_maps_fan_strictly(fan2):
    """The JAX FAN's variables (the released torch keys through the JAX
    converter) map onto the port's FAN with a strict load: every key,
    DownsampleSkip's 0/2 included, and the tree FAN.init builds."""
    net, jvars = fan2
    init = JF.FAN(num_modules=2).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 64, 64, 3)))
    assert_tree_compatible(jvars, init)
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jvars))
    keys = {k for k in net.state_dict() if not k.endswith(
        "num_batches_tracked")}
    assert set(sd) == keys
    for key in ("conv2.downsample.0.running_var", "conv2.downsample.2.weight",
                "conv4.downsample.2.weight", "m1.b2_plus_1.conv3.weight",
                "bl0.bias", "al0.weight", "l1.bias"):
        assert key in sd
    TF.FAN(num_modules=2).load_state_dict(sd, strict=True)


def test_fan_matches_jax(fan2):
    """FAN(num_modules=2) at full width on 2 inputs of 256 px: each
    module's heatmaps within 1e-4 of max|heatmap| of FAN.apply (two
    modules run the bl/al re-entry)."""
    net, jvars = fan2
    x = np.random.default_rng(12).uniform(0, 1, (2, 256, 256, 3)).astype(
        np.float32)
    want = JF.FAN(num_modules=2).apply(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(_nchw(x)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (2, 68, 64, 64)
        _close_to_max(g.numpy(), _nchw(w), 1e-4)


@pytest.mark.parametrize("case", ["with_num_batches_tracked",
                                  "without_num_batches_tracked",
                                  "missing_key", "unexpected_key"])
def test_npz_loads_strictly(tmp_path, case):
    """A torch-keyed .npz loads into FANLandmarker with or without
    BatchNorm's num_batches_tracked (the released 2DFAN4 predates it); any
    other missing or unexpected key raises."""
    net = TF.FAN(num_modules=1)
    sd = random_state_dict(net, seed=13)
    if case == "with_num_batches_tracked":
        sd.update({k: np.asarray(v.numpy()) for k, v in
                   net.state_dict().items()
                   if k.endswith("num_batches_tracked")})
    elif case == "missing_key":
        del sd["m0.b3_2.conv2.weight"]
    elif case == "unexpected_key":
        sd["m0.b3_9.conv2.weight"] = sd["m0.b3_2.conv2.weight"]
    path = tmp_path / "fan1.npz"
    np.savez(path, **sd)
    if case in ("missing_key", "unexpected_key"):
        with pytest.raises(RuntimeError, match="b3_"):
            TF.FANLandmarker(num_modules=1, weights_path=str(path),
                             device="cpu")
        return
    lm = TF.FANLandmarker(num_modules=1, weights_path=str(path), device="cpu")
    got = lm.net.state_dict()
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


# ---------------------------------------------------------------------------
# the geometry
# ---------------------------------------------------------------------------


def test_box_center_scale_matches_jax():
    boxes = np.random.default_rng(14).uniform(0, 300, (9, 4)).astype(
        np.float32)
    boxes[:, 2:] += boxes[:, :2]
    want_c, want_s = JF.box_center_scale(boxes)
    got_c, got_s = TF.box_center_scale(boxes)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-6)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)


# (image H, W; centre; scale): inside an odd-sized image, sticking out of
# it on every side, and wholly outside it
CROPS = {
    "inside": ((37, 53), (26.0, 18.5), 0.11),
    "outside_edges": ((41, 29), (3.3, 38.7), 0.31),
    "far_outside": ((23, 31), (-90.0, 140.0), 0.2),
}


@pytest.mark.parametrize("case", sorted(CROPS))
def test_crop_face_window_matches_jax(case):
    """The two-tap gather crop equals the JAX hat-matrix crop in f32
    within 1e-5, on a float image and on its uint8 copy (read as
    value / 255), at 64 and 256 px."""
    (h, w), center, scale = CROPS[case]
    img = np.random.default_rng(15).integers(0, 256, (h, w, 3)).astype(
        np.uint8)
    f = img.astype(np.float32) / 255.0
    for res in (64, 256):
        want = np.asarray(JF.crop_face_window(
            jnp.asarray(f), jnp.asarray(center), scale, res))
        for src in (torch.from_numpy(f), torch.from_numpy(img)):
            got = TF.crop_face_window(src[None], [center], [scale], res)[0]
            assert got.dtype == torch.float32 and got.shape == (res, res, 3)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if case == "far_outside":
        assert not want.any()


def _peaks(kind):
    """[2, 64, 64, 68] heatmaps of one kind (each landmark's map its own)."""
    gen = np.random.default_rng(16)
    if kind == "random":
        return gen.normal(size=(2, 64, 64, 68)).astype(np.float32)
    if kind == "flat":
        return np.full((2, 64, 64, 68), 0.25, np.float32)
    hm = gen.uniform(0, 0.5, (2, 64, 64, 68)).astype(np.float32)
    ys = gen.integers(0, 64, (2, 68))
    xs = gen.integers(0, 64, (2, 68))
    if kind == "border":  # peaks on every edge and corner
        ys[:, :17], xs[:, 17:34], ys[:, 34:51] = 0, 63, 63
        xs[:, 51:] = 0
        ys[:, :4], xs[:, :4] = 0, 0
    for n in range(2):
        for c in range(68):
            hm[n, ys[n, c], xs[n, c], c] = 2.0
            if kind == "ties":  # a second maximum, later in row order
                hm[n, min(ys[n, c] + 1, 63), xs[n, c], c] = 2.0
                hm[n, ys[n, c], min(xs[n, c] + 3, 63), c] = 2.0
    if kind == "ties":  # equal neighbours: sign(0) = 0
        hm[0, 10, 9, 5] = hm[0, 10, 11, 5] = 1.0
        hm[0, 10, 10, 5] = 3.0
    return hm


@pytest.mark.parametrize("kind", ["random", "border", "ties", "flat"])
def test_decode_heatmaps_matches_jax(kind):
    """decode_heatmaps on synthetic maps (random, peaks on the border,
    tied maxima and equal neighbours, flat maps) equals the JAX decode:
    the same first argmax and quarter-pixel shift, landmarks within 1e-4
    px."""
    hm = _peaks(kind)
    centers = np.array([[120.5, 80.25], [33.0, 47.0]], np.float32)
    scales = np.array([1.3, 0.45], np.float32)
    want = np.stack([np.asarray(JF.decode_heatmaps(
        jnp.asarray(hm[n]), jnp.asarray(centers[n]), scales[n]))
        for n in range(2)])
    got = TF.decode_heatmaps(torch.from_numpy(_nchw(hm)), centers, scales)
    assert got.shape == (2, 68, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_reduce_to_5_points_matches_jax():
    """The 68 -> 5 reduction and its sanity flag, on a sane layout (eyes
    above the nose above the mouth), on it upside down, and on random
    points."""
    gen = np.random.default_rng(17)
    sane = gen.uniform(0, 100, (68, 2)).astype(np.float32)
    sane[36:48, 1], sane[33, 1], sane[[48, 54], 1] = 30.0, 50.0, 70.0
    for pts in (sane, sane * [1, -1], gen.uniform(0, 100, (68, 2))):
        want, want_ok = JF.reduce_to_5_points(pts)
        got, ok = TF.reduce_to_5_points(pts)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
        assert ok is want_ok
    assert TF.reduce_to_5_points(sane)[1]
    assert not TF.reduce_to_5_points(sane * [1, -1])[1]


# ---------------------------------------------------------------------------
# the landmarker
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def landmarkers():
    """A 1-module FANLandmarker of each package on the same numpy-seeded
    weights, on the CPU."""
    sd = random_state_dict(TF.FAN(num_modules=1), seed=18)
    jvars = convert_state_dict(sd)
    port = TF.FANLandmarker(num_modules=1, device="cpu",
                            state_dict=state_dict_from_jax(
                                jax.tree_util.tree_map(np.asarray, jvars)))
    return port, JF.FANLandmarker(num_modules=1, variables=jvars)


def test_landmarks_for_boxes_matches_jax(landmarkers):
    """Three face crops of different sizes, each with its own box, in one
    zero-padded batch: landmarks within 1e-3 px of the JAX landmarker's
    (which pads the batch to its own buckets)."""
    port, jlm = landmarkers
    gen = np.random.default_rng(19)
    sizes = [(96, 80), (130, 151), (61, 70)]
    batch = np.zeros((3, 130, 151, 3), np.uint8)
    boxes = []
    for i, (h, w) in enumerate(sizes):
        batch[i, :h, :w] = gen.integers(0, 256, (h, w, 3))
        boxes.append([w * 0.1, h * 0.15, w * 0.9, h * 0.95])
    boxes = np.asarray(boxes, np.float32)
    want = jlm.landmarks_for_boxes(batch, boxes)
    got = port.landmarks_for_boxes(batch, boxes)
    assert got.shape == (3, 68, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    # each face alone, unpadded, gives its batch row
    for i, (h, w) in enumerate(sizes):
        one = port.landmarks_for_boxes(batch[i:i + 1, :h, :w], boxes[i:i + 1])
        np.testing.assert_allclose(one[0], got[i], rtol=0, atol=1e-3)


def test_get_landmarks_matches_jax(landmarkers):
    """get_landmarks on a whole image (its own box) and on a given box:
    [[68, 2]] within 1e-3 px of the JAX landmarker's."""
    port, jlm = landmarkers
    img = np.random.default_rng(20).integers(0, 256, (120, 100, 3)).astype(
        np.uint8)
    for box in (None, [10.0, 20.0, 90.0, 110.0]):
        want = jlm.get_landmarks(img, box)
        got = port.get_landmarks(img, box)
        assert isinstance(got, list) and len(got) == 1
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)


def test_bf16_landmarks_drift_within_one_cell(landmarkers):
    """The bf16 landmarker on the f32 one's weights: heatmaps within the
    bf16 rounding of the f32 ones, and landmarks within the JAX package's
    bf16 gate (median drift <= one heatmap cell, 90% within four)."""
    port, _ = landmarkers
    lm16 = TF.FANLandmarker(num_modules=1, dtype="bfloat16", device="cpu",
                            state_dict=port.net.state_dict())
    assert lm16.net.conv1.weight.dtype == torch.float32
    img = np.random.default_rng(21).integers(0, 256, (128, 128, 3)).astype(
        np.uint8)
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float() / 255.0
    x = torch.nn.functional.interpolate(x, size=(256, 256))
    with torch.no_grad():
        h32, h16 = port.net(x)[-1], lm16.net(x)[-1]
    assert h16.dtype == torch.float32
    rel = float(torch.linalg.vector_norm(h16 - h32)
                / torch.linalg.vector_norm(h32))
    assert rel < 5e-2, rel
    p32 = port.get_landmarks(img)[0]
    p16 = lm16.get_landmarks(img)[0]
    cell = 128 / 64  # one heatmap cell of a 128 px face window
    d = np.linalg.norm(p32 - p16, axis=-1)
    assert np.median(d) <= cell + 1e-3
    assert (d <= 4 * cell).mean() >= 0.9


def test_missing_weights_warn_and_seed(capsys):
    """A weights path that does not exist prints the JAX package's warning
    and seeds the net (the same weights every time); no path seeds
    silently; the landmarker asks for the card by default."""
    a = TF.FANLandmarker(num_modules=1, weights_path="no/such/fan.npz",
                         device="cpu")
    out = capsys.readouterr().out
    assert "Warning: FAN weights 'no/such/fan.npz' not found" in out
    b = TF.build_fan(num_modules=1, device="cpu")
    assert capsys.readouterr().out == ""
    for k, v in a.net.state_dict().items():
        assert torch.equal(v, b.net.state_dict()[k]), k
    assert float(a.net.l0.weight.detach().abs().max()) > 0
    assert TMods.FANLandmarker is TF.FANLandmarker and TMods.FAN is TF.FAN
    assert TMods.build_fan is TF.build_fan
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TF.FANLandmarker(num_modules=1)
