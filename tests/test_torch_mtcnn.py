"""Parity of the port's MTCNN against the JAX package on the vendored
published weights, on the CPU (the port's K2 wrapper takes its plain
version here; the JAX kernel runs in interpret mode)."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.models import mtcnn as JM
from vn_celeb_face_recognition_tpu.ops.pyramid_pnet_pallas import (
    pyramid_pnet as j_pyramid_pnet,
)
from vn_celeb_face_recognition_tpu_torch.models import mtcnn as TM
from vn_celeb_face_recognition_tpu_torch.ops.pyramid_pnet import (
    level_cells,
    level_table,
    pack_weights,
    pnet_chain_plain,
    pyramid_pnet as t_pyramid_pnet,
)
from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames
from torch_shared import two_threads  # noqa: F401 (autouse)

CAPS = dict(pnet_cap_per_scale=128, cross_cap=256,
            rnet_cap=64, onet_cap=32, out_cap=8)


@pytest.fixture(scope="module")
def nets():
    jvars = JM.load_mtcnn_variables()
    assert jvars is not None
    det = TM.MTCNN(min_face_size=50, device="cpu", **CAPS)
    return jvars, det


def _nchw(x):
    return torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy())


@pytest.mark.parametrize("name,side", [("pnet", 31), ("rnet", 24),
                                       ("onet", 48)])
def test_nets_match_flax(nets, name, side):
    jvars, det = nets
    flax_net = {"pnet": JM.PNet, "rnet": JM.RNet, "onet": JM.ONet}[name]()
    x = np.random.default_rng(0).uniform(-1, 1, (3, side, side, 3)).astype(
        np.float32)
    want = flax_net.apply(jvars[name], jnp.asarray(x))
    with torch.no_grad():
        got = getattr(det, name)(_nchw(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        if g.dim() == 4:  # PNet maps are NCHW in the port
            g = g.permute(0, 2, 3, 1)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)


def test_stage1_matches_pallas_pyramid_pnet(nets):
    """K2's plain version against the TPU kernel (f32, interpret mode)
    on the odd/even level geometry of tests/test_pyramid_pnet.py."""
    jvars, det = nets
    sizes = [(96, 129), (53, 71), (29, 39), (16, 21)]
    imgs = np.random.default_rng(3).uniform(0, 255, (2, 159, 214, 3)).astype(
        np.float32)
    want = j_pyramid_pnet(jvars["pnet"], jnp.asarray(imgs), sizes,
                          dtype=jnp.float32, interpret=True)
    got = t_pyramid_pnet(det.pnet, torch.from_numpy(imgs), sizes)
    for (gp, gr), (wp, wr) in zip(got, want):
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gr.numpy(), np.asarray(wr),
                                   rtol=1e-4, atol=1e-5)


def test_level_table_covers_every_cell():
    """The kernel's tile table, frame-major: tiles of 16x16 cells are
    numbered level after level within a frame, frame after frame, and
    output offsets are the prefix sums of the [B, hc, wc] level blocks."""
    sizes = ((154, 154), (109, 109), (55, 39), (14, 14))
    table, n_tiles = level_table(3, sizes)
    tiles = out_off = 0
    for row, (oh, ow) in zip(table, sizes):
        hc, wc = level_cells(oh, ow)
        assert list(row[:4]) == [oh, ow, hc, wc]
        assert row[5] == tiles and row[6] == out_off and row[7] == 0
        assert row[4] * 16 >= wc > (row[4] - 1) * 16
        tiles += row[4] * (-(-hc // 16))
        out_off += 3 * hc * wc
    assert n_tiles == 3 * tiles
    assert level_cells(154, 154) == (72, 72)
    assert not table.flags.writeable and level_table(3, sizes)[0] is table


def test_packed_weights_follow_kernel_layout(nets):
    """csrc/pyramid_pnet.cu reads the packed weights by fixed offsets:
    584 constant-memory floats (conv1 OIHW, biases, slopes, heads), then
    conv2 and conv3 as [in, kh, kw, out]. A numpy PNet that indexes the
    buffer the same way reproduces the plain version."""
    _, det = nets
    w = pack_weights(det.pnet).numpy().astype(np.float64)
    assert w.shape == (6632,)
    cw, sw = w[:584], w[584:]
    w1 = cw[0:270].reshape(10, 3, 3, 3)
    b1, a1, b2, a2 = cw[270:280], cw[280:290], cw[290:306], cw[306:322]
    b3, a3 = cw[322:354], cw[354:386]
    w41, b41 = cw[386:450].reshape(2, 32), cw[450:452]
    w42, b42 = cw[452:580].reshape(4, 32), cw[580:584]
    w2 = sw[:1440].reshape(10, 3, 3, 16).transpose(3, 0, 1, 2)
    w3 = sw[1440:].reshape(16, 3, 3, 32).transpose(3, 0, 1, 2)

    def conv(x, k, b):
        o, i, kh, kw = k.shape
        h, ww = x.shape[1] - kh + 1, x.shape[2] - kw + 1
        out = np.zeros((o, h, ww)) + b[:, None, None]
        for ci in range(i):
            for ky in range(kh):
                for kx in range(kw):
                    out += (k[:, ci, ky, kx][:, None, None]
                            * x[ci, ky:ky + h, kx:kx + ww])
        return out

    def prelu(v, a):
        return np.where(v >= 0, v, v * a[:, None, None])

    lvl = np.random.default_rng(5).uniform(0, 255, (1, 3, 45, 37)).astype(
        np.float32)
    y = prelu(conv((lvl[0] - 127.5) * 0.0078125, w1, b1), a1)
    hp, wp = -(-y.shape[1] // 2), -(-y.shape[2] // 2)
    padded = np.full((10, 2 * hp, 2 * wp), -np.inf)
    padded[:, :y.shape[1], :y.shape[2]] = y  # ceil pool: edge excluded
    y = padded.reshape(10, hp, 2, wp, 2).max(axis=(2, 4))
    y = prelu(conv(prelu(conv(y, w2, b2), a2), w3, b3), a3)
    logits = np.einsum("oc,chw->ohw", w41, y) + b41[:, None, None]
    reg = np.einsum("oc,chw->hwo", w42, y) + b42
    (probs_t, reg_t), = pnet_chain_plain(det.pnet, [torch.from_numpy(lvl)])
    assert probs_t.shape[1:] == level_cells(45, 37)
    np.testing.assert_allclose(probs_t[0].numpy(),
                               1 / (1 + np.exp(logits[0] - logits[1])),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(reg_t[0].numpy(), reg, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("min_face_size", [50, 20])
def test_detect_padded_matches_jax_cascade(min_face_size):
    frames = build_frames(2, 256, 4, face_px=100)
    kw = dict(min_face_size=min_face_size, **CAPS)
    jdet = JM.MTCNN(fused_pyramid_pnet=True, **kw)
    want = [np.asarray(a) for a in jdet._build_detect_fn(2, 256, 256)(
        jdet.variables, jnp.asarray(frames))]
    tdet = TM.MTCNN(device="cpu", **kw)
    got = [a.numpy() for a in tdet.detect_padded(torch.from_numpy(frames))]
    boxes, scores, points, valid, sat = got
    assert valid.sum() >= 6
    np.testing.assert_array_equal(valid, want[3])
    v = want[3]
    np.testing.assert_allclose(boxes[v], want[0][v], rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(points[v], want[2][v], atol=1e-3)
    np.testing.assert_allclose(scores[v], want[1][v], atol=1e-5)
    # pre-cap counts: the stage-1 and final counts are equal; between
    # them, per-scale NMS over near-tied saturated scores may keep a few
    # different boxes that later stages remove
    assert sat[0] == want[4][0] and sat[4] == want[4][4]
    np.testing.assert_allclose(sat, want[4], rtol=0.1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got_hit = tdet.warn_capacity_saturation(sat, hw=(256, 256))
        want_hit = jdet.warn_capacity_saturation(want[4], hw=(256, 256))
    assert [h[0] for h in got_hit] == [h[0] for h in want_hit]


def test_capacity_profile_and_scales_match_jax():
    for kw in (dict(min_face_size=50, **CAPS), dict(min_face_size=20)):
        jdet = JM.MTCNN(**kw)
        tdet = TM.MTCNN(device="cpu", **kw)
        for hw in ((640, 640), (1080, 1920), (256, 300)):
            assert tdet.capacity_profile(*hw) == jdet.capacity_profile(*hw)
            assert tdet._scales(*hw) == jdet._scales(*hw)
    sat = np.array([448, 10, 10, 10, 64], np.int32)
    with pytest.warns(RuntimeWarning, match="capacity saturated"):
        hit = TM.MTCNN(min_face_size=20,
                       device="cpu").warn_capacity_saturation(
            sat, hw=(640, 640))
    assert [h[0] for h in hit] == ["pnet_cap_per_scale", "out_cap"]
