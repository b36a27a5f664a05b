"""K2's frames form emulated in numpy, on the CPU, against the plain
version and the JAX package.

``csrc/pyramid_pnet.cu`` reads every level pixel of the pyramid as four
corners of the chunk's int32 integral image: the windows of
``_area_weights`` in integer arithmetic, the corner difference in uint32,
one f32 division by the window's area. Its bf16 grid then rounds the
normalised pixel, conv1 + PReLU + pool and conv2 + PReLU to bf16 and runs
conv2 (K = 90 padded to 96) and conv3 (K = 144) as implicit GEMMs on
``mma.sync`` fragments: conv2's A registers gathered lane by lane from
the 10-channel pool map, conv3's loaded with ``ldmatrix`` from the conv2
map (a 48-byte pitch a position), B from the K-major rows of
``pack_weights_mma``. Here those index maps are followed lane by lane,
applied tile by tile in the kernel's frame-major order, and the result is
held to the plain version: at 1e-4 with the maps kept in f32, within
chip_smoke.py's bf16 bounds with them rounded as the kernel rounds them.
Uses the vendored MTCNN weights."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.models import mtcnn as JM
from vn_celeb_face_recognition_tpu.ops import image as JI
from vn_celeb_face_recognition_tpu.ops.pyramid_pnet_pallas import (
    pyramid_pnet as j_pyramid_pnet,
)
from vn_celeb_face_recognition_tpu_torch.models import mtcnn as TM
from vn_celeb_face_recognition_tpu_torch.ops import crop as K4
from vn_celeb_face_recognition_tpu_torch.ops import pyramid_pnet as K2
from vn_celeb_face_recognition_tpu_torch.ops.image import pyramid_planes
from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames
from torch_shared import two_threads  # noqa: F401 (autouse)

BF16_REL_L2, BF16_REL_MAX = 1e-2, 5e-2  # chip_smoke.py check_bf16
T, IN, POOL, C2 = 16, 42, 20, 18        # tile, input, pool, conv2 sides
C2P = 24                                # conv2 map pitch a position
ODD_EVEN = ((96, 129), (53, 71), (29, 39), (16, 21))


@pytest.fixture(scope="module")
def det():
    return TM.MTCNN(device="cpu")


def _frames():
    """Two 256x214 frames: pasted faces on a grey ground, with noise."""
    img = build_frames(2, 256, 4, face_px=100)[:, :, :214].astype(np.int16)
    img += np.random.default_rng(8).integers(-20, 21, img.shape,
                                             dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def frames():
    return _frames()


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def windows(n_out, n_in):
    """The kernel's windows [p0, p1) of output rows 0..n_out-1 of an
    n_in-row frame, in unsigned integer arithmetic."""
    o = np.arange(n_out, dtype=np.uint64)
    a = o * n_in // n_out
    e = ((o + 1) * n_in + n_out - 1) // n_out
    e = np.minimum(np.maximum(e, a + 1), n_in)
    return a.astype(np.int64), e.astype(np.int64)


def level_means(integ, oh, ow):
    """Level pixels [B, oh, ow, 3] f32 as the kernel reads them: four
    corners of the int32 integral image, their difference modulo 2**32,
    one f32 division by the window's area."""
    h, w = integ.shape[1] - 1, integ.shape[2] - 1
    (p0, p1), (q0, q1) = windows(oh, h), windows(ow, w)
    u = integ.view(np.uint32)
    s = (u[:, p1][:, :, q1] - u[:, p0][:, :, q1] - u[:, p1][:, :, q0]
         + u[:, p0][:, :, q0]).view(np.int32)
    area = ((p1 - p0)[:, None] * (q1 - q0)[None]).astype(np.float32)
    return s.astype(np.float32) / area[None, :, :, None]


@pytest.mark.parametrize("case", ["odd-even", "exact-ratios", "wraps"])
def test_level_pixels_from_integral_image(case):
    """Level pixels from the integral image equal the exact area resize:
    ``pyramid_planes`` and the JAX package's f32 ``pyramid_area_resize``
    within 1e-3 on the 0-255 scale (they round in f32 GEMMs; the kernel's
    one division is within 3e-5 of the exact mean), on odd and even level
    geometry and on a 3000x3000 frame whose prefix sums wrap."""
    gen = np.random.default_rng(len(case))
    if case == "wraps":
        img = gen.integers(250, 256, (1, 3000, 3000, 3), dtype=np.uint8)
        img[0, 100:700, 900:1500] = gen.integers(0, 256, (600, 600, 3))
        sizes = ((385, 385), (27, 19), (12, 12))
    else:
        shape = (2, 159, 214) if case == "odd-even" else (2, 160, 200)
        img = gen.integers(0, 256, shape + (3,), dtype=np.uint8)
        sizes = (ODD_EVEN if case == "odd-even"
                 else ((80, 100), (40, 50), (20, 25), (16, 40)))
    integ = K4.integral_image_plain(torch.from_numpy(img)).numpy()
    if case == "wraps":
        assert integ.min() < 0
    planes = pyramid_planes(torch.from_numpy(img).to(torch.float32), sizes)
    jlv = JI.pyramid_area_resize(jnp.asarray(img, jnp.float32), sizes)
    for (oh, ow), plane, jl in zip(sizes, planes, jlv):
        got = level_means(integ, oh, ow)
        (p0, p1), (q0, q1) = windows(oh, img.shape[1]), windows(ow,
                                                                img.shape[2])
        cs = np.pad(np.cumsum(np.cumsum(img.astype(np.int64), 1), 2),
                    ((0, 0), (1, 0), (1, 0), (0, 0)))
        exact = ((cs[:, p1][:, :, q1] - cs[:, p0][:, :, q1]
                  - cs[:, p1][:, :, q0] + cs[:, p0][:, :, q0])
                 / ((p1 - p0)[:, None] * (q1 - q0)[None])[None, :, :, None])
        assert np.abs(got - exact).max() <= 3e-5
        np.testing.assert_allclose(got, plane.permute(0, 2, 3, 1).numpy(),
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(got, np.asarray(jl), rtol=0, atol=1e-3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pyramid_pnet_matches_pallas(det, frames, dtype):
    """The port's K2 (its plain version on the CPU, uint8 frames in)
    against the TPU kernel in interpret mode. In f32 at rtol 1e-4, atol
    1e-5. In bf16 (the kernel's rounding points) within chip_smoke.py's
    bf16 bounds of the plain f32 maps, and no farther from them than the
    TPU kernel's own bf16 path, which also rounds the pyramid's GEMM
    operands and the heads' inputs."""
    jvars = JM.load_mtcnn_variables()
    imgs = torch.from_numpy(frames)
    want32 = K2.pyramid_pnet(det.pnet, imgs, ODD_EVEN)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jout = j_pyramid_pnet(jvars["pnet"], jnp.asarray(frames, jnp.float32),
                          ODD_EVEN, dtype=jdt, interpret=True)
    if dtype == "f32":
        for (gp, gr), (wp, wr) in zip(want32, jout):
            np.testing.assert_allclose(gp.numpy(), np.asarray(wp),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(gr.numpy(), np.asarray(wr),
                                       rtol=1e-4, atol=1e-5)
        return
    got = K2.pyramid_pnet(det.pnet, imgs, ODD_EVEN, dtype=torch.bfloat16)
    ref = _flat(want32)
    rel, rel_max = _within_bf16(_flat(got), ref)
    j_rel, j_max = _rel(_flat(jout), ref)
    assert rel <= j_rel and rel_max <= j_max, (rel, rel_max, j_rel, j_max)


def _flat(maps):
    return np.concatenate([np.asarray(t, np.float32).reshape(-1)
                           for pr in maps for t in pr])


def _rel(got, ref):
    """check_bf16's measures: relative L2 error, max error over max|ref|."""
    return (np.linalg.norm(got - ref) / np.linalg.norm(ref),
            np.abs(got - ref).max() / np.abs(ref).max())


def _within_bf16(got, ref):
    rel, rel_max = _rel(got, ref)
    assert rel <= BF16_REL_L2 and rel_max <= BF16_REL_MAX, (rel, rel_max)
    return rel, rel_max


# ---------------------------------------------------------------------------
# the bf16 grid's index maps, lane by lane
# ---------------------------------------------------------------------------


W1_LO = 16 * K2.MMA_K1P  # conv1's lo rows follow its hi rows
W2_AT = 2 * W1_LO        # then w2's rows, then w3's
W3_AT = W2_AT + 16 * K2.MMA_K2P
N_ROWS = W3_AT + 32 * K2.MMA_K3P


def _mma_rows(pnet):
    """The bf16 B-operand rows of ``pack_weights_mma`` as f32 values."""
    buf = K2.pack_weights_mma(pnet)
    return buf[:2 * N_ROWS].view(torch.bfloat16).to(torch.float32).numpy()


def ldsm_x4(addr):
    """ldmatrix.x4: lane l gives the row address of row l % 8 of matrix
    l // 8 -> [4, 8, 8] element offsets (matrix, row, column)."""
    out = np.zeros((4, 8, 8), np.int64)
    for lane in range(32):
        out[lane // 8, lane % 8] = addr(lane) + np.arange(8)
    return out


def conv2_koff(k):
    """Pool-map offset of column k = (ky*3 + kx)*10 + ci from a position's
    first channel; -1 in the padding (k >= 90)."""
    if k >= 90:
        return -1
    tap, ci = divmod(k, 10)
    return ((tap // 3) * POOL + tap % 3) * 10 + ci


def b_rows(n_tiles, steps, at, pitch, k0=0):
    """B operands [8 n_tiles, 16 steps] as the lanes' ldmatrix.x4 loads
    address them: lane l reads row 8(l >> 4) + (l & 7) of an n-tile pair,
    k offset 8((l >> 3) & 1); matrices 2j and 2j + 1 are n-tile j's k 0-7
    and 8-15."""
    out = np.zeros((8 * n_tiles, 16 * steps), np.int64)
    for pair in range(n_tiles // 2):
        for s in range(steps):
            m = ldsm_x4(lambda ln: at + (8 * (ln >> 4) + (ln & 7) + 16 * pair)
                        * pitch + 8 * ((ln >> 3) & 1) + k0 + s * 16)
            for j in range(2):
                n0 = 16 * pair + 8 * j
                out[n0:n0 + 8, s * 16:s * 16 + 16] = np.concatenate(
                    [m[2 * j], m[2 * j + 1]], axis=1)
    return out


def conv1_koff(k):
    """s_in offset of column k = (ky*3 + kx)*4 + ci from a position's
    first channel; -1 past the 9 taps."""
    tap = k // 4
    return ((tap // 3) * IN + tap % 3) * 4 + k % 4 if tap < 9 else -1


def mma_maps():
    """The bf16 grid's operand index maps, built lane by lane as the
    kernel's threads address them:
    a1 [50, 2, 16, 48] s_in offsets of conv1's A per (group, T) (-1: zero),
    b1 [16, 48] offsets of conv1's hi rows (lo rows at + W1_LO),
    a2 [21, 16, 96] pool-map offsets of conv2's A (-1: zero),
    b2 [16, 96] offsets of w2, a3 [16, 9, 16, 16] conv2-map offsets of
    conv3's A per (m-tile, tap), b3 [32, 144] offsets of w3."""
    a1 = np.full((50, 2, 16, 48), -2, np.int64)
    for g in range(50):
        for lane in range(32):
            gq, tq = lane // 4, lane % 4
            py, px = divmod(8 * g + gq, POOL)
            for s in range(3):
                for tt in range(2):
                    for q in range(4):  # row gq + 8(q & 1): sub-position
                        row, k = gq + 8 * (q & 1), s * 16 + 2 * tq + 8 * (q >> 1)
                        pos = (2 * py + tt) * IN + 2 * px + (q & 1)
                        off = conv1_koff(k)
                        for e in range(2):
                            a1[g, tt, row, k + e] = (pos * 4 + off + e
                                                     if off >= 0 else -1)
    a2 = np.full((21, 16, 96), -2, np.int64)
    for mt in range(21):
        for lane in range(32):
            gq, tq = lane // 4, lane % 4
            for s in range(6):
                for q in range(4):  # a[q]: row gq + 8(q & 1), k + 8(q >> 1)
                    row, k = gq + 8 * (q & 1), s * 16 + 2 * tq + 8 * (q >> 1)
                    m = min(mt * 16 + row, C2 * C2 - 1)
                    base = ((m // C2) * POOL + m % C2) * 10
                    off = conv2_koff(k)
                    for e in range(2):  # one 32-bit register: k, k + 1
                        a2[mt, row, k + e] = base + off + e if off >= 0 else -1
    a3 = np.zeros((16, 9, 16, 16), np.int64)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        for warp in range(8):
            for i in range(2):
                mt = 2 * warp + i
                m = ldsm_x4(lambda ln: ((mt + ky) * C2 + (ln & 7)
                                        + 8 * ((ln >> 3) & 1) + kx) * C2P
                            + 8 * (ln >> 4))
                # A: a[0] rows 0-7 k 0-7, a[1] rows 8-15, a[2] k 8-15, a[3]
                a3[mt, tap] = np.block([[m[0], m[2]], [m[1], m[3]]])
    assert (a1 != -2).all() and (a2 != -2).all()
    b1 = b_rows(2, 3, 0, K2.MMA_K1P)
    b2 = b_rows(2, 6, W2_AT, K2.MMA_K2P)
    b3 = b_rows(4, 9, W3_AT, K2.MMA_K3P)
    return a1, b1, a2, b2, a3, b3


@pytest.fixture(scope="module")
def maps():
    return mma_maps()


def test_mma_index_maps_are_im2col(det, maps):
    """Every operand element the lanes address is the one im2col names:
    conv1's A (each pool cell's four sub-positions + tap, channel; zero
    past the 9 taps), conv2's A (position (y, x) + tap, channel; zero for
    k >= 90 and the clamped last rows), conv3's A (one tap a k16 step)
    and the packed B rows, which hold the conv weights: conv1's as bf16
    hi + lo (within 2**-16 of f32), conv2's and conv3's rounded to bf16."""
    a1, b1, a2, b2, a3, b3 = maps
    for g in range(50):
        for r in range(16):
            py, px = divmod(8 * g + r % 8, POOL)
            for tt in range(2):
                y, x = 2 * py + tt, 2 * px + r // 8
                for k in range(48):
                    tap, ci = divmod(k, 4)
                    want = -1 if tap >= 9 else (
                        ((y + tap // 3) * IN + x + tap % 3) * 4 + ci)
                    assert a1[g, tt, r, k] == want
    for m in range(21 * 16):
        mm = min(m, C2 * C2 - 1)
        y, x = divmod(mm, C2)
        for k in range(96):
            want = -1 if k >= 90 else (
                ((y + k // 30) * POOL + x + (k // 10) % 3) * 10 + k % 10)
            assert a2[m // 16, m % 16, k] == want
    for mt in range(16):
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            for r in range(16):
                pos = (mt + ky) * C2 + r + kx
                assert list(a3[mt, tap, r]) == list(pos * C2P + np.arange(16))
    packed = _mma_rows(det.pnet)
    w1 = det.pnet.conv1.weight.detach().numpy()   # [10, 3, 3, 3]
    w2 = det.pnet.conv2.weight.detach().numpy()   # [16, 10, 3, 3]
    w3 = det.pnet.conv3.weight.detach().numpy()   # [32, 16, 3, 3]
    k1 = (packed[b1] + packed[b1 + W1_LO])[:10, :36].reshape(10, 9, 4)
    np.testing.assert_allclose(k1[:, :, :3], w1.transpose(0, 2, 3, 1).reshape(
        10, 9, 3), rtol=2 ** -16, atol=0)
    assert (k1[:, :, 3] == 0).all() and (packed[b1][10:] == 0).all()
    assert (packed[b1][:, 36:] == 0).all()
    k2 = w2.transpose(0, 2, 3, 1).reshape(16, 90)
    np.testing.assert_array_equal(packed[b2[:, :90]], _bf16(k2))
    assert (packed[b2[:, 90:]] == 0).all()
    np.testing.assert_array_equal(
        packed[b3], _bf16(w3.transpose(0, 2, 3, 1).reshape(32, 144)))
    small = K2.pack_weights_mma(det.pnet)[2 * N_ROWS:].view(torch.float32)
    assert torch.equal(small, K2.pack_weights(det.pnet)[:K2.N_CONST])


def emulate(pnet, frames, sizes, maps, rounded):
    """The bf16 grid, tile by tile in the frame-major order of
    ``level_table``, from the integral image: (probs [cells], reg [cells,
    4]). ``rounded`` rounds the staged pixels, the pool map and the conv2
    map to bf16 as the kernel does; without it they stay f32."""
    a1, b1, a2, b2, a3, b3 = maps
    rnd = _bf16 if rounded else (lambda v: np.asarray(v, np.float32))
    sd = {k: v.detach().numpy().astype(np.float64)
          for k, v in pnet.state_dict().items()}
    packed = _mma_rows(pnet).astype(np.float64)
    w1 = packed[b1] + packed[b1 + W1_LO]          # [16, 48], hi + lo
    w2, w3 = packed[b2], packed[b3]               # [16, 96], [32, 144]
    b, h, w = frames.shape[:3]
    integ = K4.integral_image_plain(torch.from_numpy(frames)).numpy()
    means = [level_means(integ, oh, ow) for oh, ow in sizes]
    table, n_tiles = K2.level_table(b, tuple(sizes))
    cells = sum(b * hc * wc for hc, wc in (K2.level_cells(*s) for s in sizes))
    probs = np.full(cells, np.nan)
    reg = np.full((cells, 4), np.nan)
    per_frame = n_tiles // b
    for t in range(n_tiles):
        fb, r = divmod(t, per_frame)
        lv = max(i for i in range(len(sizes)) if table[i][5] <= r)
        oh, ow, hc, wc, tiles_x, first, out_off, _ = (int(v) for v in
                                                      table[lv])
        cy0, cx0 = divmod(r - first, tiles_x)
        cy0, cx0 = cy0 * T, cx0 * T
        iy0, ix0 = 2 * cy0, 2 * cx0
        # staging: the normalised tile, zero outside the level
        x_in = np.zeros((IN, IN, 3), np.float32)
        ys, xs = slice(iy0, min(iy0 + IN, oh)), slice(ix0, min(ix0 + IN, ow))
        lvl = means[lv][fb, ys, xs]
        x_in[:lvl.shape[0], :lvl.shape[1]] = (
            (lvl - np.float32(127.5)) * np.float32(0.0078125))
        s_in = np.zeros((IN * IN, 4))             # [pos][4], channel 3 zero
        s_in[:, :3] = rnd(x_in).reshape(-1, 3)
        s_in = np.concatenate([s_in.reshape(-1), [0.0]])  # -1 reads zero
        # conv1 by the lanes' maps (group of 8 pool cells, T = row pair of
        # sub-positions), + bias, PReLU; the max over the sub-positions in
        # the conv1 map, 0 for a cell with none
        pool = np.zeros((POOL * POOL, 10))
        for g in range(50):
            sub = np.stack([s_in[a1[g, tt]] @ w1.T for tt in range(2)])
            sub = sub[:, :, :10] + sd["conv1.bias"]  # [T, 16 rows, 10]
            sub = np.where(sub >= 0, sub, sub * sd["prelu1.weight"])
            for r in range(8):
                py, px = divmod(8 * g + r, POOL)
                vals = [sub[tt, r + 8 * hh] for tt in range(2)
                        for hh in range(2)
                        if iy0 + 2 * py + tt < oh - 2
                        and ix0 + 2 * px + hh < ow - 2]
                if vals:
                    pool[8 * g + r] = np.max(vals, axis=0)
        pool_map = np.concatenate([rnd(pool).reshape(-1).astype(np.float64),
                                   [0.0]])        # index -1 reads the zero
        # conv2: A gathered by the lanes' maps, + bias, PReLU, to the map
        a = pool_map[a2.reshape(-1, 96)]          # [336, 96]
        c2 = a @ w2.T + sd["conv2.bias"]
        c2 = np.where(c2 >= 0, c2, c2 * sd["prelu2.weight"])[:C2 * C2]
        c2_map = np.zeros((C2 * C2, C2P))
        c2_map[:, :16] = rnd(c2)
        c2_map = c2_map.reshape(-1)
        # conv3: per output row (m-tile) and tap, ldmatrix rows
        c3 = np.zeros((T, T, 32))
        for mt in range(T):
            for tap in range(9):
                c3[mt] += c2_map[a3[mt, tap]] @ w3[:, tap * 16:tap * 16 + 16].T
        c3 = c3 + sd["conv3.bias"]
        c3 = np.where(c3 >= 0, c3, c3 * sd["prelu3.weight"])
        l1 = c3 @ sd["conv4_1.weight"].reshape(2, 32).T + sd["conv4_1.bias"]
        l2 = c3 @ sd["conv4_2.weight"].reshape(4, 32).T + sd["conv4_2.bias"]
        for y in range(T):
            for x in range(T):
                gy, gx = cy0 + y, cx0 + x
                if gy < hc and gx < wc:
                    cell = out_off + fb * hc * wc + gy * wc + gx
                    assert np.isnan(probs[cell])  # written once
                    probs[cell] = 1 / (1 + np.exp(l1[y, x, 0] - l1[y, x, 1]))
                    reg[cell] = l2[y, x]
    assert not np.isnan(probs).any()
    return probs, reg


def _plain_flat(pnet, frames, sizes, dtype=torch.float32):
    maps = K2.pyramid_pnet_plain(pnet, torch.from_numpy(frames), sizes,
                                 dtype)
    return (np.concatenate([p.reshape(-1).numpy() for p, _ in maps]),
            np.concatenate([r.reshape(-1, 4).numpy() for _, r in maps]))


def test_mma_emulation_with_f32_maps_equals_plain(det, frames, maps):
    """With the staged pixels and both maps kept in f32, the lane maps
    reproduce the plain PNet whose weights are the packed B operands
    (conv1's bf16 hi + lo, conv2's and conv3's rounded to bf16) at rtol
    1e-4, atol 1e-5: the index maps, the K padding, the pooling in
    registers and the tile order are exact; f64 sums against f32."""
    pnet = copy.deepcopy(det.pnet)
    with torch.no_grad():
        for conv in (pnet.conv2, pnet.conv3):
            conv.weight.copy_(conv.weight.to(torch.bfloat16))
        w1 = pnet.conv1.weight
        hi = w1.to(torch.bfloat16).to(torch.float32)
        w1.copy_(hi + (w1 - hi).to(torch.bfloat16).to(torch.float32))
    probs, reg = emulate(pnet, frames, ODD_EVEN, maps, rounded=False)
    want_p, want_r = _plain_flat(pnet, frames, ODD_EVEN)
    np.testing.assert_allclose(probs, want_p, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(reg, want_r, rtol=1e-4, atol=1e-5)


def test_mma_emulation_within_bf16_bounds(det, frames, maps):
    """Rounded as the kernel rounds, the bf16 grid stays within
    chip_smoke.py's bf16 bounds of the plain f32 maps and no farther from
    them than the TPU kernel's bf16 path (interpret mode); the plain bf16
    version, which rounds at the same points, lies within a quarter of the
    bound of it (they differ where an f32 sum order moves a value across a
    bf16 rounding boundary)."""
    probs, reg = emulate(det.pnet, frames, ODD_EVEN, maps, rounded=True)
    got = np.concatenate([probs, reg.reshape(-1)])
    want_p, want_r = _plain_flat(det.pnet, frames, ODD_EVEN)
    rel, rel_max = _within_bf16(got, np.concatenate([want_p,
                                                     want_r.reshape(-1)]))
    jout = j_pyramid_pnet(JM.load_mtcnn_variables()["pnet"],
                          jnp.asarray(frames, jnp.float32), ODD_EVEN,
                          dtype=jnp.bfloat16, interpret=True)
    jp = np.concatenate([np.asarray(p, np.float32).reshape(-1)
                         for p, _ in jout])
    jr = np.concatenate([np.asarray(r, np.float32).reshape(-1)
                         for _, r in jout])
    j_rel, j_max = _rel(np.concatenate([jp, jr]),
                        np.concatenate([want_p, want_r.reshape(-1)]))
    assert rel <= j_rel and rel_max <= j_max, (rel, rel_max, j_rel, j_max)
    p16, r16 = _plain_flat(det.pnet, frames, ODD_EVEN, torch.bfloat16)
    same_l2, same_max = _rel(got, np.concatenate([p16, r16.reshape(-1)]))
    assert same_l2 <= BF16_REL_L2 / 4 and same_max <= BF16_REL_MAX / 4


@pytest.mark.parametrize("batch,hw,min_face", [(3, (640, 640), 50),
                                               (2, (640, 640), 20),
                                               (2, (159, 214), 12)])
def test_frame_major_tiles_cover_every_cell_once(batch, hw, min_face):
    """The kernel's tile walk (frame = tile // tiles a frame, then the
    level whose first tile is the last not above it) visits the frames in
    order and covers every cell of every level of every frame exactly
    once."""
    scales = TM.MTCNN(min_face_size=min_face, device="cpu")._scales(*hw)
    sizes = tuple((int(hw[0] * s + 1), int(hw[1] * s + 1)) for s in scales)
    table, n_tiles = K2.level_table(batch, sizes)
    per_frame = n_tiles // batch
    cells = sum(batch * hc * wc for hc, wc in
                (K2.level_cells(*s) for s in sizes))
    seen = np.zeros(cells, np.int64)
    last_b = 0
    for t in range(n_tiles):
        fb, r = divmod(t, per_frame)
        assert fb >= last_b
        last_b = fb
        lv = 0
        while lv + 1 < len(sizes) and table[lv + 1][5] <= r:
            lv += 1
        _, _, hc, wc, tiles_x, first, out_off, _ = table[lv]
        cy0, cx0 = divmod(r - first, tiles_x)
        gy = cy0 * T + np.arange(T)[:, None]
        gx = cx0 * T + np.arange(T)[None]
        ok = (gy < hc) & (gx < wc)
        assert ok.any()
        np.add.at(seen, (out_off + fb * hc * wc + gy * wc + gx)[ok], 1)
    assert (seen == 1).all() and last_b == batch - 1


if __name__ == "__main__":
    # the bf16 error of each rounding design against plain f32 (check_bf16's
    # measures) on the test frames
    pnet = TM.MTCNN(device="cpu").pnet
    img = _frames()
    ref = np.concatenate([a.reshape(-1) for a in _plain_flat(pnet, img,
                                                             ODD_EVEN)])
    probs, reg = emulate(pnet, img, ODD_EVEN, mma_maps(), rounded=True)
    rows = {"bf16 grid (emulated)": np.concatenate([probs,
                                                     reg.reshape(-1)]),
            "plain bf16 (the grid's rounding points)": np.concatenate(
                [a.reshape(-1) for a in _plain_flat(pnet, img, ODD_EVEN,
                                                    torch.bfloat16)])}
    whole = []  # PNet run wholly in bf16 on the rounded normalised level
    with torch.no_grad():
        for lvl in pyramid_planes(torch.from_numpy(img).float(), ODD_EVEN):
            r, p = pnet(K2.normalize(lvl).to(torch.bfloat16))
            whole.append((p[:, 1].float(), r.permute(0, 2, 3, 1).float()))
    rows["PNet wholly in bf16"] = np.concatenate(
        [p.reshape(-1).numpy() for p, _ in whole]
        + [r.reshape(-1).numpy() for _, r in whole])
    jout = j_pyramid_pnet(JM.load_mtcnn_variables()["pnet"],
                          jnp.asarray(img, jnp.float32), ODD_EVEN,
                          dtype=jnp.bfloat16, interpret=True)
    rows["TPU kernel, dtype=bf16"] = np.concatenate(
        [np.asarray(p, np.float32).reshape(-1) for p, _ in jout]
        + [np.asarray(r, np.float32).reshape(-1) for _, r in jout])
    for name, got in rows.items():
        rel, rel_max = _rel(got, ref)
        print(f"{name}: rel L2 {rel:.2e}, max/max|ref| {rel_max:.2e}")
