"""K4's arithmetic emulated in numpy, on the CPU.

``csrc/crop_area_pool.cu`` builds the integral image in two launches:
band totals (the column sums of each band of ``ops.crop.BAND`` rows),
then one block per (frame, band) that takes the sum of the totals above
it as its carry-in, walks its rows keeping the column sums, and writes
each row's prefix along x in passes of 1024 pixels: four pixels a thread,
an inclusive scan of the thread totals across each warp, the warp totals
through shared memory and, from the second pass on, the row's running
total of the passes before. Its pool computes each cell's bounds from the
box in f32, one rounded operation at a time. Both are followed here step
by step in uint32 and float32 and held, bit for bit, to the plain
versions (``integral_image_plain``, ``pool_tables`` and
``crop_area_pool_plain``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vn_celeb_face_recognition_tpu_torch.ops import crop as K4

THREADS, PIX, WARP = 256, 4, 32
PASS = THREADS * PIX


def band_scan(img):
    """The kernel's two launches on uint8 frames [B, H, W, 3] -> the int32
    integral image [B, H+1, W+1, 3], modulo 2**32."""
    b, h, w, _ = img.shape
    r = K4.BAND
    bands = -(-h // r)
    nt = max(bands - 1, 1)
    v = img.astype(np.uint32)
    totals = np.stack([v[:, k * r:(k + 1) * r].sum(1, dtype=np.uint32)
                       for k in range(nt)], axis=1)      # [B, nt, W, 3]
    out = np.zeros((b, h + 1, w + 1, 3), np.uint32)
    for k in range(bands):
        y0, y1 = k * r, min((k + 1) * r, h)
        rows = y1 - y0
        carry = np.zeros((b, rows, 3), np.uint32)       # s_carry
        for p0 in range(0, w, PASS):
            n = min(PASS, w - p0)
            col = np.zeros((b, rows, PASS, 3), np.uint32)
            col[:, :, :n] = (totals[:, :k, p0:p0 + n].sum(1, dtype=np.uint32)
                             [:, None]
                             + np.cumsum(v[:, y0:y1, p0:p0 + n], axis=1,
                                         dtype=np.uint32))
            thr = col.reshape(b, rows, THREADS, PIX, 3)
            pre = np.cumsum(thr, axis=3, dtype=np.uint32)   # own 4 pixels
            tot = pre[:, :, :, -1]                          # [B, R, 256, 3]
            lanes = tot.reshape(b, rows, THREADS // WARP, WARP, 3)
            incl = np.cumsum(lanes, axis=3, dtype=np.uint32)
            excl_lane = (incl - lanes).reshape(b, rows, THREADS, 3)
            wt = incl[:, :, :, -1]                          # warp totals
            excl_warp = np.repeat(np.cumsum(wt, axis=2, dtype=np.uint32) - wt,
                                  WARP, axis=2)
            base = carry[:, :, None] + excl_lane + excl_warp
            vals = (base[:, :, :, None] + pre).reshape(b, rows, PASS, 3)
            out[:, y0 + 1:y1 + 1, p0 + 1:p0 + n + 1] = vals[:, :, :n]
            carry = base[:, :, -1] + pre[:, :, -1, -1]     # thread 255
    return out.view(np.int32)


@pytest.mark.parametrize("shape", [(2, 150, 1100), (1, 64, 64), (3, 1, 5),
                                   (1, 3000, 3000)],
                         ids=["bands-and-passes", "one-band", "one-row",
                              "wraps"])
def test_band_scan_equals_plain(shape):
    """Carries across bands (150 rows: three bands of 64), across passes
    (1100 px: two of 1024), one-band and one-row frames, and a 3000x3000
    frame of pixels 250-255 whose prefix sums wrap modulo 2**32."""
    b, h, w = shape
    gen = np.random.default_rng(h + w)
    lo = 250 if h * w > 8_421_504 else 0
    img = gen.integers(lo, 256, (b, h, w, 3), dtype=np.uint8)
    got = band_scan(img)
    want = K4.integral_image_plain(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)
    if lo:
        assert want.min() < 0  # it did wrap


def cell_bounds(lo, hi, size, n):
    """The kernel's cell_bounds in float32, one rounded operation at a
    time: lo/hi [N] -> [N, size] bounds i0, i1 (int32, clamped to
    [0, n]) and extents p1 - p0."""
    f = np.float32
    o = np.arange(size, dtype=f)[None]
    extent = (hi - lo)[:, None] + f(1)
    r0 = np.floor((o * extent) / f(size))
    r1 = np.ceil(((o + f(1)) * extent) / f(size))
    r1 = np.minimum(np.maximum(r1, r0 + f(1)), extent)
    base = lo[:, None] - f(1)
    p0, p1 = base + r0, base + r1
    i0 = np.minimum(np.maximum(p0, f(0)), f(n)).astype(np.int32)
    i1 = np.maximum(np.minimum(np.maximum(p1, f(0)), f(n)).astype(np.int32),
                    i0)
    assert p0.dtype == p1.dtype == np.float32
    return i0, i1, p1 - p0


def _boxes(kind, h, w, k):
    gen = np.random.default_rng(17 + k)
    if kind == "random":  # any floats, not only the cascade's integers
        xy = gen.uniform(-30, max(h, w) + 10, (2, k, 2))
        side = gen.uniform(0.3, 90, (2, k, 2))
        return np.concatenate([xy, xy + side], -1).astype(np.float32)
    return np.array([[[1, 1, w, h],                 # full frame
                      [-40, h - 20, 30, h + 70],    # partly off-frame
                      [30, 30, 20, 25],             # inverted
                      [w + 5, 10, w + 90, 80],      # right of the frame
                      [3, 2, 39, 38],               # 37 px: not divisible
                      [7, 9, 7, 9]]],               # one pixel
                    np.float32).repeat(2, 0)


@pytest.mark.parametrize("kind,size", [("random", 24), ("random", 48),
                                       ("edges", 24), ("edges", 48)])
def test_pool_bounds_and_cells_equal_plain(kind, size):
    """The in-kernel bounds equal ``pool_tables`` bit for bit, and one
    thread per cell (four corners of 12 bytes, the uint32 difference, one
    f32 division by max(wy * wx, 1)) equals the plain pool."""
    h, w = 41, 57
    img = np.random.default_rng(5).integers(0, 256, (2, h, w, 3),
                                            dtype=np.uint8)
    boxes = _boxes(kind, h, w, 11)
    flat = boxes.reshape(-1, 4)
    y0, y1, wy = cell_bounds(flat[:, 1], flat[:, 3], size, h)
    x0, x1, wx = cell_bounds(flat[:, 0], flat[:, 2], size, w)
    (ty0, ty1, tx0, tx1), (twy, twx) = K4.pool_tables(
        torch.from_numpy(boxes), size, h, w)
    for got, want in ((y0, ty0), (y1, ty1), (x0, tx0), (x1, tx1)):
        np.testing.assert_array_equal(got, want.numpy())
    for got, want in ((wy, twy), (wx, twx)):
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.numpy().view(np.int32))
    integ = band_scan(img).view(np.uint32)
    k = boxes.shape[1]
    bi = np.repeat(np.arange(2), k)[:, None, None]
    ya, yb = y0[:, :, None], y1[:, :, None]
    xa, xb = x0[:, None, :], x1[:, None, :]
    sums = (integ[bi, yb, xb] - integ[bi, ya, xb] - integ[bi, yb, xa]
            + integ[bi, ya, xa]).view(np.int32)
    norm = np.maximum(wy[:, :, None] * wx[:, None, :], np.float32(1))
    cells = sums.astype(np.float32) / norm[..., None]
    want = K4.crop_area_pool_plain(torch.from_numpy(band_scan(img)),
                                   torch.from_numpy(boxes), size).numpy()
    np.testing.assert_array_equal(cells.reshape(want.shape), want)
