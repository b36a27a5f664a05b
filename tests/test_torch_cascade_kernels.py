"""The port's MTCNN cascade kernels K3 (NMS keep mask), K4 (crop + area
pool) and K5 (R/ONet trunks) against the JAX package, on the CPU: the
plain versions against the TPU kernels in interpret mode and the XLA
functions, and numpy emulations of what each CUDA kernel computes from
its host-side tables and packed weights. Inputs come from numpy seeds."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.models import mtcnn as JM
from vn_celeb_face_recognition_tpu.ops import boxes as JB
from vn_celeb_face_recognition_tpu.ops import crop_pallas
from vn_celeb_face_recognition_tpu.ops import crops_net_pallas as JCN
from vn_celeb_face_recognition_tpu.ops.nms_pallas import nms_keep_mask_pallas
from vn_celeb_face_recognition_tpu_torch.models import mtcnn as TM
from vn_celeb_face_recognition_tpu_torch.ops import crop as K4
from vn_celeb_face_recognition_tpu_torch.ops import crops_net as K5
from vn_celeb_face_recognition_tpu_torch.ops import nms as K3
from vn_celeb_face_recognition_tpu_torch.utils import kernels
from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames
from torch_shared import two_threads  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _boxes(gen, shape, lo=0.0, hi=100.0, wmax=40.0):
    xy = gen.uniform(lo, hi, shape + (2,))
    wh = gen.uniform(2.0, wmax, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# K3: NMS keep mask
# ---------------------------------------------------------------------------


def _nms_sets(seed, n=4, k=45):
    """Sets with exact score ties, a block of equal top scores, an
    all-invalid set and K not a multiple of 8."""
    gen = np.random.default_rng(seed)
    boxes = _boxes(gen, (n, k))
    scores = gen.uniform(0, 1, (n, k)).astype(np.float32)
    scores[:, :6] = scores[:, 6:12]
    scores[:, 20:24] = 1.0
    valid = gen.uniform(size=(n, k)) < 0.8
    valid[1] = False
    return boxes, scores, valid


def _special_coords(gen, boxes):
    """``boxes`` [n, k, 4] with about one box in six given a NaN, +inf or
    -inf coordinate (x1, y1, x2 or y2 at random, so on either box of a
    pair), in every set two boxes of infinite area (x from -inf to +inf:
    their denominator is inf + inf - inf) and one decode that overflowed
    (x1 = -inf, x2 = NaN, as RetinaFace's decode gives when exp
    overflows)."""
    boxes = boxes.copy()
    n, k = boxes.shape[:2]
    special = np.float32([np.nan, np.inf, -np.inf])
    s, r = np.nonzero(gen.uniform(size=(n, k)) < 1 / 6)
    boxes[s, r, gen.integers(0, 4, len(s))] = special[
        gen.integers(0, 3, len(s))]
    boxes[:, 0, [0, 2]] = [-np.inf, np.inf]
    boxes[:, 1, [0, 2]] = [-np.inf, np.inf]
    boxes[:, 2, [0, 2]] = [-np.inf, np.nan]
    return boxes


@pytest.mark.parametrize("offset,min_mode,thr", [(0.0, False, 0.5),
                                                 (1.0, False, 0.4),
                                                 (1.0, True, 0.7)])
def test_nms_keep_mask_matches_pallas_and_xla(offset, min_mode, thr):
    """Equal keep sets against the TPU kernel (interpret mode) and the XLA
    function, for the three (offset, min_mode) cases of the cascade and
    RetinaFace, with NaN and +-inf coordinates in the last sets; the CPU
    wrapper counts no launch."""
    for seed in range(4):
        boxes, scores, valid = _nms_sets(seed)
        if seed == 3:
            boxes = _special_coords(np.random.default_rng(seed), boxes)
        args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                thr, offset, min_mode)
        want = np.asarray(nms_keep_mask_pallas(*args, interpret=True))
        np.testing.assert_array_equal(
            want, np.asarray(JB.batched_nms_keep_mask(*args)))
        before = kernels.launch_counts()
        got = K3.nms_keep_mask(_t(boxes), _t(scores), _t(valid), thr, offset,
                               min_mode).numpy()
        assert kernels.launch_counts() == before
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
        assert not got[1].any()


def _iou_gt(a, b, off, min_mode, thr):
    """The kernel's IoU test in f32, operation by operation, with np.fmin
    and np.fmax where it uses fminf and fmaxf (which drop a NaN) and its
    NaN check ahead of the division. On every call it is held to the plain
    IoU, whose maximum, minimum and clamp pass a NaN on (as torch's and
    JAX's do), and its two screens to the IEEE division: an empty
    intersection decides without it, and so does any quotient within
    2^-22 (2 ulp) of the exact one that lies outside thr (1 +- 2^-20)."""
    f = np.float32
    a, b = np.asarray(a, f), np.asarray(b, f)
    off, thr = f(off), f(thr)
    with np.errstate(invalid="ignore", over="ignore"):
        area_a = (f(a[2] - a[0]) + off) * (f(a[3] - a[1]) + off)
        area_b = (f(b[2] - b[0]) + off) * (f(b[3] - b[1]) + off)
        # the plain version: NaN passes through maximum, minimum and clamp
        wh = np.maximum(np.minimum(a[2:], b[2:]) - np.maximum(a[:2], b[:2])
                        + off, f(0))
        p_inter = f(wh[0] * wh[1])
        p_denom = (np.minimum(area_a, area_b) if min_mode
                   else f(f(area_a + area_b) - p_inter))
        plain = f(p_inter / np.maximum(p_denom, f(1e-12))) > thr
        # the kernel
        wr = f(f(np.fmin(a[2], b[2]) - np.fmax(a[0], b[0])) + off)
        hr = f(f(np.fmin(a[3], b[3]) - np.fmax(a[1], b[1])) + off)
        inter = f(np.fmax(wr, f(0)) * np.fmax(hr, f(0)))
        dr = (np.fmin(area_a, area_b) if min_mode
              else f(f(area_a + area_b) - inter))
        if np.isnan([area_a, area_b, wr, hr, inter, dr]).any():
            assert not plain
            return False
        denom = np.fmax(dr, f(1e-12))
        exact = f(inter / denom) > thr
    assert exact == plain
    if inter == 0:
        assert exact == (f(0) > thr)
    elif 2.0 ** -100 <= thr <= 2.0 ** 100 and denom < 2.0 ** 100:
        lo, hi = f(thr * f(1 - 2.0 ** -20)), f(thr * f(1 + 2.0 ** -20))
        q = float(inter) / float(denom)
        for approx in (q * (1 - 2.0 ** -22), q * (1 + 2.0 ** -22)):
            assert not (approx > hi and not exact)
            assert not (approx < lo and exact)
    return exact


def _descending_bits(s):
    """The kernel's key bits of non-NaN f32 scores: descending as unsigned
    integers, -0.0 counted as +0.0."""
    u = np.where(s == 0, np.float32(0), s).astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, u, ~(u | 0x80000000)).astype(np.uint32)


def _bitonic_sort(key):
    """The kernel's sort, step by step: a bitonic network whose comparators
    all put the smaller key first, over the next power of two of nv =
    len(key); slots from nv on count as +inf and are never touched."""
    key, nv = key.copy(), len(key)
    span = 1
    while span < nv:
        span *= 2
    i = np.arange(span // 2)

    def order(lo, hi):
        lo, hi = lo[hi < nv], hi[hi < nv]
        a, b = key[lo], key[hi]
        swap = a > b
        key[lo[swap]], key[hi[swap]] = b[swap], a[swap]

    size = 2
    while size <= span:
        j = i & (size // 2 - 1)
        lo = (i - j) * 2 + j
        order(lo, lo + size - 1 - 2 * j)  # the mirror in each block
        stride = size // 4
        while stride:
            lo = 2 * i - (i & (stride - 1))
            order(lo, lo + stride)
            stride //= 2
        size *= 2
    return key


def _nms_emulated(boxes, scores, valid, thr, off, min_mode):
    """csrc/nms_keep.cu for one set, phase by phase. Returns (keep, whether
    the set was sorted)."""
    def hit(kept, r):
        return _iou_gt(sbox[kept], sbox[r], off, min_mode, thr)

    # 1. compact the valid, non-NaN rows in row order (the block prefix sum)
    rows = np.nonzero(valid & ~np.isnan(scores))[0]
    nv = len(rows)
    key = ((_descending_bits(scores[rows]).astype(np.uint64) << np.uint64(32))
           | rows.astype(np.uint64))
    # 2. the order check; the sort only when the score bits rise somewhere
    disorder = bool(np.any((key[:-1] >> np.uint64(32))
                           > (key[1:] >> np.uint64(32))))
    if disorder:
        key = _bitonic_sort(key)
        np.testing.assert_array_equal(key, np.sort(key))
    row = (key & np.uint64(0xFFFFFFFF)).astype(np.int64)
    sbox = boxes[row]
    sup = np.zeros(nv, bool)

    # 3. tiles of 32 ranks. Up front, each rank's mask of the earlier
    # ranks in its tile whose box would suppress its own
    mask = [{e for e in range(32 * (r // 32), r) if hit(e, r)}
            for r in range(nv)]

    # warp 0 settles a tile: the lowest live lane is kept and drops the
    # lanes whose mask holds it (the ballot loop)
    def resolve(u):
        alive = [r for r in range(32 * u, min(32 * u + 32, nv)) if not sup[r]]
        rem, kept = list(alive), []
        while rem:
            f = rem.pop(0)
            kept.append(f)
            rem = [r for r in rem if f not in mask[r]]
        for r in alive:
            sup[r] = r not in kept
        return kept

    # then the block tests every live later rank against the tile's kept
    # boxes, four at a time, up to the first group of four with a hit
    tiles = -(-nv // 32)
    kept = resolve(0) if tiles else []
    for u in range(tiles - 1):
        more = False
        for q in range(32 * (u + 1), nv):
            if sup[q]:
                continue
            for g in range(0, len(kept), 4):
                if any([hit(j, q) for j in kept[g:g + 4]]):
                    sup[q] = True
                    break
            more |= not sup[q] and q >= 32 * (u + 2)
        kept = resolve(u + 1)
        if not more:  # every rank after tile u + 1 suppressed
            break
    keep = valid.copy()  # rows out of the order: invalid, or kept (NaN)
    keep[row] = ~sup
    return keep, disorder


def _in_priority_order(scores, valid):
    """Each set's rows as a top-k hands them over: valid rows first by
    descending score (ties in row order), then the rest."""
    return np.argsort(-np.where(valid, scores, -np.inf), axis=-1,
                      kind="stable")


def _threshold_set(gen, k):
    """Pairs whose IoU is exactly the threshold (0.5 for off 0: boxes 2x1
    and 1x1 at one corner; 0.7 for off 1 in min mode: intersection 7 over
    the smaller area 10), copies nudged one ulp over and under, at integer
    offsets, in random order."""
    pairs = []
    for n in range(k // 2):
        x, y = 5.0 * (n % 8), 5.0 * (n // 8)
        if n % 2:
            a, b = [x, y, x + 2, y + 1], [x, y, x + 1, y + 1]
        else:
            a, b = [x, y, x + 9, y], [x + 3, y, x + 12, y]
        nudge = (n // 2) % 3  # exact, one ulp over, one ulp under
        if nudge:
            b[2] = np.nextafter(np.float32(b[2]), np.float32(
                np.inf if nudge == 1 else -np.inf))
        pairs += [a, b]
    boxes = np.asarray(pairs, np.float32)[gen.permutation(k)]
    return boxes


_NMS_CASES = ["ties", "nan", "dense", "signed_zero_inf", "in_order",
              "nv_edges", "threshold", "nan_inf_coords"]


def _nms_case(case):
    gen = np.random.default_rng(11 + _NMS_CASES.index(case))
    n, k = (6, 80) if case == "nv_edges" else (3, 70)
    hi = 30.0 if case in ("dense", "nv_edges", "signed_zero_inf",
                          "nan_inf_coords") else 100.0
    boxes = _boxes(gen, (n, k), hi=hi)
    scores = (gen.integers(0, 6, (n, k)) / 5).astype(np.float32)
    valid = gen.uniform(size=(n, k)) < 0.9
    if case == "nan":
        scores[:, ::9] = np.nan
    elif case == "signed_zero_inf":
        special = np.float32([-0.0, 0.0, np.inf, -np.inf, 0.25, -0.25,
                              np.nan])
        scores = special[gen.integers(0, len(special), (n, k))]
        # a set in row order whose zeros alternate in sign: ties
        scores[2] = np.sort(scores[2])[::-1]
        scores[2, np.isnan(scores[2])] = np.inf
        zero = np.nonzero(scores[2] == 0)[0]
        scores[2, zero[::2]] = -0.0
        valid[2] = True
    elif case == "nv_edges":
        valid[:] = False
        for s, nv in enumerate((0, 1, 31, 32, 33, 65)):
            valid[s, gen.permutation(k)[:nv]] = True
    elif case == "threshold":
        boxes = np.stack([_threshold_set(gen, k) for _ in range(n)])
    elif case == "nan_inf_coords":
        boxes = _special_coords(gen, boxes)
        valid[:, :3] = True
        scores = gen.permutation(n * k).reshape(n, k).astype(np.float32)
    if case in ("in_order", "nv_edges"):
        for s in range(0, n, 1 if case == "in_order" else 2):
            idx = _in_priority_order(scores[s], valid[s])
            boxes[s], scores[s], valid[s] = (boxes[s][idx], scores[s][idx],
                                             valid[s][idx])
    return boxes, scores, valid


@pytest.mark.parametrize("case", _NMS_CASES)
def test_nms_rank_and_greedy_scan_emulation(case):
    """The kernel's phases (compaction, the order check or the bitonic sort
    by key, the greedy scan in tiles of 32 with its tile masks, warp
    resolve and block apply, the IoU screens), emulated in numpy, give the plain fixpoint's keep set: with
    ties, NaN, -0.0/+0.0 and +-inf scores, dense clusters, sets in and out
    of priority order, nv in {0, 1, 31, 32, 33, 65}, and boxes at the IoU
    threshold, and with NaN and +-inf coordinates."""
    boxes, scores, valid = _nms_case(case)
    sorted_sets = []
    for off, mm, thr in ((0.0, False, 0.5), (1.0, True, 0.7),
                         (1.0, False, 0.4)):
        want = K3.nms_keep_mask_plain(_t(boxes), _t(scores), _t(valid), thr,
                                      off, mm).numpy()
        for s in range(len(scores)):
            got, sorted_set = _nms_emulated(boxes[s], scores[s], valid[s],
                                            thr, off, mm)
            np.testing.assert_array_equal(got, want[s], err_msg=f"set {s}")
            sorted_sets.append(sorted_set)
    if case == "in_order":
        assert not any(sorted_sets)  # the top-k's order needs no sort
    elif case in ("ties", "nan", "dense", "threshold"):
        assert all(sorted_sets)
    elif case == "signed_zero_inf":
        assert sorted_sets[2::3] == [False] * 3  # -0.0 ties +0.0
    if case == "nan_inf_coords":
        # a NaN coordinate on either box of an overlapping pair: neither
        # suppresses the other (the IoU is NaN, and NaN > thr is false)
        for pair in ([[np.nan, 0, 10, 10], [1, 1, 10, 10]],
                     [[0, 0, 10, 10], [1, 1, np.nan, 10]],
                     [[0, 0, 10, 10], [1, np.nan, 10, 10]],
                     [[0, 0, 10, 10], [1, 1, 10, np.nan]]):
            pb = np.float32([pair])
            args = (np.float32([[0.9, 0.8]]), np.ones((1, 2), bool))
            assert K3.nms_keep_mask_plain(_t(pb), *map(_t, args), 0.4,
                                          1.0).all()
            assert _nms_emulated(pb[0], args[0][0], args[1][0], 0.4, 1.0,
                                 False)[0].all()
        # an empty intersection over a NaN denominator (areas +inf and
        # -inf): the quotient is NaN, not > a negative thr; in min mode the
        # denominator is -inf, clamped, and 0 > thr holds
        pb = np.float32([[[-np.inf, 0, np.inf, 1], [np.inf, 5, -np.inf, 6]]])
        args = (np.float32([[0.9, 0.8]]), np.ones((1, 2), bool))
        for mm, want in ((False, [True, True]), (True, [True, False])):
            assert _iou_gt(pb[0, 0], pb[0, 1], 0.0, mm, -0.5) == (not want[1])
            np.testing.assert_array_equal(K3.nms_keep_mask_plain(
                _t(pb), *map(_t, args), -0.5, 0.0, mm)[0].numpy(), want)
            np.testing.assert_array_equal(_nms_emulated(
                pb[0], args[0][0], args[1][0], -0.5, 0.0, mm)[0], want)
    if case == "threshold":  # the exact-threshold pairs are all kept
        pair = K3.nms_keep_mask_plain(
            _t(np.float32([[[0, 0, 2, 1], [0, 0, 1, 1]]])),
            _t(np.float32([[1, 0]])), _t(np.ones((1, 2), bool)), 0.5)
        assert pair.all()
    # box, key (then row + area), tile mask, suppressed flag, plus the
    # tile buffers
    assert K3.MAX_K * (16 + 8 + 4 + 1) + 772 <= 232448


# ---------------------------------------------------------------------------
# K4: crop + area pool
# ---------------------------------------------------------------------------


def _crop_inputs(seed, b=2, h=67, w=93, k=13):
    gen = np.random.default_rng(seed)
    imgs = gen.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    raw = _boxes(gen, (b, k), lo=-40.0, hi=max(h, w) + 10.0, wmax=70.0)
    raw[:, 0] = [-5.0, -7.0, w + 2.0, h + 2.0]      # full frame and beyond
    raw[:, 1] = [w + 10.0, 4.0, w + 30.0, 20.0]     # right of the frame
    raw[:, 2] = [30.0, 30.0, 30.4, 30.9]            # one pixel
    raw[:, 3] = [50.0, 40.0, 20.0, 60.0]            # inverted
    boxes = np.asarray(JB.clamp_boxes(jnp.asarray(raw), w, h))
    return imgs, boxes


@pytest.mark.parametrize("size", [24, 48])
def test_crop_matches_pallas_bit_exact(size):
    """ops.crop.grouped_crop_area_resize equals the TPU kernel (interpret
    mode) and the XLA function bit for bit on odd-sized frames, with
    full-frame, off-frame, one-pixel and inverted boxes."""
    imgs, boxes = _crop_inputs(20 + size)
    jimgs = jnp.asarray(imgs.astype(np.float32))
    want = np.asarray(crop_pallas.grouped_crop_area_resize_pallas(
        jimgs, jnp.asarray(boxes), size, interpret=True))
    got = K4.grouped_crop_area_resize(_t(imgs), _t(boxes), size).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the shared-integral form the cascade uses, from uint8 frames
    integ = K4.integral_image(_t(imgs))
    np.testing.assert_array_equal(
        K4.crop_area_pool(integ, _t(boxes), size).numpy(), want)


def test_crop_kernel_tables_emulation():
    """The arithmetic of csrc/crop_area_pool.cu: an int32 integral image
    (prefix sums along x, then y), then per cell four corner reads at the
    bounds of ``pool_tables`` (which the kernel computes per cell) and one
    f32 division by wy * wx (at least 1)."""
    imgs, boxes = _crop_inputs(5, h=41, w=57, k=9)
    rows = np.cumsum(imgs.astype(np.int32), axis=2, dtype=np.int32)
    integ = np.zeros((2, 42, 58, 3), np.int32)
    integ[:, 1:, 1:] = np.cumsum(rows, axis=1, dtype=np.int32)
    np.testing.assert_array_equal(K4.integral_image_plain(_t(imgs)).numpy(),
                                  integ)
    for size in (24, 48):
        (y0, y1, x0, x1), (wy, wx) = K4.pool_tables(_t(boxes), size, 41, 57)
        y0, y1, x0, x1 = (t.numpy() for t in (y0, y1, x0, x1))
        wy, wx = wy.numpy(), wx.numpy()
        assert y0.dtype == np.int32 and wy.dtype == np.float32
        assert (y1 >= y0).all() and (x1 >= x0).all()
        assert y1.max() <= 41 and x1.max() <= 57 and y0.min() >= 0
        out = np.zeros((2 * 9, size, size, 3), np.float32)
        for bk in range(2 * 9):
            im = integ[bk // 9]
            for oy in range(size):
                ya, yb = y0[bk, oy], y1[bk, oy]
                xa, xb = x0[bk], x1[bk]
                s = (im[yb, xb] - im[ya, xb] - im[yb, xa] + im[ya, xa])
                norm = np.maximum(np.float32(wy[bk, oy]) * wx[bk], 1.0)
                out[bk, oy] = s.astype(np.float32) / norm.astype(
                    np.float32)[:, None]
        want = K4.crop_area_pool_plain(torch.from_numpy(integ), _t(boxes),
                                       size).numpy()
        np.testing.assert_array_equal(out.reshape(want.shape), want)


# ---------------------------------------------------------------------------
# K5: R/ONet trunks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mtcnn_pair():
    jvars = JM.load_mtcnn_variables()
    assert jvars is not None
    return jvars, TM.MTCNN(device="cpu")


_NETS = {"rnet": (K5.RNET_SPEC, JCN.RNET_SPEC, JCN.rnet_apply_fused),
         "onet": (K5.ONET_SPEC, JCN.ONET_SPEC, JCN.onet_apply_fused)}


def _norm_crops(seed, n, size):
    gen = np.random.default_rng(seed)
    return ((gen.integers(0, 256, (n, size, size, 3)) - 127.5)
            * 0.0078125).astype(np.float32)


@pytest.mark.parametrize("name", ["rnet", "onet"])
def test_crop_net_trunk_matches_pallas(mtcnn_pair, name):
    """The trunk (here its plain version) against the TPU kernel in f32,
    interpret mode, on the vendored weights, at 1e-4."""
    jvars, det = mtcnn_pair
    spec, jspec, _ = _NETS[name]
    crops = _norm_crops(30, 10, spec.size)
    want = np.asarray(JCN.crop_net_trunk(
        jvars[name]["params"], jnp.asarray(crops), jspec, dtype=jnp.float32,
        interpret=True))
    got = K5.crop_net_trunk(getattr(det, name), _t(crops), spec)
    assert tuple(got.shape) == (10, spec.out, spec.out, spec.c2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["rnet", "onet"])
def test_nets_match_fused_apply(mtcnn_pair, name):
    """RNet/ONet.forward (trunk through the K5 wrapper, then the tail)
    against the JAX package's fused apply in f32, at 1e-4."""
    jvars, det = mtcnn_pair
    spec, _, fused = _NETS[name]
    crops = _norm_crops(31, 9, spec.size)
    want = fused(jvars[name], jnp.asarray(crops), jnp.float32,
                 interpret=True)
    with torch.no_grad():
        got = getattr(det, name)(_t(crops).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def _band_rows(spec):
    """The kernel's conv1 bands: (first pooled row, end, conv rows r0..r1)."""
    h1, p = spec.conv1_out, spec.pooled
    out = []
    for py0 in range(0, p, spec.band):
        py1 = min(py0 + spec.band, p)
        out.append((py0, py1, 2 * py0, min(2 * (py1 - 1) + 2, h1 - 1)))
    return out


@pytest.mark.parametrize("name", ["rnet", "onet"])
def test_trunk_packed_weights_emulation(mtcnn_pair, name):
    """csrc/crop_net_trunk.cu emulated in numpy from the packed weights:
    conv1 band by band (each band's pool windows read only its conv rows),
    the ceil-mode pool clipped at the map's edge, then conv2. Matches the
    plain trunk at 1e-4; the bf16 kernel's packing holds
    bf16-representable values."""
    _, det = mtcnn_pair
    spec = _NETS[name][0]
    net = getattr(det, name)
    c1, c2, s = spec.c1, spec.c2, spec.size
    w = K5.pack_trunk_weights(net, spec).numpy().astype(np.float64)
    assert w.size == spec.n_weights()
    w1 = w[:27 * c1].reshape(3, 3, 3, c1)
    b1, a1 = w[27 * c1:28 * c1], w[28 * c1:29 * c1]
    o = 29 * c1
    w2 = w[o:o + 9 * c1 * c2].reshape(3, 3, c1, c2)
    b2, a2 = w[o + 9 * c1 * c2:o + 9 * c1 * c2 + c2], w[-c2:]

    def conv(x, k, b):  # valid 3x3, NHWC
        n = x.shape[1] - 2
        out = np.zeros((n, n, k.shape[-1])) + b
        for ky in range(3):
            for kx in range(3):
                out += x[ky:ky + n, kx:kx + n] @ k[ky, kx]
        return out

    def prelu(v, a):
        return np.where(v >= 0, v, v * a)

    x = _norm_crops(32, 2, s).astype(np.float64)
    got = []
    for crop in x:
        y1 = prelu(conv(crop, w1, b1), a1)
        pooled = np.zeros((spec.pooled, spec.pooled, c1))
        for py0, py1, r0, r1 in _band_rows(spec):
            assert r1 - r0 + 1 <= min(2 * spec.band + 1, spec.conv1_out)
            for py in range(py0, py1):
                for px in range(spec.pooled):
                    ys = range(2 * py, min(2 * py + 3, spec.conv1_out))
                    assert r0 <= ys[0] and ys[-1] <= r1
                    xs = slice(2 * px, min(2 * px + 3, spec.conv1_out))
                    pooled[py, px] = y1[ys.start:ys.stop, xs].max((0, 1))
        got.append(prelu(conv(pooled, w2, b2), a2))
    want = K5.crop_net_trunk_plain(net, _t(x.astype(np.float32)), spec)
    np.testing.assert_allclose(np.stack(got), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    w16 = K5.pack_trunk_weights_mma(net, spec)[-(32 + 2 * c2) * 4:].view(
        torch.float32)
    np.testing.assert_array_equal(
        w16.numpy(), w16.to(torch.bfloat16).to(torch.float32).numpy())


# ---------------------------------------------------------------------------
# The cascade
# ---------------------------------------------------------------------------


def test_cascade_matches_jax_with_tpu_kernels(monkeypatch):
    """The port's cascade (K2-K5 plain versions on the CPU) against the
    JAX cascade running its crop and trunk kernels (interpret mode) at
    min_face_size 20 on 2 small frames, with the tolerances of
    test_detect_padded_matches_jax_cascade."""
    monkeypatch.setattr(
        crop_pallas, "grouped_crop_area_resize_pallas",
        functools.partial(crop_pallas.grouped_crop_area_resize_pallas,
                          interpret=True))
    frames = build_frames(2, 160, 4, face_px=64)
    kw = dict(min_face_size=20, pnet_cap_per_scale=64, cross_cap=128,
              rnet_cap=32, onet_cap=16, out_cap=8)
    jdet = JM.MTCNN(fused_pyramid_pnet=True, pallas_crops=True,
                    fused_crop_nets=True, **kw)
    want = [np.asarray(a) for a in jdet._build_detect_fn(2, 160, 160)(
        jdet.variables, jnp.asarray(frames))]
    got = [a.numpy() for a in TM.MTCNN(device="cpu", **kw).detect_padded(
        torch.from_numpy(frames))]
    boxes, scores, points, valid, _ = got
    assert valid.sum() >= 4
    np.testing.assert_array_equal(valid, want[3])
    v = want[3]
    np.testing.assert_allclose(boxes[v], want[0][v], rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(points[v], want[2][v], atol=1e-3)
    np.testing.assert_allclose(scores[v], want[1][v], atol=1e-5)
