"""K1's frames form and its staged footprint, on the CPU.

``similarity_warp_frames`` samples each face's window straight from the
frame chunk. Here its plain version is held to the windows form on the
same windows (exactly) and to the JAX engine's window cut + TPU warp
kernel in interpret mode; ``footprint_boxes``, the kernel's rule for the
source box each output tile stages in shared memory, is shown to cover
every valid tap. Inputs come from numpy seeds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.ops.warp_pallas import (
    batched_similarity_warp_pallas,
)
from vn_celeb_face_recognition_tpu_torch.ops import warp as K1
from vn_celeb_face_recognition_tpu_torch.ops.image import invert_affine
from vn_celeb_face_recognition_tpu_torch.utils import kernels

from test_warp_fast import smooth_image
from test_warp_pallas import _mat
from torch_shared import two_threads  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _mats(gen, k, lo=0.4, hi=1.2, win=224, out=112):
    """Similarity maps window -> face in all four quadrants, with the
    window centre landing near the face centre (as chip_smoke.py's K1
    inputs)."""
    th = gen.uniform(-np.pi, np.pi, k)
    sc = gen.uniform(lo, hi, k)
    lin = np.stack([np.stack([np.cos(th) * sc, -np.sin(th) * sc], -1),
                    np.stack([np.sin(th) * sc, np.cos(th) * sc], -1)], 1)
    c = (win - 1) / 2.0
    t = ((out - 1) / 2.0 + gen.uniform(-8, 8, (k, 2))
         - np.einsum("kij,j->ki", lin, np.array([c, c])))
    return np.concatenate([lin, t[:, :, None]], -1).astype(np.float32)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_frames_form_equals_windows_form(dtype):
    """The frames form's plain version is the windows form on the windows
    cut from the same frames, bit for bit; the CPU wrapper counts no
    launch."""
    gen = np.random.default_rng(40)
    b, h, w, k, win = 3, 250, 290, 9, 224
    frames = gen.integers(0, 256, (b, h, w, 3)).astype(dtype)
    idx = gen.integers(0, b, k)
    oy = gen.integers(0, h - win + 1, k)
    ox = gen.integers(0, w - win + 1, k)
    oy[0], ox[0] = h - win, w - win  # a window in the far corner
    mats = _mats(gen, k)
    windows = np.stack([frames[i, y:y + win, x:x + win]
                        for i, y, x in zip(idx, oy, ox)]).astype(np.float32)
    before = kernels.launch_counts()
    got = K1.similarity_warp_frames(_t(frames), _t(idx), _t(oy), _t(ox), win,
                                    _t(mats), 112)
    assert kernels.launch_counts() == before
    assert got.dtype == torch.float32 and got.shape == (k, 112, 112, 3)
    want = K1.similarity_warp_plain(_t(windows), _t(mats), 112)
    assert torch.equal(got, want)
    assert torch.equal(
        K1.cut_windows(_t(frames), _t(idx), _t(oy), _t(ox), win),
        _t(windows))


@pytest.mark.parametrize("degs", [(0.0, 17.0, -44.0, 100.0),
                                  (45.0, -135.0, 178.0, -61.0)])
def test_frames_form_matches_jax_engine_cut_and_pallas_warp(degs):
    """The frames form against the JAX engine's window cut
    (``pipeline/engine.py``: ``dynamic_slice`` per face) and the TPU warp
    kernel in interpret mode, within the bounds
    test_similarity_warp_matches_pallas_warp uses."""
    from scipy.ndimage import binary_erosion

    gen = np.random.default_rng(41)
    b, n, win = 2, 256, 224
    frames = np.stack([np.clip(np.round(smooth_image(gen, n)), 0, 255)
                       for _ in range(b)]).astype(np.uint8)
    k = len(degs)
    idx = np.arange(k) % b
    oy = gen.integers(0, n - win + 1, k)
    ox = gen.integers(0, n - win + 1, k)
    mats = np.stack([_mat(d) for d in degs])
    frames_f = jnp.asarray(frames, jnp.float32)
    windows = jax.vmap(lambda i, y, x: jax.lax.dynamic_slice(
        frames_f, (i, y, x, 0), (1, win, win, 3))[0])(
            jnp.asarray(idx, jnp.int32), jnp.asarray(oy, jnp.int32),
            jnp.asarray(ox, jnp.int32))
    want = np.asarray(batched_similarity_warp_pallas(
        windows, jnp.asarray(mats), 112, interpret=True))
    got = K1.similarity_warp_frames(_t(frames), _t(idx), _t(oy), _t(ox), win,
                                    _t(mats), 112).numpy()
    for i, d in enumerate(degs):
        interior = (want[i].sum(-1) > 1) & (got[i].sum(-1) > 1)
        interior = binary_erosion(interior, iterations=3)
        assert interior.mean() > 0.2, f"deg={d}: mostly off-window"
        diff = np.abs(want[i] - got[i])[interior]
        assert diff.mean() < 2.0, f"deg={d}: mean {diff.mean()}"
        assert np.percentile(diff, 99) < 14.0, f"deg={d}"


def _valid_taps(mats, out_size, win):
    """Each output pixel's four taps (y, x) and their validity, computed
    as ops/image.batched_warp_affine computes them."""
    inv = invert_affine(_t(mats))
    ar = torch.arange(out_size, dtype=torch.float32)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    inv = inv[:, :, :, None, None]
    sx = inv[:, 0, 0] * xx + inv[:, 0, 1] * yy + inv[:, 0, 2]
    sy = inv[:, 1, 0] * xx + inv[:, 1, 1] * yy + inv[:, 1, 2]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    vy = [(y0 >= 0) & (y0 <= win - 1), (y0 >= -1) & (y0 <= win - 2)]
    vx = [(x0 >= 0) & (x0 <= win - 1), (x0 >= -1) & (x0 <= win - 2)]
    return [(y0 + a, x0 + c, vy[a] & vx[c]) for a in (0, 1) for c in (0, 1)]


def _per_pixel(boxes, staged, out_size):
    """Tile boxes [K, T, T, 4] -> per output pixel [K, S, S, 4]."""
    tile = torch.arange(out_size) // K1.TILE
    return (boxes[:, tile][:, :, tile], staged[:, tile][:, :, tile])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_footprint_boxes_cover_every_valid_tap(seed):
    """Random similarity maps in all four quadrants at scales 0.3-2.0: a
    staged box holds every valid tap of its tile, x0 + 1 and y0 + 1
    included. With uint8 frames every tile at the engine's scales (0.4 and
    up) is staged."""
    gen = np.random.default_rng(50 + seed)
    win, s = 224, 112
    mats = _mats(gen, 48, lo=0.3, hi=2.0, win=win, out=s)
    scale = np.sqrt(np.abs(np.linalg.det(mats[:, :, :2].astype(np.float64))))
    taps = _valid_taps(mats, s, win)
    assert sum(int(v.sum()) for _, _, v in taps) > 0
    for dtype in (torch.uint8, torch.float32):
        boxes, staged = K1.footprint_boxes(_t(mats), s, win, dtype)
        assert boxes.shape == (48, 7, 7, 4)
        assert int(boxes.min()) >= 0 and int(boxes.max()) <= win - 1
        if dtype == torch.uint8:
            assert bool(staged[_t(scale >= 0.4)].all())
        assert bool(staged.any())
        box, on = _per_pixel(boxes, staged, s)
        for y, x, v in taps:
            inside = ((y >= box[..., 0]) & (y <= box[..., 1])
                      & (x >= box[..., 2]) & (x <= box[..., 3]))
            miss = v & on & ~inside
            assert not bool(miss.any()), f"{dtype}: {int(miss.sum())} taps"


def test_kernel_entries_refuse_cpu_tensors():
    """The frames form's kernel and the kernel's own box rule run on CUDA
    tensors only, and stage uint8 or f32 sources only; neither counts a
    launch when it refuses."""
    gen = np.random.default_rng(42)
    frames = _t(gen.integers(0, 256, (1, 230, 230, 3)).astype(np.uint8))
    zero = torch.zeros(2, dtype=torch.int32)
    mats = _t(_mats(gen, 2))
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        K1.similarity_warp_frames_kernel(frames, zero, zero, zero, 224, mats,
                                         112)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K1.kernel_footprint_boxes(mats, 112, 224)
    with pytest.raises(ValueError, match="uint8 or f32"):
        K1.kernel_footprint_boxes(mats, 112, 224, torch.float16)
    assert kernels.launch_counts() == before


def test_footprint_boxes_of_degenerate_matrices_stay_in_the_window():
    """NaN, zero, infinite and near-singular matrices: every box lies in
    the window (a NaN matrix stages the window's first pixel); a NaN
    matrix has no valid tap and a staged box covers every valid tap."""
    win, s = 224, 112
    nan = float("nan")
    mats = np.array([
        [[nan, 0.0, 0.0], [0.0, nan, 0.0]],
        [[nan] * 3, [nan] * 3],
        [[0.0] * 3, [0.0] * 3],
        [[float("inf"), 0.0, 5.0], [0.0, 1.0, 5.0]],
        [[1e-30, 0.0, 50.0], [0.0, 1e-30, 50.0]],
        [[1e6, 0.0, -1e8], [0.0, 1e6, -1e8]],
        [[0.5, 0.5, 0.0], [0.5, 0.5, 0.0]],
    ], np.float32)
    taps = _valid_taps(mats, s, win)
    for dtype in (torch.uint8, torch.float32):
        boxes, staged = K1.footprint_boxes(_t(mats), s, win, dtype)
        assert int(boxes.min()) >= 0 and int(boxes.max()) <= win - 1
        assert bool((boxes[..., 1] >= boxes[..., 0]).all())
        assert bool((boxes[..., 3] >= boxes[..., 2]).all())
        assert bool((boxes[:2] == 0).all()) and bool(staged[:2].all())
        box, on = _per_pixel(boxes, staged, s)
        for y, x, v in taps:
            assert not bool(v[:2].any())
            inside = ((y >= box[..., 0]) & (y <= box[..., 1])
                      & (x >= box[..., 2]) & (x <= box[..., 3]))
            assert not bool((v & on & ~inside).any())
