"""3xTF32, the product of K8's and K5's f32 grids, emulated in numpy.

``csrc/bottleneck_chain.cu`` (``conv_gemm_tf32x3``) and
``csrc/crop_net_trunk.cu`` (``crop_net_trunk_tf32x3``) run their f32
GEMMs on the tensor cores with ``mma.sync`` m16n8k8 TF32 products: each
f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
(``cvt.rna``: 10 mantissa bits, ties away from zero), and each k8 step
sums lo_a hi_b, then hi_a lo_b, then hi_a hi_b on the tensor cores, which
round their f32 sums toward zero; so the grids sum short partials there
from zero (K8 a k8 step, K5 a tap of 32 channels) and add each to their
f32 sums on the CUDA cores, rounded to nearest. Here that product is emulated
step by step from the kernels' packed weights and held to the plain f32
version at 1e-4: K8's three GEMMs a block (conv1, conv2's 9 taps, conv3
with the residual) at the emotion net's l1 and l2 shapes on a few faces,
and K5's conv1 (K = 27 + a ones column for the bias, padded to 32) and
conv2 (9 taps x 32 channels) for RNet and ONet on a few crops. One case
a GEMM shows that 3xTF32 is at least 30 times closer to the f64 product
than a single TF32 product, so the tests guard the split itself. The
f32 packing of K5 is held to ``pack_trunk_weights`` and to the bf16
packing."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vn_celeb_face_recognition_tpu_torch.models import mtcnn as TM
from vn_celeb_face_recognition_tpu_torch.models.resnet_common import ResLayer
from vn_celeb_face_recognition_tpu_torch.ops import bottleneck as K8
from vn_celeb_face_recognition_tpu_torch.ops import crops_net as K5


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tf32(x):
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, ties away from
    zero, as an f32 with its 13 low bits clear."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    x = np.asarray(x, np.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def rz32(v):
    """f64 -> f32 rounded toward zero, as mma.sync rounds its f32 sums:
    the f64 mantissa cut to f32's 23 bits, then an exact conversion."""
    bits = np.ascontiguousarray(v, np.float64).view(np.int64)
    return (bits & ~np.int64((1 << 29) - 1)).view(np.float64).astype(
        np.float32)


def mma_sum(a, b, steps, three=True, running=False):
    """a [M, K] @ b [K, N] as the grids sum it. Each k8 step's products
    (3xTF32: lo_a hi_b, hi_a lo_b, hi_a hi_b; else hi_a hi_b) are exact
    and summed on the tensor cores, which round their f32 sums toward
    zero, from zero over ``steps`` k8 steps; each such partial is then
    added to the f32 sums on the CUDA cores, rounded to nearest
    (``running``: every product summed straight into the tensor cores'
    running sums instead)."""
    ah, al = split(a)
    bh, bl = split(b)
    parts = ((al, bh), (ah, bl), (ah, bh)) if three else ((ah, bh),)
    assert a.shape[1] % (8 * steps) == 0
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    t = np.zeros_like(acc)
    for i, k0 in enumerate(range(0, a.shape[1], 8)):
        for pa, pb in parts:
            prod = (pa[:, k0:k0 + 8].astype(np.float64)
                    @ pb[k0:k0 + 8].astype(np.float64))
            if running:
                acc = rz32(acc + prod)
            else:
                t = rz32(t + prod)
        if not running and (i + 1) % steps == 0:
            acc, t = acc + t, np.zeros_like(acc)
    return acc


# k8 steps a partial sum: K8 adds each step's (mma_tf32x3_add), K5 each
# tap's 32 channels of conv2 and conv1's whole K = 32
K8_STEPS, K5_STEPS = 1, 4


def taps3x3(x, pad):
    """NHWC x -> [N * H' * W', 9 * C] rows over k = (ky*3 + kx)*C + c: the
    3x3 neighbourhood of each output pixel (zero off the image when
    ``pad``, else the valid positions)."""
    if pad:
        x = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    n, h, w, c = x.shape
    ho, wo = h - 2, w - 2
    cols = [x[:, ky:ky + ho, kx:kx + wo] for ky in range(3) for kx in range(3)]
    return np.concatenate(cols, -1).reshape(n * ho * wo, 9 * c)


# ---------------------------------------------------------------------------
# K8: conv_gemm_tf32x3, three launches a block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(64, 3, 56, 1), (128, 4, 28, 1)],
                ids=["l1", "l2"])
def tail(request):
    """A ResLayer's stride-1 tail at the emotion net's l1/l2 widths, with
    random weights and BatchNorm statistics (numpy seed), and a
    non-negative input of a few faces."""
    planes, blocks, side, n = request.param
    stride, inplanes = (1, 64) if planes == 64 else (2, 256)
    layer = ResLayer(planes, blocks, stride, inplanes).eval()
    gen = np.random.default_rng(planes + 1)
    with torch.no_grad():
        for m in layer.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.from_numpy(gen.normal(
                    0, (2.0 / fan_in) ** 0.5, tuple(m.weight.shape))))
            elif isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(gen.uniform(0.5, 1.5, c)))
                m.bias.copy_(torch.from_numpy(gen.normal(0, 0.1, c)))
                m.running_mean.copy_(torch.from_numpy(gen.normal(0, 0.1, c)))
                m.running_var.copy_(torch.from_numpy(gen.uniform(0.5, 1.5,
                                                                 c)))
    x = np.maximum(gen.normal(0, 1, (n, side, side, planes * 4)),
                   0).astype(np.float32)
    return list(layer)[1:], x


def k8_gemms(blk):
    """One block's three GEMMs as the f32 grid reads them: B [K, N] from
    pack_gemm_weights' [tap][out][in] rows (k = tap * K_in + c), and the
    f32 biases."""
    w1, b1, w2, b2, w3, b3 = (t.numpy() for t in K8.pack_gemm_weights(
        K8.fold_block(blk, torch.float32)))
    return [(w.transpose(0, 2, 1).reshape(-1, w.shape[1]), b)
            for w, b in ((w1, b1), (w2, b2), (w3, b3))]


def test_k8_3xtf32_matches_plain_chain(tail):
    """conv1 -> conv2 (9 taps, zero off the image) -> conv3 + residual,
    each in emulated 3xTF32 from the packed weights, chained over the
    tail's blocks, equals bottleneck_chain_plain in f32 within 1e-4 of
    max|ref|."""
    blocks, x = tail
    n, h, w, c = x.shape
    y = x.reshape(-1, c)
    for blk in blocks:
        (g1, b1), (g2, b2), (g3, b3) = k8_gemms(blk)
        t1 = np.maximum(mma_sum(y, g1, K8_STEPS) + b1, 0)
        a2 = taps3x3(t1.reshape(n, h, w, -1), pad=True)
        t2 = np.maximum(mma_sum(a2, g2, K8_STEPS) + b2, 0)
        y = np.maximum(mma_sum(t2, g3, K8_STEPS) + b3 + y, 0)
    want = K8.bottleneck_chain(blocks, torch.from_numpy(x)).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(y.reshape(n, h, w, c), want, rtol=1e-4,
                               atol=1e-4 * scale)


def test_k8_kernel_raises_on_widths_it_does_not_tile():
    """The f32 grid tiles P by 64 and C by 128, as the bf16 grid does: the
    wrapper raises on other widths before it looks for a card."""
    layer = ResLayer(32, 2, 1, 128).eval()
    x = torch.zeros((1, 8, 8, 128))
    with pytest.raises(ValueError, match="multiple of 64"):
        K8.bottleneck_chain_kernel(list(layer)[1:], x)


# ---------------------------------------------------------------------------
# K5: crop_net_trunk_tf32x3
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def det():
    return TM.MTCNN(device="cpu")


def unpack_tf32x3(buf, spec):
    """pack_trunk_weights_tf32x3's buffer -> w1 [32][K1P], w2 [C2][K2P],
    and the parameters a1[32], b2[C2], a2[C2]."""
    b = buf.numpy()
    n1 = K5.MMA_C1 * K5.TF32_K1P
    n2 = spec.c2 * K5.TF32_K2P
    assert b.size == n1 + n2 + K5.MMA_C1 + 2 * spec.c2
    w1 = b[:n1].reshape(K5.MMA_C1, K5.TF32_K1P)
    w2 = b[n1:n1 + n2].reshape(spec.c2, K5.TF32_K2P)
    par = b[n1 + n2:]
    c1p, c2 = K5.MMA_C1, spec.c2
    return w1, w2, par[:c1p], par[c1p:c1p + c2], par[c1p + c2:]


def trunk_3xtf32(crops, spec, w1, w2, a1, b2, a2, three=True):
    """The f32 grid's two GEMMs from the packed weights: conv1 over
    positions x k = (ky*3 + kx)*3 + ci with a ones column at k = 27 (the
    bias) and zeros to 32, PReLU, the ceil-mode 3x3/2 pool, then conv2
    over k = tap*32 + ci, bias and PReLU. Returns (out, conv1's A and B,
    conv2's A and B)."""
    n = crops.shape[0]
    h1, p, p2 = spec.conv1_out, spec.pooled, spec.out
    c1p = K5.MMA_C1
    a_1 = taps3x3(crops, pad=False)                     # [N*H1*H1, 27]
    a_1 = np.concatenate([a_1, np.ones((a_1.shape[0], 1), np.float32),
                          np.zeros((a_1.shape[0], 4), np.float32)], 1)
    g_1 = np.ascontiguousarray(w1[:, :32].T)
    y1 = mma_sum(a_1, g_1, K5_STEPS, three).reshape(n, h1, h1, c1p)
    y1 = np.where(y1 >= 0, y1, y1 * a1)
    pooled = np.full((n, p, p, c1p), -np.inf, np.float32)
    for py in range(p):
        for px in range(p):
            pooled[:, py, px] = y1[:, 2 * py:2 * py + 3,
                                   2 * px:2 * px + 3].max((1, 2))
    a_2 = taps3x3(pooled, pad=False)                    # [N*P2*P2, 288]
    g_2 = np.ascontiguousarray(w2[:, :K5.MMA_K2].T)
    out = mma_sum(a_2, g_2, K5_STEPS, three) + b2
    out = np.where(out >= 0, out, out * a2)
    return out.reshape(n, p2, p2, spec.c2), (a_1, g_1), (a_2, g_2)


def _crops(spec, n, seed):
    gen = np.random.default_rng(seed)
    return ((gen.integers(0, 256, (n, spec.size, spec.size, 3)) - 127.5)
            * 0.0078125).astype(np.float32)


@pytest.mark.parametrize("name", ["rnet", "onet"])
def test_k5_3xtf32_matches_plain_trunk(det, name):
    """conv1 and conv2 in emulated 3xTF32 from the f32 packing equal
    crop_net_trunk_plain in f32 within 1e-4 of max|ref| on a few crops."""
    spec = getattr(K5, f"{name.upper()}_SPEC")
    net = getattr(det, name)
    ops = unpack_tf32x3(K5.pack_trunk_weights_tf32x3(net, spec), spec)
    crops = _crops(spec, 3, 70)
    got, _, _ = trunk_3xtf32(crops, spec, *ops)
    want = K5.crop_net_trunk(net, torch.from_numpy(crops), spec).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("name", ["rnet", "onet"])
def test_k5_tf32x3_packing_round_trips(det, name):
    """pack_trunk_weights_tf32x3 holds pack_trunk_weights' values exactly
    (f32, unrounded): w1 rows over (ky, kx, ci) with the bias in column
    27, w2 rows over (tap, ci), a1, b2, a2; every padded channel, tap and
    column is zero."""
    spec = getattr(K5, f"{name.upper()}_SPEC")
    net = getattr(det, name)
    buf = K5.pack_trunk_weights_tf32x3(net, spec)
    assert buf.dtype == torch.float32 and (buf.numel() * 4) % 16 == 0
    w1, w2, a1, b2, a2 = unpack_tf32x3(buf, spec)
    c1, c2 = spec.c1, spec.c2
    flat = K5.pack_trunk_weights(net, spec).numpy()
    o = 29 * c1
    np.testing.assert_array_equal(w1[:c1, :27], flat[:27 * c1].reshape(
        27, c1).T)
    np.testing.assert_array_equal(w1[:c1, 27], flat[27 * c1:28 * c1])
    np.testing.assert_array_equal(a1[:c1], flat[28 * c1:o])
    taps = w2[:, :K5.MMA_K2].reshape(c2, 9, K5.MMA_C1)
    np.testing.assert_array_equal(
        taps[:, :, :c1], flat[o:o + 9 * c1 * c2].reshape(9, c1, c2)
        .transpose(2, 0, 1))
    np.testing.assert_array_equal(b2, flat[o + 9 * c1 * c2:-c2])
    np.testing.assert_array_equal(a2, flat[-c2:])
    assert not w1[c1:].any() and not w1[:, 28:].any()
    assert not taps[:, :, c1:].any() and not w2[:, K5.MMA_K2:].any()
    assert not a1[c1:].any()


@pytest.mark.parametrize("name", ["rnet", "onet"])
def test_k5_bf16_packing_is_the_f32_packing_rounded(det, name):
    """The bf16 grid's operands are the f32 grid's rounded to bf16, at the
    bf16 pitches: both packings come from one set of operands."""
    spec = getattr(K5, f"{name.upper()}_SPEC")
    net = getattr(det, name)
    w1, w2, a1, b2, a2 = unpack_tf32x3(
        K5.pack_trunk_weights_tf32x3(net, spec), spec)
    raw = K5.pack_trunk_weights_mma(net, spec).numpy()
    n1 = K5.MMA_C1 * K5.MMA_K1P * 2
    n2 = spec.c2 * K5.MMA_K2P * 2

    def bf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            torch.bfloat16).to(torch.float32).numpy()

    m1 = torch.from_numpy(raw[:n1].copy()).view(torch.bfloat16).float()
    m2 = torch.from_numpy(raw[n1:n1 + n2].copy()).view(torch.bfloat16)
    m1 = m1.numpy().reshape(K5.MMA_C1, K5.MMA_K1P)
    m2 = m2.float().numpy().reshape(spec.c2, K5.MMA_K2P)
    np.testing.assert_array_equal(m1[:, :32], bf(w1[:, :32]))
    np.testing.assert_array_equal(m2[:, :K5.MMA_K2], bf(w2[:, :K5.MMA_K2]))
    np.testing.assert_array_equal(raw[n1 + n2:].view(np.float32),
                                  bf(np.concatenate([a1, b2, a2])))


# ---------------------------------------------------------------------------
# the split itself
# ---------------------------------------------------------------------------


def test_tf32_rounds_to_nearest_ties_away():
    """tf32() keeps 10 mantissa bits, rounds ties away from zero, and hi +
    lo holds x to ~2^-22 of |x|."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    vals = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                     1 + 3 * 2.0 ** -11, 1.5 + 2.0 ** -12], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + 2 * ulp, 1.5],
                    np.float32)
    np.testing.assert_array_equal(tf32(vals), want)
    x = np.random.default_rng(71).normal(0, 10, 4096).astype(np.float32)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21


def _closer(a, b, steps):
    """(one TF32 product's, 3xTF32's, 3xTF32 summed straight into the
    tensor cores' running sums') largest error against the f64 product of
    the same f32 operands."""
    ref = a.astype(np.float64) @ b.astype(np.float64)
    return tuple(np.abs(mma_sum(a, b, steps, **kw) - ref).max()
                 for kw in (dict(three=False), {}, dict(running=True)))


def test_k8_3xtf32_is_30x_closer_than_one_tf32_product(tail):
    """At K8's conv2 GEMM (9 taps of t1, zero off the image), 3xTF32's
    largest error against f64 is at least 30 times below one TF32
    product's (hi_a hi_b): without the lo halves the grid would miss
    f32's accuracy. And it is at least 5 times below that of the same
    products summed straight into the tensor cores' running sums, which
    round toward zero: the reason for mma_tf32x3_add."""
    blocks, x = tail
    n, h, w, c = x.shape
    (g1, b1), (g2, _), _ = k8_gemms(blocks[0])
    t1 = np.maximum(x.reshape(-1, c) @ g1 + b1, 0).astype(np.float32)
    err1, err3, running = _closer(taps3x3(t1.reshape(n, h, w, -1), pad=True),
                                  g2, K8_STEPS)
    assert err1 >= 30 * err3, (err1, err3)
    assert running >= 5 * err3, (running, err3)


@pytest.mark.parametrize("conv", ["conv1", "conv2"])
@pytest.mark.parametrize("name", ["rnet", "onet"])
def test_k5_3xtf32_is_30x_closer_than_one_tf32_product(det, name, conv):
    """The same at K5's conv1 (K = 32 with the ones column) and conv2 (K =
    288) GEMMs, on the operands the f32 grid builds."""
    spec = getattr(K5, f"{name.upper()}_SPEC")
    ops = unpack_tf32x3(K5.pack_trunk_weights_tf32x3(getattr(det, name),
                                                     spec), spec)
    _, gemm1, gemm2 = trunk_3xtf32(_crops(spec, 2, 72), spec, *ops)
    err1, err3, _ = _closer(*(gemm1 if conv == "conv1" else gemm2),
                            K5_STEPS)
    assert err1 >= 30 * err3, (err1, err3)
