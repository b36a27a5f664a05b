"""K5's bf16 tensor-core path emulated in numpy, on the CPU.

``csrc/crop_net_trunk.cu`` runs the bf16 trunk as two GEMMs on packed
operands: conv1 over positions x (tap, ci) with K = 27 padded to 32 (a
column of ones carries the bias), band by band into a ring of conv rows
that each band pools into an NHWC pooled map with 32 channels a pixel (an
80-byte pitch), then conv2 as an implicit GEMM whose k16 steps are one
tap x 16 channels, read straight from that map, against the K-major
[C2][9 * 32] w2 rows. Here the packing of ``pack_trunk_weights_mma`` is
unpacked, the kernel's index maps are followed step by step, and the
result is held to the plain trunk: at 1e-4 with the pooled map in f32,
and within chip_smoke.py's bf16 bounds with it rounded to bf16, as the
kernel rounds it. Uses the vendored MTCNN weights."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vn_celeb_face_recognition_tpu_torch.models import mtcnn as TM
from vn_celeb_face_recognition_tpu_torch.ops import crops_net as K5
from torch_shared import two_threads  # noqa: F401 (autouse)

BF16_REL_L2, BF16_REL_MAX = 1e-2, 5e-2  # chip_smoke.py check_bf16
PIX = K5.MMA_C1 + 8                     # pooled pixel pitch
GROUP = {"rnet": 4, "onet": 1}          # crops per block group


@pytest.fixture(scope="module")
def det():
    return TM.MTCNN(device="cpu")


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _unpack(buf, spec):
    """The byte buffer -> w1 [32][K1P], w2 [C2][K2P] (f32 holding bf16
    values) and the f32 parameters."""
    b = buf.numpy()
    n1 = K5.MMA_C1 * K5.MMA_K1P * 2
    n2 = spec.c2 * K5.MMA_K2P * 2

    def bf(raw, shape):
        t = torch.from_numpy(raw.copy()).view(torch.bfloat16)
        return t.to(torch.float32).numpy().reshape(shape)

    w1 = bf(b[:n1], (K5.MMA_C1, K5.MMA_K1P))
    w2 = bf(b[n1:n1 + n2], (spec.c2, K5.MMA_K2P))
    par = b[n1 + n2:].copy().view(np.float32)
    assert par.size == K5.MMA_C1 + 2 * spec.c2
    return w1, w2, par


def _koff(spec):
    """conv1's A columns: crop offset of k = (ky*3 + kx)*3 + ci from a
    position's first element; -2 for the column of ones that meets the
    bias (k = 27), -1 for the padding."""
    out = []
    for k in range(32):
        tap, ci = divmod(k, 3)
        out.append(((tap // 3) * spec.size + tap % 3) * 3 + ci
                   if k < 27 else (-2 if k == 27 else -1))
    return np.array(out)


def _emulate(crops, spec, w1, w2, par, round_pooled):
    """The kernel's bf16 path for one group of crops [g, S, S, 3]."""
    s, h1, p, p2, c2 = (spec.size, spec.conv1_out, spec.pooled, spec.out,
                        spec.c2)
    c1p = K5.MMA_C1
    a1, b2, a2 = par[:c1p], par[c1p:c1p + c2], par[c1p + c2:]
    g = crops.shape[0]
    flat = crops.reshape(g, -1).astype(np.float64)
    koff = _koff(spec)
    pooled = np.zeros((g * p * p, PIX))
    br = 2 * K5.MMA_BAND + 1
    ring = np.full((g, br, h1, c1p), np.nan)     # conv row y in slot y % br
    for py0 in range(0, p, K5.MMA_BAND):
        py1 = min(py0 + K5.MMA_BAND, p)
        first = 0 if py0 == 0 else 2 * py0 + 1   # rows the band adds
        nrows = min(2 * py1, h1 - 1) - first + 1
        q, x = divmod(np.arange(g * nrows * h1), h1)
        gi, r = divmod(q, nrows)
        y = first + r
        base = (y * s + x) * 3
        a = np.where(koff[None] >= 0,
                     flat[gi[:, None], base[:, None] + np.maximum(koff, 0)],
                     np.where(koff[None] == -2, 1.0, 0.0))  # [M1, 32]
        conv = a @ w1[:, :32].T.astype(np.float64)  # the bias via k = 27
        band = np.where(conv >= 0, conv, conv * a1)
        if round_pooled:
            band = _bf16(band).astype(np.float64)
        ring[gi, y % br, x] = band
        for py in range(py0, py1):
            rows = [yy % br for yy in range(2 * py, min(2 * py + 2, h1 - 1)
                                            + 1)]
            for px in range(p):
                xs = slice(2 * px, min(2 * px + 2, h1 - 1) + 1)
                win = ring[:, rows, xs].max((1, 2))  # [g, 32]; NaN if unset
                pooled[(np.arange(g) * p + py) * p + px, :c1p] = win
    m = np.arange(g * p2 * p2)                    # conv2 positions
    gi, rem = divmod(m, p2 * p2)
    pix = gi * p * p + (rem // p2) * p + rem % p2
    acc = np.zeros((m.size, c2))
    for step in range(K5.MMA_K2 // 16):           # the k16 steps
        tap, half = divmod(step, 2)
        k0 = tap * c1p + half * 16
        assert (k0 * 2) % 16 == 0 and (PIX * 2) % 16 == 0  # ldmatrix rows
        arow = pooled[pix + (tap // 3) * p + tap % 3, half * 16:half * 16 + 16]
        acc += arow @ w2[:, k0:k0 + 16].T.astype(np.float64)
    out = acc + b2
    out = np.where(out >= 0, out, out * a2)
    return out.reshape(g, p2, p2, c2)


@pytest.mark.parametrize("name", ["rnet", "onet"])
def test_mma_packing_pads_with_zeros(det, name):
    """Padded channels, taps and columns of the packed operands are zero,
    conv1's bias sits in w1's column 27, and every value is
    bf16-representable."""
    spec = getattr(K5, f"{name.upper()}_SPEC")
    net = getattr(det, name)
    buf = K5.pack_trunk_weights_mma(net, spec)
    assert buf.dtype == torch.uint8 and buf.numel() % 16 == 0
    w1, w2, par = _unpack(buf, spec)
    c1, c2 = spec.c1, spec.c2
    assert not w1[c1:].any() and not w1[:, 28:].any()
    np.testing.assert_array_equal(w1[:c1, 27],
                                  _bf16(net.conv1.bias.detach().numpy()))
    assert not w2[:, K5.MMA_K2:].any()
    assert not w2[:, :K5.MMA_K2].reshape(c2, 9, 32)[:, :, c1:].any()
    assert not par[c1:32].any()
    np.testing.assert_array_equal(par, _bf16(par))
    np.testing.assert_array_equal(
        w1[:c1, :27],
        _bf16(net.conv1.weight.detach().permute(0, 2, 3, 1).reshape(c1, 27)))


@pytest.mark.parametrize("name", ["rnet", "onet"])
@pytest.mark.parametrize("round_pooled", [False, True])
def test_mma_index_maps_match_plain_trunk(det, name, round_pooled):
    """The emulated kernel against the plain trunk. With the pooled map in
    f32 it matches the plain trunk of the bf16-rounded weights at 1e-4;
    with the pooled map rounded to bf16, as the kernel does, it stays
    within check_bf16's bounds of the plain trunk in f32. A partial group
    (fewer crops than the block's group) is included."""
    spec = getattr(K5, f"{name.upper()}_SPEC")
    net = getattr(det, name)
    w1, w2, par = _unpack(K5.pack_trunk_weights_mma(net, spec), spec)
    gen = np.random.default_rng(60)
    n = 2 * GROUP[name] + 1
    crops = _bf16((gen.integers(0, 256, (n, spec.size, spec.size, 3))
                   - 127.5) * 0.0078125)
    got = np.concatenate([
        _emulate(crops[i:i + GROUP[name]], spec, w1, w2, par, round_pooled)
        for i in range(0, n, GROUP[name])])
    x = torch.from_numpy(crops)
    if round_pooled:
        want = K5.crop_net_trunk_plain(net, x, spec).numpy()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        rel_max = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= BF16_REL_L2 and rel_max <= BF16_REL_MAX, (rel, rel_max)
    else:
        net16 = copy.deepcopy(net)
        with torch.no_grad():
            for prm in net16.parameters():
                prm.copy_(prm.to(torch.bfloat16).to(torch.float32))
        want = K5.crop_net_trunk_plain(net16, x, spec).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_rounding_before_the_pool_equals_rounding_after():
    """The kernel rounds conv1's output to bf16 and pools the rounded
    values: rounding is monotone, so this equals rounding the f32 pool."""
    gen = np.random.default_rng(61)
    v = gen.normal(0, 3, (4096, 9)).astype(np.float32)
    np.testing.assert_array_equal(_bf16(v).max(1), _bf16(v.max(1)))
