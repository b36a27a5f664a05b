"""K8's bf16 tensor-core path emulated in torch, on the CPU.

``csrc/bottleneck_chain.cu`` runs each Bottleneck block as three launches
of one implicit-GEMM template, ``conv_gemm_bf16``:
``out[m, o] = relu(sum_{tap, k} A_tap[m, k] W[tap, o, k] + b[o] (+ res))``
over the flattened pixels m = (image, y, x), where ``A_tap[m]`` is the
input pixel shifted by the tap (dy - 1, dx - 1), zero off the image. A
thread block owns a 128 x BN output tile (the last one ragged, its rows
zero-filled on load and dropped on store) and walks K in chunks of 32
channels of one tap, against the weights that ``pack_gemm_weights`` packs
[tap][out][in]. Here those tiles, chunks and the tap-shift index map are
followed step by step from the packed weights, chained conv1 -> conv2 ->
conv3 per block, and held to the plain chain at 1e-4 at the emotion
net's l1 and l2 shapes (tests/test_torch_emotion.py's ``tail``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vn_celeb_face_recognition_tpu_torch.models.resnet_common import ResLayer
from vn_celeb_face_recognition_tpu_torch.ops import bottleneck as K8
from vn_celeb_face_recognition_tpu_torch.utils import kernels
from torch_shared import two_threads  # noqa: F401 (autouse)

BM, BK = 128, 32  # the kernel's output rows per tile and K chunk


def _bn_(bn, gen):
    c = bn.num_features
    bn.weight.copy_(torch.from_numpy(gen.uniform(0.5, 1.5, c)))
    bn.bias.copy_(torch.from_numpy(gen.normal(0, 0.1, c)))
    bn.running_mean.copy_(torch.from_numpy(gen.normal(0, 0.1, c)))
    bn.running_var.copy_(torch.from_numpy(gen.uniform(0.5, 1.5, c)))


@pytest.fixture(scope="module", params=[(64, 3, 56, 1), (128, 4, 28, 2)],
                ids=["l1", "l2"])
def tail(request):
    """A ResLayer's stride-1 tail with random weights and BatchNorm
    statistics (numpy seed) and a non-negative input, at the emotion
    net's l1/l2 shapes; M = 3,136 and 1,568 pixels, so the last 128-row
    tile is ragged."""
    planes, blocks, side, n = request.param
    stride, inplanes = (1, 64) if planes == 64 else (2, 256)
    layer = ResLayer(planes, blocks, stride, inplanes).eval()
    gen = np.random.default_rng(planes)
    with torch.no_grad():
        for m in layer.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.from_numpy(gen.normal(
                    0, (2.0 / fan_in) ** 0.5, tuple(m.weight.shape))))
            elif isinstance(m, torch.nn.BatchNorm2d):
                _bn_(m, gen)
    x = np.maximum(gen.normal(0, 1, (n, side, side, planes * 4)),
                   0).astype(np.float32)
    return list(layer)[1:], torch.from_numpy(x), planes


def tap_rows(m, taps, h, w):
    """The kernel's index map: for output pixels m [R] and each tap, the
    source pixel row (m shifted by (dy - 1, dx - 1)) and whether it lies
    on the image; rows past the end (the ragged tile) are never valid."""
    y, x = (m // w) % h, m % w
    out = []
    for tap in range(taps):
        dy, dx = (tap // 3 - 1, tap % 3 - 1) if taps == 9 else (0, 0)
        ok = (y + dy >= 0) & (y + dy < h) & (x + dx >= 0) & (x + dx < w)
        out.append((m + dy * w + dx, ok))
    return out


def conv_gemm(a, wt, bias, h, w, res=None):
    """conv_gemm_bf16 followed tile by tile and chunk by chunk: a [M, K],
    wt [TAPS, N, K] packed, bias [N], res [M, N] or None -> [M, N]."""
    m_total, k = a.shape
    taps, n, _ = wt.shape
    bn = 128 if n % 128 == 0 else 64
    out = torch.empty((m_total, n), dtype=torch.float32)
    kpt = k // BK
    for m0 in range(0, m_total, BM):
        m = torch.arange(m0, m0 + BM)
        live = m < m_total
        rows = tap_rows(m, taps, h, w)
        for n0 in range(0, n, bn):
            acc = torch.zeros((BM, bn))
            for c in range(taps * kpt):
                tap, k0 = c // kpt, (c % kpt) * BK
                src, ok = rows[tap]
                ok = ok & live
                assert bool(((src[ok] >= 0) & (src[ok] < m_total)).all())
                chunk = torch.zeros((BM, BK))  # zero fill (src-size 0)
                chunk[ok] = a[src[ok], k0:k0 + BK]
                acc += chunk @ wt[tap, n0:n0 + bn, k0:k0 + BK].t()
            v = acc + bias[n0:n0 + bn]
            if res is not None:  # the residual, read at the output rows
                v = v + _rows(res, m, m_total)[:, n0:n0 + bn]
            out[m[live], n0:n0 + bn] = torch.relu(v)[live]
    return out


def _rows(t, m, m_total):
    """t's rows m, zero past the end (those rows are never stored)."""
    got = torch.zeros((m.numel(), t.shape[1]))
    live = m < m_total
    got[live] = t[m[live]]
    return got


def test_packing_round_trips_to_fold_block(tail):
    """pack_gemm_weights is fold_block's weights laid out [tap][out][in]:
    unpacked, it gives them back exactly, in bf16 and in f32."""
    blocks, _, planes = tail
    for dtype in (torch.float32, torch.bfloat16):
        folded = K8.fold_block(blocks[0], dtype)
        w1, b1, w2, b2, w3, b3 = K8.pack_gemm_weights(folded)
        c = planes * 4
        assert w1.shape == (1, planes, c) and w2.shape == (9, planes, planes)
        assert w3.shape == (1, c, planes)
        assert w1.dtype == w2.dtype == w3.dtype == dtype
        assert all(t.is_contiguous() for t in (w1, w2, w3))
        assert b1.dtype == b2.dtype == b3.dtype == torch.float32
        unpacked = (w1[0].t(), b1, w2.transpose(1, 2), b2, w3[0].t(), b3)
        for got, want in zip(unpacked, folded):
            assert torch.equal(got, want)


def test_tap_rows_index_map():
    """Each tap's source row is the pixel (y + dy - 1, x + dx - 1) of the
    same image, valid exactly when that lies on the image."""
    n, h, w = 2, 5, 7
    m = torch.arange(n * h * w + 6)  # a ragged tail of 6 rows
    for tap, (src, ok) in enumerate(tap_rows(m, 9, h, w)):
        dy, dx = tap // 3 - 1, tap % 3 - 1
        for i in range(n * h * w):
            img, y, x = i // (h * w), (i // w) % h, i % w
            inside = 0 <= y + dy < h and 0 <= x + dx < w
            assert bool(ok[i]) == inside
            if inside:
                assert int(src[i]) == (img * h + y + dy) * w + x + dx


def test_gemm_emulation_equals_plain_chain(tail):
    """Three emulated conv_gemm launches per block (conv1 x -> t1, conv2
    9 taps t1 -> t2, conv3 t2 -> y + x), from the packed weights, equal
    bottleneck_chain_plain at 1e-4, and the plain path counts no launch."""
    blocks, x, _ = tail
    n, h, w, c = x.shape
    y = x.reshape(-1, c)
    launches = 0
    for blk in blocks:
        w1, b1, w2, b2, w3, b3 = K8.pack_gemm_weights(
            K8.fold_block(blk, torch.float32))
        t1 = conv_gemm(y, w1, b1, h, w)
        t2 = conv_gemm(t1, w2, b2, h, w)
        y = conv_gemm(t2, w3, b3, h, w, res=y)
        launches += 3
    assert launches == 3 * len(blocks)
    before = kernels.launch_counts()
    want = K8.bottleneck_chain(blocks, x).contiguous()
    assert kernels.launch_counts() == before
    np.testing.assert_allclose(y.reshape(n, h, w, c).numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-4)
