"""The bf16 tensor-core paths of K6 and K7 emulated in torch, on the CPU.

``csrc/mnet_stage1.cu`` (``segment_mma_first``, ``segment_mma``) and
``csrc/emotion_stem.cu`` (``emotion_stem_mma``) cannot run here, so their
arithmetic is followed from the wrappers' own packing functions: each
kernel's tiles, its M rows padded to 16 (the padding rows repeat the
last and are dropped), its K/N layout, and the points where it rounds to
bf16, with f32 sums. The kernels' index maps for the A rows they gather
(K7's im2col from a staged face and its one-value-shifted copy, K6's
conv0 from the staged frame) are followed lane by lane through the
m16n8k16 fragment layout. The emulations are held to the plain f32
versions under chip_smoke.py's bf16 bounds and to the JAX package: K6 to
``ops/planar_mnet.planar_stage1`` in bf16 and K7 to the Pallas stem in
interpret mode, on the same numpy-seeded inputs and converted weights.

K6 splits every GEMM operand into bf16 hi + lo (three products) and keeps
its stage-A maps in f32, because the stage amplifies rounding:
``python tests/test_torch_stem_mma.py`` prints the error of that design
and of the alternatives on one bench frame."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F

import jax.numpy as jnp

# the repo root, for the packages and chip_smoke when run as a script
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import BF16_REL_L2, BF16_REL_MAX
from vn_celeb_face_recognition_tpu.models.torch_convert import (
    convert_state_dict,
)
from vn_celeb_face_recognition_tpu.ops.emotion_stem_pallas import (
    emotion_stem_pallas,
)
from vn_celeb_face_recognition_tpu.ops.planar_mnet import planar_stage1
from vn_celeb_face_recognition_tpu_torch.models import retinaface as TR
from vn_celeb_face_recognition_tpu_torch.models.layers import load_npz
from vn_celeb_face_recognition_tpu_torch.ops import emotion_stem as K7
from vn_celeb_face_recognition_tpu_torch.ops import planar_s1 as K6
from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames

from test_torch_emotion import SHALLOW, emotion_pair
from torch_shared import two_threads  # noqa: F401 (autouse)

SUB = TR.CHANNELS_SUBTRACT
BF = torch.bfloat16


def rb(x):
    """Round to bf16 and back."""
    return x.to(BF).to(torch.float32)


def leaky(x):
    return torch.where(x >= 0, x, x * 0.1)


def errors(got, want):
    """(relative L2, max error over max |want|), chip_smoke's check_bf16."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    return (float((got - want).norm() / want.norm()),
            float((got - want).abs().max() / want.abs().max()))


def mma_from_fragments(a_regs, b_regs):
    """One mma.sync.m16n8k16 from the 32 lanes' registers (uint32 holding
    two bf16, the lower column in the low half): a_regs [32, 4], b_regs
    [32, 2] -> the A [16, 16] and B [16, 8] tiles they hold."""
    def halves(r):
        lo = (r & 0xFFFF).astype(np.uint16).view(np.int16)
        hi = (r >> 16).astype(np.uint16).view(np.int16)
        return [torch.from_numpy(h.astype(np.int16)).view(BF).float()
                for h in (lo, hi)]

    a = torch.zeros(16, 16)
    b = torch.zeros(16, 8)
    for lane in range(32):
        gq, tq = lane // 4, lane % 4
        for i in range(4):
            row, col = gq + 8 * (i & 1), 2 * tq + 8 * (i >> 1)
            lo, hi = halves(np.array([a_regs[lane][i]], np.uint32))
            a[row, col], a[row, col + 1] = lo[0], hi[0]
        for i in range(2):
            lo, hi = halves(np.array([b_regs[lane][i]], np.uint32))
            b[2 * tq + 8 * i, gq], b[2 * tq + 8 * i + 1, gq] = lo[0], hi[0]
    return a, b


def bf16_bits(x):
    """f32 tensor -> its bf16 bit patterns as uint16 numpy."""
    return x.to(BF).view(torch.int16).numpy().view(np.uint16)


def words(bits):
    """uint16 array (even length) -> uint32 words, element 2i low."""
    return bits.astype(np.uint32)[0::2] | (bits.astype(np.uint32)[1::2]
                                           << 16)


# ---- K7 -------------------------------------------------------------------

STD = torch.tensor([0.229, 0.224, 0.225])
MEAN = torch.tensor([0.485, 0.456, 0.406])


def k7_face(faces):
    """The normalised face as the kernel forms it: x * 1/(255 std) +
    (-mean/std) in f32, rounded to bf16 (the A operand)."""
    return rb(faces * (1.0 / (255.0 * STD)) + (-MEAN / STD))


def k7_emulate(conv1, bn1, faces):
    """emotion_stem_mma: per 8x8 pooled tile, the 289 conv positions'
    im2col rows (k = (dy*4 + dx)*3 + c) padded to 19 m16 tiles, times the
    packed [64, 48] B, f32 sums; bias, ReLU, -inf off the conv map, bf16
    into cbuf; the 3x3/2 max pool."""
    k = faces.shape[0]
    bias = K7.fold_stem_weights(conv1, bn1)[48 * 64:]
    b = K7.pack_stem_mma_weights(conv1, bn1).to(torch.float32)
    # face rows/cols -3 .. 114: tile t's footprint starts at 16 t - 3
    xp = F.pad(k7_face(faces), (0, 0, 3, 1, 3, 1))
    foot = xp.unfold(1, 20, 16).unfold(2, 20, 16).permute(0, 1, 2, 4, 5, 3)
    cols = foot.unfold(3, 4, 1).unfold(4, 4, 1)  # [K,7,7,17,17,3,dy,dx]
    a = cols.permute(0, 1, 2, 3, 4, 6, 7, 5).reshape(k, 7, 7, 289, 48)
    a = torch.cat([a, a[..., 288:, :].expand(k, 7, 7, 15, 48)], 3)
    assert a.shape[3] == 19 * 16
    acc = (a @ b.t())[..., :289, :]
    v = torch.relu(acc + bias)
    cy = 16 * torch.arange(7)[:, None] - 1 + torch.arange(17)
    on = (cy >= 0) & (cy < 112)
    on = (on[:, None, :, None] & on[None, :, None, :]).reshape(1, 7, 7,
                                                              289, 1)
    cbuf = rb(torch.where(on, v, -torch.inf)).reshape(k, 7, 7, 17, 17, 64)
    pooled = cbuf.unfold(3, 3, 2).unfold(4, 3, 2).amax((-1, -2))
    return pooled.permute(0, 1, 3, 2, 4, 5).reshape(k, 56, 56, 64)


def k7_tile_a(face, ty, tx):
    """The A rows emotion_stem_mma gathers for tile (ty, tx) of one face,
    lane by lane as the kernel indexes them: each register one aligned
    32-bit word of the staged face f0, or of its copy f1[j] = f0[j + 1]
    when the position's column is odd. Returns the [304, 48] A (bf16
    values as f32)."""
    fy0, fx0 = 16 * ty - 3, 16 * tx - 3
    foot = torch.zeros(20, 20, 3)
    ys = slice(max(fy0, 0), min(fy0 + 20, 112))
    xs = slice(max(fx0, 0), min(fx0 + 20, 112))
    foot[ys.start - fy0:ys.stop - fy0, xs.start - fx0:xs.stop - fx0] = \
        k7_face(face)[ys, xs]
    f0 = bf16_bits(foot.reshape(-1))
    f1 = np.append(f0[1:], np.uint16(0))
    w0, w1 = words(f0), words(f1)
    a = torch.zeros(19 * 16, 48)
    for mt in range(19):
        regs = np.zeros((3, 32, 4), np.uint32)
        for lane in range(32):
            gq, tq = lane // 4, lane % 4
            base, src = [], []
            for hh in range(2):
                m = min(mt * 16 + gq + 8 * hh, 288)
                r, q = m // 17, m % 17
                base.append((r * 20 + q) * 3)
                src.append(w1 if q & 1 else w0)
            for ks in range(3):
                koff = []
                for hf in range(2):
                    kk = ks * 16 + hf * 8 + 2 * tq
                    dy = kk // 12
                    koff.append(dy * 60 + kk - 12 * dy)
                regs[ks, lane] = [src[0][(base[0] + koff[0]) >> 1],
                                  src[1][(base[1] + koff[0]) >> 1],
                                  src[0][(base[0] + koff[1]) >> 1],
                                  src[1][(base[1] + koff[1]) >> 1]]
        for ks in range(3):
            tile, _ = mma_from_fragments(regs[ks], np.zeros((32, 2),
                                                            np.uint32))
            a[mt * 16:mt * 16 + 16, ks * 16:ks * 16 + 16] = tile
    return a, foot


@pytest.fixture(scope="module")
def stem():
    net, jvars = emotion_pair(layers=SHALLOW)
    return net.conv1, net.bn1, jvars


def test_k7_mma_pack_layout(stem):
    """B is the fold's [48, 64] transposed to [64, 48] (n-major, k =
    (dy*4 + dx)*3 + c contiguous) and rounded to bf16; the bf16 wrapper's
    buffer is the f32 fold followed by B's bits, the f32 wrapper's the
    fold followed by B split into TF32 halves."""
    conv1, bn1, _ = stem
    fold = K7.fold_stem_weights(conv1, bn1)
    b = K7.pack_stem_mma_weights(conv1, bn1)
    assert b.dtype == BF and b.shape == (64, 48) and b.is_contiguous()
    assert torch.equal(b, fold[:48 * 64].reshape(48, 64).t().to(BF))
    # column (dy*4 + dx)*3 + c of output o: the 7x7 taps of its folded
    # cell, BN scale applied
    w = conv1.weight.detach()
    inv = bn1.weight / torch.sqrt(bn1.running_var + bn1.eps)
    groups = ((0,), (1, 2), (3, 4), (5, 6))
    for o, dy, dx, c in ((0, 0, 0, 0), (5, 1, 2, 1), (63, 3, 3, 2)):
        want = sum(w[o, c, i, j] for i in groups[dy] for j in groups[dx])
        torch.testing.assert_close(b[o, (dy * 4 + dx) * 3 + c].float(),
                                   rb(want * inv[o]), rtol=2 ** -7, atol=0)
    buf = K7._kernel_weights(conv1, bn1, BF)
    assert torch.equal(buf[:48 * 64 + 64], fold)
    assert torch.equal(buf[48 * 64 + 64:].view(BF), b.reshape(-1))
    buf = K7._kernel_weights(conv1, bn1, torch.float32)
    assert torch.equal(buf[:48 * 64 + 64], fold)
    assert torch.equal(buf[48 * 64 + 64:],
                       K7.pack_stem_tf32x3_weights(conv1, bn1).reshape(-1))


@pytest.mark.parametrize("tile", [(0, 0), (3, 6), (6, 6)])
def test_k7_fragments_gather_the_im2col_rows(tile):
    """emotion_stem_mma's A registers hold the im2col rows of the tile's
    conv positions (edge tiles included), the padding rows repeating
    position 288."""
    face = torch.from_numpy(np.random.default_rng(8).uniform(
        0, 255, (112, 112, 3)).astype(np.float32))
    a, foot = k7_tile_a(face, *tile)
    cols = foot.unfold(0, 4, 1).unfold(1, 4, 1)  # [17, 17, 3, dy, dx]
    want = cols.permute(0, 1, 3, 4, 2).reshape(289, 48)
    assert torch.equal(a[:289], want)
    assert torch.equal(a[289:], want[288:].expand(15, 48))


@pytest.mark.parametrize("k", [3, 9])
def test_k7_mma_emulation_matches_plain_and_jax(stem, k):
    conv1, bn1, jvars = stem
    faces = np.random.default_rng(k).uniform(0, 255, (k, 112, 112, 3)
                                             ).astype(np.float32)
    got = k7_emulate(conv1, bn1, torch.from_numpy(faces))
    want = K7.emotion_stem_plain(conv1, bn1, torch.from_numpy(faces),
                                 torch.float32)
    rel, rel_max = errors(got, want)
    assert rel <= BF16_REL_L2 and rel_max <= BF16_REL_MAX, (rel, rel_max)
    jax_out = emotion_stem_pallas(jvars["params"], jvars["batch_stats"],
                                  jnp.asarray(faces), dtype=jnp.float32,
                                  interpret=True)
    rel, rel_max = errors(got, torch.from_numpy(np.array(jax_out)))
    assert rel <= BF16_REL_L2 and rel_max <= BF16_REL_MAX, (rel, rel_max)


def test_k7_pool_of_rounded_is_rounded_pool():
    """bf16 rounding is monotone, so staging cbuf in bf16 and pooling
    equals pooling in f32 and rounding the output, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 3, (4, 64, 35, 35)).astype(np.float32))
    x[:, :, ::7] = -torch.inf  # the pool's padding cells
    x[0, 0, 1, 1] = 0.1 + 2 ** -20  # near a rounding tie
    assert torch.equal(F.max_pool2d(x.to(BF), 3, 2, 1),
                       F.max_pool2d(x, 3, 2, 1).to(BF))


# ---- K6 -------------------------------------------------------------------

def unpack_f32(flat):
    """The f32 pack's BN (mul, add) and depthwise taps per block, at the
    offsets csrc/mnet_stage1.cu reads."""
    out, at = {}, 4
    for i, (kind, cin, cout, _) in enumerate(K6.STAGE1_SPECS):
        if kind == "conv_bn":
            at += 27 * cout
            out[i] = dict(bn=(flat[at:at + cout],
                              flat[at + cout:at + 2 * cout]))
            at += 2 * cout
            continue
        dw = flat[at:at + 9 * cin].reshape(9, cin)
        at += 9 * cin
        bn1 = (flat[at:at + cin], flat[at + cin:at + 2 * cin])
        at += 2 * cin + cin * cout
        out[i] = dict(dw=dw, bn1=bn1,
                      bn2=(flat[at:at + cout], flat[at + cout:at + 2 * cout]))
        at += 2 * cout
    assert at == K6.N_WEIGHTS
    return out


def mma_mat(mma, name):
    """(hi, lo) of one packed B matrix, as f32."""
    at, rows, cols = K6.MMA_LAYOUT[name]
    n = rows * cols
    return (mma[at:at + n].reshape(rows, cols).to(torch.float32),
            mma[at + n:at + 2 * n].reshape(rows, cols).to(torch.float32))


def bn_leaky(x, bn):
    return leaky(x * bn[0] + bn[1])


def gemm_rows(a, b):
    """a [..., M, K] x b [N, K]^T, M padded to 16 by repeating the last
    row, the padding dropped."""
    m = a.shape[-2]
    pad = -m % 16
    a = torch.cat([a, a[..., -1:, :].expand(*a.shape[:-2], pad,
                                              a.shape[-1])], -2)
    return (a @ b.t())[..., :m, :]


def gemm_split(a, b, operands):
    """The kernels' products (``operands`` "split"): A = hi + lo and B =
    hi + lo in bf16, three GEMMs (hi.hi + lo.hi + hi.lo), f32 sums. "bf16":
    one GEMM of bf16 A and B; "f32": A and B unrounded."""
    if operands == "f32":
        return gemm_rows(a, b[0] + b[1])
    a_hi = rb(a)
    if operands == "bf16":
        return gemm_rows(a_hi, b[0])
    a_lo = rb(a - a_hi)
    return (gemm_rows(a_hi, b[0]) + gemm_rows(a_lo, b[0])
            + gemm_rows(a_hi, b[1]))


def footprints(x, th, tw, ty, tx):
    """[B, H, W, C] -> per-tile input footprints [B, ty, tx, 2th+5, 2tw+5,
    C] with origins (2 th i - 3, 2 tw j - 3), zero off the map."""
    ih, iw = 2 * th + 5, 2 * tw + 5
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, 3, max(0, 2 * tw * (tx - 1) - 3 + iw - w),
                   3, max(0, 2 * th * (ty - 1) - 3 + ih - h)))
    f = xp.unfold(1, ih, 2 * th).unfold(2, iw, 2 * tw)[:, :ty, :tx]
    return f.permute(0, 1, 2, 4, 5, 3)


def cells_on_map(ty, tx, th, tw, ho, wo):
    """[1, ty, tx, th+2, tw+2, 1]: the stage-A cells inside the map."""
    ry = th * torch.arange(ty)[:, None] - 1 + torch.arange(th + 2)
    rx = tw * torch.arange(tx)[:, None] - 1 + torch.arange(tw + 2)
    oy, ox = (ry >= 0) & (ry < ho), (rx >= 0) & (rx < wo)
    return (oy[:, None, :, None] & ox[None, :, None, :])[None, ..., None]


def depthwise(x, dw, stride):
    """Valid 3x3 depthwise conv of [N, h, w, C] in f32."""
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), dw.t().reshape(c, 1, 3, 3),
                 stride=stride, groups=c)
    return y.permute(0, 2, 3, 1)


def untile(t, ho, wo):
    b, ty, tx, th, tw, c = t.shape
    return t.permute(0, 1, 3, 2, 4, 5).reshape(b, ty * th, tx * tw, c)[
        :, :ho, :wo]


def k6_segment1(x, f32, mma, operands="split", map_bf16=False):
    """segment_mma_first on 16x16 tiles: conv0 as a GEMM over the 18x18
    stage-A cells (K = 27 padded to 32; A exact, B split), BN + LeakyReLU,
    zero off the map, kept f32; block 1's depthwise, the split A tile
    (K = 8 padded to 16), the pointwise GEMM, bf16 out."""
    th = tw = 16
    b, h, w, _ = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    ty, tx = -(-ho // th), -(-wo // tw)
    xs = rb(x.to(torch.float32) - torch.tensor(SUB))  # exact
    foot = footprints(xs, th, tw, ty, tx)
    cols = foot.unfold(3, 3, 2).unfold(4, 3, 2)[:, :, :, :th + 2, :tw + 2]
    a = cols.permute(0, 1, 2, 3, 4, 6, 7, 5).reshape(b, ty, tx, -1, 27)
    w0 = mma_mat(mma, "conv0")
    acc = gemm_rows(F.pad(a, (0, 5)), w0[0])
    if operands != "bf16":  # A is exact: B's lo is the only split
        acc = acc + gemm_rows(F.pad(a, (0, 5)), w0[1])
    v = bn_leaky(acc, f32[0]["bn"]).reshape(b, ty, tx, th + 2, tw + 2, 8)
    v = torch.where(cells_on_map(ty, tx, th, tw, ho, wo), v, 0)
    if map_bf16:
        v = rb(v)
    d = depthwise(v.reshape(-1, th + 2, tw + 2, 8), f32[1]["dw"], 1)
    at = F.pad(bn_leaky(d, f32[1]["bn1"]), (0, 8))
    o = gemm_split(at.reshape(b, ty, tx, th * tw, 16), mma_mat(mma, "pw1"),
                   operands)
    o = rb(bn_leaky(o, f32[1]["bn2"]))
    return untile(o.reshape(b, ty, tx, th, tw, 16), ho, wo)


def k6_segment(x, f32, mma, blocks, th, tw, operands="split",
               map_bf16=False):
    """segment_mma on th x tw tiles: depthwise 3x3/2 over the stage-A
    cells, split A tile, pointwise GEMM, BN + LeakyReLU, zero off the map,
    kept f32; depthwise 3x3/1, split A tile, pointwise GEMM, bf16 out."""
    ia, ib = blocks
    b, h, w, cin = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    ty, tx = -(-ho // th), -(-wo // tw)
    ar, ac = th + 2, tw + 2
    foot = footprints(x, th, tw, ty, tx)
    d = depthwise(foot.reshape(-1, 2 * th + 5, 2 * tw + 5, cin),
                  f32[ia]["dw"], 2)
    aa = bn_leaky(d, f32[ia]["bn1"]).reshape(b, ty, tx, ar * ac, cin)
    pw_a = mma_mat(mma, f"pw{ia}")
    cmid = pw_a[0].shape[0]
    v = bn_leaky(gemm_split(aa, pw_a, operands), f32[ia]["bn2"])
    v = torch.where(cells_on_map(ty, tx, th, tw, ho, wo),
                    v.reshape(b, ty, tx, ar, ac, cmid), 0)
    if map_bf16:
        v = rb(v)
    d = depthwise(v.reshape(-1, ar, ac, cmid), f32[ib]["dw"], 1)
    at = bn_leaky(d, f32[ib]["bn1"]).reshape(b, ty, tx, th * tw, cmid)
    pw_b = mma_mat(mma, f"pw{ib}")
    o = rb(bn_leaky(gemm_split(at, pw_b, operands), f32[ib]["bn2"]))
    return untile(o.reshape(b, ty, tx, th, tw, -1), ho, wo)


def k6_emulate(stage1, frames, operands="split", map_bf16=False):
    """The three bf16 launches (tiles 16x16, 8x16, 8x8), bf16 scratch
    between them. Other designs for the precision table: ``operands``
    "bf16" (one product of bf16 operands) or "f32" (unrounded: the f32
    kernel's arithmetic with bf16 scratch and output), ``map_bf16`` (the
    stage-A maps rounded to bf16)."""
    f32 = unpack_f32(K6.pack_stage1_weights(stage1, SUB))
    mma = K6.pack_stage1_mma_weights(stage1)
    with torch.no_grad():
        s1 = k6_segment1(frames, f32, mma, operands, map_bf16)
        s2 = k6_segment(s1, f32, mma, (2, 3), 8, 16, operands, map_bf16)
        return k6_segment(s2, f32, mma, (4, 5), 8, 8, operands, map_bf16)


def k6_conv0_tile(xs, w0, mt):
    """conv0's m tile ``mt`` of one 16x16 tile as segment_mma_first runs
    it, lane by lane: the A registers gathered from the staged [37][37][3]
    frame at the kernel's offsets (columns k >= 27 read offset 0), the B
    registers (hi, lo) read from rows of the [8][40] staged copy; returns
    the m16n8 products summed over both k16 steps and both B halves."""
    flat = bf16_bits(xs.reshape(-1))
    b_hi = F.pad(w0[0], (0, 8))  # the 40-element pitch
    b_lo = F.pad(w0[1], (0, 8))
    bw = [words(bf16_bits(m.reshape(-1))) for m in (b_hi, b_lo)]
    out = torch.zeros(16, 8)
    for ks in range(2):
        a_regs = np.zeros((32, 4), np.uint32)
        b_regs = [np.zeros((32, 2), np.uint32) for _ in range(2)]
        for lane in range(32):
            gq, tq = lane // 4, lane % 4
            base = []
            for hh in range(2):
                m = min(mt * 16 + gq + 8 * hh, 323)
                r, q = m // 18, m % 18
                base.append((2 * r * 37 + 2 * q) * 3)
            off = {}
            for hf in range(2):
                for e in range(2):
                    k = ks * 16 + hf * 8 + 2 * tq + e
                    dy, dx, c = k // 9, (k % 9) // 3, k % 3
                    off[hf, e] = (dy * 37 + dx) * 3 + c if k < 27 else 0
            for i in range(4):
                hh, hf = i & 1, i >> 1
                a_regs[lane, i] = (int(flat[base[hh] + off[hf, 0]])
                                   | int(flat[base[hh] + off[hf, 1]]) << 16)
            for p in range(2):
                for hf in range(2):
                    b_regs[p][lane, hf] = bw[p][(gq * 40 + ks * 16 + hf * 8
                                                 + 2 * tq) // 2]
        for p in range(2):
            a, b = mma_from_fragments(a_regs, b_regs[p])
            out += a @ b
    return out


@pytest.fixture(scope="module")
def fitted():
    """The vendored fitted RetinaFace stage 1 (what chip_smoke runs) and
    its JAX variables."""
    net = load_npz(TR.RetinaFaceNet(), TR.WEIGHTS_NPZ).eval()
    with np.load(TR.WEIGHTS_NPZ) as z:
        jvars = convert_state_dict({k: z[k] for k in z.files})
    return net.body.stage1, jvars


def test_k6_mma_pack_layout(fitted):
    """Each B matrix at its MMA_LAYOUT offset as [out, in], hi equal to
    the module's weights rounded to bf16 and lo to the rest rounded, the
    padding zero; the bf16 wrapper's buffer is the f32 pack followed by
    the bf16 pack's bits."""
    stage1, _ = fitted
    mma = K6.pack_stage1_mma_weights(stage1)
    assert mma.dtype == BF and mma.shape == (K6.N_MMA_WEIGHTS,)
    spans = sorted((at, at + 2 * r * c) for at, r, c in
                   K6.MMA_LAYOUT.values())
    assert spans[0][0] == 0 and spans[-1][1] == K6.N_MMA_WEIGHTS
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    w0 = stage1[0][0].weight.detach()  # [8, 3, ky, kx]
    hi, lo = mma_mat(mma, "conv0")
    want = w0.permute(0, 2, 3, 1).reshape(8, 27)  # (ky*3 + kx)*3 + c
    assert torch.equal(hi[:, :27], rb(want))
    assert torch.equal(lo[:, :27], rb(want - rb(want)))
    assert not hi[:, 27:].any() and not lo[:, 27:].any()
    assert hi[2, (1 * 3 + 2) * 3 + 1] == rb(w0[2, 1, 1, 2])
    for i in range(1, 6):
        pw = stage1[i][3].weight.detach()[:, :, 0, 0]  # [out, in]
        hi, lo = mma_mat(mma, f"pw{i}")
        cin = pw.shape[1]
        assert hi.shape == (pw.shape[0], max(cin, 16))
        assert torch.equal(hi[:, :cin], rb(pw))
        assert torch.equal(lo[:, :cin], rb(pw - rb(pw)))
        assert not hi[:, cin:].any() and not lo[:, cin:].any()
        assert float((hi + lo - F.pad(pw, (0, hi.shape[1] - cin))).abs()
                     .max()) <= 2 ** -16 * float(pw.abs().max())
    buf = K6._kernel_weights(stage1, SUB, BF)
    assert torch.equal(buf[:K6.N_WEIGHTS],
                       K6.pack_stage1_weights(stage1, SUB))
    assert torch.equal(buf[K6.N_WEIGHTS:].view(BF), mma)


def test_k6_f32_pack_offsets(fitted):
    """The depthwise taps and BN mul/add the bf16 kernels stage from the
    f32 pack are the modules' (at the offsets the emulation reads)."""
    stage1, _ = fitted
    f32 = unpack_f32(K6.pack_stage1_weights(stage1, SUB))

    def mul_add(bn):
        mul = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        return mul, bn.bias - bn.running_mean * mul

    for want, got in zip(mul_add(stage1[0][1]), f32[0]["bn"]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for i in range(1, 6):
        blk = stage1[i]
        torch.testing.assert_close(
            f32[i]["dw"], blk[0].weight[:, 0].permute(1, 2, 0).reshape(9, -1),
            rtol=0, atol=0)
        for key, bn in (("bn1", blk[1]), ("bn2", blk[4])):
            for want, got in zip(mul_add(bn), f32[i][key]):
                torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("mt", [0, 9, 20])
def test_k6_conv0_fragments_are_the_conv(fitted, mt):
    """segment_mma_first's conv0 m tiles (20: the last, half padding)
    through the fragment layout equal conv0 of the staged frame with the
    split weights (hi + lo), to f32 rounding."""
    stage1, _ = fitted
    frame = np.random.default_rng(mt).integers(0, 256, (37, 37, 3))
    xs = rb(torch.from_numpy(frame).float() - torch.tensor(SUB))
    w0 = mma_mat(K6.pack_stage1_mma_weights(stage1), "conv0")
    got = k6_conv0_tile(xs, w0, mt)
    w = (w0[0] + w0[1])[:, :27].reshape(8, 3, 3, 3).permute(0, 3, 1, 2)
    conv = F.conv2d(xs.permute(2, 0, 1)[None], w, stride=2)[0]  # [8,18,18]
    rows = [min(mt * 16 + i, 323) for i in range(16)]
    want = torch.stack([conv[:, m // 18, m % 18] for m in rows])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("shape", [(1, 640, 640), (2, 97, 131)])
def test_k6_mma_emulation_matches_plain_and_jax(fitted, shape):
    """The bf16 segments on the bench frame (640 px) and on frames where
    every segment's last tile is ragged, against the plain version in f32
    (chip_smoke's bounds) and JAX's planar stage 1 the way
    tests/test_planar_mnet.py holds its bf16 path: within 0.05 x max|ref|
    of its f32 output. On these weights JAX's bf16 path is itself 4-5%
    off that reference; the emulation must be closer to it."""
    stage1, jvars = fitted
    if shape[1] == 640:
        frames = build_frames(*shape[:2], 4)
    else:
        frames = np.random.default_rng(3).integers(0, 256, shape + (3,),
                                                   dtype=np.uint8)
    x = torch.from_numpy(frames)
    got = k6_emulate(stage1, x)
    assert got.shape == (shape[0], *K6.stage1_out_hw(*shape[1:]), 64)
    want = K6.mnet_stage1_plain(stage1, x, SUB, torch.float32)
    rel, rel_max = errors(got, want)
    assert rel <= BF16_REL_L2 and rel_max <= BF16_REL_MAX, (rel, rel_max)
    ref, ref16 = (np.asarray(planar_stage1(
        jvars["params"]["body"]["stage1"],
        jvars["batch_stats"]["body"]["stage1"], jnp.asarray(frames), SUB,
        dtype=dtype), np.float32) for dtype in (None, jnp.bfloat16))
    err = np.abs(got.numpy() - ref).max()
    assert err < 0.05 * np.abs(ref).max()
    assert err < np.abs(ref16 - ref).max()


def precision_table():
    """rel L2 and max/max|ref| of K6's emulated designs against the plain
    f32 version on one bench frame with the fitted weights."""
    stage1 = load_npz(TR.RetinaFaceNet(), TR.WEIGHTS_NPZ).eval().body.stage1
    x = torch.from_numpy(build_frames(1, 640, 4))
    want = K6.mnet_stage1_plain(stage1, x, SUB, torch.float32)
    designs = (("split operands, f32 stage-A maps (the bf16 kernels)",
                "split", False),
               ("bf16 operands, bf16 stage-A maps", "bf16", True),
               ("bf16 operands, f32 stage-A maps", "bf16", False),
               ("f32 operands and maps (the f32 kernel's arithmetic, bf16 "
                "scratch and output)", "f32", False))
    for name, operands, map_bf16 in designs:
        print(f"K6 {name}: rel L2 %.3e, max/max|ref| %.3e"
              % errors(k6_emulate(stage1, x, operands, map_bf16), want))
    with torch.no_grad():
        plain16 = K6.mnet_stage1_plain(stage1, x, SUB, BF)
    print("K6 plain version in bf16: rel L2 %.3e, max/max|ref| %.3e"
          % errors(plain16, want))


if __name__ == "__main__":
    precision_table()
