"""K2: the area-resize pyramid and MTCNN stage 1 (PNet) over every level,
in one launch.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/pyramid_pnet_pallas.py``
(``pyramid_pnet``, its pyramid feed included): frames -> every level's
PNet maps, in the detector's compute dtype. For CUDA tensors
``csrc/pyramid_pnet.cu`` reads each level pixel as four corners of the
chunk's integral image (``ops.crop.integral_image``, which the cascade
builds once for stage 1 and both crop stages), so no level reaches device
memory: a bf16 grid with its three convolutions on the tensor cores
(``mma.sync``) for bf16 detectors, an f32 grid on the CUDA cores for f32
ones. For CPU tensors the plain version runs the exact area resize
(``ops.image.pyramid_planes``) and the NCHW ``PNet`` forward per level,
in the same dtype: in bf16 with the bf16 grid's rounding points (the
normalised level, conv1 + PReLU + pool and conv2 + PReLU rounded to bf16;
conv2 and conv3 weights in bf16; the sums and the rest in f32), so a bf16
detector computes one function on the CPU and on the card.
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import kernels
from . import crop as _crop
from .image import pyramid_planes

TILE = 16  # PNet output cells per tile side (csrc/pyramid_pnet.cu kTile)
N_WEIGHTS = 6632
N_CONST = 584  # the small parameters, passed in the kernel's parameters
MAX_LEVELS = 32
# the bf16 grid's GEMM operands (pack_weights_mma): w1 rows [16][MMA_K1P]
# over k = (ky*3 + kx)*4 + ci (36 used, K = MMA_K1), w2 rows [16][MMA_K2P]
# over k = (ky*3 + kx)*10 + ci (90 used, K = MMA_K2), w3 rows
# [32][MMA_K3P] over k = (ky*3 + kx)*16 + ci
MMA_K1, MMA_K1P = 48, 56
MMA_K2, MMA_K2P, MMA_K3, MMA_K3P = 96, 104, 144, 152

# packed weight order of csrc/pyramid_pnet.cu: the small parameters
# (conv1, biases, slopes, heads), then conv2 and conv3 as
# [in, kh, kw, out] for the f32 grid's shared-memory copy
_CONST_KEYS = (
    "conv1.weight", "conv1.bias", "prelu1.weight",
    "conv2.bias", "prelu2.weight", "conv3.bias", "prelu3.weight",
    "conv4_1.weight", "conv4_1.bias", "conv4_2.weight", "conv4_2.bias",
)
_IHWO_KEYS = ("conv2.weight", "conv3.weight")


def normalize(x):
    return (x - 127.5) * 0.0078125


def level_cells(oh, ow):
    """PNet output cells (hc, wc) of an oh x ow level: conv1 (valid 3x3),
    ceil 2x2/2 pool, then two valid 3x3 convs."""
    return -(-(oh - 2) // 2) - 4, -(-(ow - 2) // 2) - 4


def pack_weights(pnet):
    """PNet parameters -> [6632] f32 in the kernel's packed order."""
    sd = pnet.state_dict()
    parts = [sd[k].reshape(-1) for k in _CONST_KEYS]
    parts += [sd[k].permute(1, 2, 3, 0).reshape(-1) for k in _IHWO_KEYS]
    flat = torch.cat(parts).to(torch.float32)
    if flat.numel() != N_WEIGHTS:
        raise ValueError(f"PNet has {flat.numel()} weights, the kernel "
                         f"expects {N_WEIGHTS}")
    return flat


def _bf16_rows(w, n, kp, ci_pad=None):
    """OIHW conv weights -> [n][kp] f32 rows over k = (ky*kw + kx)*ci + ci
    (``ci_pad`` input channels a tap when given), zero-padded."""
    co, ci, kh, kw = w.shape
    taps = w.permute(0, 2, 3, 1).reshape(co, kh * kw, ci)
    if ci_pad is not None:
        taps = F.pad(taps, (0, ci_pad - ci))
    out = torch.zeros((n, kp), dtype=torch.float32)
    out[:co, :taps[0].numel()] = taps.reshape(co, -1)
    return out


def pack_weights_mma(pnet):
    """The bf16 grid's weights as one byte buffer of bf16 B operands,
    K-major over (ky, kx, ci) with zero padding: conv1 rows [16][MMA_K1P]
    (4 channels a tap) split into hi then lo (hi + lo keeps the f32
    weights), conv2 rows [16][MMA_K2P], conv3 rows [32][MMA_K3P]; then the
    584 small parameters in f32 (``pack_weights[:584]``)."""
    with torch.no_grad():
        w1 = _bf16_rows(pnet.conv1.weight.cpu(), 16, MMA_K1P, ci_pad=4)
        hi = w1.to(torch.bfloat16)
        lo = (w1 - hi.to(torch.float32)).to(torch.bfloat16)
        b = torch.cat([hi.reshape(-1), lo.reshape(-1)] + [
            _bf16_rows(m.weight.cpu(), n, kp).to(torch.bfloat16).reshape(-1)
            for m, n, kp in ((pnet.conv2, 16, MMA_K2P),
                             (pnet.conv3, 32, MMA_K3P))])
    small = pack_weights(pnet)[:N_CONST].cpu()
    return torch.cat([b.view(torch.uint8), small.view(torch.uint8)])


@lru_cache(maxsize=64)
def level_table(batch, sizes):
    """The kernel's frame-major tile order: per-level rows [oh, ow, hc,
    wc, tiles_x, first tile within a frame, first output cell, 0] (int32,
    read-only) and the total tile count (``batch`` x the tiles of one
    frame's levels). Output cells are [B, hc, wc] blocks, level after
    level."""
    rows, tile, out_off = [], 0, 0
    for oh, ow in sizes:
        hc, wc = level_cells(oh, ow)
        if hc < 1 or wc < 1:
            raise ValueError(f"level {oh}x{ow} too small for PNet")
        tx, ty = -(-wc // TILE), -(-hc // TILE)
        rows.append([oh, ow, hc, wc, tx, tile, out_off, 0])
        tile += tx * ty
        out_off += batch * hc * wc
    if len(rows) > MAX_LEVELS:
        raise ValueError(f"{len(rows)} pyramid levels, the kernel takes at "
                         f"most {MAX_LEVELS}")
    if out_off * 4 >= 2 ** 31 or batch * tile >= 2 ** 31:
        raise ValueError("pyramid too large for 32-bit offsets")
    table = np.asarray(rows, dtype=np.int32).reshape(-1, 8)
    table.flags.writeable = False
    return table, batch * tile


def _bf16(x):
    """``x`` rounded to bf16, kept in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _pnet_bf16(pnet, x):
    """PNet with the bf16 grid's rounding points: the normalised level
    ``x``, conv1 + PReLU + pool and conv2 + PReLU rounded to bf16, conv2
    and conv3 weights in bf16; every sum, conv1's weights, the biases,
    PReLU, the heads and the softmax in f32."""
    def conv(m, v, w=None):
        return F.conv2d(v, m.weight if w is None else w, m.bias)

    def act(m, v):
        return F.prelu(v, m.weight)

    x = act(pnet.prelu1, conv(pnet.conv1, _bf16(x)))
    x = _bf16(F.max_pool2d(x, 2, 2, ceil_mode=True))
    x = _bf16(act(pnet.prelu2, conv(pnet.conv2, x, _bf16(pnet.conv2.weight))))
    x = act(pnet.prelu3, conv(pnet.conv3, x, _bf16(pnet.conv3.weight)))
    return conv(pnet.conv4_2, x), torch.softmax(conv(pnet.conv4_1, x), dim=1)


@torch.no_grad()
def pnet_chain_plain(pnet, planes, dtype=torch.float32):
    """planes: list of raw (0-255) [B, 3, oh, ow] levels -> list of
    (probs1 [B, hc, wc], reg [B, hc, wc, 4]) f32, one NCHW PNet forward
    per level: in f32, or in bf16 with the kernel's rounding points
    (``_pnet_bf16``)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute dtype {dtype}")
    out = []
    for lvl in planes:
        x = normalize(lvl.to(torch.float32))
        reg, prob = pnet(x) if dtype == torch.float32 else _pnet_bf16(pnet, x)
        out.append((prob[:, 1], reg.permute(0, 2, 3, 1)))
    return out


def pyramid_pnet_plain(pnet, frames, sizes, dtype=torch.float32):
    """The plain version: exact area-resize levels (f32 matmuls against
    the pooling matrices) and PNet per level in ``dtype``."""
    _check_frames(frames)
    planes = pyramid_planes(frames.to(torch.float32), sizes)
    return pnet_chain_plain(pnet, planes, dtype)


def _check_frames(frames):
    if frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be [B, H, W, 3], got "
                         f"{tuple(frames.shape)}")


def _fold(pnet, dev, mma):
    """(the 584 small parameters in host memory, the grid's conv2/conv3
    weights on ``dev``), packed once per module state."""
    def fold():
        flat = pack_weights(pnet).cpu()
        dense = pack_weights_mma(pnet) if mma else flat[N_CONST:]
        return flat[:N_CONST].clone(), dense.to(dev)

    return kernels.cached_fold(
        pnet, ("pyramid_pnet", str(dev), "bf16" if mma else "f32"), fold)


@torch.no_grad()
def pyramid_pnet_kernel(pnet, frames, sizes, integ=None,
                        dtype=torch.float32):
    """The same maps from one launch of the CUDA kernel over every level
    of every frame (CUDA tensors only), read from ``integ``, the frames'
    int32 integral image [B, H+1, W+1, 3] (built here, by K4, when it is
    not given). ``dtype`` bf16 takes the tensor-core grid, f32 the f32
    grid."""
    _check_frames(frames)
    if not frames.is_cuda:  # only its shape is read: any layout will do
        raise ValueError("frames must be a CUDA tensor")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute dtype {dtype}")
    b, h, w = (int(s) for s in frames.shape[:3])
    dev = frames.device
    if integ is None:
        integ = _crop.integral_image(frames)
    if tuple(integ.shape) != (b, h + 1, w + 1, 3):
        raise ValueError(f"integ must be [{b}, {h + 1}, {w + 1}, 3], got "
                         f"{tuple(integ.shape)}")
    kernels.require_cuda_tensor(integ, "integ", torch.int32)
    sizes = tuple((int(oh), int(ow)) for oh, ow in sizes)
    for oh, ow in sizes:  # the kernel's window arithmetic is uint32
        if (oh + 1) * h >= 2 ** 32 or (ow + 1) * w >= 2 ** 32:
            raise ValueError(f"level {oh}x{ow} of a {h}x{w} frame is too "
                             "large for the kernel")
    table, n_tiles = level_table(b, sizes)
    mma = dtype == torch.bfloat16
    cw, weights = _fold(pnet, dev, mma)
    cells = [b * hc * wc for hc, wc in
             (level_cells(oh, ow) for oh, ow in sizes)]
    probs = torch.empty(sum(cells), dtype=torch.float32, device=dev)
    reg = torch.empty((sum(cells), 4), dtype=torch.float32, device=dev)
    if b > 0:
        lib = kernels.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vn_pyramid_pnet(integ.data_ptr(), cw.data_ptr(),
                                  table.ctypes.data, weights.data_ptr(),
                                  probs.data_ptr(), reg.data_ptr(), b, h, w,
                                  len(sizes), n_tiles // b, int(mma), stream)
        kernels.check_cuda(err, "vn_pyramid_pnet")
        kernels.count_launch("pnet_chain")
    out, off = [], 0
    for (oh, ow), n in zip(sizes, cells):
        hc, wc = level_cells(oh, ow)
        out.append((probs[off:off + n].view(b, hc, wc),
                    reg[off:off + n].view(b, hc, wc, 4)))
        off += n
    return out


def pyramid_pnet(pnet, frames, sizes, integ=None, dtype=torch.float32):
    """Area-resize pyramid + PNet on every level.

    frames: [B, H, W, 3] uint8 (or 0-255 float) frames; sizes: [(oh, ow),
    ...]; integ: their integral image (CUDA only; built when None);
    dtype: the compute dtype (f32 or bf16). Returns per level (probs1
    [B, hc, wc], reg [B, hc, wc, 4]) f32. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise).
    """
    if frames.is_cuda:
        return pyramid_pnet_kernel(pnet, frames, sizes, integ, dtype)
    if frames.device.type != "cpu":
        raise ValueError(f"unsupported device {frames.device}")
    return pyramid_pnet_plain(pnet, frames, sizes, dtype)
