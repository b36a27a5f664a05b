"""K2: MTCNN stage 1 (PNet) over every pyramid level in one launch.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/pyramid_pnet_pallas.py``
(``pyramid_pnet``). The area-resize pyramid stays plain torch matmuls
(``ops.image.pyramid_planes``), as the JAX package keeps its feed in XLA;
the conv chain runs in ``csrc/pyramid_pnet.cu`` for CUDA tensors and as
the NCHW ``PNet`` forward on each level for CPU tensors.

Both compute in f32, whatever the detector's compute dtype.
"""

import numpy as np
import torch

from ..utils import kernels
from .image import pyramid_planes

TILE = 16  # PNet output cells per tile side (csrc/pyramid_pnet.cu kTile)
N_WEIGHTS = 6632

# packed weight order of csrc/pyramid_pnet.cu: the part the kernel keeps
# in constant memory (conv1, biases, slopes, heads), then conv2 and conv3
# as [in, kh, kw, out] for its shared-memory copy
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


def level_table(batch, sizes):
    """Per-level rows [oh, ow, hc, wc, tiles_x, first tile, input offset,
    output cell offset] (int32) and the total tile count."""
    rows, tile, in_off, out_off = [], 0, 0, 0
    for oh, ow in sizes:
        hc, wc = level_cells(oh, ow)
        if hc < 1 or wc < 1:
            raise ValueError(f"level {oh}x{ow} too small for PNet")
        tx, ty = -(-wc // TILE), -(-hc // TILE)
        rows.append([oh, ow, hc, wc, tx, tile, in_off, out_off])
        tile += batch * tx * ty
        in_off += batch * 3 * oh * ow
        out_off += batch * hc * wc
    if in_off >= 2 ** 31 or out_off * 4 >= 2 ** 31:
        raise ValueError("pyramid too large for 32-bit offsets")
    return np.asarray(rows, dtype=np.int32), tile


@torch.no_grad()
def pnet_chain_plain(pnet, planes):
    """planes: list of raw (0-255) [B, 3, oh, ow] levels -> list of
    (probs1 [B, hc, wc], reg [B, hc, wc, 4]) f32, one NCHW PNet forward
    per level."""
    out = []
    for lvl in planes:
        reg, prob = pnet(normalize(lvl.to(torch.float32)))
        out.append((prob[:, 1], reg.permute(0, 2, 3, 1)))
    return out


@torch.no_grad()
def pnet_chain_kernel(pnet, planes):
    """The same maps from one launch of the CUDA kernel over all levels
    and frames (CUDA tensors only)."""
    dev = planes[0].device
    batch = planes[0].shape[0]
    sizes = [(int(p.shape[2]), int(p.shape[3])) for p in planes]
    for p in planes:
        if p.shape[:2] != (batch, 3):
            raise ValueError("every level must be [B, 3, oh, ow]")
    table_np, n_tiles = level_table(batch, sizes)
    packed = torch.cat([p.to(torch.float32).reshape(-1) for p in planes])
    table = torch.from_numpy(table_np).to(dev)
    weights = pack_weights(pnet).to(dev)
    cells = [batch * hc * wc for hc, wc in
             (level_cells(oh, ow) for oh, ow in sizes)]
    probs = torch.empty(sum(cells), dtype=torch.float32, device=dev)
    reg = torch.empty((sum(cells), 4), dtype=torch.float32, device=dev)
    for name, t in (("levels", packed), ("table", table),
                    ("weights", weights)):
        kernels.require_cuda_tensor(t, name)
    lib = kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vn_pnet_chain(packed.data_ptr(), table.data_ptr(),
                            weights.data_ptr(), probs.data_ptr(),
                            reg.data_ptr(), len(sizes), n_tiles, stream)
    kernels.check_cuda(err, "vn_pnet_chain")
    kernels.count_launch("pnet_chain")
    out, off = [], 0
    for (oh, ow), n in zip(sizes, cells):
        hc, wc = level_cells(oh, ow)
        out.append((probs[off:off + n].view(batch, hc, wc),
                    reg[off:off + n].view(batch, hc, wc, 4)))
        off += n
    return out


def pnet_chain(pnet, planes):
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    if planes[0].is_cuda:
        return pnet_chain_kernel(pnet, planes)
    if planes[0].device.type != "cpu":
        raise ValueError(f"unsupported device {planes[0].device}")
    return pnet_chain_plain(pnet, planes)


def pyramid_pnet(pnet, imgs, sizes):
    """Area-resize pyramid + PNet on every level.

    imgs: [B, H, W, 3] frames (0-255 values); sizes: [(oh, ow), ...].
    Returns per level (probs1 [B, hc, wc], reg [B, hc, wc, 4]) f32.
    """
    planes = pyramid_planes(imgs.to(torch.float32), sizes)
    return pnet_chain(pnet, planes)
