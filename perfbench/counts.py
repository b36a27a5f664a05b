"""The yardstick's arithmetic: the card's peaks, the least time a piece of
work can take on it, and the operations and bytes of the kernels and
networks the benchmark reads, counted from shapes.

The kernels' counters are frozen copies of ``chip_smoke.py``'s
(``bound``, ``bound_3xtf32``, ``stage1_block_flops``,
``mnet_stage1_flops``, ``mnet_segment_work``, ``pnet_flops``,
``trunk_flops``, ``conv_work``, ``warp_footprint_pixels``,
``nms_iou_tests``, ``KERNEL_GRIDS``), the ``*_work`` functions built on
them: every tap of a convolution counts, the padding's too, as the
kernels compute them. The
networks' counter (``model_flops``) counts the multiply-adds of every
convolution and linear layer of a reference network, twice, on the taps
that read the input and not the zero padding (as XLA's cost analysis
counts them), from a forward pass on the meta device: no arithmetic runs.
"""

import math

import torch
from torch import nn

# NVIDIA H100 SXM data-sheet peaks (dense), at the 700 W limit
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32_TC = PEAK_TF32 / 3  # f32-accurate on the tensor cores: 3xTF32
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# the tensor-core rate that work in a configuration's dtype can reach
RATE = {"float32": PEAK_F32_TC, "bfloat16": PEAK_BF16}


def bound_s(nbytes, flops, rate):
    """Least seconds for ``nbytes`` moved and ``flops`` done at ``rate``,
    and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / rate
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# Kernels (frozen copies of chip_smoke.py's counters)
# ---------------------------------------------------------------------------

# (kind, in, out, stride) of MobileNetV1-0.25 stage 1 (K6's function)
STAGE1_SPECS = (
    ("conv_bn", 3, 8, 2),
    ("conv_dw", 8, 16, 1),
    ("conv_dw", 16, 32, 2),
    ("conv_dw", 32, 32, 1),
    ("conv_dw", 32, 64, 2),
    ("conv_dw", 64, 64, 1),
)


def stage1_block_flops(h, w):
    """Multiply-adds x2 of each block of MobileNetV1-0.25 stage 1 on one
    h x w frame."""
    flops = []
    for kind, cin, cout, stride in STAGE1_SPECS:
        if stride == 2:
            h, w = (h + 1) // 2, (w + 1) // 2
        if kind == "conv_bn":
            flops.append(2 * h * w * cout * cin * 9)
        else:
            flops.append(2 * h * w * cin * 9 + 2 * h * w * cin * cout)
    return flops


def mnet_stage1_flops(h, w):
    """Multiply-adds x2 of MobileNetV1-0.25 stage 1 on one h x w frame."""
    return sum(stage1_block_flops(h, w))


def mnet_stage1_work(b, h, w, itemsize):
    """(bytes, FLOPs) of stage 1 as one function on b u8 frames: the
    frames read once, the [b, h/8, w/8, 64] output written once."""
    ho, wo = h, w
    for _ in range(3):
        ho, wo = (ho + 1) // 2, (wo + 1) // 2
    return (b * (h * w * 3 + ho * wo * 64 * itemsize),
            b * mnet_stage1_flops(h, w))


def level_cells(oh, ow):
    """PNet output cells (hc, wc) of an oh x ow pyramid level."""
    return -(-(oh - 2) // 2) - 4, -(-(ow - 2) // 2) - 4


def pnet_flops(sizes):
    """Multiply-adds x2 of PNet's convs on every pyramid level."""
    flops = 0
    for oh, ow in sizes:
        hc, wc = level_cells(oh, ow)
        flops += 2 * (oh - 2) * (ow - 2) * 10 * 27
        flops += 2 * (hc + 2) * (wc + 2) * 16 * 90
        flops += 2 * hc * wc * (32 * 144 + 6 * 32)
    return flops


def pnet_chain_work(b, h, w, sizes):
    """(bytes, FLOPs) of K2 on b frames: the int32 integral image read
    once, 5 f32 outputs a PNet cell written once."""
    cells = sum(math.prod(level_cells(*s)) for s in sizes)
    return b * ((h + 1) * (w + 1) * 3 * 4 + cells * 5 * 4), b * pnet_flops(
        sizes)


# (crop side, conv1 channels, conv2 channels) of the R/ONet trunks (K5)
TRUNKS = {"rnet": (24, 28, 48), "onet": (48, 32, 64)}


def trunk_geometry(net):
    size, c1, c2 = TRUNKS[net]
    conv1_out = size - 2
    pooled = (conv1_out - 2) // 2 + 1
    return size, c1, c2, conv1_out, pooled - 2


def trunk_flops(net):
    """Multiply-adds x2 of one crop's conv1 and conv2."""
    size, c1, c2, conv1_out, out = trunk_geometry(net)
    return 2 * (conv1_out * conv1_out * c1 * 27 + out * out * c2 * 9 * c1)


def trunk_work(net, n, itemsize):
    """(bytes, FLOPs) of K5 on n crops: crops in, trunk output out."""
    size, c1, c2, _, out = trunk_geometry(net)
    return (n * itemsize * (size * size * 3 + out * out * c2),
            n * trunk_flops(net))


def conv_work(m, c, p):
    """(FLOPs, bytes) of conv1, conv2 and conv3 of one bottleneck block
    over m pixels: each launch's inputs read once and its output written
    once (bf16)."""
    return {"conv1": (2 * m * c * p, 2 * (m * c + m * p + c * p)),
            "conv2": (2 * m * 9 * p * p, 2 * (2 * m * p + 9 * p * p)),
            "conv3": (2 * m * p * c, 2 * (m * p + 2 * m * c + p * c))}


# the emotion net's K8 chains: (side, C, P, blocks) of layer1's and
# layer2's tails at 224 px
EMOTION_TAILS = ((56, 256, 64, 2), (28, 512, 128, 3))


def bottleneck_chain_work(k, itemsize, tails=EMOTION_TAILS):
    """(bytes, FLOPs) of K8 on k faces, each chain as one function: its
    input read once, its output and its weights written and read once."""
    nbytes = flops = 0
    for side, c, p, blocks in tails:
        pix = k * side * side
        flops += blocks * pix * 2 * (2 * c * p + 9 * p * p)
        nbytes += itemsize * (2 * pix * c + blocks * (2 * c * p + 9 * p * p))
    return nbytes, flops


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------


def _valid_taps(n_in, n_out, k, s, p, d):
    """Sum over the outputs of one axis of the taps that fall inside the
    input."""
    total = 0
    for o in range(n_out):
        start = o * s - p
        total += sum(1 for t in range(k) if 0 <= start + t * d < n_in)
    return total


def model_flops(module, *shape):
    """Multiply-adds x2 of every Conv2d (the taps that read the input) and
    Linear in ``module`` on one input of ``shape``, from a forward pass on
    the meta device."""
    total = [0]

    def conv_hook(m, inputs, out):
        x = inputs[0]
        taps = 1
        for ax in range(2):
            taps *= _valid_taps(x.shape[2 + ax], out.shape[2 + ax],
                                m.kernel_size[ax], m.stride[ax],
                                m.padding[ax], m.dilation[ax])
        total[0] += (2 * out.shape[0] * taps * m.out_channels
                     * (m.in_channels // m.groups))

    def linear_hook(m, inputs, out):
        total[0] += 2 * out.numel() * m.in_features

    hooks = []
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            hooks.append(m.register_forward_hook(conv_hook))
        elif isinstance(m, nn.Linear):
            hooks.append(m.register_forward_hook(linear_hook))
    try:
        with torch.no_grad():
            module(torch.zeros(shape, device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def meta_module(make):
    with torch.device("meta"):
        return make().eval()


# the device functions each kernel's wrapper launches, by name in the
# profiler's trace (a frozen copy of chip_smoke.py's KERNEL_GRIDS)
KERNEL_GRIDS = {
    "pnet_chain": ("pnet_frames_f32", "pnet_frames_mma"),
    "similarity_warp": ("similarity_warp_kernel",),
    "mnet_stage1": ("segment_tf32_first", "segment_tf32",
                    "segment_mma_first", "segment_mma"),
    "emotion_stem": ("emotion_stem_tf32x3", "emotion_stem_mma"),
    "bottleneck_chain": ("conv_gemm_bf16", "conv_gemm_tf32x3"),
    "nms_keep_mask": ("nms_keep_tiled",),
    "crop_area_resize": ("band_totals_kernel", "band_scan_kernel",
                         "crop_pool_kernel"),
    "crop_net_trunk": ("crop_net_trunk_mma", "crop_net_trunk_tf32x3"),
}
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def bound_3xtf32_s(nbytes, flops):
    """The least seconds of f32-accurate work: bytes at the memory rate,
    ``flops`` in 3xTF32 (three TF32 products each) at the TF32 peak."""
    return bound_s(nbytes, 3 * flops, PEAK_TF32)


def mnet_segment_work(b, h, w, itemsize=2):
    """(bytes, FLOPs) of K6's three launches on b h x w frames: each reads
    its input once (u8 frames, then the scratch) and writes its output
    once (bf16, or f32 with ``itemsize`` 4), and does the FLOPs of its two
    blocks."""
    flops = stage1_block_flops(h, w)
    sides, sizes = [(h, w)], [3]
    for c in (16, 32, 64):
        h, w = (h + 1) // 2, (w + 1) // 2
        sides.append((h, w))
        sizes.append(itemsize * c)
    work = {}
    for i in range(3):
        (hi, wi), (ho, wo) = sides[i], sides[i + 1]
        nbytes = b * (hi * wi * sizes[i] + ho * wo * sizes[i + 1])
        work[f"segment {i + 1}"] = (nbytes,
                                    b * (flops[2 * i] + flops[2 * i + 1]))
    return work


def warp_footprint_pixels(mats, win, out_size, frames_at=None):
    """Distinct source pixels that valid bilinear taps read: what K1's warp
    must fetch at least once. Without ``frames_at`` each face's window is
    its own source; with ``frames_at = (image_idx, oy, ox, (B, H, W))``
    the windows lie in shared frames and a frame pixel that several
    windows' taps read counts once."""
    from perfbench.reference.align import source_coords

    k, dev = mats.shape[0], mats.device
    sx, sy = source_coords(mats.to(torch.float32), out_size)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    if frames_at is None:
        row0 = torch.arange(k, device=dev)[:, None, None] * win
        col0, width, size = 0, win, k * win * win
    else:
        image_idx, oy, ox, (b, h, w) = frames_at
        row0 = (image_idx.long() * h + oy.long())[:, None, None]
        col0, width, size = ox.long()[:, None, None], w, b * h * w
    seen = torch.zeros(size, dtype=torch.bool, device=dev)
    for dy in (0, 1):
        for dx in (0, 1):
            y, x = y0 + dy, x0 + dx
            ok = (y >= 0) & (y <= win - 1) & (x >= 0) & (x <= win - 1)
            idx = (row0 + y.clamp(0, win - 1).long()) * width + col0 \
                + x.clamp(0, win - 1).long()
            seen[idx[ok]] = True
    return int(seen.sum())


def nms_iou_tests(boxes, scores, valid, keep, thr, offset, min_mode):
    """IoU tests K3's greedy scan needs on these sets: each valid box is
    tested against the kept boxes ahead of it, up to the first one that
    suppresses it."""
    from perfbench.reference.detect import iou

    k = scores.shape[1]
    s = torch.where(valid, scores,
                    torch.tensor(float("-inf"), device=scores.device))
    idx = torch.arange(k, device=scores.device)
    ahead = (s[:, :, None] > s[:, None, :]) | (
        (s[:, :, None] == s[:, None, :]) & (idx[:, None] < idx[None, :]))
    ahead &= keep[:, :, None] & valid[:, None, :]            # [N, j, i]
    rank = ahead.sum(1)  # boxes kept ahead of i; a kept j's rank is its own
    sup = ahead & (iou(boxes, boxes, offset, min_mode) > thr)
    big = torch.full_like(rank, k + 1)
    first = torch.where(sup, rank[:, :, None], big[:, :, None]).amin(1)
    return int((ahead & (rank[:, :, None] <= first[:, None, :])).sum())
