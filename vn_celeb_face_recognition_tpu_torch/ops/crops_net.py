"""K5: the MTCNN RNet/ONet trunks on batched crops.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/crops_net_pallas.py``
(``crop_net_trunk``, via ``rnet_apply_fused`` and ``onet_apply_fused``):
conv1 3x3 + PReLU + ceil-mode max pool 3x3/2 + conv2 3x3 + PReLU on
normalised NHWC crops, [N, 24, 24, 3] -> [N, 9, 9, 48] (RNet) and
[N, 48, 48, 3] -> [N, 21, 21, 64] (ONet). ``RNet.forward`` and
``ONet.forward`` run their trunk through ``crop_net_trunk`` and then
their tails.

For CUDA tensors the trunk is one launch of ``csrc/crop_net_trunk.cu``,
on the tensor cores in both dtypes: persistent blocks hold the packed
weights in shared memory, conv1 runs as a small GEMM (its bias carried by
a column of ones) band by band into an NHWC pooled map, and conv2 as an
implicit GEMM over that map. bf16 crops take ``crop_net_trunk_mma``
(bf16 products with f32 sums, the pooled map rounded to bf16, weights
from ``pack_trunk_weights_mma``); f32 crops, the dtype of every shipped
config, take ``crop_net_trunk_tf32x3``, whose products split each f32
operand into two TF32 halves (3xTF32, f32-accurate) and whose pooled map
stays f32 (weights from ``pack_trunk_weights_tf32x3``). For CPU tensors
it is ``crop_net_trunk_plain``, the net's own modules in the crops'
dtype. The TPU kernel's space-to-depth packing and subposition matrix
are not carried over.
"""

import torch

from ..models.layers import conv, max_pool_ceil, prelu
from ..utils import kernels


class CropNetSpec:
    """Geometry of one net's trunk: crop side, conv1/conv2 channels, the
    kernel's net id and the pooled rows per conv1 band it computes
    (``csrc/crop_net_trunk.cu`` instantiates the same values). conv1 is
    valid 3x3, the pool is ceil-mode 3x3/2 and conv2 is valid 3x3."""

    def __init__(self, name, size, c1, c2, net_id, band):
        self.name, self.size, self.c1, self.c2 = name, size, c1, c2
        self.net_id, self.band = net_id, band
        self.conv1_out = size - 2
        self.pooled = (self.conv1_out - 2) // 2 + 1
        self.out = self.pooled - 2

    def n_weights(self):
        return 27 * self.c1 + 2 * self.c1 + 9 * self.c1 * self.c2 \
            + 2 * self.c2


# the kernel's operand layout (csrc/crop_net_trunk.cu): conv1 channels
# padded to MMA_C1, w1 rows [MMA_C1][MMA_K1P] over k = (ky*3 + kx)*3 + ci
# (27 used; k = 27 holds the bias), w2 rows [C2][MMA_K2P] over
# k = (ky*3 + kx)*MMA_C1 + ci, and
# the pooled map NHWC with MMA_C1 channels a pixel (the bf16 grid's k16
# steps of conv2 are one tap x 16 channels each, the f32 grid's k8 steps
# one tap x 8 channels)
MMA_C1, MMA_K1P = 32, 40
MMA_K2 = 9 * MMA_C1
MMA_K2P = MMA_K2 + 8
# conv1 bands of both kernels, in pooled rows
MMA_BAND = 2
# the f32 kernel's operands: the same k orders, f32 rows of 36 and 292
# floats (an odd number of 16-byte units, so ldmatrix rows of eight
# neighbours fall in distinct bank groups)
TF32_K1P, TF32_K2P = MMA_C1 + 4, MMA_K2 + 4

# 24 -> 22 -> 11 -> 9 and 48 -> 46 -> 23 -> 21
RNET_SPEC = CropNetSpec("rnet", 24, 28, 48, 0, MMA_BAND)
ONET_SPEC = CropNetSpec("onet", 48, 32, 64, 1, MMA_BAND)


def _check(net, crops, spec):
    s = spec.size
    if crops.dim() != 4 or tuple(crops.shape[1:]) != (s, s, 3):
        raise ValueError(f"{spec.name} crops must be [N, {s}, {s}, 3], got "
                         f"{tuple(crops.shape)}")
    _check_weights(net, spec)


def _check_weights(net, spec):
    if tuple(net.conv1.weight.shape) != (spec.c1, 3, 3, 3) or tuple(
            net.conv2.weight.shape) != (spec.c2, spec.c1, 3, 3):
        raise ValueError(f"the net's conv1/conv2 do not match {spec.name}")


@torch.no_grad()
def pack_trunk_weights(net, spec):
    """conv1/prelu1/conv2/prelu2 -> [n_weights] f32, tap-major and
    unpadded: w1 [(ky*3 + kx)*3 + ci][C1], b1, a1, w2 [(ky*3 + kx)*C1 + ci]
    [C2], b2, a2 (the flat layout that the kernels' packings are held
    to)."""
    parts = [net.conv1.weight.permute(2, 3, 1, 0).reshape(-1),
             net.conv1.bias, net.prelu1.weight,
             net.conv2.weight.permute(2, 3, 1, 0).reshape(-1),
             net.conv2.bias, net.prelu2.weight]
    flat = torch.cat([p.reshape(-1).to(torch.float32) for p in parts])
    if flat.numel() != spec.n_weights():
        raise ValueError(f"{spec.name} has {flat.numel()} trunk weights, "
                         f"the spec expects {spec.n_weights()}")
    return flat.contiguous()


def _gemm_operands(net, spec, k1p, k2p):
    """The GEMM kernels' operands in f32: w1 [MMA_C1][k1p] with conv1's
    bias in column 27, w2 [C2][k2p] (K-major B rows; padded channels, taps
    and columns are zero) and the parameters a1[MMA_C1], b2[C2], a2[C2]."""
    c1, c2 = spec.c1, spec.c2
    _check_weights(net, spec)
    w1 = torch.zeros((MMA_C1, k1p))
    w1[:c1, :27] = net.conv1.weight.permute(0, 2, 3, 1).reshape(c1, 27)
    w1[:c1, 27] = net.conv1.bias
    taps = torch.zeros((c2, 9, MMA_C1))
    taps[:, :, :c1] = net.conv2.weight.permute(0, 2, 3, 1).reshape(c2, 9, c1)
    w2 = torch.zeros((c2, k2p))
    w2[:, :MMA_K2] = taps.reshape(c2, MMA_K2)
    par = torch.zeros(MMA_C1 + 2 * c2)
    for off, p in ((0, net.prelu1.weight), (MMA_C1, net.conv2.bias),
                   (MMA_C1 + c2, net.prelu2.weight)):
        par[off:off + p.numel()] = p.reshape(-1)
    return w1, w2, par


@torch.no_grad()
def pack_trunk_weights_mma(net, spec):
    """The bf16 kernel's weights as one byte buffer: w1 [MMA_C1][MMA_K1P]
    bf16 with conv1's bias in column 27 (the kernel's A has a column of
    ones there), w2 [C2][MMA_K2P] bf16 (K-major B operands; padded
    channels, taps and columns are zero), then f32 a1[MMA_C1], b2[C2],
    a2[C2] holding bf16 values, as the plain bf16 version casts its
    parameters."""
    w1, w2, par = _gemm_operands(net, spec, MMA_K1P, MMA_K2P)
    bf16 = torch.bfloat16
    return torch.cat([w1.to(bf16).reshape(-1).view(torch.uint8),
                      w2.to(bf16).reshape(-1).view(torch.uint8),
                      par.to(bf16).to(torch.float32).view(torch.uint8)])


@torch.no_grad()
def pack_trunk_weights_tf32x3(net, spec):
    """The f32 kernel's weights as one f32 buffer, the bf16 kernel's
    operands at the f32 pitches and unrounded: w1 [MMA_C1][TF32_K1P] with
    conv1's bias in column 27, w2 [C2][TF32_K2P], then a1[MMA_C1], b2[C2],
    a2[C2]."""
    w1, w2, par = _gemm_operands(net, spec, TF32_K1P, TF32_K2P)
    return torch.cat([w1.reshape(-1), w2.reshape(-1), par])


@torch.no_grad()
def crop_net_trunk_plain(net, crops, spec):
    """The net's own conv1/prelu1/pool/conv2/prelu2 on NHWC crops, in the
    crops' dtype; returns NHWC [N, out, out, C2]."""
    _check(net, crops, spec)
    x = crops.permute(0, 3, 1, 2)
    x = prelu(net.prelu1, conv(net.conv1, x))
    x = max_pool_ceil(x, 3, 2)
    x = prelu(net.prelu2, conv(net.conv2, x))
    return x.permute(0, 2, 3, 1)


@torch.no_grad()
def crop_net_trunk_kernel(net, crops, spec):
    """The same trunk from one launch of the CUDA kernel (CUDA tensors,
    f32 or bf16)."""
    _check(net, crops, spec)
    dtype = crops.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute dtype {dtype}")
    crops = crops.contiguous()
    kernels.require_cuda_tensor(crops, "crops", dtype)
    dev = crops.device
    bf16 = dtype == torch.bfloat16
    if crops.data_ptr() % 16:  # the kernel stages crops in 16-byte rows
        crops = crops.clone()
    pack = pack_trunk_weights_mma if bf16 else pack_trunk_weights_tf32x3
    weights = kernels.cached_fold(
        net, ("crop_net_trunk", str(dev), str(dtype)),
        lambda: pack(net, spec).to(dev))
    n = crops.shape[0]
    out = torch.empty((n, spec.out, spec.out, spec.c2), dtype=dtype,
                      device=dev)
    if n == 0:
        return out
    lib = kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vn_crop_net_trunk(crops.data_ptr(), weights.data_ptr(),
                                out.data_ptr(), n, spec.net_id, int(bf16),
                                stream)
    kernels.check_cuda(err, "vn_crop_net_trunk")
    kernels.count_launch("crop_net_trunk")
    return out


def crop_net_trunk(net, crops, spec):
    """Normalised NHWC crops [N, S, S, 3] -> NHWC trunk features
    [N, out, out, C2] in the crops' dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if crops.is_cuda:
        return crop_net_trunk_kernel(net, crops, spec)
    if crops.device.type != "cpu":
        raise ValueError(f"unsupported device {crops.device}")
    return crop_net_trunk_plain(net, crops, spec)
