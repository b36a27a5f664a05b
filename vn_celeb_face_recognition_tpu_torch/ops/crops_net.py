"""K5: the MTCNN RNet/ONet trunks on batched crops.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/crops_net_pallas.py``
(``crop_net_trunk``, via ``rnet_apply_fused`` and ``onet_apply_fused``):
conv1 3x3 + PReLU + ceil-mode max pool 3x3/2 + conv2 3x3 + PReLU on
normalised NHWC crops, [N, 24, 24, 3] -> [N, 9, 9, 48] (RNet) and
[N, 48, 48, 3] -> [N, 21, 21, 64] (ONet). ``RNet.forward`` and
``ONet.forward`` run their trunk through ``crop_net_trunk`` and then
their tails.

For CUDA tensors the trunk is one launch of ``csrc/crop_net_trunk.cu``:
in bf16 on the tensor cores (persistent blocks, the weights packed by
``pack_trunk_weights_mma`` resident in shared memory, conv1 as a small
GEMM, conv2 as an implicit GEMM over the NHWC pooled map rounded to
bf16), in f32 on the CUDA cores (one thread block per crop, f32 sums,
``pack_trunk_weights``). For CPU tensors it is ``crop_net_trunk_plain``,
the net's own modules in the crops' dtype. The TPU kernel's
space-to-depth packing and subposition matrix are not carried over.
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


RNET_SPEC = CropNetSpec("rnet", 24, 28, 48, 0, 11)  # 24 -> 22 -> 11 -> 9
ONET_SPEC = CropNetSpec("onet", 48, 32, 64, 1, 4)   # 48 -> 46 -> 23 -> 21

# the bf16 kernel's operand layout (csrc/crop_net_trunk.cu): conv1 channels
# padded to MMA_C1, w1 rows [MMA_C1][MMA_K1P] over k = (ky*3 + kx)*3 + ci
# (27 used; k = 27 holds the bias), w2 rows [C2][MMA_K2P] over
# k = (ky*3 + kx)*MMA_C1 + ci, and
# the pooled map NHWC with MMA_C1 channels a pixel (the k16 steps of conv2
# are one tap x 16 channels each)
MMA_C1, MMA_K1P = 32, 40
MMA_K2 = 9 * MMA_C1
MMA_K2P = MMA_K2 + 8
# conv1 bands of the bf16 kernel, in pooled rows
MMA_BAND = 2


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
    """conv1/prelu1/conv2/prelu2 -> [n_weights] f32 in the f32 kernel's
    order: w1 [(ky*3 + kx)*3 + ci][C1], b1, a1, w2 [(ky*3 + kx)*C1 + ci]
    [C2], b2, a2."""
    parts = [net.conv1.weight.permute(2, 3, 1, 0).reshape(-1),
             net.conv1.bias, net.prelu1.weight,
             net.conv2.weight.permute(2, 3, 1, 0).reshape(-1),
             net.conv2.bias, net.prelu2.weight]
    flat = torch.cat([p.reshape(-1).to(torch.float32) for p in parts])
    if flat.numel() != spec.n_weights():
        raise ValueError(f"{spec.name} has {flat.numel()} trunk weights, "
                         f"the kernel expects {spec.n_weights()}")
    return flat.contiguous()


@torch.no_grad()
def pack_trunk_weights_mma(net, spec):
    """The bf16 kernel's weights as one byte buffer: w1 [MMA_C1][MMA_K1P]
    bf16 with conv1's bias in column 27 (the kernel's A has a column of
    ones there), w2 [C2][MMA_K2P] bf16 (K-major B operands; padded
    channels, taps and columns are zero), then f32 a1[MMA_C1], b2[C2],
    a2[C2] holding bf16 values, as the plain bf16 version casts its
    parameters."""
    c1, c2 = spec.c1, spec.c2
    _check_weights(net, spec)
    w1 = torch.zeros((MMA_C1, MMA_K1P), dtype=torch.bfloat16)
    w1[:c1, :27] = net.conv1.weight.permute(0, 2, 3, 1).reshape(c1, 27)
    w1[:c1, 27] = net.conv1.bias
    w2 = torch.zeros((c2, 9, MMA_C1), dtype=torch.bfloat16)
    w2[:, :, :c1] = net.conv2.weight.permute(0, 2, 3, 1).reshape(c2, 9, c1)
    w2 = torch.cat([w2.reshape(c2, MMA_K2),
                    torch.zeros((c2, MMA_K2P - MMA_K2), dtype=torch.bfloat16)],
                   1)
    par = torch.zeros(MMA_C1 + 2 * c2)
    for off, p in ((0, net.prelu1.weight), (MMA_C1, net.conv2.bias),
                   (MMA_C1 + c2, net.prelu2.weight)):
        par[off:off + p.numel()] = p.reshape(-1).to(torch.bfloat16)
    return torch.cat([w1.reshape(-1).view(torch.uint8),
                      w2.reshape(-1).view(torch.uint8), par.view(torch.uint8)])


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
    pack = pack_trunk_weights_mma if bf16 else pack_trunk_weights
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
