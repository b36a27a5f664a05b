"""K5: the MTCNN RNet/ONet trunks on batched crops.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/crops_net_pallas.py``
(``crop_net_trunk``, via ``rnet_apply_fused`` and ``onet_apply_fused``):
conv1 3x3 + PReLU + ceil-mode max pool 3x3/2 + conv2 3x3 + PReLU on
normalised NHWC crops, [N, 24, 24, 3] -> [N, 9, 9, 48] (RNet) and
[N, 48, 48, 3] -> [N, 21, 21, 64] (ONet). ``RNet.forward`` and
``ONet.forward`` run their trunk through ``crop_net_trunk`` and then
their tails.

For CUDA tensors the trunk is one launch of ``csrc/crop_net_trunk.cu``
(one thread block per crop, f32 sums; f32 or bf16 in and out, with the
weights rounded to bf16 on the bf16 path). For CPU tensors it is
``crop_net_trunk_plain``, the net's own modules in the crops' dtype. The
TPU kernel's space-to-depth packing and subposition matrix are not
carried over.
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


def _check(net, crops, spec):
    s = spec.size
    if crops.dim() != 4 or tuple(crops.shape[1:]) != (s, s, 3):
        raise ValueError(f"{spec.name} crops must be [N, {s}, {s}, 3], got "
                         f"{tuple(crops.shape)}")
    if tuple(net.conv1.weight.shape) != (spec.c1, 3, 3, 3) or tuple(
            net.conv2.weight.shape) != (spec.c2, spec.c1, 3, 3):
        raise ValueError(f"the net's conv1/conv2 do not match {spec.name}")


@torch.no_grad()
def pack_trunk_weights(net, spec, dtype=torch.float32):
    """conv1/prelu1/conv2/prelu2 -> [n_weights] f32 in the kernel's order:
    w1 [(ky*3 + kx)*3 + ci][C1], b1, a1, w2 [(ky*3 + kx)*C1 + ci][C2],
    b2, a2. On the bf16 path every value is rounded to bf16 first, as the
    plain version casts the parameters to the activations' dtype."""
    parts = [net.conv1.weight.permute(2, 3, 1, 0).reshape(-1),
             net.conv1.bias, net.prelu1.weight,
             net.conv2.weight.permute(2, 3, 1, 0).reshape(-1),
             net.conv2.bias, net.prelu2.weight]
    flat = torch.cat([p.reshape(-1).to(dtype) for p in parts])
    if flat.numel() != spec.n_weights():
        raise ValueError(f"{spec.name} has {flat.numel()} trunk weights, "
                         f"the kernel expects {spec.n_weights()}")
    return flat.to(torch.float32).contiguous()


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
    weights = kernels.cached_fold(
        net, ("crop_net_trunk", str(dev), str(dtype)),
        lambda: pack_trunk_weights(net, spec, dtype).to(dev))
    n = crops.shape[0]
    out = torch.empty((n, spec.out, spec.out, spec.c2), dtype=dtype,
                      device=dev)
    if n == 0:
        return out
    lib = kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vn_crop_net_trunk(crops.data_ptr(), weights.data_ptr(),
                                out.data_ptr(), n, spec.net_id,
                                int(dtype == torch.bfloat16), stream)
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
