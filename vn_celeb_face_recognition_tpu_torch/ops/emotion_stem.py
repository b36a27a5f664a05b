"""K7: the emotion net's stem on 112 px aligned faces.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/emotion_stem_pallas.py``
(``emotion_stem_pallas``, via ``emotion_apply_fused``): the function
maxpool3x3/2(relu(bn(conv7x7/2(imagenet_normalize(area_resize(x, 224) /
255))))) of the 2-branch ResNet-50, [K, 112, 112, 3] f32 pixels ->
[K, 56, 56, 64] NHWC in the compute dtype.

The 112 -> 224 area upsample is exact 2x2 duplication, so the 7x7/2 conv
on the upsampled face equals a 4x4/1 conv on the 112 px face with the
kernel's taps summed pairwise ({0}, {1, 2}, {3, 4}, {5, 6}, along both
axes); the normalisation is applied before the zero padding, so the
padding stays zero in the normalised domain. The CUDA kernel
``csrc/emotion_stem.cu`` computes that folded conv with BatchNorm folded
in, then ReLU and the max pool from shared memory, as an implicit GEMM on
the tensor cores: for bf16 output in bf16 (``emotion_stem_mma``, B
operand from ``pack_stem_mma_weights``), for f32 output in 3xTF32, each
f32 operand split into two TF32 halves and three products a step
(``emotion_stem_tf32x3``, B operand from ``pack_stem_tf32x3_weights``).
The TPU kernel's subposition GEMM and two-faces-per-128-lanes packing are
not carried over.

``emotion_stem`` takes the plain PyTorch version (resize, normalise,
cuDNN conv) for CPU tensors only and launches the kernel for CUDA
tensors.
"""

import torch
import torch.nn.functional as F

from ..models.layers import batch_norm, conv
from ..utils import kernels
from .image import area_resize, imagenet_normalize

FACE, OUT, CH = 112, 56, 64
_FOLD = ((0,), (1, 2), (3, 4), (5, 6))


@torch.no_grad()
def fold_stem_weights(conv1, bn1):
    """conv1 [64, 3, 7, 7] + bn1 -> [48 * 64 + 64] f32: the folded 4x4
    kernel as [(dy*4 + dx)*3 + c, o] with the BN scale folded in, then
    the BN shift [64]."""
    k = conv1.weight.to(torch.float32).permute(2, 3, 1, 0)  # [7, 7, 3, 64]
    k = torch.stack([sum(k[i] for i in g) for g in _FOLD], 0)
    k = torch.stack([sum(k[:, i] for i in g) for g in _FOLD], 1)
    inv = bn1.weight / torch.sqrt(bn1.running_var + bn1.eps)
    shift = bn1.bias - bn1.running_mean * inv
    return torch.cat([(k * inv).reshape(-1), shift]).contiguous()


@torch.no_grad()
def pack_stem_mma_weights(conv1, bn1):
    """The bf16 kernel's B operand: the folded 4x4 kernel (BN scale folded
    in) as [64, 48] bf16, n-major with k = (dy*4 + dx)*3 + c contiguous."""
    fold = fold_stem_weights(conv1, bn1)
    return fold[:48 * CH].reshape(48, CH).t().to(torch.bfloat16).contiguous()


@torch.no_grad()
def pack_stem_tf32x3_weights(conv1, bn1):
    """The f32 kernel's B operand: the folded 4x4 kernel (BN scale folded
    in) as [64, 48], n-major with k = (dy*4 + dx)*3 + c contiguous, split
    into TF32 halves: [2, 64, 48] f32, hi then lo
    (``kernels.split_tf32``)."""
    fold = fold_stem_weights(conv1, bn1)
    hi, lo = kernels.split_tf32(fold[:48 * CH].reshape(48, CH).t())
    return torch.stack([hi, lo]).contiguous()


def _kernel_weights(conv1, bn1, dtype):
    """The buffer the C entry point reads: the f32 fold, followed by the
    packed B operand (for bf16 output its bf16 bits viewed as f32)."""
    fold = fold_stem_weights(conv1, bn1)
    if dtype == torch.bfloat16:
        b = pack_stem_mma_weights(conv1, bn1).reshape(-1).view(torch.float32)
    else:
        b = pack_stem_tf32x3_weights(conv1, bn1).reshape(-1)
    return torch.cat([fold, b])


def _check(faces):
    if tuple(faces.shape[1:]) != (FACE, FACE, 3):
        raise ValueError(f"faces must be [K, {FACE}, {FACE}, 3], got "
                         f"{tuple(faces.shape)}")


@torch.no_grad()
def emotion_stem_plain(conv1, bn1, faces, dtype):
    """Resize to 224, normalise, then the stem's NCHW modules in
    ``dtype``; returns NHWC [K, 56, 56, 64]."""
    _check(faces)
    x = area_resize(faces.to(torch.float32), (2 * FACE, 2 * FACE))
    x = imagenet_normalize(x / 255.0).to(dtype).permute(0, 3, 1, 2)
    x = F.relu(batch_norm(bn1, conv(conv1, x)))
    return F.max_pool2d(x, 3, 2, 1).permute(0, 2, 3, 1)


@torch.no_grad()
def emotion_stem_kernel(conv1, bn1, faces, dtype):
    """The same function through the CUDA kernel (CUDA tensors only)."""
    _check(faces)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute dtype {dtype}")
    faces = faces.to(torch.float32).contiguous()
    kernels.require_cuda_tensor(faces, "faces", torch.float32)
    dev = faces.device
    weights = kernels.cached_fold(
        (conv1, bn1), ("emotion_stem", str(dev), dtype),
        lambda: _kernel_weights(conv1, bn1, dtype).to(dev))
    k = faces.shape[0]
    out = torch.empty((k, OUT, OUT, CH), dtype=dtype, device=dev)
    if k == 0:
        return out
    lib = kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vn_emotion_stem(faces.data_ptr(), weights.data_ptr(),
                              out.data_ptr(), k,
                              int(dtype == torch.bfloat16), stream)
    kernels.check_cuda(err, "vn_emotion_stem")
    kernels.count_launch("emotion_stem")
    return out


def emotion_stem(conv1, bn1, faces, dtype):
    """faces [K, 112, 112, 3] (0-255) -> [K, 56, 56, 64] NHWC in
    ``dtype``. CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise)."""
    if faces.is_cuda:
        return emotion_stem_kernel(conv1, bn1, faces, dtype)
    if faces.device.type != "cpu":
        raise ValueError(f"unsupported device {faces.device}")
    return emotion_stem_plain(conv1, bn1, faces, dtype)
