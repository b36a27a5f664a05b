"""K8: a chain of stride-1 ResNet Bottleneck blocks.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/bottleneck_pallas.py``
(``bottleneck_chain``, via ``emotion_apply_fused_l12``): blocks of
conv1x1 -> BN -> ReLU -> conv3x3 -> BN -> ReLU -> conv1x1 -> BN ->
+residual -> ReLU, inference BatchNorm, NHWC [N, H, W, C] in and out.
The emotion net runs it on layer1's blocks 1-2 (56x56, C = 256, P = 64)
and layer2's blocks 1-3 (28x28, C = 512, P = 128).

The CUDA kernel ``csrc/bottleneck_chain.cu`` runs each block as three
launches of an implicit GEMM on the tensor cores: conv1 (x -> t1), conv2
(9 taps of t1 -> t2) and conv3 (t2 -> y, plus the residual x), with t1
and t2 in device memory, scratch in the activation dtype that
``bottleneck_chain`` allocates once per chain. bf16 activations take
``conv_gemm_bf16`` (bf16 products, f32 sums); f32 activations, the dtype
of every shipped config, take ``conv_gemm_tf32x3``, the same tiles with
each f32 operand split into two TF32 halves and three products a step
(3xTF32: f32-accurate, on the tensor cores). Both read the weights packed
[tap][out][in] by ``pack_gemm_weights`` and take P a multiple of 64 and C
of 128. Every launch is counted: a chain of n blocks counts 3n.

``bottleneck_chain`` takes the plain PyTorch version (the blocks' own
NCHW modules) for CPU tensors only and launches the kernel for CUDA
tensors.
"""

import ctypes

import torch

from ..utils import kernels


def _bn_scale_shift(bn):
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale


@torch.no_grad()
def fold_block(block, dtype):
    """One stride-1 Bottleneck -> (w1 [C, P], b1 [P], w2 [9, P, P]
    (tap, in, out), b2 [P], w3 [P, C], b3 [C]): BN scales folded into the
    weights (``dtype``), shifts as f32 biases."""
    s1, h1 = _bn_scale_shift(block.bn1)
    s2, h2 = _bn_scale_shift(block.bn2)
    s3, h3 = _bn_scale_shift(block.bn3)
    w1 = (block.conv1.weight[:, :, 0, 0] * s1[:, None]).t()
    w2 = (block.conv2.weight * s2[:, None, None, None]).permute(2, 3, 1, 0)
    w3 = (block.conv3.weight[:, :, 0, 0] * s3[:, None]).t()
    p = w1.shape[1]
    return (w1.to(dtype).contiguous(), h1.to(torch.float32).contiguous(),
            w2.reshape(9, p, p).to(dtype).contiguous(),
            h2.to(torch.float32).contiguous(),
            w3.to(dtype).contiguous(), h3.to(torch.float32).contiguous())


@torch.no_grad()
def pack_gemm_weights(folded):
    """``fold_block``'s weights -> the kernel's B operands in their dtype
    (bf16 or f32), packed [tap][out][in] with the input channels
    contiguous: (w1 [1, P, C], b1, w2 [9, P, P], b2, w3 [1, C, P], b3);
    the biases stay f32."""
    w1, b1, w2, b2, w3, b3 = folded
    return (w1.t().unsqueeze(0).contiguous(), b1,
            w2.transpose(1, 2).contiguous(), b2,
            w3.t().unsqueeze(0).contiguous(), b3)


def _check(blocks, x):
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, C], got {tuple(x.shape)}")
    for blk in blocks:
        if blk.stride != 1 or blk.downsample is not None \
                or blk.conv3.out_channels != x.shape[-1]:
            raise ValueError("the chain takes stride-1 Bottlenecks without "
                             "a downsample whose width is the input's")


@torch.no_grad()
def bottleneck_chain_plain(blocks, x):
    """Each block's NCHW modules in turn; NHWC in and out."""
    _check(blocks, x)
    y = x.permute(0, 3, 1, 2)
    for blk in blocks:
        y = blk(y)
    return y.permute(0, 2, 3, 1)


@torch.no_grad()
def bottleneck_chain_kernel(blocks, x):
    """The same chain through the CUDA kernel (CUDA tensors only): three
    launches per block, in bf16 and in f32 (3xTF32)."""
    _check(blocks, x)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {x.dtype}")
    n, h, w, c = x.shape
    p = blocks[0].conv1.out_channels if blocks else c // 4
    if p % 64 or c % 128:
        raise ValueError(f"the kernel takes P a multiple of 64 and C of 128, "
                         f"got C={c}, P={p}")
    x = x.contiguous()
    kernels.require_cuda_tensor(x, "x")
    bf16 = x.dtype == torch.bfloat16
    dev = x.device
    if not blocks or n == 0:
        return x.clone()
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    # conv1's and conv2's outputs, in device memory
    t1 = torch.empty((n, h, w, p), dtype=x.dtype, device=dev)
    t2 = torch.empty_like(t1)
    lib = kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    launched = ctypes.c_int(0)
    src = x
    for i, blk in enumerate(blocks):
        w1, b1, w2, b2, w3, b3 = kernels.cached_fold(
            blk, ("bottleneck", str(dev), x.dtype),
            lambda blk=blk: tuple(t.to(dev) for t in pack_gemm_weights(
                fold_block(blk, x.dtype))))
        dst = bufs[i % 2]
        err = lib.vn_bottleneck_block(
            src.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), dst.data_ptr(),
            t1.data_ptr(), t2.data_ptr(), n, h, w, c, p, int(bf16), stream,
            ctypes.byref(launched))
        kernels.count_launch("bottleneck_chain", launched.value)
        kernels.check_cuda(err, "vn_bottleneck_block")
        src = dst
    return src


def bottleneck_chain(blocks, x):
    """blocks: stride-1 Bottleneck modules; x [N, H, W, C] -> the same
    shape and dtype. CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    blocks = list(blocks)
    if x.is_cuda:
        return bottleneck_chain_kernel(blocks, x)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return bottleneck_chain_plain(blocks, x)
