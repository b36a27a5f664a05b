"""K8: a chain of stride-1 ResNet Bottleneck blocks.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/bottleneck_pallas.py``
(``bottleneck_chain``, via ``emotion_apply_fused_l12``): blocks of
conv1x1 -> BN -> ReLU -> conv3x3 -> BN -> ReLU -> conv1x1 -> BN ->
+residual -> ReLU, inference BatchNorm, NHWC [N, H, W, C] in and out.
The emotion net runs it on layer1's blocks 1-2 (56x56, C = 256, P = 64)
and layer2's blocks 1-3 (28x28, C = 512, P = 128).

The CUDA kernel ``csrc/bottleneck_chain.cu`` runs one whole block per
launch, fused: a thread block owns a band of one image's rows and keeps
conv1's output (with a one-row halo) and conv2's output in shared
memory, on the tensor cores in bf16 with f32 accumulation. ``bottleneck_chain``
launches it once per block of the chain, ping-ponging two device
buffers. f32 inputs (the card-vs-CPU check) take the kernel file's
plain f32 path, three unfused launches per block on the CUDA cores.
Every launch is counted: a bf16 chain of n blocks counts n.

``bottleneck_chain`` takes the plain PyTorch version (the blocks' own
NCHW modules) for CPU tensors only and launches the kernel for CUDA
tensors.
"""

import ctypes

import torch

from ..utils import kernels

# (C, P, widest W) the fused bf16 kernel is instantiated for
FUSED_SHAPES = {(256, 64): 64, (512, 128): 32}


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
    """The same chain through the CUDA kernel (CUDA tensors only): one
    launch per block in bf16, three in f32."""
    _check(blocks, x)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {x.dtype}")
    x = x.contiguous()
    kernels.require_cuda_tensor(x, "x")
    n, h, w, c = x.shape
    p = blocks[0].conv1.out_channels if blocks else c // 4
    bf16 = x.dtype == torch.bfloat16
    if bf16 and FUSED_SHAPES.get((c, p), 0) < w:
        raise ValueError(f"no fused bf16 kernel for C={c}, P={p}, W={w}; "
                         f"instantiated: {FUSED_SHAPES}")
    dev = x.device
    if not blocks or n == 0:
        return x.clone()
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    # the f32 path stages conv1's and conv2's outputs in device memory
    t1 = t2 = torch.empty(0, device=dev)
    if not bf16:
        t1 = torch.empty((n, h, w, p), dtype=x.dtype, device=dev)
        t2 = torch.empty_like(t1)
    lib = kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    launched = ctypes.c_int(0)
    src = x
    for i, blk in enumerate(blocks):
        w1, b1, w2, b2, w3, b3 = kernels.cached_fold(
            blk, ("bottleneck", str(dev), x.dtype),
            lambda blk=blk: tuple(t.to(dev) for t in fold_block(blk,
                                                                x.dtype)))
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
