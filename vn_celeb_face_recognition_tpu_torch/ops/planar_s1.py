"""K6: RetinaFace MobileNetV1-0.25 stage 1 on uint8 frames.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/planar_s1_pallas.py``
(``planar_stage1_pallas``) and ``planar_s1_pallas_v2.py``: the same
function, the six blocks of stage 1 with inference BatchNorm and
LeakyReLU(0.1) on frames minus the channel means, [B, H, W, 3] uint8 ->
[B, ceil(H/8), ceil(W/8), 64] NHWC in the compute dtype. The CUDA kernel
``csrc/mnet_stage1.cu`` computes it from the frames directly, in three
launches (one per stride-2 segment, each counted), the pointwise
convolutions and conv0 on the tensor cores: for bf16 output with split
bf16 operands (``segment_mma_first``, ``segment_mma``; their weights from
``pack_stage1_mma_weights``), for f32 output in 3xTF32, each f32 operand
split into two TF32 halves (``segment_tf32_first``, ``segment_tf32``;
their weights from ``pack_stage1_tf32x3_weights``). The TPU kernels'
space-to-depth planes and lane rolls are not carried over.

``mnet_stage1`` takes the plain PyTorch version (the stage's own NCHW
modules) for CPU tensors only and launches the kernel for CUDA tensors.
"""

import ctypes

import torch

from ..utils import kernels

# (kind, in, out, stride) of stage 1's blocks
STAGE1_SPECS = (
    ("conv_bn", 3, 8, 2),
    ("conv_dw", 8, 16, 1),
    ("conv_dw", 16, 32, 2),
    ("conv_dw", 32, 32, 1),
    ("conv_dw", 32, 64, 2),
    ("conv_dw", 64, 64, 1),
)
# packed weights of csrc/mnet_stage1.cu: 4 (means + pad), then the three
# segments (blocks 0-1, 2-3, 4-5)
N_WEIGHTS = 4 + 480 + 2192 + 7456
# the bf16 kernels' [out][in] matrices (in padded to 16, conv0's 27 taps x
# channels to 32), each as hi = bf16(w) followed by lo = bf16(w - hi):
# name -> (element offset of hi, out, in), as csrc/mnet_stage1.cu reads them
MMA_LAYOUT = {"conv0": (0, 8, 32), "pw1": (512, 16, 16),
              "pw2": (1024, 32, 16), "pw3": (2048, 32, 32),
              "pw4": (4096, 64, 32), "pw5": (8192, 64, 64)}
N_MMA_WEIGHTS = 16384
# the f32 kernels' [out][in] matrices (conv0's 27 taps x channels padded to
# 32; block 1's K = 8 is one k8 step), each as hi = tf32(w) followed by
# lo = tf32(w - hi): name -> (float offset of hi, out, in)
TF32_LAYOUT = {"conv0": (0, 8, 32), "pw1": (512, 16, 8),
               "pw2": (768, 32, 16), "pw3": (1792, 32, 32),
               "pw4": (3840, 64, 32), "pw5": (7936, 64, 64)}
N_TF32_WEIGHTS = 16128


def _bn_mul_add(bn):
    """Inference BatchNorm as a per-channel (mul, add) in f32."""
    mul = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return [mul, bn.bias - bn.running_mean * mul]


def _dw_taps(conv):
    """Depthwise [C, 1, 3, 3] -> [9, C] (tap-major)."""
    return conv.weight[:, 0].permute(1, 2, 0).reshape(9, -1)


def _pw_cin_major(conv):
    """Pointwise [O, C, 1, 1] -> [C, O]."""
    return conv.weight[:, :, 0, 0].t()


@torch.no_grad()
def pack_stage1_weights(stage1, sub):
    """Stage-1 modules + channel means -> [N_WEIGHTS] f32 in the kernel's
    order: means; conv0 as [(ky*3+kx)*3+c, o] with its BN; then per
    depthwise-separable block the taps [9, C], BN, pointwise [C, O], BN."""
    parts = [torch.tensor([*sub, 0.0])]
    for i, (kind, _, _, _) in enumerate(STAGE1_SPECS):
        blk = stage1[i]
        if kind == "conv_bn":
            parts.append(blk[0].weight.permute(2, 3, 1, 0).reshape(27, -1))
            parts += _bn_mul_add(blk[1])
        else:
            parts.append(_dw_taps(blk[0]))
            parts += _bn_mul_add(blk[1])
            parts.append(_pw_cin_major(blk[3]))
            parts += _bn_mul_add(blk[4])
    flat = torch.cat([p.reshape(-1).to(torch.float32).cpu() for p in parts])
    if flat.numel() != N_WEIGHTS:
        raise ValueError(f"stage 1 packs to {flat.numel()} weights, the "
                         f"kernel expects {N_WEIGHTS}")
    return flat


def _gemm_matrices(stage1):
    """(name, [out, in] f32 matrix) of conv0 (column (ky*3 + kx)*3 + c)
    and of each pointwise conv, as the tensor-core kernels multiply them."""
    for i, (kind, _, _, _) in enumerate(STAGE1_SPECS):
        blk = stage1[i]
        if kind == "conv_bn":
            w = blk[0].weight
            yield "conv0", w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
        else:
            yield f"pw{i}", blk[3].weight[:, :, 0, 0]


def _pack_split(stage1, layout, n, dtype, split):
    """The kernels' B operands as ``layout`` places them, each [out, in]
    matrix zero-padded to its layout's width and split into (hi, lo) by
    ``split``: [n] ``dtype``."""
    flat = torch.zeros(n, dtype=dtype)
    for name, mat in _gemm_matrices(stage1):
        at, rows, cols = layout[name]
        full = torch.zeros(rows, cols)
        full[:, :mat.shape[1]] = mat.to(torch.float32).cpu()
        hi, lo = split(full)
        flat[at:at + 2 * rows * cols] = torch.cat([hi.reshape(-1),
                                                   lo.reshape(-1)])
    return flat


def _split_bf16(x):
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(torch.float32)).to(torch.bfloat16)


@torch.no_grad()
def pack_stage1_mma_weights(stage1):
    """Stage-1 modules -> [N_MMA_WEIGHTS] bf16, the B operands of the bf16
    kernels as ``MMA_LAYOUT`` places them: conv0 as [8, 32] with column
    (ky*3 + kx)*3 + c (zero from 27), each pointwise conv as [out, in]
    (block 1's 8 inputs padded with zeros to 16); each matrix as its bf16
    rounding hi, then the bf16 rounding of the rest, lo = w - hi."""
    return _pack_split(stage1, MMA_LAYOUT, N_MMA_WEIGHTS, torch.bfloat16,
                       _split_bf16)


@torch.no_grad()
def pack_stage1_tf32x3_weights(stage1):
    """Stage-1 modules -> [N_TF32_WEIGHTS] f32, the B operands of the f32
    kernels as ``TF32_LAYOUT`` places them: conv0 as [8, 32] (zero from
    column 27), each pointwise conv as [out, in]; each matrix split into
    TF32 halves, hi then lo (``kernels.split_tf32``)."""
    return _pack_split(stage1, TF32_LAYOUT, N_TF32_WEIGHTS, torch.float32,
                       kernels.split_tf32)


def _kernel_weights(stage1, sub, dtype):
    """The buffer the C entry point reads: the f32 pack, followed by the
    kernels' B operands (for bf16 output the bf16 pack, its bits viewed as
    f32; for f32 output the split f32 pack)."""
    flat = pack_stage1_weights(stage1, sub)
    if dtype == torch.bfloat16:
        gemm = pack_stage1_mma_weights(stage1).view(torch.float32)
    else:
        gemm = pack_stage1_tf32x3_weights(stage1)
    return torch.cat([flat, gemm])


def _check(frames):
    if frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be [B, H, W, 3], got "
                         f"{tuple(frames.shape)}")


@torch.no_grad()
def mnet_stage1_plain(stage1, frames, sub, dtype):
    """The stage's NCHW modules on ``frames - sub`` in ``dtype``; returns
    NHWC [B, H/8, W/8, 64]."""
    _check(frames)
    mean = torch.tensor(sub, dtype=torch.float32, device=frames.device)
    x = (frames.to(torch.float32) - mean).permute(0, 3, 1, 2).to(dtype)
    return stage1(x).permute(0, 2, 3, 1)


def stage1_out_hw(h, w):
    """Spatial size after the three stride-2 layers (pad 1, 3x3)."""
    for _ in range(3):
        h, w = (h + 1) // 2, (w + 1) // 2
    return h, w


@torch.no_grad()
def mnet_stage1_kernel(stage1, frames, sub, dtype):
    """The same function through the CUDA kernel (CUDA tensors only)."""
    _check(frames)
    if frames.dtype != torch.uint8:
        raise ValueError(f"frames must be uint8, got {frames.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute dtype {dtype}")
    if any(float(m) != int(m) or not 0 <= m <= 255 for m in sub):
        # conv0's A operand, frame - means, is then exact in bf16 and TF32
        raise ValueError(f"the kernel takes integer channel means in "
                         f"[0, 255], got {tuple(sub)}")
    frames = frames.contiguous()
    kernels.require_cuda_tensor(frames, "frames", torch.uint8)
    if frames.data_ptr() % 16:  # the kernel copies 16-byte aligned pieces
        frames = frames.clone()
    dev = frames.device
    weights = kernels.cached_fold(
        stage1, ("mnet_stage1", str(dev), tuple(sub), dtype),
        lambda: _kernel_weights(stage1, sub, dtype).to(dev))
    b, h, w, _ = frames.shape
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    h4, w4 = (h2 + 1) // 2, (w2 + 1) // 2
    h8, w8 = stage1_out_hw(h, w)
    scratch1 = torch.empty((b, h2, w2, 16), dtype=dtype, device=dev)
    scratch2 = torch.empty((b, h4, w4, 32), dtype=dtype, device=dev)
    out = torch.empty((b, h8, w8, 64), dtype=dtype, device=dev)
    lib = kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    launched = ctypes.c_int(0)
    err = lib.vn_mnet_stage1(frames.data_ptr(), weights.data_ptr(),
                             out.data_ptr(), scratch1.data_ptr(),
                             scratch2.data_ptr(), b, h, w,
                             int(dtype == torch.bfloat16), stream,
                             ctypes.byref(launched))
    kernels.count_launch("mnet_stage1", launched.value)
    kernels.check_cuda(err, "vn_mnet_stage1")
    return out


def mnet_stage1(stage1, frames, sub, dtype):
    """frames [B, H, W, 3] uint8 -> stage-1 features NHWC in ``dtype``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    if frames.is_cuda:
        return mnet_stage1_kernel(stage1, frames, sub, dtype)
    if frames.device.type != "cpu":
        raise ValueError(f"unsupported device {frames.device}")
    return mnet_stage1_plain(stage1, frames, sub, dtype)
