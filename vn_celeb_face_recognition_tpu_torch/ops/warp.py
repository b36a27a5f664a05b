"""K1: per-face similarity warp of windows into aligned faces.

Counterpart of ``vn_celeb_face_recognition_tpu/ops/warp_pallas.py``
(``batched_similarity_warp_pallas``). The CUDA kernel is
``csrc/similarity_warp.cu``; it computes the exact bilinear
``warp_affine`` rather than the TPU kernel's 3-shear factorisation.

``similarity_warp`` takes the plain PyTorch version for CPU tensors only
and launches the kernel for CUDA tensors.
"""

import torch

from ..utils import kernels
from .image import batched_warp_affine


def _check(windows, mats):
    if windows.dim() != 4 or windows.shape[1] != windows.shape[2] \
            or windows.shape[3] != 3:
        raise ValueError(f"windows must be [K, N, N, 3], got "
                         f"{tuple(windows.shape)}")
    if mats.shape != (windows.shape[0], 2, 3):
        raise ValueError(f"mats must be [K, 2, 3], got {tuple(mats.shape)}")


def similarity_warp_plain(windows, mats, out_size):
    """windows [K, N, N, 3] f32, mats [K, 2, 3] -> [K, S, S, 3] f32 with
    ``ops.image.batched_warp_affine``, one window per face."""
    _check(windows, mats)
    idx = torch.arange(windows.shape[0], device=windows.device)
    return batched_warp_affine(windows.to(torch.float32), idx, mats,
                               (out_size, out_size))


def similarity_warp_kernel(windows, mats, out_size):
    """The same function through the CUDA kernel (CUDA tensors only)."""
    _check(windows, mats)
    k, n = windows.shape[0], windows.shape[1]
    if k > 65535:
        raise ValueError(f"at most 65535 faces per launch, got {k}")
    windows = windows.to(torch.float32).contiguous()
    mats = mats.to(torch.float32).contiguous()
    kernels.require_cuda_tensor(windows, "windows", torch.float32)
    kernels.require_cuda_tensor(mats, "mats", torch.float32)
    if mats.device != windows.device:
        raise ValueError("windows and mats must be on the same device")
    out = torch.empty((k, out_size, out_size, 3), dtype=torch.float32,
                      device=windows.device)
    lib = kernels.library()
    stream = torch.cuda.current_stream(windows.device).cuda_stream
    err = lib.vn_similarity_warp(windows.data_ptr(), mats.data_ptr(),
                                 out.data_ptr(), k, n, out_size, stream)
    kernels.check_cuda(err, "vn_similarity_warp")
    kernels.count_launch("similarity_warp")
    return out


def similarity_warp(windows, mats, out_size):
    """windows [K, N, N, 3], mats [K, 2, 3] -> [K, S, S, 3] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    if windows.is_cuda:
        return similarity_warp_kernel(windows, mats, out_size)
    if windows.device.type != "cpu":
        raise ValueError(f"unsupported device {windows.device}")
    return similarity_warp_plain(windows, mats, out_size)
