"""Build, load and count the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for Hopper
(``sm_90a``), one compiler process per file, all at once, and linked
into one shared library with a plain C interface,
``csrc/build/libvnkernels.so``, the first time a kernel is launched. The
library is rebuilt when the hash of the sources changes. ``nvcc`` is
taken from ``PATH``, else from ``$CUDA_HOME/bin``, else from
``/usr/local/cuda/bin``. A missing compiler or a failed build raises with
the compiler's output; nothing falls back to another implementation.

Each kernel wrapper counts its launches (``count_launch``), one per grid
the card runs, right where it launches its kernel and nowhere else, so a
run can show that the main path really went through the kernels.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
LIB_NAME = "libvnkernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_NP = ctypes.POINTER(ctypes.c_int)
# C entry points: name -> argtypes. Pointers and the stream are c_void_p,
# ints are c_int; every function returns cudaGetLastError() as an int.
# Entry points that launch more than one kernel write how many they
# launched to a trailing int*.
SIGNATURES = {
    # src, src_u8, image_idx, oy, ox, mats, out, K, n_img, H, W, win,
    # out_size, stream
    "vn_similarity_warp": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _P],
    # mats, src_u8, out boxes, K, win, out_size, stream (a check of K1's
    # box rule, not a step of the warp)
    "vn_similarity_warp_boxes": [_P, _I, _P, _I, _I, _I, _P],
    # integ, small parameters (host), level table (host), weights, probs,
    # reg, B, H, W, n_levels, tiles_per_frame, mma, stream
    "vn_pyramid_pnet": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P],
    # frames, weights, out, scratch1, scratch2, B, H, W, out_bf16, stream,
    # launches
    "vn_mnet_stage1": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _NP],
    # faces, weights, out, K, out_bf16, stream
    "vn_emotion_stem": [_P, _P, _P, _I, _I, _P],
    # x, w1, b1, w2, b2, w3, b3, out, t1, t2, N, H, W, C, P, bf16, stream,
    # launches
    "vn_bottleneck_block": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P, _NP],
    # boxes, scores, valid, keep, N, K, iou_thr, offset, min_mode, stream
    "vn_nms_keep_mask": [_P, _P, _P, _P, _I, _I, _F, _F, _I, _P],
    # frames, integ, totals, B, H, W, stream, launches
    "vn_integral_image": [_P, _P, _P, _I, _I, _I, _P, _NP],
    # integ, boxes, out, B, K, H, W, S, stream
    "vn_crop_area_pool": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # crops, weights, out, N, net (0 RNet, 1 ONet), bf16, stream
    "vn_crop_net_trunk": [_P, _P, _P, _I, _I, _I, _P],
}


_LAUNCHES = {"pnet_chain": 0, "similarity_warp": 0, "mnet_stage1": 0,
             "emotion_stem": 0, "bottleneck_chain": 0, "nms_keep_mask": 0,
             "crop_area_resize": 0, "crop_net_trunk": 0}


def count_launch(name, n=1):
    """Add ``n`` kernel launches of ``name`` (one per grid launched)."""
    _LAUNCHES[name] += n


def reset_launch_counts():
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts():
    return dict(_LAUNCHES)


def find_nvcc():
    cand = shutil.which("nvcc")
    if cand:
        return cand
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            path = os.path.join(root, "bin", "nvcc")
            if os.path.exists(path):
                return path
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin;"
        " the CUDA kernels cannot be built")


def _sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def sources_hash():
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()


def build(verbose=False):
    """Compile ``csrc/*.cu`` into ``csrc/build/libvnkernels.so`` unless
    a library built from the same sources exists: one ``nvcc -c`` per
    source, all started together, then one link. Returns (library path,
    seconds spent compiling; 0.0 when it was current)."""
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = os.path.join(BUILD_DIR, LIB_NAME + ".sha256")
    digest = sources_hash()
    if os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as fh:
            if fh.read().strip() == digest:
                return lib_path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    tmp = f"{lib_path}.{tag}"
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
               *[obj for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"link failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    if verbose:
        print("".join(logs))
    os.replace(tmp, lib_path)
    with open(stamp, "w") as fh:
        fh.write(digest)
    return lib_path, seconds


_LIB = None
_LIB_LOCK = threading.Lock()


def library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def cached_fold(modules, tag, fold):
    """``fold()`` (host-side weight folding for a kernel), cached on the
    first of ``modules`` under ``tag`` until a parameter or buffer of any
    of them is written again (``load_state_dict``, ``copy_``, ``to``)."""
    if not isinstance(modules, (list, tuple)):
        modules = (modules,)
    state = tuple((id(t), t._version) for m in modules
                  for t in (*m.parameters(), *m.buffers()))
    cache = modules[0].__dict__.setdefault("_kernel_folds", {})
    hit = cache.get(tag)
    if hit is None or hit[0] != state:
        hit = (state, fold())
        cache[tag] = hit
    return hit[1]


def check_cuda(err, name):
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require_cuda_tensor(t, name, dtype=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
