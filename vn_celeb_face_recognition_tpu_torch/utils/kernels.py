"""Build, load and count the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface,
``csrc/build/libvnkernels.so``, the first time a kernel is launched. The
library is rebuilt when the hash of the sources changes. ``nvcc`` is
taken from ``PATH``, else from ``$CUDA_HOME/bin``, else from
``/usr/local/cuda/bin``. A missing compiler or a failed build raises with
the compiler's output; nothing falls back to another implementation.

Each kernel wrapper counts its launches (``count_launch``) right where
it launches its kernel and nowhere else, so a run can show that the main
path really went through the kernels.
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
# C entry points: name -> argtypes. Pointers and the stream are c_void_p,
# ints are c_int; every function returns cudaGetLastError() as an int.
SIGNATURES = {
    # windows, mats, out, K, N, out_size, stream
    "vn_similarity_warp": [_P, _P, _P, _I, _I, _I, _P],
    # levels, table, weights, probs, reg, n_levels, n_tiles, stream
    "vn_pnet_chain": [_P, _P, _P, _P, _P, _I, _I, _P],
}


_LAUNCHES = {"pnet_chain": 0, "similarity_warp": 0}


def count_launch(name):
    _LAUNCHES[name] += 1


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
    a library built from the same sources exists. Returns
    (library path, seconds spent compiling; 0.0 when it was current)."""
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = os.path.join(BUILD_DIR, LIB_NAME + ".sha256")
    digest = sources_hash()
    if os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as fh:
            if fh.read().strip() == digest:
                return lib_path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
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
