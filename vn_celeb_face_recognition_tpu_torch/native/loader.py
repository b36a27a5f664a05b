"""Build, load and call the port's IO runtime (``src/*.cpp``).

Each source is compiled with ``g++`` into its own shared library under
``native/build/`` the first time one of its functions is called, and
rebuilt when the hash of the source and its flags changes:

  * ``image_io.cpp`` -> ``libvn_image_io.so`` (libjpeg): ``decode_jpeg_file``;
  * ``video_io.cpp`` -> ``libvn_video_io.so`` (libavformat, libavcodec,
    libavutil, libswscale): ``VideoReader``.

A missing compiler, header or library raises ``RuntimeError`` at first use
with the compiler's output and the name of the missing header or library.
The build is tried once a process: ``available(name)`` says whether it
succeeded, and ``library(name)`` raises the kept reason again after a
failure. The readers choose between the runtime and cv2 by
``use_runtime``, the JAX package's rule, and say which they took.
Importing this module builds nothing.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "src")
BUILD_DIR = os.path.join(_HERE, "build")
CXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared", "-Wall"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
# library -> (source, link flags, headers it includes, {function: (argtypes,
# restype)})
LIBRARIES = {
    "image_io": ("image_io.cpp", ["-ljpeg"], ["jpeglib.h"], {
        "vn_decode_jpeg": ([ctypes.c_char_p, ctypes.c_size_t, _IP, _IP], _P),
        "vn_free": ([_P], None),
    }),
    "video_io": ("video_io.cpp",
                 ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"],
                 ["libavcodec/avcodec.h", "libavformat/avformat.h",
                  "libavutil/imgutils.h", "libswscale/swscale.h"], {
        "vn_video_open": ([ctypes.c_char_p], _P),
        "vn_video_width": ([_P], _I),
        "vn_video_height": ([_P], _I),
        "vn_video_fps": ([_P], ctypes.c_double),
        "vn_video_nframes": ([_P], ctypes.c_int64),
        "vn_video_read": ([_P, _P, _I], _I),
        "vn_video_close": ([_P], None),
    }),
}
_MISSING_HEADER = re.compile(r"fatal error: ([^:\s]+): No such file")
_MISSING_LIB = re.compile(r"cannot find -l([^:\s]+)")

_LIBS = {}
_FAILED = {}  # library -> the RuntimeError its build or load raised
_ANNOUNCED = set()  # the reader choices printed so far
_LOCK = threading.Lock()


def find_cxx():
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the IO runtime (JPEG and "
                           "video decode) cannot be built")
    return cxx


def _digest(source, link):
    h = hashlib.sha256()
    with open(os.path.join(SRC_DIR, source), "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(CXX_FLAGS + link).encode())
    return h.hexdigest()


def build(name):
    """Compile library ``name`` of ``LIBRARIES`` unless one built from the
    same source and flags exists; returns its path."""
    source, link, headers, _ = LIBRARIES[name]
    lib_path = os.path.join(BUILD_DIR, f"libvn_{name}.so")
    stamp = lib_path + ".sha256"
    digest = _digest(source, link)
    if os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as fh:
            if fh.read().strip() == digest:
                return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [find_cxx(), *CXX_FLAGS, "-o", tmp,
           os.path.join(SRC_DIR, source), *link]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        out = proc.stdout + proc.stderr
        header, lib = _MISSING_HEADER.search(out), _MISSING_LIB.search(out)
        what = (f"header {header.group(1)} not found" if header else
                f"library lib{lib.group(1)} not found" if lib else
                f"the build failed (it needs the headers {headers} and "
                f"{' '.join(link)})")
        raise RuntimeError(f"IO runtime {name}: {what}; {' '.join(cmd)}\n"
                           f"{out}")
    os.replace(tmp, lib_path)
    # the stamp is renamed into place too: a process that starts its build
    # meanwhile reads the old stamp or the new one, never a half-written one
    with open(f"{stamp}.{os.getpid()}.{threading.get_ident()}.tmp",
              "w") as fh:
        fh.write(digest)
    os.replace(fh.name, stamp)
    return lib_path


def library(name):
    """The loaded library ``name``, built on first use. A build or load
    that failed once raises its ``RuntimeError`` again without a retry."""
    with _LOCK:
        if name in _FAILED:
            raise _FAILED[name]
        if name not in _LIBS:
            try:
                lib = ctypes.CDLL(build(name))
            except OSError as exc:  # a library the loader cannot map
                _FAILED[name] = RuntimeError(
                    f"IO runtime {name}: cannot load it: {exc}")
                raise _FAILED[name] from exc
            except RuntimeError as exc:
                _FAILED[name] = exc
                raise
            for fn, (argtypes, restype) in LIBRARIES[name][3].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return _LIBS[name]


def available(name):
    """Whether library ``name`` builds and loads on this machine (the
    counterpart of the JAX package's ``native.available()``). The build is
    tried once; after a failure ``unavailable_reason(name)`` says why."""
    try:
        library(name)
    except RuntimeError:
        return False
    return True


def unavailable_reason(name):
    """What library ``name``'s build or load reported missing (the header
    or library, without the compiler's command and output), or None when
    it has not failed."""
    exc = _FAILED.get(name)
    return None if exc is None else str(exc).splitlines()[0].split("; ")[0]


def use_runtime(name, use_native, what):
    """Resolve a reader's ``use_native`` as the JAX package does: None
    takes the IO runtime when ``available(name)``, else cv2; True takes
    the runtime (whose build error then raises at first use); False takes
    cv2. The choice for ``what`` is printed to stderr once a process, with
    the reason when the runtime was not taken. Returns whether to use the
    runtime."""
    if use_native is None:
        use_native = available(name)
        why = "" if use_native else (
            f": the IO runtime is not available ({unavailable_reason(name)})")
    else:
        why = f" (use_native={use_native})"
    reader = (f"the IO runtime ({LIBRARIES[name][0]})" if use_native
              else "cv2")
    line = f"{what}: read by {reader}{why}"
    with _LOCK:
        if line not in _ANNOUNCED:
            _ANNOUNCED.add(line)
            print(line, file=sys.stderr, flush=True)
    return bool(use_native)


def cv2_module(name, use_native, what):
    """cv2, for a reader of ``what`` that did not take library ``name``;
    without cv2 the error names both readers."""
    try:
        import cv2
    except ImportError as exc:
        runtime = (f"the IO runtime is not available "
                   f"({unavailable_reason(name)})" if use_native is None
                   else f"use_native={use_native}")
        raise RuntimeError(f"no reader for {what}: {runtime}, and cv2 "
                           "(opencv-python) is not installed") from exc
    return cv2


def decode_jpeg_file(path):
    """A JPEG file -> [H, W, 3] uint8 RGB (libjpeg, ``JCS_RGB``); raises
    ``ValueError`` when libjpeg cannot decode it."""
    lib = library("image_io")
    with open(path, "rb") as fh:
        data = fh.read()
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    ptr = lib.vn_decode_jpeg(data, len(data), ctypes.byref(w),
                             ctypes.byref(h))
    if not ptr:
        raise ValueError(f"{path}: libjpeg could not decode the file")
    try:
        buf = (ctypes.c_uint8 * (w.value * h.value * 3)).from_address(ptr)
        return np.frombuffer(buf, np.uint8).reshape(h.value, w.value,
                                                     3).copy()
    finally:
        lib.vn_free(ptr)


class VideoReader:
    """Frames of a video file as packed RGB uint8, a chunk at a time
    (libav; pixel formats converted with ``SWS_BILINEAR``). Use it as a
    context manager, or call ``close``."""

    def __init__(self, path):
        self._lib = library("video_io")
        self._h = self._lib.vn_video_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open video {path}")
        self.width = self._lib.vn_video_width(self._h)
        self.height = self._lib.vn_video_height(self._h)
        self.fps = self._lib.vn_video_fps(self._h) or 25.0
        self.nframes = self._lib.vn_video_nframes(self._h)

    def read(self, n):
        """Up to ``n`` frames -> uint8 [m, H, W, 3], m < n only at the end
        of the stream (0 after it)."""
        if not self._h:
            raise ValueError("read from a closed VideoReader")
        buf = np.empty((n, self.height, self.width, 3), dtype=np.uint8)
        got = self._lib.vn_video_read(self._h, buf.ctypes.data, n)
        return buf[:got]

    def close(self):
        if self._h:
            self._lib.vn_video_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
