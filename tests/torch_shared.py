"""Expensive module fixtures of the port's tests, computed once a run.

Under pytest-xdist with ``--dist load`` the tests of one module are spread
over every worker, and each worker that gets one of them runs the module's
fixtures again; it runs them once more whenever it comes back to the module
after another one, since pytest tears a module's fixtures down when the
next test belongs to another module. ``once_a_run`` keeps such a fixture to
one computation a run, as pytest-xdist's documentation shows ("Making
session-scoped fixtures execute only once"): the first worker that asks
computes the data while it holds an exclusive ``fcntl.flock`` on a file in
the directory that every worker of the run shares
(``tmp_path_factory.getbasetemp().parent``) and saves it there as a pickle;
the other workers wait on the lock and load the file. Without xdist the data
is computed in place. The data must be numpy arrays and plain Python (no
torch modules or tensors, no JAX arrays): a test that holds a torch module
rebuilds it from the saved numpy weights. Files that the computation writes
(checkpoints, datasets) stay where it wrote them, under the computing
worker's temporary directory, which lives as long as the run."""

import fcntl
import os
import pickle

import numpy as np
import pytest


def plain(tree):
    """``tree`` with every JAX array in it as a numpy array (dicts, lists
    and tuples walked): the same values, in the form the shared file
    holds."""
    if isinstance(tree, dict):
        return type(tree)((k, plain(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(plain(v) for v in tree)
    if type(tree).__module__.split(".")[0] in ("jax", "jaxlib"):
        return np.asarray(tree)
    return tree


def once_a_run(tmp_path_factory, name, compute):
    """``compute()`` once a test run across the xdist workers (its JAX
    arrays as numpy, ``plain``); ``name`` keys the shared file and must be
    unique in the test suite. A computation must not call ``once_a_run``
    itself: two workers could then wait on each other's locks."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return plain(compute())
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"torch_shared_{name}.pkl"
    with open(root / f"torch_shared_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as fh:
                return pickle.load(fh)
        data = plain(compute())
        tmp = root / f"torch_shared_{name}.{os.getpid()}.tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(data, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        return data


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Torch on two threads while a module's tests run (six xdist workers
    share the CPUs), the old count restored after. A test module
    takes it with ``from torch_shared import two_threads``."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# what the JAX package's native loader binds (vn_celeb_face_recognition_tpu/
# native/loader.py): a library without one of them cannot stand in for it
JAX_RUNTIME_SYMBOLS = (
    "vn_decode_file", "vn_video_open", "vn_video_width", "vn_video_height",
    "vn_video_fps", "vn_video_nframes", "vn_video_read", "vn_video_close",
    "vn_loader_create", "vn_loader_next", "vn_loader_destroy")


def build_jax_runtime(out_dir):
    """The JAX package's IO runtime (libvnruntime.so) built by its own
    CMakeLists.txt, as its ``native.loader.build`` does, into ``out_dir``;
    returns the library's path once it exports every symbol the JAX loader
    binds."""
    import ctypes
    import shutil
    import subprocess

    from vn_celeb_face_recognition_tpu.native import loader

    gen = ["-G", "Ninja"] if shutil.which("ninja") else []
    for cmd in (["cmake", *gen, "-S", os.path.dirname(loader._BUILD_DIR),
                 "-B", str(out_dir)],
                ["cmake", "--build", str(out_dir), "-j"]):
        subprocess.run(cmd, check=True, capture_output=True)
    path = os.path.join(str(out_dir), "libvnruntime.so")
    lib = ctypes.CDLL(path)
    for name in JAX_RUNTIME_SYMBOLS:
        getattr(lib, name)
    return path


@pytest.fixture(scope="module", autouse=True)
def jax_runtime(tmp_path_factory):
    """The JAX package's IO runtime for the module's comparisons, built once
    a run (``once_a_run``) outside the package, and bound in its loader
    while the module runs (``_LIB_PATH``, ``_lib``; restored after).

    The JAX package builds its runtime lazily into one directory of the
    checkout, and ``tests/test_native_io.py`` asks for it while it is
    collected: under xdist every worker runs that CMake build in the same
    directory at once, and such a race has left a library without
    ``vn_loader_create``. A worker that loaded it cannot load another file
    by the same path, its JAX decode raises, and the JAX ``demo_video``'s
    reader thread then dies before it queues its sentinel, so
    ``frame_chunks`` waits forever. Where the runtime does not build (no
    cmake, no libav headers), nothing is bound. A module takes this
    fixture with ``from torch_shared import jax_runtime``."""
    import subprocess

    from vn_celeb_face_recognition_tpu.native import loader

    try:
        path = once_a_run(tmp_path_factory, "jax_runtime", lambda: (
            build_jax_runtime(tmp_path_factory.mktemp("jax_runtime"))))
    except (OSError, AttributeError, subprocess.CalledProcessError):
        # no runtime builds here: the module's tests that need it fail as
        # they would without this fixture, the others run
        yield None
        return
    saved = loader._LIB_PATH, loader._lib
    loader._LIB_PATH, loader._lib = path, None
    yield path
    loader._LIB_PATH, loader._lib = saved
