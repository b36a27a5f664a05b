"""The block of a global batch that this process holds.

Under a data-parallel mesh (``parallel``) each process holds one
contiguous block of the leading axis of every global batch: block
``index`` of ``count`` equal blocks. The JAX package runs one SPMD program
over the whole batch, so its random draws (augmentation parameters,
dropout masks) are drawn for the global batch. The port does the same:
inside ``batch_block(index, count)`` the functions that draw per-row
randomness from a ``torch.Generator`` draw for ``count`` times their
local rows and keep their own block, so every process advances its
generator exactly as a one-process run does and a row's draw does not
depend on the number of processes.

Outside the context the block is (0, 1): the whole batch.
"""

import contextlib
import threading

_local = threading.local()


def current_block():
    """(index, count) of this process's block of the global batch."""
    return getattr(_local, "block", (0, 1))


@contextlib.contextmanager
def batch_block(index, count):
    """Draws made inside are drawn for ``count`` blocks of the local
    batch's rows; each keeps block ``index``."""
    prev = current_block()
    _local.block = (int(index), int(count))
    try:
        yield
    finally:
        _local.block = prev


def global_rows(n_local):
    """The global batch's row count for a local block of ``n_local``."""
    return n_local * current_block()[1]


def keep_block(t, n_local, dim=0):
    """``t``, drawn for the global batch along ``dim``, cut to this
    process's block of ``n_local`` rows."""
    index, count = current_block()
    if count == 1:
        return t
    return t.narrow(dim, index * n_local, n_local)
