"""Run a function in one process per device under ``torch.distributed``.

``launch(fn, n_devices, device, *args)`` spawns ``n_devices`` processes
(the spawn start method: a child imports only what ``fn``'s module
imports), joins them in one process group through a ``FileStore`` in a
temporary directory (nothing leaves the machine), and calls ``fn(*args)``
in each. ``device`` "cuda" initialises NCCL and gives rank ``r`` card
``r``; "cpu" initialises gloo. A CUDA request never falls back to gloo or
the CPU.

Rank 0's return value is returned. If any rank raises, or a process dies,
the others are stopped and the launch raises with that rank's traceback;
``timeout`` (seconds, None for no limit) bounds the whole launch, and the
group's own collective timeout bounds a collective whose peer is gone.
"""

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a collective that waits longer than this for a peer raises in its rank
COLLECTIVE_TIMEOUT_S = 600


class LaunchError(RuntimeError):
    """A rank of a launch raised, died or ran out of time."""


def resolve_devices(n_devices, device):
    """``n_devices`` with 0 read as every visible card (one process on the
    CPU). Asking for more cards than are visible exits with the JAX CLI's
    message."""
    n_devices = int(n_devices)
    if torch.device(device).type != "cuda":
        return max(n_devices, 1)
    avail = torch.cuda.device_count()
    if n_devices == 0:
        n_devices = avail
    if n_devices > avail:
        raise SystemExit(f"--n_devices {n_devices} requested but only "
                         f"{avail} device(s) are visible")
    return n_devices


def _child(rank, world, kind, store_path, threads, results, fn, args):
    try:
        if threads:
            torch.set_num_threads(threads)
        if kind == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            "nccl" if kind == "cuda" else "gloo", store=store, rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        out = fn(*args)
        message = (rank, True, out if rank == 0 else None)
    except BaseException:  # reported to the parent, which raises it
        message = (rank, False, traceback.format_exc())
    # reported before the group closes, so a rank that raised is heard
    # before its peers' broken collectives
    results.put(message)
    if dist.is_initialized():
        dist.destroy_process_group()


def _failures(results, rank, world, value, grace=2.0):
    """The first failed rank's traceback, and those of the ranks that fail
    within ``grace`` seconds after it (their peers' collectives break)."""
    parts = [f"rank {rank} of {world} raised:\n{value}"]
    end = time.monotonic() + grace
    while time.monotonic() < end:
        try:
            r, ok, v = results.get(timeout=max(end - time.monotonic(), 0.01))
        except queue.Empty:
            break
        if not ok:
            parts.append(f"rank {r} of {world} raised:\n{v}")
    return "\n".join(parts)


def launch(fn, n_devices, device, *args, timeout=None, threads=None):
    """``fn(*args)`` in ``n_devices`` processes of one group (NCCL for
    ``device`` "cuda", gloo for "cpu"); rank 0's result. ``fn`` and
    ``args`` must pickle; ``fn`` must be importable from its module.
    ``threads`` pins each child's torch threads."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"launch runs on 'cuda' or 'cpu', not {device!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch on 'cuda' requested but torch sees no "
                           "CUDA device")
    world = resolve_devices(n_devices, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="launch_")
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_child,
                         args=(r, world, kind, store_path, threads, results,
                               fn, args), daemon=True)
             for r in range(world)]
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        done = {}
        while len(done) < world:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in done and not p.is_alive():
                        # its message may still be in flight
                        try:
                            rank, ok, value = results.get(timeout=1.0)
                        except queue.Empty:
                            raise LaunchError(
                                f"rank {r} of {world} died (exit code "
                                f"{p.exitcode}) without a result") from None
                        break
                else:
                    if deadline is not None and time.monotonic() > deadline:
                        raise LaunchError(
                            f"launch of {getattr(fn, '__name__', fn)} on "
                            f"{world} {kind} process(es) ran past its "
                            f"{timeout} s limit")
                    continue
            if not ok:
                raise LaunchError(_failures(results, rank, world, value))
            done[rank] = value
        for p in procs:
            p.join()
        return done[0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
