"""Tracing and per-stage host timers.

Counterpart of ``vn_celeb_face_recognition_tpu/utils/tracing.py``:

  * ``StageTimer``: named wall-clock timers with running totals, the
    per-layer host breakdown of the recognition library (detect, align,
    embed, classify, emotion); ``report`` and ``log`` print what the JAX
    package's do;
  * ``trace(log_dir)``: a ``torch.profiler`` trace of a region, written as
    a Chrome trace under ``log_dir`` (a no-op without a directory);
  * ``annotate(name)``: labels a region in that trace, and on a CUDA device
    also pushes an NVTX range; ``timed_stage(timer, name)`` adds a
    ``StageTimer`` stage to it when a timer is given.

A stage's time is host time: a region that launches device work and does
not wait for it measures the enqueue. The library's stages end in a copy to
the host, which waits.
"""

import contextlib
import os
import time
from collections import defaultdict

import torch


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self):
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(
                    1000.0 * self.totals[name] / max(self.counts[name], 1),
                    2,
                ),
            }
            for name in sorted(self.totals)
        }

    def log(self, printer=print):
        for name, stats in self.report().items():
            printer(
                f"  stage {name:20s} total {stats['total_s']:8.2f}s  "
                f"mean {stats['mean_ms']:8.2f}ms  x{stats['count']}"
            )


@contextlib.contextmanager
def trace(log_dir=None):
    """Trace the region with ``torch.profiler`` (the CPU, and the card when
    one is visible) and write ``trace.json`` under ``log_dir``; a no-op
    when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name, device=None):
    """Label the region ``name`` in a ``torch.profiler`` trace; on a CUDA
    ``device`` also push an NVTX range around it."""
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def timed_stage(timer, name, device=None):
    """``annotate(name, device)`` around the region, timed as stage
    ``name`` of ``timer`` when one is given."""
    with annotate(name, device):
        if timer is None:
            yield
        else:
            with timer.stage(name):
                yield
