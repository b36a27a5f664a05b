"""Per-stage host timers, spans and counters.

Counterpart of ``vn_celeb_face_recognition_tpu/utils/tracing.py``:

  * ``StageTimer``: named wall-clock timers with running totals, the
    per-layer host breakdown of the recognition library (detect, align,
    embed, classify, emotion); ``report`` and ``log`` print what the JAX
    package's do;
  * ``annotate(name)``: a span, a ``torch.profiler.record_function`` range
    around the region, on the profiler's clock beside the device events it
    launches (under ``torch.autograd.profiler.emit_nvtx`` an NVTX range).
    With no profiler session running it enters nothing, so a span left in
    a hot loop costs one flag read; ``timed_stage(timer, name)`` adds a
    ``StageTimer`` stage to it when a timer is given;
  * ``count(name, n)``, ``counts()``, ``reset_counts()``: the process's one
    store of counters (``utils.kernels``' kernel launch counts are kept
    here too). A counter takes values the host already holds, such as
    shapes or a host copy, and never reads the device.

A stage's time is host time: a region that launches device work and does
not wait for it measures the enqueue. The library's stages end in a copy to
the host, which waits.
"""

import contextlib
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


_NO_SPAN = contextlib.nullcontext()


def annotate(name):
    """The span ``name`` around the region: a ``record_function`` range
    while a profiler (``torch.profiler`` or ``emit_nvtx``) is running,
    nothing otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def timed_stage(timer, name):
    """``annotate(name)`` around the region, timed as stage ``name`` of
    ``timer`` when one is given."""
    with annotate(name):
        if timer is None:
            yield
        else:
            with timer.stage(name):
                yield


_COUNTS = defaultdict(int)


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] += n


def counts():
    """Every counter of the process by name."""
    return dict(_COUNTS)


def reset_counts():
    _COUNTS.clear()
