"""Spans around the program's layers, a torch.profiler session over
steady chunks, and the reduction of its trace to per-chunk device times.

The spans exist only in a traced run: the harness wraps the objects it
hands the engine (``spanned``, ``Spanned``) so that each call opens a
``record_function`` range, and records each call's batch size. The
profiler traces the CPU and the card; its Chrome trace is written once,
read back and deleted. Every device operation (kernel, copy, fill) is
tied, through the runtime call that launched it, to the innermost span the
host was in at that moment.
"""

import bisect
import json
import os
import re

import torch
from torch import nn

CHUNK = "pb.chunk"
SPANS = {"upload": "pb.upload", "detect": "pb.detect", "embed": "pb.embed",
         "classify": "pb.classify", "emotion": "pb.emotion",
         "identify": "pb.identify"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def spanned(fn, name, calls=None):
    """``fn`` inside a span; each call's first argument's batch size is
    appended to ``calls`` when given."""
    def wrapper(*args, **kwargs):
        if calls is not None and args and hasattr(args[0], "shape"):
            calls.append(int(args[0].shape[0]))
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


class Spanned(nn.Module):
    """A module whose calls (and ``forward_normalized``) open a span."""

    def __init__(self, inner, name, calls):
        super().__init__()
        self.inner, self.span, self.calls = inner, name, calls

    def forward(self, *args, **kwargs):
        return spanned(self.inner, self.span, self.calls)(*args, **kwargs)

    def forward_normalized(self, *args, **kwargs):
        return spanned(self.inner.forward_normalized, self.span,
                       self.calls)(*args, **kwargs)


def is_grid(name, grids):
    """Whether a profiler kernel name (demangled or not) is one of the
    device functions ``grids``, matched as a whole name."""
    return any(re.search(rf"(?:^|[^A-Za-z_]){re.escape(g)}(?:[<(IE]|$)",
                         name) for g in grids)


class Trace:
    """The device operations of the traced window: ``ops`` is a list of
    (name, category, start_s, seconds, span); ``window_s`` the traced
    window's length; spans named as ``SPANS``' values, ``pb.engine``
    (inside a chunk, outside the wrapped layers) or ``harness``."""

    def __init__(self, events):
        steps = [e for e in events if e.get("ph") == "X"
                 and str(e.get("name", "")).startswith("ProfilerStep#")]
        if not steps:
            raise RuntimeError("the trace has no profiler steps")
        self.t0 = min(e["ts"] for e in steps)
        self.t1 = max(e["ts"] + e["dur"] for e in steps)
        self.window_s = (self.t1 - self.t0) * 1e-6
        names = set(SPANS.values()) | {CHUNK}
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in events if e.get("ph") == "X"
                       and e.get("name") in names)
        self._spans = spans
        self._starts = [s[0] for s in spans]
        launch = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = e["ts"]
        self.ops = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            if e["ts"] + e["dur"] < self.t0 or e["ts"] > self.t1:
                continue
            corr = (e.get("args") or {}).get("correlation")
            host = launch.get(corr)
            span = self.span_at(host) if host is not None else "harness"
            self.ops.append((e["name"], e["cat"], (e["ts"] - self.t0) * 1e-6,
                             e["dur"] * 1e-6, span))
        self.ops.sort(key=lambda o: o[2])

    def span_at(self, t):
        """The innermost span around host time ``t`` (trace microseconds)."""
        i = bisect.bisect_right(self._starts, t)
        best = None
        for s, e, name in reversed(self._spans[:i]):
            if s <= t <= e:
                if name != CHUNK:
                    return name
                best = best or "pb.engine"
        return best or "harness"

    def device_s(self, span=None, grids=None, cats=DEVICE_CATS):
        """Summed seconds of the device operations of ``cats`` launched in
        ``span`` (any, when None) whose names are ``grids`` (any, when
        None)."""
        return sum(d for n, c, _, d, s in self.ops
                   if c in cats and (span is None or s == span)
                   and (grids is None or is_grid(n, grids)))

    def count(self, grids):
        return sum(1 for n, c, *_ in self.ops
                   if c == "kernel" and is_grid(n, grids))

    def union_s(self, cats=DEVICE_CATS):
        """Seconds of the window in which an operation of ``cats`` ran."""
        total, end = 0.0, 0.0
        for _, c, start, dur, _ in self.ops:
            if c not in cats:
                continue
            stop = start + dur
            if stop > end:
                total += stop - max(start, end)
                end = stop
        return total

    def idle_by_span(self):
        """Seconds the card ran nothing, by the span the host was in at the
        middle of each gap."""
        out, end = {}, 0.0
        gaps = []
        for _, _, start, dur, _ in self.ops:
            if start > end:
                gaps.append((end, start))
            end = max(end, start + dur)
        if self.window_s > end:
            gaps.append((end, self.window_s))
        for a, b in gaps:
            name = self.span_at(self.t0 + (a + b) / 2 * 1e6)
            out[name] = out.get(name, 0.0) + (b - a)
        return out

    def top_ops(self, n=10):
        by = {}
        for name, _, _, dur, _ in self.ops:
            by[name[:120]] = by.get(name[:120], 0.0) + dur
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def profile(step, n_chunks, path):
    """``step(i)`` for i = 0 .. n_chunks under torch.profiler; step 0 warms
    the session up and is dropped (a session's first device events are
    lost on this card). Returns the ``Trace`` of steps 1 .. n_chunks."""
    from torch.profiler import ProfilerActivity, schedule

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=n_chunks, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for i in range(n_chunks + 1):
            step(i)
            prof.step()
    try:
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)
