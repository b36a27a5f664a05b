"""The program's own spans in a ``torch.profiler`` Chrome trace.

The port opens its spans with ``utils.tracing.annotate``: host
``record_function`` ranges (category ``user_annotation``) named
``engine.*``, ``mtcnn.*`` and ``retinaface.*``, on the profiler's clock.
``ProgramTrace`` keeps those ranges, the runtime calls that launch device
work (kernel launches, copies, memsets) and the device operations of the
traced window (the ``ProfilerStep#`` ranges), and ties each operation,
through the correlation id of the call that launched it, to the innermost
program span the host was in then. The harness's own ``pb.*`` ranges, and
the device-side copies of every range (``gpu_user_annotation``), are not
program spans and are left out.

What it gives, over the window (the readers divide by the chunks):
  * ``device_s(span)``: device seconds launched inside a span;
  * ``dispatch_s()``: host seconds inside ``engine.chunk`` and
    ``engine.identify`` less those inside ``engine.upload``, ``engine.sync``
    and ``engine.identify.fetch`` (the copies and the wait);
  * ``launches()``: launching runtime calls inside ``engine.chunk`` and
    ``engine.identify``, by innermost program span;
  * ``self_s()``: each span's duration less the parts its child spans
    cover, by name;
  * ``idle_by_span()``: seconds the card ran nothing, by the innermost
    program span the host was in at the middle of each gap ("outside"
    when in none).
"""

import bisect

PREFIXES = ("engine.", "mtcnn.", "retinaface.")
TOP = ("engine.chunk", "engine.identify")
WAITS = ("engine.upload", "engine.sync", "engine.identify.fetch")
OUTSIDE = "outside"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
LAUNCHING = ("Launch", "Memcpy", "Memset")


def is_program_span(e):
    return (e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(PREFIXES))


class ProgramTrace:
    def __init__(self, events):
        steps = [e for e in events if e.get("ph") == "X"
                 and str(e.get("name", "")).startswith("ProfilerStep#")]
        if not steps:
            raise RuntimeError("the trace has no profiler steps")
        self.t0 = min(e["ts"] for e in steps)
        self.t1 = max(e["ts"] + e["dur"] for e in steps)
        self.window_s = (self.t1 - self.t0) * 1e-6
        inside = [e for e in events
                  if e.get("ph") == "X" and self.t0 <= e["ts"] <= self.t1]
        # (start, end, name), an enclosing span before those it holds
        self.spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                             for e in inside if is_program_span(e)),
                            key=lambda s: (s[0], -s[1]))
        self._starts = [s[0] for s in self.spans]
        launched = {}
        self.calls = []  # (host time, correlation) of each launching call
        for e in inside:
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") not in RUNTIME_CATS or corr is None:
                continue
            launched[corr] = e["ts"]
            if any(w in e["name"] for w in LAUNCHING):
                self.calls.append((e["ts"], corr))
        self.ops = []  # (name, category, start_s, seconds, span)
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            if e["ts"] + e["dur"] < self.t0 or e["ts"] > self.t1:
                continue
            host = launched.get((e.get("args") or {}).get("correlation"))
            span = self.span_at(host) if host is not None else OUTSIDE
            self.ops.append((e["name"], e["cat"], (e["ts"] - self.t0) * 1e-6,
                             e["dur"] * 1e-6, span))
        self.ops.sort(key=lambda o: o[2])

    def span_at(self, t):
        """The innermost program span around host time ``t`` (trace
        microseconds), else ``OUTSIDE``."""
        for s, e, name in reversed(self.spans[:bisect.bisect_right(
                self._starts, t)]):
            if s <= t <= e:
                return name
        return OUTSIDE

    def _within(self, names):
        return [(s, e, n) for s, e, n in self.spans if n in names]

    def device_s(self, span):
        return sum(d for _, _, _, d, s in self.ops if s == span)

    def dispatch_s(self):
        host = sum(e - s for s, e, _ in self._within(TOP))
        waits = sum(e - s for s, e, _ in self._within(WAITS))
        return (host - waits) * 1e-6

    def launches(self):
        """{innermost program span: launching runtime calls} over the calls
        inside ``TOP`` spans, one per correlation id."""
        tops = self._within(TOP)
        out, seen = {}, set()
        for t, corr in self.calls:
            if corr in seen or not any(s <= t <= e for s, e, _ in tops):
                continue
            seen.add(corr)
            name = self.span_at(t)
            out[name] = out.get(name, 0) + 1
        return out

    def self_s(self):
        """{span name: seconds} of each span less its child spans."""
        out, stack = {}, []
        for s, e, name in self.spans:
            while stack and stack[-1][1] <= s:
                stack.pop()
            out[name] = out.get(name, 0.0) + (e - s) * 1e-6
            if stack:
                parent = stack[-1][2]
                out[parent] -= (e - s) * 1e-6
            stack.append((s, e, name))
        return out

    def idle_by_span(self):
        out, end, gaps = {}, 0.0, []
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
