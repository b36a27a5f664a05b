"""What the per-layer readers (``metrics/<name>.py``) share: per-chunk
device times from the trace, the idle share, a kernel's share of its
roofline, and the model FLOPs of the window. A reader that finds nothing
to read returns None, and the harness leaves its metric out."""

from perfbench import counts
from perfbench.weights import ROLES


def span_ms(ctx, *spans):
    """Device ms a chunk of the operations launched inside ``spans``."""
    return sum(ctx.trace.device_s(span=s) for s in spans) / ctx.n_chunks * 1e3


def h2d_ms(ctx):
    """Device ms a chunk of host-to-device copies: the chunk's upload."""
    s = sum(d for name, cat, _, d, _ in ctx.trace.ops
            if cat == "gpu_memcpy" and "HtoD" in name)
    return s / ctx.n_chunks * 1e3


def idle_pct(ctx):
    """Share of the traced window in which no kernel ran (copies count as
    idle)."""
    busy = ctx.trace.union_s(cats=("kernel",))
    return 100.0 * (1.0 - busy / ctx.trace.window_s)


def roofline_pct(ctx, kernel, work):
    """100 x the least time of ``work`` = (bytes, FLOPs) over the traced
    chunks, at the configuration dtype's tensor-core rate, over the device
    time of ``kernel``'s grids; None (with a note) when the trace holds
    another number of its grids than the program launched, or none."""
    grids = counts.KERNEL_GRIDS[kernel]
    seen, launched = ctx.trace.count(grids), ctx.launches.get(kernel, 0)
    if seen == 0 or seen != launched:
        ctx.say(f"note: {kernel}: the trace holds {seen} of its grids, the "
                f"program launched {launched}; no roofline")
        return None
    t = ctx.trace.device_s(grids=grids, cats=("kernel",))
    least, _ = counts.bound_s(*work, counts.RATE[ctx.dtype])
    return 100.0 * least / t


def mfu_pct(ctx):
    """The window's model FLOPs (the detector on every frame, the per-face
    nets once for every valid face identified; padded slots are waste, not
    work; each net counted by its ``nets/<net>.py``) over its seconds,
    against the 495 TFLOP/s TF32 peak."""
    from perfbench.harness import net_module

    win, cfg = ctx.window, ctx.cfg
    flops = 0.0
    for role in ROLES:
        if cfg.get(role):
            n = win["frames"] if role == "detector" else win["faces"]
            flops += n * net_module(cfg[role]["net"]).flops(cfg[role], ctx)
    return 100.0 * flops / win["seconds"] / counts.PEAK_TF32
