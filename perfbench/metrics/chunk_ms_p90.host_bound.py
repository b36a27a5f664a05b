"""The 90th percentile of the untraced window's chunk latencies, in the
cells whose card idles a third of the traced window or more (the upload
and the host's dispatch set their pace): their runs spread 4-10% against
the production crowd cell's 1%, so there the tail stands beside
``frames_per_s.host_bound`` as a per-layer metric rather than under
``chunk_ms_p90``'s bound."""

from perfbench.harness import p90


def read(ctx):
    return p90(ctx.window["latencies"]) * 1e3
