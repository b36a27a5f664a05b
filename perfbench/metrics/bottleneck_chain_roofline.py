"""K8 (the emotion net's layer1 and layer2 tails) against its roofline:
each chain's input read and output written once, its FLOPs, on every
face slot the emotion net ran."""

from perfbench import counts
from perfbench.readers import roofline_pct


def read(ctx):
    item = counts.ITEMSIZE[ctx.dtype]
    work = [0, 0]
    for k in ctx.calls.get("emotion", []):
        nbytes, flops = counts.bottleneck_chain_work(k, item)
        work[0] += nbytes
        work[1] += flops
    return roofline_pct(ctx, "bottleneck_chain", work)
