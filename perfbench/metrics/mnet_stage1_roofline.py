"""K6 (RetinaFace's MobileNet stage 1) against its roofline: the frames
read once, the stage's output written once, its FLOPs."""

from perfbench import counts
from perfbench.readers import roofline_pct


def read(ctx):
    h, w = ctx.frame_hw
    item = counts.ITEMSIZE[ctx.dtype]
    work = [0, 0]
    for b in ctx.calls["detector"]:
        nbytes, flops = counts.mnet_stage1_work(b, h, w, item)
        work[0] += nbytes
        work[1] += flops
    return roofline_pct(ctx, "mnet_stage1", work)
