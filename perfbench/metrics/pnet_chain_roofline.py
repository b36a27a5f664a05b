"""K2 (the MTCNN pyramid and PNet) against its roofline: the integral
image read once, five floats a PNet cell written once, PNet's FLOPs on
every level."""

from perfbench import counts
from perfbench.readers import roofline_pct
from perfbench.reference.detect import mtcnn_scales


def read(ctx):
    h, w = ctx.frame_hw
    a = ctx.cfg["detector"]["args"]
    sizes = [(int(h * s + 1), int(w * s + 1))
             for s in mtcnn_scales(h, w, a["min_face_size"], a["factor"])]
    work = [0, 0]
    for b in ctx.calls["detector"]:
        nbytes, flops = counts.pnet_chain_work(b, h, w, sizes)
        work[0] += nbytes
        work[1] += flops
    return roofline_pct(ctx, "pnet_chain", work)
