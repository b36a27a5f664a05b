"""K5 (the RNet and ONet trunks) against its roofline: every crop slot
the cascade's caps give read once, the trunk's output written once, the
trunk's FLOPs."""

from perfbench import counts
from perfbench.readers import roofline_pct
from perfbench.reference.detect import mtcnn_caps


def read(ctx):
    h, w = ctx.frame_hw
    caps = mtcnn_caps(h, w, ctx.cfg["detector"]["args"])
    item = counts.ITEMSIZE[ctx.dtype]
    work = [0, 0]
    for b in ctx.calls["detector"]:
        for net, cap in (("rnet", "rnet_cap"), ("onet", "onet_cap")):
            nbytes, flops = counts.trunk_work(net, b * caps[cap], item)
            work[0] += nbytes
            work[1] += flops
    return roofline_pct(ctx, "crop_net_trunk", work)
