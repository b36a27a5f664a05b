"""RetinaFace cfg_mnet with the fitted weights the repo vendors."""

import os

from perfbench import ROOT, counts
from perfbench.reference import detect, nets
from perfbench.weights import read_npz

KIND = "detector"


def program(spec, dtype, device, seed):
    from vn_celeb_face_recognition_tpu_torch.models.retinaface import (
        RetinaFace,
    )

    det = RetinaFace(backbone_cfg=spec["backbone_cfg"],
                     weights_path=os.path.join(ROOT, spec["weights"]),
                     dtype=dtype, device=device, **spec["args"])
    if det.out_cap != spec["out_cap"]:
        raise ValueError(f"the program keeps {det.out_cap} faces a frame, "
                         f"the configuration states {spec['out_cap']}")
    return det


def reference(spec, seed, device):
    net = nets.RetinaFaceMnet().to(device).eval()
    net.load_state_dict(read_npz(os.path.join(ROOT, spec["weights"]),
                                 device))
    a = spec["args"]
    nms_cap = min(a["nms_cap"], a["topk_bf_nms"])

    def run(frames):
        return detect.retinaface(net, frames, a["conf_thres"], nms_cap,
                                 a["nms_thres"], a["vis_thres"],
                                 spec["out_cap"])

    run.thresholds = (a["vis_thres"],)
    return run


def flops(spec, ctx):
    """Model FLOPs of the net on one frame."""
    h, w = ctx.frame_hw
    return counts.model_flops(counts.meta_module(nets.RetinaFaceMnet), 1, h,
                              w, 3)
