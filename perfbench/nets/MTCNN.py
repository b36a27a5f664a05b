"""The MTCNN cascade with the published weights the repo vendors."""

import os

from perfbench import ROOT, counts
from perfbench.reference import detect, nets
from perfbench.weights import read_npz

KIND = "detector"


def program(spec, dtype, device, seed):
    from vn_celeb_face_recognition_tpu_torch.models.mtcnn import MTCNN

    return MTCNN(dtype=dtype, device=device,
                 weights_dir=os.path.join(ROOT, spec["weights"]),
                 **spec["args"])


def reference(spec, seed, device):
    trio = []
    for name, cls in (("pnet", nets.PNet), ("rnet", nets.RNet),
                      ("onet", nets.ONet)):
        net = cls().to(device).eval()
        net.load_state_dict(read_npz(
            os.path.join(ROOT, spec["weights"], name + ".npz"), device))
        trio.append(net)

    def run(frames):
        return detect.mtcnn(trio, frames, spec["args"])

    run.thresholds = tuple(spec["args"]["thresholds"])
    return run


def flops(spec, ctx):
    """Model FLOPs a frame: PNet on every pyramid level, and RNet and ONet
    on as many candidates a frame as the reference's cascade gave them on
    the judged chunks."""
    h, w = ctx.frame_hw
    a = spec["args"]

    def of(cls, *shape):
        return counts.model_flops(counts.meta_module(cls), *shape)

    pnet = sum(of(nets.PNet, 1, 3, int(h * s + 1), int(w * s + 1))
               for s in detect.mtcnn_scales(h, w, a["min_face_size"],
                                            a["factor"]))
    return (pnet + (ctx.numbers["n_rnet"] * of(nets.RNet, 1, 3, 24, 24)
                    + ctx.numbers["n_onet"] * of(nets.ONet, 1, 3, 48, 48))
            / ctx.judged_frames)
