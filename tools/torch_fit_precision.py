#!/usr/bin/env python3
"""How far one detector train step's f32 gradients lie from f64, on the
card and on the CPU.

Takes the vendored fitted RetinaFace weights and a net fitted for
``--fit_steps`` steps by ``cli.fit_detector`` (seed 0), then computes one
train step's loss and parameter gradients on ``--batch`` synthetic scenes
of ``--size`` px three ways: on the card in f32 (TF32 off), on the CPU in
f32 and on the CPU in f64. For each pair it prints the relative L2
distance of all gradients, the five tensors farthest apart (relative L2,
max abs, the reference's norm) and how many hard-negative choices differ.
It also reruns the card's step with the CPU's mined negatives, to tell
mining from arithmetic.

  python3 tools/torch_fit_precision.py [--size 640 --batch 2 --fit_steps 40]

On a machine without a card, ``--device cpu`` compares the CPU with
itself (a rehearsal of the script).
"""

import argparse
import contextlib
import copy
import io
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vn_celeb_face_recognition_tpu_torch.cli import fit_detector as FD  # noqa: E402
from vn_celeb_face_recognition_tpu_torch.models import retinaface as TR  # noqa: E402
from vn_celeb_face_recognition_tpu_torch.models.layers import load_npz  # noqa: E402
from vn_celeb_face_recognition_tpu_torch.ops import boxes as B  # noqa: E402
from vn_celeb_face_recognition_tpu_torch.training import (  # noqa: E402
    multibox_loss as ML,
)
from vn_celeb_face_recognition_tpu_torch.training.detector import (  # noqa: E402
    synth_batch,
)
from vn_celeb_face_recognition_tpu_torch.utils import kernels  # noqa: E402


def step_grads(net, batch, priors, where, dtype, mask=None):
    """(losses, {name: f64 gradient}, mined negatives) of one train step;
    ``mask`` replaces the step's own mined negatives."""
    net = copy.deepcopy(net).to(where, dtype).train()
    net.dtype = dtype
    kernels.forget_folds(net)
    frames, boxes, labels, landms, valid = batch
    loc, conf, landm = net(torch.from_numpy(frames).to(where))
    targets = B.match_priors(
        torch.from_numpy(boxes).to(where, dtype),
        torch.from_numpy(labels.astype(np.int64)).to(where),
        torch.from_numpy(landms).to(where, dtype), priors.to(where, dtype),
        tuple(TR.cfg_mnet["variance"]), 0.35,
        torch.from_numpy(valid).to(where))
    mined = {}
    own = ML.mined_negatives

    def mine(ce, pos, ratio):
        mined["mask"] = own(ce, pos, ratio).cpu()
        return mined["mask"].to(where) if mask is None else mask.to(where)

    ML.mined_negatives = mine
    try:
        losses = ML.multibox_loss((loc, conf, landm), targets)
    finally:
        ML.mined_negatives = own
    losses["loss"].backward()
    losses = {k: v.detach() for k, v in losses.items()}
    grads = {n: p.grad.detach().cpu().double()
             for n, p in net.named_parameters()}
    return ({k: v.item() for k, v in losses.items()}, grads, mined["mask"])


def compare(what, got, want):
    rows = sorted(((float((got[k] - want[k]).norm())
                    / max(float(want[k].norm()), 1e-30),
                    float((got[k] - want[k]).abs().max()),
                    float(want[k].norm()), k) for k in want), reverse=True)
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    print(f"{what}: gradients rel L2 {(num / den) ** 0.5:.3e}, max abs "
          f"{max(r[1] for r in rows):.3e}; farthest: "
          + "; ".join(f"{k} rel L2 {a:.2e} max {b:.2e} |ref| {c:.2e}"
                      for a, b, c, k in rows[:5]), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--fit_steps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
    crops = FD.load_crops()
    with np.load(os.path.join(FD.ROOT, "meta_data",
                              "crop_landmarks.npz")) as z:
        lms = z["landmarks"]
    batch = synth_batch(np.random.default_rng(args.seed), args.batch,
                        args.size, crops, lms)
    priors = torch.from_numpy(B.make_priors(
        (args.size, args.size), TR.cfg_mnet["min_sizes"],
        TR.cfg_mnet["steps"]))
    nets = {"vendored": load_npz(TR.RetinaFaceNet(phase="train"),
                                 TR.WEIGHTS_NPZ)}
    with tempfile.TemporaryDirectory() as work, \
            contextlib.redirect_stdout(io.StringIO()):
        res = FD.main(["--steps", str(args.fit_steps), "--eval_every", "0",
                       "--size", str(args.size), "-dv", args.device,
                       "--out", os.path.join(work, "fit.npz")])
    nets[f"fit{args.fit_steps}"] = res["fit"].net.cpu()
    cpu = torch.device("cpu")
    for name, net in nets.items():
        lg, gg, mg = step_grads(net, batch, priors, dev, torch.float32)
        lc, gc, mc = step_grads(net, batch, priors, cpu, torch.float32)
        l64, g64, m64 = step_grads(net, batch, priors, cpu, torch.float64)
        print(f"[{name}] losses card f32 {lg}, CPU f32 {lc}, CPU f64 {l64}; "
              f"mined negatives differing card/CPU "
              f"{int((mg != mc).sum())}, CPU f32/f64 "
              f"{int((mc != m64).sum())}", flush=True)
        compare(f"[{name}] card f32 vs CPU f32", gg, gc)
        compare(f"[{name}] card f32 vs CPU f64", gg, g64)
        compare(f"[{name}] CPU f32 vs CPU f64", gc, g64)
        compare(f"[{name}] card f32 with the CPU's mining vs CPU f32",
                step_grads(net, batch, priors, dev, torch.float32, mc)[1],
                gc)


if __name__ == "__main__":
    main()
