"""Fit RetinaFace (cfg_mnet) from scratch on synthetic scenes, on the port.

Counterpart of the repo's ``tools/fit_detector.py``, with its flags: the
repo's face crops (``data/*.png``, read by the port's PNG reader) pasted
over varied backgrounds with exact box and landmark ground truth
(``training.detector.synth_batch``), AdamW with optax's cosine decay,
weight decay 5e-4, batch 8 at 640 px by default. Every ``--eval_every``
steps and at the end the net is evaluated in eval mode, as the detector
runs it (stage 1 through kernel K6, NMS through K3 on the card): anchors
above the confidence filter a frame and the recall at IoU 0.5, on 8
synthetic scenes and on ``utils.frames.build_frames`` frames (4 faces of
144 px on flat grey; at sizes below 288 px the faces are cut to half the
frame, where the JAX tool's frames do not fit). The trained weights are
written as the torch-keyed npz that both packages' ``RetinaFace(
weights_path=...)`` load, with a provenance ``.json`` beside it.

The crops' landmarks come from ``--landmarks_cache`` (the repo's
``meta_data/crop_landmarks.npz``); without it, the published-weight MTCNN
probes the crops on the device (kernels K2-K5 on the card) and the cache is
written.

  python -m vn_celeb_face_recognition_tpu_torch.cli.fit_detector \\
      --steps 1500 --out saved/retinaface_mnet025_fit.npz [-dv cpu]
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..models.convert import export_state_dict
from ..models.layers import seeded_init_
from ..models.retinaface import (
    INIT_SCALE,
    RetinaFace,
    RetinaFaceNet,
    cfg_mnet,
)
from ..ops import boxes as B
from ..training.detector import (
    conf_sparsity,
    detection_recall,
    make_detection_train_step,
    make_eval_fns,
    probe_crop_landmarks,
    synth_batch,
)
from ..training.optim import make_adamw_cosine
from ..utils.device import select_device
from ..utils.frames import build_frames, face_files, read_png
from ..utils.tracing import timed_stage

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
EVAL_BATCH, EVAL_SEED = 8, 12345
BENCH_FACES, BENCH_FACE_PX = 4, 144


def build_arg_parser():
    ap = argparse.ArgumentParser(
        description="Fit RetinaFace cfg_mnet on synthetic scenes (PyTorch "
                    "port)")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--max_faces", type=int, default=6)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval_every", type=int, default=250)
    ap.add_argument("--device", "-dv", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--landmarks_cache", default=os.path.join(
        ROOT, "meta_data", "crop_landmarks.npz"),
        help="npz of the crops' MTCNN-probed landmarks; probed and "
             "written when the file is missing")
    ap.add_argument("--out", default=os.path.join(
        "saved", "retinaface_mnet025_fit.npz"))
    return ap


def load_crops():
    """The repo's face crops (``data/*.png``) as RGB uint8 arrays."""
    files = face_files()
    if not files:
        raise FileNotFoundError("no face crops under data/")
    return [read_png(f) for f in files]


def crop_landmarks(crops, cache, device):
    """The crops' [N, 5, 2] landmarks from ``cache``, else probed (and
    written to ``cache`` when one is named)."""
    if cache and os.path.exists(cache):
        with np.load(cache) as z:
            lms = z["landmarks"]
        if lms.shape[0] != len(crops):
            raise ValueError(f"landmark cache {cache} holds {lms.shape[0]} "
                             f"crops, data/ {len(crops)}: point "
                             "--landmarks_cache at a fresh path")
        print(f"[fit] loaded cached crop landmarks ({cache})")
        return lms
    print(f"[fit] probing landmarks on {len(crops)} crops with the "
          "published-weight MTCNN ...")
    lms = probe_crop_landmarks(crops, device=device)
    if cache:
        np.savez_compressed(cache, landmarks=lms)
    return lms


def bench_boxes(batch, size):
    """``build_frames(batch, size, 4, face_px)``'s frames and their face
    boxes [batch, 4, 4] px: a 2x2 grid, each face centred in its cell."""
    face_px = min(BENCH_FACE_PX, size // 2)
    frames = build_frames(batch, size, BENCH_FACES, face_px=face_px)
    cell = size // 2
    pad = (cell - face_px) // 2
    boxes = np.zeros((batch, BENCH_FACES, 4), np.float32)
    for f in range(BENCH_FACES):
        r, c = divmod(f, 2)
        boxes[:, f] = (c * cell + pad, r * cell + pad,
                       c * cell + pad + face_px, r * cell + pad + face_px)
    return frames, boxes, np.ones((batch, BENCH_FACES), bool)


class DetectorFit:
    """The fit's state: crops and landmarks, the train-phase net seeded
    from ``--seed`` (lecun-normal, identity BatchNorm), AdamW + cosine, the
    train step, and a ``RetinaFace`` detector around the same net for the
    evaluations."""

    def __init__(self, args):
        self.args = args
        self.device = select_device(args.device)
        self.crops = load_crops()
        self.landmarks = crop_landmarks(self.crops, args.landmarks_cache,
                                        self.device)
        self.rng = np.random.default_rng(args.seed)
        net = RetinaFaceNet(torch.float32, cfg_mnet, phase="train")
        seeded_init_(net, torch.Generator().manual_seed(args.seed),
                     INIT_SCALE)
        self.net = net.to(self.device).train()
        priors = B.make_priors((args.size, args.size), cfg_mnet["min_sizes"],
                               cfg_mnet["steps"], cfg_mnet["clip"])
        self.optimizer, self.scheduler = make_adamw_cosine(
            self.net.parameters(), args.lr, args.steps)
        self.step = make_detection_train_step(
            self.net, torch.from_numpy(priors).to(self.device),
            tuple(cfg_mnet["variance"]), self.optimizer, self.scheduler)
        self.rf = RetinaFace(backbone_cfg="cfg_mnet", device=self.device)
        self.rf.net = self.net
        self.conf_fn, self.detect_fn = make_eval_fns(self.rf)
        self._eval_sets = None

    def batch(self):
        """One synthetic batch drawn on the host, on the device."""
        a = self.args
        frames, boxes, labels, landms, valid = synth_batch(
            self.rng, a.batch, a.size, self.crops, self.landmarks,
            max_faces=a.max_faces)
        return tuple(torch.from_numpy(x).to(self.device)
                     for x in (frames, boxes, labels.astype(np.int64),
                               landms, valid))

    def train_step(self, batch):
        return self.step(*batch)

    def eval_sets(self):
        """The evaluations' two frame sets, (frames, px boxes, valid)
        each: EVAL_BATCH synthetic scenes from EVAL_SEED and the bench
        frames; drawn once, the same for every evaluation."""
        if self._eval_sets is None:
            a = self.args
            frames, boxes, _, _, valid = synth_batch(
                np.random.default_rng(EVAL_SEED), EVAL_BATCH, a.size,
                self.crops, self.landmarks, max_faces=a.max_faces)
            self._eval_sets = ((frames, boxes * a.size, valid),
                               bench_boxes(EVAL_BATCH, a.size))
        return self._eval_sets

    def evaluate(self):
        """(synth sparsity, synth recall, bench sparsity, bench recall)."""
        out = []
        for frames, boxes, valid in self.eval_sets():
            out.append(conf_sparsity(self.rf, frames, conf_fn=self.conf_fn))
            out.append(detection_recall(self.rf, frames, boxes, valid,
                                        detect_fn=self.detect_fn))
        return tuple(out)

    def export(self, path, evaluation):
        """Write the net as a torch-keyed npz and its provenance json."""
        a = self.args
        sd = export_state_dict(self.net)
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez_compressed(path, **sd)
        sparse, rec, bsparse, brec = evaluation
        meta = {
            "provenance": "vn_celeb_face_recognition_tpu_torch.cli."
                          "fit_detector synthetic-scene fit (NOT the "
                          "published checkpoint; see WEIGHTS.md)",
            "steps": a.steps, "batch": a.batch, "size": a.size,
            "lr": a.lr, "seed": a.seed, "device": str(self.device),
            "synth_sparsity_anchors_per_frame": sparse,
            "synth_recall_iou50": rec,
            "bench_sparsity_anchors_per_frame": bsparse,
            "bench_recall_iou50": brec,
        }
        with open(path + ".json", "w") as fh:
            json.dump(meta, fh, indent=1)
        return sd


def _print_losses(i, losses, t0):
    v = {k: float(t) for k, t in losses.items()}
    print(f"[fit] step {i:5d} loss {v['loss']:.4f} (loc {v['loss_loc']:.4f} "
          f"conf {v['loss_conf']:.4f} landm {v['loss_landm']:.4f}) "
          f"{time.time() - t0:.0f}s", flush=True)


def main(argv=None, timer=None):
    """Run the fit; returns a dict with the per-step losses ([steps]
    float arrays by name), the evaluations ``(step, (synth sparsity,
    synth recall, bench sparsity, bench recall))``, the ``DetectorFit``
    and the written path. ``timer`` (a ``utils.tracing.StageTimer``)
    times the ``synth`` and ``step`` stages on the host's clock."""
    args = build_arg_parser().parse_args(argv)
    fit = DetectorFit(args)
    history, evals = [], []
    t0 = time.time()
    for i in range(args.steps):
        with timed_stage(timer, "synth", fit.device):
            batch = fit.batch()
        with timed_stage(timer, "step", fit.device):
            losses = fit.train_step(batch)
        history.append(losses)
        if i % 50 == 0 or i == args.steps - 1:
            _print_losses(i, losses, t0)
        if args.eval_every and i and i % args.eval_every == 0:
            sparse, rec, bsparse, brec = fit.evaluate()
            evals.append((i, (sparse, rec, bsparse, brec)))
            print(f"[fit] eval step {i}: synth sparsity {sparse:.0f} "
                  f"anchors/frame recall {rec:.3f} | bench sparsity "
                  f"{bsparse:.0f} recall {brec:.3f}", flush=True)
    final = fit.evaluate()
    evals.append((args.steps, final))
    sparse, rec, bsparse, brec = final
    print(f"[fit] final: synth sparsity {sparse:.0f} anchors/frame recall "
          f"{rec:.3f} | bench-frames sparsity {bsparse:.0f} recall "
          f"{brec:.3f}")
    fit.export(args.out, final)
    print(f"[fit] saved {args.out} ({os.path.getsize(args.out) / 1e6:.2f} "
          "MB) + provenance json")
    losses = {k: torch.stack([h[k] for h in history]).cpu().numpy()
              for k in history[0]} if history else {}
    return {"losses": losses, "evals": evals, "fit": fit, "out": args.out}


if __name__ == "__main__":
    main()
