#!/usr/bin/env python3
"""K6 on the H100: the bf16 segments' device times under other tiles.

Each variant is a copy of the port package under ``build/k6_tiles/``
(gitignored) whose ``csrc/mnet_stage1.cu`` has one launch's template
arguments replaced. Each runs in its own process, with its own kernel
build, in the order a, b, b, a, and prints each segment's device time
(torch.profiler, mean of 20 calls, three times) and the error against the
plain f32 version, at the production line's shape: 128 frames of 640x640,
the vendored fitted RetinaFace weights.

Usage, from the root of a checkout, on a machine with the card:
    python3 tools/torch_k6_tiles.py
"""

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PKG = "vn_celeb_face_recognition_tpu_torch"
OUT = os.path.join(ROOT, "build", "k6_tiles")
# name -> substitutions in csrc/mnet_stage1.cu
VARIANTS = {
    "as built (segment 2 at 8x16)": {},
    "segment 2 at 8x8": {"launch_mma<16, 32, 32, 8, 16, 2>":
                         "launch_mma<16, 32, 32, 8, 8, 4>"},
}


def make_variant(name, subs):
    """A copy of the package with ``subs`` applied; returns its parent."""
    where = os.path.join(OUT, str(list(VARIANTS).index(name)))
    shutil.rmtree(where, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(where, PKG),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    src = os.path.join(where, PKG, "csrc", "mnet_stage1.cu")
    with open(src) as fh:
        text = fh.read()
    for old, new in subs.items():
        if old not in text:
            raise SystemExit(f"{name}: {old!r} not in mnet_stage1.cu")
        text = text.replace(old, new)
    with open(src, "w") as fh:
        fh.write(text)
    return where


def measure(name):
    """Run in a variant's process: its package is first on the path."""
    sys.path.append(ROOT)
    import torch

    import chip_smoke as C
    from vn_celeb_face_recognition_tpu_torch.models.layers import load_npz
    from vn_celeb_face_recognition_tpu_torch.models.retinaface import (
        CHANNELS_SUBTRACT,
        RetinaFaceNet,
    )
    from vn_celeb_face_recognition_tpu_torch.ops import planar_s1 as K6
    from vn_celeb_face_recognition_tpu_torch.utils import frames as FR

    if not K6.__file__.startswith(OUT):
        raise SystemExit(f"{name}: imported {K6.__file__}, not a variant")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    FR.DATA_DIR = os.path.join(ROOT, "data")  # the copies hold no data
    dev = torch.device("cuda")
    weights = os.path.join(ROOT, "vn_celeb_face_recognition_tpu", "models",
                           "weights", "retinaface_mnet025.npz")
    stage1 = load_npz(RetinaFaceNet(), weights).to(dev).eval().body.stage1
    frames = torch.from_numpy(FR.build_frames(C.PROD_BATCH, C.SIZE,
                                              C.FACES_PER_FRAME)).to(dev)
    sub = CHANNELS_SUBTRACT
    got = K6.mnet_stage1(stage1, frames, sub, torch.bfloat16)
    want = K6.mnet_stage1_plain(stage1, frames, sub, torch.float32)
    rel = float((got.float() - want).norm() / want.norm())
    for _ in range(3):
        seg = C.device_ms_by(torch, lambda: K6.mnet_stage1(
            stage1, frames, sub, torch.bfloat16), C.segment_role)
        print(f"[{name}] K6 {sum(seg.values()):.4f} ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(seg.items()))
              + f"; rel L2 vs plain f32 {rel:.3e}; {C.card_line()}",
              flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        measure(sys.argv[2])
        return
    dirs = {name: make_variant(name, subs) for name, subs in VARIANTS.items()}
    a, b = list(VARIANTS)
    for name in (a, b, b, a):
        env = dict(os.environ, PYTHONPATH=dirs[name])
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--measure", name], cwd=ROOT, env=env, check=True)


if __name__ == "__main__":
    main()
