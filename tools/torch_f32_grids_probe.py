#!/usr/bin/env python3
"""The f32 grids of K8, K5, K7 and K6 on the H100, at the CLI paths'
shapes.

Builds the checkout's kernels (or those of the package first on
``PYTHONPATH``, e.g. ``git archive`` of an earlier commit unpacked under
``build/``), prints what ``ptxas -v`` says of the f32 and bf16 grids of
``bottleneck_chain.cu``, ``crop_net_trunk.cu``, ``emotion_stem.cu`` and
``mnet_stage1.cu``, then, in f32 with TF32 off in cuDNN and in matmul:

* K8 on the emotion net's layer1 and layer2 tails (2 blocks at 56x56, C
  256, P 64; 3 at 28x28, C 512, P 128) at 64 faces, the face count of a
  chunk of the production script's flags (CLI path b), on seeded
  non-negative inputs;
* K5 on 16,384 RNet and 8,192 ONet crops, a chunk run of ``demo_video
  --fused_engine`` (CLI path a), seeded in [-1, 1);
* K7 on 64 faces of uniform 0-255 pixels (CLI path b's faces);
* K6 with the vendored fitted RetinaFace stage 1 on 16 and 8 seeded
  640x640 frames (a CLI path b chunk; the detector fit's evaluations),
  and on 2 ragged 97x131 frames;

each held to its plain version within 1e-4 of max|ref| (K6: rtol and
atol 1e-4) and timed: the
kernel's device time (torch.profiler, mean of 20 calls), the wrapper call
(CUDA events, median of 20), the plain version's device time (cuDNN),
beside the 3xTF32 floor (bytes at 3.35 TB/s, 3 x operations at the 495
TFLOP/s TF32 peak; K6's bytes those of its three launches, the f32
scratch included) and the bound at the 67 TFLOP/s f32 peak. Prints one
``[f32-grids]`` line a kernel and one JSON line. ``--only K7,K6`` runs
those kernels alone.

Usage, from the root of a checkout, on a machine with the card:
    python3 tools/torch_f32_grids_probe.py [--label NAME] [--only K7,K6]
    PYTHONPATH=build/parent python3 tools/torch_f32_grids_probe.py \\
        --label parent
"""

import argparse
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.append(os.path.dirname(HERE))  # chip_smoke and, last, the package

CLI_B_FACES = 64                          # faces a CLI (b) chunk
CLI_A_CROPS = {"rnet": 16384, "onet": 8192}  # crops a CLI (a) chunk run
CLI_B_FRAMES, FIT_FRAMES = 16, 8         # K6's frames: a CLI (b) chunk, a fit
GRIDS = re.compile(r"(conv_gemm_\w+|crop_net_trunk_\w+|emotion_stem_\w+|"
                   r"segment_\w+)")


def ptxas_lines(log):
    """The build log's register/spill/shared-memory lines of the grids of
    K5, K8, K7 and K6, one line a function."""
    out, fn = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = GRIDS.search(line)
            fn = line.split("'")[1] if m else None
        elif fn and ("registers" in line or "spill" in line):
            out.append(f"{fn}: {line.split('info    :')[-1].strip()}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="checkout")
    ap.add_argument("--only", default="K8,K5,K7,K6")
    args = ap.parse_args()
    only = set(args.only.split(","))

    import torch

    import chip_smoke as CS
    from vn_celeb_face_recognition_tpu_torch.models import resnet_2branch_50
    from vn_celeb_face_recognition_tpu_torch.models.layers import (
        seeded_init_,
    )
    from vn_celeb_face_recognition_tpu_torch.models.mtcnn import MTCNN
    from vn_celeb_face_recognition_tpu_torch.models.retinaface import (
        CHANNELS_SUBTRACT,
        WEIGHTS_NPZ,
        RetinaFaceNet,
    )
    from vn_celeb_face_recognition_tpu_torch.models.layers import load_npz
    from vn_celeb_face_recognition_tpu_torch.ops import bottleneck as K8
    from vn_celeb_face_recognition_tpu_torch.ops import crops_net as K5
    from vn_celeb_face_recognition_tpu_torch.ops import emotion_stem as K7
    from vn_celeb_face_recognition_tpu_torch.ops import planar_s1 as K6
    from vn_celeb_face_recognition_tpu_torch.utils import kernels

    if not torch.cuda.is_available():
        CS.fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.card_line()
    import contextlib
    import io

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _, build_s = kernels.build(verbose=True)
    kernels.library()
    print(f"[f32-grids] {args.label}: {K8.__file__}; built in {build_s:.1f} "
          f"s; {card}", flush=True)
    for line in ptxas_lines(log.getvalue()):
        print(f"[ptxas] {args.label}: {line}", flush=True)

    dev = torch.device("cuda")
    rows = {}

    def run(name, fn, plain, flops, nbytes, atol=None):
        got, want = fn(), plain()
        scale = float(want.abs().max())
        err = CS.check_close(torch, got, want, 1e-4,
                             1e-4 * scale if atol is None else atol,
                             f"{args.label} {name}")
        ms = CS.device_ms(torch, fn)
        call = CS.median_ms(torch, fn)
        plain_ms = CS.device_ms(torch, plain)
        floor, floor_by = CS.bound(nbytes, 3 * flops, CS.PEAK_TF32)
        f32, _ = CS.bound(nbytes, flops, CS.PEAK_F32)
        rows[name] = dict(ms=ms, call_ms=call, plain_ms=plain_ms,
                          max_abs_err=err, floor_3xtf32_ms=floor,
                          floor_by=floor_by, f32_peak_ms=f32)
        print(f"[f32-grids] {args.label} {name}: max abs err {err:.3e} "
              f"(max|ref| {scale:.3e}); kernel {ms:.4f} "
              f"ms device, {flops / ms / 1e9:.1f} TFLOP/s, "
              f"{nbytes / ms / 1e6:.0f} GB/s, call {call:.4f} "
              f"ms; plain {plain_ms:.4f} ms; 3xtf32 floor {floor:.4f} ms "
              f"({floor_by}), f32-peak bound {f32:.4f} ms; {card}",
              flush=True)

    g = torch.Generator().manual_seed(5)
    emo = seeded_init_(resnet_2branch_50(num_classes=690), g).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(6)
    if "K7" in only:
        faces = torch.rand((CLI_B_FACES, 112, 112, 3), generator=gen,
                           device=dev) * 255
        run(f"K7 K={CLI_B_FACES}",
            lambda: K7.emotion_stem(emo.conv1, emo.bn1, faces,
                                    torch.float32),
            lambda: K7.emotion_stem_plain(emo.conv1, emo.bn1, faces,
                                          torch.float32),
            CLI_B_FACES * 112 * 112 * 64 * 48 * 2,
            (faces.numel() + CLI_B_FACES * 56 * 56 * 64) * 4)
        del faces
    if "K6" in only:
        stage1 = load_npz(RetinaFaceNet(), WEIGHTS_NPZ).to(dev).eval()
        stage1 = stage1.body.stage1
        for b, h, w in ((CLI_B_FRAMES, 640, 640), (FIT_FRAMES, 640, 640),
                        (2, 97, 131)):
            frames = torch.randint(0, 256, (b, h, w, 3), generator=gen,
                                   device=dev, dtype=torch.uint8)
            work = CS.mnet_segment_work(b, h, w, itemsize=4)
            run(f"K6 {b}x{h}x{w}",
                lambda: K6.mnet_stage1(stage1, frames, CHANNELS_SUBTRACT,
                                       torch.float32),
                lambda: K6.mnet_stage1_plain(stage1, frames,
                                             CHANNELS_SUBTRACT,
                                             torch.float32),
                b * CS.mnet_stage1_flops(h, w),
                sum(n for n, _ in work.values()), atol=1e-4)
            rows[f"K6 {b}x{h}x{w}"]["segment_ms"] = CS.device_ms_by(
                torch, lambda: K6.mnet_stage1(stage1, frames,
                                              CHANNELS_SUBTRACT,
                                              torch.float32),
                CS.segment_role)
            print(f"[f32-grids] {args.label} K6 {b}x{h}x{w} by segment: "
                  f"{rows[f'K6 {b}x{h}x{w}']['segment_ms']}", flush=True)
            del frames
    for name, layer, side, c, p in (("l1", emo.layer1, 56, 256, 64),
                                    ("l2", emo.layer2, 28, 512, 128)):
        if "K8" not in only:
            break
        blocks = list(layer)[1:]
        x = torch.relu(torch.randn((CLI_B_FACES, side, side, c),
                                   generator=gen, device=dev))
        pix = CLI_B_FACES * side * side
        flops = len(blocks) * pix * 2 * (2 * c * p + 9 * p * p)
        nbytes = len(blocks) * (2 * pix * c * 4 + 4 * (2 * c * p + 9 * p * p))
        run(f"K8 {name} K={CLI_B_FACES}",
            lambda: K8.bottleneck_chain(blocks, x),
            lambda: K8.bottleneck_chain_plain(blocks, x), flops, nbytes)
        del x
    det = MTCNN(device=dev) if "K5" in only else None
    for net, spec in ((det.rnet, K5.RNET_SPEC), (det.onet, K5.ONET_SPEC)
                      ) if det else ():
        n = CLI_A_CROPS[spec.name]
        x = torch.rand((n, spec.size, spec.size, 3), generator=gen,
                       device=dev) * 2 - 1
        nbytes = (x.numel() + n * spec.out * spec.out * spec.c2) * 4
        run(f"K5 {spec.name} {n} crops",
            lambda: K5.crop_net_trunk(net, x, spec),
            lambda: K5.crop_net_trunk_plain(net, x, spec),
            n * CS.trunk_flops(spec), nbytes)
        del x
    print(json.dumps({"label": args.label, "card": card, "rows": rows}),
          flush=True)


if __name__ == "__main__":
    main()
