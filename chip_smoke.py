#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (sm_90).

Drives the port's three lines through the entry points a user calls
(``FusedRecognitionEngine.process_adaptive`` + ``identify``) and the
MTCNN host API, and checks each hand-written kernel against its plain
PyTorch version on the card:

* the default bench line: MTCNN(min_face_size=50) -> window cut +
  Umeyama + warp -> InceptionResnetV1 (full depth, bf16) -> MLP(512,
  1001) over 64-frame 640x640 chunks (kernels K2, K3, K4, K5, K1);
* the stock line (``bench.py --detector=mtcnn_stock``): the same with
  MTCNN at min_face_size=20, auto caps and out_cap 8 over 128-frame
  chunks, an 11-level pyramid (the same kernels);
* the production line (``bench.py --production``): RetinaFace cfg_mnet
  (bf16, the vendored fitted weights) -> warp -> iresnet100 (bf16) ->
  MLP(512, 1020), plus the 2-branch ResNet-50 emotion head (690 tags,
  top 6) over 128-frame 640x640 chunks (kernels K6, K3, K1, K7, K8).

Phases, one line of output each (a failed phase exits non-zero):

   1. card: torch version, nvidia-smi name and power limit, sm_90 check;
   2. build: compiles csrc/*.cu with nvcc (one process per source);
   3. K2 (pnet_chain: pyramid + PNet read from the chunk's integral
      image) vs the plain version (pyramid_planes + the per-level PNet
      forward) at the default line's pyramid and the stock line's (128
      frames, 11 levels from 385 px): the f32 grid at 1e-4 against plain
      f32, the bf16 tensor-core grid by check_bf16; both grids timed and
      bounded, and the plain pyramid feed they replaced timed alone;
   4. K1 (similarity_warp) vs the plain bilinear warp, 512 faces: the
      windows form with F.grid_sample on the same f32 windows as the
      library yardstick, and the frames form (uint8 frames, the engine's
      path) timed against gather + cast + windows form; the kernel's tile
      boxes held to ops.warp.footprint_boxes; each form's bound counts the
      distinct source pixels that valid taps read (for the frames form,
      frame pixels that overlapping windows share count once);
   5. K3 (nms_keep_mask) keep masks equal to the plain fixpoint at six
      shapes (stock per-scale, cross-scale, ONet stage, RetinaFace, one
      set of 4,096, all-equal scores), one set of MAX_K = 7,680, sets
      with nv in {0, 1, 31, 32, 33, 65} and with +-0.0, +-inf and NaN
      scores, and at every shape the three lines launch, each with its
      sets in priority order (as ops.boxes.top_k_select hands them over)
      and not; every line shape timed both ways beside its bound;
   6. K4 (crop_area_resize: the integral image in two grids, band totals
      and one scan that writes each entry once, and pools that compute
      their own cell bounds) bit-exact to the plain integral-image crops
      on the stock chunk at S = 24 and 48, and on one 4032x3024 frame
      whose int32 prefix sums wrap; the integral image timed alone and
      with both pools;
   7. K5 (crop_net_trunk) vs the nets' cuDNN modules at the stock line's
      crop counts (bf16 on the tensor cores, f32 on 1,024 crops), RNet
      and ONet timed apart with their TFLOP/s and GB/s;
   8. the default slice: chunks with launch counters reset just before
      and read just after, held to exact per-run counts;
   9. its profile: device busy time of one chunk under torch.profiler,
      and each kernel's device time and grids in that chunk;
  10. its card vs CPU: the same engine in f32 on a 2-frame chunk;
  11. the stock slice, counters held the same way;
  12. its profile;
  13. its card vs CPU in f32 on 2 frames;
  14. the MTCNN host API (detect, __call__) on the card vs the CPU, and
      detect on the card on the 4032x3024 frame, which must find the faces
      pasted into it;
  15. K6 (mnet_stage1) vs the stage's cuDNN modules, 128x640x640 and
      ragged 97x131 frames (also a view not on 16 bytes), with each
      segment's device time beside its own bytes/FLOP floor;
  16. K7 (emotion_stem) vs resize + normalise + cuDNN stem, 512 faces;
  17. K8 (bottleneck_chain) vs the blocks' cuDNN modules, layer1 and
      layer2 tails at 512 faces and at 3 (a ragged last tile), with each
      convolution's device time, TFLOP/s and GB/s;
  18. the production slice, counters held the same way;
  19. its profile;
  20. its card vs CPU in f32 on 2 frames.

Kernel phases check bf16 at the lines' shapes and f32 on a slice of
them; exact kernels (K3, K4) are held with torch.equal. Every kernel is
timed the same way: ``ms`` is the device time of its own grids and
``plain_ms``/``library_ms`` that of the plain and library calls
(torch.profiler, mean per call), ``call_ms`` CUDA events around the
wrapper call, host work included (median of 20). Then one JSON
line with every kernel's numbers, the card line, and the last line
{"ok": true, "device": {...}}. Weights are random from a seed, except
the published MTCNN weights and the fitted RetinaFace weights vendored
in the repo.

Usage, from the root of a checkout: python3 chip_smoke.py
"""

import copy
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "vn_celeb_face_recognition_tpu_torch"
JAX_OPS = "vn_celeb_face_recognition_tpu/ops"
KERNEL_SOURCES = {
    "pnet_chain": (f"{PKG}/csrc/pyramid_pnet.cu",
                   f"{JAX_OPS}/pyramid_pnet_pallas.py:287"),
    "similarity_warp": (f"{PKG}/csrc/similarity_warp.cu",
                        f"{JAX_OPS}/warp_pallas.py:245"),
    "mnet_stage1": (f"{PKG}/csrc/mnet_stage1.cu",
                    f"{JAX_OPS}/planar_s1_pallas.py:306"),
    "emotion_stem": (f"{PKG}/csrc/emotion_stem.cu",
                     f"{JAX_OPS}/emotion_stem_pallas.py:171"),
    "bottleneck_chain": (f"{PKG}/csrc/bottleneck_chain.cu",
                         f"{JAX_OPS}/bottleneck_pallas.py:218"),
    "nms_keep_mask": (f"{PKG}/csrc/nms_keep.cu",
                      f"{JAX_OPS}/nms_pallas.py:93"),
    "crop_area_resize": (f"{PKG}/csrc/crop_area_pool.cu",
                         f"{JAX_OPS}/crop_pallas.py:85"),
    "crop_net_trunk": (f"{PKG}/csrc/crop_net_trunk.cu",
                       f"{JAX_OPS}/crops_net_pallas.py:239"),
}
# the device functions each kernel's wrapper launches, by name in
# torch.profiler's trace: a kernel's ``ms`` is their device time
KERNEL_GRIDS = {
    "pnet_chain": ("pnet_frames_f32", "pnet_frames_mma"),
    "similarity_warp": ("similarity_warp_kernel",),
    "mnet_stage1": ("segment_kernel", "segment_mma_first", "segment_mma"),
    "emotion_stem": ("emotion_stem_kernel", "emotion_stem_mma"),
    "bottleneck_chain": ("conv_gemm_bf16",),
    "nms_keep_mask": ("nms_keep_tiled",),
    "crop_area_resize": ("band_totals_kernel", "band_scan_kernel",
                         "crop_pool_kernel"),
    "crop_net_trunk": ("crop_net_trunk_mma",),
}
# K8's convolutions by the template arguments <BN, TAPS, RES> of its grid
# in the profiler's (demangled or mangled) kernel name
CONV_ARGS = re.compile(r"conv_gemm_bf16(?:<(\d+), (\d+), (true|false)>|"
                       r"ILi(\d+)ELi(\d+)ELb([01])E)")
# K6's bf16 segments by grid: segment_mma_first is segment 1, and the
# first template argument (C_in) of segment_mma tells segments 2 and 3
SEGMENT_ARGS = re.compile(r"segment_mma(?:(_first)|<(\d+),|ILi(\d+)E)")
# a 12 MP photo (4032x3024), above the 8,421,504 pixels whose int32 prefix
# sums of 255 stay below 2**31
BIG_H, BIG_W = 3024, 4032
# launches per chunk run of an MTCNN line: K2 once, four NMS (K3), one
# integral image (two grids) and two pools (K4), the RNet and ONet trunks
# (K5), and one warp (K1)
MTCNN_LINE_LAUNCHES = {"pnet_chain": 1, "nms_keep_mask": 4,
                       "crop_area_resize": 4, "crop_net_trunk": 2,
                       "similarity_warp": 1}
# K3's launches on each line: (line, NMS, sets, boxes a set, thr, offset,
# min_mode). The per-scale and cross-scale sets and RetinaFace's come out
# of a top-k in priority order; the RNet and ONet sets do not.
K3_SHAPES = [
    ("default", "per-scale", 512, 128, 0.5, 0.0, False),
    ("default", "cross-scale", 64, 256, 0.7, 0.0, False),
    ("default", "RNet", 64, 64, 0.7, 0.0, False),
    ("default", "ONet", 64, 32, 0.7, 1.0, True),
    ("stock", "per-scale", 1408, 448, 0.5, 0.0, False),
    ("stock", "cross-scale", 128, 512, 0.7, 0.0, False),
    ("stock", "RNet", 128, 256, 0.7, 0.0, False),
    ("stock", "ONet", 128, 128, 0.7, 1.0, True),
    ("production", "RetinaFace", 128, 1024, 0.4, 1.0, False),
]
# default bench line
DETECTOR = dict(min_face_size=50, pnet_cap_per_scale=128,
                cross_cap=256, rnet_cap=64, onet_cap=32, out_cap=8)
BATCH, SIZE, FACES_PER_FRAME = 64, 640, 4
FACE_BUCKETS = [256, 320]
N_CLASSES = 1001
CHUNKS = 4
# production line (bench.py --production)
PROD_BATCH = 128
PROD_FACES = PROD_BATCH * FACES_PER_FRAME
PROD_BUCKETS = [PROD_FACES, PROD_FACES + PROD_BATCH]
PROD_CLASSES, EMOTION_TAGS, EMOTION_TOPK = 1020, 690, 6
RETINAFACE = dict(conf_thres=0.02, nms_cap=1024, nms_thres=0.4,
                  vis_thres=0.6)
PROD_CHUNKS = 6
# stock line (bench.py --detector=mtcnn_stock): MTCNN at min_face_size=20
# with the auto caps (448/512/256/128 at 640x640), out_cap 8
STOCK_BATCH = 128
STOCK_FACES = STOCK_BATCH * FACES_PER_FRAME
STOCK_BUCKETS = [STOCK_FACES, STOCK_FACES + STOCK_BATCH]
STOCK_CHUNKS = 4
# NVIDIA H100 SXM data-sheet peaks (dense), at the 700 W limit
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# a bf16 kernel is held to its plain version computed in f32 on the same
# inputs: the kernels accumulate in f32 and round to bf16 (8 significant
# bits, eps 2**-8) at their outputs and, for K6 and K8, at a few staged
# intermediates and folded weights. The plain version run in bf16 rounds
# after every layer, before BatchNorm's scale, and is printed beside it.
BF16_REL_L2, BF16_REL_MAX = 1e-2, 5e-2
# how every kernel phase times (see ``timed``)
TIMING = ("kernel, plain and library: device time from torch.profiler, mean "
          "per call; call: CUDA events around the wrapper call, host work "
          "included, median of 20")


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(torch, fn, runs=20, warmup=3):
    """Median CUDA-event time of ``fn()`` over ``runs`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def is_grid(key, names):
    """Whether the profiler's kernel name ``key`` (demangled or mangled) is
    one of the device functions ``names``, matched as a whole name."""
    return any(re.search(rf"(?:^|[^A-Za-z_]){re.escape(n)}(?:[<(IE]|$)",
                         key) for n in names)


def device_ms(torch, fn, names=(), runs=20):
    """Device time (ms) per call of ``fn()`` spent in the device functions
    whose name contains one of ``names`` (every one when it is empty), from
    torch.profiler: the kernels alone, without the host's launch overhead
    or the wrapper's other work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events
                if not names or is_grid(e.key, names))
    if total <= 0:
        fail(f"torch.profiler recorded no device time for {names or 'fn'}; "
             f"it saw {sorted({e.key[:80] for e in events})}")
    return total / runs / 1e3


def timed(torch, name, fn, plain, plain_runs=20):
    """One yardstick for every kernel: (ms, call_ms, plain_ms) = the device
    time per call of kernel ``name``'s own grids in ``fn()``, the median
    CUDA-event time around the whole wrapper call (its host work
    included), and the device time per call of ``plain()``."""
    return (device_ms(torch, fn, KERNEL_GRIDS[name]), median_ms(torch, fn),
            device_ms(torch, plain, runs=plain_runs))


def check_close(torch, got, want, rtol, atol, what):
    got, want = got.to(torch.float32), want.to(torch.float32)
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        fail(f"{what}: {int(bad.sum())} elements outside rtol={rtol} "
             f"atol={atol}, max abs err {float(err.max()):.3e}")
    return float(err.max())


def check_bf16(torch, got, want32, want16, what):
    """bf16 kernel output vs the plain version in f32 (held: relative L2
    error and max error over the largest magnitude) and in bf16 (shown).
    Returns (max abs err vs f32, rel L2, rel max, plain bf16 rel L2)."""
    got, want32 = got.to(torch.float32), want32.to(torch.float32)
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite output")

    def rel_l2(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    err = float((got - want32).abs().max())
    rel = rel_l2(got, want32)
    rel_max = err / max(float(want32.abs().max()), 1e-30)
    plain16 = rel_l2(want16.to(torch.float32), want32)
    if rel > BF16_REL_L2 or rel_max > BF16_REL_MAX:
        fail(f"{what}: vs plain f32 rel L2 err {rel:.3e} (<= {BF16_REL_L2})"
             f", max err / max|ref| {rel_max:.3e} (<= {BF16_REL_MAX}); the "
             f"plain bf16 version's rel L2 err {plain16:.3e}")
    return err, rel, rel_max, plain16


def through_kernel(kernels, name, fn, launches=1):
    """``fn()``, which must launch kernel ``name`` ``launches`` times."""
    before = kernels.launch_counts()[name]
    out = fn()
    got = kernels.launch_counts()[name] - before
    if got != launches:
        fail(f"{name}: the wrapper counted {got} kernel launches on CUDA "
             f"tensors, want {launches}")
    return out


def bound(nbytes, flops, peak_flops):
    """Least time (ms) for the work, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_line_counts(counts, per_run, runs, line, results):
    """The launch counts of ``runs`` chunk runs of a line must be exactly
    ``per_run`` x runs (every other kernel 0); each kernel's launches add
    to its row."""
    want = {k: per_run.get(k, 0) * runs for k in counts}
    if counts != want:
        fail(f"{line} launches {counts}, want {want} for {runs} chunk runs")
    for k, n in counts.items():
        if n:
            results[k]["launches"] = results[k].get("launches", 0) + n


def mtcnn_card_vs_cpu(torch, engine_cls, mtcnn_cls, det_kw, models,
                      models_cpu, two, buckets, dev, what):
    """The same MTCNN engine in f32 on the card and on the CPU, 2 frames:
    equal valid masks, boxes within 1e-2 px, embedding cosine >= 0.999."""
    outs = []
    for where, (e, c) in ((dev, models), ("cpu", models_cpu)):
        e.dtype = torch.float32
        eng = engine_cls(mtcnn_cls(dtype=torch.float32, device=where,
                                   **det_kw), e, c, target_fs=112,
                         compute_dtype=torch.float32, face_cap=buckets)
        outs.append({key: v.cpu() for key, v in
                     eng.process_adaptive(two).items()
                     if isinstance(v, torch.Tensor)})
    gpu, cpu = outs
    if not torch.equal(gpu["valid"], cpu["valid"]):
        fail(f"{what}: valid masks differ")
    v = cpu["valid"]
    box_err = float((gpu["boxes"][v] - cpu["boxes"][v]).abs().max())
    cos = torch.nn.functional.cosine_similarity(
        gpu["embeddings"][v], cpu["embeddings"][v], dim=-1)
    phase(what, f"{two.shape[0]}x{two.shape[1]}x{two.shape[2]} f32: "
          f"{int(v.sum())} valid on both; max box diff {box_err:.2e} (atol "
          f"1e-2); min embedding cosine {float(cos.min()):.6f} (>= 0.999)")
    if int(v.sum()) == 0 or box_err > 1e-2 or float(cos.min()) < 0.999:
        fail(f"{what} outside tolerance")


def host_frames(frames_np, n):
    """``n`` stock frames with the top-left face replaced by a larger one,
    so each frame's largest face is unique."""
    from vn_celeb_face_recognition_tpu_torch.utils.frames import (
        face_files,
        read_png,
        resize_bicubic,
    )

    out = frames_np[:n].copy()
    files = face_files()
    for i in range(n):
        face = resize_bicubic(read_png(files[(5 + i) % len(files)]),
                              (200, 200))
        out[i, 40:240, 40:240] = face
    return out


def host_api_card_vs_cpu(torch, mtcnn_cls, frames_np, dev):
    """detect(landmarks=True) and __call__ (largest face, extract) of the
    MTCNN host API on the card and on the CPU, in f32 on 3 frames: the
    same face counts, boxes within 1e-2 px, and equal extracted faces
    wherever the integer crop boxes agree."""
    imgs = list(host_frames(frames_np, 3))
    dets = [mtcnn_cls(min_face_size=20, out_cap=8, device=where)
            for where in (dev, "cpu")]
    found = [d.detect(imgs, landmarks=True) for d in dets]
    box_err = 0.0
    for gb, cb in zip(found[0][0], found[1][0]):
        if len(gb) != len(cb) or len(gb) == 0:
            fail(f"host API: {len(gb)} faces on the card, {len(cb)} on the "
                 "CPU")
        # order by area may swap near-equal faces: match each card box to
        # the nearest CPU box
        d = np.abs(np.asarray(gb, np.float64)[:, None]
                   - np.asarray(cb, np.float64)[None]).max(-1)
        box_err = max(box_err, float(d.min(1).max()))
    called = [d(imgs, return_prob=True) for d in dets]
    equal = 0
    for gf, cf, gb, cb in zip(called[0][0], called[1][0], called[0][1],
                              called[1][1]):
        box_err = max(box_err, float(np.abs(gb.astype(np.float64)
                                            - cb.astype(np.float64)).max()))
        if np.array_equal(np.trunc(gb.astype(np.float64)),
                          np.trunc(cb.astype(np.float64))):
            if not np.array_equal(gf, cf):
                fail("host API: extracted faces differ for equal crop boxes")
            equal += 1
    counts = [len(b) for b in found[0][0]]
    phase("host-api", f"detect(landmarks=True) on {len(imgs)} frames f32: "
          f"faces per frame {counts} on card and CPU; __call__ (largest "
          f"face, extract 160 px): {equal} of {len(imgs)} faces extracted "
          f"equal (the rest differ in an integer crop bound); max box diff "
          f"{box_err:.2e} (atol 1e-2)")
    if box_err > 1e-2 or equal == 0:
        fail("host API card vs CPU outside tolerance")


def big_frame():
    """One 4032x3024 photo: a bright background (pixels 250-255, so its
    int32 prefix sums wrap) with four faces of 420-800 px pasted into it.
    Returns (frame [H, W, 3] uint8, the pasted boxes [4, 4] x1 y1 x2 y2)."""
    from vn_celeb_face_recognition_tpu_torch.utils.frames import (
        face_files,
        read_png,
        resize_bicubic,
    )

    img = np.random.default_rng(12).integers(250, 256, (BIG_H, BIG_W, 3),
                                              dtype=np.uint8)
    files = face_files()
    boxes = []
    for i, (x, y, side) in enumerate(((300, 400, 600), (1800, 900, 420),
                                      (3000, 300, 800), (2600, 2200, 500))):
        img[y:y + side, x:x + side] = resize_bicubic(
            read_png(files[(3 * i) % len(files)]), (side, side))
        boxes.append((x, y, x + side, y + side))
    return img, np.asarray(boxes, np.float64)


def box_iou(a, b):
    """IoU of boxes a [A, 4] and b [B, 4] (x1 y1 x2 y2) -> [A, B]."""
    a, b = np.asarray(a, np.float64)[:, None], np.asarray(b, np.float64)[None]
    iw = np.clip(np.minimum(a[..., 2], b[..., 2])
                 - np.maximum(a[..., 0], b[..., 0]), 0, None)
    ih = np.clip(np.minimum(a[..., 3], b[..., 3])
                 - np.maximum(a[..., 1], b[..., 1]), 0, None)
    inter = iw * ih
    area = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
            + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))
    return inter / (area - inter)


def big_frame_detect(torch, kernels, mtcnn_cls, big_np, pasted, dev):
    """MTCNN.detect (default constructor, auto caps) on the card on the
    4032x3024 frame: every pasted face found (IoU >= 0.5), through K2, K3,
    K4 and K5."""
    det = mtcnn_cls(device=dev)
    det.detect(big_np)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    boxes, probs = det.detect(big_np)
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = {k: n for k, n in MTCNN_LINE_LAUNCHES.items()
            if k != "similarity_warp"}
    if {k: n for k, n in counts.items() if n} != want:
        fail(f"big-frame detect launches {counts}, want {want}")
    best = (box_iou(pasted, boxes).max(1) if len(boxes)
            else np.zeros(len(pasted)))
    phase("big-frame", f"MTCNN.detect on one {BIG_W}x{BIG_H} u8 frame on "
          f"the card (caps {det.capacity_profile(BIG_H, BIG_W)}): "
          f"{len(boxes)} faces, best IoU with each of the {len(pasted)} "
          f"pasted faces {np.round(best, 3).tolist()} (>= 0.5); launches "
          f"{counts}; {secs:.3f} s (host clock)")
    if (best < 0.5).any():
        fail("MTCNN.detect on the 4032x3024 frame missed a pasted face")


def drive(torch, kernels, engine, chunks, n, names):
    """``n`` timed chunks of process_adaptive + identify, counters reset
    just before; returns (chunk seconds, valid counts, launch counts,
    process runs, last output, last identify result)."""
    runs = [0]
    process = engine.process

    def counted(frames):
        runs[0] += 1
        return process(frames)

    engine.process = counted
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times, valid_counts = [], []
    for i in range(n):
        t0 = time.perf_counter()
        out = engine.process_adaptive(chunks[i % 2])
        res = engine.identify(out, names, 0.5)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        valid_counts.append(int(out["valid"].sum()))
        if not bool(torch.isfinite(out["embeddings"][out["valid"]]).all()):
            fail(f"chunk {i}: non-finite embeddings")
        if sum(len(r[0]) for r in res) != valid_counts[-1]:
            fail(f"chunk {i}: identify lost faces")
    counts = kernels.launch_counts()
    del engine.process
    return times, valid_counts, counts, runs[0], out, res


def profile_chunk(torch, engine, frames, names, chunk_ms, card, what,
                  line, results):
    """Device busy time of one chunk under torch.profiler, and each
    kernel's device time and grids in it (added to its row as
    ``chunk_device_ms[line]``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = engine.process_adaptive(frames)
        engine.identify(out, names, 0.5)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    # device-side events only (the CPU ops that launched them repeat the
    # same time); everything runs on one stream, so their sum is the busy
    # time
    device = [e for e in averages if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    if busy_ms <= 0.0:
        fail("torch.profiler recorded no device time")
    print(averages.table(sort_by="self_device_time_total", row_limit=25))
    parts = []
    for kname, grids in KERNEL_GRIDS.items():
        mine = [e for e in device if is_grid(e.key, grids)]
        if mine:
            ms = sum(e.self_device_time_total for e in mine) / 1e3
            results[kname].setdefault("chunk_device_ms", {})[line] = ms
            parts.append(f"{kname} {ms:.4f} ms in "
                         f"{sum(e.count for e in mine)} grids")
    phase(what, f"one chunk: device busy {busy_ms:.2f} ms = "
          f"{busy_ms / chunk_ms:.1%} of the median chunk {chunk_ms:.2f} ms "
          f"(device idle {1 - busy_ms / chunk_ms:.1%}; {card}); kernels: "
          + "; ".join(parts))
    return busy_ms


def nms_sets(torch, gen, n, k, size, dev):
    """``n`` padded sets of ``k`` boxes, clustered around a few faces per
    set as the cascade's candidates are, with quantised scores (ties) and
    about 20% invalid rows."""
    centres = gen.uniform(40, size - 40, (n, 8, 2))
    pick = gen.integers(0, 8, (n, k))
    c = np.take_along_axis(centres, pick[..., None], axis=1)
    side = gen.uniform(20, 150, (n, k, 1))
    c = c + gen.normal(0, 0.15, (n, k, 2)) * side
    wh = side * gen.uniform(0.8, 1.25, (n, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = (np.round(gen.uniform(0, 1, (n, k)) * 64) / 64).astype(
        np.float32)
    valid = gen.uniform(size=(n, k)) < 0.8
    return (torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
            torch.from_numpy(valid).to(dev))


def nms_iou_tests(torch, boxes, scores, valid, keep, thr, offset, min_mode):
    """IoU tests a greedy scan needs on these sets: each valid box is
    tested against the kept boxes ahead of it, up to the first one that
    suppresses it."""
    from vn_celeb_face_recognition_tpu_torch.ops.boxes import pairwise_iou

    k = scores.shape[1]
    s = torch.where(valid, scores, torch.tensor(float("-inf"), device=
                                                 scores.device))
    idx = torch.arange(k, device=scores.device)
    ahead = (s[:, :, None] > s[:, None, :]) | (
        (s[:, :, None] == s[:, None, :]) & (idx[:, None] < idx[None, :]))
    ahead &= keep[:, :, None] & valid[:, None, :]            # [N, j, i]
    rank = ahead.sum(1)  # boxes kept ahead of i; a kept j's rank is its own
    sup = ahead & (pairwise_iou(boxes, boxes, offset, min_mode) > thr)
    big = torch.full_like(rank, k + 1)
    first = torch.where(sup, rank[:, :, None], big[:, :, None]).amin(1)
    return int((ahead & (rank[:, :, None] <= first[:, None, :])).sum())


def in_priority_order(torch, boxes, scores, valid):
    """The sets as a top-k hands them to K3 on the lines: valid rows first
    by descending score, ties in row order (ops.boxes.top_k_select)."""
    from vn_celeb_face_recognition_tpu_torch.ops.boxes import top_k_select

    idx, still = top_k_select(scores, valid, scores.shape[1])
    return (torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
            torch.gather(scores, 1, idx), still)


def nv_edge_sets(torch, gen, k, dev):
    """Sets of ``k`` clustered boxes with exactly 0, 1, 31, 32, 33 and 65
    valid rows (tile edges of the greedy scan)."""
    boxes, scores, _ = nms_sets(torch, gen, 6, k, SIZE, dev)
    valid = np.zeros((6, k), bool)
    for s, nv in enumerate((0, 1, 31, 32, 33, 65)):
        valid[s, gen.permutation(k)[:nv]] = True
    return boxes, scores, torch.from_numpy(valid).to(dev)


def special_scores(torch, gen, scores):
    """``scores`` replaced by draws from -0.0, +0.0, +-inf, NaN and two
    finite values: ties across the sign of zero."""
    special = np.float32([-0.0, 0.0, np.inf, -np.inf, np.nan, 0.5, -0.5])
    pick = gen.integers(0, len(special), tuple(scores.shape))
    return torch.from_numpy(special[pick]).to(scores.device)


def phase_k3(torch, kernels, K3, dev, card, results):
    """K3 keep masks equal to the plain version at the cascade's, the ONet
    stage's and RetinaFace's shapes, one set of 4,096, all-equal scores,
    one set of MAX_K, the scan's tile edges, special scores, and every
    line shape in and out of priority order; timed at the stock per-scale
    shape against the plain version, and at every line shape both ways
    beside its bound."""
    gen = np.random.default_rng(10)
    cases = [("stock per-scale", 1408, 448, 0.5, 0.0, False),
             ("cross-scale", 128, 512, 0.7, 0.0, False),
             ("ONet stage", 128, 128, 0.7, 1.0, True),
             ("RetinaFace", 128, 1024, 0.4, 1.0, False),
             ("one set", 1, 4096, 0.5, 0.0, False),
             ("all-equal scores", 64, 448, 0.5, 0.0, False),
             ("one set of MAX_K", 1, K3.MAX_K, 0.5, 0.0, False),
             ("nv 0/1/31/32/33/65", 6, 96, 0.5, 0.0, False),
             ("+-0.0, +-inf, NaN scores", 64, 448, 0.5, 0.0, False),
             ("+-0.0, +-inf, NaN scores in order", 64, 448, 0.5, 0.0,
              False)]
    parts, timed_set = [], None

    def check(what, boxes, scores, valid, thr, off, mm):
        got = through_kernel(kernels, "nms_keep_mask",
                             lambda: K3.nms_keep_mask(boxes, scores, valid,
                                                      thr, off, mm))
        want = K3.nms_keep_mask_plain(boxes, scores, valid, thr, off, mm)
        n, k = scores.shape
        if not torch.equal(got, want):
            fail(f"K3 {what} {n}x{k}: {int((got != want).sum())} keep flags "
                 "differ from the plain version")
        return got, (f"{what} {n}x{k} @{thr} off {off:g} min {mm}: "
                     f"{int(got.sum())} kept of {int(valid.sum())}")

    for what, n, k, thr, off, mm in cases:
        if what.startswith("nv "):
            boxes, scores, valid = nv_edge_sets(torch, gen, k, dev)
        else:
            boxes, scores, valid = nms_sets(torch, gen, n, k, SIZE, dev)
        if what == "all-equal scores":
            scores = torch.full_like(scores, 0.5)
        elif what.startswith("+-0.0"):
            scores = special_scores(torch, gen, scores)
            if what.endswith("in order"):
                boxes, scores, valid = in_priority_order(torch, boxes,
                                                         scores, valid)
        got, part = check(what, boxes, scores, valid, thr, off, mm)
        parts.append(part)
        if timed_set is None:
            timed_set = (boxes, scores, valid, got, thr)
    boxes, scores, valid, keep, thr = timed_set
    ms, call_ms, plain_ms = timed(
        torch, "nms_keep_mask",
        lambda: K3.nms_keep_mask(boxes, scores, valid, thr),
        lambda: K3.nms_keep_mask_plain(boxes, scores, valid, thr),
        plain_runs=5)
    tests = nms_iou_tests(torch, boxes, scores, valid, keep, thr, 0.0, False)
    # 22 bytes a box (boxes, score, valid in; keep out); ~15 f32 operations
    # an IoU test
    bound_ms, bound_by = bound(scores.numel() * 22, tests * 15, PEAK_F32)
    phase("K3", "nms_keep_mask keep masks equal (torch.equal): "
          + "; ".join(parts) + f". Timed at 1408x448: kernel {ms:.4f} ms, "
          f"call {call_ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {tests} IoU tests); library none "
          f"(no single PyTorch call computes a batched greedy keep mask) "
          f"({TIMING}; {card})")

    # every line shape, with its sets in priority order and not
    gen = np.random.default_rng(13)
    shapes, lines = {}, []
    for line, nms, n, k, thr, off, mm in K3_SHAPES:
        raw = nms_sets(torch, gen, n, k, SIZE, dev)
        row = {}
        for order, sets in (("in_order", in_priority_order(torch, *raw)),
                            ("unordered", raw)):
            bx, sc, vl = sets
            got, _ = check(f"{line} {nms} {order}", bx, sc, vl, thr, off, mm)
            t_ms = device_ms(torch, lambda: K3.nms_keep_mask(bx, sc, vl, thr,
                                                             off, mm),
                             KERNEL_GRIDS["nms_keep_mask"])
            tests = nms_iou_tests(torch, bx, sc, vl, got, thr, off, mm)
            b_ms, b_by = bound(sc.numel() * 22, tests * 15, PEAK_F32)
            row[order] = dict(ms=t_ms, bound_ms=b_ms, bound_by=b_by,
                              iou_tests=tests, kept=int(got.sum()),
                              valid=int(vl.sum()))
        shapes[f"{line} {nms} {n}x{k}"] = row
        lines.append(
            f"{line} {nms} {n}x{k} @{thr} off {off:g} min {mm}: in order "
            f"{row['in_order']['ms']:.4f} ms, unordered "
            f"{row['unordered']['ms']:.4f} ms, bound "
            f"{row['unordered']['bound_ms']:.6f} ms "
            f"({row['unordered']['bound_by']}; "
            f"{row['unordered']['iou_tests']} IoU tests; "
            f"{row['unordered']['kept']} kept of "
            f"{row['unordered']['valid']})")
    phase("K3-shapes", "nms_keep_mask at the lines' launch shapes, keep "
          "masks equal both ways (kernel device time, torch.profiler, mean "
          f"of 20 calls; {card}): " + "; ".join(lines))
    results["nms_keep_mask"] = dict(
        max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        ms_in_order=shapes["stock per-scale 1408x448"]["in_order"]["ms"],
        shapes=shapes)


def phase_k4(torch, kernels, K4, frames, big, pasted, card, results):
    """K4 bit-exact (torch.equal) to the plain version on the stock chunk:
    K = 256 at S = 24 and K = 128 at S = 48, with full-frame, partly
    off-frame and inverted boxes; timed as the cascade runs it (one
    integral image, two pools). Then bit-exact on the 4032x3024 frame
    ``big`` [1, H, W, 3], whose int32 prefix sums wrap."""
    gen = np.random.default_rng(11)
    b, h, w = frames.shape[:3]
    dev = frames.device

    def box_set(k):
        xy = gen.uniform(-60, w + 20, (b, k, 2))
        side = gen.uniform(4, 300, (b, k, 1))
        bx = np.trunc(np.concatenate([xy, xy + side], -1))
        bx[:, 0] = [1, 1, w, h]                      # full frame
        bx[:, 1] = [-40, h - 50, 60, h + 70]         # partly off-frame
        bx[:, 2] = [300, 300, 200, 250]              # inverted
        bx[:, 3] = [w + 5, 10, w + 90, 80]           # right of the frame
        return torch.from_numpy(bx.astype(np.float32)).to(dev)

    stages = [(24, box_set(256)), (48, box_set(128))]
    integ = through_kernel(kernels, "crop_area_resize",
                           lambda: K4.integral_image(frames), launches=2)
    integ_plain = K4.integral_image_plain(frames)
    if not torch.equal(integ, integ_plain):
        fail("K4 integral image differs from the plain version")
    nbytes = frames.numel()
    for s, bx in stages:
        got = through_kernel(kernels, "crop_area_resize",
                             lambda: K4.crop_area_pool(integ, bx, s))
        want = K4.grouped_crop_area_resize_plain(frames, bx, s)
        if not torch.equal(got, want):
            err = float((got - want).abs().max())
            fail(f"K4 S={s}: not bit-exact, max abs err {err:.3e}")
        nbytes += got.numel() * 4 + bx.numel() * 4
    del integ_plain

    # the 12 MP frame: its prefix sums wrap modulo 2**32
    integ_big = through_kernel(kernels, "crop_area_resize",
                               lambda: K4.integral_image(big), launches=2)
    if not torch.equal(integ_big, K4.integral_image_plain(big)):
        fail("K4 integral image of the 4032x3024 frame differs from the "
             "plain version")
    if int(integ_big.min()) >= 0:
        fail("the 4032x3024 frame's int32 prefix sums did not wrap")
    xy = gen.uniform(-100, BIG_W, (1, 60, 2))
    side = gen.uniform(10, 2500, (1, 60, 1))
    bx = np.trunc(np.concatenate([xy, xy + side], -1))
    bx[0, :4] = pasted + [1, 1, 0, 0]                  # the pasted faces
    bx[0, 4] = [1, 1, BIG_W, BIG_H]                    # the whole frame
    bx[0, 5] = [BIG_W - 300, BIG_H - 200, BIG_W + 50, BIG_H + 9]
    bx = torch.from_numpy(bx.astype(np.float32)).to(dev)
    for s in (24, 48):
        got = through_kernel(kernels, "crop_area_resize",
                             lambda: K4.crop_area_pool(integ_big, bx, s))
        if not torch.equal(got, K4.grouped_crop_area_resize_plain(big, bx,
                                                                  s)):
            fail(f"K4 S={s} on the 4032x3024 frame: not bit-exact")
    del integ_big

    def cascade_crops():  # one integral image, both pools
        shared = K4.integral_image(frames)
        return [K4.crop_area_pool(shared, bx, s) for s, bx in stages]

    ms, call_ms, plain_ms = timed(
        torch, "crop_area_resize", cascade_crops,
        lambda: [K4.grouped_crop_area_resize_plain(frames, bx, s)
                 for s, bx in stages], plain_runs=5)
    ms_integ = device_ms(torch, lambda: K4.integral_image(frames),
                         KERNEL_GRIDS["crop_area_resize"])
    bound_ms, bound_by = bound(nbytes, 0, PEAK_F32)
    results["crop_area_resize"] = dict(max_abs_err=0.0, ms=ms,
                                       call_ms=call_ms, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by,
                                       library_ms=None,
                                       integral_image_ms=ms_integ)
    phase("K4", f"crop_area_resize {b}x{h}x{w} u8, K=256 S=24 and K=128 "
          "S=48 (full-frame, off-frame, inverted boxes): bit-exact "
          f"(torch.equal); one {BIG_W}x{BIG_H} frame (prefix sums wrap), "
          "K=60 at S=24 and 48: bit-exact (torch.equal); integral image + "
          f"both pools {ms:.3f} ms (the "
          f"integral image {ms_integ:.3f} ms), call {call_ms:.3f} ms, plain "
          f"(integral image per stage) {plain_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}: frames in, crops out); library "
          f"none (no PyTorch call pools many boxes per frame) ({TIMING}; "
          f"{card})")


def trunk_flops(spec):
    """Multiply-adds x2 of one crop's conv1 and conv2."""
    c1 = spec.conv1_out
    return 2 * (c1 * c1 * spec.c1 * 27
                + spec.out * spec.out * spec.c2 * 9 * spec.c1)


def phase_k5(torch, kernels, K5, det, card, results):
    """K5 on the stock line's crop counts in bf16 (held to the plain version
    in f32; also on 1,023 crops, an offset view whose last RNet group is
    part-filled) and f32 on a slice (1e-4)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    ms = call_ms = plain_ms = err = 0.0
    nbytes = flops = 0
    parts = []
    for net, spec, n in ((det.rnet, K5.RNET_SPEC, STOCK_BATCH * 256),
                         (det.onet, K5.ONET_SPEC, STOCK_BATCH * 128)):
        raw = torch.randint(0, 256, (n, spec.size, spec.size, 3),
                            generator=gen, device="cuda")
        x32 = (raw.to(torch.float32) - 127.5) * 0.0078125
        x = x32.to(torch.bfloat16)
        got = through_kernel(kernels, "crop_net_trunk",
                             lambda: K5.crop_net_trunk(net, x, spec))
        want = K5.crop_net_trunk_plain(net, x.to(torch.float32), spec)
        e, rel_l2, rel_max, plain16 = check_bf16(
            torch, got, want, K5.crop_net_trunk_plain(net, x, spec),
            f"K5 {spec.name} bf16")
        # a crop count that leaves the last group of RNet's 4 part-filled
        odd = x[1:1024]
        check_bf16(torch, K5.crop_net_trunk(net, odd, spec),
                   want[1:1024], K5.crop_net_trunk_plain(net, odd, spec),
                   f"K5 {spec.name} bf16, 1023 crops")
        few = x32[:1024]
        want32 = K5.crop_net_trunk_plain(net, few, spec)
        e32 = check_close(torch, K5.crop_net_trunk(net, few, spec), want32,
                          1e-4, 1e-4 * float(want32.abs().max()),
                          f"K5 {spec.name} f32")
        t_k, t_call, t_p = timed(
            torch, "crop_net_trunk", lambda: K5.crop_net_trunk(net, x, spec),
            lambda: K5.crop_net_trunk_plain(net, x, spec))
        ms, call_ms, plain_ms = ms + t_k, call_ms + t_call, plain_ms + t_p
        err = max(err, e)
        net_bytes = (x.numel() + got.numel()) * 2
        net_flops = n * trunk_flops(spec)
        net_bound, net_by = bound(net_bytes, net_flops, PEAK_BF16)
        nbytes += net_bytes
        flops += net_flops
        parts.append(f"{spec.name} {n} crops vs plain f32: max abs err "
                     f"{e:.3e}, rel L2 {rel_l2:.2e}, max/max|ref| "
                     f"{rel_max:.2e} (plain bf16 rel L2 {plain16:.2e}), f32 "
                     f"kernel on 1024 crops {e32:.3e}; kernel {t_k:.3f} ms "
                     f"({net_flops / t_k / 1e9:.1f} TFLOP/s, "
                     f"{net_bytes / t_k / 1e6:.1f} GB/s; call {t_call:.3f} "
                     f"ms), bound {net_bound:.3f} ms ({net_by}), plain "
                     f"{t_p:.3f} ms")
        del raw, x32, x, got, want, few, want32
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16)
    results["crop_net_trunk"] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=bound_by, library_ms=None)
    phase("K5", "crop_net_trunk bf16: " + "; ".join(parts) + f"; both "
          f"{ms:.3f} ms (call {call_ms:.3f} ms), plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP at "
          "the bf16 peak); library none (no single PyTorch call computes "
          f"conv + PReLU + pool + conv + PReLU) ({TIMING}; {card})")


def pnet_maps(torch, maps):
    """Every level's (probs, reg) maps as one flat f32 vector."""
    return torch.cat([t.reshape(-1).to(torch.float32) for pr in maps
                      for t in pr])


def phase_k2(torch, kernels, K2, K4, pyramid_planes, pnet, pyramids, card,
             results):
    """K2 read from the integral image, both grids, at the default and the
    stock line's pyramids: the f32 grid vs the plain version in f32 (rtol
    1e-4, atol 1e-5), the bf16 grid (the lines' path) by ``check_bf16``;
    each timed beside its bound (the integral image read once, 20 B
    written per cell; FLOPs at the bf16 or the f32 peak), and the plain
    ``pyramid_planes`` feed (f32 cast, weight copies and GEMMs) that the
    frames form replaced, timed alone."""
    row = results.setdefault("pnet_chain", {})
    for label, fr, sizes in pyramids:
        b = fr.shape[0]
        integ = K4.integral_image(fr)

        def kernel(dtype):
            return K2.pyramid_pnet(pnet, fr, sizes, integ, dtype)

        want32 = K2.pyramid_pnet_plain(pnet, fr, sizes, torch.float32)
        got32 = through_kernel(kernels, "pnet_chain",
                               lambda: kernel(torch.float32))
        err32 = 0.0
        for (gp, gr), (wp, wr), sz in zip(got32, want32, sizes):
            err32 = max(err32,
                        check_close(torch, gp, wp, 1e-4, 1e-5,
                                    f"K2 {label} f32 p {sz}"),
                        check_close(torch, gr, wr, 1e-4, 1e-5,
                                    f"K2 {label} f32 reg {sz}"))
        got16 = through_kernel(kernels, "pnet_chain",
                               lambda: kernel(torch.bfloat16))
        want16 = K2.pyramid_pnet_plain(pnet, fr, sizes, torch.bfloat16)
        err, rel_l2, rel_max, plain16 = check_bf16(
            torch, pnet_maps(torch, got16), pnet_maps(torch, want32),
            pnet_maps(torch, want16), f"K2 {label} bf16")
        del got32, want32, got16, want16
        ms, call_ms, plain_ms = timed(
            torch, "pnet_chain", lambda: kernel(torch.bfloat16),
            lambda: K2.pyramid_pnet_plain(pnet, fr, sizes, torch.bfloat16),
            plain_runs=5)
        ms32, call32, plain32 = timed(
            torch, "pnet_chain", lambda: kernel(torch.float32),
            lambda: K2.pyramid_pnet_plain(pnet, fr, sizes, torch.float32),
            plain_runs=5)
        feed_ms = device_ms(torch, lambda: pyramid_planes(
            fr.to(torch.float32), sizes), runs=5)
        cells = sum(b * int(np.prod(K2.level_cells(*s))) for s in sizes)
        nbytes = integ.numel() * 4 + cells * 5 * 4
        flops = b * pnet_flops(sizes)
        bound16, by16 = bound(nbytes, flops, PEAK_BF16)
        bound32, by32 = bound(nbytes, flops, PEAK_F32)
        pre = "" if label == "default" else f"{label}_"
        if label == "default":  # the contract's keys: the lines' bf16 grid
            row.update(max_abs_err=err, ms=ms, call_ms=call_ms,
                       plain_ms=plain_ms, bound_ms=bound16, bound_by=by16,
                       library_ms=None)
        else:
            row.update({f"{pre}max_abs_err": err, f"{pre}ms": ms,
                        f"{pre}call_ms": call_ms, f"{pre}plain_ms": plain_ms,
                        f"{pre}bound_ms": bound16, f"{pre}bound_by": by16})
        row.update({f"{pre}f32_max_abs_err": err32, f"{pre}f32_ms": ms32,
                    f"{pre}f32_call_ms": call32, f"{pre}f32_plain_ms": plain32,
                    f"{pre}f32_bound_ms": bound32, f"{pre}f32_bound_by": by32,
                    f"{pre}pyramid_feed_ms": feed_ms})
        phase("K2", f"pyramid_pnet {label} {b}x{SIZE}x{SIZE} u8 from the "
              f"integral image, levels {[s[0] for s in sizes]}: bf16 grid "
              f"vs plain f32 max abs err {err:.3e}, rel L2 {rel_l2:.2e}, "
              f"max/max|ref| {rel_max:.2e} (plain bf16 rel L2 "
              f"{plain16:.2e}); kernel {ms:.3f} ms, call {call_ms:.3f} ms, "
              f"plain bf16 {plain_ms:.3f} ms, bound {bound16:.3f} ms ({by16},"
              f" bf16 peak). f32 grid vs plain f32 max abs err {err32:.3e} "
              f"(rtol 1e-4, atol 1e-5); kernel {ms32:.3f} ms, call "
              f"{call32:.3f} ms, plain f32 {plain32:.3f} ms, bound "
              f"{bound32:.3f} ms ({by32}, f32 peak). The plain pyramid feed "
              f"the frames form replaced (f32 cast, weight copies, "
              f"pyramid_planes GEMMs) {feed_ms:.3f} ms. Library none (no "
              f"PyTorch call computes the pyramid + PNet chain) ({TIMING}; "
              f"{card})")
        del integ


def stage1_block_flops(h, w):
    """Multiply-adds x2 of each block of MobileNetV1-0.25 stage 1 on one
    h x w frame."""
    from vn_celeb_face_recognition_tpu_torch.ops.planar_s1 import (
        STAGE1_SPECS,
    )

    flops = []
    for kind, cin, cout, stride in STAGE1_SPECS:
        if stride == 2:
            h, w = (h + 1) // 2, (w + 1) // 2
        if kind == "conv_bn":
            flops.append(2 * h * w * cout * cin * 9)
        else:
            flops.append(2 * h * w * cin * 9 + 2 * h * w * cin * cout)
    return flops


def mnet_stage1_flops(h, w):
    """Multiply-adds x2 of MobileNetV1-0.25 stage 1 on one h x w frame."""
    return sum(stage1_block_flops(h, w))


def mnet_segment_work(b, h, w):
    """(bytes, FLOPs) of K6's three bf16 launches on b h x w frames: each
    reads its input once (u8 frames, then bf16 scratch) and writes its
    output once (bf16), and does the FLOPs of its two blocks."""
    flops = stage1_block_flops(h, w)
    sides, sizes = [(h, w)], [3]
    for c in (16, 32, 64):
        h, w = (h + 1) // 2, (w + 1) // 2
        sides.append((h, w))
        sizes.append(2 * c)
    work = {}
    for i in range(3):
        (hi, wi), (ho, wo) = sides[i], sides[i + 1]
        nbytes = b * (hi * wi * sizes[i] + ho * wo * sizes[i + 1])
        work[f"segment {i + 1}"] = (nbytes,
                                    b * (flops[2 * i] + flops[2 * i + 1]))
    return work


def pnet_flops(sizes):
    """Multiply-adds x2 of PNet's convs on every pyramid level."""
    from vn_celeb_face_recognition_tpu_torch.ops.pyramid_pnet import (
        level_cells,
    )

    flops = 0
    for oh, ow in sizes:
        hc, wc = level_cells(oh, ow)
        flops += 2 * (oh - 2) * (ow - 2) * 10 * 27
        flops += 2 * (hc + 2) * (wc + 2) * 16 * 90
        flops += 2 * hc * wc * (32 * 144 + 6 * 32)
    return flops


def warp_footprint_pixels(torch, mats, win, out_size, frames_at=None):
    """Distinct source pixels that valid bilinear taps read: what a warp
    must fetch at least once. Without ``frames_at`` each face's window is
    its own source (the windows form); with ``frames_at = (image_idx, oy,
    ox, (B, H, W))`` the faces' windows lie in shared frames (the frames
    form), and a frame pixel that the taps of several windows read counts
    once."""
    from vn_celeb_face_recognition_tpu_torch.ops.image import invert_affine

    k, dev = mats.shape[0], mats.device
    inv = invert_affine(mats)[:, :, :, None, None]
    ar = torch.arange(out_size, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    y0 = torch.floor(inv[:, 1, 0] * xx + inv[:, 1, 1] * yy + inv[:, 1, 2])
    x0 = torch.floor(inv[:, 0, 0] * xx + inv[:, 0, 1] * yy + inv[:, 0, 2])
    if frames_at is None:
        row0 = torch.arange(k, device=dev)[:, None, None] * win
        col0, width, size = 0, win, k * win * win
    else:
        image_idx, oy, ox, (b, h, w) = frames_at
        row0 = (image_idx.long() * h + oy.long())[:, None, None]
        col0, width, size = ox.long()[:, None, None], w, b * h * w
    seen = torch.zeros(size, dtype=torch.bool, device=dev)
    for dy in (0, 1):
        for dx in (0, 1):
            y, x = y0 + dy, x0 + dx
            ok = (y >= 0) & (y <= win - 1) & (x >= 0) & (x <= win - 1)
            idx = (row0 + y.clamp(0, win - 1).long()) * width + col0 \
                + x.clamp(0, win - 1).long()
            seen[idx[ok]] = True
    return int(seen.sum())


def similarity_mats(gen, k, lo, hi):
    """``k`` similarity maps from a 224 px window to a 112 px face at
    scales ``lo``-``hi`` in all four quadrants, the window's centre landing
    near the face's."""
    th = gen.uniform(-np.pi, np.pi, k)
    sc = gen.uniform(lo, hi, k)
    lin = np.stack([np.stack([np.cos(th) * sc, -np.sin(th) * sc], -1),
                    np.stack([np.sin(th) * sc, np.cos(th) * sc], -1)], 1)
    t = (55.5 + gen.uniform(-8, 8, (k, 2))
         - np.einsum("kij,j->ki", lin, np.array([111.5, 111.5])))
    return np.concatenate([lin, t[:, :, None]], -1).astype(np.float32)


def check_k1_boxes(torch, K1, mats, win, out_size):
    """The kernel's own tile boxes and stage decisions
    (``kernel_footprint_boxes``) equal ``ops.warp.footprint_boxes``, the
    rule the CPU tests hold to every valid tap: on ``mats`` and on 64 faces
    shrunk to 0.15-0.4, where boxes outgrow a stage buffer in either type.
    Returns the staged share of ``mats``' tiles by source type."""
    small = torch.from_numpy(similarity_mats(np.random.default_rng(5), 64,
                                             0.15, 0.4)).to(mats.device)
    both = torch.cat([mats, small])
    shares = {}
    for dt in (torch.uint8, torch.float32):
        kb, ks = K1.kernel_footprint_boxes(both, out_size, win, dt)
        pb, ps = K1.footprint_boxes(both.cpu(), out_size, win, dt)
        kb, ks = kb.cpu(), ks.cpu()
        if not (torch.equal(kb, pb) and torch.equal(ks, ps)):
            fail(f"K1 {dt} tile boxes: the kernel and footprint_boxes differ "
                 f"in {int((kb != pb).any(-1).sum())} boxes and "
                 f"{int((ks != ps).sum())} stage decisions")
        if bool(ks.all()) or not bool(ks.any()):
            fail(f"K1 {dt} box check saw only staged or only unstaged tiles")
        shares[dt] = float(ks[:mats.shape[0]].float().mean())
    return shares


def phase_k1(torch, F, kernels, K1, frames, card, results):
    """K1 on the production line's 512 faces: the windows form (f32
    windows cut from the frames, with F.grid_sample on the same windows as
    the library yardstick) and the frames form the engine runs (the uint8
    frames and per-face window origins), each held to its plain version;
    the fused frames form timed against gather + cast + windows form; the
    kernel's tile boxes held to ``ops.warp.footprint_boxes``."""
    gen = np.random.default_rng(0)
    dev = frames.device
    k, n = PROD_FACES, 224
    idx, oy, ox = (torch.from_numpy(gen.integers(0, hi, k)).to(
        device=dev, dtype=torch.int32) for hi in (BATCH, SIZE - n, SIZE - n))
    windows = K1.cut_windows(frames, idx, oy, ox, n)
    mats = torch.from_numpy(similarity_mats(gen, k, 0.4, 1.2)).to(dev)
    got = through_kernel(kernels, "similarity_warp",
                         lambda: K1.similarity_warp(windows, mats, 112))
    want = K1.similarity_warp_plain(windows, mats, 112)
    torch.cuda.synchronize()
    err_w = check_close(torch, got, want, 0.0, 1e-2, "K1 windows form")
    got_f = through_kernel(kernels, "similarity_warp",
                           lambda: K1.similarity_warp_frames(
                               frames, idx, oy, ox, n, mats, 112))
    want_f = K1.similarity_warp_frames_plain(frames, idx, oy, ox, n, mats,
                                             112)
    torch.cuda.synchronize()
    err_f = check_close(torch, got_f, want_f, 0.0, 1e-2, "K1 frames form")
    shares = check_k1_boxes(torch, K1, mats, n, 112)
    ms_w = device_ms(torch, lambda: K1.similarity_warp(windows, mats, 112),
                     KERNEL_GRIDS["similarity_warp"])
    ms_f, call_f, plain_ms = timed(
        torch, "similarity_warp",
        lambda: K1.similarity_warp_frames(frames, idx, oy, ox, n, mats, 112),
        lambda: K1.similarity_warp_frames_plain(frames, idx, oy, ox, n,
                                                mats, 112))
    ms_cut = median_ms(torch, lambda: K1.similarity_warp(
        K1.cut_windows(frames, idx, oy, ox, n), mats, 112))
    # library yardstick: F.grid_sample (zeros padding, align_corners)
    # on the same f32 windows with the sampling grid built outside the
    # timing
    from vn_celeb_face_recognition_tpu_torch.ops.image import invert_affine

    inv = invert_affine(mats)
    ys, xs = torch.meshgrid(torch.arange(112., device=dev),
                            torch.arange(112., device=dev), indexing="ij")
    sx = inv[:, 0, 0, None, None] * xs + inv[:, 0, 1, None, None] * ys \
        + inv[:, 0, 2, None, None]
    sy = inv[:, 1, 0, None, None] * xs + inv[:, 1, 1, None, None] * ys \
        + inv[:, 1, 2, None, None]
    grid = torch.stack([sx, sy], -1) * (2.0 / (n - 1)) - 1.0
    win_nchw = windows.permute(0, 3, 1, 2)

    def grid_sample():
        return F.grid_sample(win_nchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    lib_err = float((grid_sample().permute(0, 2, 3, 1) - want).abs().max())
    library_ms = device_ms(torch, grid_sample) if lib_err <= 1e-2 else None
    call_lib = median_ms(torch, grid_sample)
    # bounds: bytes the function must move. The old bound charged the whole
    # f32 window stack. The windows form must read the distinct pixels of
    # each window that valid taps read, in f32; the frames form the
    # distinct frame pixels that they read, in uint8, however many windows
    # share them, and its three int32 per face. Both add mats and the
    # output.
    out_bytes = got.numel() * 4 + mats.numel() * 4
    flops = got.numel() * 12
    old_ms, _ = bound(windows.numel() * 4 + out_bytes, flops, PEAK_F32)
    win_px = warp_footprint_pixels(torch, mats, n, 112)
    frame_px = warp_footprint_pixels(torch, mats, n, 112,
                                     (idx, oy, ox, frames.shape[:3]))
    bytes_w = win_px * 3 * 4 + out_bytes
    bytes_f = frame_px * 3 + k * 3 * 4 + out_bytes
    bound_w, _ = bound(bytes_w, flops, PEAK_F32)
    bound_ms, bound_by = bound(bytes_f, flops, PEAK_F32)
    results["similarity_warp"] = dict(
        max_abs_err=max(err_w, err_f), ms=ms_f, call_ms=call_f,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms)
    lib = (f"{library_ms:.4f} ms ({bytes_w / library_ms / 1e6:.0f} GB/s of "
           "the windows form's bytes)" if library_ms else "not timed")
    phase("K1", f"similarity_warp K={k} N={n} -> 112, scales 0.4-1.2 in "
          f"all quadrants ({TIMING}). Tile boxes equal "
          f"ops.warp.footprint_boxes in both source types; staged tiles "
          f"{shares[torch.uint8]:.2%} (uint8), {shares[torch.float32]:.2%} "
          f"(f32). Windows form (f32 windows): max abs err {err_w:.3e} (atol "
          f"1e-2 on 0-255), kernel {ms_w:.4f} ms ({bytes_w / ms_w / 1e6:.0f}"
          f" GB/s), bound {bound_w:.4f} ms ({win_px} window pixels read, "
          f"{win_px / (k * n * n):.1%} of the windows, in f32). Library: "
          f"F.grid_sample on the same f32 windows, max abs diff "
          f"{lib_err:.3e}, kernel {lib}, call {call_lib:.4f} ms. Frames "
          f"form (uint8 frames {tuple(frames.shape)}, the engine's path): "
          f"max abs diff vs the plain cut + warp {err_f:.3e} (atol 1e-2), "
          f"kernel {ms_f:.4f} ms ({bytes_f / ms_f / 1e6:.0f} GB/s), call "
          f"{call_f:.4f} ms vs gather + cast + windows form call "
          f"{ms_cut:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}: {frame_px} distinct frame pixels read, in "
          f"uint8); the old bound on the whole f32 window stack "
          f"{old_ms:.4f} ms ({card})")


def device_ms_by(torch, fn, role_of, runs=20):
    """Device ms per call of fn(), summed by ``role_of(kernel name)`` over
    the grids it gives a role (None: not counted), from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        role = role_of(e.key) if e.device_type == DeviceType.CUDA else None
        if role is not None:
            out[role] = (out.get(role, 0.0)
                         + e.self_device_time_total / runs / 1e3)
    return out


def conv_role(key):
    """K8's convolution (conv1, conv2, conv3) of a grid, from the template
    arguments <BN, TAPS, RES> in the profiler's kernel name."""
    if "conv_gemm_bf16" not in key:
        return None
    args = CONV_ARGS.search(key)
    if args is None:
        fail(f"K8: no template arguments in the kernel name {key!r}")
    taps = args.group(2) or args.group(5)
    res = (args.group(3) or args.group(6)) in ("true", "1")
    return "conv2" if taps == "9" else "conv3" if res else "conv1"


def conv_device_ms(torch, fn, runs=20):
    """Device ms per call of fn() in K8's grids, by convolution of the
    block (conv1, conv2, conv3, summed over the chain's blocks)."""
    out = device_ms_by(torch, fn, conv_role, runs)
    if sorted(out) != ["conv1", "conv2", "conv3"]:
        fail(f"K8: profiled convolutions {sorted(out)}")
    return out


def segment_role(key):
    """K6's bf16 segment of a grid, from its name and first template
    argument."""
    if "segment_mma" not in key:
        return None
    args = SEGMENT_ARGS.search(key)
    cin = args and (args.group(2) or args.group(3))
    if args is None or not (args.group(1) or cin in ("16", "32")):
        fail(f"K6: no segment in the kernel name {key!r}")
    return ("segment 1" if args.group(1) else
            "segment 2" if cin == "16" else "segment 3")


def conv_work(m, c, p):
    """(FLOPs, bytes) of conv1, conv2 and conv3 of one block over m pixels:
    each launch's inputs read once and its output written once (bf16)."""
    return {"conv1": (2 * m * c * p, 2 * (m * c + m * p + c * p)),
            "conv2": (2 * m * 9 * p * p, 2 * (2 * m * p + 9 * p * p)),
            "conv3": (2 * m * p * c, 2 * (m * p + 2 * m * c + p * c))}


def phase_k8(torch, kernels, K8, emo, card, results):
    """K8 on the emotion net's layer1 and layer2 tails at 512 faces and at
    3 (the last 128-pixel tile ragged), bf16 held to the plain version in
    f32, f32 on 16 faces at 1e-4; each convolution timed apart."""
    dev = next(emo.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(3)
    ms = call_ms = plain_ms = bound_ms = err = 0.0
    parts, bound_by = [], {}
    for name, layer, side, c, p in (("l1", emo.layer1, 56, 256, 64),
                                    ("l2", emo.layer2, 28, 512, 128)):
        blocks = list(layer)[1:]
        x = torch.relu(torch.randn((PROD_FACES, side, side, c),
                                   generator=gen, device=dev)).to(
                                       torch.bfloat16)
        # three launches (conv1, conv2, conv3) per block
        launches = 3 * len(blocks)
        got = through_kernel(kernels, "bottleneck_chain",
                             lambda: K8.bottleneck_chain(blocks, x),
                             launches=launches)
        want = K8.bottleneck_chain_plain(blocks, x.to(torch.float32))
        e, rel_l2, rel_max, plain16 = check_bf16(
            torch, got, want, K8.bottleneck_chain_plain(blocks, x),
            f"K8 bf16 {name}")
        del got, want
        few = x[:3]  # 3 x side x side pixels: the last tile is ragged
        got3 = through_kernel(kernels, "bottleneck_chain",
                              lambda: K8.bottleneck_chain(blocks, few),
                              launches=launches)
        _, rel3, rel_max3, _ = check_bf16(
            torch, got3, K8.bottleneck_chain_plain(blocks,
                                                   few.to(torch.float32)),
            K8.bottleneck_chain_plain(blocks, few), f"K8 bf16 {name} 3 faces")
        x32 = x[:16].to(torch.float32)
        want32 = K8.bottleneck_chain_plain(blocks, x32)
        e32 = check_close(torch, K8.bottleneck_chain(blocks, x32), want32,
                          1e-4, 1e-4 * float(want32.abs().max()),
                          f"K8 f32 {name}")
        t_k, t_call, t_p = timed(
            torch, "bottleneck_chain",
            lambda: K8.bottleneck_chain(blocks, x),
            lambda: K8.bottleneck_chain_plain(blocks, x))
        per_conv = conv_device_ms(torch,
                                  lambda: K8.bottleneck_chain(blocks, x))
        call_ms += t_call
        pix = PROD_FACES * side * side
        convs = []
        for role, (flops, nbytes) in conv_work(pix, c, p).items():
            t = per_conv[role]
            floor_ms, floor_by = bound(nbytes, flops, PEAK_BF16)
            convs.append(
                f"{role} {t:.3f} ms = {len(blocks) * flops / t / 1e9:.1f} "
                f"TFLOP/s, {len(blocks) * nbytes / t / 1e6:.0f} GB/s (own "
                f"floor {len(blocks) * floor_ms:.3f} ms, {floor_by})")
        flops = len(blocks) * pix * 2 * (2 * c * p + 9 * p * p)
        wbytes = len(blocks) * 2 * (2 * c * p + 9 * p * p)
        b_ms, b_by = bound(2 * pix * c * 2 + wbytes, flops, PEAK_BF16)
        ms, plain_ms, bound_ms, err = (ms + t_k, plain_ms + t_p,
                                       bound_ms + b_ms, max(err, e))
        bound_by[b_ms] = b_by
        parts.append(
            f"{name} C={c} {side}x{side} {len(blocks)} blocks vs plain f32: "
            f"max abs err {e:.3e}, rel L2 {rel_l2:.2e}, max/max|ref| "
            f"{rel_max:.2e} (plain bf16 rel L2 {plain16:.2e}); 3 faces rel L2 "
            f"{rel3:.2e}, max/max|ref| {rel_max3:.2e}; f32 kernel on 16 faces "
            f"{e32:.3e}; kernel {t_k:.3f} ms ({', '.join(convs)}), call "
            f"{t_call:.3f} ms, plain (cuDNN) {t_p:.3f} ms, bound {b_ms:.3f} "
            f"ms ({b_by}); kernel {'<' if t_k < t_p else '>='} plain")
        del x, few, got3, x32, want32
    results["bottleneck_chain"] = dict(
        max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by[max(bound_by)], library_ms=None)
    phase("K8", f"bottleneck_chain K={PROD_FACES}, bf16, 3 launches a "
          "block: " + "; ".join(parts) + f"; both chains {ms:.3f} ms (call "
          f"{call_ms:.3f} ms), plain {plain_ms:.3f} ms, bound {bound_ms:.3f} "
          f"ms ({TIMING}; {card})")


def main():
    if not os.path.isdir(os.path.join(HERE, PKG)):
        fail(f"no {PKG} package beside {os.path.basename(__file__)}; run "
             "it from a checkout")

    # ---- 1. card -------------------------------------------------------
    import torch

    if not torch.cuda.is_available():
        fail(f"torch {torch.__version__} sees no CUDA device")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    phase("card", f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{card}; capability {cap}; {torch.cuda.device_count()} device(s)")
    if cap != (9, 0):
        fail(f"need an sm_90 card, got capability {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    import torch.nn.functional as F

    from vn_celeb_face_recognition_tpu_torch.models import (
        MLPModel,
        RetinaFace,
        iresnet100,
        resnet_2branch_50,
    )
    from vn_celeb_face_recognition_tpu_torch.models.inception_resnet_v1 import (  # noqa: E501
        InceptionResnetV1,
    )
    from vn_celeb_face_recognition_tpu_torch.models.layers import seeded_init_
    from vn_celeb_face_recognition_tpu_torch.models.mtcnn import MTCNN
    from vn_celeb_face_recognition_tpu_torch.models.retinaface import (
        CHANNELS_SUBTRACT,
        WEIGHTS_NPZ,
    )
    from vn_celeb_face_recognition_tpu_torch.ops import bottleneck as K8
    from vn_celeb_face_recognition_tpu_torch.ops import crop as K4
    from vn_celeb_face_recognition_tpu_torch.ops import crops_net as K5
    from vn_celeb_face_recognition_tpu_torch.ops import emotion_stem as K7
    from vn_celeb_face_recognition_tpu_torch.ops import nms as K3
    from vn_celeb_face_recognition_tpu_torch.ops import planar_s1 as K6
    from vn_celeb_face_recognition_tpu_torch.ops import pyramid_pnet as K2
    from vn_celeb_face_recognition_tpu_torch.ops import warp as K1
    from vn_celeb_face_recognition_tpu_torch.ops.image import pyramid_planes
    from vn_celeb_face_recognition_tpu_torch.pipeline.engine import (
        FusedRecognitionEngine,
    )
    from vn_celeb_face_recognition_tpu_torch.utils import kernels
    from vn_celeb_face_recognition_tpu_torch.utils.device import (
        select_device,
    )
    from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames

    dev = select_device("cuda")  # raises when the card is not visible

    # ---- 2. build ------------------------------------------------------
    lib_path, build_s = kernels.build(verbose=True)
    kernels.library()
    phase("build", f"{os.path.relpath(lib_path, HERE)} in {build_s:.1f} s "
          "(nvcc -gencode arch=compute_90a,code=sm_90a, one process per "
          "source)")

    frames_np = build_frames(BATCH, SIZE, FACES_PER_FRAME)
    frames = torch.from_numpy(frames_np).to(dev)
    stock_np = build_frames(STOCK_BATCH, SIZE, FACES_PER_FRAME)
    stock = torch.from_numpy(stock_np).to(dev)
    results = {}

    # ---- 3. K2 vs plain ------------------------------------------------
    det = MTCNN(dtype=torch.bfloat16, device=dev, **DETECTOR)
    pyramids = []
    for label, fr, kw in (("default", frames, DETECTOR),
                          ("stock", stock, dict(min_face_size=20))):
        scales = MTCNN(device=dev, **kw)._scales(SIZE, SIZE)
        pyramids.append((label, fr, [(int(SIZE * s + 1), int(SIZE * s + 1))
                                     for s in scales]))
    phase_k2(torch, kernels, K2, K4, pyramid_planes, det.pnet, pyramids,
             card, results)

    # ---- 4. K1 vs plain ------------------------------------------------
    phase_k1(torch, F, kernels, K1, frames, card, results)

    # ---- 5-7. K3, K4, K5 vs plain at the stock line's shapes ------------
    phase_k3(torch, kernels, K3, dev, card, results)
    big_np, pasted = big_frame()
    big = torch.from_numpy(big_np[None]).to(dev)
    phase_k4(torch, kernels, K4, stock, big, pasted, card, results)
    del big
    phase_k5(torch, kernels, K5, det, card, results)

    # ---- 8. the default slice ------------------------------------------
    g = torch.Generator().manual_seed(0)
    enc = seeded_init_(InceptionResnetV1(dtype=torch.bfloat16), g)
    clf = seeded_init_(MLPModel(512, N_CLASSES), g)
    enc_cpu, clf_cpu = copy.deepcopy(enc), copy.deepcopy(clf)
    engine = FusedRecognitionEngine(
        det, enc, clf, target_fs=112, compute_dtype=torch.bfloat16,
        face_cap=FACE_BUCKETS, face_hint=BATCH * FACES_PER_FRAME)
    chunks = [frames, torch.from_numpy(np.roll(frames_np, 97, axis=2)).to(
        dev)]
    names = {label: f"celeb_{label}" for label in range(N_CLASSES)}
    for c in chunks:  # warm-up: cuDNN plans, allocator, buckets
        engine.identify(engine.process_adaptive(c), names, 0.5)
    times, valid_counts, counts, runs, out, _ = drive(
        torch, kernels, engine, chunks, CHUNKS, names)
    check_line_counts(counts, MTCNN_LINE_LAUNCHES, runs, "default",
                      results)
    chunk_ms = sorted(times)[len(times) // 2] * 1e3
    faces = sum(valid_counts) / len(valid_counts)
    phase("slice", f"{len(times)} chunks of {BATCH}x{SIZE}x{SIZE}, bf16; "
          f"valid faces per chunk {valid_counts}; median chunk "
          f"{chunk_ms:.2f} ms (host clock incl. identify), "
          f"{faces / chunk_ms * 1e3:.1f} faces/s on {card}; "
          f"launches {counts}; bucket {out['_face_cap_used']}")
    if min(valid_counts) < 0.9 * BATCH * FACES_PER_FRAME:
        fail(f"too few faces detected: {valid_counts}")

    # ---- 9. profile ---------------------------------------------------
    profile_chunk(torch, engine, chunks[0], names, chunk_ms, card, "profile",
                  "default", results)

    # ---- 10. card vs CPU -----------------------------------------------
    mtcnn_card_vs_cpu(torch, FusedRecognitionEngine, MTCNN, DETECTOR,
                      (enc, clf), (enc_cpu, clf_cpu), frames_np[:2],
                      FACE_BUCKETS, dev, "card-vs-cpu")
    del engine, det, enc, clf, enc_cpu, clf_cpu, chunks, frames
    torch.cuda.empty_cache()

    # ---- 11. the stock slice (bench.py --detector=mtcnn_stock) ---------
    sdet = MTCNN(min_face_size=20, out_cap=8, dtype=torch.bfloat16,
                 device=dev)
    g = torch.Generator().manual_seed(4)
    enc = seeded_init_(InceptionResnetV1(dtype=torch.bfloat16), g)
    clf = seeded_init_(MLPModel(512, N_CLASSES), g)
    enc_cpu, clf_cpu = copy.deepcopy(enc), copy.deepcopy(clf)
    engine = FusedRecognitionEngine(
        sdet, enc, clf, target_fs=112, compute_dtype=torch.bfloat16,
        face_cap=STOCK_BUCKETS, face_hint=STOCK_FACES)
    chunks = [stock, torch.from_numpy(np.roll(stock_np, 97, axis=2)).to(dev)]
    for c in chunks:  # warm-up
        engine.identify(engine.process_adaptive(c), names, 0.5)
    times, valid_counts, counts, runs, out, _ = drive(
        torch, kernels, engine, chunks, STOCK_CHUNKS, names)
    check_line_counts(counts, MTCNN_LINE_LAUNCHES, runs, "stock", results)
    chunk_ms = sorted(times)[len(times) // 2] * 1e3
    faces = sum(valid_counts) / len(valid_counts)
    phase("stock", f"{len(times)} chunks of {STOCK_BATCH}x{SIZE}x{SIZE}, "
          f"MTCNN min_face_size=20 caps {sdet.capacity_profile(SIZE, SIZE)}"
          f", bf16; valid faces per chunk {valid_counts}; {runs} chunk runs;"
          f" median chunk {chunk_ms:.2f} ms (host clock incl. identify), "
          f"{faces / chunk_ms * 1e3:.1f} faces/s on {card}; launches "
          f"{counts}; bucket {out['_face_cap_used']}")
    if min(valid_counts) < 0.9 * STOCK_FACES:
        fail(f"too few faces detected: {valid_counts}")

    # ---- 12. its profile -----------------------------------------------
    profile_chunk(torch, engine, chunks[0], names, chunk_ms, card,
                  "stock-profile", "stock", results)
    del engine, chunks, out

    # ---- 13. stock card vs CPU -----------------------------------------
    mtcnn_card_vs_cpu(torch, FusedRecognitionEngine, MTCNN,
                      dict(min_face_size=20, out_cap=8), (enc, clf),
                      (enc_cpu, clf_cpu), stock_np[:2], STOCK_BUCKETS, dev,
                      "stock-card-vs-cpu")
    del enc, clf, enc_cpu, clf_cpu, sdet

    # ---- 14. the MTCNN host API, card vs CPU ---------------------------
    host_api_card_vs_cpu(torch, MTCNN, stock_np, dev)
    big_frame_detect(torch, kernels, MTCNN, big_np, pasted, dev)
    del stock, big_np
    torch.cuda.empty_cache()

    # ---- production models ---------------------------------------------
    prod_np = build_frames(PROD_BATCH, SIZE, FACES_PER_FRAME)
    prod = torch.from_numpy(prod_np).to(dev)
    rdet = RetinaFace(weights_path=WEIGHTS_NPZ, dtype=torch.bfloat16,
                      device=dev, **RETINAFACE)
    g = torch.Generator().manual_seed(1)
    penc = seeded_init_(iresnet100(dtype=torch.bfloat16), g)
    pclf = seeded_init_(MLPModel(512, PROD_CLASSES), g)
    emo = seeded_init_(resnet_2branch_50(num_classes=EMOTION_TAGS,
                                         dtype=torch.bfloat16), g)
    with torch.no_grad():  # logits of order 1, so the softmax is not flat 0/1
        emo.fc.weight.mul_(0.02)
    penc_cpu, pclf_cpu, emo_cpu = (copy.deepcopy(m) for m in
                                   (penc, pclf, emo))
    for m in (penc, pclf, emo):
        m.to(dev).eval()

    # ---- 15. K6 vs plain ------------------------------------------------
    stage1 = rdet.net.body.stage1
    sub = CHANNELS_SUBTRACT
    # one launch per stride-2 segment
    got = through_kernel(kernels, "mnet_stage1", lambda: K6.mnet_stage1(
        stage1, prod, sub, torch.bfloat16), launches=3)
    want = K6.mnet_stage1_plain(stage1, prod, sub, torch.float32)
    err, rel_l2, rel_max, plain16 = check_bf16(
        torch, got, want, K6.mnet_stage1_plain(stage1, prod, sub,
                                               torch.bfloat16), "K6 bf16")
    # 97x131 frames: every segment's last tile ragged, and the frame rows
    # start at every offset of the 16-byte pieces segment 1 stages; then a
    # view that does not start on 16 bytes (the wrapper copies it)
    odd = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (3, 97, 131, 3), dtype=np.uint8)).to(dev)
    ragged = []
    for what, fr in (("2x97x131", odd[:2]), ("unaligned view", odd[1:])):
        _, rel_o, rel_max_o, _ = check_bf16(
            torch, K6.mnet_stage1(stage1, fr, sub, torch.bfloat16),
            K6.mnet_stage1_plain(stage1, fr, sub, torch.float32),
            K6.mnet_stage1_plain(stage1, fr, sub, torch.bfloat16),
            f"K6 bf16 {what}")
        ragged.append(f"{what} rel L2 {rel_o:.2e}, max/max|ref| "
                      f"{rel_max_o:.2e}")
    few = prod[:8]
    err32 = check_close(
        torch, K6.mnet_stage1(stage1, few, sub, torch.float32),
        K6.mnet_stage1_plain(stage1, few, sub, torch.float32), 1e-4, 1e-4,
        "K6 f32")
    ms, call_ms, plain_ms = timed(
        torch, "mnet_stage1",
        lambda: K6.mnet_stage1(stage1, prod, sub, torch.bfloat16),
        lambda: K6.mnet_stage1_plain(stage1, prod, sub, torch.bfloat16))
    # the function makes bf16 from u8: bounded at the bf16 peak
    bound_ms, bound_by = bound(prod.numel() + got.numel() * 2,
                               PROD_BATCH * mnet_stage1_flops(SIZE, SIZE),
                               PEAK_BF16)
    results["mnet_stage1"] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, library_ms=None)
    per_seg = device_ms_by(torch, lambda: K6.mnet_stage1(
        stage1, prod, sub, torch.bfloat16), segment_role)
    work = mnet_segment_work(PROD_BATCH, SIZE, SIZE)
    if sorted(per_seg) != sorted(work):
        fail(f"K6: profiled segments {sorted(per_seg)}")
    results["mnet_stage1"]["segment_ms"] = per_seg
    segs = []
    for seg, (nbytes, flops) in work.items():
        t = per_seg[seg]
        floor_ms, floor_by = bound(nbytes, flops, PEAK_BF16)
        segs.append(f"{seg} {t:.3f} ms = {flops / t / 1e9:.1f} TFLOP/s, "
                    f"{nbytes / t / 1e6:.0f} GB/s (own floor {floor_ms:.3f} "
                    f"ms, {floor_by})")
    phase("K6", f"mnet_stage1 {PROD_BATCH}x{SIZE}x{SIZE} u8 -> "
          f"{tuple(got.shape)} bf16 vs plain f32: max abs err {err:.3e}, "
          f"rel L2 {rel_l2:.2e}, max/max|ref| {rel_max:.2e} (plain bf16 "
          f"rel L2 {plain16:.2e}); {'; '.join(ragged)}; f32 kernel on 8 "
          f"frames max abs err {err32:.3e} (rtol/atol 1e-4); kernel "
          f"{ms:.3f} ms ("
          f"{'; '.join(segs)}), call {call_ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, bound {bound_ms:.3f} ms ({bound_by}, bf16 peak) ({TIMING}; "
          f"{card})")
    del got, want

    # ---- 16. K7 vs plain ------------------------------------------------
    faces = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 255, (PROD_FACES, 112, 112, 3)).astype(np.float32)).to(dev)
    conv1, bn1 = emo.conv1, emo.bn1
    got = through_kernel(kernels, "emotion_stem", lambda: K7.emotion_stem(
        conv1, bn1, faces, torch.bfloat16))
    want = K7.emotion_stem_plain(conv1, bn1, faces, torch.float32)
    err, rel_l2, rel_max, plain16 = check_bf16(
        torch, got, want, K7.emotion_stem_plain(conv1, bn1, faces,
                                                torch.bfloat16), "K7 bf16")
    scale = float(want.abs().max())
    err32 = check_close(
        torch, K7.emotion_stem(conv1, bn1, faces[:64], torch.float32),
        K7.emotion_stem_plain(conv1, bn1, faces[:64], torch.float32), 1e-4,
        1e-4 * scale, "K7 f32")
    ms, call_ms, plain_ms = timed(
        torch, "emotion_stem",
        lambda: K7.emotion_stem(conv1, bn1, faces, torch.bfloat16),
        lambda: K7.emotion_stem_plain(conv1, bn1, faces, torch.bfloat16))
    # the folded 4x4 conv, f32 faces in, bf16 out: bf16 peak
    bound_ms, bound_by = bound(faces.numel() * 4 + got.numel() * 2,
                               PROD_FACES * 112 * 112 * 64 * 48 * 2,
                               PEAK_BF16)
    results["emotion_stem"] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=None)
    phase("K7", f"emotion_stem K={PROD_FACES} 112 px f32 -> "
          f"{tuple(got.shape)} bf16 vs plain f32: max abs err {err:.3e}, "
          f"rel L2 {rel_l2:.2e}, max/max|ref| {rel_max:.2e} (plain bf16 "
          f"rel L2 {plain16:.2e}); f32 kernel on 64 faces max "
          f"abs err {err32:.3e} (rtol 1e-4, atol 1e-4 x max|ref|); kernel "
          f"{ms:.3f} ms, call {call_ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({bound_by}, folded 4x4 conv at the bf16 "
          f"peak) ({TIMING}; {card})")
    del faces, got, want

    # ---- 17. K8 vs plain -----------------------------------------------
    phase_k8(torch, kernels, K8, emo, card, results)

    # ---- 18. the production slice --------------------------------------
    engine = FusedRecognitionEngine(
        rdet, penc, pclf, target_fs=112, compute_dtype=torch.bfloat16,
        face_cap=PROD_BUCKETS, face_hint=PROD_FACES, emotion=emo,
        emotion_topk=EMOTION_TOPK)
    chunks = [prod, torch.from_numpy(np.roll(prod_np, 97, axis=2)).to(dev)]
    names = {label: f"celeb_{label}" for label in range(PROD_CLASSES)}
    for c in chunks:  # warm-up
        engine.identify(engine.process_adaptive(c), names, 0.5)
    times, valid_counts, counts, runs, out, res = drive(
        torch, kernels, engine, chunks, PROD_CHUNKS, names)
    # per chunk run: K6's three segments, one NMS (K3), one K1 and one K7
    # launch, and three K8 launches per block of layer1's and layer2's
    # tails (15)
    tail_blocks = len(emo.layer1) - 1 + len(emo.layer2) - 1
    check_line_counts(counts, {"mnet_stage1": 3, "nms_keep_mask": 1,
                               "similarity_warp": 1, "emotion_stem": 1,
                               "bottleneck_chain": 3 * tail_blocks}, runs,
                      "production", results)
    if any(len(r) != 4 for r in res):
        fail("identify did not return (names, boxes, emotion_idx, "
             "emotion_prob) per frame")
    v = out["valid"]
    if not bool(torch.isfinite(out["emotion_prob"][v]).all()):
        fail("non-finite emotion probabilities")
    chunk_ms = sorted(times)[len(times) // 2] * 1e3
    faces = sum(valid_counts) / len(valid_counts)
    phase("production", f"{len(times)} chunks of {PROD_BATCH}x{SIZE}x{SIZE},"
          f" RetinaFace + iresnet100 + emotion, bf16; valid faces per chunk "
          f"{valid_counts}; {runs} chunk runs; median chunk {chunk_ms:.2f} ms"
          f" (host clock incl. identify), {faces / chunk_ms * 1e3:.1f} "
          f"faces/s on {card}; launches {counts}; bucket "
          f"{out['_face_cap_used']}")
    if min(valid_counts) < 0.9 * PROD_FACES:
        fail(f"too few faces detected: {valid_counts}")

    # ---- 19. profile ---------------------------------------------------
    profile_chunk(torch, engine, chunks[0], names, chunk_ms, card,
                  "production-profile", "production", results)
    del engine, chunks, out, res

    # ---- 20. production card vs CPU ------------------------------------
    two = prod_np[:2]
    outs = []
    for where, e, c, m in ((dev, penc, pclf, emo),
                           ("cpu", penc_cpu, pclf_cpu, emo_cpu)):
        e.dtype = m.dtype = torch.float32
        eng = FusedRecognitionEngine(
            RetinaFace(weights_path=WEIGHTS_NPZ, dtype=torch.float32,
                       device=where, **RETINAFACE), e, c, target_fs=112,
            compute_dtype=torch.float32, face_cap=[8, 16], face_hint=8,
            emotion=m, emotion_topk=EMOTION_TOPK)
        outs.append({key: v.cpu() for key, v in
                     eng.process_adaptive(two).items()
                     if isinstance(v, torch.Tensor)})
    gpu, cpu = outs
    if not torch.equal(gpu["valid"], cpu["valid"]):
        fail("production card vs CPU: valid masks differ")
    v = cpu["valid"]
    box_err = float((gpu["boxes"][v] - cpu["boxes"][v]).abs().max())
    cos = torch.nn.functional.cosine_similarity(
        gpu["embeddings"][v], cpu["embeddings"][v], dim=-1)
    top1_equal = bool(torch.equal(gpu["emotion_idx"][v][:, 0],
                                  cpu["emotion_idx"][v][:, 0]))
    prob_err = float((gpu["emotion_prob"][v]
                      - cpu["emotion_prob"][v]).abs().max())
    phase("production-card-vs-cpu", f"2x{SIZE}x{SIZE} f32: {int(v.sum())} "
          f"valid on both; max box diff {box_err:.2e} (atol 1e-2); min "
          f"embedding cosine {float(cos.min()):.6f} (>= 0.999); emotion "
          f"top-1 equal {top1_equal}; max emotion prob diff {prob_err:.2e} "
          "(atol 5e-3)")
    if (int(v.sum()) == 0 or box_err > 1e-2 or float(cos.min()) < 0.999
            or not top1_equal or prob_err > 5e-3):
        fail("production card vs CPU outside tolerance")

    kernel_rows = []
    for kname, (src, replaces) in KERNEL_SOURCES.items():
        r = results[kname]
        # the contract's keys, then call_ms, K2's stock-pyramid numbers and
        # K6's per-segment device times
        kernel_rows.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": r.pop("launches"),
            "max_abs_err": r.pop("max_abs_err"), "ms": r.pop("ms"),
            "plain_ms": r.pop("plain_ms"), "bound_ms": r.pop("bound_ms"),
            "bound_by": r.pop("bound_by"), "library_ms": r.pop("library_ms"),
            **r})
    phase("done", f"all phases passed in {time.perf_counter() - t_start:.1f}"
          " s after the card check")
    print(json.dumps({"kernels": kernel_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
