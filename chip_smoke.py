#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (sm_90).

Drives the port's two paths through the entry points a user calls
(``FusedRecognitionEngine.process_adaptive`` + ``identify``) and checks
each hand-written kernel against its plain PyTorch version on the card:

* the default bench line: MTCNN(min_face_size=50) -> window cut +
  Umeyama + warp -> InceptionResnetV1 (full depth, bf16) -> MLP(512,
  1001) over 64-frame 640x640 chunks (kernels K2, K1);
* the production line (``bench.py --production``): RetinaFace cfg_mnet
  (bf16, the vendored fitted weights) -> warp -> iresnet100 (bf16) ->
  MLP(512, 1020), plus the 2-branch ResNet-50 emotion head (690 tags,
  top 6) over 128-frame 640x640 chunks (kernels K6, K1, K7, K8).

Phases, one line of output each (a failed phase exits non-zero):

   1. card: torch version, nvidia-smi name and power limit, sm_90 check;
   2. build: compiles csrc/*.cu with nvcc (one process per source);
   3. K2 (pnet_chain) vs the per-level PNet forward, bench shapes, f32;
   4. K1 (similarity_warp) vs the plain bilinear warp, 512 faces, and
      F.grid_sample as the library yardstick;
   5. the default slice: chunks with launch counters reset just before
      and read just after;
   6. its profile: device busy time of one chunk under torch.profiler;
   7. its card vs CPU: the same engine in f32 on a 2-frame chunk;
   8. K6 (mnet_stage1) vs the stage's cuDNN modules, 128x640x640;
   9. K7 (emotion_stem) vs resize + normalise + cuDNN stem, 512 faces;
  10. K8 (bottleneck_chain) vs the blocks' cuDNN modules, layer1 and
      layer2 tails at 512 faces;
  11. the production slice, counters reset just before, read just after;
  12. its profile;
  13. its card vs CPU in f32 on 2 frames.

Kernel phases check bf16 at the production shapes and f32 on a slice of
them. Then one JSON line with every kernel's numbers, the card line, and
the last line {"ok": true, "device": {...}}. Weights are random from a
seed, except the published MTCNN weights and the fitted RetinaFace
weights vendored in the repo.

Usage, from the root of a checkout: python3 chip_smoke.py
"""

import copy
import json
import os
import subprocess
import sys
import time

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
}
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
# NVIDIA H100 SXM data-sheet peaks (dense), at the 700 W limit
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# a bf16 kernel is held to its plain version computed in f32 on the same
# inputs: the kernels accumulate in f32 and round to bf16 (8 significant
# bits, eps 2**-8) at their outputs and, for K6 and K8, at a few staged
# intermediates and folded weights. The plain version run in bf16 rounds
# after every layer, before BatchNorm's scale, and is printed beside it.
BF16_REL_L2, BF16_REL_MAX = 1e-2, 5e-2


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


def profile_chunk(torch, engine, frames, names, chunk_ms, card, what):
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
    busy_ms = sum(e.self_device_time_total for e in averages
                  if e.device_type == DeviceType.CUDA) / 1e3
    if busy_ms <= 0.0:
        fail("torch.profiler recorded no device time")
    print(averages.table(sort_by="self_device_time_total", row_limit=25))
    phase(what, f"one chunk: device busy {busy_ms:.2f} ms = "
          f"{busy_ms / chunk_ms:.1%} of the median chunk {chunk_ms:.2f} ms "
          f"(device idle {1 - busy_ms / chunk_ms:.1%}; {card})")
    return busy_ms


def mnet_stage1_flops(h, w):
    """Multiply-adds x2 of MobileNetV1-0.25 stage 1 on one h x w frame."""
    from vn_celeb_face_recognition_tpu_torch.ops.planar_s1 import (
        STAGE1_SPECS,
    )

    flops = 0
    for kind, cin, cout, stride in STAGE1_SPECS:
        if stride == 2:
            h, w = (h + 1) // 2, (w + 1) // 2
        if kind == "conv_bn":
            flops += 2 * h * w * cout * cin * 9
        else:
            flops += 2 * h * w * cin * 9 + 2 * h * w * cin * cout
    return flops


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


def main():
    if not os.path.isdir(os.path.join(HERE, PKG)):
        fail(f"no {PKG} package beside {os.path.basename(__file__)}; run "
             "it from a checkout")

    # ---- 1. card -------------------------------------------------------
    import numpy as np
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
    from vn_celeb_face_recognition_tpu_torch.ops import emotion_stem as K7
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
    results = {}

    # ---- 3. K2 vs plain ------------------------------------------------
    det = MTCNN(dtype=torch.bfloat16, device=dev, **DETECTOR)
    scales = det._scales(SIZE, SIZE)
    sizes = [(int(SIZE * s + 1), int(SIZE * s + 1)) for s in scales]
    planes = pyramid_planes(frames.to(torch.float32), sizes)
    got = through_kernel(kernels, "pnet_chain",
                         lambda: K2.pnet_chain(det.pnet, planes))
    want = K2.pnet_chain_plain(det.pnet, planes)
    torch.cuda.synchronize()
    err = 0.0
    for (gp, gr), (wp, wr), s in zip(got, want, sizes):
        err = max(err, check_close(torch, gp, wp, 1e-4, 1e-5, f"K2 p {s}"),
                  check_close(torch, gr, wr, 1e-4, 1e-5, f"K2 reg {s}"))
    ms = median_ms(torch, lambda: K2.pnet_chain(det.pnet, planes))
    plain_ms = median_ms(torch, lambda: K2.pnet_chain_plain(det.pnet, planes))
    cells = sum(BATCH * np.prod(K2.level_cells(*s)) for s in sizes)
    nbytes = sum(p.numel() * 4 for p in planes) + cells * 5 * 4
    bound_ms, bound_by = bound(nbytes, BATCH * pnet_flops(sizes), PEAK_F32)
    results["pnet_chain"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 library_ms=None)
    phase("K2", f"pnet_chain {BATCH}x{SIZE}x{SIZE}, levels "
          f"{[s[0] for s in sizes]}, f32: max abs err {err:.3e} "
          f"(rtol 1e-4, atol 1e-5); kernel {ms:.3f} ms, plain {plain_ms:.3f}"
          f" ms, bound {bound_ms:.3f} ms ({bound_by}) (median of 20, CUDA "
          f"events; {card})")
    del planes, got, want

    # ---- 4. K1 vs plain ------------------------------------------------
    gen = np.random.default_rng(0)
    k, n = PROD_FACES, 224
    idx = torch.from_numpy(gen.integers(0, BATCH, k)).to(dev)
    oy = torch.from_numpy(gen.integers(0, SIZE - n, k)).to(dev)
    ox = torch.from_numpy(gen.integers(0, SIZE - n, k)).to(dev)
    ar = torch.arange(n, device=dev)
    windows = frames[idx[:, None, None], oy[:, None, None] + ar[None, :, None],
                     ox[:, None, None] + ar[None, None, :]].to(torch.float32)
    th = gen.uniform(-np.pi, np.pi, k)  # all four quadrants
    sc = gen.uniform(0.4, 1.2, k)
    lin = np.stack([np.stack([np.cos(th) * sc, -np.sin(th) * sc], -1),
                    np.stack([np.sin(th) * sc, np.cos(th) * sc], -1)], 1)
    t = (55.5 + gen.uniform(-8, 8, (k, 2))
         - np.einsum("kij,j->ki", lin, np.array([111.5, 111.5])))
    mats = torch.from_numpy(np.concatenate([lin, t[:, :, None]], -1).astype(
        np.float32)).to(dev)
    got = through_kernel(kernels, "similarity_warp",
                         lambda: K1.similarity_warp(windows, mats, 112))
    want = K1.similarity_warp_plain(windows, mats, 112)
    torch.cuda.synchronize()
    err = check_close(torch, got, want, 0.0, 1e-2, "K1")
    ms = median_ms(torch, lambda: K1.similarity_warp(windows, mats, 112))
    plain_ms = median_ms(torch, lambda: K1.similarity_warp_plain(
        windows, mats, 112))
    # library yardstick: F.grid_sample (zeros padding, align_corners)
    # on the same windows with the sampling grid built outside the timing
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
    library_ms = median_ms(torch, grid_sample) if lib_err <= 1e-2 else None
    nbytes = windows.numel() * 4 + mats.numel() * 4 + got.numel() * 4
    bound_ms, bound_by = bound(nbytes, got.numel() * 12, PEAK_F32)
    results["similarity_warp"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)
    phase("K1", f"similarity_warp K={k} N={n} -> 112: max abs err "
          f"{err:.3e} (atol 1e-2 on 0-255); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); "
          f"F.grid_sample max abs diff {lib_err:.3e}, "
          f"{'%.3f ms' % library_ms if library_ms else 'not timed'} "
          f"(median of 20, CUDA events; {card})")
    del windows, got, want, grid, win_nchw

    # ---- 5. the default slice ------------------------------------------
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
    for kname in ("pnet_chain", "similarity_warp"):
        if counts[kname] != runs:
            fail(f"kernel {kname}: {counts[kname]} launches in {runs} "
                 "chunk runs of the default line")
        results[kname]["launches"] = counts[kname]
    chunk_ms = sorted(times)[len(times) // 2] * 1e3
    faces = sum(valid_counts) / len(valid_counts)
    phase("slice", f"{len(times)} chunks of {BATCH}x{SIZE}x{SIZE}, bf16; "
          f"valid faces per chunk {valid_counts}; median chunk "
          f"{chunk_ms:.2f} ms (host clock incl. identify), "
          f"{faces / chunk_ms * 1e3:.1f} faces/s on {card}; "
          f"launches {counts}; bucket {out['_face_cap_used']}")
    if min(valid_counts) < 0.9 * BATCH * FACES_PER_FRAME:
        fail(f"too few faces detected: {valid_counts}")

    # ---- 6. profile ---------------------------------------------------
    profile_chunk(torch, engine, chunks[0], names, chunk_ms, card, "profile")

    # ---- 7. card vs CPU ------------------------------------------------
    two = frames_np[:2]
    outs = []
    for where, e, c in ((dev, enc, clf), ("cpu", enc_cpu, clf_cpu)):
        e.dtype = torch.float32
        eng = FusedRecognitionEngine(
            MTCNN(dtype=torch.float32, device=where, **DETECTOR), e, c,
            target_fs=112, compute_dtype=torch.float32,
            face_cap=FACE_BUCKETS)
        outs.append({key: v.cpu() for key, v in
                     eng.process_adaptive(two).items()
                     if isinstance(v, torch.Tensor)})
    gpu, cpu = outs
    if not torch.equal(gpu["valid"], cpu["valid"]):
        fail("card vs CPU: valid masks differ")
    v = cpu["valid"]
    box_err = float((gpu["boxes"][v] - cpu["boxes"][v]).abs().max())
    cos = torch.nn.functional.cosine_similarity(
        gpu["embeddings"][v], cpu["embeddings"][v], dim=-1)
    phase("card-vs-cpu", f"2x{SIZE}x{SIZE} f32: {int(v.sum())} valid on "
          f"both; max box diff {box_err:.2e} (atol 1e-2); min embedding "
          f"cosine {float(cos.min()):.6f} (>= 0.999)")
    if int(v.sum()) == 0 or box_err > 1e-2 or float(cos.min()) < 0.999:
        fail("card vs CPU outside tolerance")
    del engine, eng, det, enc, clf, enc_cpu, clf_cpu, chunks, frames
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

    # ---- 8. K6 vs plain ------------------------------------------------
    stage1 = rdet.net.body.stage1
    sub = CHANNELS_SUBTRACT
    # one launch per stride-2 segment
    got = through_kernel(kernels, "mnet_stage1", lambda: K6.mnet_stage1(
        stage1, prod, sub, torch.bfloat16), launches=3)
    want = K6.mnet_stage1_plain(stage1, prod, sub, torch.float32)
    err, rel_l2, rel_max, plain16 = check_bf16(
        torch, got, want, K6.mnet_stage1_plain(stage1, prod, sub,
                                               torch.bfloat16), "K6 bf16")
    few = prod[:8]
    err32 = check_close(
        torch, K6.mnet_stage1(stage1, few, sub, torch.float32),
        K6.mnet_stage1_plain(stage1, few, sub, torch.float32), 1e-4, 1e-4,
        "K6 f32")
    ms = median_ms(torch, lambda: K6.mnet_stage1(stage1, prod, sub,
                                                 torch.bfloat16))
    plain_ms = median_ms(torch, lambda: K6.mnet_stage1_plain(
        stage1, prod, sub, torch.bfloat16))
    # the function makes bf16 from u8: bounded at the bf16 peak
    bound_ms, bound_by = bound(prod.numel() + got.numel() * 2,
                               PROD_BATCH * mnet_stage1_flops(SIZE, SIZE),
                               PEAK_BF16)
    results["mnet_stage1"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  library_ms=None)
    phase("K6", f"mnet_stage1 {PROD_BATCH}x{SIZE}x{SIZE} u8 -> "
          f"{tuple(got.shape)} bf16 vs plain f32: max abs err {err:.3e}, "
          f"rel L2 {rel_l2:.2e}, max/max|ref| {rel_max:.2e} (plain bf16 "
          f"rel L2 {plain16:.2e}); f32 kernel on 8 frames max "
          f"abs err {err32:.3e} (rtol/atol 1e-4); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, bf16 "
          f"peak) (median of 20, CUDA events; {card})")
    del got, want

    # ---- 9. K7 vs plain ------------------------------------------------
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
    ms = median_ms(torch, lambda: K7.emotion_stem(conv1, bn1, faces,
                                                  torch.bfloat16))
    plain_ms = median_ms(torch, lambda: K7.emotion_stem_plain(
        conv1, bn1, faces, torch.bfloat16))
    # the folded 4x4 conv, f32 faces in, bf16 out: bf16 peak
    bound_ms, bound_by = bound(faces.numel() * 4 + got.numel() * 2,
                               PROD_FACES * 112 * 112 * 64 * 48 * 2,
                               PEAK_BF16)
    results["emotion_stem"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=None)
    phase("K7", f"emotion_stem K={PROD_FACES} 112 px f32 -> "
          f"{tuple(got.shape)} bf16 vs plain f32: max abs err {err:.3e}, "
          f"rel L2 {rel_l2:.2e}, max/max|ref| {rel_max:.2e} (plain bf16 "
          f"rel L2 {plain16:.2e}); f32 kernel on 64 faces max "
          f"abs err {err32:.3e} (rtol 1e-4, atol 1e-4 x max|ref|); kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}, folded 4x4 conv at the bf16 peak) (median of 20, "
          f"CUDA events; {card})")
    del faces, got, want

    # ---- 10. K8 vs plain -----------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(3)
    ms = plain_ms = bound_ms = err = 0.0
    parts, bound_by = [], {}
    for layer, side, c, p in ((emo.layer1, 56, 256, 64),
                              (emo.layer2, 28, 512, 128)):
        blocks = list(layer)[1:]
        x = torch.relu(torch.randn((PROD_FACES, side, side, c),
                                   generator=gen, device=dev)).to(
                                       torch.bfloat16)
        # one launch per block
        got = through_kernel(kernels, "bottleneck_chain",
                             lambda: K8.bottleneck_chain(blocks, x),
                             launches=len(blocks))
        want = K8.bottleneck_chain_plain(blocks, x.to(torch.float32))
        e, rel_l2, rel_max, plain16 = check_bf16(
            torch, got, want, K8.bottleneck_chain_plain(blocks, x),
            f"K8 bf16 C={c}")
        x32 = x[:16].to(torch.float32)
        want32 = K8.bottleneck_chain_plain(blocks, x32)
        e32 = check_close(torch, K8.bottleneck_chain(blocks, x32), want32,
                          1e-4, 1e-4 * float(want32.abs().max()),
                          f"K8 f32 C={c}")
        t_k = median_ms(torch, lambda: K8.bottleneck_chain(blocks, x))
        t_p = median_ms(torch, lambda: K8.bottleneck_chain_plain(blocks, x))
        pix = PROD_FACES * side * side
        flops = len(blocks) * pix * 2 * (2 * c * p + 9 * p * p)
        wbytes = len(blocks) * 2 * (2 * c * p + 9 * p * p)
        b_ms, b_by = bound(2 * pix * c * 2 + wbytes, flops, PEAK_BF16)
        ms, plain_ms, bound_ms, err = (ms + t_k, plain_ms + t_p,
                                       bound_ms + b_ms, max(err, e))
        bound_by[b_ms] = b_by
        parts.append(f"C={c} {side}x{side} {len(blocks)} blocks vs plain "
                     f"f32: max abs err {e:.3e}, rel L2 {rel_l2:.2e}, "
                     f"max/max|ref| {rel_max:.2e} (plain bf16 rel L2 "
                     f"{plain16:.2e}), f32 kernel on 16 faces {e32:.3e}; kernel "
                     f"{t_k:.3f} ms, plain {t_p:.3f} ms, bound {b_ms:.3f} ms "
                     f"({b_by})")
        del x, got, want, x32, want32
    results["bottleneck_chain"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by[max(bound_by)], library_ms=None)
    phase("K8", f"bottleneck_chain K={PROD_FACES}, bf16: " + "; ".join(parts)
          + f"; both chains {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms (median of 20, CUDA events; {card})")

    # ---- 11. the production slice --------------------------------------
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
    # per chunk run: K6's three segments, one K1 and one K7 launch, and
    # one K8 launch per block of layer1's and layer2's tails
    tail_blocks = len(emo.layer1) - 1 + len(emo.layer2) - 1
    want_counts = {"mnet_stage1": 3 * runs, "similarity_warp": runs,
                   "emotion_stem": runs,
                   "bottleneck_chain": tail_blocks * runs, "pnet_chain": 0}
    if counts != want_counts:
        fail(f"production launches {counts}, want {want_counts} for {runs} "
             "chunk runs")
    for kname in ("mnet_stage1", "emotion_stem", "bottleneck_chain"):
        results[kname]["launches"] = counts[kname]
    results["similarity_warp"]["launches"] += counts["similarity_warp"]
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

    # ---- 12. profile ---------------------------------------------------
    profile_chunk(torch, engine, chunks[0], names, chunk_ms, card,
                  "production-profile")
    del engine, chunks, out, res

    # ---- 13. production card vs CPU ------------------------------------
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
        kernel_rows.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    phase("done", f"all phases passed in {time.perf_counter() - t_start:.1f}"
          " s after the card check")
    print(json.dumps({"kernels": kernel_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
