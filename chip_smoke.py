#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (sm_90).

Drives the port's main path — the default bench line: MTCNN(min_face_size
=50) -> window cut + Umeyama + warp -> InceptionResnetV1 (full depth, bf16)
-> MLP(512, 1001) over 64-frame 640x640 chunks — and checks each
hand-written kernel against its plain PyTorch version on the card.
Phases, one line of output each (a failed phase exits non-zero):

  1. card: torch version, nvidia-smi name and power limit, sm_90 check;
  2. build: compiles csrc/*.cu with nvcc;
  3. K2 (pnet_chain) vs the per-level PNet forward, bench shapes, f32;
  4. K1 (similarity_warp) vs the plain bilinear warp, 320 faces;
  5. the slice: process_adaptive + identify on alternating chunks, with
     launch counters reset just before and read just after;
  6. profile: device busy time of one chunk under torch.profiler, and
     the table of its ops and kernels by device time;
  7. card vs CPU: the same engine in f32 on a 2-frame chunk.

Then one JSON line with every kernel's numbers, the card line, and the
last line {"ok": true, "device": {...}}. Weights are random from a seed;
the MTCNN weights are the published ones vendored in the repo.

Usage, from the root of a checkout: python3 chip_smoke.py
"""

import copy
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCES = {
    "pnet_chain": (
        "vn_celeb_face_recognition_tpu_torch/csrc/pyramid_pnet.cu",
        "vn_celeb_face_recognition_tpu/ops/pyramid_pnet_pallas.py:287"),
    "similarity_warp": (
        "vn_celeb_face_recognition_tpu_torch/csrc/similarity_warp.cu",
        "vn_celeb_face_recognition_tpu/ops/warp_pallas.py:245"),
}
DETECTOR = dict(min_face_size=50, pnet_cap_per_scale=128,
                cross_cap=256, rnet_cap=64, onet_cap=32, out_cap=8)
BATCH, SIZE, FACES_PER_FRAME = 64, 640, 4
FACE_BUCKETS = [256, 320]
N_CLASSES = 1001
CHUNKS = 8


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
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        fail(f"{what}: {int(bad.sum())} elements outside rtol={rtol} "
             f"atol={atol}, max abs err {float(err.max()):.3e}")
    return float(err.max())


def through_kernel(kernels, name, fn):
    """``fn()``, which must launch kernel ``name`` exactly once."""
    before = kernels.launch_counts()[name]
    out = fn()
    if kernels.launch_counts()[name] != before + 1:
        fail(f"{name}: the wrapper did not launch its kernel on CUDA tensors")
    return out


def main():
    if not os.path.isdir(os.path.join(HERE,
                                      "vn_celeb_face_recognition_tpu_torch")):
        fail(f"no vn_celeb_face_recognition_tpu_torch package beside "
             f"{os.path.basename(__file__)}; run it from a checkout")

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

    from vn_celeb_face_recognition_tpu_torch.models.inception_resnet_v1 import (  # noqa: E501
        InceptionResnetV1,
    )
    from vn_celeb_face_recognition_tpu_torch.models.layers import seeded_init_
    from vn_celeb_face_recognition_tpu_torch.models.mlp import MLPModel
    from vn_celeb_face_recognition_tpu_torch.models.mtcnn import MTCNN
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
          "(nvcc -gencode arch=compute_90a,code=sm_90a)")

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
    results["pnet_chain"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    phase("K2", f"pnet_chain {BATCH}x{SIZE}x{SIZE}, levels "
          f"{[s[0] for s in sizes]}, f32: max abs err {err:.3e} "
          f"(rtol 1e-4, atol 1e-5); kernel {ms:.3f} ms, plain {plain_ms:.3f}"
          f" ms (median of 20, CUDA events; {card})")

    # ---- 4. K1 vs plain ------------------------------------------------
    gen = np.random.default_rng(0)
    k, n = FACE_BUCKETS[-1], 224
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
    results["similarity_warp"] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms)
    phase("K1", f"similarity_warp K={k} N={n} -> 112: max abs err "
          f"{err:.3e} (atol 1e-2 on 0-255); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms (median of 20, CUDA events; {card})")
    del windows, got, want, planes

    # ---- 5. the slice --------------------------------------------------
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
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times, valid_counts = [], []
    for i in range(CHUNKS):
        t0 = time.perf_counter()
        out = engine.process_adaptive(chunks[i % 2])
        res = engine.identify(out, names, 0.5)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        valid = out["valid"]
        valid_counts.append(int(valid.sum()))
        emb = out["embeddings"][valid]
        if not bool(torch.isfinite(emb).all()):
            fail(f"chunk {i}: non-finite embeddings")
        if sum(len(r[0]) for r in res) != valid_counts[-1]:
            fail(f"chunk {i}: identify lost faces")
    counts = kernels.launch_counts()
    for kname, c in counts.items():
        if c == 0:
            fail(f"kernel {kname} was not launched on the main path")
        results[kname]["launches"] = c
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = engine.process_adaptive(chunks[0])
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
    phase("profile", f"one chunk: device busy {busy_ms:.2f} ms = "
          f"{busy_ms / chunk_ms:.1%} of the median chunk {chunk_ms:.2f} ms "
          f"(device idle {1 - busy_ms / chunk_ms:.1%}; {card})")

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

    kernel_rows = []
    for kname, (src, replaces) in KERNEL_SOURCES.items():
        r = results[kname]
        kernel_rows.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernel_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
