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
      with nv in {0, 1, 31, 32, 33, 65}, with +-0.0, +-inf and NaN
      scores, and with NaN and +-inf coordinates (pairs whose IoU is NaN
      keep both boxes, an empty intersection over a NaN denominator at a
      negative threshold too), and at every shape the three lines launch, each
      with its
      sets in priority order (as ops.boxes.top_k_select hands them over)
      and not; every line shape timed both ways beside its bound;
   6. K4 (crop_area_resize: the integral image in two grids, band totals
      and one scan that writes each entry once, and pools that compute
      their own cell bounds) bit-exact to the plain integral-image crops
      on the stock chunk at S = 24 and 48, and on one 4032x3024 frame
      whose int32 prefix sums wrap; the integral image timed alone and
      with both pools;
   7. K5 (crop_net_trunk) vs the nets' cuDNN modules at the stock line's
      crop counts (bf16 on the tensor cores, f32 in 3xTF32 on 1,024
      crops), RNet and ONet timed apart with their TFLOP/s and GB/s;
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
      layer2 tails at 512 faces and at 3 (a ragged last tile), f32
      (3xTF32) on 16 faces, with each convolution's device time, TFLOP/s
      and GB/s;
  18. the production slice, counters held the same way;
  19. its profile;
  20. its card vs CPU in f32 on 2 frames;
  21. the recognition library (``pipeline.recognition``) through its
      entry points on 4 frames: MTCNN (cfg/detection/mtcnn.json) with
      parallel_detect_and_align and sequential_detect_and_align, then
      recognize_celeb (InceptionResnetV1 + MLP 1001); RetinaFace
      (cfg/detection/retina_face.json) with parallel_detect_and_align,
      then recognize_celeb (iresnet100 + MLP 1020) and recognize_emotion
      (690 tags, top 6); f32, full depth. Launches held to exact per-call
      counts (K1-K8 each launched), median host ms a call and stage
      means, one profiled call per detector, K1's windows form at the
      call's padded windows (torch.equal to the plain version, timed
      against F.grid_sample), and the card against the CPU in f32 on 2
      frames: equal face counts and names, boxes within 1e-2 px, aligned
      faces within 1 level, embedding cosine >= 0.999, equal emotion
      top-1 and probabilities within 5e-3;
  22. the CLIs under ``cli/`` through their entry points, inputs made in
      memory (PNG only, nothing drawn): a ``cli-io`` line (g++, the IO
      runtime's headers, cv2 on this machine); find_embedding.main on the
      20 face PNGs (-bz 8 -w none: one .npz per file, cosine >= 0.999 to
      a lone Encoder call); demo_image.recognize_image on a 640x640 frame
      with MTCNN (seq_fd_vs_aln, par_fd_vs_aln) and RetinaFace + emotion
      at 112 px (K7) and 160 px faces; demo_video.process_video over
      chunk_frames of build_frames frames: (a) --fused_engine, MTCNN +
      InceptionResnetV1 + MLP 1001 + emotion, bf16, 2 chunks of 64, and
      (b) the flags of scripts/celeb_stat_dynamic_itv.sh (RetinaFace,
      iresnet100, -nc 1021, local thresholds, emotion, -fidx 1 6 11 16;
      --n_frames 16 for 120) on 200 frames at 25 fps, then
      celeb_statistic's dynamic-interval tracker.json of (b). Rows, frame
      indices, 4 names and boxes a row, tags; launches held to exact
      per-run counts and K1-K8 each launched; the card against the CPU in
      f32 on a chunk of 2 frames of (a) and (b) (equal names and tags,
      boxes within 1e-4 normalised); median host ms a chunk, the CLI's
      FPS line and stage means, one profiled chunk of each; cli-k8-f32,
      K8's f32 grid (3xTF32) on the emotion tails' own inputs of (b)'s
      first chunk (taken by a forward hook), held to the plain version
      in f32 at 1e-4 and timed beside its 3xtf32 floor, its f32-peak
      bound and cuDNN.
  23. the trainers through ``cli.train.main`` and ``cli.eval.main``,
      datasets written from a seed: (a) cfg/train_cfg_emb_classify.json
      (MLP 512-2048-1000 on 1,000 classes x 6 .npz embeddings; epochs cut
      to 3, save_period to 3): median ms a step (CUDA events), samples/s,
      epoch wall, the busy share of a profiled epoch, the loss falling, no
      kernel launched; one epoch at dropout 0 on the card against the CPU
      (per-batch losses within rtol 1e-4, weights within 1e-3); cli.eval's
      result.csv, one row per validation sample. (b)
      cfg/train_cfg_aug_emb_classify.json (facenet_aug through K1's
      frames form, a frozen iresnet100 in f32, MLP 512-2048-1001, batch 64,
      16 classes x 40 faces of 112 px; epochs cut to 2): median ms a step,
      images/s, StageTimer means, the busy share, exactly one K1 launch a
      step; K1 at this shape equal to its plain version and timed against
      it and its bound, its tile boxes against footprint_boxes; the
      augmented batch card vs CPU (torch.equal before standardisation), the
      encoder's embeddings card vs CPU (cosine >= 0.999), the encoder's
      weights unchanged and without gradients.
  24. the image-classify trainer and the shared online-aug step:
      train-img, cfg/train_cfg_img_classify.json through cli.train.main
      (InceptionResnetV1 classify, 1,000 classes, seeded; rank1_aug; batch
      64; f32; 64 classes x 10 + 1 seeded 181 px PNGs; epochs cut to 2):
      samples/s over the median epoch wall, median step, StageTimer means
      (augment, forward_backward, optimizer), busy share, peak memory,
      checkpoint size, no kernel launched; train-img-aug, rank1 card vs
      CPU on the same parameters (1e-4 after prewhiten) and the draw's
      shares; train-img-card-vs-cpu, two steps of 8 at dropout 0 with SGD,
      each from the same state (losses rtol 1e-4, parameters and BN
      statistics 1e-3); train-img-eval, cli.eval's result.csv; aug-step,
      training.aug_step at bench.py's train shape (iresnet100 bf16, MLP
      1001, 256 faces of 112 px): median step, images/s, one K1 launch a
      step, K1 at 256x112 against its plain version and bound.
  25. FAN and the dataset tools: fan, FANLandmarker (4 modules, seeded) on
      64 face crops of 96-224 px in f32 (TF32 off and on) and bf16, ms a
      batch, faces/s and TFLOP/s beside the bound, batch 1, the busy
      share, bf16 drift <= one heatmap cell; fan-card-vs-cpu, each
      module's heatmaps on 2 faces within 1e-4 of max|heatmap| and the
      decode of the same heatmaps equal; fan-seq, demo_image
      seq_fd_vs_aln --fan_weights (a seeded .npz) on a 640x640 frame with
      4 faces, MTCNN's and K1's launches exact, card vs CPU; dataset-tools,
      crop_face, split_train_val and align_face (MTCNN, then
      --fan_weights) through main() on data/'s 20 faces, two two-face
      frames, a faceless image and a broken file, images/s and stage
      means, launches exact per detect call and aligned image; and
      dataset-tools-card-vs-cpu, the same with -dv cpu: equal files,
      manifests and crops, aligned faces within 1 level.
  26. the readers of JPEG and video as a user's files reach them: readers,
      which reader use_native=None resolves to on this machine and why,
      an MJPG .avi and JPEGs written by cv2 read back; readers-find-
      embedding, find_embedding.main on the 20 face crops as JPEGs;
      readers-cli, demo_image.recognize_image on a JPEG frame,
      demo_video.process_video --fused_engine (MTCNN f32, 2 chunks of 64)
      through frame_chunks on the .avi, launches held to CLI path (a)'s
      per-run counts and tracker.csv equal to a run on cv2's own frames
      of the file, K5's f32 grid (3xTF32) held to the plain version in f32
      at 1e-4 on all of that run's crops and timed there beside its
      3xtf32 floor and its f32-peak bound, and celeb_statistic.main on
      the file.
  27. the SE-IR encoder: se-ir, resnet101 at full depth on 64 faces of 112
      px in f32 (TF32 off), ms a batch, faces/s and TFLOP/s beside the
      bound, card vs CPU cosine >= 0.999 on 2 faces; arcmargin,
      ArcMarginModel at 1,001 classes on those embeddings, card vs CPU
      within 1e-4 x margin_s, both margin rules; se-ir-train,
      cfg/train_cfg_aug_emb_classify.json through cli.train.main with
      chosen_idx_enc 1 and encoder_img_size 112, one K1 launch a step,
      ms a step, images/s, the busy share.
  28. RetinaFace cfg_re50 (seeded, offset heads shrunk, keep_top_k 4)
      through the recognition library: re50, parallel_detect_and_align and
      recognize_celeb (iresnet100 + MLP 1020) on 4 frames of 640 px, f32,
      K3 and K1 once a call, median host ms a call; re50-net, the net
      alone with TF32 off and on; re50-card-vs-cpu, the seeded net's head
      outputs (offsets not shrunk) on 2 frames within rtol 1e-3 atol 1e-3.
  29. detector training: fit, cli.fit_detector.main at the tool's full
      width (RetinaFace cfg_mnet from seed 0, batch 8 of 640 px synthetic
      scenes, AdamW + cosine from lr 1e-3, f32, TF32 as PyTorch leaves it)
      with the steps cut to 40 and an evaluation every 20: losses finite
      and falling, BatchNorm statistics moved, no launch in a train step,
      K6 3 in conf_sparsity and K6 3 + K3 1 in detection_recall (exact),
      median step (CUDA events) and host synth, images/s, the busy share
      of a profiled step, peak memory; fit-export, the written npz through
      RetinaFace(weights_path=...) equal to the trained net's
      detect_padded; fit-k6, K6 on the trained stage 1 after more steps
      against its plain version (phase 15's gates); fit-card-vs-cpu, one
      SGD step on 2 scenes of 640 px, TF32 off, the card in f32 against
      the CPU in f64 (losses rtol 1e-4, parameters and BN statistics
      1e-3), the CPU's f32 step shown; fit-probe, probe_crop_landmarks
      on the 20 crops, K2-K5 exact per detect call, points within 0.5 px
      of the vendored cache and of the CPU probe.
  30. parallel: ``parallel.launch(n_devices=1, device="cuda")`` starts one
      process in a one-rank NCCL group (the card machine has one H100, and
      NCCL puts no two ranks of a communicator on one card), which runs
      every mesh code path on a (1, 1) mesh: parallel-train, two
      ``make_dp_train_step`` online-aug steps at
      ``__graft_entry__.dryrun_multichip``'s shapes (InceptionResnetV1 f32
      at 96 px, frozen; MLP 512-2048-16 with dropout 0.5; Adam; 8 images)
      against the same steps without a mesh (losses and weights within
      rtol 1e-5); parallel-engine, a chunk of the default line (64 frames
      of 640 px, MTCNN, InceptionResnetV1 and MLP 1001 in bf16, the face_cap
      buckets) through the engine on the data mesh against the same engine
      without one (equal valid slots and predictions, boxes within 1e-4
      px, embedding cosine >= 0.9999, launches K2 1, K3 4, K4 4, K5 2, K1 1
      in the mesh chunk), ms a chunk both ways (median of 3); the NCCL
      version and the time the launch took to reach the function.
  31. the rest of the JAX package's surface: rest, the default line's
      chunk (64x640x640, bf16) through an engine whose MTCNN reads a
      ``weights_dir`` of .pt files and whose emotion head (690 tags,
      ``num_projections`` 128) runs at ``emotion_size`` 64 (the net's
      own stem; K8 on the tails, no K7), launches exact per run, median
      chunk ms; rest-mtcnn, those detections torch.equal to the vendored
      npz's; rest-engine-card-vs-cpu, the engine at emotion_size 64 and
      224 in f32 on 2 frames (the engine gates); rest-proj, x_proj card
      vs CPU; rest-crops, ``ops.image.batched_crop_area_resize`` through
      K4 (3 launches a call, torch.equal to its plain version) at the
      default line's RNet and ONet crop counts, timed beside its bound,
      and the bilinear crops card vs CPU; rest-align,
      ``pipeline.align.align_faces_batch`` card vs CPU, each side beside
      an f64 reference; rest-k8, K8 in bf16 on the tails' own inputs
      from the emotion_size 64 engine (16 and 8 px maps) held to the
      plain version in f32, timed beside its bound.

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

import ast
import contextlib
import copy
import io
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
    "bottleneck_chain": ("conv_gemm_bf16", "conv_gemm_tf32x3"),
    "nms_keep_mask": ("nms_keep_tiled",),
    "crop_area_resize": ("band_totals_kernel", "band_scan_kernel",
                         "crop_pool_kernel"),
    "crop_net_trunk": ("crop_net_trunk_mma", "crop_net_trunk_tf32x3"),
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
# the recognition library (phase 21): REC_FRAMES frames of 640 px with 4
# faces each, REC_CALLS timed calls of each flow; InceptionResnetV1's MLP
# has REC_CLASSES classes, iresnet100's PROD_CLASSES
REC_FRAMES, REC_CALLS, REC_CLASSES = 4, 5, 1001
# launches per call: an MTCNN flow detects (the default line's cascade)
# and aligns once; the RetinaFace flow detects (K6's three segments, one
# NMS), aligns once and runs the emotion net (K7 once, K8 three launches
# for each of the 5 tail blocks)
REC_LAUNCHES = {
    "mtcnn": MTCNN_LINE_LAUNCHES,
    "retinaface": {"mnet_stage1": 3, "nms_keep_mask": 1,
                   "similarity_warp": 1, "emotion_stem": 1,
                   "bottleneck_chain": 15}}
# NVIDIA H100 SXM data-sheet peaks (dense), at the 700 W limit
PEAK_BF16, PEAK_TF32, PEAK_F32, PEAK_BYTES = 989e12, 495e12, 67e12, 3.35e12
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
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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


def profiled(torch, activities, fn, warm=None):
    """torch.profiler over one ``fn()``, after a warm-up step under the
    same session whose events are dropped (``warm()``, by default
    ``fn()``). The tracer starts late: without the warm-up an H100 left the
    first grids of a session unrecorded, up to every grid of a short one
    and more of them late in a long process."""
    from torch.profiler import profile, schedule

    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for step in (warm or fn, fn):
            step()
            torch.cuda.synchronize()
            prof.step()
    return prof


def device_ms(torch, fn, names=(), runs=20):
    """Device time (ms) per call of ``fn()`` spent in the device functions
    whose name contains one of ``names`` (every one when it is empty), from
    torch.profiler: the kernels alone, without the host's launch overhead
    or the wrapper's other work. The named grids must be recorded in whole
    calls and within the CUDA-event span of the calls (K5's grids still
    lost some after the warm-up step, on an H100); a session that misses
    that is taken again, twice, and then the time is the CUDA-event time
    around one call, with a note."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    span = {}

    def calls():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        torch.cuda.synchronize()
        span["ms"] = start.elapsed_time(end)

    for _ in range(3):
        prof = profiled(torch, [ProfilerActivity.CUDA], calls)
        grids = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and (not names or is_grid(e.key, names))]
        total = sum(e.self_device_time_total for e in grids) / 1e3
        counts = sorted({(e.key[:60], e.count) for e in grids})
        if total > 0 and (not names or (
                all(c % runs == 0 for _, c in counts)
                and total <= 1.01 * span["ms"])):
            return total / runs
        print(f"note: torch.profiler recorded {counts or 'no grid'} of "
              f"{names or 'fn'} in {runs} calls ({total:.3f} ms in a "
              f"{span['ms']:.3f} ms span)", flush=True)
    ms = median_ms(torch, fn)
    print(f"note: the device time of {names or 'fn'} is taken by CUDA "
          f"events around the call instead: {ms:.3f} ms", flush=True)
    return ms


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


def bound_3xtf32(nbytes, flops):
    """The card's floor (ms) for f32-accurate work, and which of the two
    bounds it: bytes at the memory rate, and ``flops`` in 3xTF32 (three
    TF32 products for each f32 product) at the TF32 tensor-core peak."""
    return bound(nbytes, 3 * flops, PEAK_TF32)


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


def profile_chunk(torch, run, chunk_ms, card, what, line, results,
                  unit="chunk"):
    """Device busy time of one call of ``run()`` (a chunk, or a call of the
    recognition library) under torch.profiler, and each kernel's device
    time and grids in it (added to its row as ``chunk_device_ms[line]``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    prof = profiled(torch, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    run)
    averages = prof.key_averages()
    # device-side events only (the CPU ops that launched them repeat the
    # same time), without the spans of the library's annotated stages;
    # everything runs on one stream, so their sum is the busy time
    device = [e for e in averages if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
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
    phase(what, f"one {unit}: device busy {busy_ms:.2f} ms = "
          f"{busy_ms / chunk_ms:.1%} of the median {unit} {chunk_ms:.2f} ms "
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


def special_coords(torch, gen, boxes, valid):
    """``boxes`` with about one box in six given a NaN, +inf or -inf
    coordinate (x1, y1, x2 or y2, on either box of a pair), and in every
    set two valid boxes of infinite area (x from -inf to +inf: inf + inf -
    inf in the IoU's denominator) and one valid overflowed decode (x1 =
    -inf, x2 = NaN, as RetinaFace's decode gives when exp overflows)."""
    b = boxes.cpu().numpy().copy()
    n, k = b.shape[:2]
    special = np.float32([np.nan, np.inf, -np.inf])
    s, r = np.nonzero(gen.uniform(size=(n, k)) < 1 / 6)
    b[s, r, gen.integers(0, 4, len(s))] = special[gen.integers(0, 3, len(s))]
    b[:, 0, [0, 2]] = [-np.inf, np.inf]
    b[:, 1, [0, 2]] = [-np.inf, np.inf]
    b[:, 2, [0, 2]] = [-np.inf, np.nan]
    valid = valid.clone()
    valid[:, :3] = True
    return torch.from_numpy(b).to(boxes.device), valid


def nan_pairs(torch, dev):
    """Four sets of two overlapping boxes, scores 0.9 and 0.8, one
    coordinate NaN (x1 of the first box; x2, y1, y2 of the second): the
    IoU is NaN, so both are kept."""
    pairs = [[[np.nan, 0, 10, 10], [1, 1, 10, 10]],
             [[0, 0, 10, 10], [1, 1, np.nan, 10]],
             [[0, 0, 10, 10], [1, np.nan, 10, 10]],
             [[0, 0, 10, 10], [1, 1, 10, np.nan]]]
    return (torch.tensor(pairs, dtype=torch.float32, device=dev),
            torch.tensor([[0.9, 0.8]] * 4, device=dev),
            torch.ones((4, 2), dtype=torch.bool, device=dev))


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
              False),
             ("NaN, +-inf coordinates", 64, 448, 0.5, 0.0, False),
             ("NaN, +-inf coordinates in order", 64, 448, 0.5, 0.0, False),
             ("NaN, +-inf coordinates, RetinaFace", 64, 1024, 0.4, 1.0,
              False),
             ("NaN, +-inf coordinates, ONet", 64, 128, 0.7, 1.0, True),
             ("NaN coordinate pairs", 4, 2, 0.4, 1.0, False),
             ("empty intersection, NaN denominator", 1, 2, -0.5, 0.0,
              False),
             ("empty intersection, NaN denominator, min", 1, 2, -0.5, 0.0,
              True)]
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
        elif what == "NaN coordinate pairs":
            boxes, scores, valid = nan_pairs(torch, dev)
        elif what.startswith("empty intersection"):
            # areas +inf and -inf: the denominator is NaN (min mode: -inf)
            boxes = torch.tensor([[[-np.inf, 0, np.inf, 1],
                                   [np.inf, 5, -np.inf, 6]]], device=dev)
            scores = torch.tensor([[0.9, 0.8]], device=dev)
            valid = torch.ones((1, 2), dtype=torch.bool, device=dev)
        else:
            boxes, scores, valid = nms_sets(torch, gen, n, k, SIZE, dev)
        if what == "all-equal scores":
            scores = torch.full_like(scores, 0.5)
        elif what.startswith("+-0.0"):
            scores = special_scores(torch, gen, scores)
            if what.endswith("in order"):
                boxes, scores, valid = in_priority_order(torch, boxes,
                                                         scores, valid)
        elif what.startswith("NaN, +-inf"):
            boxes, valid = special_coords(torch, gen, boxes, valid)
            if what.endswith("in order"):
                boxes, scores, valid = in_priority_order(torch, boxes,
                                                         scores, valid)
        got, part = check(what, boxes, scores, valid, thr, off, mm)
        if what == "NaN coordinate pairs" and not bool(got.all()):
            fail(f"K3 suppressed a box of a pair whose IoU is NaN: {got}")
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


def grid_sample_warp(torch, F, windows, mats, out_size):
    """K1's windows form as one PyTorch call, the library yardstick: a
    function running F.grid_sample (bilinear, zeros padding,
    align_corners) of the f32 windows [K, N, N, 3], with each face's
    sampling grid built here, outside the timing. It returns NCHW."""
    from vn_celeb_face_recognition_tpu_torch.ops.image import invert_affine

    n, dev = windows.shape[1], windows.device
    inv = invert_affine(mats)
    ar = torch.arange(float(out_size), device=dev)
    ys, xs = torch.meshgrid(ar, ar, indexing="ij")
    sx = inv[:, 0, 0, None, None] * xs + inv[:, 0, 1, None, None] * ys \
        + inv[:, 0, 2, None, None]
    sy = inv[:, 1, 0, None, None] * xs + inv[:, 1, 1, None, None] * ys \
        + inv[:, 1, 2, None, None]
    grid = torch.stack([sx, sy], -1) * (2.0 / (n - 1)) - 1.0
    win_nchw = windows.permute(0, 3, 1, 2)

    def grid_sample():
        return F.grid_sample(win_nchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    return grid_sample


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
    grid_sample = grid_sample_warp(torch, F, windows, mats, 112)
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
    from torch.profiler import ProfilerActivity

    def calls():
        for _ in range(runs):
            fn()

    fn()
    # a session whose grids were not recorded in whole calls lost events
    # (device_ms): taken again, twice
    for _ in range(3):
        prof = profiled(torch, [ProfilerActivity.CUDA], calls)
        out, counts = {}, {}
        for e in prof.key_averages():
            role = (role_of(e.key) if e.device_type == DeviceType.CUDA
                    else None)
            if role is not None:
                out[role] = (out.get(role, 0.0)
                             + e.self_device_time_total / runs / 1e3)
                counts[role] = counts.get(role, 0) + e.count
        if all(c % runs == 0 for c in counts.values()):
            return out
        print(f"note: torch.profiler recorded grids {counts} in {runs} "
              f"calls", flush=True)
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


def read_json(*parts):
    with open(os.path.join(HERE, *parts)) as fp:
        return json.load(fp)


def name_tables():
    """The 1,020-class name table (label -> name) and per-class thresholds
    of meta_data/face_recognition, and the 690 emotion tags."""
    import csv
    import pickle

    meta = os.path.join(HERE, "meta_data")
    with open(os.path.join(meta, "face_recognition",
                           "label2name_1020_cls.txt"), newline="") as fp:
        names = {int(r["label"]): r["name"] for r in csv.DictReader(fp)}
    thresholds = read_json("meta_data", "face_recognition",
                           "local_thresholds.json")
    with open(os.path.join(meta, "emotion_recognition", "etag2idx.pkl"),
              "rb") as fp:
        tags = pickle.load(fp)["idx2key"]
    return names, thresholds, tags


def recognition_models(torch, build_model, pipeline, dev):
    """The library's models, full depth, seeded by the registry: encoder +
    MLP for each detector's flow and the emotion net, wrapped on ``dev``,
    and f32 copies of the same weights wrapped on the CPU."""
    emo = build_model("resnet_2branch_50",
                      **read_json("cfg", "emotion", "resnet50_2_branch.json"))
    with torch.no_grad():  # logits of order 1, so the softmax is not flat 0/1
        emo.fc.weight.mul_(0.02)
    modules = (build_model("InceptionResnetV1"),
               build_model("MLPModel", input_dim=512, num_classes=REC_CLASSES),
               build_model("iresnet100"),
               build_model("MLPModel", input_dim=512,
                           num_classes=PROD_CLASSES), emo)
    wrappers = (pipeline.Encoder, pipeline.Classifier, pipeline.Encoder,
                pipeline.Classifier, pipeline.EmotionModel)
    cpu = [w(copy.deepcopy(m), device="cpu")
           for w, m in zip(wrappers, modules)]
    card = [w(m, device=dev) for w, m in zip(wrappers, modules)]
    return card, cpu


def recognition_flows(pipeline, dets, models, tables):
    """The library's three calls the phase drives, as a user's image loop
    makes them: {name: (flow, encoder)}, ``flow(images, timer=None)`` ->
    dict of per-image faces, boxes, names (and emotion tags and
    probabilities)."""
    mtcnn, retina = dets
    enc, clf, penc, pclf, emo = models
    names, thresholds, tags = tables
    tpl, fs = pipeline.center_point_dict["(112, 112)"], (112, 112)
    celebs = {label: f"celeb_{label}" for label in range(REC_CLASSES)}
    map_tags = np.vectorize(lambda i: tags[i])
    box_req = {"min_dim": 50, "box_ratio": 2.0}  # the CLIs' defaults

    def mtcnn_flow(detect_and_align):
        def flow(imgs, timer=None):
            faces, boxes = detect_and_align(imgs, timer)
            return dict(faces=faces, boxes=boxes, names=pipeline.
                        recognize_celeb(faces, None, enc, clf, None, celebs,
                                        0.0, timer=timer))
        return flow

    def retina_flow(imgs, timer=None):
        faces, boxes = pipeline.parallel_detect_and_align(
            imgs, retina, tpl, fs, timer=timer)
        out = dict(faces=faces, boxes=boxes, names=pipeline.recognize_celeb(
            faces, None, penc, pclf, None, names, thresholds, timer=timer))
        out["emotions"], out["probs"] = pipeline.recognize_emotion(
            faces, None, emo, None, map_tags, EMOTION_TOPK, timer=timer)
        return out

    return {
        "mtcnn-parallel": (mtcnn_flow(
            lambda imgs, t: pipeline.parallel_detect_and_align(
                imgs, mtcnn, tpl, fs, timer=t)), enc),
        "mtcnn-sequential": (mtcnn_flow(
            lambda imgs, t: pipeline.sequential_detect_and_align(
                imgs, mtcnn, tpl, fs, box_req, timer=t)), enc),
        "retinaface-parallel": (retina_flow, penc)}


def pair_boxes(got, want):
    """Each of ``got``'s boxes paired with the nearest of ``want``'s: the
    permutation and the largest pair difference (None when they do not
    pair up)."""
    if len(got) != len(want):
        return None, None
    if not len(got):
        return [], 0.0
    d = np.abs(np.asarray(got, np.float64)[:, None]
               - np.asarray(want, np.float64)[None]).max(-1)
    perm = d.argmin(1)
    if sorted(perm.tolist()) != list(range(len(want))):
        return None, None
    return perm, float(d[np.arange(len(got)), perm].max())


def compare_flows(pipeline, what, gpu, cpu, gpu_enc, cpu_enc):
    """One flow's outputs on the card against the CPU's, f32, 2 frames:
    equal face counts per frame; each card box paired with the nearest CPU
    box (detect orders faces by area, and near-equal areas may swap), the
    pairs within 1e-2 px; aligned uint8 faces within 1 level; embedding
    cosine >= 0.999; equal names; equal emotion top-1 and probabilities
    within 5e-3. Returns a summary."""
    box_err, level, cos_min, prob_err, faces = 0.0, 0, 1.0, 0.0, 0
    for i, (gb, cb) in enumerate(zip(gpu["boxes"], cpu["boxes"])):
        if len(gb) != len(cb) or len(gb) == 0:
            fail(f"{what}: frame {i}: {len(gb)} faces on the card, "
                 f"{len(cb)} on the CPU")
        perm, err = pair_boxes(gb, cb)
        if perm is None:
            fail(f"{what}: frame {i}: the card's boxes do not pair up with "
                 "the CPU's")
        box_err = max(box_err, err)
        gf = np.stack(gpu["faces"][i])
        cf = np.stack(cpu["faces"][i])[perm]
        level = max(level, int(np.abs(gf.astype(np.int16)
                                      - cf.astype(np.int16)).max()))
        ge = pipeline.find_embedding(gf.astype(np.float32), gpu_enc)
        ce = pipeline.find_embedding(cf.astype(np.float32), cpu_enc)
        cos = (ge * ce).sum(-1) / (np.linalg.norm(ge, axis=-1)
                                   * np.linalg.norm(ce, axis=-1))
        cos_min = min(cos_min, float(cos.min()))
        if list(gpu["names"][i]) != [cpu["names"][i][j] for j in perm]:
            fail(f"{what}: frame {i}: names {gpu['names'][i]} on the card, "
                 f"{cpu['names'][i]} on the CPU")
        if "emotions" in gpu:
            if not np.array_equal(gpu["emotions"][i][:, 0],
                                  cpu["emotions"][i][perm, 0]):
                fail(f"{what}: frame {i}: emotion top-1 differs")
            prob_err = max(prob_err, float(np.abs(
                gpu["probs"][i] - cpu["probs"][i][perm]).max()))
        faces += len(gb)
    summary = (f"{what}: {faces} faces, counts equal; max box diff "
               f"{box_err:.2e} (atol 1e-2); max face diff {level} levels "
               f"(<= 1); min embedding cosine {cos_min:.6f} (>= 0.999); "
               f"names equal")
    if "emotions" in gpu:
        summary += (f"; emotion top-1 equal, max prob diff {prob_err:.2e} "
                    "(atol 5e-3)")
    if box_err > 1e-2 or level > 1 or cos_min < 0.999 or prob_err > 5e-3:
        fail(f"{what} card vs CPU outside tolerance: {summary}")
    return summary


def phase_recognition(torch, F, kernels, K1, dev, card, results):
    """21. The recognition library through its entry points, at full width:
    MTCNN (cfg/detection/mtcnn.json) with parallel_detect_and_align and
    sequential_detect_and_align, then recognize_celeb (InceptionResnetV1 +
    MLP 1001); RetinaFace (cfg/detection/retina_face.json, the fitted mnet
    weights) with parallel_detect_and_align, then recognize_celeb
    (iresnet100 + MLP 1020, the per-class thresholds) and
    recognize_emotion (ResNet-50, 690 tags, top 6); f32, as the configs
    give them. Each flow's launches are held to exact per-call counts, K1
    through K8 must each launch; each flow's median host ms over
    REC_CALLS calls and its stage means; one profiled call per detector;
    K1's windows form at this path's windows held to its plain version
    with torch.equal and timed against F.grid_sample; the card against
    the CPU in f32 on 2 frames."""
    from vn_celeb_face_recognition_tpu_torch import pipeline
    from vn_celeb_face_recognition_tpu_torch.models import (
        build_detector,
        build_model,
    )
    from vn_celeb_face_recognition_tpu_torch.ops.similarity import (
        umeyama_similarity,
    )
    from vn_celeb_face_recognition_tpu_torch.pipeline.align import (
        pad_windows,
    )
    from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames
    from vn_celeb_face_recognition_tpu_torch.utils.tracing import StageTimer

    imgs = list(build_frames(REC_FRAMES, SIZE, FACES_PER_FRAME))
    mtcnn_cfg = read_json("cfg", "detection", "mtcnn.json")
    retina_cfg = read_json("cfg", "detection", "retina_face.json")
    retina_cfg["weights_path"] = os.path.join(HERE,
                                              retina_cfg["weights_path"])
    dets = (build_detector("MTCNN", device=dev, **mtcnn_cfg),
            build_detector("RetinaFace", device=dev, **retina_cfg))
    tables = name_tables()
    models, models_cpu = recognition_models(torch, build_model, pipeline,
                                            dev)
    flows = recognition_flows(pipeline, dets, models, tables)

    lines, medians, counted = [], {}, {}
    for what, (flow, _) in flows.items():
        flow(imgs)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        timer = StageTimer()
        kernels.reset_launch_counts()
        times = []
        for _ in range(REC_CALLS):
            t0 = time.perf_counter()
            out = flow(imgs, timer)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = kernels.launch_counts()
        check_line_counts(counts, REC_LAUNCHES[what.split("-")[0]],
                          REC_CALLS, f"recognition {what}", results)
        for k, n in counts.items():
            counted[k] = counted.get(k, 0) + n
            if n:
                rec = results[k].setdefault("recognition_launches", {})
                rec[what] = n
        per_frame = [len(f) for f in out["faces"]]
        if min(per_frame) < FACES_PER_FRAME:
            fail(f"recognition {what}: faces per frame {per_frame}")
        medians[what] = sorted(times)[len(times) // 2] * 1e3
        stages = ", ".join(f"{name} {st['mean_ms']:.2f}"
                           for name, st in timer.report().items())
        lines.append(f"{what}: median {medians[what]:.2f} ms a call of "
                     f"{REC_FRAMES} frames (host clock, {REC_CALLS} calls; "
                     f"stage means ms: {stages}); faces per frame "
                     f"{per_frame}; names of frame 0 {out['names'][0]}; "
                     f"launches {({k: n for k, n in counts.items() if n})}")
    missing = [k for k in KERNEL_SOURCES if not counted.get(k)]
    if missing:
        fail(f"recognition: kernels never launched: {missing}")
    phase("recognition", f"{SIZE}x{SIZE} frames, f32, through the "
          f"library's entry points; each flow's launches held to exact "
          f"per-call counts; {card}: " + "; ".join(lines))

    # one profiled call per detector
    for what in ("mtcnn-parallel", "retinaface-parallel"):
        flow = flows[what][0]
        profile_chunk(torch, lambda: flow(imgs), medians[what], card,
                      f"recognition-profile {what}", f"recognition {what}",
                      results, unit="call")

    # K1's windows form at this path's windows: RetinaFace's faces of the
    # call, padded as align_crops pads them
    boxes, _, lms = dets[1].inference(imgs)
    crops, pts = [], []
    for img, bx, lm in zip(imgs, boxes, lms):
        faces, idx = pipeline.get_face_from_boxes(img, bx)
        crops += faces
        pts += [pipeline.move_landmark_to_box(bx[j], lm[j]) for j in idx]
    windows = torch.from_numpy(pad_windows(crops)).to(dev).to(torch.float32)
    mats = umeyama_similarity(
        torch.from_numpy(np.asarray(pts, np.float32)).to(dev),
        torch.from_numpy(pipeline.center_point_dict["(112, 112)"]).to(dev))
    k, n = windows.shape[:2]
    got = through_kernel(kernels, "similarity_warp",
                         lambda: K1.similarity_warp(windows, mats, 112))
    want = K1.similarity_warp_plain(windows, mats, 112)
    if not torch.equal(got, want):
        fail(f"K1 windows form at the recognition path's {k}x{n} windows: "
             f"max abs diff {float((got - want).abs().max()):.3e} from the "
             "plain version")
    ms, call_ms, plain_ms = timed(
        torch, "similarity_warp",
        lambda: K1.similarity_warp(windows, mats, 112),
        lambda: K1.similarity_warp_plain(windows, mats, 112))
    grid_sample = grid_sample_warp(torch, F, windows, mats, 112)
    lib_err = float((grid_sample().permute(0, 2, 3, 1) - want).abs().max())
    library_ms = device_ms(torch, grid_sample) if lib_err <= 1e-2 else None
    win_px = warp_footprint_pixels(torch, mats, n, 112)
    bound_ms, bound_by = bound(win_px * 3 * 4 + got.numel() * 4
                               + mats.numel() * 4, got.numel() * 12, PEAK_F32)
    results["similarity_warp"]["recognition_windows"] = dict(
        faces=k, window=n, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    lib = f"{library_ms:.4f} ms" if library_ms else "not timed"
    phase("recognition-K1", f"similarity_warp windows form at the "
          f"RetinaFace flow's {k} faces, {n}x{n} f32 windows -> 112: equal "
          f"to the plain version (torch.equal); kernel {ms:.4f} ms, call "
          f"{call_ms:.4f} ms, plain {plain_ms:.3f} ms, F.grid_sample on the "
          f"same windows {lib} (max abs diff {lib_err:.3e}), bound "
          f"{bound_ms:.4f} ms ({bound_by}; {win_px} window pixels read) "
          f"({TIMING}; {card})")

    # the card against the CPU, f32, 2 frames
    dets_cpu = (build_detector("MTCNN", device="cpu", **mtcnn_cfg),
                build_detector("RetinaFace", device="cpu", **retina_cfg))
    flows_cpu = recognition_flows(pipeline, dets_cpu, models_cpu, tables)
    two = imgs[:2]
    parts = [compare_flows(pipeline, what, flows[what][0](two),
                           flows_cpu[what][0](two), flows[what][1],
                           flows_cpu[what][1]) for what in flows]
    phase("recognition-card-vs-cpu", f"2x{SIZE}x{SIZE} f32: "
          + "; ".join(parts))


def cli_io_probe():
    """Whether this machine has g++, the IO runtime's headers and cv2, and
    cv2's video backends (reported; nothing below depends on them: phase
    22 decodes only PNG, in Python, and draws nothing; phase 26 reads
    JPEG and video by the reader this machine resolves to)."""
    import shutil

    gxx = shutil.which("g++")
    parts = [f"g++ {'yes' if gxx else 'no'}"]
    for header in ("jpeglib.h", "libavcodec/avcodec.h",
                   "libavformat/avformat.h", "libswscale/swscale.h"):
        found = gxx is not None and subprocess.run(
            [gxx, "-x", "c++", "-E", "-o", os.devnull, "-"],
            input=f"#include <{header}>\n", capture_output=True, text=True,
            timeout=60).returncode == 0
        parts.append(f"{header} {'yes' if found else 'no'}")
    cv2 = subprocess.run([sys.executable, "-c", "import cv2"],
                         capture_output=True, timeout=120).returncode == 0
    parts.append(f"import cv2 {'yes' if cv2 else 'no'}")
    parts.append(cv2_video_probe())
    phase("cli-io", "; ".join(parts))


def cli_find_embedding(torch, dev, work, jpeg=False):
    """find_embedding.main on the repo's 20 face crops (the PNGs, or with
    ``jpeg`` the same crops written as JPEGs by cv2), -bz 8 -w none: one
    .npz per file, named after it, each at cosine >= 0.999 to a lone
    Encoder call on that file's read_image, resized as the CLI resizes
    it."""
    import shutil

    from vn_celeb_face_recognition_tpu_torch.cli import find_embedding as FE
    from vn_celeb_face_recognition_tpu_torch.utils.frames import (
        face_files,
        read_image,
        read_png,
        resize_bilinear,
    )

    src = os.path.join(work, "faces_jpg" if jpeg else "faces")
    out = src + "_emb"
    os.makedirs(src)
    for f in face_files():
        if jpeg:
            import cv2

            stem = os.path.basename(f).split(".")[0]
            cv2.imwrite(os.path.join(src, stem + ".jpg"),
                        np.ascontiguousarray(read_png(f)[..., ::-1]))
        else:
            shutil.copy(f, src)
    names = sorted(os.listdir(src))
    files = [os.path.join(src, n) for n in names]
    t0 = time.perf_counter()
    n = FE.main(["-d", src, "-o", out, "-bz", "8", "-w", "none"])
    secs = time.perf_counter() - t0
    if n != len(files) or sorted(os.listdir(out)) != sorted(
            f.split(".")[0] + ".npz" for f in names):
        fail(f"cli find_embedding wrote {sorted(os.listdir(out))} for "
             f"{len(files)} files")
    enc = FE.build_encoder("InceptionResnetV1", "none", dev)
    first = read_image(files[0])
    cos_min, resized = 1.0, 0
    for f, name in zip(files, names):
        img = read_image(f)
        if img.shape != first.shape:
            img = resize_bilinear(img, (first.shape[1], first.shape[0]))
            resized += 1
        want = enc(img[None].astype(np.float32))[0]
        with np.load(os.path.join(out, name.split(".")[0] + ".npz")) as z:
            got = z["arr_0"]
        cos_min = min(cos_min, float(got @ want / (np.linalg.norm(got)
                                                   * np.linalg.norm(want))))
    kind = "JPEG" if jpeg else "PNG"
    phase("readers-find-embedding" if jpeg else "cli-find-embedding",
          f"find_embedding.main -bz 8 -w none on the card: {n} .npz files, "
          f"each named after its {kind} ({resized} resized to "
          f"{first.shape[1]}x{first.shape[0]}); min cosine {cos_min:.6f} "
          f"to a lone Encoder call on each file's read_image (>= 0.999); "
          f"{secs * 1e3:.1f} ms (host clock, encoder build included)")
    if cos_min < 0.999:
        fail("cli find_embedding: an embedding differs from its file's")


def cli_rows(path):
    import csv

    with open(path, newline="") as fp:
        return list(csv.DictReader(fp))


def cli_check_rows(rows, counts, fps, what):
    """A tracker.csv's rows: one per sampled frame, Frame_idx the frame
    count and Time count / fps as the JAX CLI writes them, 4 names and 4
    boxes in [0, 1] a row, 4 lists of EMOTION_TOPK tags."""
    if [r["Frame_idx"] for r in rows] != [str(c) for c in counts]:
        fail(f"{what}: Frame_idx {[r['Frame_idx'] for r in rows]}, want "
             f"{counts}")
    if [r["Time"] for r in rows] != [str(c / fps) for c in counts]:
        fail(f"{what}: Time column differs from count / fps")
    for r in rows:
        names, boxes = (ast.literal_eval(r["Names"]),
                        ast.literal_eval(r["Bboxes"]))
        tags = ast.literal_eval(r["Emotion"])
        if not (len(names) == len(boxes) == len(tags) == FACES_PER_FRAME):
            fail(f"{what}: frame {r['Frame_idx']}: {len(names)} names, "
                 f"{len(boxes)} boxes, {len(tags)} tag lists")
        if not all(0.0 <= v <= 1.0 for b in boxes for v in b):
            fail(f"{what}: frame {r['Frame_idx']}: a box outside [0, 1]")
        if any(len(t) != EMOTION_TOPK for t in tags):
            fail(f"{what}: frame {r['Frame_idx']}: tag lists {tags}")


def cli_timed_chunks(torch, chunks, times):
    """``chunks`` with the host time from handing out each chunk to the
    request for the next one (the CLI's work on it) appended to ``times``."""
    for chunk in chunks:
        t0 = time.perf_counter()
        yield chunk
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)


def cli_drive(torch, kernels, DV, args, models, threshold, frames, fps,
              fidx):
    """process_video over ``frames`` (chunk_frames at ``fps``, ``-fidx``)
    after one untimed run; returns (rows, chunk host seconds, launch
    counts, the CLI's own printout)."""
    def chunks(times=None):
        it = iter(frames)
        c = DV.chunk_frames(lambda: next(it, None), fps, args.n_frames, fidx)
        return c if times is None else cli_timed_chunks(torch, c, times)

    fs = (args.target_face_size, args.target_face_size)
    tpl = DV.center_point_dict[str(fs)]
    with contextlib.redirect_stdout(io.StringIO()):
        DV.process_video(args, models, fs, tpl, threshold, fidx,
                         track_bbox=True, chunks=chunks())
    torch.cuda.synchronize()
    times, log = [], io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(log):
        DV.process_video(args, models, fs, tpl, threshold, fidx,
                         track_bbox=True, chunks=chunks(times))
    counts = kernels.launch_counts()
    return cli_rows(args.output_tracker), times, counts, log.getvalue()


def cli_card_vs_cpu(DV, args, models, models_cpu, threshold, frames, infos,
                    work, what):
    """One chunk of 2 frames through process_video on the card and on the
    CPU, f32: equal names and emotion tags, boxes within 1e-4
    (normalised)."""
    fs = (args.target_face_size, args.target_face_size)
    tpl = DV.center_point_dict[str(fs)]
    rows = []
    for where, m in (("card", models), ("cpu", models_cpu)):
        a = copy.copy(args)
        a.output_tracker = os.path.join(work, f"{what}-{where}.csv")
        a.compute_dtype = "float32"
        with contextlib.redirect_stdout(io.StringIO()):
            DV.process_video(a, m, fs, tpl, threshold, None, track_bbox=True,
                             chunks=[(list(frames), infos)])
        rows.append(cli_rows(a.output_tracker))
    box_err, faces = 0.0, 0
    for g, c in zip(*rows):
        if g["Names"] != c["Names"] or g["Emotion"] != c["Emotion"]:
            fail(f"cli card vs CPU {what}: frame {g['Frame_idx']}: names "
                 f"{g['Names']} / {c['Names']}, or emotion tags differ")
        gb, cb = ast.literal_eval(g["Bboxes"]), ast.literal_eval(c["Bboxes"])
        if len(gb) != len(cb) or not gb:
            fail(f"cli card vs CPU {what}: {len(gb)} boxes on the card, "
                 f"{len(cb)} on the CPU")
        box_err = max(box_err, float(np.abs(np.asarray(gb)
                                            - np.asarray(cb)).max()))
        faces += len(gb)
    if len(rows[0]) != len(rows[1]) or box_err > 1e-4:
        fail(f"cli card vs CPU {what}: max normalised box diff {box_err:.2e}"
             " (atol 1e-4)")
    return (f"{what}: {faces} faces, names and emotion tags equal, max "
            f"normalised box diff {box_err:.2e} (atol 1e-4)")


def phase_cli(torch, kernels, dev, card, results):
    """22. The CLIs' entry points under the port (cli/), at full width on
    the card, with inputs made in memory: find_embedding.main on the
    repo's face PNGs; demo_image.recognize_image with MTCNN (both
    methods) and RetinaFace + emotion at 112 px (K7) and 160 px faces;
    demo_video.process_video over chunk_frames of build_frames frames, (a)
    --fused_engine (MTCNN, InceptionResnetV1, MLP 1001, emotion,
    --compute_dtype bfloat16, --n_frames 64, 2 chunks) and (b) the flags
    of scripts/celeb_stat_dynamic_itv.sh (RetinaFace, iresnet100, -nc
    1021, the 1,020-class table, local thresholds, par_fd_vs_aln,
    --recog_emotion, --track_bbox, -fidx 1 6 11 16; --n_frames 16 in
    place of 120, on 200 frames at 25 fps), then celeb_statistic's
    dynamic-interval tracker.json of (b). Rows, frame indices, names,
    boxes and tags checked; launches held to exact per-run counts, K1-K8
    each launched; the card against the CPU in f32 on a chunk of 2
    frames of (a) and (b); median host ms a chunk, the CLI's FPS line and
    stage means, and one profiled chunk of each."""
    import shutil
    import tempfile

    os.chdir(HERE)  # the CLIs' flags name files from the repo root
    cli_io_probe()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="cli_smoke_", dir=os.path.join(HERE,
                                                                  "build"))
    try:
        cli_paths(torch, kernels, dev, card, results, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def cli_paths(torch, kernels, dev, card, results, work):
    """Phase 22's drives and checks (``phase_cli``), writing under
    ``work``."""
    from vn_celeb_face_recognition_tpu_torch.cli import celeb_statistic as CS
    from vn_celeb_face_recognition_tpu_torch.cli import demo_image as DI
    from vn_celeb_face_recognition_tpu_torch.cli import demo_video as DV
    from vn_celeb_face_recognition_tpu_torch.models import build_detector
    from vn_celeb_face_recognition_tpu_torch.pipeline import recognition as R
    from vn_celeb_face_recognition_tpu_torch.utils.frames import (
        build_frames,
        face_files,
        read_png,
        resize_bicubic,
    )
    from vn_celeb_face_recognition_tpu_torch.utils.misc import (
        convert_sec_to_max_time_quantity,
    )

    cli_find_embedding(torch, dev, work)

    meta = "meta_data/face_recognition"
    mtcnn_flags = ["-m", "", "-l2n", f"{meta}/label2name.txt", "-nc",
                   str(REC_CLASSES), "--recog_emotion"]
    retina_flags = ["-m", "", "-l2n", f"{meta}/label2name_1020_cls.txt",
                    "-nc", "1021", "-det", "RetinaFace", "-dargs",
                    "cfg/detection/retina_face.json", "-enc", "iresnet100",
                    "-eargs", "cfg/embedding/iresnet100_enc.json",
                    "--inference_method", "par_fd_vs_aln", "--recog_emotion"]
    parser = CS.build_arg_parser()
    sets = {}
    for label, flags in (("mtcnn", mtcnn_flags), ("retinaface",
                                                  retina_flags)):
        with contextlib.redirect_stdout(io.StringIO()):
            # on the card: -dv defaults to it
            models = DI.setup_models(parser.parse_args(flags))
        with torch.no_grad():  # logits of order 1: the top-k tags not tied
            models[4].module.fc.weight.mul_(0.02)
        sets[label] = models

    # demo_image: one face PNG pasted into a 640x640 frame. RetinaFace
    # runs with the default encoder (InceptionResnetV1 takes 160 px faces;
    # iresnet100 only 112 px ones)
    m = sets["mtcnn"]
    sets["retinaface-image"] = (m[0], sets["retinaface"][1], *m[2:])
    img = np.full((SIZE, SIZE, 3), 90, np.uint8)
    img[170:470, 170:470] = resize_bicubic(read_png(face_files()[0]),
                                           (300, 300))
    without_k7 = dict(REC_LAUNCHES["retinaface"], emotion_stem=0)
    parts, counted = [], {}
    for what, label, flags, per_call in (
            ("MTCNN seq_fd_vs_aln", "mtcnn",
             ["--inference_method", "seq_fd_vs_aln"], MTCNN_LINE_LAUNCHES),
            ("MTCNN par_fd_vs_aln", "mtcnn",
             ["--inference_method", "par_fd_vs_aln"], MTCNN_LINE_LAUNCHES),
            ("RetinaFace par_fd_vs_aln + emotion at 112 px",
             "retinaface-image", ["--inference_method", "par_fd_vs_aln",
                                  "-tg_fs", "112"],
             REC_LAUNCHES["retinaface"]),
            ("RetinaFace par_fd_vs_aln + emotion at 160 px",
             "retinaface-image", ["--inference_method", "par_fd_vs_aln",
                                  "-tg_fs", "160"], without_k7)):
        models = sets[label]
        args = parser.parse_args(mtcnn_flags + flags)
        args.recog_emotion = "emotion" in what
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        names, boxes, tags, probs = DI.recognize_image(args, models, img)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = kernels.launch_counts()
        check_line_counts(launches, per_call, 1, f"cli demo_image {what}",
                          results)
        for k, n in launches.items():
            counted[k] = counted.get(k, 0) + n
        if len(names) != len(boxes) or not names:
            fail(f"cli demo_image {what}: {len(names)} names, {len(boxes)} "
                 "boxes")
        if tags is not None and (np.asarray(tags).shape != (
                len(names), EMOTION_TOPK) or not np.isfinite(probs).all()):
            fail(f"cli demo_image {what}: emotion tags {tags}")
        where = np.round(np.asarray(boxes, np.float64), 1).tolist()
        parts.append(f"{what}: {names} at {where}"
                     + ("" if tags is None else f", top tag {tags[0][0]}")
                     + f", {ms:.1f} ms")
    phase("cli-image", "demo_image.recognize_image on the card, one 640x640"
          " frame, launches held to exact per-call counts (K7 only at 112 "
          "px): " + "; ".join(parts))

    # demo_video / celeb_statistic: (a) the fused engine, (b) production
    frames_a = build_frames(2 * BATCH, SIZE, FACES_PER_FRAME)
    frames_b = build_frames(200, SIZE, FACES_PER_FRAME)
    fps, fidx_b = 25.0, [1, 6, 11, 16]
    args_a = parser.parse_args(mtcnn_flags + [
        "--fused_engine", "--compute_dtype", "bfloat16", "--n_frames",
        str(BATCH), "--face_cap", "256,320", "-ot",
        os.path.join(work, "a.csv"), "-of", os.path.join(work, "a_frames")])
    args_b = parser.parse_args(retina_flags + [
        "--track_bbox", "--local_thresholds", f"{meta}/local_thresholds.json",
        "--statistic_mode", "dynamic_itv", "--n_frames", "16", "-fidx",
        *map(str, fidx_b), "-ot", os.path.join(work, "b.csv"), "-of",
        os.path.join(work, "b_frames"), "-jst", os.path.join(work, "b.json"),
        "-nvi", "2", "-tap", "1"])
    thresholds = read_json(args_b.local_thresholds)  # from the repo root
    counts_b = [c for c in range(1, 201) if any(c % fps == i for i in fidx_b)]
    emotion_run = {"emotion_stem": 1,
                   "bottleneck_chain": REC_LAUNCHES["retinaface"][
                       "bottleneck_chain"]}
    paths = (("a", "fused engine, MTCNN + InceptionResnetV1 + emotion, "
              "bf16", args_a, sets["mtcnn"], 0.0, frames_a, None,
              list(range(1, 2 * BATCH + 1)),
              dict(MTCNN_LINE_LAUNCHES, **emotion_run)),
             ("b", "celeb_stat_dynamic_itv.sh flags, RetinaFace + "
              "iresnet100 + emotion, f32", args_b, sets["retinaface"],
              thresholds, frames_b, fidx_b, counts_b,
              REC_LAUNCHES["retinaface"]))
    lines, medians = [], {}
    # (b)'s emotion tails' inputs of its first chunk, for cli-k8-f32
    emo_b, taken = sets["retinaface"][4].module, {}
    hooks = [layer[0].register_forward_hook(
        lambda mod, args, y, n=n: taken.setdefault(n, y.detach()))
        for n, layer in (("l1", emo_b.layer1), ("l2", emo_b.layer2))]
    for key, what, args, models, thr, frames, fidx, counts, per_run in paths:
        rows, times, launches, log = cli_drive(
            torch, kernels, DV, args, models, thr, frames, fps, fidx)
        if key == "b":
            for h in hooks:
                h.remove()
        cli_check_rows(rows, counts, fps, f"cli ({key})")
        runs = launches["pnet_chain"] if key == "a" else len(times)
        if runs < len(times):
            fail(f"cli ({key}): {runs} engine runs for {len(times)} chunks")
        check_line_counts(launches, per_run, runs, f"cli ({key})", results)
        for k, n in launches.items():
            counted[k] = counted.get(k, 0) + n
        medians[key] = sorted(times)[len(times) // 2] * 1e3
        fps_line = [ln for ln in log.splitlines() if ln.startswith("FPS")]
        stages = "; ".join(" ".join(ln.split()) for ln in log.splitlines()
                           if ln.strip().startswith("stage"))
        lines.append(f"({key}) {what}: {len(rows)} rows of {len(frames)} "
                     f"frames in {len(times)} chunks ({runs} runs), median "
                     f"{medians[key]:.2f} ms a chunk (host clock, chunk ms "
                     f"{[round(t * 1e3, 2) for t in times]}); "
                     f"{fps_line[0] if fps_line else 'no FPS line'}; "
                     f"{stages}; launches "
                     f"{({k: n for k, n in launches.items() if n})}")
    missing = [k for k in KERNEL_SOURCES if not counted.get(k)]
    if missing:
        fail(f"cli: kernels never launched through the CLIs: {missing}")
    phase("cli-video", f"demo_video.process_video over chunk_frames of "
          f"{SIZE}x{SIZE} frames with {FACES_PER_FRAME} faces each, on the "
          f"card ({card}); K1-K8 each launched through the CLIs: "
          + " | ".join(lines))
    k8_f32_at(torch, kernels, emo_b, taken, card, results)
    del taken

    # celeb_statistic's dynamic-interval tracker.json of (b): as the CLI
    # writes it (-ign Unknown), and with nothing ignored, every interval's
    # names with their sighting counts, from the rows
    table = CS.TrackerTable.read(args_b.output_tracker)
    n_itv, per = args_b.n_video_intervals, len(table) // 2
    found = []
    for ignored in (args_b.ignored_name, ""):
        with contextlib.redirect_stdout(io.StringIO()):
            stats = CS.export_json_stat_dynamic_itv(
                table, args_b.json_tracker, n_itv, args_b.n_time_appear,
                ignored)
        with open(args_b.json_tracker) as fp:
            if json.load(fp) != json.loads(json.dumps(stats)):
                fail("cli tracker.json: the file differs from the export")
        for i in range(n_itv):
            part = table.rows(i * per, len(table) if i == n_itv - 1
                              else (i + 1) * per)
            want = {}
            for names in part["Names"]:
                for n in ast.literal_eval(names):
                    if n != ignored:
                        want[n] = want.get(n, 0) + 1
            entry = stats[str(i + 1)]
            got = {n: len(v) for n, v in entry["celebrities"].items()}
            times = part["Time"]
            if got != want or entry["interval"] != (
                    convert_sec_to_max_time_quantity(times[0]),
                    convert_sec_to_max_time_quantity(times[-1])):
                fail(f"cli tracker.json (-ign {ignored!r}) interval {i + 1}:"
                     f" {entry['interval']} {got}, want {want}")
            found.append(f"-ign {ignored!r} {entry['interval']}: {got}")
    phase("cli-statistic", f"celeb_statistic dynamic_itv -nvi {n_itv} -tap "
          f"{args_b.n_time_appear} on (b)'s tracker.csv ({len(table)} rows):"
          " every name of an interval listed in it with its sighting count: "
          + "; ".join(found))

    # the card against the CPU, f32, one chunk of 2 frames of (a) and (b)
    mtcnn_cfg = read_json("cfg", "detection", "mtcnn.json")
    retina_cfg = read_json("cfg", "detection", "retina_face.json")

    def on_cpu(models, detector):
        names, _, enc, clf, emo, tags = models
        return (names, detector, R.Encoder(copy.deepcopy(enc.module),
                                           device="cpu"),
                R.Classifier(copy.deepcopy(clf.module), device="cpu"),
                R.EmotionModel(copy.deepcopy(emo.module), device="cpu"),
                tags)

    cmp = [
        cli_card_vs_cpu(DV, args_a, sets["mtcnn"], on_cpu(
            sets["mtcnn"], build_detector("MTCNN", device="cpu",
                                          **mtcnn_cfg)),
            0.0, frames_a[:2], [[c / fps, c] for c in (1, 2)], work, "a"),
        cli_card_vs_cpu(DV, args_b, sets["retinaface"], on_cpu(
            sets["retinaface"], build_detector("RetinaFace", device="cpu",
                                               **retina_cfg)),
            thresholds, frames_b[[c - 1 for c in counts_b[:2]]],
            [[c / fps, c] for c in counts_b[:2]], work, "b")]
    phase("cli-card-vs-cpu", "process_video, one chunk of 2 frames, f32: "
          + "; ".join(cmp))

    # one profiled chunk of each
    for key, _, args, models, thr, frames, fidx, counts, _ in paths:
        a = copy.copy(args)
        a.output_tracker = os.path.join(work, f"{key}-profile.csv")
        chunk = next(DV.chunk_frames(iter(frames).__next__, fps, a.n_frames,
                                     fidx))
        fs = (a.target_face_size, a.target_face_size)

        def run(a=a, models=models, thr=thr, chunk=chunk, fs=fs):
            with contextlib.redirect_stdout(io.StringIO()):
                DV.process_video(a, models, fs,
                                 DV.center_point_dict[str(fs)], thr, None,
                                 track_bbox=True, chunks=[chunk])

        profile_chunk(torch, run, medians[key], card,
                      f"cli-profile ({key})", f"cli ({key})", results)


# phase 23 (training): the embedding classifier of
# cfg/train_cfg_emb_classify.json on TRAIN_CLASSES x (5 + 1) embeddings,
# and the online-aug trainer of cfg/train_cfg_aug_emb_classify.json on
# AUG_CLASSES x AUG_PER_CLASS 112 px faces; epochs cut as stated
TRAIN_CLASSES, TRAIN_PER_CLASS, TRAIN_EPOCHS = 1000, 5, 3
AUG_CLASSES, AUG_PER_CLASS, AUG_VAL, AUG_EPOCHS = 16, 40, 4, 2
# card against CPU: faces through the frozen iresnet100 on the CPU
AUG_CPU_FACES = 8
# phase 24 (the image-classify trainer): cfg/train_cfg_img_classify.json on
# IMG_CLASSES x (IMG_PER_CLASS + 1) PNGs of IMG_SIZE px (the size of the
# repo's data/*.png faces), epochs cut to IMG_EPOCHS; its card-vs-CPU gate
# takes two steps at IMG_GATE_BATCH; then training.aug_step at bench.py's
# train shape (iresnet100 bf16, MLP 1001, 256 faces of 112 px)
IMG_CLASSES, IMG_PER_CLASS, IMG_SIZE, IMG_EPOCHS = 64, 10, 181, 2
IMG_GATE_BATCH, IMG_GATE_STEPS = 8, 2
STEP_BATCH, STEP_CLASSES, STEP_RUNS = 256, 1001, 20


@contextlib.contextmanager
def patched(cls, name, wrap):
    """``cls.name`` replaced by ``wrap(original)`` inside the block."""
    orig = cls.__dict__[name]
    setattr(cls, name, wrap(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


@contextlib.contextmanager
def train_probes(torch, trainer_mod, timer=None, stages=None):
    """Inside the block, every trainer's steps are timed with CUDA events
    and its per-step losses and epoch logs and host wall times recorded
    (the entry points run unchanged). With a ``StageTimer``, the step's
    stages are timed on it too, each waiting for the device at its end:
    ``stages`` names them as (class, method, stage) (default augment,
    encode and mlp_step)."""
    rec = {"steps": [], "losses": [], "epochs": []}

    def step(orig):
        def timed(self, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(self, batch)
            end.record()
            rec["steps"].append((start, end))
            rec["losses"].append(out[0])
            return out
        return timed

    def epoch(orig):
        def timed(self, n):
            t0 = time.perf_counter()
            log = orig(self, n)
            torch.cuda.synchronize()
            rec["epochs"].append((n, time.perf_counter() - t0, dict(log)))
            return log
        return timed

    def stage(name):
        def wrap(orig):
            def timed(self, *args, **kwargs):
                label = name
                if name == "augment" and not kwargs.get("train", True):
                    label = "transform"
                with timer.stage(label):
                    out = orig(self, *args, **kwargs)
                    torch.cuda.synchronize()
                return out
            return timed
        return wrap

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(trainer_mod.BaseTrainer, "_train_step",
                                    step))
        stack.enter_context(patched(trainer_mod.ClassificationTrainer,
                                    "_train_epoch", epoch))
        if timer is not None:
            for cls, method, name in stages or (
                    (trainer_mod.BaseTrainer, "_prepare_input", "augment"),
                    (trainer_mod.AugClassificationTrainer, "_encode",
                     "encode"),
                    (trainer_mod.BaseTrainer, "_update", "mlp_step")):
                stack.enter_context(patched(cls, method, stage(name)))
        yield rec


def step_ms(rec):
    return sorted(s.elapsed_time(e) for s, e in rec["steps"])


def busy_ms(torch, run):
    """Device time of ``run()`` under torch.profiler (the sum over device
    events, the copies on the loader's side stream included) and the five
    largest device functions. ``run()`` trains, so the profiler's warm-up
    step runs small grids of its own instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    def warm():
        x = torch.ones(1 << 20, device="cuda")
        for _ in range(64):
            x = x * 1.0

    prof = profiled(torch, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    run, warm)
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in device) / 1e3
    if total <= 0.0:
        fail("torch.profiler recorded no device time")
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:5]
    return total, ", ".join(
        f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f}" for e in top)


def steps_in_memory(torch, trainer_mod, trainer, timer=None, stages=None):
    """One pass of ``trainer``'s train batches, all moved to the card
    first, so no reader thread runs beside the steps: the sorted CUDA-event
    ms of each ``_train_step`` (each stage timed by ``timer`` if given, as
    ``train_probes`` times them)."""
    batches = [{k: torch.from_numpy(v).to(trainer.device)
                if isinstance(v, np.ndarray) else v for k, v in b.items()}
               for b in trainer.train_loader]
    torch.cuda.synchronize()
    with train_probes(torch, trainer_mod, timer, stages) as rec:
        for batch in batches:
            trainer._train_step(batch)
            torch.cuda.synchronize()
    return step_ms(rec)


def train_rate(n_train, walls):
    """Train samples a second over the median epoch wall (train and
    validation, loader waits included), and that median in s."""
    wall = float(np.median(walls))
    return n_train / wall, wall


def write_config(cfg, work, name):
    path = os.path.join(work, name)
    with open(path, "w") as fp:
        json.dump(cfg, fp)
    return path


def emb_dataset(work):
    """TRAIN_CLASSES x (TRAIN_PER_CLASS + 1) .npz embeddings (the layout
    find_embedding writes) around seeded class centres; the last of each
    class is for validation."""
    emb = os.path.join(work, "train_emb")
    os.makedirs(emb)
    gen = np.random.default_rng(23)
    centres = gen.normal(size=(TRAIN_CLASSES, 512)).astype(np.float32)
    train, val = {}, {}
    for c in range(TRAIN_CLASSES):
        names = []
        for j in range(TRAIN_PER_CLASS + 1):
            v = centres[c] + 0.5 * gen.normal(size=512).astype(np.float32)
            np.savez(os.path.join(emb, f"{c}_{j}.npz"), v)
            names.append(f"{c}_{j}.png")
        train[str(c)], val[str(c)] = names[:-1], names[-1:]
    for name, manifest in (("train.json", train), ("val.json", val)):
        with open(os.path.join(work, name), "w") as fp:
            json.dump(manifest, fp)
    return emb


def face_dataset(work):
    """AUG_CLASSES x AUG_PER_CLASS 112 px PNG faces: the repo's face PNGs
    resized, each class one face under seeded brightness, shift and
    noise; AUG_VAL a class for validation."""
    from vn_celeb_face_recognition_tpu_torch.utils.frames import (
        face_files,
        read_png,
        resize_bilinear,
        write_png,
    )

    img_dir = os.path.join(work, "train")
    os.makedirs(img_dir)
    gen = np.random.default_rng(24)
    bases = [resize_bilinear(read_png(f), (124, 124)).astype(np.float32)
             for f in face_files()[:AUG_CLASSES]]
    train, val = {}, {}
    for c in range(AUG_CLASSES):
        names = []
        for j in range(AUG_PER_CLASS):
            y, x = gen.integers(0, 13, 2)
            img = bases[c][y:y + 112, x:x + 112] * gen.uniform(0.7, 1.3) \
                + gen.normal(0, 6, (112, 112, 3))
            write_png(os.path.join(img_dir, f"{c}_{j}.png"),
                      np.clip(np.round(img), 0, 255).astype(np.uint8))
            names.append(f"{c}_{j}.png")
        train[str(c)] = names[:-AUG_VAL]
        val[str(c)] = names[-AUG_VAL:]
    for name, manifest in (("train.json", train), ("val.json", val)):
        with open(os.path.join(work, name), "w") as fp:
            json.dump(manifest, fp)
    return img_dir


def phase_train(torch, kernels, K1, dev, card, results):
    """23. The port's trainers through their entry points
    (``cli.train.main``, ``cli.eval.main``), datasets written under a
    temp dir from a seed. The rate of each is train samples over the
    median epoch wall (train and validation, loader waits included), with
    the median ms a step (CUDA events) beside it. (a)
    cfg/train_cfg_emb_classify.json as it stands (MLP 512 -> 2048 ->
    1000, Adam 1e-4 wd 1e-4, batch 64, val 32, plateau schedule) on 1,000
    classes x 5 + 1 embeddings; cut: epochs 1000 -> 3, save_period 25 ->
    3 (so the cut run writes its checkpoint). The rate, the step, the
    busy share of one profiled epoch, the loss falling epoch 1 -> 3, no
    kernel launched; gate: one epoch with dropout_prob 0 on the card
    against the CPU, per-batch losses within rtol 1e-4, final weights
    within 1e-3; cli.eval on the checkpoint written, one result.csv row
    per validation sample. (b) cfg/train_cfg_aug_emb_classify.json as it
    stands (facenet_aug, iresnet100 seeded as no local weights exist, MLP
    512 -> 2048 -> 1001, f32, batch 64) on 16 classes x 40 faces of 112
    px; cut: epochs 1000 -> 2. The rate, the step, StageTimer means
    (augment, encode, mlp_step), the busy share, one K1 launch a step
    (held exactly), K1 at this shape against its plain version
    (torch.equal) and bound, its tile boxes against footprint_boxes;
    gates: the augmented batch on the card against the CPU for the same
    drawn parameters (torch.equal before standardisation), the encoder's
    embeddings against the CPU's (cosine >= 0.999), the encoder's weights
    unchanged and without gradients, and the MLP step of one epoch at
    dropout 0 on the card against the CPU on the same embeddings
    (per-batch losses within rtol 1e-4, MLP weights within 1e-3)."""
    import logging
    import shutil
    import tempfile

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="train_smoke_",
                            dir=os.path.join(HERE, "build"))
    # the trainers log to stdout and info.txt: both go to this file
    log = open(os.path.join(work, "trainer.log"), "w")
    try:
        train_emb_classifier(torch, kernels, dev, card, work, log)
        train_online_aug(torch, kernels, K1, dev, card, results, work, log)
    finally:
        root = logging.getLogger()
        for handler in list(root.handlers):
            root.removeHandler(handler)
            handler.close()
        log.close()
        shutil.rmtree(work, ignore_errors=True)


def train_emb_classifier(torch, kernels, dev, card, work, log):
    """Phase 23 (a)."""
    import csv

    from vn_celeb_face_recognition_tpu_torch.cli import eval as cli_eval
    from vn_celeb_face_recognition_tpu_torch.cli import train as cli_train
    from vn_celeb_face_recognition_tpu_torch.training import trainer as TR

    t0 = time.perf_counter()
    emb = emb_dataset(work)
    data_s = time.perf_counter() - t0
    cfg = read_json("cfg", "train_cfg_emb_classify.json")
    for split, manifest in (("train_dataset", "train.json"),
                            ("val_dataset", "val.json")):
        cfg[split]["args"] = {"data_dir": emb,
                              "label_file": os.path.join(work, manifest)}
    cfg["trainer"].update(epochs=TRAIN_EPOCHS, save_period=TRAIN_EPOCHS,
                          save_dir=os.path.join(work, "saved_a"))
    path = write_config(cfg, work, "train_a.json")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with train_probes(torch, TR) as rec, contextlib.redirect_stdout(log):
        trainer = cli_train.main(["-c", path])
    counts = kernels.launch_counts()
    if any(counts.values()):
        fail(f"train (a) launched kernels {counts}; its path has none")
    if trainer.device.type != "cuda":
        fail(f"train (a) ran on {trainer.device}")
    ms = step_ms(rec)
    n_steps = len(trainer.train_loader) * TRAIN_EPOCHS
    if len(ms) != n_steps or [e for e, _, _ in rec["epochs"]] != [1, 2, 3]:
        fail(f"train (a): {len(ms)} steps, epochs {rec['epochs']}")
    losses = [lg["neg_log_llhood"] for _, _, lg in rec["epochs"]]
    if not losses[-1] < losses[0] or not all(np.isfinite(losses)):
        fail(f"train (a): the loss did not fall: {losses}")
    walls = [s for _, s, _ in rec["epochs"]]
    n_train = len(trainer.train_loader.dataset)
    bs = trainer.train_loader.batch_size
    median = ms[len(ms) // 2]
    rate, epoch_s = train_rate(n_train, walls)
    busy, top = busy_ms(torch, lambda: trainer._train_epoch(TRAIN_EPOCHS + 1))
    mem = steps_in_memory(torch, TR, trainer)
    phase("train-emb", f"cfg/train_cfg_emb_classify.json through "
          f"cli.train.main on the card: MLP 512-2048-1000, Adam 1e-4, "
          f"batch {bs}, {TRAIN_CLASSES} classes x {TRAIN_PER_CLASS} train + 1 "
          f"val .npz (written in {data_s:.1f} s); cut: epochs 1000 -> "
          f"{TRAIN_EPOCHS}, save_period 25 -> {TRAIN_EPOCHS}. {rate:.1f} "
          f"train samples/s = {n_train} over the median epoch wall "
          f"{epoch_s:.3f} s (train + val, loader waits included; epochs "
          f"{', '.join(f'{s:.3f}' for s in walls)} s); median step "
          f"{median:.3f} ms (CUDA events, {len(ms)} steps; min {ms[0]:.3f}, "
          f"max {ms[-1]:.3f}); train loss by epoch "
          f"{', '.join(f'{v:.4f}' for v in losses)}, val accuracy "
          f"{rec['epochs'][-1][2]['val_accuracy']:.4f}; one profiled epoch: "
          f"device busy {busy:.2f} ms = {busy / 1e3 / epoch_s:.1%} of the "
          f"median epoch wall (top: {top}); with the batches on the "
          f"card beforehand (no reader thread): median step "
          f"{mem[len(mem) // 2]:.3f} ms; kernels launched: none ({card})")

    # the card against the CPU: one epoch, dropout 0, the same weights
    cfg["model"]["args"]["dropout_prob"] = 0.0
    cfg["trainer"].update(epochs=1, save_period=100,
                          save_dir=os.path.join(work, "saved_gate"))
    runs = {}
    for where in (dev, "cpu"):
        with train_probes(torch, TR) as rec, \
                contextlib.redirect_stdout(log):
            t, _, _ = cli_train.build_trainer_from_config(
                copy.deepcopy(cfg), device=where)
            t.train()
        runs[str(where)] = (rec["losses"], t.model.state_dict())
    (gl, gw), (cl, cw) = runs[str(dev)], runs["cpu"]
    gl, cl = np.asarray(gl), np.asarray(cl)
    loss_rel = float(np.max(np.abs(gl - cl) / np.abs(cl)))
    w_err = max(float((gw[k].cpu() - cw[k]).abs().max()) for k in cw)
    phase("train-emb-card-vs-cpu", f"one epoch, dropout 0, from the same "
          f"seeded weights: {len(gl)} per-batch losses, max rel diff "
          f"{loss_rel:.2e} (rtol 1e-4); final weights max abs diff "
          f"{w_err:.2e} (atol 1e-3)")
    if len(gl) != len(cl) or loss_rel > 1e-4 or w_err > 1e-3:
        fail("train (a) card vs CPU outside tolerance")

    # cli.eval on the checkpoint the cut run wrote
    ckpt = os.path.join(trainer.save_dir,
                        f"checkpoint-epoch{TRAIN_EPOCHS}.ckpt")
    cfg = read_json("cfg", "train_cfg_emb_classify.json")
    cfg["train_dataset"]["args"] = cfg["val_dataset"]["args"] = {
        "data_dir": emb, "label_file": os.path.join(work, "val.json")}
    cfg["trainer"].update(resume_path=ckpt, save_result=True,
                          save_dir=os.path.join(work, "saved_eval"))
    with contextlib.redirect_stdout(log):
        ev = cli_eval.main(["-c", write_config(cfg, work, "eval_a.json")])
    with open(os.path.join(ev.save_dir, "result.csv"), newline="") as fp:
        rows = list(csv.reader(fp))
    hits = sum(r[1] == r[2] for r in rows[1:])
    phase("train-emb-eval", f"cli.eval.main on {os.path.basename(ckpt)}: "
          f"result.csv {len(rows) - 1} rows for {TRAIN_CLASSES} validation "
          f"samples, header {rows[0]}, {hits} predicted right")
    if rows[0] != ["Path", "Target", "Prediction", "Probability"] \
            or len(rows) - 1 != TRAIN_CLASSES:
        fail("train (a) eval: result.csv rows")


def train_online_aug(torch, kernels, K1, dev, card, results, work, log):
    """Phase 23 (b)."""
    from vn_celeb_face_recognition_tpu_torch.cli import train as cli_train
    from vn_celeb_face_recognition_tpu_torch.models import local_weights
    from vn_celeb_face_recognition_tpu_torch.ops import augment as AUG
    from vn_celeb_face_recognition_tpu_torch.ops.image import (
        fixed_image_standardization,
    )
    from vn_celeb_face_recognition_tpu_torch.training import trainer as TR
    from vn_celeb_face_recognition_tpu_torch.utils.tracing import StageTimer

    t0 = time.perf_counter()
    img_dir = face_dataset(work)
    data_s = time.perf_counter() - t0
    cfg = read_json("cfg", "train_cfg_aug_emb_classify.json")
    for split, manifest in (("train_dataset", "train.json"),
                            ("val_dataset", "val.json")):
        cfg[split]["args"] = {"data_dir": img_dir,
                              "label_file": os.path.join(work, manifest)}
    cfg["trainer"].update(epochs=AUG_EPOCHS,
                          save_dir=os.path.join(work, "saved_b"))
    path = write_config(cfg, work, "train_b.json")
    weights = local_weights("iresnet100", True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with train_probes(torch, TR) as rec, contextlib.redirect_stdout(log):
        trainer = cli_train.main(["-c", path])
    counts = kernels.launch_counts()
    steps = len(trainer.train_loader) * AUG_EPOCHS
    check_line_counts(counts, {"similarity_warp": 1}, steps, "train (b)",
                      results)
    results["similarity_warp"]["train_launches"] = steps
    ms = step_ms(rec)
    losses = [lg["neg_log_llhood"] for _, _, lg in rec["epochs"]]
    if len(ms) != steps or not all(np.isfinite(losses)):
        fail(f"train (b): {len(ms)} steps, losses {losses}")
    median = ms[len(ms) // 2]
    bs = trainer.train_loader.batch_size
    n_train = len(trainer.train_loader.dataset)
    walls = [s for _, s, _ in rec["epochs"]]
    enc = trainer.encoder
    snapshot = {k: v.clone() for k, v in enc.state_dict().items()}

    # stage means (each stage waits for the device at its end), one more
    # unprofiled epoch for the rate, and the busy share of a profiled one
    timer = StageTimer()
    with train_probes(torch, TR, timer), contextlib.redirect_stdout(log):
        trainer._train_epoch(AUG_EPOCHS + 1)
    stages = ", ".join(f"{name} {st['mean_ms']:.2f}" for name, st in
                       timer.report().items())
    with train_probes(torch, TR) as rec, contextlib.redirect_stdout(log):
        trainer._train_epoch(AUG_EPOCHS + 2)
    walls += [s for _, s, _ in rec["epochs"]]
    with contextlib.redirect_stdout(log):
        busy, top = busy_ms(torch, lambda: trainer._train_epoch(
            AUG_EPOCHS + 3))
    rate, epoch_s = train_rate(n_train, walls)
    mem = steps_in_memory(torch, TR, trainer)
    mem_timer = StageTimer()
    steps_in_memory(torch, TR, trainer, mem_timer)
    mem_stages = ", ".join(f"{name} {st['mean_ms']:.2f}" for name, st in
                           mem_timer.report().items())
    changed = [k for k, v in enc.state_dict().items()
               if not torch.equal(v, snapshot[k])]
    grads = [n for n, p in enc.named_parameters()
             if p.grad is not None or p.requires_grad]
    if changed or grads or enc.training:
        fail(f"train (b): the frozen encoder changed ({changed[:3]}) or "
             f"takes gradients ({grads[:3]}) or is in train mode")
    phase("train-aug", f"cfg/train_cfg_aug_emb_classify.json through "
          f"cli.train.main on the card: facenet_aug -> iresnet100 (f32, "
          f"{'weights ' + weights if weights else 'seeded: no local weights'}"
          f", frozen) -> MLP 512-2048-1001, batch {bs}, {AUG_CLASSES} classes "
          f"x {AUG_PER_CLASS - AUG_VAL} train + {AUG_VAL} val 112 px PNG "
          f"faces (written in {data_s:.1f} s); cut: epochs 1000 -> "
          f"{AUG_EPOCHS}. {rate:.1f} train images/s = {n_train} over the "
          f"median epoch wall {epoch_s:.3f} s (train + val, loader waits "
          f"included; epochs {', '.join(f'{s:.3f}' for s in walls)} s, the "
          f"last one unprofiled after the run); median step {median:.2f} ms "
          f"(CUDA events, {len(ms)} steps; min {ms[0]:.2f}, max "
          f"{ms[-1]:.2f}); train loss by epoch "
          f"{', '.join(f'{v:.4g}' for v in losses)}; StageTimer means ms "
          f"(each stage synchronised): {stages}; one profiled epoch: device "
          f"busy {busy:.1f} ms = {busy / 1e3 / epoch_s:.1%} of the median "
          f"epoch wall (top: {top}); with the batches on the "
          f"card beforehand (no reader thread): median step "
          f"{mem[len(mem) // 2]:.2f} ms, stage means ms {mem_stages}; "
          f"launches {counts} = one K1 "
          f"a step; encoder weights unchanged, no gradients ({card})")

    # K1 at the training shape, and the card against the CPU
    batch = next(iter(trainer.train_loader))
    frames = torch.from_numpy(batch["data"]).to(dev)
    b, h = frames.shape[:2]
    gen = torch.Generator(device=dev).manual_seed(5)
    mats, offs, flip = AUG.facenet_aug_params(gen, b, h, h, h)
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    idx = torch.arange(b, dtype=torch.int32, device=dev)
    got = through_kernel(kernels, "similarity_warp",
                         lambda: AUG.facenet_aug_warp(frames, mats, offs,
                                                      flip, h))
    want = AUG.facenet_aug_warp(frames.cpu(), mats.cpu(), offs.cpu(),
                                flip.cpu(), h)
    aug_diff = float((got.cpu() - want).abs().max())
    if not torch.equal(got.cpu(), want):
        fail(f"facenet_aug on the card vs the CPU: max diff {aug_diff}")
    warp = through_kernel(kernels, "similarity_warp",
                          lambda: K1.similarity_warp_frames(
                              frames, idx, zeros, zeros, h, mats, h))
    plain = K1.similarity_warp_frames_plain(frames, idx, zeros, zeros, h,
                                            mats, h)
    if not torch.equal(warp, plain):
        fail(f"K1 frames form at the training shape: max diff "
             f"{float((warp - plain).abs().max()):.3e} from the plain "
             "version")
    shares = check_k1_boxes(torch, K1, mats, h, h)
    ms_k, call_k, plain_ms = timed(
        torch, "similarity_warp",
        lambda: K1.similarity_warp_frames(frames, idx, zeros, zeros, h,
                                          mats, h),
        lambda: K1.similarity_warp_frames_plain(frames, idx, zeros, zeros,
                                                h, mats, h))
    px = warp_footprint_pixels(torch, mats, h, h,
                               (idx, zeros, zeros, tuple(frames.shape[:3])))
    nbytes = px * 3 + b * 3 * 4 + mats.numel() * 4 + warp.numel() * 4
    bound_ms, bound_by = bound(nbytes, warp.numel() * 12, PEAK_F32)
    results["similarity_warp"]["train"] = dict(
        faces=b, window=h, ms=ms_k, call_ms=call_k, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by)
    # the frozen encoder on the card against the CPU, same augmented faces
    x = fixed_image_standardization(want[:AUG_CPU_FACES])
    enc_cpu = copy.deepcopy(enc).cpu()
    with torch.no_grad():
        e_gpu = enc(x.to(dev).permute(0, 3, 1, 2)).cpu()
        e_cpu = enc_cpu(x.permute(0, 3, 1, 2))
    cos = float(torch.nn.functional.cosine_similarity(e_gpu, e_cpu,
                                                      dim=-1).min())
    phase("train-aug-K1", f"similarity_warp frames form at the training "
          f"shape, {b}x{h}x{h} u8 images, each its own window, one "
          f"rotation + crop similarity each -> {h} px f32: equal to the "
          f"plain version (torch.equal); tile boxes equal "
          f"ops.warp.footprint_boxes (staged tiles {shares[torch.uint8]:.2%}"
          f" u8); kernel {ms_k:.4f} ms, call {call_k:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {px} "
          f"distinct pixels read, {px / (b * h * h):.1%} of the batch) "
          f"({TIMING}); facenet_aug_warp on the card vs the CPU for the same "
          f"drawn parameters: max diff {aug_diff} (torch.equal); the frozen "
          f"iresnet100 on {AUG_CPU_FACES} augmented faces, card vs CPU f32: "
          f"min cosine {cos:.6f} (>= 0.999) ({card})")
    if cos < 0.999:
        fail("train (b) encoder card vs CPU outside tolerance")

    # the MLP step of (b) on the card against the CPU: one epoch, dropout
    # 0, the same seeded MLP, each batch augmented and encoded once on the
    # card and the same embeddings given to both
    cfg["model"]["args"]["dropout_prob"] = 0.0
    cfg["trainer"].update(epochs=1,
                          save_dir=os.path.join(work, "saved_b_gate"))
    with contextlib.redirect_stdout(log):
        tg = cli_train.build_trainer_from_config(copy.deepcopy(cfg),
                                                 device=dev)[0]
        tc = cli_train.build_trainer_from_config(copy.deepcopy(cfg),
                                                 device="cpu")[0]
    gl, cl, norms = [], [], []
    for batch in tg._batches(tg.train_loader):
        emb = tg._encode(tg._prepare_input(batch["data"], train=True))
        norms.append(float(emb.norm(dim=1).median()))
        target, weight = batch["target"], batch["weight"]
        gl.append(tg._update(emb, target, weight)[0])
        cl.append(tc._update(emb.cpu(), target.cpu(), weight.cpu())[0])
    gl, cl = np.asarray(gl), np.asarray(cl)
    loss_rel = float(np.max(np.abs(gl - cl) / np.abs(cl)))
    gw, cw = tg.model.state_dict(), tc.model.state_dict()
    w_err = max(float((gw[k].cpu() - cw[k]).abs().max()) for k in cw)
    phase("train-aug-card-vs-cpu", f"the MLP step of (b), one epoch, "
          f"dropout 0, from the same seeded weights on the same augmented "
          f"and encoded batches (median embedding norm "
          f"{np.median(norms):.4g}): {len(gl)} per-batch losses "
          f"{', '.join(f'{v:.4g}' for v in gl)}, max rel diff "
          f"{loss_rel:.2e} (rtol 1e-4); final MLP weights max abs diff "
          f"{w_err:.2e} (atol 1e-3) ({card})")
    if not np.all(np.isfinite(gl)) or loss_rel > 1e-4 or w_err > 1e-3:
        fail("train (b) MLP step card vs CPU outside tolerance")


def img_dataset(work):
    """IMG_CLASSES x (IMG_PER_CLASS + 1) PNGs of IMG_SIZE px: class c is
    face c mod 20 of the repo's data/*.png under a seeded colour tint,
    each image a seeded crop of it enlarged by 12 px, a gain and noise;
    the last of each class is for validation."""
    from vn_celeb_face_recognition_tpu_torch.utils.frames import (
        face_files,
        read_png,
        resize_bilinear,
        write_png,
    )

    img_dir = os.path.join(work, "img")
    os.makedirs(img_dir)
    gen = np.random.default_rng(25)
    big = IMG_SIZE + 12
    bases = [resize_bilinear(read_png(f), (big, big)).astype(np.float32)
             for f in face_files()]
    train, val = {}, {}
    for c in range(IMG_CLASSES):
        base = bases[c % len(bases)] * gen.uniform(0.75, 1.25, 3)
        names = []
        for j in range(IMG_PER_CLASS + 1):
            y, x = gen.integers(0, 13, 2)
            crop = base[y:y + IMG_SIZE, x:x + IMG_SIZE]
            img = crop * gen.uniform(0.8, 1.2) \
                + gen.normal(0, 6, (IMG_SIZE, IMG_SIZE, 3))
            write_png(os.path.join(img_dir, f"{c}_{j}.png"),
                      np.clip(np.round(img), 0, 255).astype(np.uint8))
            names.append(f"{c}_{j}.png")
        train[str(c)], val[str(c)] = names[:-1], names[-1:]
    for name, manifest in (("img_train.json", train),
                           ("img_val.json", val)):
        with open(os.path.join(work, name), "w") as fp:
            json.dump(manifest, fp)
    return img_dir


def phase_train_img(torch, kernels, K1, dev, card, results):
    """24. The image-classify trainer and the shared online-aug step.
    (a) ``train-img``: cfg/train_cfg_img_classify.json as it stands
    through cli.train.main (InceptionResnetV1 classify, 1,000 classes,
    seeded after the missing-weights warning; rank1_aug; batch 64, val 32;
    Adam 1e-3 wd 1e-4; plateau schedule; f32, TF32 off) on seeded 181 px
    PNGs; cut: epochs 100 -> 2, save_period kept at 1. The rate (train
    samples over the median epoch wall), the median step (CUDA events),
    StageTimer means (augment, forward_backward, optimizer), the busy
    share of a profiled epoch, the peak of torch.cuda.max_memory_allocated
    and the checkpoint's size; no kernel launched. (b) ``train-img-aug``:
    rank1 on the card against the CPU on the same drawn parameters, every
    augmenter forced at least once, within 1e-4 after prewhiten; the
    draw's shares. (c) ``train-img-card-vs-cpu``: two steps of batches of
    8 at dropout 0, each from the same state on both (the card's after the
    first) with the same rank1 parameters, with SGD (momentum 0.9, the
    config's rate and decay): Adam's first step is ~lr sign(g), which
    turns the devices' rounding on gradients near 0 into +-lr moves, while
    SGD's step is linear in the gradient. Losses within rtol 1e-4,
    parameters and BN running statistics within 1e-3. (d)
    ``train-img-eval``: cli.eval.main on the checkpoint writes result.csv,
    one row per validation image. (e) ``aug-step``:
    training.aug_step.make_aug_train_step at bench.py's train shape: the
    median step, images/s, exactly one K1 launch a step; K1 at that shape
    equal to its plain version and timed against it and its bound."""
    import logging
    import shutil
    import tempfile

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="train_img_smoke_",
                            dir=os.path.join(HERE, "build"))
    log = open(os.path.join(work, "trainer.log"), "w")
    try:
        train_img_classifier(torch, kernels, dev, card, work, log)
        aug_step_line(torch, kernels, K1, dev, card, results)
    finally:
        root = logging.getLogger()
        for handler in list(root.handlers):
            root.removeHandler(handler)
            handler.close()
        log.close()
        shutil.rmtree(work, ignore_errors=True)


def to_cpu(tree):
    """A tree of dicts and lists (rank1 parameters, an optimizer's
    state_dict) with copies of its tensors on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.detach().cpu().clone() if hasattr(tree, "detach") else tree


def train_img_classifier(torch, kernels, dev, card, work, log):
    """Phase 24 (a)-(d)."""
    import csv

    from vn_celeb_face_recognition_tpu_torch.cli import eval as cli_eval
    from vn_celeb_face_recognition_tpu_torch.cli import train as cli_train
    from vn_celeb_face_recognition_tpu_torch.models import local_weights
    from vn_celeb_face_recognition_tpu_torch.ops import augment as AUG
    from vn_celeb_face_recognition_tpu_torch.training import trainer as TR
    from vn_celeb_face_recognition_tpu_torch.utils.tracing import StageTimer

    t0 = time.perf_counter()
    img_dir = img_dataset(work)
    data_s = time.perf_counter() - t0
    cfg = read_json("cfg", "train_cfg_img_classify.json")
    for split, manifest in (("train_dataset", "img_train.json"),
                            ("val_dataset", "img_val.json")):
        cfg[split]["args"] = {"data_dir": img_dir,
                              "label_file": os.path.join(work, manifest)}
    cfg["trainer"].update(epochs=IMG_EPOCHS,
                          save_dir=os.path.join(work, "saved_img"))
    path = write_config(cfg, work, "train_img.json")
    weights = local_weights("InceptionResnetV1", "vggface2")
    source = (f"weights {weights}" if weights else
              "seeded: no local weights, the warning printed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with train_probes(torch, TR) as rec, contextlib.redirect_stdout(log):
        trainer = cli_train.main(["-c", path])
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        fail(f"train-img launched kernels {counts}; its path has none")
    model = trainer.model
    if trainer.device.type != "cuda" or model.logits is None \
            or model.logits.out_features != 1000:
        fail(f"train-img: {type(model).__name__} on {trainer.device}")
    steps = len(trainer.train_loader) * IMG_EPOCHS
    ms = step_ms(rec)
    losses = [lg["neg_log_llhood"] for _, _, lg in rec["epochs"]]
    if len(ms) != steps or not all(np.isfinite(losses)):
        fail(f"train-img: {len(ms)} steps, losses {losses}")
    ckpt = os.path.join(trainer.save_dir, f"checkpoint-epoch{IMG_EPOCHS}.ckpt")
    ckpt_mb = os.path.getsize(ckpt) / 2**20
    walls = [s for _, s, _ in rec["epochs"]]
    bs = trainer.train_loader.batch_size
    n_train = len(trainer.train_loader.dataset)

    # stage means (each stage waits for the device at its end), one more
    # unprofiled epoch for the rate, and the busy share of a profiled one
    timer = StageTimer()
    stages = ((TR.BaseTrainer, "_prepare_input", "augment"),
              (TR.BaseTrainer, "_forward_backward", "forward_backward"),
              (TR.BaseTrainer, "_optimizer_step", "optimizer"))
    with train_probes(torch, TR, timer, stages), \
            contextlib.redirect_stdout(log):
        trainer._train_epoch(IMG_EPOCHS + 1)
    means = ", ".join(f"{name} {st['mean_ms']:.2f}" for name, st in
                      timer.report().items())
    with train_probes(torch, TR) as rec2, contextlib.redirect_stdout(log):
        trainer._train_epoch(IMG_EPOCHS + 2)
    walls += [s for _, s, _ in rec2["epochs"]]
    with contextlib.redirect_stdout(log):
        busy, top = busy_ms(torch, lambda: trainer._train_epoch(
            IMG_EPOCHS + 3))
    rate, epoch_s = train_rate(n_train, walls)
    mem = steps_in_memory(torch, TR, trainer)
    mem_timer = StageTimer()
    steps_in_memory(torch, TR, trainer, mem_timer, stages)
    mem_means = ", ".join(f"{name} {st['mean_ms']:.2f}" for name, st in
                          mem_timer.report().items())
    phase("train-img", f"cfg/train_cfg_img_classify.json through "
          f"cli.train.main on the card: InceptionResnetV1 classify 1,000 "
          f"classes ({source}), "
          f"rank1_aug, f32 (TF32 off), Adam 1e-3, batch {bs}, "
          f"{IMG_CLASSES} classes x {IMG_PER_CLASS} train + 1 val PNGs of "
          f"{IMG_SIZE} px (written in {data_s:.1f} s); cut: epochs 100 -> "
          f"{IMG_EPOCHS}, save_period 1. {rate:.1f} train samples/s = "
          f"{n_train} over the median epoch wall {epoch_s:.3f} s (train + "
          f"val, loader waits included; epochs "
          f"{', '.join(f'{s:.3f}' for s in walls)} s, the last one "
          f"unprofiled after the run); median step {ms[len(ms) // 2]:.2f} "
          f"ms (CUDA events, {len(ms)} steps; min {ms[0]:.2f}, max "
          f"{ms[-1]:.2f}); train loss by epoch "
          f"{', '.join(f'{v:.4f}' for v in losses)}; StageTimer means ms "
          f"(each stage synchronised): {means}; one profiled epoch: device "
          f"busy {busy:.1f} ms = {busy / 1e3 / epoch_s:.1%} of the median "
          f"epoch wall (top: {top}); with the batches on the card "
          f"beforehand (no reader thread): median step "
          f"{mem[len(mem) // 2]:.2f} ms, stage means ms {mem_means}; "
          f"max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; checkpoint {ckpt_mb:.1f} MiB; kernels "
          f"launched: none ({card})")

    # (b) rank1 on the card against the CPU, every augmenter forced once
    batch = next(iter(trainer.train_loader))
    frames = torch.from_numpy(batch["data"]).to(dev)
    b = frames.shape[0]
    gen = torch.Generator(device=dev).manual_seed(6)
    params = AUG.rank1_vn_celeb_aug_params(gen, b)
    n_ops = len(AUG.RANK1_OPS)
    params["op"][:n_ops] = torch.arange(n_ops, device=dev)
    params["apply"][:n_ops] = True
    got = AUG.rank1_vn_celeb_aug_apply(frames, params)
    want = AUG.rank1_vn_celeb_aug_apply(frames.cpu(), to_cpu(params))
    aug_err = float((got.cpu() - want).abs().max())
    aug_ms = median_ms(torch, lambda: AUG.rank1_vn_celeb_aug(gen, frames))
    draws = AUG.rank1_vn_celeb_aug_params(gen, 4096)
    op_shares = torch.bincount(draws["op"], minlength=n_ops).float() / 4096
    shares = ", ".join(f"{name} {float(v):.3f}" for (name, _, _), v in
                       zip(AUG.RANK1_OPS, op_shares))
    phase("train-img-aug", f"rank1_vn_celeb_aug_apply on {b}x{IMG_SIZE}x"
          f"{IMG_SIZE} u8 on the card vs the CPU, the same drawn parameters "
          f"with each of the {n_ops} augmenters forced on one image: max abs "
          f"diff {aug_err:.2e} after prewhiten (<= 1e-4); draw + apply on "
          f"the card {aug_ms:.3f} ms (CUDA events, median of 20); 4,096 "
          f"draws: flip {float(draws['flip'].float().mean()):.3f} (0.5), "
          f"apply {float(draws['apply'].float().mean()):.3f} (0.8), ops "
          f"{shares} "
          f"(0.125 each) ({card})")
    if not aug_err <= 1e-4 or not bool(torch.isfinite(got).all()):
        fail("rank1_aug card vs CPU outside tolerance")

    # (c) the card against the CPU: two steps, each from the same state
    gate = copy.deepcopy(cfg)
    gate["model"]["args"]["dropout_prob"] = 0.0
    gate["optimizer"] = {"name": "SGD", "args": {
        "lr": cfg["optimizer"]["args"]["lr"], "momentum": 0.9,
        "weight_decay": cfg["optimizer"]["args"]["weight_decay"]}}
    gate["train_data_loader"]["args"]["batch_size"] = IMG_GATE_BATCH
    gate["trainer"].update(epochs=1, save_dir=os.path.join(work, "gate"))
    with contextlib.redirect_stdout(log):
        tg = cli_train.build_trainer_from_config(copy.deepcopy(gate),
                                                 device=dev)[0]
        tc = cli_train.build_trainer_from_config(copy.deepcopy(gate),
                                                 device="cpu")[0]
    gen = torch.Generator(device=dev).manual_seed(7)
    rows, lines = [], []
    for i, batch in enumerate(tg.train_loader):
        if i == IMG_GATE_STEPS:
            break
        if i:  # the CPU continues from the card's state
            tc.model.load_state_dict(tg.model.state_dict())
            tc.optimizer.load_state_dict(to_cpu(tg.optimizer.state_dict()))
        data = torch.from_numpy(batch["data"])
        target = torch.from_numpy(batch["target"])
        weight = torch.from_numpy(batch["weight"])
        p = AUG.rank1_vn_celeb_aug_params(gen, data.shape[0])
        xg = AUG.rank1_vn_celeb_aug_apply(data.to(dev), p)
        xc = AUG.rank1_vn_celeb_aug_apply(data, to_cpu(p))
        lg = tg._update(xg.permute(0, 3, 1, 2), target.to(dev),
                        weight.to(dev))[0]
        lc = tc._update(xc.permute(0, 3, 1, 2), target, weight)[0]
        gw, cw = tg.model.state_dict(), tc.model.state_dict()
        diffs = {k: float((gw[k].cpu().float() - cw[k].float()).abs().max())
                 for k in cw if not k.endswith("num_batches_tracked")}
        stats = max(v for k, v in diffs.items() if ".running_" in k)
        par = max(v for k, v in diffs.items() if ".running_" not in k)
        worst = max(diffs, key=diffs.get)
        rel = abs(lg - lc) / abs(lc)
        rows.append((rel, par, stats))
        lines.append(f"step {i + 1}: losses {lg:.6f} / {lc:.6f} (rel "
                     f"{rel:.2e}), parameters max abs diff {par:.2e}, BN "
                     f"running statistics {stats:.2e} (worst {worst})")
    phase("train-img-card-vs-cpu", f"InceptionResnetV1 classify, batches of "
          f"{IMG_GATE_BATCH} x {IMG_SIZE} px, dropout 0, rank1 on the same "
          f"drawn parameters, SGD lr {gate['optimizer']['args']['lr']} "
          f"momentum 0.9 wd {gate['optimizer']['args']['weight_decay']} "
          f"(linear in the gradient), each step from the same state: "
          f"{'; '.join(lines)} (gates: rtol 1e-4, atol 1e-3, atol 1e-3) "
          f"({card})")
    if len(rows) != IMG_GATE_STEPS or any(
            not (rel <= 1e-4 and par <= 1e-3 and st <= 1e-3)
            for rel, par, st in rows):
        fail("train-img card vs CPU outside tolerance")

    # (d) cli.eval on the checkpoint the cut run wrote
    ev_cfg = copy.deepcopy(cfg)
    ev_cfg["trainer"].update(resume_path=ckpt, save_result=True,
                             save_dir=os.path.join(work, "saved_img_eval"))
    with contextlib.redirect_stdout(log):
        ev = cli_eval.main(["-c", write_config(ev_cfg, work,
                                                "eval_img.json")])
    with open(os.path.join(ev.save_dir, "result.csv"), newline="") as fp:
        result = list(csv.reader(fp))
    hits = sum(r[1] == r[2] for r in result[1:])
    phase("train-img-eval", f"cli.eval.main on {os.path.basename(ckpt)}: "
          f"result.csv {len(result) - 1} rows for {IMG_CLASSES} validation "
          f"images, header {result[0]}, {hits} predicted right")
    if result[0] != ["Path", "Target", "Prediction", "Probability"] \
            or len(result) - 1 != IMG_CLASSES:
        fail("train-img eval: result.csv rows")


def aug_step_line(torch, kernels, K1, dev, card, results):
    """Phase 24 (e)."""
    from vn_celeb_face_recognition_tpu_torch.ops import augment as AUG
    from vn_celeb_face_recognition_tpu_torch.training.aug_step import (
        make_aug_train_step,
    )
    from vn_celeb_face_recognition_tpu_torch.utils.frames import (
        face_files,
        read_png,
        resize_bilinear,
    )

    step, mlp, opt = make_aug_train_step("iresnet100", STEP_CLASSES, 112,
                                         seed=0, device=dev)
    faces = [resize_bilinear(read_png(f), (112, 112)) for f in face_files()]
    imgs = torch.from_numpy(np.stack([faces[i % len(faces)]
                                      for i in range(STEP_BATCH)])).to(dev)
    target = (torch.arange(STEP_BATCH, device=dev) % STEP_CLASSES).to(
        torch.int32)
    weight = torch.ones(STEP_BATCH, device=dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    for _ in range(3):  # warm-up: cuDNN plans, the allocator
        step(mlp, opt, imgs, target, weight, gen)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    events, losses = [], []
    for _ in range(STEP_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(mlp, opt, imgs, target, weight, gen))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_line_counts(counts, {"similarity_warp": 1}, STEP_RUNS, "aug-step",
                      results)
    results["similarity_warp"]["aug_step_launches"] = STEP_RUNS
    times = sorted(s.elapsed_time(e) for s, e in events)
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        fail(f"aug-step losses {losses}")
    median = times[len(times) // 2]

    # K1 at the step's shape: one frames-form warp of the 256 faces
    b, h = imgs.shape[:2]
    mats, offs, flip = AUG.facenet_aug_params(gen, b, h, h, h)
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    idx = torch.arange(b, dtype=torch.int32, device=dev)
    warp = through_kernel(kernels, "similarity_warp",
                          lambda: K1.similarity_warp_frames(
                              imgs, idx, zeros, zeros, h, mats, h))
    plain = K1.similarity_warp_frames_plain(imgs, idx, zeros, zeros, h,
                                            mats, h)
    if not torch.equal(warp, plain):
        fail(f"K1 frames form at the aug-step shape: max diff "
             f"{float((warp - plain).abs().max()):.3e} from the plain "
             "version")
    ms_k, call_k, plain_ms = timed(
        torch, "similarity_warp",
        lambda: K1.similarity_warp_frames(imgs, idx, zeros, zeros, h, mats,
                                          h),
        lambda: K1.similarity_warp_frames_plain(imgs, idx, zeros, zeros, h,
                                                mats, h))
    px = warp_footprint_pixels(torch, mats, h, h,
                               (idx, zeros, zeros, tuple(imgs.shape[:3])))
    nbytes = px * 3 + b * 3 * 4 + mats.numel() * 4 + warp.numel() * 4
    bound_ms, bound_by = bound(nbytes, warp.numel() * 12, PEAK_F32)
    results["similarity_warp"]["aug_step"] = dict(
        faces=b, window=h, ms=ms_k, call_ms=call_k, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by)
    phase("aug-step", f"training.aug_step.make_aug_train_step at bench.py's "
          f"train shape: facenet_aug (K1 frames form) -> iresnet100 bf16 "
          f"(seeded, frozen, no_grad) -> MLP 512-2048-{STEP_CLASSES}, NLL, "
          f"Adam 1e-4; {b} faces of {h} px from data/*.png: median step "
          f"{median:.2f} ms (CUDA events, {STEP_RUNS} steps after 3 warm-up; "
          f"min {times[0]:.2f}, max {times[-1]:.2f}) = "
          f"{b / median * 1e3:.1f} images/s; losses {losses[0]:.4g} -> "
          f"{losses[-1]:.4g}; launches {counts} = one K1 a step; K1 at "
          f"{b}x{h}x{h} u8 equal to its plain version (torch.equal), kernel "
          f"{ms_k:.4f} ms, call {call_k:.4f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {px} distinct pixels "
          f"read) ({TIMING}; {card})")


# phase 25 (FAN and the dataset tools): FAN_FACES face crops a timed batch,
# the data/ PNGs resized to FAN_SIDES px in turn, each crop its own box;
# FAN_CALLS timed calls. FAN_REL bounds each module's heatmaps card vs CPU
# in f32 (TF32 off), relative to max|heatmap|.
FAN_FACES, FAN_CALLS, FAN_MODULES = 64, 10, 4
FAN_SIDES = (96, 128, 160, 192, 224)
FAN_REL = 1e-4
# launches of one MTCNN detect (the default line's cascade, no warp)
DETECT_LAUNCHES = {k: n for k, n in MTCNN_LINE_LAUNCHES.items()
                   if k != "similarity_warp"}


def fan_faces(n):
    """``n`` face crops (the data/ PNGs resized to FAN_SIDES px in turn)
    zero-padded into one uint8 batch, and their boxes: each crop's own
    extent, as the seq path hands its crops to FAN."""
    import cv2

    from vn_celeb_face_recognition_tpu_torch.utils.frames import face_files

    files = face_files()
    side = max(FAN_SIDES)
    batch = np.zeros((n, side, side, 3), np.uint8)
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        s = FAN_SIDES[i % len(FAN_SIDES)]
        bgr = cv2.imread(files[i % len(files)])
        batch[i, :s, :s] = cv2.resize(bgr, (s, s),
                                      interpolation=cv2.INTER_AREA)[..., ::-1]
        boxes[i, 2:] = s
    return batch, boxes


def fan_flops(torch, num_modules):
    """FLOP of one face through a ``num_modules`` FAN at 256 px (two a
    multiply-add), by torch.utils.flop_counter on these shapes, traced on
    the meta device (no data, no device work)."""
    from torch.utils.flop_counter import FlopCounterMode

    from vn_celeb_face_recognition_tpu_torch.models.fan import FAN

    with torch.device("meta"):
        net = FAN(num_modules=num_modules).eval()
        x = torch.zeros((1, 3, 256, 256))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(x)
    return counter.get_total_flops()


def write_fan_npz(torch, path):
    """A seeded 4-module FAN as a torch-keyed .npz without
    num_batches_tracked, as the released 2DFAN4 checkpoint is keyed."""
    from vn_celeb_face_recognition_tpu_torch.models.fan import FAN
    from vn_celeb_face_recognition_tpu_torch.models.layers import (
        seeded_init_,
    )

    net = seeded_init_(FAN(num_modules=FAN_MODULES),
                       torch.Generator().manual_seed(3))
    np.savez(path, **{k: v.numpy() for k, v in net.state_dict().items()
                      if not k.endswith("num_batches_tracked")})
    return path


def phase_fan(torch, kernels, dev, card, results):
    """25. FAN and the dataset tools, through the port's entry points.
    ``fan``: FANLandmarker (4 modules, seeded) on FAN_FACES face crops of
    96-224 px in f32 (TF32 off, and on as users run it) and bf16: median
    ms a batch (CUDA events around landmarks_for_boxes, copies included),
    the device time, faces/s and TFLOP/s at the counted FLOP beside the
    bound; get_landmarks at batch 1; the busy share of one profiled batch;
    bf16 against f32, median landmark drift <= one heatmap cell.
    ``fan-card-vs-cpu``: 2 faces in f32: the crops within 1e-5, each
    module's heatmaps within FAN_REL of max|heatmap|, the decode of the
    same heatmaps equal on both devices. ``fan-seq``:
    demo_image.recognize_image with seq_fd_vs_aln and --fan_weights (a
    seeded 4-module .npz) on a 640x640 frame with 4 faces, the geometric
    gate wrapped to accept while still running it; launches held to exact
    per-call counts; the card against the CPU (equal names, boxes within
    1e-2 px). ``dataset-tools``: crop_face, split_train_val, align_face
    with MTCNN and with --fan_weights through their main() on the 20 face
    PNGs of data/, two frames with two faces, a faceless image and a file
    that is no image; images/s and stage means; launches held to exact
    counts (MTCNN's per detect call, K1's per aligned image).
    ``dataset-tools-card-vs-cpu``: the same with -dv cpu on the same
    inputs: equal file names, manifests and crops, aligned PNGs within 1
    level."""
    import shutil
    import tempfile

    os.chdir(HERE)  # the CLIs' flags name files from the repo root
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="fan_smoke_", dir=os.path.join(HERE,
                                                                  "build"))
    try:
        npz = write_fan_npz(torch, os.path.join(work, "fan4.npz"))
        fan_line(torch, dev, card)
        fan_seq(torch, kernels, dev, card, results, npz)
        dataset_tools(torch, kernels, dev, card, results, work, npz)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def fan_line(torch, dev, card):
    """Phase 25's ``fan`` and ``fan-card-vs-cpu`` lines."""
    from vn_celeb_face_recognition_tpu_torch.models import fan as FM

    lm32 = FM.FANLandmarker(num_modules=FAN_MODULES, device=dev)
    lm16 = FM.FANLandmarker(num_modules=FAN_MODULES, dtype="bfloat16",
                            state_dict=lm32.net.state_dict(), device=dev)
    batch, boxes = fan_faces(FAN_FACES)
    flops = fan_flops(torch, FAN_MODULES)
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       lm32.net.state_dict().values())
    nbytes = batch.nbytes + boxes.nbytes + weight_bytes + FAN_FACES * 68 * 8
    parts, pts, batch_ms = [], {}, {}
    for label, lm, peak, tf32 in (("f32", lm32, PEAK_F32, False),
                                  ("f32 TF32", lm32, PEAK_TF32, True),
                                  ("bf16", lm16, PEAK_BF16, False)):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            def call(lm=lm):
                return lm.landmarks_for_boxes(batch, boxes)

            pts[label] = call()
            ms = median_ms(torch, call, runs=FAN_CALLS, warmup=2)
            dev_ms = device_ms(torch, call, runs=3)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        if not np.isfinite(pts[label]).all():
            fail(f"fan {label}: non-finite landmarks")
        bound_ms, bound_by = bound(nbytes, FAN_FACES * flops, peak)
        batch_ms[label] = ms
        parts.append(
            f"{label}: median {ms:.2f} ms a batch of {FAN_FACES} = "
            f"{ms / FAN_FACES:.3f} ms a face, {FAN_FACES / ms * 1e3:.1f} "
            f"faces/s; device {dev_ms:.2f} ms = "
            f"{FAN_FACES * flops / dev_ms / 1e9:.1f} TFLOP/s; bound "
            f"{bound_ms:.2f} ms ({bound_by})")
    one = batch[0, :FAN_SIDES[0], :FAN_SIDES[0]]
    b1 = {label: median_ms(torch, lambda lm=lm: lm.get_landmarks(one),
                           runs=20)
          for label, lm in (("f32", lm32), ("bf16", lm16))}
    busy, top = busy_ms(torch, lambda: lm32.landmarks_for_boxes(batch,
                                                                boxes))
    f32_ms = batch_ms["f32"]
    cell = (200.0 * FM.box_center_scale(boxes)[1].numpy() / 64.0)[:, None]
    drift = np.linalg.norm(pts["bf16"] - pts["f32"], axis=-1) / cell
    phase("fan", f"FANLandmarker({FAN_MODULES} modules, seeded, "
          f"{sum(p.numel() for p in lm32.net.parameters()) / 1e6:.1f} M "
          f"weights, {flops / 1e9:.2f} GFLOP a face at 256 px by "
          f"torch.utils.flop_counter) on {FAN_FACES} face crops of "
          f"{FAN_SIDES[0]}-{FAN_SIDES[-1]} px: " + "; ".join(parts)
          + f" (CUDA events around landmarks_for_boxes, copies included, "
          f"median of {FAN_CALLS}; device time from torch.profiler, mean of "
          f"3); batch 1"
          f" get_landmarks median f32 {b1['f32']:.2f} ms, bf16 "
          f"{b1['bf16']:.2f} ms; one profiled f32 batch device busy "
          f"{busy:.2f} ms = {busy / f32_ms:.1%} of {f32_ms:.2f} ms (top: "
          f"{top}); bf16 vs f32 landmark drift median {np.median(drift):.3f}"
          f" heatmap cells (<= 1), {(drift <= 4).mean():.1%} within 4 cells, "
          f"max {drift.max():.1f}; {card}")
    if np.median(drift) > 1.0:
        fail("fan: bf16 landmarks drift more than one heatmap cell")

    # the card against the CPU, f32, TF32 off, 2 faces
    cpu = FM.FANLandmarker(num_modules=FAN_MODULES, device="cpu",
                           state_dict=lm32.net.state_dict())
    images = torch.from_numpy(batch[:2])
    centers, scales = FM.box_center_scale(boxes[:2])
    crops = FM.crop_face_window(images, centers, scales)
    crop_err = float((FM.crop_face_window(
        images.to(dev), centers.to(dev), scales.to(dev)).cpu()
        - crops).abs().max())
    x = crops.permute(0, 3, 1, 2)
    with torch.no_grad():
        want = cpu.net(x)
        got = [h.cpu() for h in lm32.net(x.to(dev))]
    rels = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    on_card = FM.decode_heatmaps(got[-1].to(dev), centers.to(dev),
                                 scales.to(dev)).cpu()
    on_cpu = FM.decode_heatmaps(got[-1], centers, scales)
    same = int((FM.decode_heatmaps(want[-1], centers, scales)
                == on_cpu).all(-1).sum())
    phase("fan-card-vs-cpu", f"2 faces, f32, TF32 off: crops max diff "
          f"{crop_err:.2e} (<= 1e-5); heatmaps max diff / max|heatmap| per "
          f"module {', '.join(f'{r:.2e}' for r in rels)} (<= {FAN_REL}); "
          f"decode of the card's heatmaps equal on both devices "
          f"{bool(torch.equal(on_card, on_cpu))}; {same} of 136 landmarks "
          "equal when each device decodes its own heatmaps (not gated: the "
          "seeded maps are nearly flat)")
    if crop_err > 1e-5 or max(rels) > FAN_REL or not torch.equal(on_card,
                                                                 on_cpu):
        fail("fan card vs CPU outside tolerance")


def fan_seq(torch, kernels, dev, card, results, npz):
    """Phase 25's ``fan-seq`` line."""
    from vn_celeb_face_recognition_tpu_torch.cli import demo_image as DI
    from vn_celeb_face_recognition_tpu_torch.models import fan as FM
    from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames

    parser = DI.build_arg_parser()
    flags = ["-m", "", "-l2n", "meta_data/face_recognition/label2name.txt",
             "-nc", str(REC_CLASSES), "--inference_method", "seq_fd_vs_aln",
             "--fan_weights", npz]
    img = build_frames(1, SIZE, FACES_PER_FRAME)[0]
    verdicts, real = [], FM.reduce_to_5_points

    def lenient(pts):
        dst, ok = real(pts)
        verdicts.append(ok)
        return dst, True

    out = {}
    FM.reduce_to_5_points = lenient
    try:
        for where in ("cuda", "cpu"):
            args = parser.parse_args(flags + ["-dv", where])
            with contextlib.redirect_stdout(io.StringIO()):
                models = DI.setup_models(args)
                fan = DI.build_fan_model(args)
                out[where] = DI.recognize_image(args, models, img, fan)
            if where == "cpu":
                continue
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            verdicts.clear()
            times = []
            for _ in range(REC_CALLS):
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    names, boxes, _, _ = DI.recognize_image(args, models,
                                                            img, fan)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            counts = kernels.launch_counts()
            check_line_counts(counts, MTCNN_LINE_LAUNCHES, REC_CALLS,
                              "fan-seq", results)
            launched = {k: n for k, n in counts.items() if n}
            if len(names) != FACES_PER_FRAME:
                fail(f"fan-seq: {len(names)} faces kept of "
                     f"{FACES_PER_FRAME}")
            accepted = sum(verdicts) / REC_CALLS
    finally:
        FM.reduce_to_5_points = real
    (g_names, g_boxes), (c_names, c_boxes) = (out["cuda"][:2],
                                              out["cpu"][:2])
    perm, box_err = pair_boxes(g_boxes, c_boxes)
    names_equal = perm is not None and list(g_names) == [c_names[j]
                                                          for j in perm]
    times.sort()
    phase("fan-seq", f"demo_image.recognize_image seq_fd_vs_aln "
          f"--fan_weights (a seeded {FAN_MODULES}-module .npz) on one "
          f"{SIZE}x{SIZE} frame with {FACES_PER_FRAME} faces, MTCNN + "
          f"InceptionResnetV1 + MLP {REC_CLASSES}, f32: median "
          f"{times[len(times) // 2]:.2f} ms a call (host clock, {REC_CALLS} "
          f"calls; min {times[0]:.2f}); {len(names)} faces kept, the real "
          f"gate accepted {accepted:.0f} of them a call (the gate wrapped to "
          f"accept, still run); launches {launched} held to "
          f"{MTCNN_LINE_LAUNCHES} a call; card vs CPU: names equal "
          f"{names_equal}, max box diff "
          f"{'unpaired' if box_err is None else f'{box_err:.2e}'} (atol "
          f"1e-2); {card}")
    if not names_equal or box_err > 1e-2:
        fail(f"fan-seq card vs CPU: names {g_names} / {c_names}, boxes "
             f"{g_boxes} / {c_boxes}")


def dataset_inputs(root):
    """The tools' inputs: the 20 face PNGs of data/, two 400x200 frames
    with two faces each, a faceless gradient and a file that is no
    image."""
    import shutil

    import cv2

    from vn_celeb_face_recognition_tpu_torch.utils.frames import face_files

    os.makedirs(root)
    files = face_files()
    for f in files:
        shutil.copy(f, root)
    for i in range(2):
        frame = np.full((200, 400, 3), 90, np.uint8)
        for j in range(2):
            face = cv2.resize(cv2.imread(files[2 * i + j]), (150, 150))
            frame[25:175, 30 + 200 * j:180 + 200 * j] = face
        cv2.imwrite(os.path.join(root, f"two_faces_{i}.png"), frame)
    yy, xx = np.mgrid[0:150, 0:170]
    blank = np.stack([yy, xx, (yy + xx) // 2], -1).astype(np.uint8)
    cv2.imwrite(os.path.join(root, "blank.png"), blank)
    with open(os.path.join(root, "broken.png"), "wb") as fp:
        fp.write(b"not an image")
    return len(files) + 4


def run_tools(torch, kernels, where, raw, out, to_align, npz, counted):
    """crop_face and split_train_val on ``raw``, then align_face (MTCNN,
    then --fan_weights) on ``to_align`` (made from the crops and the
    faceless image by the first run), through their main() on ``where``,
    writing under ``out``. With --fan_weights the geometric gate is
    wrapped to accept while still running it (seeded landmarks seldom
    pass; MTCNN's run drives the blur sweep and the fallback). Returns
    ({tool: (wall s, images, stats, stage means, launches, detect
    calls)}, FAN's [(68 landmarks, box)] an image, the real gate's
    verdicts); on the card each tool's launches are held to MTCNN's per
    detect call and K1's per aligned image."""
    import shutil

    from vn_celeb_face_recognition_tpu_torch.cli import align_face as AF
    from vn_celeb_face_recognition_tpu_torch.cli import crop_face as CF
    from vn_celeb_face_recognition_tpu_torch.cli import split_train_val as SV
    from vn_celeb_face_recognition_tpu_torch.models import fan as FM
    from vn_celeb_face_recognition_tpu_torch.models.mtcnn import MTCNN
    from vn_celeb_face_recognition_tpu_torch.utils.tracing import StageTimer

    os.makedirs(out)
    crops = os.path.join(out, "crops")
    calls, fan_pts, verdicts, report = [0], [], [], {}

    def counting(orig):
        def inference(self, *args, **kwargs):
            calls[0] += 1
            return orig(self, *args, **kwargs)
        return inference

    def recording(orig):
        def get_landmarks(self, rgb_image, detected_box=None):
            pts = orig(self, rgb_image, detected_box)
            h, w = rgb_image.shape[:2]
            fan_pts.append((pts[0], np.asarray(
                [0, 0, w, h] if detected_box is None else detected_box,
                np.float32)))
            return pts
        return get_landmarks

    def lenient(orig):
        def reduce(points68):
            dst, ok = orig(points68)
            verdicts.append(ok)
            return dst, True
        return reduce

    def run(tool, fn, n_images):
        timer = StageTimer()
        calls[0] = 0
        if where == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            stats = fn(timer)
        if where == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernels.launch_counts()
        if where == "cuda" and tool != "split_train_val":
            aligned = (stats["total"] - stats["no_face"]
                       if tool.startswith("align") else 0)
            want = {k: DETECT_LAUNCHES.get(k, 0) * calls[0]
                    + (aligned if k == "similarity_warp" else 0)
                    for k in counts}
            if counts != want:
                fail(f"dataset-tools {tool}: launches {counts}, want {want} "
                     f"for {calls[0]} detect calls and {aligned} aligned "
                     "images")
            for k, n in counts.items():
                counted[k] = counted.get(k, 0) + n
        report[tool] = (secs, n_images, stats, {
            name: st["mean_ms"] for name, st in timer.report().items()},
            {k: n for k, n in counts.items() if n}, calls[0])

    dv = ["-dv", where]
    with patched(MTCNN, "inference", counting):
        run("crop_face", lambda t: CF.main(dv + [
            "-id", raw, "-od", crops, "-nf", os.path.join(out, "unknown.txt"),
            "-mf", os.path.join(out, "many_boxes.txt")], timer=t),
            len(os.listdir(raw)))
        names = sorted(os.listdir(crops))
        with open(os.path.join(out, "train.csv"), "w") as fp:
            fp.write("image,label\n")
            fp.writelines(f"{n},{(2, 10, 7)[i % 3]}\n"
                          for i, n in enumerate(names))
        run("split_train_val", lambda t: SV.main([
            "-d", os.path.join(out, "train.csv"), "-o",
            os.path.join(out, "vn_celeb.json"), "-tr",
            os.path.join(out, "train.json"), "-v",
            os.path.join(out, "val.json"), "--remap_key"]), len(names))
        if not os.path.isdir(to_align):
            os.makedirs(to_align)
            for n in names:
                shutil.copy(os.path.join(crops, n), to_align)
            shutil.copy(os.path.join(raw, "blank.png"), to_align)
        n_align = len(os.listdir(to_align))
        run("align_face", lambda t: AF.main(dv + [
            "-id", to_align, "-od", os.path.join(out, "aligned_mtcnn"), "-as",
            "112", "112", "-nf", os.path.join(out, "unknown_mtcnn.txt")],
            timer=t), n_align)
        with patched(FM.FANLandmarker, "get_landmarks", recording), \
                patched(FM, "reduce_to_5_points", lenient):
            run("align_face --fan_weights", lambda t: AF.main(dv + [
                "-id", to_align, "-od", os.path.join(out, "aligned_fan"),
                "-as", "112", "112", "-nf",
                os.path.join(out, "unknown_fan.txt"), "--fan_weights",
                npz], timer=t), n_align)
    return report, fan_pts, verdicts


def same_tree(a, b, levels, skip=()):
    """Files under ``a`` against ``b``: equal names; PNGs (read by cv2)
    of the same shape, crops equal and the others within ``levels``, other
    files equal byte for byte; the PNGs under the ``skip`` prefixes are
    left to the caller. Returns (files, PNGs held, largest level
    difference) or fails."""
    import cv2

    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    other = sorted(os.path.relpath(os.path.join(d, f), b)
                   for d, _, fs in os.walk(b) for f in fs)
    if names != other:
        fail(f"dataset-tools card vs CPU: files {names} / {other}")
    worst, n_img = 0, 0
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".png"):
            if name.startswith(skip):
                continue
            ia, ib = cv2.imread(pa), cv2.imread(pb)
            if ia.shape != ib.shape:
                fail(f"dataset-tools card vs CPU: {name} {ia.shape} / "
                     f"{ib.shape}")
            diff = int(np.abs(ia.astype(np.int16) - ib).max())
            lim = 0 if name.startswith("crops") else levels
            if diff > lim:
                fail(f"dataset-tools card vs CPU: {name} differs by {diff} "
                     f"levels (<= {lim})")
            worst, n_img = max(worst, diff), n_img + 1
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                if fa.read() != fb.read():
                    fail(f"dataset-tools card vs CPU: {name} differs")
    return len(names), n_img, worst


def fan_aligned_card_vs_cpu(work, to_align, gpu_pts, cpu_pts):
    """align_face --fan_weights card vs CPU, each device on its own FAN
    landmarks (seeded maps are nearly flat, so an argmax may flip on a
    rounding difference): the drift of the 68 landmarks in heatmap cells
    (median <= 1, the bf16 gate's), and the aligned PNG within 1 level for
    every image whose landmarks agree within 1e-3 px on both devices.
    Returns a summary."""
    import cv2

    from vn_celeb_face_recognition_tpu_torch.models.fan import (
        box_center_scale,
    )

    names = sorted(os.listdir(to_align))
    if len(gpu_pts) != len(names) or len(cpu_pts) != len(names):
        fail(f"dataset-tools FAN: {len(gpu_pts)} / {len(cpu_pts)} FAN calls "
             f"for {len(names)} images")
    drift, held, worst = [], 0, 0
    for name, (g, box), (c, cbox) in zip(names, gpu_pts, cpu_pts):
        if np.abs(box - cbox).max() > 1e-2:
            fail(f"dataset-tools FAN {name}: FAN boxes {box} / {cbox}")
        cell = 200.0 * float(box_center_scale(box)[1]) / 64.0
        drift.append(np.linalg.norm(g - c, axis=-1) / cell)
        if np.abs(g - c).max() <= 1e-3:
            ia, ib = (cv2.imread(os.path.join(work, d, "aligned_fan", name))
                      for d in ("cuda", "cpu"))
            diff = int(np.abs(ia.astype(np.int16) - ib).max())
            if diff > 1:
                fail(f"dataset-tools FAN {name}: equal landmarks, aligned "
                     f"faces differ by {diff} levels")
            held, worst = held + 1, max(worst, diff)
    drift = np.concatenate(drift)
    if not held:
        fail("dataset-tools FAN: no image's landmarks agree on both devices")
    if np.median(drift) > 1.0:
        fail(f"dataset-tools FAN: landmark drift card vs CPU median "
             f"{np.median(drift):.3f} heatmap cells (<= 1)")
    return (f"align_face --fan_weights: landmark drift median "
            f"{np.median(drift):.2e} heatmap cells (<= 1), max "
            f"{drift.max():.2e}; {held} of {len(names)} images with their "
            f"landmarks within 1e-3 px on both devices, their aligned faces "
            f"within {worst} levels (<= 1)")


def dataset_tools(torch, kernels, dev, card, results, work, npz):
    """Phase 25's ``dataset-tools`` and ``dataset-tools-card-vs-cpu``
    lines."""
    raw = os.path.join(work, "raw")
    dataset_inputs(raw)
    to_align = os.path.join(work, "to_align")
    counted, runs = {}, {}
    for where in ("cuda", "cpu"):
        runs[where] = run_tools(torch, kernels, where, raw,
                                os.path.join(work, where), to_align, npz,
                                counted)
    for k, n in counted.items():
        if n:
            results[k]["launches"] = results[k].get("launches", 0) + n
            results[k]["dataset_tools_launches"] = n
    report, gpu_pts, verdicts = runs["cuda"]
    parts = []
    for tool, (secs, n, stats, stages, counts, det) in report.items():
        shown = ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        parts.append(f"{tool}: {n} images in {secs:.2f} s = {n / secs:.1f} "
                     f"images/s (host clock); stats "
                     f"{stats if isinstance(stats, dict) else '-'}; stage "
                     f"means ms: {shown or '-'}; {det} detect calls; "
                     f"launches {counts}")
    crop_stats = report["crop_face"][2]
    if crop_stats != {"total": 24, "no_face": 2, "many_faces": 2,
                      "skipped": 0}:
        fail(f"dataset-tools crop_face stats {crop_stats}")
    with open(os.path.join(work, "cuda", "unknown_mtcnn.txt")) as fp:
        if os.path.join(to_align, "blank.png") not in fp.read().split("\n"):
            fail("dataset-tools align_face: the faceless image was aligned")
    phase("dataset-tools", "through main() on the card: crop_face on the 20 "
          "face PNGs of data/, two 400x200 frames with two faces, a faceless"
          " image and a file that is no image; split_train_val --remap_key "
          "on the crops; align_face -as 112 112 on the crops and the "
          "faceless image, with MTCNN (cfg/detection/mtcnn.json) and with "
          f"--fan_weights (a seeded {FAN_MODULES}-module .npz, f32; the gate"
          f" wrapped to accept, still run: the real gate accepted "
          f"{sum(verdicts)} of {len(verdicts)}); launches held to "
          f"{DETECT_LAUNCHES} a detect call and one K1 an aligned image: "
          + "; ".join(parts) + f"; {card}")
    files, images, worst = same_tree(os.path.join(work, "cuda"),
                                     os.path.join(work, "cpu"), 1,
                                     skip=("aligned_fan",))
    fan_part = fan_aligned_card_vs_cpu(work, to_align, gpu_pts,
                                       runs["cpu"][1])
    cpu_s = {t: r[0] for t, r in runs["cpu"][0].items()}
    phase("dataset-tools-card-vs-cpu", f"the same tools with -dv cpu on the "
          f"same inputs: {files} files with equal names; manifests and JSON "
          f"equal byte for byte; {images} PNGs of crop_face and align_face "
          f"(MTCNN): crops equal, aligned faces within {worst} levels (<= "
          f"1); {fan_part}; CPU walls "
          + ", ".join(f"{t} {s:.2f} s" for t, s in cpu_s.items()))

# phase 26 (readers): the CLIs' readers on files written here with cv2, an
# MJPG .avi of 2 x BATCH frames at READ_FPS (OpenCV's own MJPG backend
# writes and reads it without FFmpeg), the repo's face PNGs as JPEGs and
# one frame as a JPEG
READ_FPS = 25.0
# phase 27 (se-ir): resnet101 at full depth on SE_BATCH faces of 112 px,
# timed over SE_RUNS forwards; the aug trainer with it for SE_EPOCHS
# epochs; ArcMargin at PROD_CLASSES + 1 classes (the shipped config's
# MLP width)
SE_BATCH, SE_RUNS, SE_EPOCHS, ARC_CLASSES = 64, 10, 1, 1001


@contextlib.contextmanager
def scratch(prefix):
    """A temp dir under the gitignored build/, removed afterwards; the
    working directory is the repo root, as the CLIs' flags name files
    from it."""
    import shutil
    import tempfile

    os.chdir(HERE)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix=prefix, dir=os.path.join(HERE, "build"))
    try:
        yield work
    finally:
        shutil.rmtree(work, ignore_errors=True)


def cv2_frames(cv2, path):
    """Every frame of a video file as cv2.VideoCapture decodes it, turned
    to RGB, and the fps it reports (25 when it reports 0)."""
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(np.ascontiguousarray(frame[..., ::-1]))
    finally:
        cap.release()
    return frames, fps


def cv2_video_probe():
    """cv2's video backends and whether an mp4v .mp4 that cv2.VideoWriter
    writes reads back, for the cli-io line."""
    import tempfile

    try:
        import cv2
    except ImportError:
        return "cv2 video backends: no cv2"
    registry = cv2.videoio_registry
    names = [registry.getBackendName(b) for b in registry.getBackends()]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "probe.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 READ_FPS, (64, 64))
        opened = writer.isOpened()
        for i in range(4):
            writer.write(np.full((64, 64, 3), 40 * i, np.uint8))
        writer.release()
        back = len(cv2_frames(cv2, path)[0]) if opened else 0
    return (f"cv2 {cv2.__version__} video backends {names}; mp4v .mp4 round"
            f" trip: writer {'opened' if opened else 'not opened'}, {back} "
            "of 4 frames read back")


def phase_readers(torch, kernels, dev, card, results):
    """26. The readers of JPEG and video as a user's files reach them on
    this machine: which reader ``use_native=None`` resolves to and why
    (``native.loader.available``); find_embedding.main on the repo's 20
    face crops written as JPEGs (-bz 8 -w none; cosine >= 0.999 to a lone
    Encoder call on each file's read_image); demo_image.recognize_image on
    a 640x640 frame read from a JPEG (MTCNN par_fd_vs_aln, launches exact
    a call); demo_video.process_video --fused_engine (MTCNN f32,
    InceptionResnetV1, MLP 1001, emotion, 2 chunks of 64) through
    frame_chunks on an MJPG .avi, launches held to CLI path (a)'s exact
    per-run counts, and its tracker.csv equal to a run of the same CLI on
    chunks of the frames cv2.VideoCapture decodes from that file here;
    celeb_statistic.main on the same file (-fidx 1 6 11 16, dynamic
    intervals)."""
    with scratch("readers_smoke_") as work:
        readers_paths(torch, kernels, dev, card, results, work)


def readers_paths(torch, kernels, dev, card, results, work):
    """Phase 26's drives and checks, writing under ``work``."""
    import cv2

    from vn_celeb_face_recognition_tpu_torch.cli import celeb_statistic as CS
    from vn_celeb_face_recognition_tpu_torch.cli import demo_image as DI
    from vn_celeb_face_recognition_tpu_torch.cli import demo_video as DV
    from vn_celeb_face_recognition_tpu_torch.models import mtcnn as MT
    from vn_celeb_face_recognition_tpu_torch.native import loader
    from vn_celeb_face_recognition_tpu_torch.utils.frames import (
        build_frames,
        read_image,
    )

    choice = []
    for name, what in (("image_io", "JPEG"), ("video_io", "video")):
        choice.append(f"{what}: " + (
            "the IO runtime" if loader.available(name) else
            f"cv2, as the IO runtime is not available "
            f"({loader.unavailable_reason(name)})"))
    frames = build_frames(2 * BATCH, SIZE, FACES_PER_FRAME)
    avi = os.path.join(work, "clip.avi")
    writer = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"MJPG"), READ_FPS,
                             (SIZE, SIZE))
    if not writer.isOpened():
        fail("readers: cv2.VideoWriter cannot write an MJPG .avi here")
    for f in frames:
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    decoded, fps = cv2_frames(cv2, avi)
    jpg = os.path.join(work, "frame.jpg")
    cv2.imwrite(jpg, np.ascontiguousarray(frames[0][..., ::-1]))
    img = read_image(jpg)
    ref = cv2.imread(jpg, cv2.IMREAD_COLOR)[..., ::-1]
    img_diff = int(np.abs(img.astype(np.int16) - ref).max())
    phase("readers", f"use_native=None resolves to: {'; '.join(choice)}; "
          f"an MJPG .avi of {len(frames)} {SIZE}x{SIZE} frames at "
          f"{READ_FPS} fps written by cv2.VideoWriter, read back by "
          f"cv2.VideoCapture as {len(decoded)} frames at {fps} fps, max "
          f"diff {int(np.abs(np.stack(decoded).astype(np.int16) - frames).max())}"
          f" levels from the written frames (MJPG is lossy); a JPEG of "
          f"frame 0 through read_image: max diff {img_diff} levels from "
          f"cv2.imread (0 wanted)")
    if len(decoded) != len(frames) or fps != READ_FPS or img_diff:
        fail("readers: the file did not read back as written")

    cli_find_embedding(torch, dev, work, jpeg=True)

    meta = "meta_data/face_recognition"
    flags = ["-m", "", "-l2n", f"{meta}/label2name.txt", "-nc",
             str(REC_CLASSES), "--recog_emotion"]
    parser = CS.build_arg_parser()
    with contextlib.redirect_stdout(io.StringIO()):
        models = DI.setup_models(parser.parse_args(flags))
    with torch.no_grad():  # logits of order 1: the top-k tags not tied
        models[4].module.fc.weight.mul_(0.02)

    args = parser.parse_args(flags + ["--inference_method",
                                      "par_fd_vs_aln"])
    args.recog_emotion = False
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    names, boxes, _, _ = DI.recognize_image(args, models, read_image(jpg))
    torch.cuda.synchronize()
    image_ms = (time.perf_counter() - t0) * 1e3
    check_line_counts(kernels.launch_counts(), MTCNN_LINE_LAUNCHES, 1,
                      "readers demo_image", results)
    if len(names) != FACES_PER_FRAME:
        fail(f"readers demo_image: {len(names)} faces in the JPEG frame")

    # demo_video on the file, and on cv2's frames of it handed over
    emotion_run = {"emotion_stem": 1,
                   "bottleneck_chain": REC_LAUNCHES["retinaface"][
                       "bottleneck_chain"]}
    per_run = dict(MTCNN_LINE_LAUNCHES, **emotion_run)
    csvs = {k: os.path.join(work, f"{k}.csv") for k in ("file", "cv2")}
    args = parser.parse_args(flags + [
        "--fused_engine", "--n_frames", str(BATCH), "--face_cap", "256,320",
        "-vp", avi, "-ot", csvs["file"], "-of", os.path.join(work, "out")])
    fs = (args.target_face_size, args.target_face_size)
    tpl = DV.center_point_dict[str(fs)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    log = io.StringIO()
    trunks = []  # (net, spec, crops) of the first chunk run's K5 calls

    def recorded(orig):
        def trunk(net, x, spec):
            if len(trunks) < 2:
                trunks.append((net, spec, x.clone()))
            return orig(net, x, spec)
        return trunk

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log), patched(MT, "crop_net_trunk",
                                                  recorded):
        n, _ = DV.process_video(args, models, fs, tpl, 0.0, None)
    torch.cuda.synchronize()
    video_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    runs = len(frames) // BATCH  # one engine run a chunk of the file
    if n != len(frames):
        fail(f"readers demo_video: {n} of {len(frames)} frames")
    check_line_counts(launches, per_run, runs, "readers demo_video",
                      results)
    it = iter(decoded)
    a = copy.copy(args)
    a.output_tracker = csvs["cv2"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        DV.process_video(a, models, fs, tpl, 0.0, None, chunks=DV.chunk_frames(
            lambda: next(it, None), fps, args.n_frames))
    torch.cuda.synchronize()
    handed_s = time.perf_counter() - t0
    rows = {k: cli_rows(p) for k, p in csvs.items()}
    cli_check_rows(rows["file"], list(range(1, len(frames) + 1)), fps,
                   "readers demo_video")
    if rows["file"] != rows["cv2"]:
        fail("readers demo_video: tracker.csv from the file differs from the"
             " run on cv2's frames of it")
    fps_line = [ln for ln in log.getvalue().splitlines()
                if ln.startswith("FPS")]
    k5 = k5_f32_at(torch, trunks, results)

    stat_csv = os.path.join(work, "stat.csv")
    stat_json = os.path.join(work, "stat.json")
    fidx = [1, 6, 11, 16]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        CS.main(flags + ["--fused_engine", "--n_frames", str(BATCH),
                         "-vp", avi, "-ot", stat_csv, "-jst", stat_json,
                         "-fidx", *map(str, fidx), "-nvi", "2", "-tap", "1",
                         "-of", os.path.join(work, "stat_out")])
    stat_s = time.perf_counter() - t0
    counts = [c for c in range(1, len(frames) + 1)
              if any(c % fps == i for i in fidx)]
    cli_check_rows(cli_rows(stat_csv), counts, fps, "readers celeb_statistic")
    with open(stat_json) as fp:
        intervals = sorted(json.load(fp))
    phase("readers-cli", f"on the card ({card}), files read by the CLIs' "
          f"readers: demo_image.recognize_image on the JPEG frame (MTCNN "
          f"par_fd_vs_aln): {names}, {image_ms:.1f} ms (host clock, the "
          f"call), launches exact; demo_video.process_video "
          f"--fused_engine (MTCNN f32, InceptionResnetV1, MLP 1001, emotion) "
          f"through frame_chunks on the .avi: {len(rows['file'])} rows in "
          f"{runs} engine runs, {video_s:.2f} s (host clock, the first "
          f"f32 engine run of the process, decode included; "
          f"{fps_line[0] if fps_line else 'no FPS line'}; then {handed_s:.2f}"
          f" s on the decoded frames handed over), "
          f"launches {({k: v for k, v in launches.items() if v})}"
          f" held to CLI path (a)'s per-run counts, tracker.csv equal to the "
          f"run on cv2.VideoCapture's frames of the file; {k5}; "
          f"celeb_statistic.main"
          f" -fidx {fidx} on the .avi: {len(counts)} rows, tracker.json "
          f"intervals {intervals}, {stat_s:.2f} s (models built in it)")


def k5_f32_at(torch, trunks, results):
    """K5's f32 grid (3xTF32) at the crops of one MTCNN chunk run of the
    CLI path (``trunks``: its RNet and ONet calls, (net, spec, crops)):
    held to the plain version in f32 within 1e-4 of max|ref| on all of
    them; each net's call time (CUDA events) and profiler device time on
    those crops, and on seeded crops of the same count, beside its floor
    (crops read once and features written once, 4 bytes a value; conv1 +
    conv2 multiply-adds in 3xTF32 at the TF32 peak) and its bound at the
    f32 peak. The row keeps the call time: in a long process the profiler
    has summed K5's f32 grid below its bound (PERF.md §7), and a call time
    below the floor fails. Returns the line's text."""
    from vn_celeb_face_recognition_tpu_torch.ops import crops_net as K5

    gen = torch.Generator(device="cuda").manual_seed(13)
    parts, err = [], 0.0
    total = total_dev = total_floor = total_f32 = 0.0
    for net, spec, crops in trunks:
        seeded = (torch.rand(crops.shape, generator=gen, device="cuda")
                  - 0.5) * 2.0
        out = K5.crop_net_trunk(net, crops, spec)
        if crops.dtype != torch.float32 or out.dtype != torch.float32:
            fail(f"K5 at the CLI path: {spec.name} runs in {crops.dtype}")
        want = K5.crop_net_trunk_plain(net, crops, spec)
        scale = float(want.abs().max())
        e = check_close(torch, out, want, 1e-4, 1e-4 * scale,
                        f"K5 f32 at the CLI path, {spec.name}, "
                        f"{crops.shape[0]} crops")
        err = max(err, e)
        del want
        times = {}
        for what, x in (("the path's crops", crops), ("seeded crops",
                                                      seeded)):
            times[what] = (
                median_ms(torch, lambda x=x: K5.crop_net_trunk(net, x,
                                                               spec)),
                device_ms(torch, lambda x=x: K5.crop_net_trunk(net, x, spec),
                          KERNEL_GRIDS["crop_net_trunk"]))
        ms, dev_ms = times["the path's crops"]
        nbytes = (crops.numel() + out.numel()) * 4
        flops = crops.shape[0] * trunk_flops(spec)
        floor_ms, floor_by = bound_3xtf32(nbytes, flops)
        f32_ms, f32_by = bound(nbytes, flops, PEAK_F32)
        if ms < floor_ms:
            fail(f"K5 f32 at the CLI path: {spec.name} call {ms:.3f} ms is "
                 f"under its 3xtf32 floor {floor_ms:.3f} ms")
        total, total_dev = total + ms, total_dev + dev_ms
        total_floor, total_f32 = total_floor + floor_ms, total_f32 + f32_ms
        parts.append(f"{spec.name} {crops.shape[0]} crops: max abs err "
                     f"{e:.3e} vs plain f32 (max|ref| {scale:.3e}; 1e-4 x "
                     f"max|ref|); " + ", ".join(
                         f"{what} {c:.3f} ms (profiler {d:.3f} ms)"
                         for what, (c, d) in times.items())
                     + f"; 3xtf32 floor {floor_ms:.3f} ms ({floor_by}), "
                     f"f32-peak bound {f32_ms:.3f} ms ({f32_by}; "
                     f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    results["crop_net_trunk"]["f32_cli"] = dict(
        ms=total, device_ms=total_dev, bound_ms=total_floor,
        bound_f32_peak_ms=total_f32, max_abs_err=err)
    return (f"K5's f32 grid (3xTF32) at this path's crops of a chunk run "
            f"(call: CUDA events around the wrapper call, median of 20; "
            f"profiler: device time, mean per call): " + "; ".join(parts)
            + f"; both {total:.3f} ms a call on the path's crops (profiler "
            f"{total_dev:.3f} ms) against a 3xtf32 floor of "
            f"{total_floor:.3f} ms (f32-peak bound {total_f32:.3f} ms)")


def k8_f32_at(torch, kernels, emo, taken, card, results):
    """K8's f32 grid (3xTF32) on the emotion tails' inputs of one chunk of
    CLI path (b) (``taken``: layer name -> the NCHW output of the layer's
    first block, from a forward hook): held to the plain version in f32
    within 1e-4 of max|ref|, launches held by through_kernel, and timed:
    kernel device time (torch.profiler), the wrapper call (CUDA events)
    and the plain version (cuDNN, TF32 off), beside the 3xtf32 floor (x
    read and y written once a block, the weights once; the multiply-adds
    in 3xTF32 at the TF32 peak) and the bound at the f32 peak. A call time
    under the floor fails."""
    from vn_celeb_face_recognition_tpu_torch.ops import bottleneck as K8

    parts, row = [], {}
    tot = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, bound_ms=0.0,
               bound_f32_peak_ms=0.0, max_abs_err=0.0)
    for name, layer, c, p in (("l1", emo.layer1, 256, 64),
                              ("l2", emo.layer2, 512, 128)):
        blocks = list(layer)[1:]
        x = taken[name].permute(0, 2, 3, 1)  # as _trunk hands it to K8
        k, side = int(x.shape[0]), int(x.shape[1])
        if x.dtype != torch.float32 or x.shape[-1] != c:
            fail(f"K8 f32 at CLI (b) {name}: the tail's input is {x.dtype} "
                 f"{tuple(x.shape)}")
        got = through_kernel(kernels, "bottleneck_chain",
                             lambda: K8.bottleneck_chain(blocks, x),
                             launches=3 * len(blocks))
        want = K8.bottleneck_chain_plain(blocks, x)
        scale = float(want.abs().max())
        e = check_close(torch, got, want, 1e-4, 1e-4 * scale,
                        f"K8 f32 at CLI (b) {name}")
        del got, want
        t_k, t_call, t_p = timed(
            torch, "bottleneck_chain",
            lambda: K8.bottleneck_chain(blocks, x),
            lambda: K8.bottleneck_chain_plain(blocks, x))
        pix = k * side * side
        flops = len(blocks) * pix * 2 * (2 * c * p + 9 * p * p)
        nbytes = len(blocks) * (2 * pix * c + 2 * c * p + 9 * p * p) * 4
        floor_ms, floor_by = bound_3xtf32(nbytes, flops)
        f32_ms, f32_by = bound(nbytes, flops, PEAK_F32)
        if t_call < floor_ms:
            fail(f"K8 f32 at CLI (b) {name}: call {t_call:.3f} ms is under "
                 f"its 3xtf32 floor {floor_ms:.3f} ms")
        row[name] = dict(k=k, side=side, max_abs_err=e, ms=t_k,
                         call_ms=t_call, plain_ms=t_p, bound_ms=floor_ms,
                         bound_by=floor_by, bound_f32_peak_ms=f32_ms)
        for key, v in (("ms", t_k), ("call_ms", t_call), ("plain_ms", t_p),
                       ("bound_ms", floor_ms), ("bound_f32_peak_ms", f32_ms)):
            tot[key] += v
        tot["max_abs_err"] = max(tot["max_abs_err"], e)
        parts.append(
            f"{name} K={k} C={c} {side}x{side} {len(blocks)} blocks: max "
            f"abs err {e:.3e} vs plain f32 (max|ref| {scale:.3e}; 1e-4 x "
            f"max|ref|); kernel "
            f"{t_k:.3f} ms ({flops / t_k / 1e9:.1f} TFLOP/s), call "
            f"{t_call:.3f} ms, plain (cuDNN, TF32 off) {t_p:.3f} ms; 3xtf32 "
            f"floor {floor_ms:.3f} ms ({floor_by}), f32-peak bound "
            f"{f32_ms:.3f} ms ({f32_by}; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
    results["bottleneck_chain"]["f32_cli"] = dict(tot, **row)
    phase("cli-k8-f32", "bottleneck_chain f32 (3xTF32) on the emotion "
          "tails' own inputs of a CLI (b) chunk, 3 launches a block: "
          + "; ".join(parts) + f"; both tails {tot['ms']:.3f} ms (call "
          f"{tot['call_ms']:.3f} ms), plain {tot['plain_ms']:.3f} ms, "
          f"3xtf32 floor {tot['bound_ms']:.3f} ms, f32-peak bound "
          f"{tot['bound_f32_peak_ms']:.3f} ms ({TIMING}; {card})")


def face_batch(torch, n, size):
    """``n`` standardised faces of ``size`` px, NCHW f32: the repo's face
    crops resized, in turn."""
    from vn_celeb_face_recognition_tpu_torch.utils.frames import (
        face_files,
        read_png,
        resize_bilinear,
    )

    files = face_files()
    faces = np.stack([resize_bilinear(read_png(files[i % len(files)]),
                                      (size, size)) for i in range(n)])
    x = (faces.astype(np.float32) - 127.5) / 128.0
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def se_flops(torch, size):
    """FLOP of one face through resnet101 at ``size`` px (two a
    multiply-add), by torch.utils.flop_counter on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from vn_celeb_face_recognition_tpu_torch.models import ResNetSE

    with torch.device("meta"):
        net = ResNetSE().eval()
        x = torch.zeros((1, 3, size, size))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(x)
    return counter.get_total_flops()


def phase_se_ir(torch, kernels, K1, dev, card, results):
    """27. The SE-IR encoder and ArcMargin. ``se-ir``: build_model
    ("resnet101") with the shipped aug config's arguments (cp_path
    insight-face-v3.pt is absent: seeded), full depth (3, 4, 23, 3), on
    SE_BATCH faces of 112 px in f32 (TF32 off): median ms a batch (CUDA
    events), faces/s, TFLOP/s at the counted FLOP beside the f32 bound;
    the card against the CPU on 2 faces (cosine >= 0.999).
    ``se-ir-train``: cli.train.main on a copy of
    cfg/train_cfg_aug_emb_classify.json with chosen_idx_enc 1 (resnet101,
    frozen) and encoder_img_size 112 on phase 23's seeded 112 px faces,
    epochs cut to SE_EPOCHS: exactly one K1 launch a step, median ms a
    step, images/s over the median epoch wall, the busy share of one
    profiled epoch, the encoder unchanged. ``arcmargin``: ArcMarginModel
    at ARC_CLASSES classes on SE_BATCH embeddings, card against CPU within
    1e-4 x margin_s, both margin rules."""
    from vn_celeb_face_recognition_tpu_torch.models import (
        ArcMarginModel,
        build_model,
    )

    enc_args = read_json("cfg", "train_cfg_aug_emb_classify.json")[
        "trainer"]["encoders"][1]
    enc = build_model(enc_args["name"], **enc_args["args"]).to(dev)
    x = face_batch(torch, SE_BATCH, 112).to(dev)
    with torch.no_grad():
        emb = enc(x)
        ms = median_ms(torch, lambda: enc(x), runs=SE_RUNS, warmup=2)
    flops = se_flops(torch, 112) * SE_BATCH
    bound_ms = flops / PEAK_F32 * 1e3
    enc_cpu = copy.deepcopy(enc).cpu()
    with torch.no_grad():
        e_cpu = enc_cpu(x[:2].cpu())
    cos = float(torch.nn.functional.cosine_similarity(
        emb[:2].cpu(), e_cpu, dim=-1).min())
    norms = emb.norm(dim=-1)
    phase("se-ir", f"resnet101 (SE-IR, {enc_args['args']}; no file at "
          f"cp_path: seeded), layers (3, 4, 23, 3), fc {enc.fc.in_features}"
          f" -> 512, on {SE_BATCH} faces of 112 px, f32, TF32 "
          f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'}: median "
          f"{ms:.2f} ms a batch (CUDA events, {SE_RUNS} runs), "
          f"{SE_BATCH / ms * 1e3:.1f} faces/s, {flops / 1e9:.1f} GFLOP a "
          f"batch = {flops / ms / 1e9:.1f} TFLOP/s, f32 bound "
          f"{bound_ms:.2f} ms (operations, {PEAK_F32 / 1e12:.0f} TFLOP/s); "
          f"embedding norms {float(norms.min()):.6f}-"
          f"{float(norms.max()):.6f}; card vs CPU on 2 faces: min cosine "
          f"{cos:.6f} (>= 0.999) ({card})")
    if cos < 0.999 or not bool(torch.isfinite(emb).all()):
        fail("se-ir: card vs CPU outside tolerance")

    # ArcMargin on these embeddings: both margin rules, card vs CPU
    gen = torch.Generator().manual_seed(6)
    labels = torch.randint(0, ARC_CLASSES, (SE_BATCH,), generator=gen)
    parts = []
    for easy in (False, True):
        arc = ArcMarginModel(ARC_CLASSES, easy_margin=easy)
        with torch.no_grad():
            want = arc(emb.cpu(), labels)
            got = arc.to(dev)(emb, labels.to(dev)).cpu()
        err = float((got - want).abs().max())
        parts.append(f"easy_margin={easy}: max abs diff {err:.2e}")
        if err > 1e-4 * arc.margin_s or not bool(torch.isfinite(got).all()):
            fail(f"arcmargin card vs CPU: {parts[-1]} (atol "
                 f"{1e-4 * arc.margin_s:.1e})")
    phase("arcmargin", f"ArcMarginModel({ARC_CLASSES}, 512, m 0.5, s 64) on "
          f"the {SE_BATCH} resnet101 embeddings, card vs CPU f32: "
          + "; ".join(parts) + f" (atol 1e-4 x margin_s) ({card})")
    del enc, enc_cpu
    torch.cuda.empty_cache()

    with scratch("se_ir_smoke_") as work:
        se_ir_trainer(torch, kernels, dev, card, results, work)


def se_ir_trainer(torch, kernels, dev, card, results, work):
    """Phase 27's ``se-ir-train`` line."""
    import logging

    from vn_celeb_face_recognition_tpu_torch.cli import train as cli_train
    from vn_celeb_face_recognition_tpu_torch.training import trainer as TR

    img_dir = face_dataset(work)
    cfg = read_json("cfg", "train_cfg_aug_emb_classify.json")
    for split, manifest in (("train_dataset", "train.json"),
                            ("val_dataset", "val.json")):
        cfg[split]["args"] = {"data_dir": img_dir,
                              "label_file": os.path.join(work, manifest)}
    cfg["transforms"]["encoder_img_size"] = 112
    cfg["trainer"].update(chosen_idx_enc=1, epochs=SE_EPOCHS,
                          save_dir=os.path.join(work, "saved"))
    path = write_config(cfg, work, "train_se.json")
    log = open(os.path.join(work, "trainer.log"), "w")
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with train_probes(torch, TR) as rec, contextlib.redirect_stdout(log):
            trainer = cli_train.main(["-c", path])
        counts = kernels.launch_counts()
        steps = len(trainer.train_loader) * SE_EPOCHS
        check_line_counts(counts, {"similarity_warp": 1}, steps,
                          "se-ir train", results)
        ms = step_ms(rec)
        losses = [lg["neg_log_llhood"] for _, _, lg in rec["epochs"]]
        if len(ms) != steps or not all(np.isfinite(losses)):
            fail(f"se-ir train: {len(ms)} steps, losses {losses}")
        enc = trainer.encoder
        snapshot = {k: v.clone() for k, v in enc.state_dict().items()}
        walls = [s for _, s, _ in rec["epochs"]]
        with train_probes(torch, TR) as rec2, \
                contextlib.redirect_stdout(log):
            trainer._train_epoch(SE_EPOCHS + 1)
        walls += [s for _, s, _ in rec2["epochs"]]
        ms += step_ms(rec2)
        with contextlib.redirect_stdout(log):
            busy, top = busy_ms(torch, lambda: trainer._train_epoch(
                SE_EPOCHS + 2))
    finally:
        root = logging.getLogger()
        for handler in list(root.handlers):
            root.removeHandler(handler)
            handler.close()
        log.close()
    ms = sorted(ms)
    rate, epoch_s = train_rate(len(trainer.train_loader.dataset), walls)
    changed = [k for k, v in enc.state_dict().items()
               if not torch.equal(v, snapshot[k])]
    if (changed or enc.training or type(enc).__name__ != "ResNetSE"
            or any(p.requires_grad for p in enc.parameters())):
        fail(f"se-ir train: the encoder is not the frozen ResNetSE "
             f"({type(enc).__name__}, changed {changed[:3]})")
    phase("se-ir-train", f"cfg/train_cfg_aug_emb_classify.json through "
          f"cli.train.main on the card with chosen_idx_enc 1: facenet_aug "
          f"(K1) -> resnet101 (f32, TF32 off, seeded, frozen, fc "
          f"{enc.fc.in_features} -> 512) -> MLP 512-2048-1001, batch "
          f"{trainer.train_loader.batch_size}, {AUG_CLASSES} classes x "
          f"{AUG_PER_CLASS - AUG_VAL} train 112 px faces; cut: epochs 1000 "
          f"-> {SE_EPOCHS}, encoder_img_size 160 -> 112. {rate:.1f} train "
          f"images/s over the median epoch wall {epoch_s:.3f} s (epochs "
          f"{', '.join(f'{s:.3f}' for s in walls)} s); median step "
          f"{ms[len(ms) // 2]:.2f} ms (CUDA events, {len(ms)} steps; min "
          f"{ms[0]:.2f}, max {ms[-1]:.2f}); train loss "
          f"{', '.join(f'{v:.4g}' for v in losses)}; one profiled epoch: "
          f"device busy {busy:.1f} ms = {busy / 1e3 / epoch_s:.1%} of the "
          f"median epoch wall (top: {top}); launches {counts} = one K1 a "
          f"step; encoder unchanged ({card})")


# phase 28 (re50): the library's RetinaFace flow with a cfg_re50 detector
RE50_CUT = {"keep_top_k": FACES_PER_FRAME}
RE50_OFFSET_SCALE = 0.01


def shrink_re50_offsets(torch, net):
    """Scale the box and landmark heads of a seeded RetinaFace net by
    RE50_OFFSET_SCALE. With the JAX package's init (lecun-normal, identity
    BatchNorm) a re50's offsets reach ~100, so its decoded boxes lie
    thousands of px off the frame and the library keeps none; scaled, they
    lie near their priors, inside the frame, as a fitted net's do."""
    with torch.no_grad():
        for head in (net.BboxHead, net.LandmarkHead):
            for p in head.parameters():
                p.mul_(RE50_OFFSET_SCALE)
    return net


def re50_flops(torch):
    """FLOP of one 640 px frame through the re50 net (two a multiply-add),
    by torch.utils.flop_counter on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from vn_celeb_face_recognition_tpu_torch.models.retinaface import (
        RetinaFaceNet,
        cfg_re50,
    )

    with torch.device("meta"):
        net = RetinaFaceNet(torch.float32, cfg_re50).eval()
        x = torch.zeros((1, SIZE, SIZE, 3), dtype=torch.uint8)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(x)
    return counter.get_total_flops()


def phase_re50(torch, kernels, dev, card, results):
    """28. RetinaFace cfg_re50 through the recognition library: a
    detection JSON written to a temp dir from cfg/detection/
    retina_face.json with backbone_cfg cfg_re50 and no weights_path (the
    net is seeded, its offsets shrunk by shrink_re50_offsets; the repo has
    no fitted re50 weights) and keep_top_k cut 750 -> 4 (the faces each frame holds: seeded scores pass
    vis_thres 0.6 at hundreds of anchors a frame); REC_FRAMES frames of
    640 px through parallel_detect_and_align, then recognize_celeb
    (iresnet100 + MLP 1020, the per-class thresholds), f32, TF32 off:
    launches exact a call (K3 once, K1's windows form once; K6 never),
    median host ms a call over REC_CALLS calls and stage means, the busy
    share of one profiled call; the net alone, TF32 off and on, beside
    its bound; the seeded net's head outputs (offsets not shrunk) on 2
    frames, card against CPU, within rtol 1e-3 and atol 1e-3 (the JAX
    package's re50 test's), with the count beyond atol 1e-4 shown."""
    from vn_celeb_face_recognition_tpu_torch import pipeline
    from vn_celeb_face_recognition_tpu_torch.models import (
        build_detector,
        build_model,
    )
    from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames
    from vn_celeb_face_recognition_tpu_torch.utils.tracing import StageTimer

    with scratch("re50_smoke_") as work:
        cfg = read_json("cfg", "detection", "retina_face.json")
        del cfg["weights_path"]
        cfg.update(backbone_cfg="cfg_re50", **RE50_CUT)
        with open(write_config(cfg, work, "retina_face_re50.json")) as fp:
            cfg = json.load(fp)
    t0 = time.perf_counter()
    det = build_detector("RetinaFace", device=dev, **cfg)
    shrink_re50_offsets(torch, det.net)
    build_s = time.perf_counter() - t0
    enc = pipeline.Encoder(build_model("iresnet100"), device=dev)
    clf = pipeline.Classifier(build_model(
        "MLPModel", input_dim=512, num_classes=PROD_CLASSES), device=dev)
    names, thresholds, _ = name_tables()
    tpl, fs = pipeline.center_point_dict["(112, 112)"], (112, 112)
    imgs = list(build_frames(REC_FRAMES, SIZE, FACES_PER_FRAME))

    def flow(timer=None):
        faces, boxes = pipeline.parallel_detect_and_align(
            imgs, det, tpl, fs, timer=timer)
        return faces, boxes, pipeline.recognize_celeb(
            faces, None, enc, clf, None, names, thresholds, timer=timer)

    flow()
    torch.cuda.synchronize()
    timer = StageTimer()
    kernels.reset_launch_counts()
    times = []
    for _ in range(REC_CALLS):
        t0 = time.perf_counter()
        faces, boxes, got_names = flow(timer)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    check_line_counts(counts, {"nms_keep_mask": 1, "similarity_warp": 1},
                      REC_CALLS, "re50 library", results)
    per_frame = [len(f) for f in faces]
    if not sum(per_frame) or any(len(n) != len(f) for n, f in
                                 zip(got_names, faces)):
        fail(f"re50 library: faces per frame {per_frame}")
    median = sorted(times)[len(times) // 2] * 1e3
    stages = ", ".join(f"{name} {st['mean_ms']:.2f}"
                       for name, st in timer.report().items())
    busy, top = busy_ms(torch, flow)
    phase("re50", f"RetinaFace cfg_re50 (seeded as the JAX package inits it, offset "
          f"heads x {RE50_OFFSET_SCALE}, "
          f"built in {build_s:.2f} s; JSON cut {RE50_CUT}) -> "
          f"parallel_detect_and_align -> recognize_celeb (iresnet100 + MLP "
          f"{PROD_CLASSES}) on {REC_FRAMES} frames of {SIZE} px, f32, TF32 "
          f"off: median {median:.2f} ms a call (host clock, {REC_CALLS} "
          f"calls; stage means ms: {stages}); one profiled call: device "
          f"busy {busy:.2f} ms = {busy / median:.1%} of the median (top: "
          f"{top}); faces per frame {per_frame}; launches "
          f"{({k: n for k, n in counts.items() if n})} = K3 and K1 once a "
          f"call ({card})")

    # the net alone on the call's frames, TF32 off (the gates') and on
    # (PyTorch's default, what a user runs)
    frames = torch.from_numpy(np.stack(imgs)).to(dev)
    flops = re50_flops(torch) * len(imgs)
    nets = []
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            with torch.no_grad():
                ms = median_ms(torch, lambda: det.net(frames), runs=10,
                               warmup=2)
                busy, top = busy_ms(torch, lambda: det.net(frames))
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        peak = PEAK_TF32 if tf32 else PEAK_F32
        nets.append(f"TF32 {'on' if tf32 else 'off'}: {ms:.2f} ms (CUDA "
                    f"events, median of 10), {flops / ms / 1e9:.1f} TFLOP/s, "
                    f"bound {flops / peak * 1e3:.2f} ms (operations), device "
                    f"{busy:.2f} ms (top: {top})")
    phase("re50-net", f"the re50 net alone on the call's {len(imgs)} frames "
          f"of {SIZE} px, f32, {flops / 1e9:.1f} GFLOP: " + "; ".join(nets)
          + f" ({card})")

    # the JSON's net as built, offsets not shrunk, on both devices
    det_cpu = build_detector("RetinaFace", device="cpu", **cfg)
    net_gpu = copy.deepcopy(det_cpu.net).to(dev)
    two = torch.from_numpy(np.stack(imgs[:2]))
    with torch.no_grad():
        gpu = [t.cpu() for t in net_gpu(two.to(dev))]
        cpu = det_cpu.net(two)
    parts = []
    for what, g, c in zip(("loc", "conf", "landmarks"), gpu, cpu):
        err = check_close(torch, g, c, 1e-3, 1e-3, f"re50 card vs CPU {what}")
        beyond = int(((g - c).abs() > 1e-4 + 1e-3 * c.abs()).sum())
        parts.append(f"{what} {tuple(g.shape)} max abs diff {err:.2e}, "
                     f"{beyond} beyond atol 1e-4, max |value| "
                     f"{float(c.abs().max()):.3g}")
    phase("re50-card-vs-cpu", f"the seeded re50 net's head outputs (offsets "
          f"not shrunk) on 2 frames of {SIZE} px, f32, TF32 off, within rtol "
          f"1e-3 atol 1e-3: "
          + "; ".join(parts) + f" ({card})")


# phase 29 (detector-fit): cli.fit_detector at its full width (cfg_mnet,
# 640 px, batch 8, up to 6 faces a scene, AdamW + cosine from lr 1e-3),
# the steps cut 1500 -> FIT_STEPS with an evaluation every FIT_EVAL_EVERY
# and at the end; FIT_PROFILE_STEPS more steps after the export for the
# busy share; the card-vs-CPU step on FIT_GATE_BATCH scenes with SGD at
# FIT_GATE_LR. One evaluation calls conf_sparsity (K6's three segments)
# and detection_recall (K6's three, one NMS), each on synthetic and on
# bench frames; a train step launches no kernel.
FIT_STEPS, FIT_EVAL_EVERY, FIT_PROFILE_STEPS = 40, 20, 3
FIT_GATE_BATCH, FIT_GATE_LR = 2, 1e-3
FIT_CALL_LAUNCHES = {"conf_sparsity": {"mnet_stage1": 3},
                     "detection_recall": {"mnet_stage1": 3,
                                          "nms_keep_mask": 1}}
FIT_EVAL_LAUNCHES = {"mnet_stage1": 12, "nms_keep_mask": 2}


def launched_by(kernels, fn, want, what):
    """``fn()``, which must launch exactly ``want`` ({kernel: n}, every
    other kernel 0)."""
    before = kernels.launch_counts()
    out = fn()
    after = kernels.launch_counts()
    got = {k: after[k] - before[k] for k in after}
    full = {k: want.get(k, 0) for k in after}
    if got != full:
        fail(f"{what}: launches {got}, want {full}")
    return out


@contextlib.contextmanager
def fit_probes(torch, kernels, FD, rec):
    """Inside the block: the fit's host synth (``synth_batch``) timed on
    the host's clock; each train step timed with CUDA events, its
    launches held to none, the loop's end taken (synchronised) after the
    last; each evaluation call held to its exact launches and each
    evaluation timed on the host's clock (synchronised)."""
    def synth(orig):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            rec["synth"].append(time.perf_counter() - t0)
            rec.setdefault("start", t0)
            return out
        return wrapped

    def step(orig):
        def wrapped(self, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = launched_by(kernels, lambda: orig(self, batch), {},
                              "a fit train step")
            end.record()
            rec["steps"].append((start, end))
            if len(rec["steps"]) == self.args.steps:
                torch.cuda.synchronize()
                rec["end"] = time.perf_counter()
            return out
        return wrapped

    def evaluate(orig):
        def wrapped(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_synth = len(rec["synth"])
            out = launched_by(kernels, lambda: orig(self), FIT_EVAL_LAUNCHES,
                              "a fit evaluation")
            del rec["synth"][n_synth:]  # the evaluation scenes' draw
            torch.cuda.synchronize()
            rec["evals"].append((t0, time.perf_counter() - t0))
            return out
        return wrapped

    def counted(name, orig):
        def wrapped(*args, **kw):
            return launched_by(kernels, lambda: orig(*args, **kw),
                               FIT_CALL_LAUNCHES[name], name)
        return wrapped

    saved = {n: getattr(FD, n) for n in ("synth_batch", *FIT_CALL_LAUNCHES)}
    FD.synth_batch = synth(saved["synth_batch"])
    for n in FIT_CALL_LAUNCHES:
        setattr(FD, n, counted(n, saved[n]))
    try:
        with patched(FD.DetectorFit, "train_step", step), \
                patched(FD.DetectorFit, "evaluate", evaluate):
            yield
    finally:
        for n, f in saved.items():
            setattr(FD, n, f)


def phase_fit(torch, kernels, K6, dev, card, results):
    """29. Detector training through ``cli.fit_detector.main`` at the
    tool's full width (cfg_mnet seeded from --seed 0, 640 px, batch 8, up
    to 6 faces a scene, AdamW + optax's cosine decay from lr 1e-3, wd
    5e-4, f32, the vendored landmark cache), the steps cut 1500 ->
    FIT_STEPS with --eval_every FIT_EVAL_EVERY, TF32 as PyTorch leaves it
    (cuDNN on, matmul off), as a user runs it. ``fit``: every loss
    finite, the mean of the last 10 below the first, every BatchNorm's
    running statistics moved, no launch in a train step and exact
    launches in each evaluation call (counted); median ms a step (CUDA
    events) and of the host synth, images/s over the training loop, the
    busy share of a profiled step, peak memory. ``fit-export``: the npz
    written, loaded by RetinaFace(weights_path=...), gives detect_padded
    outputs equal to the trained net's in eval mode. ``fit-k6``: after
    the profiled steps (AdamW and running-statistic writes since the last
    evaluation folded K6's weights), K6 on the stage-1 modules against
    mnet_stage1_plain in eval mode: f32 at 1e-4 and bf16 by check_bf16,
    phase 15's gates. ``fit-card-vs-cpu``, TF32 off: one SGD step from
    the fitted state on the same FIT_GATE_BATCH scenes of 640 px, the card
    in f32 against the CPU in f64: losses within rtol 1e-4, parameters and
    BatchNorm statistics within 1e-3 (relative above 1), the CPU's f32
    step shown beside. ``fit-probe``:
    probe_crop_landmarks on data/'s 20 crops on the card, K2-K5 launches
    exact per detect call, the points within 0.5 px of
    meta_data/crop_landmarks.npz and of the CPU probe, with the same
    template fallbacks."""
    from vn_celeb_face_recognition_tpu_torch.cli import fit_detector as FD

    with scratch("fit_smoke_") as work:
        fit = fit_line(torch, kernels, FD, dev, card, results, work)
        fit_k6(torch, K6, fit, card, results)
        fit_card_vs_cpu(torch, fit, dev, card)
        fit_probe(torch, kernels, fit, dev, card, results)


def fit_line(torch, kernels, FD, dev, card, results, work):
    """Phase 29's ``fit`` and ``fit-export`` lines; returns the fit."""
    out = os.path.join(work, "retinaface_fit.npz")
    rec = {"synth": [], "steps": [], "evals": []}
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        with open(os.path.join(work, "fit.log"), "w") as log:
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            with fit_probes(torch, kernels, FD, rec), \
                    contextlib.redirect_stdout(log):
                res = FD.main(["--steps", str(FIT_STEPS), "--eval_every",
                               str(FIT_EVAL_EVERY), "--out", out])
            counts = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
        fit = res["fit"]
        args = fit.args
        n_evals = len(res["evals"])
        want = {k: FIT_EVAL_LAUNCHES.get(k, 0) * n_evals for k in counts}
        if n_evals != FIT_STEPS // FIT_EVAL_EVERY or counts != want:
            fail(f"fit: {n_evals} evaluations, launches {counts}, want "
                 f"{want}")
        for k, n in counts.items():
            if n:
                results[k]["launches"] = results[k].get("launches", 0) + n
                results[k]["fit_launches"] = n
        losses = res["losses"]
        loss = losses["loss"]
        moved = [bool((m.running_mean != 0).any()
                      and (m.running_var != 1).any())
                 for m in fit.net.modules()
                 if isinstance(m, torch.nn.BatchNorm2d)]
        if not all(np.isfinite(v).all() for v in losses.values()):
            fail(f"fit: non-finite losses {losses}")
        if not loss[-10:].mean() < loss[0] or not all(moved):
            fail(f"fit: losses {loss.tolist()}; BatchNorm statistics moved "
                 f"in {sum(moved)} of {len(moved)} layers")
        step_ms = sorted(s.elapsed_time(e) for s, e in rec["steps"])
        synth_ms = sorted(t * 1e3 for t in rec["synth"])
        in_loop = sum(d for t0, d in rec["evals"] if t0 < rec["end"])
        loop_s = rec["end"] - rec["start"] - in_loop
        rate = FIT_STEPS * args.batch / loop_s
        export = fit_export(torch, FD, fit, out, dev)

        # the busy share of a step as the loop runs it (synth included)
        def one_step():
            launched_by(kernels, lambda: fit.train_step(fit.batch()), {},
                        "a profiled fit step")

        walls = []
        for _ in range(FIT_PROFILE_STEPS - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        busy, top = busy_ms(torch, one_step)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    wall = sorted(walls)[len(walls) // 2]
    evals = "; ".join(
        f"step {i}: synth sparsity {s:.1f} anchors/frame, recall {r:.3f}, "
        f"bench sparsity {bs:.1f}, recall {br:.3f}"
        for i, (s, r, bs, br) in res["evals"])
    eval_s = ", ".join(f"{d:.2f}" for _, d in rec["evals"])
    launched = {k: n for k, n in counts.items() if n}
    phase("fit", f"cli.fit_detector.main: RetinaFace cfg_mnet from seed "
          f"{args.seed}, {args.batch} scenes of {args.size} px a step (up to "
          f"{args.max_faces} faces), AdamW + cosine from lr {args.lr}, f32, "
          f"steps cut 1500 -> {FIT_STEPS}, --eval_every {FIT_EVAL_EVERY}; "
          f"TF32: cuDNN on, matmul off (PyTorch's default): loss "
          f"{loss[0]:.4f} at step 0 -> {loss[-10:].mean():.4f} mean of the "
          f"last 10 (loc {losses['loss_loc'][-10:].mean():.4f}, conf "
          f"{losses['loss_conf'][-10:].mean():.4f}, landm "
          f"{losses['loss_landm'][-10:].mean():.4f}); BatchNorm statistics "
          f"moved in all {len(moved)} layers; evaluations: {evals}; median "
          f"step {step_ms[len(step_ms) // 2]:.2f} ms (CUDA events around "
          f"train_step; min {step_ms[0]:.2f}, max {step_ms[-1]:.2f}), median "
          f"host synth {synth_ms[len(synth_ms) // 2]:.2f} ms a batch (host "
          f"clock); {rate:.1f} images/s over the training loop "
          f"({loop_s:.2f} s for {FIT_STEPS} steps, evaluations left out); "
          f"evaluations {eval_s} s; one profiled step (synth + train_step, "
          f"TF32 as above): device busy {busy:.2f} ms = {busy / wall:.1%} "
          f"of its {wall:.2f} ms wall (median of {len(walls)}; top: {top}); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; launches "
          f"{launched} = {n_evals} evaluations x {FIT_EVAL_LAUNCHES}, 0 in "
          f"each of {len(rec['steps'])} train steps ({card})")
    phase("fit-export", export + f" ({card})")
    return fit


def fit_export(torch, FD, fit, out, dev):
    """The npz the fit wrote, loaded by RetinaFace(weights_path=...), must
    give the trained net's detect_padded outputs on the evaluation
    scenes; returns the ``fit-export`` line."""
    from vn_celeb_face_recognition_tpu_torch.models import RetinaFace
    from vn_celeb_face_recognition_tpu_torch.training.detector import (
        evaluating,
    )

    args = fit.args
    frames = torch.from_numpy(fit.eval_sets()[0][0]).to(dev)
    loaded = RetinaFace(backbone_cfg="cfg_mnet", weights_path=out,
                        device=dev)
    with evaluating(fit.net):
        want = fit.rf.detect_padded(frames)
    got = loaded.detect_padded(frames)
    diffs = [float((g.float() - w.float()).abs().max())
             for g, w in zip(got, want)]
    with np.load(out) as z:
        keys = len(z.files)
    line = (f"{os.path.basename(out)} ({os.path.getsize(out) / 1e6:.2f} MB, "
            f"{keys} keys) through RetinaFace(weights_path=...) on the "
            f"{FD.EVAL_BATCH} evaluation scenes of {args.size} px: "
            f"detect_padded boxes, scores, points, valid max abs diff "
            f"{diffs} against the trained net in eval mode "
            f"({int(want[3].sum())} faces kept; want torch.equal)")
    if keys != 253 or not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"fit-export: {line}")
    return line


def fit_k6(torch, K6, fit, card, results):
    """Phase 29's ``fit-k6`` line: K6's cached fold after training, and
    its f32 grid (what the fit's evaluations launch) timed at their shape
    against its plain version and bound."""
    from vn_celeb_face_recognition_tpu_torch.models.retinaface import (
        CHANNELS_SUBTRACT,
    )

    args = fit.args
    stage1 = fit.net.body.stage1
    frames = fit.batch()[0]
    fit.net.eval()
    try:
        got32 = K6.mnet_stage1(stage1, frames, CHANNELS_SUBTRACT,
                               torch.float32)
        want32 = K6.mnet_stage1_plain(stage1, frames, CHANNELS_SUBTRACT,
                                      torch.float32)
        err32 = check_close(torch, got32, want32, 1e-4, 1e-4,
                            "fit-k6 f32")
        got16 = K6.mnet_stage1(stage1, frames, CHANNELS_SUBTRACT,
                               torch.bfloat16)
        _, rel, rel_max, plain16 = check_bf16(
            torch, got16, want32, K6.mnet_stage1_plain(
                stage1, frames, CHANNELS_SUBTRACT, torch.bfloat16),
            "fit-k6 bf16")
        ms, call_ms, plain_ms = timed(
            torch, "mnet_stage1",
            lambda: K6.mnet_stage1(stage1, frames, CHANNELS_SUBTRACT,
                                   torch.float32),
            lambda: K6.mnet_stage1_plain(stage1, frames, CHANNELS_SUBTRACT,
                                         torch.float32))
    finally:
        fit.net.train()
    b = frames.shape[0]
    bound_ms, bound_by = bound(frames.numel() + got32.numel() * 4,
                               b * mnet_stage1_flops(args.size, args.size),
                               PEAK_F32)
    results["mnet_stage1"]["fit_f32"] = dict(
        ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by)
    phase("fit-k6", f"K6 on the fitted stage 1 after {FIT_PROFILE_STEPS} "
          f"more AdamW steps (the weights and running statistics written in "
          f"place since the last evaluation folded them) against "
          f"mnet_stage1_plain in eval mode on {args.batch}x{args.size}x"
          f"{args.size} scenes: f32 max abs err {err32:.3e} (rtol/atol "
          f"1e-4); bf16 rel L2 {rel:.2e}, max/max|ref| {rel_max:.2e} (plain "
          f"bf16 rel L2 {plain16:.2e}; gates {BF16_REL_L2}, {BF16_REL_MAX}); "
          f"the f32 grid the evaluations launch: kernel {ms:.3f} ms, call "
          f"{call_ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} "
          f"ms ({bound_by}, f32 peak) ({TIMING}; {card})")


def fit_card_vs_cpu(torch, fit, dev, card):
    """Phase 29's ``fit-card-vs-cpu`` line, TF32 off: one SGD step from
    the fitted state on the card in f32 against the same step on the CPU
    in f64 (the reference), and on the CPU in f32 beside them. The CPU's
    f32 step is the less exact of the two, its largest gaps in stage 1's
    BatchNorm parameters, whose statistics reduce 2 x 320 x 320 values a
    channel (``tools/torch_fit_precision.py`` measures both sides'
    gradients against f64)."""
    from vn_celeb_face_recognition_tpu_torch.models.retinaface import cfg_mnet
    from vn_celeb_face_recognition_tpu_torch.ops.boxes import make_priors
    from vn_celeb_face_recognition_tpu_torch.training.detector import (
        make_detection_train_step,
        synth_batch,
    )
    from vn_celeb_face_recognition_tpu_torch.utils import kernels

    args = fit.args
    frames, boxes, labels, landms, valid = synth_batch(
        np.random.default_rng(7), FIT_GATE_BATCH, args.size, fit.crops,
        fit.landmarks, max_faces=args.max_faces)
    priors = torch.from_numpy(make_priors(
        (args.size, args.size), cfg_mnet["min_sizes"], cfg_mnet["steps"],
        cfg_mnet["clip"]))
    runs = {}
    for label, where, dtype in (("card", dev, torch.float32),
                                ("cpu", torch.device("cpu"), torch.float32),
                                ("cpu64", torch.device("cpu"),
                                 torch.float64)):
        net = copy.deepcopy(fit.net).to(where, dtype).train()
        net.dtype = dtype
        kernels.forget_folds(net)
        step = make_detection_train_step(
            net, priors.to(where, dtype), tuple(cfg_mnet["variance"]),
            torch.optim.SGD(net.parameters(), lr=FIT_GATE_LR))
        t0 = time.perf_counter()
        losses = step(torch.from_numpy(frames).to(where),
                      torch.from_numpy(boxes).to(where, dtype),
                      torch.from_numpy(labels.astype(np.int64)).to(where),
                      torch.from_numpy(landms).to(where, dtype),
                      torch.from_numpy(valid).to(where))
        runs[label] = ({k: float(v) for k, v in losses.items()},
                       {k: v.detach().cpu().double() for k, v in
                        net.state_dict().items()
                        if not k.endswith("num_batches_tracked")},
                       time.perf_counter() - t0)

    def against_f64(label):
        (lg, sg, _), (lr, sr, _) = runs[label], runs["cpu64"]
        rel = max(abs(lg[k] - lr[k]) / abs(lr[k]) for k in lr)
        par = {k: float((sg[k] - sr[k]).abs().max()) for k in sr
               if ".running_" not in k}
        stats = max(float(((sg[k] - sr[k]).abs()
                           / sr[k].abs().clamp(min=1.0)).max())
                    for k in sr if ".running_" in k)
        worst = max(par, key=par.get)
        return rel, par[worst], worst, stats

    got, cpu32 = against_f64("card"), against_f64("cpu")
    phase("fit-card-vs-cpu", f"one SGD step (lr {FIT_GATE_LR}) from the "
          f"fitted state on {FIT_GATE_BATCH} scenes of {args.size} px, TF32 "
          f"off, the card in f32 against the CPU in f64: losses "
          + ", ".join(f"{k} {runs['card'][0][k]:.6f} / "
                      f"{runs['cpu64'][0][k]:.6f}" for k in runs["card"][0])
          + f" (max rel {got[0]:.2e}, gate 1e-4); parameters max abs diff "
          f"{got[1]:.2e} ({got[2]}; gate 1e-3); BatchNorm statistics "
          f"{got[3]:.2e} (relative above 1; gate 1e-3). The CPU in f32 "
          f"against f64, shown: losses {cpu32[0]:.2e}, parameters "
          f"{cpu32[1]:.2e} ({cpu32[2]}), statistics {cpu32[3]:.2e}. Step "
          f"wall {runs['card'][2]:.2f} / {runs['cpu'][2]:.2f} / "
          f"{runs['cpu64'][2]:.2f} s ({card})")
    if not (got[0] <= 1e-4 and got[1] <= 1e-3 and got[3] <= 1e-3):
        fail("fit card vs CPU outside tolerance")


def fit_probe(torch, kernels, fit, dev, card, results):
    """Phase 29's ``fit-probe`` line."""
    from vn_celeb_face_recognition_tpu_torch.training.detector import (
        probe_crop_landmarks,
        template_landmarks,
    )

    crops, cached = fit.crops, fit.landmarks
    n = len(crops)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = probe_crop_landmarks(crops, device=dev)
    probe_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check_line_counts(counts, DETECT_LAUNCHES, n, "fit-probe", results)
    cpu = probe_crop_landmarks(crops, device="cpu")

    def fallbacks(pts):
        return [i for i, (p, c) in enumerate(zip(pts, crops))
                if np.allclose(p, template_landmarks(c.shape[0]))]

    d_cache = float(np.abs(got - cached).max())
    d_cpu = float(np.abs(got - cpu).max())
    falls = [fallbacks(x) for x in (got, cpu, cached)]
    phase("fit-probe", f"probe_crop_landmarks (MTCNN min_face_size 40) on "
          f"data/'s {n} crops on the card in {probe_s:.2f} s (host clock): "
          f"launches {({k: v for k, v in counts.items() if v})} = "
          f"{DETECT_LAUNCHES} x {n} detect calls; points max abs diff "
          f"{d_cache:.2e} px to meta_data/crop_landmarks.npz and {d_cpu:.2e} "
          f"px to the CPU probe (gate 0.5); template fallbacks card / CPU / "
          f"cache {falls} ({card})")
    if d_cache > 0.5 or d_cpu > 0.5 or not falls[0] == falls[1] == falls[2]:
        fail("fit-probe outside tolerance")


def parallel_rank():
    """Phase 30 inside the one-rank NCCL group ``parallel.launch`` started
    (a process of its own: it builds its models and reads its own launch
    counters). Returns its numbers; the caller checks the gates."""
    t_enter = time.time()
    import torch
    import torch.distributed as dist

    from vn_celeb_face_recognition_tpu_torch.data.transforms import (
        transform_default,
    )
    from vn_celeb_face_recognition_tpu_torch.models import MLPModel
    from vn_celeb_face_recognition_tpu_torch.models.inception_resnet_v1 import (  # noqa: E501
        InceptionResnetV1,
    )
    from vn_celeb_face_recognition_tpu_torch.models.layers import seeded_init_
    from vn_celeb_face_recognition_tpu_torch.models.mtcnn import MTCNN
    from vn_celeb_face_recognition_tpu_torch.parallel import (
        make_dp_train_step,
        make_mesh,
    )
    from vn_celeb_face_recognition_tpu_torch.pipeline.engine import (
        FusedRecognitionEngine,
    )
    from vn_celeb_face_recognition_tpu_torch.training.optim import (
        make_optimizer,
    )
    from vn_celeb_face_recognition_tpu_torch.utils import kernels
    from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(device="cuda")
    dev = mesh.device
    out = {"t_enter": t_enter, "backend": dist.get_backend(),
           "world": dist.get_world_size(), "device": str(dev),
           "nccl": ".".join(str(v) for v in torch.cuda.nccl.version())}

    # ---- the DP x TP online-aug step at dryrun_multichip's shapes --------
    gen = np.random.default_rng(0)
    batch = {"data": gen.integers(0, 255, size=(8, 96, 96, 3)).astype(
                 np.float32),
             "target": gen.integers(0, 16, size=8).astype(np.int64),
             "weight": np.ones(8, dtype=np.float32)}
    steps = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        g = torch.Generator().manual_seed(0)
        enc = seeded_init_(InceptionResnetV1(), g).to(dev).eval()
        enc.requires_grad_(False)
        mlp = seeded_init_(MLPModel(512, 16), g).to(dev)
        opt = make_optimizer("Adam", {"lr": 1e-3, "weight_decay": 1e-4},
                             mlp.parameters())
        step, place_state, place_batch = make_dp_train_step(
            m, mlp, opt, encoder=enc, transform=transform_default)
        place_state(mlp, opt)
        placed = place_batch({k: torch.from_numpy(v).to(dev)
                              for k, v in batch.items()})
        draw = torch.Generator(device=dev).manual_seed(1)
        losses, ms = [], []
        for _ in range(2):  # the first warms cuDNN up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, metrics = step(placed, draw)
            losses.append(float(loss))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        steps[name] = (losses, [p.detach().clone() for p in mlp.parameters()],
                       ms)
    (pl, pw, pms), (ml, mw, mms) = steps["plain"], steps["mesh"]
    out["train"] = {
        "losses": ml, "plain_losses": pl, "ms": mms[1], "plain_ms": pms[1],
        "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(ml, pl)),
        "weights_close": all(torch.allclose(a, b, rtol=1e-5, atol=1e-7)
                             for a, b in zip(mw, pw)),
        "weights_max_diff": max(float((a - b).abs().max())
                                for a, b in zip(mw, pw))}
    del steps

    # ---- one chunk of the default line through the data mesh -----------
    det = MTCNN(dtype=torch.bfloat16, device=dev, **DETECTOR)
    g = torch.Generator().manual_seed(0)
    enc = seeded_init_(InceptionResnetV1(dtype=torch.bfloat16), g)
    clf = seeded_init_(MLPModel(512, N_CLASSES), g)
    frames = torch.from_numpy(build_frames(BATCH, SIZE, FACES_PER_FRAME)).to(
        dev)
    names = {label: f"celeb_{label}" for label in range(N_CLASSES)}
    engines = {m: FusedRecognitionEngine(
        det, enc, clf, target_fs=112, compute_dtype=torch.bfloat16,
        face_cap=FACE_BUCKETS, face_hint=BATCH * FACES_PER_FRAME,
        mesh=None if m == "plain" else mesh) for m in ("plain", "mesh")}
    outs, times, runs = {}, {"plain": [], "mesh": []}, [0]
    for m, engine in engines.items():  # warm-up
        engine.identify(engine.process_adaptive(frames), names, 0.5)
    process = engines["mesh"].process

    def counted(chunk):
        runs[0] += 1
        return process(chunk)

    engines["mesh"].process = counted
    for m in ("plain", "mesh", "mesh", "plain", "plain", "mesh"):
        engine = engines[m]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        runs[0] = 0
        t0 = time.perf_counter()
        res = engine.process_adaptive(frames)
        engine.identify(res, names, 0.5)
        torch.cuda.synchronize()
        times[m].append((time.perf_counter() - t0) * 1e3)
        if m not in outs:
            outs[m] = (res, kernels.launch_counts(), runs[0])
    (p, _, _), (q, counts, n_runs) = outs["plain"], outs["mesh"]
    v = p["valid"]
    e, r = q["embeddings"][v].float(), p["embeddings"][v].float()
    cos = (e * r).sum(-1) / (e.norm(dim=-1) * r.norm(dim=-1))
    out["engine"] = {
        "valid_equal": bool(torch.equal(q["valid"], v)),
        "pred_equal": bool(torch.equal(q["pred"][v], p["pred"][v])),
        "box_err": float((q["boxes"][v] - p["boxes"][v]).abs().max()),
        "cos_min": float(cos.min()), "faces": int(v.sum()),
        "bucket": q["_face_cap_used"], "counts": counts, "runs": n_runs,
        "ms": sorted(times["mesh"])[1], "plain_ms": sorted(times["plain"])[1]}
    return out


def phase_parallel(torch, card):
    """Phase 30: ``parallel_rank`` under ``parallel.launch(n_devices=1,
    device="cuda")``, its gates and its lines."""
    from vn_celeb_face_recognition_tpu_torch.parallel import launch

    t0 = time.time()
    r = launch(parallel_rank, 1, "cuda", timeout=300)
    wall = time.time() - t0
    if r["backend"] != "nccl" or r["world"] != 1:
        fail(f"parallel: expected a one-rank NCCL group, got {r['backend']} "
             f"world {r['world']}")
    phase("parallel", f"parallel.launch(n_devices=1, device='cuda'): one "
          f"rank, {r['backend']} (NCCL {r['nccl']}) on {r['device']}; the "
          f"function started {r['t_enter'] - t0:.1f} s after the launch "
          f"call (spawn, imports, group init), the launch took {wall:.1f} s "
          f"({card})")
    t = r["train"]
    phase("parallel-train", f"make_dp_train_step on the (1, 1) mesh, "
          f"InceptionResnetV1 f32 96 px frozen + MLP 16 (dropout 0.5, Adam), "
          f"8 images: losses {t['losses']} against {t['plain_losses']} "
          f"without the mesh (max rel diff {t['loss_rel']:.2e}), weights max "
          f"diff {t['weights_max_diff']:.2e}; the second step "
          f"{t['ms']:.2f} ms on the mesh, {t['plain_ms']:.2f} ms without "
          f"(host clock, synchronised; {card})")
    if t["loss_rel"] > 1e-5 or not t["weights_close"]:
        fail("parallel-train: the mesh step differs from the plain step")
    e = r["engine"]
    want = {k: MTCNN_LINE_LAUNCHES.get(k, 0) * e["runs"]
            for k in e["counts"]}
    phase("parallel-engine", f"the default line's chunk ({BATCH}x{SIZE}x"
          f"{SIZE}, bf16, bucket {e['bucket']}, {e['faces']} valid faces) "
          f"on the data mesh against the engine without one: valid equal "
          f"{e['valid_equal']}, predictions equal {e['pred_equal']}, boxes "
          f"max diff {e['box_err']:.2e} px, embedding cosine min "
          f"{e['cos_min']:.6f}; launches {e['counts']} in {e['runs']} "
          f"process run(s) of the mesh chunk; median of 3 chunks "
          f"(host clock incl. identify) {e['ms']:.2f} ms on the mesh, "
          f"{e['plain_ms']:.2f} ms without ({card})")
    if not (e["valid_equal"] and e["pred_equal"]) or e["box_err"] > 1e-4 \
            or e["cos_min"] < 0.9999:
        fail("parallel-engine: the mesh chunk differs from the plain chunk")
    if e["counts"] != want:
        fail(f"parallel-engine: launches {e['counts']}, want {want}")


# phase 31 (rest): the default line's chunk through an engine whose MTCNN
# reads a weights_dir of .pt files and whose emotion head (690 tags, 128
# projections) runs at REST_EMOTION_SIZE; REST_CHUNKS timed chunks
REST_EMOTION_SIZE, REST_PROJECTIONS, REST_CHUNKS = 64, 128, 3
# align_faces_batch card vs CPU, and each f32 side vs the f64 reference:
# f32 rounding of a source coordinate near 640 px (6e-5 px an ulp) times
# an intensity step of up to 255 a pixel; each side measured 1.4e-2 to
# 1.7e-2 from f64 on the card's run of this phase, card vs CPU 1.95e-2
ALIGN_ATOL = 0.05


def emotion_engine_card_vs_cpu(torch, engine_cls, mtcnn_cls, models,
                               models_cpu, two, size, dev):
    """The engine with the emotion head at ``emotion_size`` ``size`` in f32
    on the card and on the CPU, 2 frames: the engine gates (valid equal,
    boxes within 1e-2 px, embedding cosine >= 0.999, emotion top-1 equal,
    emotion probabilities within 5e-3)."""
    outs = []
    for where, (e, c, m) in ((dev, models), ("cpu", models_cpu)):
        e.dtype = m.dtype = torch.float32
        eng = engine_cls(
            mtcnn_cls(dtype=torch.float32, device=where, **DETECTOR), e, c,
            target_fs=112, compute_dtype=torch.float32, face_cap=[8, 16],
            face_hint=8, emotion=m, emotion_size=size,
            emotion_topk=EMOTION_TOPK)
        outs.append({k: v.cpu() for k, v in eng.process_adaptive(two).items()
                     if isinstance(v, torch.Tensor)})
    gpu, cpu = outs
    if not torch.equal(gpu["valid"], cpu["valid"]):
        fail(f"rest-engine-card-vs-cpu at {size} px: valid masks differ")
    v = cpu["valid"]
    box_err = float((gpu["boxes"][v] - cpu["boxes"][v]).abs().max())
    cos = float(torch.nn.functional.cosine_similarity(
        gpu["embeddings"][v], cpu["embeddings"][v], dim=-1).min())
    top1 = bool(torch.equal(gpu["emotion_idx"][v][:, 0],
                            cpu["emotion_idx"][v][:, 0]))
    prob_err = float((gpu["emotion_prob"][v]
                      - cpu["emotion_prob"][v]).abs().max())
    if (int(v.sum()) == 0 or box_err > 1e-2 or cos < 0.999 or not top1
            or prob_err > 5e-3):
        fail(f"rest-engine-card-vs-cpu at {size} px: {int(v.sum())} valid, "
             f"box diff {box_err:.2e}, cosine {cos:.6f}, top-1 equal {top1},"
             f" prob diff {prob_err:.2e}")
    return (f"emotion_size {size}: {int(v.sum())} valid on both, box diff "
            f"{box_err:.2e} (atol 1e-2), cosine min {cos:.6f} (>= 0.999), "
            f"top-1 equal, prob diff {prob_err:.2e} (atol 5e-3)")


def phase_rest(torch, kernels, K4, K8, dev, card, results):
    """Phase 31: the last of the JAX package's surface on the card.

    rest: the default line's chunk (64x640x640, bf16) through an engine
    whose MTCNN reads a ``weights_dir`` of .pt files written from the
    vendored npz and whose emotion head (``num_projections`` 128) runs at
    ``emotion_size`` 64 (the net's own stem, K8 on the tails, no K7),
    launches held to exact per-run counts; rest-k8, K8 in bf16 on the
    tails' own inputs from that engine (16 and 8 px maps) held to the
    plain version in f32 and timed beside its bound; rest-mtcnn, that MTCNN's
    detections equal (torch.equal) to the default MTCNN's;
    rest-engine-card-vs-cpu, the engine at emotion_size 64 and 224 card
    vs CPU in f32; rest-proj, the 128-wide ``proj`` card vs CPU;
    rest-crops, ``ops.image.batched_crop_area_resize`` through K4 (three
    launches a call) equal to its plain version at the default line's RNet
    (24 px) and ONet (48 px) crop counts, timed; ``crop_resize_bilinear``,
    ``batched_crop_resize`` and ``pipeline.align.align_faces_batch`` card
    vs CPU, timed, each f32 side shown beside an f64 reference."""
    import copy as _copy

    from vn_celeb_face_recognition_tpu_torch.models import (
        MLPModel,
        resnet_2branch_50,
    )
    from vn_celeb_face_recognition_tpu_torch.models.inception_resnet_v1 import (  # noqa: E501
        InceptionResnetV1,
    )
    from vn_celeb_face_recognition_tpu_torch.models.layers import (
        read_state_dict,
        seeded_init_,
    )
    from vn_celeb_face_recognition_tpu_torch.models.mtcnn import (
        MTCNN,
        NETS,
        WEIGHTS_DIR,
    )
    from vn_celeb_face_recognition_tpu_torch.ops import boxes as B
    from vn_celeb_face_recognition_tpu_torch.ops import image as I
    from vn_celeb_face_recognition_tpu_torch.pipeline.align import (
        align_faces_batch,
        center_point_dict,
    )
    from vn_celeb_face_recognition_tpu_torch.pipeline.engine import (
        FusedRecognitionEngine,
    )
    from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames

    frames_np = build_frames(BATCH, SIZE, FACES_PER_FRAME)
    frames = torch.from_numpy(frames_np).to(dev)
    g = torch.Generator().manual_seed(31)
    enc = seeded_init_(InceptionResnetV1(dtype=torch.bfloat16), g)
    clf = seeded_init_(MLPModel(512, N_CLASSES), g)
    emo = seeded_init_(resnet_2branch_50(
        num_classes=EMOTION_TAGS, num_projections=REST_PROJECTIONS,
        dtype=torch.bfloat16), g)
    with torch.no_grad():  # logits of order 1, so the softmax is not flat
        emo.fc.weight.mul_(0.02)
    cpu_models = tuple(_copy.deepcopy(m) for m in (enc, clf, emo))
    with scratch("rest_") as work:
        for net in NETS:
            torch.save(read_state_dict(os.path.join(WEIGHTS_DIR,
                                                    f"{net}.npz")),
                       os.path.join(work, f"{net}.pt"))
        det = MTCNN(dtype=torch.bfloat16, device=dev, weights_dir=work,
                    **DETECTOR)
    det_default = MTCNN(dtype=torch.bfloat16, device=dev, **DETECTOR)
    with torch.no_grad():
        got = det.detect_padded(frames[:8])
        want = det_default.detect_padded(frames[:8])
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    # stage 1's box grid at the default and stock (min_face_size 20)
    # pyramids: the card divides by the scale as the CPU does
    from vn_celeb_face_recognition_tpu_torch.models.mtcnn import (
        _stage1_boxes,
    )

    stock = _copy.copy(det)
    stock.min_face_size = 20
    grid_equal = True
    for scale in det._scales(SIZE, SIZE) + stock._scales(SIZE, SIZE):
        n = int(SIZE * scale + 1)
        score = torch.zeros((1, n, n))
        reg = torch.zeros((1, n, n, 4))
        card_boxes = _stage1_boxes(score.to(dev), reg.to(dev), scale,
                                   0.6)[0].cpu()
        grid_equal &= torch.equal(card_boxes,
                                  _stage1_boxes(score, reg, scale, 0.6)[0])
    phase("rest-mtcnn", f"MTCNN(weights_dir=<{', '.join(NETS)}>.pt) on "
          f"8x{SIZE}x{SIZE} bf16: detections equal to the vendored npz's "
          f"{same} (torch.equal; {int(want[3].sum())} valid); stage 1's box "
          f"grids at the default and stock pyramids card vs CPU equal "
          f"{grid_equal} (torch.equal)")
    if not same or not grid_equal:
        fail("rest-mtcnn: the .pt weights_dir detects otherwise, or stage "
             "1's box grid differs card vs CPU")

    # ---- the slice's path: the engine at emotion_size 64 ----------------
    engine = FusedRecognitionEngine(
        det, enc, clf, target_fs=112, compute_dtype=torch.bfloat16,
        face_cap=FACE_BUCKETS, face_hint=BATCH * FACES_PER_FRAME,
        emotion=emo, emotion_size=REST_EMOTION_SIZE,
        emotion_topk=EMOTION_TOPK)
    chunks = [frames, torch.from_numpy(np.roll(frames_np, 97, axis=2)).to(
        dev)]
    names = {label: f"celeb_{label}" for label in range(N_CLASSES)}
    for c in chunks:  # warm-up
        engine.identify(engine.process_adaptive(c), names, 0.5)
    times, valid_counts, counts, runs, out, res = drive(
        torch, kernels, engine, chunks, REST_CHUNKS, names)
    tail_blocks = len(emo.layer1) - 1 + len(emo.layer2) - 1
    check_line_counts(counts, {**MTCNN_LINE_LAUNCHES,
                               "bottleneck_chain": 3 * tail_blocks}, runs,
                      "rest", results)
    if any(len(r) != 4 for r in res):
        fail("rest: identify did not return emotion tags per frame")
    v = out["valid"]
    if not bool(torch.isfinite(out["emotion_prob"][v]).all()):
        fail("rest: non-finite emotion probabilities")
    chunk_ms = sorted(times)[len(times) // 2] * 1e3
    faces = sum(valid_counts) / len(valid_counts)
    phase("rest", f"{len(times)} chunks of {BATCH}x{SIZE}x{SIZE}, bf16, "
          f"MTCNN from a .pt weights_dir + InceptionResnetV1 + MLP "
          f"{N_CLASSES} + emotion ({EMOTION_TAGS} tags, proj "
          f"{REST_PROJECTIONS}) at emotion_size {REST_EMOTION_SIZE}; valid "
          f"faces per chunk {valid_counts}; {runs} chunk runs; median chunk "
          f"{chunk_ms:.2f} ms (host clock incl. identify), "
          f"{faces / chunk_ms * 1e3:.1f} faces/s on {card}; launches "
          f"{counts} (K8 on the tails at {REST_EMOTION_SIZE // 4} and "
          f"{REST_EMOTION_SIZE // 8} px maps, no K7)")
    if min(valid_counts) < 0.9 * BATCH * FACES_PER_FRAME:
        fail(f"rest: too few faces detected: {valid_counts}")
    points = out["points"][:8][v[:8]]
    idx8 = torch.nonzero(v[:8])[:, 0].to(torch.int32)
    rest_k8(torch, kernels, K8, engine, emo, chunks[0], card, results)
    del engine, chunks, out, res, det, det_default

    # ---- the engine at 64 and 224 px, and proj, card vs CPU -------------
    gates = [emotion_engine_card_vs_cpu(
        torch, FusedRecognitionEngine, MTCNN, (enc, clf, emo), cpu_models,
        frames_np[:2], size, dev) for size in (REST_EMOTION_SIZE, 224)]
    phase("rest-engine-card-vs-cpu", f"2x{SIZE}x{SIZE} f32, MTCNN + "
          f"InceptionResnetV1 + MLP + emotion: " + "; ".join(gates))
    gen = np.random.default_rng(31)
    x64 = gen.normal(size=(8, REST_EMOTION_SIZE, REST_EMOTION_SIZE, 3))
    f112 = gen.uniform(0, 255, (8, 112, 112, 3))
    projs = []
    with torch.no_grad():
        for m, where in ((emo, dev), (cpu_models[2], "cpu")):
            projs.append((
                m.forward_normalized(torch.from_numpy(x64).float().to(
                    where))[1].cpu(),
                m(torch.from_numpy(f112).float().to(where))[1].cpu()))
    errs = []
    for got_p, want_p, what in zip(projs[0], projs[1], ("64 px normalised",
                                                        "112 px faces")):
        if got_p.shape != (8, REST_PROJECTIONS):
            fail(f"rest-proj: x_proj shape {tuple(got_p.shape)}")
        scale = float(want_p.abs().max())
        errs.append(f"{what} max abs err {check_close(torch, got_p, want_p, 1e-3, 1e-3 * scale, 'rest-proj ' + what):.2e}")  # noqa: E501
    phase("rest-proj", f"ResNet2Branch(num_projections={REST_PROJECTIONS}) "
          f"f32, 8 inputs, x_proj card vs CPU (rtol 1e-3, atol 1e-3 x "
          f"max|ref|): {'; '.join(errs)}")
    del emo, enc, clf, cpu_models

    # ---- the library crops and batched alignment ------------------------
    h, w = SIZE, SIZE
    crop_lines = []
    for s, per in ((24, DETECTOR["rnet_cap"]), (48, DETECTOR["onet_cap"])):
        xy = gen.uniform(-40, w, (BATCH * per, 2))
        side = gen.uniform(12, 260, (BATCH * per, 1))
        bx = torch.from_numpy(np.trunc(np.concatenate(
            [xy, xy + side], -1)).astype(np.float32)).to(dev)
        bx = B.clamp_boxes(bx, w, h)
        idx = torch.arange(BATCH, device=dev,
                           dtype=torch.int32).repeat_interleave(per)

        def flat(bx=bx, idx=idx, s=s):
            return I.batched_crop_area_resize(frames, bx, idx, s)

        def plain(bx=bx, s=s, per=per):
            return K4.grouped_crop_area_resize_plain(
                frames, bx.reshape(BATCH, per, 4), s).reshape(-1, s, s, 3)

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = flat()
        check_line_counts(kernels.launch_counts(), {"crop_area_resize": 3},
                          1, f"rest-crops S={s}", results)
        n8 = 8 * per  # the CPU runs the first 8 frames' crops
        if not torch.equal(got, plain()) or not torch.equal(
                got[:n8].cpu(), I.batched_crop_area_resize(
                    frames[:8].cpu(), bx[:n8].cpu(), idx[:n8].cpu(), s)):
            fail(f"rest-crops S={s}: batched_crop_area_resize differs from "
                 "its plain version")
        ms, call_ms, plain_ms = timed(torch, "crop_area_resize", flat, plain,
                                      plain_runs=5)
        bound_ms, bound_by = bound(frames.numel() + bx.numel() * 4
                                   + got.numel() * 4, 0, PEAK_F32)
        results["crop_area_resize"][f"batched_s{s}"] = dict(
            k=int(bx.shape[0]), ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=bound_ms)
        crop_lines.append(
            f"S={s} K={bx.shape[0]}: torch.equal to the plain version (card;"
            f" and the CPU on 8 frames), 3 launches a call; kernel {ms:.3f} ms, call "
            f"{call_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by})")
        # the bilinear crops of the same boxes, card vs CPU
        bil = I.batched_crop_resize(frames, bx, idx, s)
        bil_cpu = I.batched_crop_resize(frames[:8].cpu(), bx[:n8].cpu(),
                                        idx[:n8].cpu(), s)
        bil_err = check_close(torch, bil[:n8].cpu(), bil_cpu, 1e-4, 1e-4,
                              f"batched_crop_resize S={s}")
        one = I.crop_resize_bilinear(frames[3], bx[5], s)
        check_close(torch, one.cpu(), I.crop_resize_bilinear(
            frames[3].cpu(), bx[5].cpu(), s), 1e-4, 1e-4,
            "crop_resize_bilinear")
        bil_ms = median_ms(torch, lambda: I.batched_crop_resize(
            frames, bx, idx, s), runs=10)
        crop_lines.append(f"batched_crop_resize S={s} card vs CPU (8 "
                          f"frames) max abs err {bil_err:.2e} (1e-4), "
                          f"{bil_ms:.3f} ms a call of K={bx.shape[0]} (CUDA "
                          f"events, median of 10)")
    phase("rest-crops", f"ops.image on {BATCH}x{SIZE}x{SIZE} u8 frames: "
          f"batched_crop_area_resize (K4) " + "; ".join(crop_lines)
          + f"; crop_resize_bilinear card vs CPU within 1e-4 ({TIMING}; "
          f"{card})")
    imgs = frames[:8].float()
    tpl = center_point_dict["(112, 112)"]
    aligned = align_faces_batch(imgs, idx8, points, tpl, (112, 112),
                                device=dev)
    aligned_cpu = align_faces_batch(imgs.cpu(), idx8.cpu(), points.cpu(),
                                    tpl, (112, 112), device="cpu")
    al_err = check_close(torch, aligned.cpu(), aligned_cpu, 0.0, ALIGN_ATOL,
                         "align_faces_batch")
    ref = align_f64(torch, imgs.cpu(), idx8.cpu(), points.cpu(), tpl)
    off = [float((a.cpu().double() - ref).abs().max())
           for a in (aligned, aligned_cpu)]
    if max(off) > ALIGN_ATOL:
        fail(f"align_faces_batch: card and CPU (f32) are {off[0]:.3e} and "
             f"{off[1]:.3e} from the f64 reference, want <= {ALIGN_ATOL}")
    al_ms = median_ms(torch, lambda: align_faces_batch(
        imgs, idx8, points, tpl, (112, 112), device=dev), runs=10)
    phase("rest-align", f"align_faces_batch on {int(points.shape[0])} "
          f"detected faces of 8x{SIZE}x{SIZE} f32 frames -> 112 px: card vs "
          f"CPU max abs err {al_err:.2e} (atol {ALIGN_ATOL}); from the f64 "
          f"reference: card {off[0]:.2e}, CPU {off[1]:.2e}; {al_ms:.3f} ms "
          f"a call (CUDA events, median of 10; {card})")


def align_f64(torch, images, image_idx, landmarks, template):
    """align_faces_batch to 112 px in f64 on the CPU, by an independent
    route: the f64 Umeyama matrices, inverted, as a grid_sample grid
    (bilinear, zeros outside: cv2's constant border of 0)."""
    import torch.nn.functional as F

    from vn_celeb_face_recognition_tpu_torch.ops.image import invert_affine
    from vn_celeb_face_recognition_tpu_torch.ops.similarity import (
        umeyama_similarity,
    )

    f64 = torch.float64
    inv = invert_affine(umeyama_similarity(
        landmarks.to(f64), torch.as_tensor(template, dtype=f64)))
    ys, xs = torch.meshgrid(torch.arange(112, dtype=f64),
                            torch.arange(112, dtype=f64), indexing="ij")
    src = torch.einsum("kij,hwj->khwi", inv,
                       torch.stack([xs, ys, torch.ones_like(xs)], -1))
    _, h, w, _ = images.shape
    grid = torch.stack([src[..., 0] * 2 / (w - 1) - 1,
                        src[..., 1] * 2 / (h - 1) - 1], -1)
    out = [F.grid_sample(images[int(i)].to(f64).permute(2, 0, 1)[None],
                         g[None], mode="bilinear", padding_mode="zeros",
                         align_corners=True)[0]
           for i, g in zip(image_idx, grid)]
    return torch.stack(out).permute(0, 2, 3, 1)


def rest_k8(torch, kernels, K8, engine, emo, chunk, card, results):
    """rest-k8: K8 in bf16 on the emotion tails' inputs that ``engine``
    (emotion_size REST_EMOTION_SIZE) gives them on ``chunk``, taken by a
    forward hook on each layer's first block, held to the plain version in
    f32 as phase K8 holds it at 224 px, and timed beside its bound."""
    taken = {}
    hooks = [layer[0].register_forward_hook(
        lambda mod, args, y, n=n: taken.__setitem__(n, y.detach()))
        for n, layer in (("l1", emo.layer1), ("l2", emo.layer2))]
    with torch.no_grad():
        engine.process_adaptive(chunk)
    for h in hooks:
        h.remove()
    parts, row = [], {}
    for name, layer, c, p in (("l1", emo.layer1, 256, 64),
                              ("l2", emo.layer2, 512, 128)):
        blocks = list(layer)[1:]
        x = taken[name].permute(0, 2, 3, 1)  # as _trunk hands it to K8
        k, side = int(x.shape[0]), int(x.shape[1])
        if x.dtype != torch.bfloat16 or tuple(x.shape[1:]) != (
                side, side, c) or side != REST_EMOTION_SIZE // (
                    4 if name == "l1" else 8):
            fail(f"rest-k8 {name}: the tail's input is {x.dtype} "
                 f"{tuple(x.shape)}")
        got = through_kernel(kernels, "bottleneck_chain",
                             lambda: K8.bottleneck_chain(blocks, x),
                             launches=3 * len(blocks))
        e, rel_l2, rel_max, plain16 = check_bf16(
            torch, got, K8.bottleneck_chain_plain(blocks,
                                                  x.to(torch.float32)),
            K8.bottleneck_chain_plain(blocks, x), f"rest-k8 bf16 {name}")
        t_k, t_call, t_p = timed(
            torch, "bottleneck_chain",
            lambda: K8.bottleneck_chain(blocks, x),
            lambda: K8.bottleneck_chain_plain(blocks, x))
        pix = k * side * side
        flops = len(blocks) * pix * 2 * (2 * c * p + 9 * p * p)
        wbytes = len(blocks) * 2 * (2 * c * p + 9 * p * p)
        b_ms, b_by = bound(2 * pix * c * 2 + wbytes, flops, PEAK_BF16)
        row[name] = dict(k=k, side=side, max_abs_err=e, rel_l2=rel_l2,
                         ms=t_k, call_ms=t_call, plain_ms=t_p, bound_ms=b_ms,
                         bound_by=b_by)
        parts.append(
            f"{name} K={k} C={c} {side}x{side} {len(blocks)} blocks vs plain "
            f"f32: max abs err {e:.3e}, rel L2 {rel_l2:.2e}, max/max|ref| "
            f"{rel_max:.2e} (plain bf16 rel L2 {plain16:.2e}); kernel "
            f"{t_k:.3f} ms, call {t_call:.3f} ms, plain (cuDNN) {t_p:.3f} "
            f"ms, bound {b_ms:.3f} ms ({b_by})")
    results["bottleneck_chain"][f"emotion_size_{REST_EMOTION_SIZE}"] = row
    phase("rest-k8", f"bottleneck_chain bf16 on the engine's own tail "
          f"inputs at emotion_size {REST_EMOTION_SIZE}, 3 launches a block: "
          + "; ".join(parts) + f" ({TIMING}; {card})")


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
    laps = []  # (phases, s since the previous lap), for the done line

    def lap(phases):
        laps.append((phases, time.perf_counter() - t_start
                     - sum(s for _, s in laps)))

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

    lap("2")

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
    lap("3-7")

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
    profile_chunk(torch, lambda: engine.identify(
        engine.process_adaptive(chunks[0]), names, 0.5), chunk_ms, card,
        "profile", "default", results)

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
    profile_chunk(torch, lambda: engine.identify(
        engine.process_adaptive(chunks[0]), names, 0.5), chunk_ms, card,
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
    lap("8-14")

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
    profile_chunk(torch, lambda: engine.identify(
        engine.process_adaptive(chunks[0]), names, 0.5), chunk_ms, card,
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

    del prod, rdet, penc, pclf, emo, penc_cpu, pclf_cpu, emo_cpu, eng
    torch.cuda.empty_cache()
    lap("15-20")

    # ---- 21. the recognition library -------------------------------------
    phase_recognition(torch, F, kernels, K1, dev, card, results)
    torch.cuda.empty_cache()
    lap("21")

    # ---- 22. the CLIs ----------------------------------------------------
    phase_cli(torch, kernels, dev, card, results)
    torch.cuda.empty_cache()
    lap("22")

    # ---- 23. the trainers ------------------------------------------------
    phase_train(torch, kernels, K1, dev, card, results)
    torch.cuda.empty_cache()
    lap("23")

    # ---- 24. the image-classify trainer and the online-aug step ----------
    phase_train_img(torch, kernels, K1, dev, card, results)
    torch.cuda.empty_cache()
    lap("24")

    # ---- 25. FAN and the dataset tools -------------------------------------
    phase_fan(torch, kernels, dev, card, results)
    torch.cuda.empty_cache()
    lap("25")

    # ---- 26. JPEG and video through the CLIs' readers ----------------------
    phase_readers(torch, kernels, dev, card, results)
    torch.cuda.empty_cache()
    lap("26")

    # ---- 27. the SE-IR encoder and ArcMargin -------------------------------
    phase_se_ir(torch, kernels, K1, dev, card, results)
    torch.cuda.empty_cache()
    lap("27")

    # ---- 28. RetinaFace cfg_re50 through the library -----------------------
    phase_re50(torch, kernels, dev, card, results)
    torch.cuda.empty_cache()
    lap("28")

    # ---- 29. detector training ---------------------------------------------
    phase_fit(torch, kernels, K6, dev, card, results)
    torch.cuda.empty_cache()
    lap("29")

    # ---- 30. the mesh on a one-rank NCCL group -----------------------------
    phase_parallel(torch, card)
    lap("30")

    # ---- 31. the rest: emotion_size, num_projections, weights_dir, --------
    # the library crops and batched alignment
    phase_rest(torch, kernels, K4, K8, dev, card, results)
    torch.cuda.empty_cache()
    lap("31")

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
          " s after the card check (s by phase: "
          + ", ".join(f"{p} {s:.1f}" for p, s in laps) + ")")
    print(json.dumps({"kernels": kernel_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
