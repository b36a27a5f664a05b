#!/usr/bin/env python3
"""K3 on the H100: the NMS keep-mask kernel against its variants.

Each variant of ``csrc/nms_keep.cu`` is compiled into its own shared
library under ``build/k3_probe/`` (gitignored), one ``nvcc`` each, all
started together, and loaded with ctypes (each exports the same C entry
point, ``vn_nms_keep_mask``). Every variant that computes the whole
function is held to the plain version (``torch.equal``); then all are
timed at every shape the three lines launch (``chip_smoke.K3_SHAPES``),
with the sets in priority order (as a top-k hands them over) and not, by
CUDA events over 50 launches, in turns: a b ... b a. The sets stay in L2
between launches, as they do on the lines, where K3 reads what the step
before it wrote.

Variants:
  tiled            the checkout's kernel;
  tiled, narrow    the same with at most 256 threads a block whatever the
                   number of sets (no wide blocks for launches of fewer
                   sets than SMs);
  stop after 1     returns after the load and compaction (times only);
  stop after 2     returns after the order check, the sort when it runs,
                   and the gather of boxes by rank (times only);
  parent           with ``--parent DIR``: the ``nms_keep.cu`` (and
                   ``launch.cuh``) in DIR, e.g. from ``git archive`` of an
                   earlier commit;
and with ``--probes`` the variants in ``PROBES``, each of which changes
one part of the scan to show what it costs.

Usage, from the root of a checkout, on a machine with the card:
    python3 tools/torch_k3_probe.py [--parent DIR]
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CSRC = os.path.join(ROOT, "vn_celeb_face_recognition_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "k3_probe")
PHASE2 = "  // -- phase 2: order check, then sort only when needed\n"
PHASE3 = "  // -- phase 3: greedy scan in tiles of 32 ranks\n"
# name -> (substitutions in nms_keep.cu, computes the whole function)
VARIANTS = {
    "tiled": ({}, True),
    "tiled, narrow": ({"const int most = n < sms ? kMaxThreads : "
                       "kNarrowThreads;": "const int most = kNarrowThreads;"},
                      True),
    "stop after 1": ({PHASE2: "  if (tid == 0) keep[base] = (uint8_t)nv;\n"
                      "  return;\n" + PHASE2}, False),
    "stop after 2": ({PHASE3: "  if (tid == 0 && nv > 0)\n"
                      "    keep[base] = (uint8_t)(row_area[2 * nv - 1] ^ "
                      "__float_as_uint(sbox[nv - 1].x));\n"
                      "  return;\n" + PHASE3}, False),
}
# with --probes: variants that change one part of the kernel to show its
# cost (fast division alone does not compute the whole function)
PROBES = {
    "no screens": ({"  if (inter == 0.f) return 0.f > t.thr;\n": "",
                    "  if (denom < 0x1p100f) {": "  if (false) {"}, True),
    "fast division": ({"return __fdiv_rn(inter, denom) > t.thr;":
                       "return __fdividef(inter, denom) > t.thr;"}, False),
    "narrow 128": ({"constexpr int kNarrowThreads = 256;":
                    "constexpr int kNarrowThreads = 128;"}, True),
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 \
    + [ctypes.c_int, ctypes.c_void_p]


def build(variants, parent, nvcc):
    """Compile every variant at once; returns name -> loaded library."""
    jobs = []
    shutil.rmtree(OUT, ignore_errors=True)
    for i, (name, (subs, _)) in enumerate(variants.items()):
        where = os.path.join(OUT, str(i))
        os.makedirs(where)
        src_dir = parent if name == "parent" else CSRC
        with open(os.path.join(src_dir, "nms_keep.cu")) as fh:
            text = fh.read()
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in nms_keep.cu")
            text = text.replace(old, new)
        with open(os.path.join(where, "nms_keep.cu"), "w") as fh:
            fh.write(text)
        shutil.copy(os.path.join(src_dir, "launch.cuh"), where)
        lib = os.path.join(where, "libk3.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", lib,
               os.path.join(where, "nms_keep.cu")]
        jobs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, path, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        usage = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {' | '.join(usage)}", flush=True)
        lib = ctypes.CDLL(path)
        lib.vn_nms_keep_mask.argtypes = ARGTYPES
        lib.vn_nms_keep_mask.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="directory holding an earlier "
                    "nms_keep.cu and launch.cuh")
    ap.add_argument("--probes", action="store_true",
                    help="also build and time the PROBES variants")
    ap.add_argument("--launches", type=int, default=50)
    args = ap.parse_args()
    sys.path.append(ROOT)
    import torch

    import chip_smoke as C
    from vn_celeb_face_recognition_tpu_torch.ops import nms as K3
    from vn_celeb_face_recognition_tpu_torch.utils import kernels

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = C.card_line()
    variants = dict(VARIANTS, **(PROBES if args.probes else {}))
    if args.parent:
        variants["parent"] = ({}, True)
    libs = build(variants, args.parent, kernels.find_nvcc())
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(name, sets, keep, thr, off, mm):
        bx, sc, vl = sets
        n, k = sc.shape
        err = libs[name].vn_nms_keep_mask(
            bx.data_ptr(), sc.data_ptr(), vl.data_ptr(), keep.data_ptr(), n,
            k, thr, off, int(mm), stream)
        if err:
            raise SystemExit(f"{name}: CUDA error {err} at launch")

    def per_launch_ms(name, sets, keep, thr, off, mm):
        for _ in range(5):
            launch(name, sets, keep, thr, off, mm)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.launches):
            launch(name, sets, keep, thr, off, mm)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.launches

    gen = np.random.default_rng(13)
    turns = list(variants) + list(reversed(variants))
    print(f"[probe] {card}; CUDA events over {args.launches} launches, "
          f"turns {turns}", flush=True)
    for line, nms, n, k, thr, off, mm in C.K3_SHAPES:
        raw = C.nms_sets(torch, gen, n, k, C.SIZE, dev)
        for order, sets in (("in order", C.in_priority_order(torch, *raw)),
                            ("unordered", raw)):
            want = K3.nms_keep_mask_plain(*sets, thr, off, mm)
            keep = torch.empty_like(want)
            for name, (_, whole) in variants.items():
                if whole:
                    keep.zero_()
                    launch(name, sets, keep, thr, off, mm)
                    torch.cuda.synchronize()
                    if not torch.equal(keep, want):
                        raise SystemExit(
                            f"{name} {line} {nms} {order}: "
                            f"{int((keep != want).sum())} keep flags differ")
            times = {name: [] for name in variants}
            for name in turns:
                times[name].append(per_launch_ms(name, sets, keep, thr, off,
                                                 mm))
            print(f"[probe] {line} {nms} {n}x{k} {order} "
                  f"({int(want.sum())} kept of {int(sets[2].sum())}): "
                  + "; ".join(f"{name} {sum(t) / 2:.4f} ms ("
                              + ", ".join(f"{x:.4f}" for x in t) + ")"
                              for name, t in times.items()), flush=True)
    print("[probe] done", flush=True)


if __name__ == "__main__":
    main()
