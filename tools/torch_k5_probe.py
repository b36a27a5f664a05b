#!/usr/bin/env python3
"""K5's f32 grid on the H100: the 3xTF32 trunk kernel against its variants.

Each variant of ``csrc/crop_net_trunk.cu`` is compiled into its own shared
library under ``build/k5_probe/`` (gitignored), one ``nvcc`` each, all
started together, and loaded with ctypes (each exports the same C entry
point, ``vn_crop_net_trunk``). Every variant that computes the whole
function is held to the plain version in f32 within 1e-4 of max|ref|;
then all are timed on 16,384 RNet and 8,192 ONet crops (a chunk run of
``demo_video --fused_engine``, CLI path a), seeded in [-1, 1), by CUDA
events over 20 launches, in turns: a b ... b a.

Variants (substitutions in ``crop_net_trunk.cu`` or ``mma.cuh``;
``launch_tf32x3<S, C2, G, R, MT, NT>``: MT m16 tiles x NT n8 tiles a conv2
item):
  checkout        the checkout's kernel;
  cvt split       split_tf32 rounding by cvt.rna.tf32.f32 in place of
                  integer adds and masks (the same values);
  lo truncated    lo left unrounded (the tensor cores read its top 10
                  mantissa bits);
  conv1 3 chains  conv1's three products summed in three accumulators;
  rnet MTxNT,
  onet MTxNT      other conv2 items for one net;
  running sums    conv2's products summed straight into the running sums
                  (no partial a tap), to show what the partials cost;
  partial a step  a partial a k8 step (mma_tf32x3_add) in place of a tap;
  no conv1,
  no conv2        the phase skipped (times only);
  parent          with ``--parent DIR``: the ``crop_net_trunk.cu`` (and
                  its headers) in DIR, with its own weight packing.

Usage, from the root of a checkout, on a machine with the card:
    python3 tools/torch_k5_probe.py [--parent DIR]
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CSRC = os.path.join(ROOT, "vn_celeb_face_recognition_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "k5_probe")
RNET = "launch_tf32x3<24, 48, 4, 2, 1, 2>"
ONET = "launch_tf32x3<48, 64, 1, 2, 2, 4>"
CONV1 = ("    // (the ring of conv rows as on the bf16 path, kept in f32)\n"
         "    for (int py0 = 0; py0 < P; py0 += R) {")
CONV2 = "    for (int it = warp; it < items; it += kTfWarps) {"
# split_tf32's rounding (mma.cuh): integer adds and masks, or cvt.rna
INT = """  hi = (x + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) +
        0x1000u) & 0xffffe000u;"""
CVT = {INT: ('  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : '
             '"f"(__uint_as_float(x)));\n'
             '  hi &= 0xffffe000u;\n'
             '  asm("cvt.rna.tf32.f32 %0, %1;\\n"\n'
             '      : "=r"(lo)\n'
             '      : "f"(__uint_as_float(x) - __uint_as_float(hi)));')}
LO_TRUNC = {INT: """  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));"""}
# conv1's three products in three accumulators (chains of 4 in place of 12)
CONV1_ACC = ("        float acc[4][4] = {};\n#pragma unroll\n"
             "        for (int ks")
CONV1_MMA = ("            mma_tf32x3(acc[2 * jp], ah, al, bh, bl);\n"
             "            mma_tf32x3(acc[2 * jp + 1], ah, al, bh + 2, "
             "bl + 2);\n          }\n        }\n")
THREE_CHAINS = {
    CONV1_ACC: CONV1_ACC.replace("acc[4][4] = {};",
                                 "acc[4][4] = {}, s1[4][4] = {}, "
                                 "s2[4][4] = {};"),
    CONV1_MMA: """            for (int u = 0; u < 2; ++u) {
              mma_tf32(s1[2 * jp + u], al, bh + 2 * u);
              mma_tf32(s2[2 * jp + u], ah, bl + 2 * u);
              mma_tf32(acc[2 * jp + u], ah, bh + 2 * u);
            }
          }
        }
        for (int j = 0; j < 4; ++j)
          for (int e = 0; e < 4; ++e) acc[j][e] += s1[j][e] + s2[j][e];
"""}
# name -> (substitutions in crop_net_trunk.cu or mma.cuh, computes the
# whole function)
VARIANTS = {
    "checkout": ({}, True),
    "cvt split": (CVT, True),
    "lo truncated": (LO_TRUNC, True),
    "rnet 2x6": ({RNET: RNET.replace("1, 2>", "2, 6>")}, True),
    "onet 1x4": ({ONET: ONET.replace("2, 4>", "1, 4>")}, True),
    "onet 1x8": ({ONET: ONET.replace("2, 4>", "1, 8>")}, True),
    "conv1 3 chains": (THREE_CHAINS, True),
    "conv1 3 chains, rnet 2x6": (dict(THREE_CHAINS, **{
        RNET: RNET.replace("1, 2>", "2, 6>")}), True),
    "partial a step": ({
        "mma_tf32x3(t[mi][j], ": "mma_tf32x3_add(acc[mi][j], ",
        "mma_tf32x3(t[mi][j + 1], ": "mma_tf32x3_add(acc[mi][j + 1], "},
        True),
    "running sums": ({
        "mma_tf32x3(t[mi][j], ": "mma_tf32x3(acc[mi][j], ",
        "mma_tf32x3(t[mi][j + 1], ": "mma_tf32x3(acc[mi][j + 1], "}, True),
    "no conv1": ({CONV1: CONV1.replace("py0 < P;", "py0 < 0;")}, False),
    "no conv2": ({CONV2: CONV2.replace("it < items;", "it < 0;")}, False),
}
SOURCES = ("crop_net_trunk.cu", "mma.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
CROPS = {"rnet": 16384, "onet": 8192}


def build(variants, parent, nvcc):
    """Compile every variant at once; returns name -> loaded library."""
    jobs = []
    shutil.rmtree(OUT, ignore_errors=True)
    for i, (name, (subs, _)) in enumerate(variants.items()):
        where = os.path.join(OUT, str(i))
        os.makedirs(where)
        src_dir = parent if name == "parent" else CSRC
        texts = {}
        for f in SOURCES:
            with open(os.path.join(src_dir, f)) as fh:
                texts[f] = fh.read()
        for old, new in subs.items():
            hits = [f for f in SOURCES if old in texts[f]]
            if len(hits) != 1:
                raise SystemExit(f"{name}: {old!r} in {hits}")
            texts[hits[0]] = texts[hits[0]].replace(old, new)
        for f, text in texts.items():
            with open(os.path.join(where, f), "w") as fh:
                fh.write(text)
        shutil.copy(os.path.join(src_dir, "launch.cuh"), where)
        lib = os.path.join(where, "libk5.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", lib,
               os.path.join(where, "crop_net_trunk.cu")]
        jobs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, path, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        usage, fn = [], None
        for ln in out.splitlines():
            if "Compiling entry function" in ln:
                fn = "tf32x3" in ln or "_f32" in ln
            elif fn and ("registers" in ln or "spill" in ln):
                usage.append(ln.split(":", 1)[-1].strip())
        print(f"[build] {name} (f32 grids): {' | '.join(usage)}", flush=True)
        lib = ctypes.CDLL(path)
        lib.vn_crop_net_trunk.argtypes = ARGTYPES
        lib.vn_crop_net_trunk.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="directory holding an earlier "
                    "crop_net_trunk.cu, launch.cuh and mma.cuh")
    ap.add_argument("--launches", type=int, default=20)
    args = ap.parse_args()
    sys.path.append(ROOT)
    import torch

    import chip_smoke as C
    from vn_celeb_face_recognition_tpu_torch.models.mtcnn import MTCNN
    from vn_celeb_face_recognition_tpu_torch.ops import crops_net as K5
    from vn_celeb_face_recognition_tpu_torch.utils import kernels

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    card = C.card_line()
    variants = dict(VARIANTS)
    if args.parent:
        variants["parent"] = ({}, True)
    libs = build(variants, args.parent, kernels.find_nvcc())
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    det = MTCNN(device=dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    turns = list(variants) + list(reversed(variants))
    print(f"[probe] {card}; CUDA events over {args.launches} launches, "
          f"turns {turns}", flush=True)
    for net, spec in ((det.rnet, K5.RNET_SPEC), (det.onet, K5.ONET_SPEC)):
        n = CROPS[spec.name]
        x = torch.rand((n, spec.size, spec.size, 3), generator=gen,
                       device=dev) * 2 - 1
        packed = {
            "new": K5.pack_trunk_weights_tf32x3(net, spec).to(dev),
            "parent": K5.pack_trunk_weights(net, spec).to(dev)}
        want = K5.crop_net_trunk_plain(net, x, spec)
        out = torch.empty_like(want)

        def launch(name):
            w = packed["parent" if name == "parent" else "new"]
            err = libs[name].vn_crop_net_trunk(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), n, spec.net_id,
                0, stream)
            if err:
                raise SystemExit(f"{name}: CUDA error {err} at launch")

        errs = {}
        for name, (_, whole) in variants.items():
            if whole:
                out.fill_(float("nan"))
                launch(name)
                torch.cuda.synchronize()
                errs[name] = C.check_close(
                    torch, out, want, 1e-4, 1e-4 * float(want.abs().max()),
                    f"{name} {spec.name}")

        def per_launch_ms(name):
            for _ in range(3):
                launch(name)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.launches):
                launch(name)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / args.launches

        times = {name: [] for name in variants}
        for name in turns:
            times[name].append(per_launch_ms(name))
        floor, by = C.bound_3xtf32((x.numel() + want.numel()) * 4,
                                   n * C.trunk_flops(spec))
        print(f"[probe] {spec.name} {n} crops (3xtf32 floor {floor:.3f} ms, "
              f"{by}): " + "; ".join(
                  f"{name} {sum(t) / 2:.3f} ms ("
                  + ", ".join(f"{v:.3f}" for v in t) + ")"
                  + (f" err {errs[name]:.2e}" if name in errs else "")
                  for name, t in times.items()), flush=True)
        del x, want, out
    print("[probe] done", flush=True)


if __name__ == "__main__":
    main()
