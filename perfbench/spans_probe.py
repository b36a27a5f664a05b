#!/usr/bin/env python3
"""The program's spans and counters in one cell, and what they cost,
beside another checkout's program on the same chunks:

    python3 perfbench/spans_probe.py --workload <cell> --seed <n> \
        [--program DIR] --out <file.json>

It builds the cell's engine as a run does (``harness.run``: the
configuration, the seeded weights and pool), runs every pool chunk once,
then measures, each over the pool's chunks:
  * ``chunk_ms``: the untraced chunk (``process_adaptive`` + ``identify``)
    on the host clock;
  * ``syncs``: the device syncs a chunk, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them, and the lines
    of the program that made them;
  * ``launch_counts``: ``kernels.launch_counts()`` a chunk, and the
    program's other counters;
  * ``digest``: a hash of each output of pool chunk 0 and of its names;
  * three profiles of 8 chunks (``perfbench/trace.py``'s warm-up step
    first), each with the traced chunk's host ms, the launching runtime
    calls a chunk, and from the program's spans (``program_trace.py``):
    device ms by span, dispatch ms, launches by span, self ms and idle ms
    by span, a chunk;
  * ``span_us``: one chunk's spans (``annotate``) and counters in a
    loop, with no profiler, against the same ranges entered
    unconditionally, and inside a profiler session;
  * ``nvtx``: whether spans are ranges under ``emit_nvtx``.

``--program DIR`` imports the port from DIR (a checkout of another
commit) instead of this one. The benchmark's own runs do not run this.
"""

import argparse
import hashlib
import json
import os
import statistics
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench import harness, program_trace, traffic_gen  # noqa: E402
from perfbench import trace as tr  # noqa: E402

PROFILES = 3
TRACED = 8


def build(workload, seed, device, overrides):
    import torch

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cell = harness.find_cell(bench, workload)
    cfg = harness.load_json(harness.HERE, "configs", f"{cell['config']}.json")
    mix = traffic_gen.load_mix(cell["traffic"])
    for key, value in (overrides or {}).items():
        (mix if key in mix else cfg)[key] = value
    from vn_celeb_face_recognition_tpu_torch.pipeline.engine import (
        FusedRecognitionEngine,
    )
    from vn_celeb_face_recognition_tpu_torch.utils import kernels

    dev = torch.device(device)
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"]["cudnn"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"]["matmul"])
    cdtype = getattr(torch, cfg["dtype"])
    if dev.type == "cuda":
        kernels.build()
    pool, _ = traffic_gen.build_pool(mix, int(cfg["chunk_frames"]), seed,
                                     dev)
    roles = [r for r in ("detector", "encoder", "classifier", "emotion")
             if cfg.get(r)]
    built = {r: harness.net_module(cfg[r]["net"]).program(cfg[r], cdtype,
                                                          dev, seed)
             for r in roles}
    emo, eng = cfg.get("emotion"), cfg["engine"]
    engine = FusedRecognitionEngine(
        built["detector"], built["encoder"], built["classifier"],
        target_fs=eng["target_fs"], compute_dtype=cdtype,
        face_window=eng["face_window"], face_cap=eng["face_cap"],
        emotion=built.get("emotion"),
        emotion_size=emo["size"] if emo else 224,
        emotion_topk=emo["topk"] if emo else 6)
    names = {i: f"celeb_{i}"
             for i in range(cfg["classifier"]["args"]["num_classes"])}
    threshold = cfg["identify"]["threshold"]

    def chunk(i):
        out = engine.process_adaptive(pool[i % len(pool)])
        return out, engine.identify(out, names, threshold)

    return chunk, len(pool)


def digest(out, res):
    import torch

    parts = {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()[:16]
             for k, v in sorted(out.items()) if isinstance(v, torch.Tensor)}
    h = hashlib.sha256()
    for frame in res:
        h.update(repr(frame[0]).encode())
        for rest in frame[1:]:
            for a in rest:
                h.update(a.tobytes())
    parts["identify"] = h.hexdigest()[:16]
    return parts


def profile_events(chunk, kernels, path):
    """``chunk(k)`` for k = 0 .. TRACED under torch.profiler, step 0 the
    dropped warm-up (the harness's ``trace.profile``); the Chrome trace's
    events."""
    import torch
    from torch.profiler import ProfilerActivity, schedule

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            schedule=schedule(wait=0, warmup=1, active=TRACED, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for k in range(TRACED + 1):
            if k == 1:
                kernels.reset_launch_counts()
            chunk(k)
            prof.step()
    try:
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.remove(path)


def read_profile(events, tracing):
    pt = program_trace.ProgramTrace(events)
    per = 1.0 / TRACED
    steps = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("ProfilerStep#")]
    calls = {(e.get("args") or {}).get("correlation") for e in events
             if e.get("ph") == "X" and e.get("cat") in tr.RUNTIME_CATS
             and any(w in e["name"] for w in program_trace.LAUNCHING)
             and pt.t0 <= e["ts"] <= pt.t1}
    calls.discard(None)
    spans = {}
    for _, _, name in pt.spans:
        spans[name] = spans.get(name, 0) + per
    gpu_annotations = sum(1 for e in events
                          if e.get("cat") == "gpu_user_annotation")
    old = tr.Trace(events)
    counters = tracing.counts() if hasattr(tracing, "counts") else {}
    return {
        "traced_chunk_ms": statistics.mean(e["dur"] for e in steps) * 1e-3,
        "launch_calls": len(calls) * per,
        "spans_a_chunk": spans,
        "device_ms_by_span": {s: pt.device_s(s) * per * 1e3
                              for s in sorted(spans)},
        "dispatch_ms": pt.dispatch_s() * per * 1e3,
        "launches_by_span": {k: v * per for k, v in
                             sorted(pt.launches().items())},
        "self_ms": {k: v * per * 1e3 for k, v in sorted(pt.self_s().items())},
        "idle_ms_by_span": {k: v * per * 1e3 for k, v in
                            sorted(pt.idle_by_span().items())},
        "idle_ms_by_pb_span": {k: v * per * 1e3 for k, v in
                               sorted(old.idle_by_span().items())},
        "busy_ms": old.union_s(cats=("kernel",)) * per * 1e3,
        "window_ms": pt.window_s * per * 1e3,
        "gpu_user_annotations": gpu_annotations,
        "counters": {k: v for k, v in counters.items()
                     if not k.startswith("launches.")},
    }


def span_cost_us(tracing, spans_a_chunk, reps=20000):
    """µs of host time a chunk for one chunk's spans and counters in a
    loop: with no profiler through ``annotate`` and as bare
    ``record_function`` ranges (what unconditional spans would cost), and
    through ``annotate`` inside a CPU and CUDA profiler session."""
    import torch
    from torch.profiler import ProfilerActivity

    seq = [n for n, k in sorted(spans_a_chunk.items())
           for _ in range(round(k))]

    def loop(enter, n):
        t0 = time.perf_counter()
        for _ in range(n):
            for name in seq:
                with enter(name):
                    pass
            if hasattr(tracing, "count"):
                tracing.count("engine.slots", 512)
                tracing.count("engine.faces", 444)
        return (time.perf_counter() - t0) / n * 1e6

    out = {"spans": len(seq), "annotate": loop(tracing.annotate, reps),
           "record_function": loop(torch.profiler.record_function, reps)}
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        out["annotate_profiled"] = loop(tracing.annotate, reps // 10)
    if hasattr(tracing, "counts"):
        tracing.reset_counts()
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--program", default=None,
                   help="a checkout whose port to import")
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true",
                   help="2-frame chunks, for a rehearsal on the CPU")
    p.add_argument("--out", required=True)
    args = p.parse_args()
    if args.program:
        sys.path.insert(0, os.path.abspath(args.program))
    import torch

    from vn_celeb_face_recognition_tpu_torch.utils import kernels, tracing

    overrides = ({"chunk_frames": 2, "pool_chunks": 2} if args.small
                 else None)
    if args.device == "cpu":
        torch.set_num_threads(2)
    cuda = args.device == "cuda"
    t0 = time.perf_counter()
    chunk, n_pool = build(args.workload, args.seed, args.device, overrides)
    for i in range(n_pool):
        chunk(i)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    res = {"workload": args.workload, "seed": args.seed,
           "program": os.path.dirname(os.path.dirname(tracing.__file__)),
           "card": harness.card_line() if cuda else "cpu",
           "setup_s": time.perf_counter() - t0}

    ms = []
    for i in range(3 * n_pool):
        t = time.perf_counter()
        chunk(i)
        ms.append((time.perf_counter() - t) * 1e3)
    res["chunk_ms"] = {"median": statistics.median(ms), "all": ms}

    if cuda:
        per_chunk, sites = [], {}
        for i in range(n_pool):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    chunk(i)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs = [w for w in caught if "synchroniz" in str(w.message)]
            per_chunk.append(len(syncs))
            for w in syncs:
                site = (f"{os.path.relpath(w.filename, res['program'])}:"
                        f"{w.lineno}")
                sites[site] = sites.get(site, 0) + 1 / n_pool
        res["syncs"] = per_chunk
        res["sync_sites"] = dict(sorted(sites.items()))

    kernels.reset_launch_counts()
    for i in range(n_pool):
        chunk(i)
    res["launch_counts"] = {k: v / n_pool
                            for k, v in kernels.launch_counts().items()}
    if hasattr(tracing, "counts"):
        res["counters_a_chunk"] = {k: v / n_pool for k, v in
                                   tracing.counts().items()
                                   if not k.startswith("launches.")}
    res["digest"] = digest(*chunk(0))

    path = os.path.join(harness.CACHE_DIR, f"probe-{os.getpid()}.json")
    os.makedirs(harness.CACHE_DIR, exist_ok=True)
    res["profiles"] = [read_profile(profile_events(chunk, kernels, path),
                                    tracing) for _ in range(PROFILES)]
    res["span_us"] = span_cost_us(tracing,
                                  res["profiles"][0]["spans_a_chunk"])
    if cuda:
        with torch.autograd.profiler.emit_nvtx():
            res["nvtx"] = {
                "profiler_enabled": torch.autograd._profiler_enabled(),
                "annotate": type(tracing.annotate("engine.chunk")).__name__}
            chunk(0)
        sync()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    brief = {k: res[k] for k in ("workload", "program", "card", "syncs",
                                 "digest", "span_us", "nvtx") if k in res}
    brief["chunk_ms"] = res["chunk_ms"]["median"]
    brief["profiles"] = [{k: p[k] for k in ("traced_chunk_ms",
                                             "launch_calls", "dispatch_ms")}
                         for p in res["profiles"]]
    print(json.dumps(brief), flush=True)


if __name__ == "__main__":
    main()
