"""One run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``). A run builds the program's fused engine
(``FusedRecognitionEngine``) from the configuration with weights made from
the seed, makes the mix's pool of distinct chunks from the seed, runs every
pool chunk once (set-up: the kernels' build, cuDNN plans, the allocator,
every face bucket the traffic reaches), then hands the engine one chunk at
a time, as a host uint8 array, through ``process_adaptive`` and
``identify``, for ``--seconds``: a closed loop with one chunk in flight, as
the offline indexing CLIs run. Hand-overs stop at the deadline; the window
ends when the last chunk handed over is back.

After the window two of the pool's chunks, drawn from the seed, are judged
against the plain reference (``judge.py``) with the program's last outputs
for them, once the program is freed. With ``--trace 1`` the run then also
profiles eight more chunks and prints the cell's per-layer metrics, read
by ``metrics/<name>.py``, instead of its end-to-end ones.
"""

import contextlib
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
import types

from perfbench import HERE, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "vn_celeb_face_recognition_tpu")
PORT = "vn_celeb_face_recognition_tpu_torch"
JUDGED_CHUNKS = 2
TRACE_CHUNKS = 8
CACHE_DIR = os.path.join(ROOT, ".perfbench")


def process_age_s():
    """Seconds since this process started (Linux /proc), else since the
    harness was imported."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules():
    """Modules loaded in this process whose whole top-level name is JAX's,
    jaxlib's, flax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def find_cell(bench, workload):
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metric_reader(name):
    """The reader ``metrics/<name>.py`` (its ``read(ctx)``)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def net_module(name):
    return importlib.import_module(f"perfbench.nets.{name}")


def cell_metrics(bench, key, workload):
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


def p90(values):
    """The 90th percentile, linear between order statistics."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def window_metrics(latencies, frames_per_chunk, window_s):
    """The closed loop's end-to-end metrics: every frame handed over in
    the window over the window's seconds (the window ends when the last
    chunk is back), and the 90th percentile of every chunk's latency."""
    return {"frames_per_s": len(latencies) * frames_per_chunk / window_s,
            "chunk_ms_p90": p90(latencies) * 1e3}


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def say(msg):
    print(msg, file=sys.stderr, flush=True)


def run(workload, seed, seconds, trace=False, device="cuda", dtype=None,
        overrides=None):
    """One run; returns the result dict (the printed line's keys). ``dtype``
    replaces the configuration's (the lower-precision control);
    ``overrides`` replaces configuration and mix keys (small CPU runs)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = find_cell(bench, workload)
    cfg = load_json(HERE, "configs", f"{cell['config']}.json")
    from perfbench.traffic_gen import build_pool, load_mix, rng_for

    mix = load_mix(cell["traffic"])
    for key, value in (overrides or {}).items():
        (mix if key in mix else cfg)[key] = value
    limits = load_json(HERE, "limits", f"{workload}.json")

    os.makedirs(CACHE_DIR, exist_ok=True)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    import torch
    from vn_celeb_face_recognition_tpu_torch.pipeline.engine import (
        FusedRecognitionEngine,
    )
    from vn_celeb_face_recognition_tpu_torch.utils import kernels

    from perfbench import judge
    from perfbench import trace as tr

    dev = torch.device(device)
    card = card_line() if dev.type == "cuda" else "cpu"
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"]["cudnn"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"]["matmul"])
    dtype_name = dtype or cfg["dtype"]
    cdtype = getattr(torch, dtype_name)
    compile_s = kernels.build()[1] if dev.type == "cuda" else 0.0
    laps = [("build", process_age_s())]

    frames_per_chunk = int(cfg["chunk_frames"])
    pool, pool_faces = build_pool(mix, frames_per_chunk, seed, dev)
    laps.append(("traffic", process_age_s()))
    roles = [r for r in ("detector", "encoder", "classifier", "emotion")
             if cfg.get(r)]
    nets = {r: net_module(cfg[r]["net"]) for r in roles}
    built = {r: nets[r].program(cfg[r], cdtype, dev, seed) for r in roles}
    calls = {r: [] for r in roles}
    if trace:
        det = built["detector"]
        det.detect_padded = tr.spanned(det.detect_padded,
                                       tr.SPANS["detect"], calls["detector"])
        for role, span in (("encoder", "embed"), ("classifier", "classify"),
                           ("emotion", "emotion")):
            if role in built:
                built[role] = tr.Spanned(built[role], tr.SPANS[span],
                                         calls[role])
    built["classifier"] = kept = judge.LastCall(built["classifier"])
    emo = cfg.get("emotion")
    eng = cfg["engine"]
    engine = FusedRecognitionEngine(
        built["detector"], built["encoder"], built["classifier"],
        target_fs=eng["target_fs"], compute_dtype=cdtype,
        face_window=eng["face_window"], face_cap=eng["face_cap"],
        emotion=built.get("emotion"),
        emotion_size=emo["size"] if emo else 224,
        emotion_topk=emo["topk"] if emo else 6)
    laps.append(("nets", process_age_s()))
    if trace:
        engine._as_frames = tr.spanned(engine._as_frames,
                                       tr.SPANS["upload"])
    names = {i: f"celeb_{i}"
             for i in range(cfg["classifier"]["args"]["num_classes"])}
    threshold = cfg["identify"]["threshold"]
    record = (torch.profiler.record_function if trace
              else lambda name: contextlib.nullcontext())

    def chunk(i):
        with record(tr.CHUNK):
            out = engine.process_adaptive(pool[i % len(pool)])
            with record(tr.SPANS["identify"]):
                res = engine.identify(out, names, threshold)
        return out, res

    for i in range(len(pool)):  # warm-up: every chunk of the pool once
        chunk(i)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age_s()

    # ---- the window ----------------------------------------------------
    last, rows = {}, {}
    lat, faces = [], 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t_end = t_start
    i = 0
    while i == 0 or t_end < deadline:
        t0 = time.perf_counter()
        out, res = chunk(i)
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        faces += sum(len(r[0]) for r in res)
        last[i % len(pool)] = out
        rows[i % len(pool)] = kept.last
        i += 1
    window_s = t_end - t_start
    n_chunks = i
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    traced = None
    if trace:
        def step(k):
            if k == 1:
                kernels.reset_launch_counts()
                for v in calls.values():
                    v.clear()
            chunk(k)

        traced = tr.profile(step, TRACE_CHUNKS,
                            os.path.join(CACHE_DIR, "trace.json"))
        launches = kernels.launch_counts()
        result_launches = {k: v / TRACE_CHUNKS for k, v in launches.items()
                           if v}
        say(f"kernel launches a traced chunk: {result_launches}")
        traced_calls = {r: list(v) for r, v in calls.items()}

    # ---- free the program, then judge ---------------------------------
    judged = sorted(rng_for(seed, 1).choice(sorted(last), size=min(
        JUDGED_CHUNKS, len(last)), replace=False).tolist())
    keys = ("boxes", "scores", "points", "valid", "pred", "prob",
            "embeddings", "emotion_idx", "emotion_prob")
    outs = {j: {k: last[j][k].cpu().numpy() for k in keys if k in last[j]}
            for j in judged}
    for j in judged:
        outs[j]["cls_in"], outs[j]["logp"] = (t.float().cpu().numpy()
                                              for t in rows[j])
    del engine, built, kept, last, rows, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    refs = {r: nets[r].reference(cfg[r], seed, dev) for r in roles}
    thr = refs["detector"].thresholds[-1]
    per_chunk = [judge.judge_chunk(outs[j], pool[j], refs, thr, emo, dev)
                 for j in judged]
    numbers = judge.merge(per_chunk)
    del refs
    checks = {name: {"value": numbers.get(name, float("nan")),
                     "limit": limit} for name, limit in limits.items()}

    def passes(nums):
        return all(nums.get(n, float("nan")) <= lim
                   for n, lim in limits.items())

    failed = sum(not passes(c) for c in per_chunk)
    correct = failed == 0 and numbers.get("faces", 0) > 0

    # ---- metrics -------------------------------------------------------
    result = {"correct": bool(correct), "attempted": n_chunks,
              "failed": failed}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type),
        "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    if not trace:
        values = dict(window_metrics(lat, frames_per_chunk, window_s),
                      setup_s=setup_s)
        for m in cell_metrics(bench, "end_to_end", workload):
            # a suffix after the first dot names the cells a bound of its
            # own holds (``frames_per_s.host_bound``); the quantity is the
            # same
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    else:
        # what a per-layer reader (metrics/<name>.py) reads
        ctx = types.SimpleNamespace(
            trace=traced, n_chunks=TRACE_CHUNKS, launches=launches,
            calls=traced_calls, cfg=cfg, dtype=dtype_name,
            frame_hw=tuple(mix["frame_hw"]), numbers=numbers,
            judged_frames=len(judged) * frames_per_chunk,
            window={"frames": n_chunks * frames_per_chunk, "faces": faces,
                    "seconds": window_s, "latencies": lat},
            say=say)
        for m in cell_metrics(bench, "per_layer", workload):
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = traced.union_s()
        device_info["window_s"] = traced.window_s
        idle = sorted(traced.idle_by_span().items(), key=lambda kv: -kv[1])
        result["launches_per_chunk"] = result_launches
        result["breakdown"] = {"device_ops": traced.top_ops(10),
                               "idle_gaps": [list(kv) for kv in idle[:10]]}
    result["metrics"] = metrics
    result["device"] = device_info
    result["judged"] = numbers
    result["card"] = card
    result["checks"] = checks
    say(f"{workload} seed {seed}: {n_chunks} chunks of {frames_per_chunk} "
        f"frames in {window_s:.4f} s, {faces} faces identified; pool faces "
        f"{pool_faces}; set-up {setup_s:.3f} s (kernel build {compile_s:.3f}"
        f" s; process age at " + ", ".join(f"{k} {v:.2f}" for k, v in laps)
        + f"); {dtype_name}; {card}")
    say("judged pool chunks " + str(judged) + ": " + json.dumps(numbers))
    return result


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    chips = find_cell(bench, args.workload)["chips"]
    if not os.path.isdir(os.path.join(ROOT, PORT)):
        say(f"no {PORT} package at {ROOT}: nothing to measure")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"{args.workload} needs {chips} CUDA device(s); torch "
            f"{torch.__version__} sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            )
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        say(f"the run loaded {found}: the benchmark takes no JAX")
        return 3
    for name, c in result["checks"].items():
        ok = c["value"] <= c["limit"]
        say(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if ok else 'FAIL'}")
    print(json.dumps(result), flush=True)
    return 0
