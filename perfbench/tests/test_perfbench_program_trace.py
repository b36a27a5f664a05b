"""The program's spans in a Chrome trace (``program_trace.py``), the
``slot_use_pct`` readers, and the accepted reduction (``trace.py``) and
readers left as they were by the program's ranges."""

import json
import os
import types

import pytest

from perfbench import ROOT, harness
from perfbench import program_trace as pt
from perfbench import trace as tr


def X(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


U = "user_annotation"
HARNESS = [  # the harness's ranges, the runtime calls and device work
    X("ProfilerStep#1", U, 0, 1000),
    X("cudaLaunchKernel", "cuda_runtime", 2, 2, corr=7),  # before a chunk
    X("fill_kernel", "kernel", 6, 2, corr=7),
    X(tr.CHUNK, U, 10, 980),
    X("pb.upload", U, 20, 50),
    X("cudaMemcpyAsync", "cuda_runtime", 30, 5, corr=1),
    X("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 40, 100, corr=1),
    X("pb.detect", U, 100, 200),
    X("cudaLaunchKernel", "cuda_runtime", 110, 5, corr=2),
    X("void segment_tf32_first<8>(float*)", "kernel", 150, 100, corr=2),
    X("cudaLaunchKernel", "cuda_runtime", 320, 5, corr=3),
    X("similarity_warp_kernel", "kernel", 330, 20, corr=3),
    X("pb.embed", U, 400, 100),
    X("cudaLaunchKernel", "cuda_runtime", 410, 5, corr=4),
    X("cutlass_gemm", "kernel", 420, 300, corr=4),
    X("pb.embed", "gpu_user_annotation", 420, 300),
    X("cudaStreamSynchronize", "cuda_runtime", 515, 210, corr=5),
    X("pb.identify", U, 800, 150),
    X("cudaMemcpyAsync", "cuda_runtime", 810, 30, corr=6),
    X("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 815, 25, corr=6),
]
PROGRAM = [  # the program's spans, nested in and around the harness's
    X("engine.chunk", U, 12, 778),
    X("engine.upload", U, 22, 46),
    X("engine.detect", U, 95, 215),
    X("mtcnn.stage1", U, 105, 195),
    X("engine.align", U, 315, 25),
    X("engine.embed", U, 395, 110),
    X("engine.embed", "gpu_user_annotation", 420, 300),  # not a span
    X("engine.sync", U, 510, 220),
    X("engine.identify", U, 801, 148),
    X("engine.identify.fetch", U, 805, 45),
]


def test_program_spans_device_dispatch_launches_self_and_idle():
    t = pt.ProgramTrace(HARNESS + PROGRAM)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.device_s("engine.align") == pytest.approx(20e-6)
    assert t.device_s("mtcnn.stage1") == pytest.approx(100e-6)
    assert t.device_s("engine.upload") == pytest.approx(100e-6)
    assert t.device_s("engine.embed") == pytest.approx(300e-6)
    assert t.device_s("engine.detect") == 0.0  # all in its child
    assert t.device_s(pt.OUTSIDE) == pytest.approx(2e-6)
    # (778 + 148) us in engine.chunk and engine.identify, less upload 46,
    # sync 220 and fetch 45
    assert t.dispatch_s() == pytest.approx(615e-6)
    # the sync launches nothing; the call before the chunk is outside
    assert t.launches() == {"engine.upload": 1, "mtcnn.stage1": 1,
                            "engine.align": 1, "engine.embed": 1,
                            "engine.identify.fetch": 1}
    self_s = t.self_s()
    assert self_s["engine.chunk"] == pytest.approx(
        (778 - 46 - 215 - 25 - 110 - 220) * 1e-6)
    assert self_s["engine.detect"] == pytest.approx(20e-6)
    assert self_s["mtcnn.stage1"] == pytest.approx(195e-6)
    assert self_s["engine.identify"] == pytest.approx(103e-6)
    assert self_s["engine.embed"] == pytest.approx(110e-6)
    # gaps 0-6, 8-40, 140-150, 250-330, 350-420, 720-815, 840-1000 by the
    # span around each middle
    idle = t.idle_by_span()
    assert idle == pytest.approx({
        pt.OUTSIDE: 6e-6, "engine.upload": 32e-6, "mtcnn.stage1": 90e-6,
        "engine.chunk": 165e-6, "engine.identify": 160e-6})


def test_no_program_spans():
    t = pt.ProgramTrace(HARNESS)
    assert t.spans == [] and t.launches() == {} and t.dispatch_s() == 0.0
    assert t.device_s(pt.OUTSIDE) == pytest.approx(547e-6)


def ctx_for(events, config="retinaface_arcface"):
    cfg = json.load(open(os.path.join(ROOT, "perfbench", "configs",
                                      f"{config}.json")))
    return types.SimpleNamespace(
        trace=tr.Trace(events), n_chunks=1, launches={},
        calls={r: [128 if r == "detector" else 512] for r in cfg
               if r in ("detector", "encoder", "classifier", "emotion")},
        cfg=cfg, dtype="float32", frame_hw=(640, 640),
        numbers={"n_rnet": 4096, "n_onet": 1024}, judged_frames=2,
        window={"frames": 128, "faces": 444, "seconds": 0.2,
                "latencies": [0.2, 0.19, 0.21]},
        say=lambda msg: None)


BENCH = harness.load_json(ROOT, "BENCHMARK.json")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_accepted_readers_ignore_the_program_spans(cell):
    """Every accepted per-layer reader of the cell, and the reduction it
    reads, gives the same on the same events with the program's ranges
    present."""
    a, b = (ctx_for(events, cell["config"])
            for events in (HARNESS, HARNESS + PROGRAM))
    assert a.trace.ops == b.trace.ops
    assert a.trace.idle_by_span() == b.trace.idle_by_span()
    assert a.trace.top_ops() == b.trace.top_ops()
    assert a.trace.union_s() == b.trace.union_s()
    for t in range(0, 1001, 5):
        assert a.trace.span_at(t) == b.trace.span_at(t)
    read = 0
    for m in harness.cell_metrics(BENCH, "per_layer", cell["name"]):
        if m["name"].startswith("slot_use_pct"):
            continue
        reader = harness.metric_reader(m["name"])
        assert reader(a) == reader(b), m["name"]
        read += 1
    assert read >= 6


@pytest.fixture
def counters():
    from vn_celeb_face_recognition_tpu_torch.utils import tracing

    tracing.reset_counts()
    yield tracing
    tracing.reset_counts()


@pytest.mark.parametrize("name", ["slot_use_pct", "slot_use_pct.host_bound"])
def test_slot_use_reads_the_program_counters(counters, monkeypatch, name):
    read = harness.metric_reader(name)
    ctx = ctx_for(HARNESS)
    assert read(ctx) is None  # no chunk ran
    counters.count("engine.slots", 512)
    counters.count("engine.faces", 444)
    assert read(ctx) == 100.0 * 444 / 512
    # a program without the counter store (the parent's): nothing to read
    monkeypatch.delattr(counters, "counts")
    assert read(ctx) is None
