"""The reduction of a Chrome trace to per-span device time, busy time and
idle gaps."""

import pytest

from perfbench import trace as tr


def X(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    X("ProfilerStep#1", "user_annotation", 0, 1000),
    X(tr.CHUNK, "user_annotation", 10, 980),
    X("pb.upload", "user_annotation", 20, 50),
    X("cudaMemcpyAsync", "cuda_runtime", 30, 5, corr=1),
    X("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 40, 100, corr=1),
    X("pb.detect", "user_annotation", 100, 200),
    X("cudaLaunchKernel", "cuda_runtime", 110, 5, corr=2),
    X("void segment_tf32_first<8>(float*)", "kernel", 150, 100, corr=2),
    X("cudaLaunchKernel", "cuda_runtime", 320, 5, corr=3),  # engine code
    X("similarity_warp_kernel", "kernel", 330, 20, corr=3),
    X("pb.embed", "user_annotation", 400, 100),
    X("cudaLaunchKernel", "cuda_runtime", 410, 5, corr=4),
    X("cutlass_gemm", "kernel", 420, 300, corr=4),
    X("pb.identify", "user_annotation", 800, 150),
]


def test_attribution_busy_and_gaps():
    t = tr.Trace(EVENTS)
    assert t.window_s == pytest.approx(1000e-6)
    spans = {o[0]: o[4] for o in t.ops}
    assert spans["Memcpy HtoD (Pageable -> Device)"] == "pb.upload"
    assert spans["void segment_tf32_first<8>(float*)"] == "pb.detect"
    assert spans["similarity_warp_kernel"] == "pb.engine"
    assert spans["cutlass_gemm"] == "pb.embed"
    assert t.device_s(span="pb.embed") == pytest.approx(300e-6)
    assert t.count(("segment_tf32_first", "segment_tf32")) == 1
    assert t.device_s(grids=("segment_tf32",)) == 0.0
    # kernels: 150-250, 330-350, 420-720; the copy 40-140
    assert t.union_s(cats=("kernel",)) == pytest.approx(420e-6)
    assert t.union_s() == pytest.approx(520e-6)
    idle = t.idle_by_span()
    assert sum(idle.values()) == pytest.approx(480e-6)
    assert idle["pb.identify"] == pytest.approx(280e-6)  # 720-1000
    assert t.top_ops(1) == [["cutlass_gemm", pytest.approx(300e-6)]]
