"""The fused engine's spans and counters (``utils.tracing``) on the CPU,
on ``test_torch_engine``'s MTCNN chunk: under ``torch.profiler`` one
``process_adaptive`` plus ``identify`` opens each span where the work
happens, nested as the engine's docstring lists them; ``engine.slots``
counts every run's slots, a retry's too, and ``engine.faces`` the faces
``identify`` names; a profiler changes no output; with no profiler the
counters still count and no range is entered."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from vn_celeb_face_recognition_tpu_torch.utils import kernels, tracing

from test_torch_engine import FACE_CAP, N_CLASSES
from test_torch_engine import setup  # noqa: F401 (the MTCNN fixture)
from torch_shared import two_threads  # noqa: F401 (autouse)

NAMES = {label: f"P{label}" for label in range(N_CLASSES)}
PROGRAM = ("engine.", "mtcnn.", "retinaface.")
# each span's parent span and how many times a chunk opens it, when the
# chunk fits its first bucket; a retry runs the chunk's ``process`` again
# inside ``engine.retry``
PARENT = {"engine.chunk": None, "engine.detect": "engine.chunk",
          "mtcnn.stage1": "engine.detect", "mtcnn.rnet": "engine.detect",
          "mtcnn.onet": "engine.detect", "engine.compact": "engine.chunk",
          "engine.align": "engine.chunk", "engine.embed": "engine.chunk",
          "engine.classify": "engine.chunk", "engine.sync": "engine.chunk",
          "engine.identify": None,
          "engine.identify.fetch": "engine.identify"}
PER_RUN = ("engine.detect", "mtcnn.stage1", "mtcnn.rnet", "mtcnn.onet",
           "engine.align", "engine.embed", "engine.classify")


def program_spans(prof):
    """(name, parent, start, end) of the program's spans in a profile, by
    start; ``parent`` is the innermost program span the profiler nested
    it in (None at the top)."""
    out = []
    for e in prof.events():
        if not e.name.startswith(PROGRAM):
            continue
        up = e.cpu_parent
        while up is not None and not up.name.startswith(PROGRAM):
            up = up.cpu_parent
        out.append((e.name, up.name if up is not None else None,
                    e.time_range.start, e.time_range.end))
    return sorted(out, key=lambda r: (r[2], -r[3]))


def chunk(eng, frames):
    out = eng.process_adaptive(frames)
    return out, eng.identify(out, NAMES, 0.0)


@pytest.mark.parametrize("hint,runs", [(None, 1), (1, 2)],
                         ids=["fits", "overflows"])
def test_spans_nest_and_counters_count(setup, hint, runs):
    """A chunk that fits its bucket, and one that overflows the first and
    re-runs at the next bucket up inside ``engine.retry``."""
    frames, engine, _, _ = setup
    eng = engine(face_cap=[2, FACE_CAP], face_hint=hint)
    tracing.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, res = chunk(eng, frames)
    spans = program_spans(prof)
    seen = {}
    for name, *_ in spans:
        seen[name] = seen.get(name, 0) + 1
    want = {name: runs if name in PER_RUN else 1 for name in PARENT}
    # compaction: the selection, then the scatter back, in every run
    want.update({"engine.compact": 2 * runs, "engine.sync": runs})
    if runs > 1:
        want["engine.retry"] = runs - 1
    assert seen == want  # no upload: the CPU chunk is copied nowhere
    in_retry = set()
    for name, parent, _, _ in spans:
        if name == "engine.retry":
            assert parent == "engine.chunk"
        elif parent == "engine.retry":
            in_retry.add(name)
        else:
            assert parent == PARENT[name], (name, parent)
    # the re-run's own spans nest inside the retry (the detector's inside
    # its engine.detect)
    assert in_retry == ({"engine.detect", "engine.compact", "engine.align",
                         "engine.embed", "engine.classify"} if runs > 1
                        else set())
    assert out["_face_cap_used"] == FACE_CAP
    c = tracing.counts()
    assert c["engine.slots"] == (FACE_CAP if runs == 1 else 2 + FACE_CAP)
    named = sum(len(frame_names) for frame_names, _ in res)
    assert c["engine.faces"] == named == int(out["valid"].sum()) >= 6


def test_profiler_changes_no_output(setup):
    frames, engine, _, _ = setup
    plain = chunk(engine(face_cap=[2, FACE_CAP]), frames)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = chunk(engine(face_cap=[2, FACE_CAP]), frames)
    assert plain[0].keys() == traced[0].keys()
    for key, v in plain[0].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, traced[0][key]), key
        else:
            assert v == traced[0][key], key
    for (names_a, boxes_a), (names_b, boxes_b) in zip(plain[1], traced[1]):
        assert names_a == names_b
        np.testing.assert_array_equal(np.array(boxes_a), np.array(boxes_b))


def test_no_profiler_counts_and_enters_no_range(setup, monkeypatch):
    frames, engine, _, _ = setup
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    kernels.reset_launch_counts()  # the one store: every counter
    assert tracing.counts() == {}
    _, res = chunk(engine(face_cap=[2, FACE_CAP]), frames)
    assert entered == []
    c = tracing.counts()
    assert c["engine.slots"] == FACE_CAP
    assert c["engine.faces"] == sum(len(n) for n, _ in res)
    # CPU tensors: the plain versions, no kernel launch
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("method", ["detect_padded", "infer_padded"])
def test_retinaface_spans(method):
    """RetinaFace's two spans, the net and the selection after it, once a
    call each, with the same outputs as without a profiler."""
    from vn_celeb_face_recognition_tpu_torch.models import retinaface as TR
    from vn_celeb_face_recognition_tpu_torch.utils.frames import (
        build_frames,
    )

    det = TR.RetinaFace(weights_path=TR.WEIGHTS_NPZ, device="cpu")
    frames = torch.from_numpy(build_frames(1, 128, 4, 56))
    plain = getattr(det, method)(frames)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = getattr(det, method)(frames)
    assert [s[:2] for s in program_spans(prof)] == [
        ("retinaface.net", None), ("retinaface.select", None)]
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
