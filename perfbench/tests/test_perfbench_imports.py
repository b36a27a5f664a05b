"""The check that a run loaded no JAX compares whole top-level names."""

import sys
import types

import pytest

from perfbench import harness


@pytest.mark.parametrize("name,caught", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("vn_celeb_face_recognition_tpu", True),
    ("vn_celeb_face_recognition_tpu.models.mtcnn", True),
    ("vn_celeb_face_recognition_tpu_torch", False),
    ("vn_celeb_face_recognition_tpu_torch.pipeline.engine", False),
    ("jaxtyping", False),
])
def test_top_level_names(monkeypatch, name, caught):
    for key in [k for k in sys.modules
                if k.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, key)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert (found == [name.split(".")[0]]) == caught
    assert bool(found) == caught


def test_the_harness_imports_no_jax():
    # the harness's own modules and the reference, on a clean import
    import subprocess

    code = ("import sys; from perfbench import harness, judge, counts, "
            "traffic_gen, trace, readers; from perfbench.reference import "
            "nets, detect, align; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "set(harness.FORBIDDEN)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, check=True).stdout
    assert out.strip() == "[]"
