"""Alone in a directory (BENCHMARK.json and the benchmark's folder, no
program), a run exits non-zero and prints no result."""

import os
import shutil
import subprocess
import sys

from perfbench import ROOT


def test_exits_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "retinaface_arcface.crowd", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "vn_celeb_face_recognition_tpu_torch" in proc.stderr
