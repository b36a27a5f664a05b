"""On the card, at each cell's own size: a short run is correct, and the
program's bfloat16 path (the lower-precision control) is not. Skips
without a CUDA device; run on the card with

    python -m pytest perfbench/tests -m card
"""

import json
import os

import pytest

from perfbench import ROOT, harness

CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(card, cell):
    res = harness.run(cell, 2 ** 31 + 303, 3.0)
    assert res["correct"], res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    res = harness.run(cell, 2 ** 31 + 304, 3.0, dtype="bfloat16")
    assert not res["correct"], res["checks"]
