"""pytest settings for the benchmark's own tests (``perfbench/tests``):
the benchmark's folder on the path and the ``card`` marker, for tests
that need a CUDA device and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one (the "
        "decision is made inside a fixture)")
