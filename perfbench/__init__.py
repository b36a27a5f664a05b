"""The benchmark of the PyTorch and CUDA port
(``vn_celeb_face_recognition_tpu_torch``): ``run.py`` runs one cell of
``BENCHMARK.json``. Everything it measures with (traffic, weights, the
reference, the comparison, the counters and the readers of per-layer
metrics) lives in this folder; from the port it takes only the system
under test."""

import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
