"""Canonical 5-point alignment templates per output size (the published
ArcFace/insightface coordinates). Counterpart of the templates in
``vn_celeb_face_recognition_tpu/pipeline/align.py``."""

import numpy as np

center_point_dict = {
    "(96, 112)": np.array([
        [30.2946, 51.6963],
        [65.5318, 51.5014],
        [48.0252, 71.7366],
        [33.5493, 92.3655],
        [62.7299, 92.2041],
    ], dtype=np.float32),
    "(112, 112)": np.array([
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ], dtype=np.float32),
    "(150, 150)": np.array([
        [51.287415, 69.23612],
        [98.48009, 68.97509],
        [75.03375, 96.075806],
        [55.646385, 123.7038],
        [94.72754, 123.48763],
    ], dtype=np.float32),
    "(160, 160)": np.array([
        [54.706573, 73.85186],
        [105.045425, 73.573425],
        [80.036, 102.48086],
        [59.356144, 131.95071],
        [101.04271, 131.72014],
    ], dtype=np.float32),
    "(224, 224)": np.array([
        [76.589195, 103.3926],
        [147.0636, 103.0028],
        [112.0504, 143.4732],
        [83.098595, 184.731],
        [141.4598, 184.4082],
    ], dtype=np.float32),
}
