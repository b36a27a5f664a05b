"""Seeded video chunks: real faces pasted on a flat background.

A traffic mix (``traffic/<name>.json``) gives the frame size, the grey
level of the background, the grid of cells a face may sit in, the range
of face sizes, the weights of each number of faces a frame, and how many
distinct chunks the pool holds. From the run's seed this module draws, for
every chunk, which frame holds how many faces, which cells they take, each
face's picture (one of the repo's ``data/*.png`` crops), its size and its
jitter inside its cell.

The work a chunk asks for does not hang on the seed: each chunk's numbers
of faces a frame are the mix's weights spread over its frames by largest
remainder (the same multiset in every chunk, shuffled), and its face sizes
are evenly spaced over the range (shuffled). The seed moves only which
face, where, and in which order.

A copy of the idea of ``bench.build_frames`` (real crops on a grey
background) with a seed, several face sizes and a face count a frame.
"""

import glob
import json
import os

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from perfbench import HERE, ROOT

FACES_GLOB = os.path.join("data", "*.png")


def load_mix(name):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def face_files(root=ROOT):
    files = sorted(glob.glob(os.path.join(root, FACES_GLOB)))
    if not files:
        raise FileNotFoundError(f"no face pictures at {root}/{FACES_GLOB}")
    return files


def read_rgb(path):
    """A picture as an HxWx3 uint8 array."""
    with Image.open(path) as im:
        return np.array(im.convert("RGB"))


def counts_multiset(weights, n_frames):
    """The faces-a-frame counts of one chunk: ``n_frames`` values spread
    over the weighted counts by largest remainder (ties to the smaller
    count)."""
    keys = sorted(int(k) for k in weights)
    w = np.array([float(weights[str(k)]) for k in keys])
    share = w / w.sum() * n_frames
    n = np.floor(share).astype(int)
    order = sorted(range(len(keys)), key=lambda i: (-(share[i] - n[i]), i))
    for i in order[:n_frames - int(n.sum())]:
        n[i] += 1
    return np.repeat(keys, n)


def plan_chunk(mix, n_frames, rng, n_files):
    """[(frame, file, size, y0, x0)] for every face of one chunk."""
    h, w = mix["frame_hw"]
    grid = mix["grid"]
    ch, cw = h // grid, w // grid
    lo, hi = mix["face_px"]
    counts = rng.permutation(counts_multiset(mix["faces_per_frame"],
                                             n_frames))
    total = int(counts.sum())
    sizes = lo + np.floor((np.arange(total) + 0.5) * (hi - lo + 1)
                          / max(total, 1)).astype(int)
    sizes = rng.permutation(sizes)
    faces, i = [], 0
    for frame, k in enumerate(counts):
        for cell in rng.choice(grid * grid, size=int(k), replace=False):
            r, c = divmod(int(cell), grid)
            s = int(sizes[i])
            y0 = r * ch + int(rng.integers(0, max(ch - s, 0) + 1))
            x0 = c * cw + int(rng.integers(0, max(cw - s, 0) + 1))
            faces.append((frame, int(rng.integers(n_files)), s, y0, x0))
            i += 1
    return faces


class FacePainter:
    """The face pictures on ``device``, each resized (bicubic with
    antialiasing, rounded to uint8) once for every size asked."""

    def __init__(self, device, root=ROOT):
        self.src = [torch.from_numpy(read_rgb(f)).to(device)
                    .permute(2, 0, 1)[None].to(torch.float32)
                    for f in face_files(root)]
        self.cache = {}

    def face(self, i, size):
        key = (i, size)
        if key not in self.cache:
            x = F.interpolate(self.src[i], size=(size, size), mode="bicubic",
                              align_corners=False, antialias=True)
            self.cache[key] = (x.clamp(0, 255).round().to(torch.uint8)[0]
                               .permute(1, 2, 0))
        return self.cache[key]


def rng_for(seed, stream=0):
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & (2 ** 64 - 1), 0x7AF1C, stream]))


def build_pool(mix, n_frames, seed, device, n_chunks=None):
    """The mix's pool of distinct chunks for ``seed``: a list of host
    uint8 arrays [n_frames, H, W, 3], and the faces a chunk holds."""
    rng = rng_for(seed)
    painter = FacePainter(device)
    h, w = mix["frame_hw"]
    pool, n_faces = [], []
    for _ in range(n_chunks or mix["pool_chunks"]):
        frames = torch.full((n_frames, h, w, 3), mix["background"],
                            dtype=torch.uint8, device=device)
        plan = plan_chunk(mix, n_frames, rng, len(painter.src))
        for frame, f, s, y0, x0 in plan:
            frames[frame, y0:y0 + s, x0:x0 + s] = painter.face(f, s)
        pool.append(np.ascontiguousarray(frames.cpu().numpy()))
        n_faces.append(len(plan))
    return pool, n_faces
