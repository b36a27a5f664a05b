"""The traffic generator: seeds, and each mix's faces a frame."""

import numpy as np
import pytest
import torch

from perfbench import traffic_gen as tg


def small_pool(mix, seed):
    return tg.build_pool(tg.load_mix(mix), 6, seed, torch.device("cpu"),
                         n_chunks=2)


@pytest.mark.parametrize("mix", ["crowd", "sparse"])
def test_same_seed_same_chunks_other_seed_other_chunks(mix):
    a, fa = small_pool(mix, 2 ** 31 + 5)
    b, fb = small_pool(mix, 2 ** 31 + 5)
    c, _ = small_pool(mix, 2 ** 31 + 6)
    assert fa == fb
    for x, y in zip(a, b):
        assert x.dtype == np.uint8 and x.shape == (6, 640, 640, 3)
        assert np.array_equal(x, y)
    assert any(not np.array_equal(x, z) for x, z in zip(a, c))


@pytest.mark.parametrize("mix,want,faces", [
    ("crowd", {1: 22, 2: 22, 3: 21, 4: 21, 5: 21, 6: 21}, 444),
    ("sparse", {0: 77, 1: 38, 2: 13}, 64),
])
def test_faces_a_frame_distribution(mix, want, faces):
    m = tg.load_mix(mix)
    counts = tg.counts_multiset(m["faces_per_frame"], 128)
    got = {int(k): int(n) for k, n in zip(*np.unique(counts,
                                                     return_counts=True))}
    assert got == want and counts.sum() == faces
    for seed in (0, 1, 2 ** 33 + 1):
        plan = tg.plan_chunk(m, 128, tg.rng_for(seed), 20)
        per_frame = np.bincount([f[0] for f in plan], minlength=128)
        assert sorted(per_frame) == sorted(counts)
        lo, hi = m["face_px"]
        sizes = sorted(f[2] for f in plan)
        assert lo <= sizes[0] and sizes[-1] <= hi
        assert sizes == sorted(lo + np.floor((np.arange(faces) + 0.5)
                                             * (hi - lo + 1) / faces)
                               .astype(int))


def test_faces_stay_in_their_cells():
    m = tg.load_mix("crowd")
    cell = m["frame_hw"][0] // m["grid"]
    for frame, _, s, y0, x0 in tg.plan_chunk(m, 128, tg.rng_for(3), 20):
        assert y0 // cell == (y0 + s - 1) // cell
        assert x0 // cell == (x0 + s - 1) // cell
