"""The frozen counters kept for kernel rooflines: K6's segments, K1's
footprint and K3's IoU tests, on cases small enough to count by hand."""

import torch

from perfbench import counts


def test_segments_add_up_to_the_stage():
    work = counts.mnet_segment_work(2, 64, 48, itemsize=4)
    assert sum(f for _, f in work.values()) == \
        2 * counts.mnet_stage1_flops(64, 48)
    # segment 1 reads the u8 frames and writes 16 channels at 32x24
    assert work["segment 1"][0] == 2 * (64 * 48 * 3 + 32 * 24 * 16 * 4)


def test_warp_footprint_of_the_identity():
    # the identity map on a 4 x 4 face from a 6 x 6 window reads the 5 x 5
    # pixels the taps (x0, x0 + 1) reach, of each face's own window
    eye = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]]).repeat(2, 1, 1)
    assert counts.warp_footprint_pixels(eye, 6, 4) == 2 * 25
    # two faces whose windows sit at the same place of one frame share it
    at = (torch.tensor([0, 0]), torch.tensor([1, 1]), torch.tensor([2, 2]),
          (1, 10, 10))
    assert counts.warp_footprint_pixels(eye, 6, 4, frames_at=at) == 25


def test_nms_iou_tests_by_hand():
    # three boxes in priority order: 0 kept, 1 overlaps 0 and goes, 2 is
    # apart and stays: 1 is tested against 0 once; 2 against 0 (kept
    # ahead) once; 0 against nothing
    boxes = torch.tensor([[[0.0, 0, 10, 10], [1.0, 1, 10, 10],
                           [20.0, 20, 30, 30]]])
    scores = torch.tensor([[0.9, 0.8, 0.7]])
    valid = torch.ones(1, 3, dtype=torch.bool)
    keep = torch.tensor([[True, False, True]])
    assert counts.nms_iou_tests(boxes, scores, valid, keep, 0.5, 0.0,
                                False) == 2
    t, by = counts.bound_3xtf32_s(0, 495e12)
    assert by == "operations" and abs(t - 3.0) < 1e-12
