"""The yardstick's FLOP counts."""

from types import SimpleNamespace

import pytest
from torch import nn

from perfbench import HERE, counts, harness
from perfbench.reference import nets
from perfbench.weights import ROLES


def test_hand_counted_conv():
    # 3x3, pad 1, stride 1 on a 4x4 map: per axis the outputs see
    # 2, 3, 3, 2 taps inside the input (10), so 100 taps, x 2 channels in,
    # x 5 out, x 2 for multiply and add
    conv = counts.meta_module(lambda: nn.Conv2d(2, 5, 3, 1, 1, bias=False))
    assert counts.model_flops(conv, 1, 2, 4, 4) == 2 * 100 * 2 * 5
    # stride 2, no padding, 5x5 -> 2x2: every tap inside
    conv = counts.meta_module(lambda: nn.Conv2d(3, 4, 3, 2, 0))
    assert counts.model_flops(conv, 1, 3, 5, 5) == 2 * 4 * 9 * 3 * 4
    # depthwise: one input channel a group
    conv = counts.meta_module(lambda: nn.Conv2d(8, 8, 3, 1, 1, groups=8))
    assert counts.model_flops(conv, 1, 8, 4, 4) == 2 * 100 * 1 * 8


def test_linear():
    fc = counts.meta_module(lambda: nn.Linear(512, 1021))
    assert counts.model_flops(fc, 1, 512) == 2 * 512 * 1021


@pytest.mark.parametrize("make,shape,gflop", [
    (lambda: nets.IResNet(100), (1, 3, 112, 112), 22.76),
    (lambda: nets.ResNet2Branch(690, 300), (1, 3, 224, 224), 8.11),
])
def test_networks_against_xla_counts(make, shape, gflop):
    # per-face figures of XLA's cost analysis of the JAX programs
    # (bench_flops.json: encoder and emotion over 512 faces)
    got = counts.model_flops(counts.meta_module(make), *shape) / 1e9
    assert got == pytest.approx(gflop, rel=0.03)


def test_kernel_counters():
    # K6's stage 1 on a 640x640 frame; K8's chains at 64 faces in f32
    assert counts.mnet_stage1_flops(640, 640) == sum(
        counts.stage1_block_flops(640, 640))
    nbytes, flops = counts.bottleneck_chain_work(64, 4)
    assert flops == 64 * (2 * 56 * 56 * 2 * (2 * 256 * 64 + 9 * 64 * 64)
                          + 3 * 28 * 28 * 2 * (2 * 512 * 128
                                               + 9 * 128 * 128))
    t, by = counts.bound_s(nbytes, flops, counts.RATE["float32"])
    assert by == "operations" and t == pytest.approx(flops / 165e12)


@pytest.mark.parametrize("config", ["retinaface_arcface", "mtcnn_facenet"])
def test_every_net_counts_its_own_flops(config):
    # each nets/<net>.py counts its net: a frame for the detector, a face
    # for the others, so the mfu reader never asks which net it is
    cfg = harness.load_json(HERE, "configs", f"{config}.json")
    ctx = SimpleNamespace(cfg=cfg, frame_hw=(640, 640), judged_frames=256,
                          numbers={"n_rnet": 4096, "n_onet": 1024})
    got = {role: harness.net_module(cfg[role]["net"]).flops(cfg[role], ctx)
           for role in ROLES if cfg.get(role)}
    assert all(v > 0 for v in got.values())
    if cfg["encoder"]["net"] == "iresnet100":
        assert got["encoder"] / 1e9 == pytest.approx(22.76, rel=0.03)
        assert got["emotion"] / 1e9 == pytest.approx(8.11, rel=0.03)
    assert got["classifier"] == 2 * 2048 * (
        512 + cfg["classifier"]["args"]["num_classes"])
