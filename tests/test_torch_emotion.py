"""The port's 2-branch emotion ResNet-50 and its kernels K7 (stem) and K8
(bottleneck chain) against the JAX package, on the CPU: the plain
versions against the TPU kernels in interpret mode and the flax modules,
and the kernels' host-side folds (the arithmetic the CUDA kernels run)
against the unfolded modules."""

import flax.linen as nn
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.models.resnet_2_branch import (
    ResNet2Branch as JResNet2Branch,
)
from vn_celeb_face_recognition_tpu.models.resnet_common import (
    Bottleneck as JBottleneck,
)
from vn_celeb_face_recognition_tpu.ops.bottleneck_pallas import (
    bottleneck_chain as j_chain,
)
from vn_celeb_face_recognition_tpu.ops.bottleneck_pallas import (
    emotion_apply_fused_l12,
    fold_layer_tail,
)
from vn_celeb_face_recognition_tpu.ops.emotion_stem_pallas import (
    emotion_apply_fused,
    emotion_stem_pallas,
)
from vn_celeb_face_recognition_tpu.ops.image import (
    area_resize as j_area_resize,
)
from vn_celeb_face_recognition_tpu.ops.image import (
    imagenet_normalize as j_imagenet_normalize,
)
from vn_celeb_face_recognition_tpu_torch.models import ResNet2Branch
from vn_celeb_face_recognition_tpu_torch.models.resnet_common import ResLayer
from vn_celeb_face_recognition_tpu_torch.ops import bottleneck as K8
from vn_celeb_face_recognition_tpu_torch.ops import emotion_stem as K7
from vn_celeb_face_recognition_tpu_torch.ops.image import (
    area_resize,
    imagenet_normalize,
)
from vn_celeb_face_recognition_tpu_torch.utils import kernels

from test_torch_encoder import load_pair
from torch_shared import two_threads  # noqa: F401 (autouse)


def emotion_pair(seed=7, num_classes=17, layers=(3, 4, 6, 3)):
    """Port and JAX 2-branch nets on the same random weights; the heads
    are scaled so the logits are of order one."""
    net, jvars = load_pair(ResNet2Branch(layers, num_classes=num_classes),
                           seed=seed)
    with torch.no_grad():
        for head in (net.fc, net.proj):
            head.weight.mul_(0.002)
    for head in ("fc", "proj"):
        jvars["params"][head]["kernel"] = (
            net.state_dict()[f"{head}.weight"].numpy().T.copy())
    return net, jvars


# layer1 and layer2 keep the tails K8 runs (2 and 3 blocks) and the
# depth the JAX fused l1/l2 path assumes; layer3/4 are cut to one block
SHALLOW = (3, 4, 1, 1)


@pytest.fixture(scope="module")
def pair():
    return emotion_pair(layers=SHALLOW)


@pytest.fixture(scope="module")
def faces():
    return np.random.default_rng(4).uniform(0, 255, (3, 112, 112, 3)).astype(
        np.float32)


def _stem_nhwc(got):
    return got.numpy() if got.is_contiguous() else got.contiguous().numpy()


def test_imagenet_normalize_and_upsample_match_jax(faces):
    x = torch.from_numpy(faces)
    got = imagenet_normalize(area_resize(x, (224, 224)) / 255.0)
    want = j_imagenet_normalize(j_area_resize(jnp.asarray(faces),
                                              (224, 224)) / 255.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # 112 -> 224 is exact 2x2 duplication
    up = area_resize(x, (224, 224))
    np.testing.assert_array_equal(up[:, ::2, ::2].numpy(), faces)
    np.testing.assert_array_equal(up[:, 1::2, 1::2].numpy(), faces)


def test_stem_plain_matches_tpu_kernel(pair, faces):
    """K7's plain version against the Pallas stem in interpret mode and
    the flax conv/BN/pool, at tests/test_emotion_stem.py's 1e-4."""
    net, jvars = pair
    p, st = jvars["params"], jvars["batch_stats"]
    before = kernels.launch_counts()
    got = _stem_nhwc(K7.emotion_stem(net.conv1, net.bn1,
                                     torch.from_numpy(faces), torch.float32))
    assert kernels.launch_counts() == before
    assert got.shape == (3, 56, 56, 64)
    pallas = emotion_stem_pallas(p, st, jnp.asarray(faces),
                                 dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4,
                               atol=1e-4)
    ex = j_imagenet_normalize(j_area_resize(jnp.asarray(faces),
                                            (224, 224)) / 255.0)
    x = nn.Conv(64, (7, 7), strides=(2, 2), padding=((3, 3), (3, 3)),
                use_bias=False).apply({"params": p["conv1"]}, ex)
    x = (x - st["bn1"]["mean"]) / jnp.sqrt(st["bn1"]["var"] + 1e-5) \
        * p["bn1"]["scale"] + p["bn1"]["bias"]
    x = nn.max_pool(nn.relu(x), (3, 3), strides=(2, 2),
                    padding=((1, 1), (1, 1)))
    np.testing.assert_allclose(got, np.asarray(x), rtol=1e-4, atol=1e-4)


def test_stem_fold_is_the_kernels_arithmetic(pair, faces):
    """What csrc/emotion_stem.cu computes, in torch: the folded 4x4/1
    conv (BN folded) on the normalised 112 px face, padded 2 before and
    1 after, then ReLU and the 3x3/2 max pool, equals the plain stem."""
    net, _ = pair
    folded = K7.fold_stem_weights(net.conv1, net.bn1)
    w = folded[:48 * 64].reshape(4, 4, 3, 64).permute(3, 2, 0, 1)
    bias = folded[48 * 64:]
    x = imagenet_normalize(torch.from_numpy(faces) / 255.0)
    x = F.pad(x.permute(0, 3, 1, 2), (2, 1, 2, 1))
    y = F.max_pool2d(F.relu(F.conv2d(x, w, bias)), 3, 2, 1)
    want = K7.emotion_stem_plain(net.conv1, net.bn1, torch.from_numpy(faces),
                                 torch.float32)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(),
                               _stem_nhwc(want), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=[(64, 3, 56, 1), (128, 4, 28, 2)],
                ids=["l1", "l2"])
def tail(request):
    """A ResLayer's stride-1 tail (port blocks, JAX folded weights) and a
    non-negative input at the emotion net's l1/l2 shapes."""
    planes, blocks, side, n = request.param
    stride, inplanes = (1, 64) if planes == 64 else (2, 256)
    layer, jvars = load_pair(ResLayer(planes, blocks, stride, inplanes),
                             seed=planes)
    x = np.maximum(np.random.default_rng(planes).normal(
        0, 1, (n, side, side, planes * 4)), 0).astype(np.float32)
    return list(layer)[1:], jvars, x, planes


def test_bottleneck_chain_plain_matches_tpu_kernel(tail):
    """K8's plain version against the Pallas chain in interpret mode and
    the flax blocks, at tests/test_bottleneck_pallas.py's 2e-4."""
    blocks, jvars, x, planes = tail
    before = kernels.launch_counts()
    got = K8.bottleneck_chain(blocks, torch.from_numpy(x)).contiguous()
    assert kernels.launch_counts() == before
    folded = fold_layer_tail(jvars["params"], jvars["batch_stats"],
                             len(blocks))
    want = j_chain(jnp.asarray(x), folded, x.shape[1], x.shape[2], planes,
                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    ref = jnp.asarray(x)
    for i in range(1, len(blocks) + 1):
        ref = JBottleneck(planes).apply(
            {"params": jvars["params"][str(i)],
             "batch_stats": jvars["batch_stats"][str(i)]}, ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_bottleneck_fold_is_the_kernels_arithmetic(tail):
    """What csrc/bottleneck_chain.cu computes per block, in torch from
    ``fold_block``'s weights: t1 = relu(x W1 + b1), t2 = relu(3x3 taps of
    t1 W2 + b2), y = relu(t2 W3 + b3 + x); equals the plain chain."""
    blocks, _, x, _ = tail
    y = torch.from_numpy(x)
    for blk in blocks:
        w1, b1, w2, b2, w3, b3 = K8.fold_block(blk, torch.float32)
        t1 = torch.relu(y @ w1 + b1)
        tp = F.pad(t1, (0, 0, 1, 1, 1, 1))
        h, w = t1.shape[1:3]
        t2 = sum(tp[:, dy:dy + h, dx:dx + w] @ w2[dy * 3 + dx]
                 for dy in range(3) for dx in range(3))
        t2 = torch.relu(t2 + b2)
        y = torch.relu(t2 @ w3 + b3 + y)
    want = K8.bottleneck_chain_plain(blocks, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), want.contiguous().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layers", [
    SHALLOW, pytest.param((3, 4, 6, 3), marks=pytest.mark.slow)],
    ids=["shallow", "resnet50"])
def test_resnet_2branch_matches_flax(pair, faces, layers):
    """forward (K7 + K8's wrappers on 112 px faces) against
    ResNet2Branch.apply on the resized, normalised faces and the JAX
    package's fused stem and fused l1/l2 paths (interpret mode), at
    2e-4."""
    net, jvars = pair if layers == SHALLOW else emotion_pair(layers=layers)
    jmod = JResNet2Branch(layers=layers, num_classes=17)
    two = faces[:2]
    ex = j_imagenet_normalize(j_area_resize(jnp.asarray(two), (224, 224))
                              / 255.0)
    want_cls, want_proj = jmod.apply(jvars, ex, train=False)
    before = kernels.launch_counts()
    with torch.no_grad():
        got_cls, got_proj = net(torch.from_numpy(two))
    assert kernels.launch_counts() == before  # CPU: the plain versions
    assert got_cls.shape == (2, 17) and got_proj.shape == (2, 300)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_proj.numpy(), np.asarray(want_proj),
                               rtol=2e-4, atol=2e-4)
    fused_cls, _ = emotion_apply_fused(jmod, jvars, jnp.asarray(two),
                                       dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(fused_cls),
                               rtol=2e-4, atol=2e-4)
    l12_cls, _ = emotion_apply_fused_l12(jmod, jvars, ex, interpret=True)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(l12_cls),
                               rtol=2e-4, atol=2e-4)
