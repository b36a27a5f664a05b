"""The port's iresnet encoder and the weight conversion of every
production net against the JAX package, on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.models import iresnet as JI
from vn_celeb_face_recognition_tpu.models import resnet_2branch_50 as jres50
from vn_celeb_face_recognition_tpu.models.retinaface import (
    RetinaFaceNet as JRetinaFaceNet,
)
from vn_celeb_face_recognition_tpu_torch.models import (
    IResNet,
    RetinaFaceNet,
    iresnet34,
    iresnet50,
    iresnet100,
    resnet_2branch_50,
)
from vn_celeb_face_recognition_tpu_torch.models.convert import (
    state_dict_from_jax,
)

from test_torch_encoder import load_pair
from torch_shared import two_threads  # noqa: F401 (autouse)

SHALLOW = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def shallow():
    return load_pair(IResNet(SHALLOW), seed=21)


@pytest.fixture(scope="module")
def faces():
    return np.random.default_rng(3).uniform(-1, 1, (2, 112, 112, 3)).astype(
        np.float32)


@pytest.mark.parametrize("layers", [
    SHALLOW, pytest.param((3, 13, 30, 3), marks=pytest.mark.slow)],
    ids=["shallow", "iresnet100"])
def test_iresnet_matches_flax(shallow, faces, layers):
    """Every part of the block, the channel-major flatten, the f32 fc and
    the ``features`` BatchNorm1d; dropout is inactive at inference."""
    enc, jvars = (shallow if layers == SHALLOW
                  else load_pair(IResNet(layers), seed=22))
    want = np.asarray(JI.IResNet(layers=layers).apply(
        jvars, jnp.asarray(faces)))
    with torch.no_grad():
        got = enc(torch.from_numpy(faces).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 512) and got.dtype == np.float32
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.9999, cos
    # random weights without normalisation grow with depth (~1e12 at
    # full depth): hold the error relative to the output's scale
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=2e-4,
                               atol=2e-4)


def test_iresnet_bf16_trunk_keeps_f32_head(shallow, faces):
    enc, _ = shallow
    x = torch.from_numpy(faces).permute(0, 3, 1, 2)
    enc.dtype = torch.bfloat16
    try:
        with torch.no_grad():
            got = enc(x)
    finally:
        enc.dtype = torch.float32
    with torch.no_grad():
        ref = enc(x)
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in enc.parameters())
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    assert float(cos.min()) > 0.99


def _zeros_like_jax(module, x):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


@pytest.mark.parametrize("name", ["iresnet100", "resnet_2branch_50",
                                  "retinaface"])
def test_jax_variables_load_into_full_size_nets(name):
    """``state_dict_from_jax`` maps the JAX variables of every production
    net (flax PReLU, BatchNorm1d ``features``, depthwise convs, Dense
    heads) onto the port's full-size module, key for key and shape for
    shape."""
    if name == "iresnet100":
        port = iresnet100()
        jvars = _zeros_like_jax(JI.iresnet100(), jnp.zeros((1, 112, 112, 3)))
        assert [len(getattr(port, f"layer{i}")) for i in range(1, 5)] == [
            3, 13, 30, 3]
    elif name == "resnet_2branch_50":
        port = resnet_2branch_50(num_classes=690)
        jvars = _zeros_like_jax(jres50(num_classes=690),
                                jnp.zeros((1, 64, 64, 3)))
    else:
        port = RetinaFaceNet()
        jvars = _zeros_like_jax(
            JRetinaFaceNet(backbone="mobilenet0.25", out_channel=64),
            jnp.zeros((1, 64, 64, 3)))
    sd = state_dict_from_jax(jvars)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    port.load_state_dict(sd, strict=True)


def test_iresnet_depths():
    for factory, layers in ((iresnet34, (3, 4, 6, 3)),
                            (iresnet50, (3, 4, 14, 3)),
                            (iresnet100, (3, 13, 30, 3))):
        net = factory()
        assert tuple(len(getattr(net, f"layer{i}"))
                     for i in range(1, 5)) == layers
