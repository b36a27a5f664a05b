"""Parity of the port's InceptionResnetV1, MLP and JAX->torch weight
converter against the JAX package, on the CPU, on the same random
weights (made with numpy, converted into JAX variables by the JAX
package's own converter)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.models.inception_resnet_v1 import (
    InceptionResnetV1 as JEnc,
)
from vn_celeb_face_recognition_tpu.models.mlp import MLPModel as JMLP
from vn_celeb_face_recognition_tpu.models.torch_convert import (
    convert_state_dict,
    flax_to_torch_state_dict,
)
from vn_celeb_face_recognition_tpu_torch.models.convert import (
    state_dict_from_jax,
)
from vn_celeb_face_recognition_tpu_torch.models.inception_resnet_v1 import (
    InceptionResnetV1 as TEnc,
)
from vn_celeb_face_recognition_tpu_torch.models.mlp import MLPModel as TMLP


def random_state_dict(module, seed):
    """numpy weights for every entry of ``module``'s state_dict: He-normal
    conv/linear weights, small biases, BatchNorm near identity with
    non-trivial statistics."""
    gen = np.random.default_rng(seed)
    keys = module.state_dict()
    bn = {k[:-len(".running_mean")] for k in keys
          if k.endswith(".running_mean")}
    out = {}
    for key, value in keys.items():
        if key.endswith("num_batches_tracked"):
            continue
        shape = tuple(value.shape)
        scope, leaf = key.rsplit(".", 1)
        if scope in bn:
            if leaf in ("weight", "running_var"):
                v = gen.uniform(0.8, 1.2, shape)
            else:
                v = gen.normal(0.0, 0.05, shape)
        elif leaf == "weight" and len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            v = gen.normal(0.0, (2.0 / fan_in) ** 0.5, shape)
        else:
            v = gen.normal(0.0, 0.01, shape)
        out[key] = v.astype(np.float32)
    return out


def load_pair(module, seed):
    """Same random weights into the port's module and as JAX variables."""
    jvars = convert_state_dict(random_state_dict(module, seed))
    module.load_state_dict(state_dict_from_jax(jvars), strict=True)
    return module.eval(), jvars


@pytest.fixture(scope="module")
def encoders():
    enc, jvars = load_pair(TEnc(), seed=0)
    return enc, jvars


def test_state_dict_from_jax_equals_flax_to_torch(encoders):
    enc, jvars = encoders
    want = flax_to_torch_state_dict(jvars)
    got = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jvars))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    module_keys = {k for k in enc.state_dict()
                   if not k.endswith("num_batches_tracked")}
    assert set(got) == module_keys
    for key in ("conv2d_1a.conv.weight", "repeat_1.0.branch1.1.conv.weight",
                "last_bn.running_var", "block8.conv2d.bias"):
        assert key in got


def test_inception_resnet_v1_full_depth_matches_flax(encoders):
    enc, jvars = encoders
    x = np.random.default_rng(1).uniform(-1, 1, (2, 112, 112, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(JEnc().apply)(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = enc(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == (2, 512) and got.dtype == np.float32
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.9999, cos
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_inception_resnet_v1_bf16_compute_keeps_f32_contract(encoders):
    """bf16 trunk, f32 parameters and f32 unit-norm output."""
    enc, _ = encoders
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (2, 3, 112, 112)).astype(np.float32))
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
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    assert float((got * ref).sum(-1).min()) > 0.98


def test_mlp_matches_flax():
    mlp, jvars = load_pair(TMLP(512, 1001), seed=3)
    x = np.random.default_rng(4).normal(0, 1, (5, 512)).astype(np.float32)
    want = np.asarray(JMLP(512, 1001).apply(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
