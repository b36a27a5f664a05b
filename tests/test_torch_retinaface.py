"""The port's RetinaFace (cfg_mnet) against the JAX package, on the CPU:
prior boxes and their decode, stage 1 (kernel K6's plain version)
against the TPU kernel in interpret mode and the flax NHWC stage, the
whole net, and the fixed-capacity detector on the fitted weights."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.models import retinaface as JR
from vn_celeb_face_recognition_tpu.models.torch_convert import (
    convert_state_dict,
)
from vn_celeb_face_recognition_tpu.ops import boxes as JB
from vn_celeb_face_recognition_tpu.ops.planar_mnet import _STAGE1_SPECS
from vn_celeb_face_recognition_tpu.ops.planar_s1_pallas import (
    planar_stage1_pallas,
)
from vn_celeb_face_recognition_tpu_torch.models import retinaface as TR
from vn_celeb_face_recognition_tpu_torch.models.layers import load_npz
from vn_celeb_face_recognition_tpu_torch.ops import boxes as TB
from vn_celeb_face_recognition_tpu_torch.ops import planar_s1 as K6
from vn_celeb_face_recognition_tpu_torch.utils import kernels
from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames

from test_torch_encoder import load_pair
from torch_shared import two_threads  # noqa: F401 (autouse)

SUB = (104.0, 117.0, 123.0)


@pytest.fixture(scope="module")
def random_net():
    """The port's net and the JAX variables on the same random weights
    (non-trivial BatchNorm statistics)."""
    return load_pair(TR.RetinaFaceNet(), seed=5)


@pytest.fixture(scope="module")
def fitted_net():
    net = load_npz(TR.RetinaFaceNet(), TR.WEIGHTS_NPZ).eval()
    with np.load(TR.WEIGHTS_NPZ) as z:
        jvars = convert_state_dict({k: z[k] for k in z.files})
    return net, jvars


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape + (3,),
                                                dtype=np.uint8)


def test_priors_and_decode_match_jax():
    cfg = TR.cfg_mnet
    for hw in ((640, 640), (72, 104)):
        want = JB.make_priors(hw, cfg["min_sizes"], cfg["steps"])
        got = TB.make_priors(hw, cfg["min_sizes"], cfg["steps"])
        np.testing.assert_array_equal(got, want)
    gen = np.random.default_rng(0)
    pri = got[gen.integers(0, len(got), 50)]
    loc = gen.normal(0, 1, (50, 4)).astype(np.float32)
    ldm = gen.normal(0, 1, (50, 10)).astype(np.float32)
    var = cfg["variance"]
    np.testing.assert_allclose(
        TB.decode_boxes(torch.from_numpy(loc), torch.from_numpy(pri),
                        var).numpy(),
        np.asarray(JB.decode_boxes(jnp.asarray(loc), jnp.asarray(pri), var)),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        TB.decode_landmarks(torch.from_numpy(ldm), torch.from_numpy(pri),
                            var).numpy(),
        np.asarray(JB.decode_landmarks(jnp.asarray(ldm), jnp.asarray(pri),
                                       var)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 48, 80), (1, 37, 53)])
def test_stage1_plain_matches_tpu_kernel_and_flax(random_net, shape):
    """K6's plain version against the flax NHWC stage (any size) and the
    Pallas kernel in interpret mode (sizes divisible by 16), at the JAX
    package's own stage-1 tolerance."""
    net, jvars = random_net
    params = jvars["params"]["body"]["stage1"]
    stats = jvars["batch_stats"]["body"]["stage1"]
    frames = _frames(shape, seed=sum(shape))
    before = kernels.launch_counts()
    got = K6.mnet_stage1(net.body.stage1, torch.from_numpy(frames), SUB,
                         torch.float32).numpy()
    assert kernels.launch_counts() == before  # CPU: the plain version
    assert got.shape == (shape[0], *K6.stage1_out_hw(*shape[1:]), 64)
    x = frames.astype(np.float32) - np.asarray(SUB, np.float32)
    flax_stage = JR.MobileNetV1Stage(_STAGE1_SPECS).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(flax_stage), rtol=2e-4,
                               atol=2e-4)
    if shape[1] % 16 == 0 and shape[2] % 16 == 0:
        pallas = planar_stage1_pallas(params, stats, jnp.asarray(frames),
                                      SUB, dtype=None, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-4,
                                   atol=2e-4)


def test_stage1_weight_pack_layout(random_net):
    """The kernel's packed weights: means first, then conv0 tap-major,
    and the block count the CUDA source asserts."""
    net, _ = random_net
    packed = K6.pack_stage1_weights(net.body.stage1, SUB)
    assert packed.shape == (K6.N_WEIGHTS,)
    np.testing.assert_array_equal(packed[:4].numpy(), [*SUB, 0.0])
    w0 = net.body.stage1[0][0].weight.detach()  # [8, 3, 3, 3]
    np.testing.assert_array_equal(
        packed[4:4 + 27 * 8].reshape(3, 3, 3, 8).numpy(),
        w0.permute(2, 3, 1, 0).numpy())


@pytest.mark.parametrize("hw", [(96, 96), (72, 104)])
def test_retinaface_net_matches_flax(fitted_net, hw):
    """loc, conf and landmarks of the whole net (stage 1 through K6's
    wrapper on the uint8 frames) on the fitted weights, against the flax
    net on the mean-subtracted frames, including sizes whose FPN upsample
    is not an exact 2x."""
    net, jvars = fitted_net
    assert TR.CHANNELS_SUBTRACT == SUB
    frames = build_frames(2, max(hw), 4, 40)[:, :hw[0], :hw[1]]
    x = frames.astype(np.float32) - np.asarray(SUB, np.float32)
    jnet = JR.RetinaFaceNet(backbone="mobilenet0.25", out_channel=64)
    want = jnet.apply(jvars, jnp.asarray(x), train=False)
    before = kernels.launch_counts()
    with torch.no_grad():
        got = net(torch.from_numpy(frames))
    assert kernels.launch_counts() == before  # CPU: the plain version
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


def _same_box_sets(got_boxes, want_boxes, atol):
    """Every kept box on one side has a box within ``atol`` on the
    other (order may differ between near-tied scores)."""
    assert len(got_boxes) == len(want_boxes)
    for a, b in ((got_boxes, want_boxes), (want_boxes, got_boxes)):
        for box in a:
            assert np.abs(b - box).max(axis=-1).min() <= atol, box


@pytest.mark.parametrize("planar", [False, True])
def test_detector_matches_jax(planar):
    """The fitted detector on 2 frames: the same NMS keep sets and the
    same final faces as the JAX RetinaFace (flax stage 1, or the Pallas
    stage-1 kernel in interpret mode)."""
    frames = build_frames(2, 128, 4, 56)
    jdet = JR.RetinaFace(weights_path=TR.WEIGHTS_NPZ, planar_stage1=planar)
    tdet = TR.RetinaFace(weights_path=TR.WEIGHTS_NPZ, device="cpu")
    assert tdet.out_cap == jdet.out_cap and tdet.nms_cap == jdet.nms_cap
    fr = torch.from_numpy(frames)
    want_nms = jax.device_get(jdet._build_infer_fn(128, 128)(
        jdet.variables, jnp.asarray(frames)))
    got_nms = [t.numpy() for t in tdet.infer_padded(fr)]
    want = jax.device_get(jdet._build_detect_fn(2, 128, 128)(
        jdet.variables, jnp.asarray(frames)))
    got = [t.numpy() for t in tdet.detect_padded(fr)]
    assert got[0].shape == (2, 16, 4) and got[2].shape == (2, 16, 5, 2)
    for i in range(2):
        kept = got_nms[3][i]
        assert kept.sum() == want_nms[3][i].sum() >= 2
        _same_box_sets(got_nms[0][i][kept], want_nms[0][i][want_nms[3][i]],
                       atol=1e-3)
        v, wv = got[3][i], np.asarray(want[3][i])
        np.testing.assert_array_equal(v, wv)
        np.testing.assert_allclose(got[0][i][v], want[0][i][wv], atol=1e-3)
        np.testing.assert_allclose(got[1][i][v], want[1][i][wv], atol=1e-5)
        np.testing.assert_allclose(got[2][i][v], want[2][i][wv], atol=1e-3)
    assert got[3].sum() >= 2
