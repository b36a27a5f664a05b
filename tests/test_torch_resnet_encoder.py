"""The port's SE-IR encoder (``models.resnet_encoder``: ``ResNetSE``,
``resnet101``, ``build_resnet_se``), ``ArcMarginModel``, the iresnet heads
(``n_classes``, ``num_features``), the weight conversion of these trees,
and the online-aug trainer with the SE-IR encoder, against the JAX
package on the CPU. Weights are flax's initialisation with every
BatchNorm statistic, BatchNorm affine term, bias and PReLU slope redrawn
from a numpy seed, carried across by ``models.convert``. Each test states
its tolerance."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn
import jax
import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.models import iresnet as JI
from vn_celeb_face_recognition_tpu.models import resnet_encoder as JR
from vn_celeb_face_recognition_tpu.models.mlp import MLPModel as JMLP
from vn_celeb_face_recognition_tpu.training.trainer import (
    AugClassificationTrainer as JAug,
)
from vn_celeb_face_recognition_tpu import data as JD
from vn_celeb_face_recognition_tpu_torch import data as PD
from vn_celeb_face_recognition_tpu_torch import models as PM
from vn_celeb_face_recognition_tpu_torch.models import resnet_encoder as TR
from vn_celeb_face_recognition_tpu_torch.models.convert import (
    state_dict_from_jax,
    state_dict_to_jax,
)
from vn_celeb_face_recognition_tpu_torch.training.trainer import (
    AugClassificationTrainer as PAug,
)

from test_torch_encoder import load_pair
from test_torch_training import aug_config, face_dataset, loaders  # noqa: F401
from torch_shared import two_threads  # noqa: F401 (autouse)

SHALLOW = (1, 1, 1, 1)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(variables, seed):
    """``variables`` with every non-kernel leaf redrawn: BatchNorm scales
    and variances in [0.8, 1.2], means and biases N(0, 0.05), PReLU
    slopes in [0.1, 0.3]; conv and dense kernels keep flax's init."""
    gen = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name in ("scale", "var"):
            return gen.uniform(0.8, 1.2, leaf.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return gen.normal(0.0, 0.05, leaf.shape).astype(np.float32)
        if name == "alpha":
            return gen.uniform(0.1, 0.3, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(redraw, variables)


def se_pair(layers, size, seed, use_se=True):
    """(flax ResNetSE, its variables at ``size`` px, the port's module on
    the same weights, in eval mode)."""
    jm = JR.ResNetSE(layers=layers, use_se=use_se)
    jvars = perturbed(jm.init(jax.random.PRNGKey(seed),
                              jnp.zeros((1, size, size, 3))), seed)
    tm = TR.ResNetSE(layers, use_se=use_se)
    tm.load_state_dict(state_dict_from_jax(np_tree(jvars)), strict=True)
    return jm, jvars, tm.eval()


def faces(n, size, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)
                                               ).astype(np.float32)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))


# ---------------------------------------------------------------------------
# ResNetSE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [112, 160])
def test_resnet_se_matches_flax(size):
    """Eval mode at small depth: fc takes 25,088 inputs at 112 px and
    51,200 at 160 px, as flax infers; unit-norm embeddings within 2e-5."""
    jm, jvars, tm = se_pair(SHALLOW, size, seed=size)
    assert tm.fc.weight.shape == (512, {112: 25088, 160: 51200}[size])
    x = faces(2, size)
    want = np.asarray(jm.apply(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(nchw(x)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("size", [112, 160])
def test_resnet_se_train_mode_matches_flax(size):
    """Train-mode BatchNorm (the batch's statistics, flax's running
    update): the flax module's dropout mask, read from its output, is
    applied between the port's ``trunk`` and ``head``; embeddings within
    1e-4, every updated running statistic within 1e-5."""
    jm, jvars, tm = se_pair(SHALLOW, size, seed=size + 1)
    x = faces(4, size, seed=2)
    want, updated = jm.apply(
        jvars, jnp.asarray(x), train=True, mutable=["batch_stats",
                                                    "intermediates"],
        rngs={"dropout": jax.random.PRNGKey(5)},
        capture_intermediates=lambda m, _: isinstance(m, fnn.Dropout))
    dropped = np.array(jax.tree_util.tree_leaves(
        updated["intermediates"])[0])
    tm.train()
    with torch.no_grad():
        t = tm.trunk(nchw(x))
        kept = torch.from_numpy(dropped).permute(0, 3, 1, 2) != 0
        got = tm.head(t * kept / (1.0 - TR.DROPOUT)).numpy()
    assert 0.3 < kept.float().mean() < 0.7
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    stats = state_dict_from_jax({"batch_stats": np_tree(
        updated["batch_stats"])})
    sd = tm.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("use_se", [True, False])
def test_resnet_se_keys_and_convert_round_trip(use_se):
    """The port's keys are the flax tree's (``layerN.i.bn0``, ``se.fc.0``,
    ``downsample.0/1``, the [1] PReLU slopes), and state_dict_to_jax
    inverts state_dict_from_jax over the tree, bit for bit."""
    jm, jvars, tm = se_pair(SHALLOW, 112, seed=7, use_se=use_se)
    v = np_tree(jvars)
    keys = {k for k in tm.state_dict() if not k.endswith(
        "num_batches_tracked")}
    assert keys == set(state_dict_from_jax(v))
    assert ("layer1.0.se.fc.0.weight" in keys) == use_se
    assert {"layer2.0.downsample.0.weight", "layer1.0.bn0.running_var",
            "bn3.weight", "fc.bias"} <= keys
    assert tm.prelu.weight.shape == (1,)
    assert tm.layer1[0].prelu.weight.shape == (1,)
    assert_trees_equal(state_dict_to_jax(state_dict_from_jax(v)), v)
    assert_trees_equal(state_dict_to_jax(tm), v)


def test_resnet_se_lazy_fc_is_seeded_once_at_its_width():
    """Without weights fc takes its width at the first forward and is
    seeded (lecun-normal) from FC_SEED: two modules give the same fc at
    112 px; the seeded net is well conditioned: a batch of 4 and its
    first 2 faces alone give the same embeddings (cosine >= 0.99999)."""
    mods = [PM.build_model("resnet101") for _ in range(2)]
    for m in mods:
        assert m.fc.in_features == 0
        with torch.no_grad():
            out = m(nchw(faces(1, 112)))
        assert out.shape == (1, 512) and m.fc.in_features == 25088
        assert not m.training
    x = nchw(faces(4, 112, seed=8))
    with torch.no_grad():
        four, two = mods[0](x), mods[0](x[:2])
    cos = torch.nn.functional.cosine_similarity(four[:2], two, dim=-1)
    assert float(cos.min()) >= 0.99999, cos
    torch.testing.assert_close(mods[0].fc.weight, mods[1].fc.weight,
                               rtol=0, atol=0)
    std = float(mods[0].fc.weight.detach().std())
    assert abs(std - (TR.INIT_SCALE / 25088) ** 0.5) < 1e-4


@pytest.mark.parametrize("kind", ["npz", "pt"])
def test_build_model_resnet101_loads_a_local_file(tmp_path, kind):
    """build_model("resnet101") with the shipped config's arguments: the
    absent cp_path seeds the full-depth encoder; a local .npz
    (weights_path) or torch checkpoint (cp_path) loads strictly, fc at
    its stored width."""
    cfg = {"use_se": True, "pretrained": False, "img_size": 112,
           "cp_path": str(tmp_path / "insight-face-v3.pt")}
    seeded = PM.build_model("resnet101", **cfg)
    assert isinstance(seeded, PM.ResNetSE)
    assert [len(seeded.layer1), len(seeded.layer2), len(seeded.layer3),
            len(seeded.layer4)] == [3, 4, 23, 3]
    src = PM.build_model("resnet101")
    src.fc.initialize_parameters(torch.zeros(1, 51200))
    with torch.no_grad():
        for p in src.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(p.numel() % 97)))
    sd = {k: v for k, v in src.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    if kind == "npz":
        path = str(tmp_path / "se.npz")
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
        got = PM.build_model("resnet101", **dict(cfg, weights_path=path))
    else:
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
                   cfg["cp_path"])
        got = PM.build_model("resnet101", **cfg)
    assert got.fc.weight.shape == (512, 51200)
    for k, v in sd.items():
        assert torch.equal(got.state_dict()[k], v), k


@pytest.mark.slow
def test_resnet101_full_depth_matches_flax():
    """Full depth (3, 4, 23, 3) at 112 px: cosine >= 0.999, as the JAX
    package's encoder parity holds its encoders."""
    jm, jvars, tm = se_pair((3, 4, 23, 3), 112, seed=11)
    x = faces(2, 112, seed=4)
    want = np.asarray(jm.apply(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(nchw(x)).numpy()
    cos = (got * want).sum(-1)
    assert cos.min() >= 0.999, cos


# ---------------------------------------------------------------------------
# ArcMargin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("easy_margin", [False, True])
def test_arcmargin_matches_flax(easy_margin):
    """Both branches of each margin rule (cos > th and cos - mm; cos > 0
    and cos) on embeddings aligned with, against and across their class
    weights; one label outside the classes gets no target, as jax's
    one_hot; within 1e-4 * margin_s."""
    n_cls, emb = 11, 32
    jm = JR.ArcMarginModel(n_cls, emb, margin_m=0.5, margin_s=64.0,
                           easy_margin=easy_margin)
    gen = np.random.default_rng(3)
    label = np.array([0, 1, 2, 3, 4, 5, 6, 7, 13])
    jvars = np_tree(jm.init(jax.random.PRNGKey(1),
                            np.zeros((9, emb), np.float32), label))
    w = jvars["params"]["weight"]
    sign = np.array([1, 1, -1, -1, 0, 0, 1, -1, 1], np.float32)[:, None]
    x = (sign * w[label % n_cls] + 0.05 * gen.normal(size=(9, emb))
         ).astype(np.float32)
    want = np.asarray(jm.apply(jvars, x, label))
    tm = PM.ArcMarginModel(n_cls, emb, margin_m=0.5, margin_s=64.0,
                           easy_margin=easy_margin)
    tm.load_state_dict(state_dict_from_jax(jvars), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(label)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * 64.0)
    cos = got[np.arange(8), label[:8]] / 64.0
    assert (sign[:8, 0] < 0).any() and (cos < np.cos(np.pi - 0.5)).any()
    assert_trees_equal(state_dict_to_jax(tm), jvars)


def test_arcmargin_init_is_seeded_xavier_uniform():
    a, b = PM.ArcMarginModel(1001), PM.ArcMarginModel(1001)
    assert torch.equal(a.weight, b.weight) and a.weight.shape == (1001, 512)
    bound = (6.0 / (1001 + 512)) ** 0.5
    w = a.weight.detach()
    assert float(w.abs().max()) <= bound
    assert abs(float(w.std()) - bound / 3 ** 0.5) < 2e-3
    a.reset_parameters(torch.Generator().manual_seed(1))
    assert not torch.equal(a.weight, b.weight)


# ---------------------------------------------------------------------------
# iresnet heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_features,n_classes", [(256, None), (512, 10),
                                                    (256, 10)])
def test_iresnet_head_matches_flax(num_features, n_classes):
    """num_features sizes fc and features; n_classes adds logits and an
    f32 log_softmax; within 2e-4 of the output's scale; the convert round
    trip is exact."""
    enc, jvars = load_pair(PM.IResNet(SHALLOW, num_features=num_features,
                                      n_classes=n_classes), seed=41)
    x = faces(2, 112, seed=5)
    want = np.asarray(JI.IResNet(layers=SHALLOW, num_features=num_features,
                                 n_classes=n_classes).apply(
        jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = enc(nchw(x)).numpy()
    assert got.shape == (2, n_classes or num_features)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=2e-4,
                               atol=2e-4)
    if n_classes:
        np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)
    assert_trees_equal(state_dict_to_jax(enc), np_tree(jvars))


def test_build_model_iresnet_with_a_head(tmp_path):
    """build_model takes n_classes and num_features; published weights
    load without their logits unless a head is asked for."""
    net = PM.build_model("iresnet50", n_classes=10, num_features=256)
    assert net.logits.out_features == 10 and net.fc.out_features == 256
    assert net.features.num_features == 256
    src = PM.build_model("iresnet34", n_classes=7)
    path = str(tmp_path / "iresnet34.npz")
    np.savez(path, **{k: v.numpy() for k, v in src.state_dict().items()
                      if not k.endswith("num_batches_tracked")})
    trunk = PM.build_model("iresnet34", pretrained=True, weights_path=path)
    head = PM.build_model("iresnet34", pretrained=True, weights_path=path,
                          n_classes=7)
    assert trunk.logits is None
    assert torch.equal(head.logits.weight, src.logits.weight)
    assert torch.equal(trunk.fc.weight, src.fc.weight)


# ---------------------------------------------------------------------------
# the online-aug trainer with the SE-IR encoder
# ---------------------------------------------------------------------------


def record_losses(trainer):
    """Per-batch training losses, as ``_train_epoch`` reports them."""
    losses = []
    update = trainer.train_loss.update

    def wrapped(name, value, n=1):
        losses.append(float(value))
        return update(name, value, n=n)

    trainer.train_loss.update = wrapped
    return losses


def test_aug_trainer_resnet101_encoder_matches_jax(face_dataset, tmp_path):
    """chosen_idx_enc 1 (the SE-IR encoder, at small depth, weights
    carried across) under the default transform, then the MLP: per-batch
    losses of 2 steps within rtol 1e-4 of the JAX trainer's; the encoder
    stays frozen."""
    jm, jvars, enc = se_pair(SHALLOW, 112, seed=17)
    cfg = aug_config(face_dataset, tmp_path / "jax", "default", epochs=1)
    cfg["trainer"]["chosen_idx_enc"] = 1
    jt = JAug(copy.deepcopy(cfg), JMLP(512, 4, dropout_prob=0.0), seed=123,
              encoder=jm, encoder_variables=jvars)
    jt.setup_loader(*loaders(JD, face_dataset))
    jt._ensure_ready(next(iter(jt.val_loader)))
    mlp = PM.build_model("MLPModel", input_dim=512, num_classes=4,
                         dropout_prob=0.0)
    mlp.load_state_dict(state_dict_from_jax(np_tree(jt.variables)))
    cfg["trainer"]["save_dir"] = str(tmp_path / "port")
    pt = PAug(copy.deepcopy(cfg), mlp, seed=123, device="cpu", encoder=enc)
    pt.setup_loader(*loaders(PD, face_dataset))
    jl, pl = record_losses(jt), record_losses(pt)
    jt._train_epoch(1)
    pt._train_epoch(1)
    assert len(pl) == len(jl) == 2
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert not pt.encoder.training
    assert all(not p.requires_grad and p.grad is None
               for p in pt.encoder.parameters())
