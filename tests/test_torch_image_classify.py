"""The port's image-classify trainer (cfg/train_cfg_img_classify.json)
against the JAX package's on the CPU: BatchNorm in train mode, dropout,
InceptionResnetV1's classify head and its builder, ``ClassificationTrainer``
on a BatchNorm model, checkpoints both ways, ``training.aug_step`` and the
CLIs on a toy image config. Weights cross between the packages through
``models.convert``; the compared runs use dropout 0, since the packages
draw from different generators. Each test states its tolerance."""

import copy
import csv
import functools
import json
import logging
import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax
import torch.nn.functional as F

from vn_celeb_face_recognition_tpu import data as JD
from vn_celeb_face_recognition_tpu.models.inception_resnet_v1 import (
    InceptionResnetV1 as JIRv1,
)
from vn_celeb_face_recognition_tpu.models.mlp import MLPModel as JMLP
from vn_celeb_face_recognition_tpu.training import losses as JL
from vn_celeb_face_recognition_tpu.training import optim as JO
from vn_celeb_face_recognition_tpu.training.checkpoint import (
    load_checkpoint as j_load_checkpoint,
)
from vn_celeb_face_recognition_tpu.training.checkpoint import (
    restore_variables as j_restore,
)
from vn_celeb_face_recognition_tpu.training.checkpoint import (
    save_checkpoint as j_save_checkpoint,
)
from vn_celeb_face_recognition_tpu.training.trainer import (
    ClassificationTrainer as JCT,
)
from vn_celeb_face_recognition_tpu_torch import data as PD
from vn_celeb_face_recognition_tpu_torch import models as PM
from vn_celeb_face_recognition_tpu_torch.cli import eval as p_eval
from vn_celeb_face_recognition_tpu_torch.cli import train as p_train
from vn_celeb_face_recognition_tpu_torch.models.convert import (
    state_dict_from_jax,
    state_dict_to_jax,
)
from vn_celeb_face_recognition_tpu_torch.models.inception_resnet_v1 import (
    InceptionResnetV1,
)
from vn_celeb_face_recognition_tpu_torch.models.layers import (
    batch_norm,
    conv,
    dropout,
    linear,
    seeded_init_,
)
from vn_celeb_face_recognition_tpu_torch.ops import augment as PA
from vn_celeb_face_recognition_tpu_torch.training import checkpoint as PC
from vn_celeb_face_recognition_tpu_torch.training import losses as PL
from vn_celeb_face_recognition_tpu_torch.training import optim as PO
from vn_celeb_face_recognition_tpu_torch.training.aug_step import (
    make_aug_train_step,
)
from vn_celeb_face_recognition_tpu_torch.training.trainer import (
    AugClassificationTrainer as PAug,
)
from vn_celeb_face_recognition_tpu_torch.training.trainer import (
    ClassificationTrainer as PCT,
)
from vn_celeb_face_recognition_tpu_torch.utils import kernels
from vn_celeb_face_recognition_tpu_torch.utils.frames import write_png
from torch_shared import two_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_state_close(got_sd, want_vars, atol):
    """A port state_dict against JAX variables (params and batch_stats),
    key for key (``num_batches_tracked`` has no flax counterpart)."""
    want = state_dict_from_jax(np_tree(want_vars))
    got = {k: v for k, v in got_sd.items()
           if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# BatchNorm in train mode, dropout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 5, 7, 9), (10, 16)])
def test_train_mode_batch_norm_matches_flax(shape):
    """A port BatchNorm in train mode against flax nn.BatchNorm(momentum
    0.9, epsilon 1e-3) on two batches: outputs within 1e-6 of the exact
    (float64) normalisation and within 1e-6 + 1e-6 |flax| of flax's (whose
    E[x^2] - E[x]^2 variance errs by up to ~1e-6 here), running statistics
    within 1e-6, the input and scale gradients within 1e-5. Plain
    F.batch_norm(training=True) would update the running variance with
    the unbiased variance, n / (n - 1) of flax's; eval mode normalises
    with the running statistics."""
    gen = np.random.default_rng(len(shape))
    c = shape[1]
    xs = [(gen.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
          for _ in range(2)]
    to_nhwc = (lambda a: np.moveaxis(a, 1, -1)) if len(shape) == 4 else \
        (lambda a: a)
    bn = nn.BatchNorm(momentum=0.9, epsilon=1e-3)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(to_nhwc(xs[0])),
                        use_running_average=False)
    scale = gen.uniform(0.5, 1.5, c).astype(np.float32)
    bias = gen.normal(size=c).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": variables["batch_stats"]}
    m = (torch.nn.BatchNorm2d if len(shape) == 4 else torch.nn.BatchNorm1d)(
        c, eps=1e-3, momentum=0.1)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    m.train()
    train_apply = jax.jit(functools.partial(
        bn.apply, use_running_average=False, mutable=["batch_stats"]))
    for x in xs:
        want, upd = train_apply(variables, jnp.asarray(to_nhwc(x)))
        variables = {"params": variables["params"], **upd}
        got = batch_norm(m, torch.from_numpy(x)).detach().numpy()
        axes = tuple(i for i in range(x.ndim) if i != 1)
        xd = x.astype(np.float64)
        exact = (xd - xd.mean(axes, keepdims=True)) / np.sqrt(
            xd.var(axes, keepdims=True) + 1e-3)
        shape_c = [1] * x.ndim
        shape_c[1] = c
        exact = exact * scale.reshape(shape_c) + bias.reshape(shape_c)
        np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
        np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        stats = upd["batch_stats"]
        np.testing.assert_allclose(m.running_mean.numpy(),
                                   np.asarray(stats["mean"]), atol=1e-6)
        np.testing.assert_allclose(m.running_var.numpy(),
                                   np.asarray(stats["var"]), atol=1e-6)

    m.eval()
    with torch.no_grad():
        got = batch_norm(m, torch.from_numpy(xs[1]))
    want = bn.apply(variables, jnp.asarray(to_nhwc(xs[1])),
                    use_running_average=True)
    np.testing.assert_allclose(to_nhwc(got.numpy()), np.asarray(want),
                               rtol=0, atol=1e-5)
    m.train()

    # gradients of a weighted sum with respect to the input and the scale
    w = gen.normal(size=shape).astype(np.float32)

    def f(x, s):
        out = train_apply({"params": {"scale": s, "bias": jnp.asarray(bias)},
                           "batch_stats": variables["batch_stats"]}, x)[0]
        return jnp.sum(out * jnp.asarray(to_nhwc(w)))

    gx, gs = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jnp.asarray(to_nhwc(xs[0])), jnp.asarray(scale))
    xt = torch.from_numpy(xs[0]).requires_grad_(True)
    (batch_norm(m, xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(to_nhwc(xt.grad.numpy()), np.asarray(gx),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.weight.grad.numpy(), np.asarray(gs),
                               rtol=1e-5, atol=1e-5)

    # plain F.batch_norm's running variance is the unbiased one's update
    n = xs[0].size // c
    rm, rv = torch.zeros(c), torch.ones(c)
    F.batch_norm(torch.from_numpy(xs[0]), rm, rv, m.weight, m.bias, True,
                 0.1, 1e-3)
    x0 = jnp.asarray(to_nhwc(xs[0]))
    first = train_apply(bn.init(jax.random.PRNGKey(0), x0,
                                use_running_average=False), x0)[1]
    flax_var = np.asarray(first["batch_stats"]["var"])
    ratio = (rv.numpy() - 0.9) / (flax_var - 0.9)
    np.testing.assert_allclose(ratio, n / (n - 1), rtol=1e-4)
    assert np.abs(rv.numpy() - flax_var).max() > 1e-4


def test_dropout_rate_scale_and_the_classify_forward():
    """dropout drops ~p of the elements with the generator's mask and
    scales the rest by 1 / (1 - p). InceptionResnetV1 applies it before
    last_linear in train mode only: the same generator state gives the
    same output, another state another; eval mode and dropout_prob 0
    ignore the generator; train mode with p > 0 and no generator raises.
    The classify head gives log-probabilities in f32, the embedding
    encoder unit vectors."""
    x = torch.ones((400, 1792))
    y = dropout(x, 0.6, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.4) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.5))
    assert torch.equal(dropout(x, 0.6, torch.Generator().manual_seed(0)), y)

    net = seeded_init_(InceptionResnetV1(classify=True, num_classes=5),
                       torch.Generator().manual_seed(1))
    faces = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (3, 3, 80, 80)).astype(np.float32))
    net.train()
    with torch.no_grad():
        a = net(faces, generator=torch.Generator().manual_seed(2))
        b = net(faces, generator=torch.Generator().manual_seed(2))
        c = net(faces, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.float32 and a.shape == (3, 5)
    torch.testing.assert_close(a.exp().sum(-1), torch.ones(3))
    with pytest.raises(ValueError, match="Generator"):
        net(faces)
    net.dropout_prob = 0.0
    with torch.no_grad():
        d = net(faces)
    net.eval()
    with torch.no_grad():
        e = net(faces, generator=torch.Generator().manual_seed(2))
        f = net(faces)
    assert torch.equal(e, f) and not torch.equal(d, e)
    emb = seeded_init_(InceptionResnetV1(), torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = emb.eval()(faces)
    torch.testing.assert_close(out.norm(dim=-1), torch.ones(3))


def test_build_model_classify_semantics(monkeypatch, tmp_path, capsys):
    """build_model("InceptionResnetV1") with the JAX constructor's
    semantics: classify without pretrained needs num_classes (JAX raises
    too); with pretrained the head has the dataset's class count unless
    classify and num_classes are both given; without local weights a
    warning and a seeded model; local weights load
    the trunk, and the head only when it keeps the dataset's class count
    (else a fresh seeded head); the state_dict keys are the torch reference's
    (``logits.*``)."""
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    with pytest.raises(ValueError, match="num_classes"):
        PM.build_model("InceptionResnetV1", classify=True)
    with pytest.raises(Exception, match="num_classes"):
        from vn_celeb_face_recognition_tpu.models import build_model as jbm

        jbm("InceptionResnetV1", classify=True)
    net = PM.build_model("InceptionResnetV1", classify=True, num_classes=7)
    assert net.logits.out_features == 7 and not net.training
    assert {"logits.weight", "logits.bias"} <= set(net.state_dict())
    assert state_dict_to_jax(net)["params"]["logits"]["kernel"].shape == \
        (512, 7)
    capsys.readouterr()
    cfg_net = PM.build_model("InceptionResnetV1", pretrained="vggface2",
                             classify=True, num_classes=1000)
    assert "Warning: pretrained='vggface2'" in capsys.readouterr().out
    assert cfg_net.logits.out_features == 1000
    assert PM.build_model("InceptionResnetV1", pretrained="casia-webface",
                          classify=True).logits.out_features == 10575

    # a local file with a vggface2-sized head
    src = seeded_init_(InceptionResnetV1(classify=True, num_classes=8631),
                       torch.Generator().manual_seed(9))
    path = str(tmp_path / "irv1.npz")
    np.savez(path, **{k: v.numpy() for k, v in src.state_dict().items()
                      if not k.endswith("num_batches_tracked")})
    same = PM.build_model("InceptionResnetV1", pretrained="vggface2",
                          classify=True, weights_path=path)
    fresh = PM.build_model("InceptionResnetV1", pretrained="vggface2",
                           classify=True, num_classes=7, weights_path=path)
    trunk = PM.build_model("InceptionResnetV1", pretrained="vggface2",
                           weights_path=path)
    assert trunk.logits is None
    got = [m.state_dict() for m in (same, fresh, trunk)]
    for k, v in src.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(got[0][k], v), k
        if not k.startswith("logits."):
            assert torch.equal(got[1][k], v), k
            assert torch.equal(got[2][k], v), k
    assert fresh.logits.out_features == 7
    assert float(fresh.logits.weight.detach().std()) > 0.0
    assert float(fresh.logits.bias.detach().abs().max()) == 0.0
    # the iresnets take a classification head too, as the JAX IResNet does
    head = PM.build_model("iresnet50", n_classes=10)
    assert head.logits.out_features == 10


# ---------------------------------------------------------------------------
# ClassificationTrainer on a BatchNorm model
# ---------------------------------------------------------------------------


class JTinyBN(nn.Module):
    """Conv + BN + dense log-softmax head: the JAX image-classify test's
    TinyBNClassifier with an explicit pad of 1, a dropout rate and, as
    InceptionResnetV1's BasicConv2d, no conv bias before the BatchNorm (its
    gradient is 0 up to rounding, which Adam's normalised step turns into
    +-lr moves that differ between any two implementations)."""

    num_classes: int = 5
    rate: float = 0.0

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = nn.Conv(8, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)),
                    use_bias=False)(x)
        x = nn.BatchNorm(use_running_average=not train, momentum=0.9)(x)
        x = nn.relu(x)
        x = jnp.mean(x, axis=(1, 2))
        x = nn.Dropout(self.rate, deterministic=not train)(x)
        x = nn.Dense(self.num_classes)(x)
        return nn.log_softmax(x, axis=-1)


class TinyBN(torch.nn.Module):
    """The port's counterpart of JTinyBN, under flax's auto names."""

    def __init__(self, num_classes=5, rate=0.0):
        super().__init__()
        self.rate = rate
        self.Conv_0 = torch.nn.Conv2d(3, 8, 3, stride=2, padding=1,
                                      bias=False)
        self.BatchNorm_0 = torch.nn.BatchNorm2d(8, eps=1e-5, momentum=0.1)
        self.Dense_0 = torch.nn.Linear(8, num_classes)

    def forward(self, x, generator=None):
        x = F.relu(batch_norm(self.BatchNorm_0, conv(self.Conv_0, x)))
        x = x.mean(dim=(2, 3))
        if self.training:
            x = dropout(x, self.rate, generator)
        return F.log_softmax(linear(self.Dense_0, x), dim=-1)


@pytest.fixture(scope="module")
def color_images(tmp_path_factory):
    """5 classes x 6 flat-colour 80 px PNGs with noise (5 train + 1 val
    each): 25 train images, so batches of 8 end in a padded one. 80 px is
    the smallest size InceptionResnetV1's stride-2 stages keep whole."""
    root = tmp_path_factory.mktemp("img_cls")
    img_dir = root / "data"
    img_dir.mkdir()
    gen = np.random.default_rng(11)
    palette = gen.integers(30, 225, size=(5, 3))
    train, val = {}, {}
    for c in range(5):
        names = []
        for j in range(6):
            arr = np.clip(palette[c] + gen.integers(-25, 25, (80, 80, 3)),
                          0, 255).astype(np.uint8)
            write_png(str(img_dir / f"{c}_{j}.png"), arr)
            names.append(f"{c}_{j}.png")
        train[str(c)], val[str(c)] = names[:-1], names[-1:]
    (root / "train.json").write_text(json.dumps(train))
    (root / "val.json").write_text(json.dumps(val))
    return root


def tiny_config(save_dir, transform="prewhiten", epochs=3, resume=""):
    return {
        "transforms": {"name": transform, "resize": False,
                       "encoder_img_size": 80},
        "metrics": ["accuracy"],
        "loss": "neg_log_llhood",
        "trainer": {
            "name": "ClassificationTrainer", "resume_path": resume,
            "save_dir": str(save_dir), "device": "CPU", "log_step": 100,
            "do_validation": True, "validation_step": 1, "epochs": epochs,
            "tracked_metric": ["val_neg_log_llhood", "min"],
            "patience": 10, "save_period": 2, "track4plot": False,
        },
        "optimizer": {"name": "Adam",
                      "args": {"lr": 0.01, "weight_decay": 1e-4}},
        "lr_scheduler": {"name": "ReduceLROnPlateau",
                         "args": {"mode": "min", "threshold": 0.5,
                                  "factor": 0.5, "patience": 0,
                                  "min_lr": 1e-7, "threshold_mode": "rel"}},
    }


def loaders(pkg, root):
    return (pkg.DataLoader(pkg.VNCelebDataset(str(root / "data"),
                                              str(root / "train.json")),
                           batch_size=8, shuffle=True, seed=123),
            pkg.DataLoader(pkg.VNCelebDataset(str(root / "data"),
                                              str(root / "val.json")),
                           batch_size=8))


def jax_tiny(cfg, root, variables=None):
    jt = JCT(copy.deepcopy(cfg), JTinyBN(), seed=123)
    jt.setup_loader(*loaders(JD, root))
    if variables is not None:
        jt.variables = variables
    jt._ensure_ready(next(iter(jt.val_loader)))
    return jt


def port_tiny(cfg, root, jt=None, rate=0.0):
    model = seeded_init_(TinyBN(rate=rate), torch.Generator().manual_seed(5))
    if jt is not None:
        model.load_state_dict(state_dict_from_jax(np_tree(jt.variables)))
    pt = PCT(copy.deepcopy(cfg), model, seed=123, device="cpu")
    pt.setup_loader(*loaders(PD, root))
    return pt


def record(trainer, lr_of):
    logs = []
    orig = trainer._train_epoch

    def wrapped(epoch):
        out = orig(epoch)
        logs.append((epoch, dict(out), lr_of()))
        return out

    trainer._train_epoch = wrapped
    return logs


def assert_logs_close(jlogs, plogs):
    assert [e for e, _, _ in jlogs] == [e for e, _, _ in plogs]
    for (e, a, lr_a), (_, b, lr_b) in zip(jlogs, plogs):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"epoch {e} {k}")
        np.testing.assert_allclose(lr_b, lr_a, rtol=1e-4)


def test_classification_trainer_with_bn_matches_jax(color_images, tmp_path):
    """Three epochs of both ClassificationTrainers on a BatchNorm model from
    the same weights (prewhiten, batches of 8 ending in a padded one whose
    padded rows enter the batch statistics; the plateau schedule halving
    the rate): per-epoch train and val logs and rates within rtol 1e-4,
    weights and running statistics within 1e-4; the running statistics
    moved, and validation ran in eval mode."""
    jt = jax_tiny(tiny_config(tmp_path / "jax"), color_images)
    pt = port_tiny(tiny_config(tmp_path / "port"), color_images, jt)
    jlogs = record(jt, lambda: JO.get_current_lr(jt.opt_state))
    plogs = record(pt, lambda: PO.get_current_lr(pt.optimizer))
    for epoch in (1, 2, 3):
        jt._train_epoch(epoch)
        pt._train_epoch(epoch)
    assert_logs_close(jlogs, plogs)
    assert plogs[-1][1]["neg_log_llhood"] < plogs[0][1]["neg_log_llhood"]
    assert_state_close(pt.model.state_dict(), jt.variables, 1e-4)
    assert float(pt.model.BatchNorm_0.running_mean.abs().sum()) > 0.0
    assert not pt.model.training


def test_bn_checkpoints_both_ways(color_images, tmp_path):
    """A port checkpoint of the BatchNorm model loads in the JAX package
    (load_checkpoint + restore_variables, as its trainer resumes): its
    eval log-probs equal the port's within 1e-5. A JAX checkpoint at
    epoch 2 resumes in the port (weights, running statistics, Adam's
    moments, the rate, epoch and best) and epochs 3-4 follow the JAX
    trainer's resumed from it: logs within rtol 1e-4, weights and
    statistics within 1e-4."""
    pt = port_tiny(tiny_config(tmp_path / "p0", epochs=2), color_images)
    pt.train()
    cp = j_load_checkpoint(str(pt.save_dir / "checkpoint-epoch2.ckpt"))
    assert {"batch_stats", "params"} == set(cp["state_dict"])
    template = JTinyBN().init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 80, 80, 3)))
    variables = j_restore(template, cp["state_dict"])
    x = np.random.default_rng(2).normal(size=(4, 80, 80, 3)).astype(
        np.float32)
    want = np.asarray(JTinyBN().apply(variables, jnp.asarray(x)))
    pt.model.eval()
    with torch.no_grad():
        got = pt.model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    first = jax_tiny(tiny_config(tmp_path / "j0", epochs=2), color_images)
    first.train()
    ckpt = str(first.save_dir / "checkpoint-epoch2.ckpt")
    runs = {}
    for side in ("jax", "port"):
        cfg = tiny_config(tmp_path / side, epochs=4, resume=ckpt)
        cfg["trainer"]["save_period"] = 100
        if side == "jax":
            t = jax_tiny(cfg, color_images)
            logs = record(t, lambda t=t: JO.get_current_lr(t.opt_state))
        else:
            t = port_tiny(cfg, color_images)
            logs = record(t, lambda t=t: PO.get_current_lr(t.optimizer))
            assert t.mnt_best == pytest.approx(first.mnt_best)
        assert t.start_epoch == 3
        t.train()
        runs[side] = (t, logs)
    (jt, jlogs), (pt, plogs) = runs["jax"], runs["port"]
    assert [e for e, _, _ in plogs] == [3, 4]
    assert_logs_close(jlogs, plogs)
    assert_state_close(pt.model.state_dict(), jt.variables, 1e-4)


def test_bn_port_resume_is_exact(color_images, tmp_path):
    """With rank1_aug and dropout 0.2 (so the generator's state counts)
    and shuffled batches, a port run resumed from its epoch-2 checkpoint
    continues exactly as the uninterrupted run: epochs 3-4 logs equal,
    final weights and running statistics equal."""
    full = port_tiny(tiny_config(tmp_path / "a", "rank1_aug", epochs=4),
                     color_images, rate=0.2)
    full_logs = record(full, lambda: PO.get_current_lr(full.optimizer))
    full.train()
    cfg = tiny_config(tmp_path / "b", "rank1_aug", epochs=4,
                      resume=str(full.save_dir / "checkpoint-epoch2.ckpt"))
    resumed = port_tiny(cfg, color_images, rate=0.2)
    assert resumed.start_epoch == 3
    logs = record(resumed, lambda: PO.get_current_lr(resumed.optimizer))
    resumed.train()
    assert logs == full_logs[2:]
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# InceptionResnetV1 classify at full depth
# ---------------------------------------------------------------------------

# SGD, not the config's Adam: Adam's first step is ~lr sign(g), which turns
# the rounding noise of gradients near 0 into +-lr moves; SGD's step is
# linear in the gradient, so the weights after it compare the gradients
IRV1_SGD = {"lr": 1e-4, "momentum": 0.9, "weight_decay": 1e-4}


@pytest.fixture(scope="module")
def irv1_jax_step():
    """JAX's train step of InceptionResnetV1(classify=True, 7 classes,
    dropout 0), the ClassificationTrainer's: forward with mutable
    batch_stats, NLL, grad, the optimizer (IRV1_SGD), the stats written
    back. Jitted once for the module, at XLA's backend optimisation level
    0 (it compiles ~4 s sooner)."""
    model = JIRv1(classify=True, num_classes=7, dropout_prob=0.0)
    tx = JO.make_optimizer("SGD", IRV1_SGD)

    @functools.partial(jax.jit, compiler_options={
        "xla_backend_optimization_level": 0})
    def step(variables, opt_state, x, target, weight):
        def loss_of(params):
            out, upd = model.apply(dict(variables, params=params), x,
                                   train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(0)})
            return JL.neg_log_llhood(out, target, weight), upd

        (loss, upd), grads = jax.value_and_grad(loss_of, has_aux=True)(
            variables["params"])
        u, opt_state = tx.update(grads, opt_state, variables["params"])
        return ({"params": optax.apply_updates(variables["params"], u),
                 "batch_stats": upd["batch_stats"]}, opt_state, loss)

    return step, tx


def test_irv1_classify_step_matches_jax(irv1_jax_step, tmp_path):
    """One train step of the port's full-depth InceptionResnetV1 classify
    (8 images of 80 px, the last a padded row of weight 0, dropout 0,
    train-mode BatchNorm, SGD with momentum, IRV1_SGD) against the JAX step
    from the same weights: loss within rtol 1e-4, parameters and
    batch_stats within 1e-4. The port's checkpoint of it is read by the
    JAX package into the JAX step's variables (1e-4). A JAX checkpoint of
    the step (weights, batch_stats, the momentum trace) resumes in a fresh
    port model and optimizer, and a second step from it on each agrees
    again (1e-4). Batch 8, not 4: at 4 images the seeded net in train mode
    is so ill-conditioned (stages of 1x1 pixels normalise over 4 values)
    that a 1e-7 relative change of the input moves the port's own
    log-probabilities by 4.9e-4 and the first conv's gradient by 0.22; at
    8 by 8.7e-5 and 7.3e-3."""
    step, tx = irv1_jax_step
    net = seeded_init_(InceptionResnetV1(classify=True, num_classes=7,
                                         dropout_prob=0.0),
                       torch.Generator().manual_seed(3))
    variables = state_dict_to_jax(net)
    opt_state = tx.init(variables["params"])
    gen = np.random.default_rng(4)
    x = gen.uniform(-1, 1, (8, 80, 80, 3)).astype(np.float32)
    target = (np.arange(8) * 3 % 7).astype(np.int32)
    weight = np.array([1] * 7 + [0], np.float32)
    opt = PO.make_optimizer("SGD", IRV1_SGD, net.parameters())

    def port_step(model, optimizer):
        model.train()
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
        loss = PL.neg_log_llhood(out, torch.from_numpy(target),
                                 torch.from_numpy(weight))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return float(loss.detach())

    variables, opt_state, jloss = step(variables, opt_state, x, target,
                                       weight)
    loss = port_step(net, opt)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    assert_state_close(net.state_dict(), variables, 1e-4)

    # port -> JAX
    path = tmp_path / "port.ckpt"
    PC.save_checkpoint(path, arch="InceptionResnetV1", epoch=1, model=net,
                       optimizer=opt, monitor_best=loss, config={})
    restored = j_restore(np_tree(variables),
                         j_load_checkpoint(str(path))["state_dict"])
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(np_tree(variables))):
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-4)

    # JAX -> port, then a second step on both
    path = tmp_path / "jax.ckpt"
    j_save_checkpoint(str(path), arch="InceptionResnetV1", epoch=1,
                      variables=variables, opt_state=opt_state,
                      monitor_best=float(jloss), config={})
    cp = PC.load_checkpoint(path)
    fresh = seeded_init_(InceptionResnetV1(classify=True, num_classes=7,
                                           dropout_prob=0.0),
                         torch.Generator().manual_seed(8))
    PC.load_state_dict_from_jax(fresh, cp["state_dict"])
    fresh_opt = PO.make_optimizer("SGD", IRV1_SGD, fresh.parameters())
    PC.restore_optimizer(fresh_opt, fresh, cp["optimizer"],
                         cp["state_dict"]["batch_stats"])
    assert all(fresh_opt.state[p]["momentum_buffer"].abs().sum() > 0
               for p in fresh.parameters() if p.dim() == 4)
    variables, opt_state, jloss = step(variables, opt_state, x, target,
                                       weight)
    loss = port_step(fresh, fresh_opt)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    assert_state_close(fresh.state_dict(), variables, 1e-4)


# ---------------------------------------------------------------------------
# training.aug_step
# ---------------------------------------------------------------------------


def test_make_aug_train_step(tmp_path):
    """make_aug_train_step on the CPU (InceptionResnetV1 in bf16, 4 images
    of 80 px, MLP of 4 classes): one step equals AugClassificationTrainer's
    step on the same uint8 batch and generator (facenet_aug, the frozen encoder,
    dropout, Adam 1e-4 wd 1e-4: loss and MLP weights equal), launching no
    kernel on CPU tensors; the MLP update on the step's embeddings at
    dropout 0 matches the JAX package's (JAX MLP, its Adam) within 1e-5;
    without a card and without device="cpu" it raises."""
    step, mlp, opt = make_aug_train_step("facenet", 4, 80, seed=1,
                                         device="cpu")
    assert step.encoder.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in step.encoder.parameters())
    cfg = {
        "transforms": {"name": "facenet_aug", "resize": False,
                       "encoder_img_size": 80},
        "metrics": ["accuracy"], "loss": "neg_log_llhood",
        "trainer": {"name": "AugClassificationTrainer", "resume_path": "",
                    "save_dir": str(tmp_path), "log_step": 100,
                    "do_validation": False, "validation_step": 1,
                    "epochs": 1, "tracked_metric": ["val_neg_log_llhood",
                                                    "min"],
                    "patience": 10, "save_period": 10},
        "optimizer": {"name": "Adam", "args": {"lr": 1e-4,
                                               "weight_decay": 1e-4}},
    }
    trainer = PAug(cfg, copy.deepcopy(mlp), device="cpu",
                   encoder=step.encoder)
    gen = np.random.default_rng(6)
    imgs = torch.from_numpy(gen.integers(0, 256, (4, 80, 80, 3),
                                         dtype=np.uint8))
    target = torch.arange(4, dtype=torch.int32)
    weight = torch.ones(4)
    before = kernels.launch_counts()
    loss = step(mlp, opt, imgs, target, weight,
                torch.Generator().manual_seed(7))
    trainer.generator.manual_seed(7)
    vals = trainer._train_step({"data": imgs, "target": target,
                                "weight": weight})
    assert kernels.launch_counts() == before
    assert float(loss) == vals[0] and np.isfinite(vals[0])
    for k, v in mlp.state_dict().items():
        assert torch.equal(trainer.model.state_dict()[k], v), k

    # the MLP update on the step's embeddings against JAX's, dropout 0
    with torch.no_grad():
        x = PA.facenet_aug(torch.Generator().manual_seed(9), imgs)
        emb = step.encoder(x.permute(0, 3, 1, 2)).float()
    mlp.dropout_prob = 0.0
    variables = np_tree(state_dict_to_jax(mlp))
    tx = JO.make_optimizer("Adam", {"lr": 1e-4, "weight_decay": 1e-4})
    opt_state = tx.init(variables["params"])
    jmlp = JMLP(512, 4, dropout_prob=0.0)

    def loss_of(params):
        out = jmlp.apply({"params": params}, jnp.asarray(emb.numpy()),
                         train=True)
        return JL.neg_log_llhood(out, jnp.asarray(target.numpy()),
                                 jnp.asarray(weight.numpy()))

    jloss, grads = jax.value_and_grad(loss_of)(variables["params"])
    upd, _ = tx.update(grads, opt_state, variables["params"])
    params = optax.apply_updates(variables["params"], upd)
    fresh_opt = PO.make_optimizer("Adam", {"lr": 1e-4, "weight_decay": 1e-4},
                                  mlp.parameters())
    mlp.train()
    out = mlp(emb)
    ploss = PL.neg_log_llhood(out, target, weight)
    fresh_opt.zero_grad()
    ploss.backward()
    fresh_opt.step()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=1e-5)
    assert_state_close(mlp.state_dict(), {"params": params}, 1e-5)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; the no-card contract is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_aug_train_step("facenet", 4, 80)


# ---------------------------------------------------------------------------
# the CLIs on a toy copy of cfg/train_cfg_img_classify.json
# ---------------------------------------------------------------------------


def absl_handlers_write_to_capsys(monkeypatch):
    """absl's logging handler, put on the root logger when absl is
    imported, closes its stream when ``logging.config.dictConfig`` (the
    trainer's ``setup_logging``) shuts it down, unless that stream is the
    current ``sys.stdout`` or ``sys.stderr``. Under ``capsys`` its stream
    is pytest's own capture file, which the process then loses. A test
    whose process has not yet run a trainer (the first of its module on
    an xdist worker under ``--dist load``, or alone) points it at capsys's
    stderr."""
    for ref in list(logging._handlerList):
        h = ref()
        if (h is not None and type(h).__module__.startswith("absl")
                and hasattr(h, "stream")):
            monkeypatch.setattr(h, "stream", sys.stderr)


def test_cli_train_and_eval_image_classify(color_images, tmp_path,
                                           monkeypatch, capsys):
    """cli.train -d CPU on cfg/train_cfg_img_classify.json with its
    dataset, batch sizes (16 and 8), epochs (1) and save_dir cut to a toy:
    InceptionResnetV1
    with classify=True (1,000 classes, seeded after the missing-weights
    warning), rank1_aug and train-mode BatchNorm write checkpoints whose
    weights and batch_stats the JAX package restores; cli.eval on the best
    one writes result.csv with one row per validation image; without -d
    CPU on a machine without a card both raise."""
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    absl_handlers_write_to_capsys(monkeypatch)
    with open(os.path.join(REPO, "cfg", "train_cfg_img_classify.json")) as fp:
        cfg = json.load(fp)
    root = color_images
    for split, manifest in (("train_dataset", "train.json"),
                            ("val_dataset", "val.json")):
        cfg[split]["args"] = {"data_dir": str(root / "data"),
                              "label_file": str(root / manifest)}
    cfg["train_data_loader"]["args"]["batch_size"] = 16
    cfg["val_data_loader"]["args"]["batch_size"] = 8
    cfg["trainer"].update(epochs=1, save_dir=str(tmp_path / "saved"))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    trainer = p_train.main(["-c", str(path), "-d", "CPU"])
    assert "Warning: pretrained='vggface2'" in capsys.readouterr().out
    assert isinstance(trainer.model, InceptionResnetV1)
    assert trainer.model.logits.out_features == 1000
    names = sorted(os.listdir(trainer.save_dir))
    assert names == ["checkpoint-epoch1.ckpt", "model_best.ckpt"]
    with open(trainer.log_dir / "log_loss.txt") as fp:
        assert [r[0] for r in csv.reader(fp)] == ["Epoch", "1"]
    with open(trainer.save_dir / "checkpoint-epoch1.ckpt", "rb") as fp:
        cp = pickle.load(fp)
    assert cp["arch"] == "InceptionResnetV1" and cp["epoch"] == 1
    assert cp["state_dict"]["params"]["logits"]["kernel"].shape == (512, 1000)
    mean = cp["state_dict"]["batch_stats"]["conv2d_1a"]["bn"]["mean"]
    assert np.abs(mean).sum() > 0.0  # the running statistics moved
    jmodel = JIRv1(classify=True, num_classes=1000)
    template = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 80, 80, 3))))
    restored = j_restore(np_tree(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), template)), cp["state_dict"])
    assert_state_close(trainer.model.state_dict(), restored, 0.0)

    eval_cfg = copy.deepcopy(cfg)
    eval_cfg["trainer"].update(
        resume_path=str(trainer.save_dir / "model_best.ckpt"),
        save_result=True, save_dir=str(tmp_path / "eval"))
    eval_path = tmp_path / "eval.json"
    eval_path.write_text(json.dumps(eval_cfg))
    ev = p_eval.main(["-c", str(eval_path), "-d", "CPU"])
    with open(ev.save_dir / "result.csv", newline="") as fp:
        rows = list(csv.reader(fp))
    assert rows[0] == ["Path", "Target", "Prediction", "Probability"]
    assert len(rows) == 1 + 5
    assert all(0.0 < float(r[3]) <= 1.0 for r in rows[1:])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; the no-card contract is moot")
    for main in (p_train.main, p_eval.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-c", str(path)])
