"""The port's training layer (``training/``, ``data/``, ``ops.augment``,
``registry``, ``cli.train``/``cli.eval``) against the JAX package's, on
the CPU at small sizes: the same seeded numpy inputs and the same weights
(JAX variables carried across by ``models.convert``) go through both. The
trainers run with ``dropout_prob=0`` wherever they are compared, since
dropout draws from different generators in the two packages; dropout is
tested on its own. Each test states its tolerance."""

import copy
import csv
import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

import train as j_train
from vn_celeb_face_recognition_tpu import data as JD
from vn_celeb_face_recognition_tpu.models import iresnet as JI
from vn_celeb_face_recognition_tpu.models.mlp import MLPModel as JMLP
from vn_celeb_face_recognition_tpu.ops import augment as JA
from vn_celeb_face_recognition_tpu.ops.image import (
    fixed_image_standardization as j_fix_std,
)
from vn_celeb_face_recognition_tpu.ops.image import warp_affine as j_warp
from vn_celeb_face_recognition_tpu.training import losses as JL
from vn_celeb_face_recognition_tpu.training import optim as JO
from vn_celeb_face_recognition_tpu.training.checkpoint import (
    load_checkpoint as j_load_checkpoint,
)
from vn_celeb_face_recognition_tpu.training.checkpoint import (
    restore_variables as j_restore,
)
from vn_celeb_face_recognition_tpu.training.trainer import (
    AugClassificationTrainer as JAug,
)
from vn_celeb_face_recognition_tpu_torch import data as PD
from vn_celeb_face_recognition_tpu_torch import registry
from vn_celeb_face_recognition_tpu_torch.cli import eval as p_eval
from vn_celeb_face_recognition_tpu_torch.cli import train as p_train
from vn_celeb_face_recognition_tpu_torch.data import transforms as PT
from vn_celeb_face_recognition_tpu_torch.models import IResNet, build_model
from vn_celeb_face_recognition_tpu_torch.models.convert import (
    state_dict_from_jax,
    state_dict_to_jax,
)
from vn_celeb_face_recognition_tpu_torch.models.layers import seeded_init_
from vn_celeb_face_recognition_tpu_torch.models.mlp import MLPModel, dropout
from vn_celeb_face_recognition_tpu_torch.ops import augment as PA
from vn_celeb_face_recognition_tpu_torch.pipeline import Classifier
from vn_celeb_face_recognition_tpu_torch.training import losses as PL
from vn_celeb_face_recognition_tpu_torch.training import optim as PO
from vn_celeb_face_recognition_tpu_torch.training.trainer import (
    AugClassificationTrainer as PAug,
)
from vn_celeb_face_recognition_tpu_torch.utils import kernels
from vn_celeb_face_recognition_tpu_torch.utils.frames import (
    face_files,
    read_png,
    resize_bilinear,
    write_png,
)

from test_facenet_aug_batch import smooth_batch
from test_torch_encoder import load_pair
from test_train_slice import make_config
from torch_shared import two_threads  # noqa: F401 (autouse)

# a plateau schedule that halves the rate at every epoch after the first
# (a 50% drop is never reached), so the compared runs change their rate
HALVING = {"mode": "min", "threshold": 0.5, "factor": 0.5, "patience": 0,
           "min_lr": 1e-7, "threshold_mode": "rel"}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def emb_config(data, save_dir, epochs=4, lr=1e-5, **trainer):
    """The toy embedding config of test_train_slice, dropout 0, at a rate
    where the loss falls over several epochs, the halving schedule."""
    cfg = make_config(data, save_dir, epochs=epochs)
    cfg["model"]["args"]["dropout_prob"] = 0.0
    cfg["optimizer"]["args"]["lr"] = lr
    cfg["lr_scheduler"]["args"] = dict(HALVING)
    cfg["trainer"].update(trainer)
    return cfg


def jax_trainer(cfg):
    """The JAX package's trainer for ``cfg`` with a dropout-free MLP,
    initialised on its first validation batch (which draws nothing from
    the shuffled loader)."""
    jt, _, _ = j_train.build_trainer_from_config(copy.deepcopy(cfg))
    args = cfg["model"]["args"]
    jt.model = JMLP(args["input_dim"], args["num_classes"], dropout_prob=0.0)
    jt._ensure_ready(next(iter(jt.val_loader)))
    return jt


def port_trainer(cfg, jt=None):
    """The port's trainer for ``cfg`` on the CPU, with ``jt``'s variables
    when one is given."""
    pt, _, _ = p_train.build_trainer_from_config(copy.deepcopy(cfg),
                                                 device="cpu")
    if jt is not None:
        pt.model.load_state_dict(state_dict_from_jax(np_tree(jt.variables)))
    return pt


def record_epochs(trainer, lr_of):
    """Wrap ``trainer._train_epoch`` to record (epoch, log, rate after the
    epoch's plateau step)."""
    logs = []
    orig = trainer._train_epoch

    def wrapped(epoch):
        out = orig(epoch)
        logs.append((epoch, dict(out), lr_of()))
        return out

    trainer._train_epoch = wrapped
    return logs


def j_lr(jt):
    return lambda: JO.get_current_lr(jt.opt_state)


def p_lr(pt):
    return lambda: PO.get_current_lr(pt.optimizer)


def assert_logs_close(jlogs, plogs, rtol=1e-4):
    assert [e for e, _, _ in jlogs] == [e for e, _, _ in plogs]
    for (e, a, lr_a), (_, b, lr_b) in zip(jlogs, plogs):
        assert set(a) == set(b), e
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, atol=1e-6,
                                       err_msg=f"epoch {e} {k}")
        np.testing.assert_allclose(lr_b, lr_a, rtol=rtol, err_msg=f"lr {e}")


def assert_weights_close(jt, pt, atol=1e-4):
    want = state_dict_from_jax(np_tree(jt.variables))
    got = pt.model.state_dict()
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=atol, err_msg=k)


def loss_rows(trainer):
    with open(trainer.log_dir / "log_loss.txt") as fp:
        return list(csv.reader(fp))


# ---------------------------------------------------------------------------
# losses, optimizers, schedulers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weights", ["none", "ones", "padded", "zeros"])
def test_losses_and_metrics_match_jax(weights):
    """Weighted NLL and accuracy equal JAX's (atol 1e-6); padded rows
    (weight 0) change nothing."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(12, 7)).astype(np.float32) * 3
    log_probs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    targets = rng.integers(0, 7, 12).astype(np.int32)
    targets[:4] = log_probs[:4].argmax(1)  # some hits
    w = {"none": None, "ones": np.ones(12, np.float32),
         "padded": np.r_[np.ones(9), np.zeros(3)].astype(np.float32),
         "zeros": np.zeros(12, np.float32)}[weights]
    for name in ("neg_log_llhood", "accuracy"):
        jfn = {**JL.LOSSES, **JL.METRICS}[name]
        pfn = {**PL.LOSSES, **PL.METRICS}[name]
        want = float(jfn(jnp.asarray(log_probs), jnp.asarray(targets),
                         None if w is None else jnp.asarray(w)))
        got = float(pfn(torch.from_numpy(log_probs),
                        torch.from_numpy(targets),
                        None if w is None else torch.from_numpy(w)))
        assert abs(got - want) <= 1e-6, (name, got, want)
    if weights == "padded":
        real = float(PL.neg_log_llhood(torch.from_numpy(log_probs[:9]),
                                       torch.from_numpy(targets[:9])))
        got = float(PL.neg_log_llhood(torch.from_numpy(log_probs),
                                      torch.from_numpy(targets),
                                      torch.from_numpy(w)))
        assert abs(got - real) <= 1e-6


@pytest.mark.parametrize("name,args", [
    ("Adam", {"lr": 1e-3, "weight_decay": 1e-4}),
    ("SGD", {"lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4}),
], ids=["adam_wd", "sgd_momentum_wd"])
def test_optimizer_tracks_jax(name, args):
    """make_optimizer's torch optimizer tracks the JAX make_optimizer's
    optax chain for 20 steps on the same gradients: rtol 1e-5, and atol a
    thousandth of one step's size (lr), for weights that pass near 0."""
    jmodel = JMLP(16, 5)
    params = np_tree(jmodel.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 16)))["params"])
    module = MLPModel(16, 5)
    module.load_state_dict(state_dict_from_jax({"params": params}))
    tx = JO.make_optimizer(name, args)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    opt = PO.make_optimizer(name, args, module.parameters())

    @jax.jit
    def update(grads, state, jparams):
        upd, state = tx.update(grads, state, jparams)
        return optax.apply_updates(jparams, upd), state

    rng = np.random.default_rng(1)
    for step in range(20):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        jparams, state = update(grads, state, jparams)
        tgrads = state_dict_from_jax({"params": grads})
        for key, p in module.named_parameters():
            p.grad = tgrads[key]
        opt.step()
        want = state_dict_from_jax({"params": np_tree(jparams)})
        for key, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(),
                                       rtol=1e-5, atol=1e-3 * args["lr"],
                                       err_msg=f"{key} step {step}")


@pytest.mark.parametrize("kw", [
    {"mode": "min", "threshold": 0.01, "threshold_mode": "rel",
     "factor": 0.5, "patience": 1, "min_lr": 1e-5},
    {"mode": "min", "threshold": 0.05, "threshold_mode": "abs",
     "factor": 0.3, "patience": 0, "min_lr": 1e-6},
    {"mode": "max", "threshold": 0.01, "threshold_mode": "rel",
     "factor": 0.5, "patience": 1, "cooldown": 2, "min_lr": 1e-6},
], ids=["rel", "abs", "cooldown"])
def test_reduce_lr_on_plateau_matches_jax(kw):
    """The same learning rates as the JAX ReduceLROnPlateau on a fixed
    metric sequence (rel 1e-12). torch skips a reduction smaller than its
    eps (1e-8) and the JAX class does not, so the rates stay above that
    (``min_lr``)."""
    metrics = [1.0, 0.95, 0.949, 0.949, 0.8, 0.8, 0.799, 0.9, 0.5, 0.5,
               0.5, 0.5, 0.49, 0.7, 0.7, 0.7]
    jsched = JO.ReduceLROnPlateau(**kw)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1e-3)
    psched = PO.make_lr_scheduler("ReduceLROnPlateau", dict(kw, verbose=True),
                                  opt)
    lr, reduced = 1e-3, 0
    for m in metrics:
        new = jsched.step(m, lr)
        reduced += new < lr
        lr = new
        psched.step(m)
        assert PO.get_current_lr(opt) == pytest.approx(lr, rel=1e-12)
    assert reduced >= 2


def test_multistep_lr_compounds_in_jax_not_in_port(toy_embedding_dataset,
                                                    tmp_path):
    """ROADMAP C7: with milestones=[2], gamma 0.1, the JAX trainer passes
    its current rate as MultiStepLR's base every epoch, so after epoch 2
    the rate shrinks by 10x every epoch; the port follows torch, one step
    at the milestone. Rates after epochs 2-5 (rel 1e-6)."""
    cfg = emb_config(toy_embedding_dataset, tmp_path / "j", epochs=5,
                     lr=1e-3, save_period=100)
    cfg["lr_scheduler"] = {"name": "MultiStepLR",
                           "args": {"milestones": [2], "gamma": 0.1}}
    rates = {}
    for side in ("jax", "port"):
        cfg["trainer"]["save_dir"] = str(tmp_path / side)
        if side == "jax":
            t = jax_trainer(cfg)
            lr_of = j_lr(t)
        else:
            t = port_trainer(cfg)
            lr_of = p_lr(t)
        seen = []
        orig = t._train_epoch

        def wrapped(epoch, orig=orig, seen=seen, lr_of=lr_of):
            if epoch > 1:
                seen.append(lr_of())  # the rate after epoch - 1
            return orig(epoch)

        t._train_epoch = wrapped
        t.train()
        rates[side] = seen[1:] + [lr_of()]
    np.testing.assert_allclose(rates["jax"], [1e-4, 1e-5, 1e-6, 1e-7],
                               rtol=1e-6)
    np.testing.assert_allclose(rates["port"], [1e-4] * 4, rtol=1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_data_loader_matches_jax(toy_embedding_dataset, shuffle, seed):
    """The same batches as the JAX DataLoader, two epochs: order, padding
    (the last batch of 80 at batch 24), weight and path, exactly."""
    d = toy_embedding_dataset
    jl = JD.DataLoader(JD.VNCelebEmbDataset(d["emb_dir"], d["train_json"]),
                       batch_size=24, shuffle=shuffle, seed=seed)
    pl = PD.DataLoader(PD.VNCelebEmbDataset(d["emb_dir"], d["train_json"]),
                       batch_size=24, shuffle=shuffle, seed=seed)
    assert len(jl) == len(pl) == 4
    for _ in range(2):
        got, want = list(pl), list(jl)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in ("data", "target", "weight"):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a["path"] == b["path"]
    assert got[-1]["weight"].sum() == 80 - 3 * 24
    assert got[-1]["path"][-1] == ""


def test_emb_dataset_matches_jax(toy_embedding_dataset):
    d = toy_embedding_dataset
    jd = JD.VNCelebEmbDataset(d["emb_dir"], d["val_json"])
    pd_ = PD.VNCelebEmbDataset(d["emb_dir"], d["val_json"])
    assert len(pd_) == len(jd) == 16 and pd_.n_classes == jd.n_classes
    for i in range(len(jd)):
        (a, la, pa), (b, lb, pb) = pd_[i], jd[i]
        assert a.dtype == np.float32 and la == lb and pa == pb
        np.testing.assert_array_equal(a, b)


def test_image_dataset_matches_pil_decode(tmp_path):
    """VNCelebDataset on the repo's face PNGs: the port's decode equals the
    JAX package's PIL ``convert("RGB")``, bit for bit, with the same labels
    and paths."""
    files = face_files()
    assert len(files) == 20
    names = [os.path.basename(f) for f in files]
    manifest = {str(c): names[c::4] for c in range(4)}
    label_file = tmp_path / "labels.json"
    label_file.write_text(json.dumps(manifest))
    data_dir = os.path.dirname(files[0])
    jd = JD.VNCelebDataset(data_dir, str(label_file))
    pd_ = PD.VNCelebDataset(data_dir, str(label_file))
    assert len(pd_) == len(jd) == 20
    for i in range(len(jd)):
        (a, la, pa), (b, lb, pb) = pd_[i], jd[i]
        assert a.dtype == np.uint8 and a.shape == b.shape
        assert (la, pa) == (lb, pb)
        np.testing.assert_array_equal(a, b)


def test_prefetch_to_device_keeps_order_and_raises():
    batches = [{"data": np.full((2, 3), i, np.float32), "path": [str(i)]}
               for i in range(7)]
    got = list(PD.prefetch_to_device(iter(batches), "cpu", size=2))
    assert [b["path"] for b in got] == [b["path"] for b in batches]
    assert all(isinstance(b["data"], torch.Tensor)
               and float(b["data"][0, 0]) == i for i, b in enumerate(got))

    def broken():
        yield batches[0]
        raise OSError("unreadable file")

    it = PD.prefetch_to_device(broken(), "cpu")
    assert next(it)["path"] == ["0"]
    with pytest.raises(OSError, match="unreadable"):
        next(it)
    # closing early stops the reader
    it = PD.prefetch_to_device(iter(batches * 10), "cpu", size=1)
    next(it)
    it.close()


# ---------------------------------------------------------------------------
# facenet_aug
# ---------------------------------------------------------------------------


def uint8_batch(seed, b=8):
    return np.clip(np.round(smooth_batch(np.random.default_rng(seed), b=b)),
                   0, 255).astype(np.uint8)


def jax_params(key, b, n):
    mats, flip, offs = JA._facenet_aug_params(key, b, n, n, n)
    return np.asarray(mats), np.asarray(offs), np.asarray(flip)


def test_facenet_aug_apply_matches_exact_composite():
    """facenet_aug_apply with parameters replayed from JAX
    _facenet_aug_params equals the sequential composite (JAX warp_affine
    rotation, pad-2 crop, flip, fixed_image_standardization) within 1e-4,
    as tests/test_facenet_aug_batch.py builds it; the uint8 batch (K1's
    frames form) and the same batch in f32 (its windows form) agree
    exactly; on CPU tensors no kernel launches."""
    imgs = uint8_batch(1, b=6)
    b, h, w, _ = imgs.shape
    mats, offs, flip = jax_params(jax.random.PRNGKey(7), b, h)
    assert 0 < flip.sum() < b
    before = kernels.launch_counts()
    args = [torch.from_numpy(a.copy()) for a in (mats, offs, flip)]
    got = PA.facenet_aug_apply(torch.from_numpy(imgs), *args, h).numpy()
    got_f = PA.facenet_aug_apply(torch.from_numpy(imgs).float(), *args,
                                 h).numpy()
    assert kernels.launch_counts() == before
    np.testing.assert_array_equal(got, got_f)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    warp = jax.jit(j_warp, static_argnums=2)
    for i in range(b):
        cs, sn = float(mats[i, 0, 0]), float(mats[i, 1, 0])
        m = np.array([[cs, -sn, cx - cs * cx + sn * cy],
                      [sn, cs, cy - sn * cx - cs * cy]], np.float32)
        rot = np.asarray(warp(jnp.asarray(imgs[i].astype(np.float32)),
                              jnp.asarray(m), (h, w)))
        padded = np.pad(rot, ((2, 2), (2, 2), (0, 0)))
        oy, ox = int(offs[i, 0]), int(offs[i, 1])
        ref = padded[oy + 2:oy + 2 + h, ox + 2:ox + 2 + w]
        if flip[i]:
            ref = ref[:, ::-1]
        ref = np.asarray(j_fix_std(jnp.asarray(ref)))
        np.testing.assert_allclose(got[i], ref, atol=1e-4, rtol=0,
                                   err_msg=f"image {i}")


def test_facenet_aug_within_shear_bound():
    """Against JAX facenet_aug_shear (the TPU formulation) on the same key:
    mean < 1 px and p99 < 10 px, the bound of
    tests/test_facenet_aug_batch.py."""
    imgs = uint8_batch(5)
    b, h, _, _ = imgs.shape
    key = jax.random.PRNGKey(13)
    shear = np.asarray(jax.jit(JA.facenet_aug_shear)(key, jnp.asarray(
        imgs.astype(np.float32))))
    got = PA.facenet_aug_apply(
        torch.from_numpy(imgs),
        *[torch.from_numpy(a.copy()) for a in jax_params(key, b, h)],
        h).numpy()
    d = np.abs(got - shear) * 128.0
    assert d.mean() < 1.0, d.mean()
    assert np.percentile(d, 99) < 10.0


def test_facenet_aug_params_distributions():
    """deg in [-10, 10] (the folded rotation's angle), crop origins in
    {-2..2}, flip rate near 0.5 (1,000 draws, 4 sigma), the fold equal to
    JAX's on the same draws (1e-5), and other generators giving other
    outputs; standardised outputs stay in [-1, 1]."""
    g = torch.Generator().manual_seed(0)
    mats, offs, flip = PA.facenet_aug_params(g, 1000, 112, 112, 112)
    deg = torch.rad2deg(torch.atan2(mats[:, 1, 0], mats[:, 0, 0]))
    assert float(deg.min()) >= -10.0 and float(deg.max()) <= 10.0
    assert float(deg.std()) > 5.0
    assert offs.dtype == torch.int64
    assert set(offs.flatten().tolist()) == {-2, -1, 0, 1, 2}
    assert abs(float(flip.float().mean()) - 0.5) < 4 * 0.5 / np.sqrt(1000)
    # the fold of JAX _facenet_aug_params, on JAX's own draws
    key = jax.random.PRNGKey(3)
    jm, _, jo = JA._facenet_aug_params(key, 16, 112, 112, 112)
    k_rot, k_crop, _ = jax.random.split(key, 3)
    jdeg = jax.random.uniform(k_rot, (16,), minval=-10.0, maxval=10.0)
    k1, k2 = jax.random.split(k_crop)
    y0 = jax.random.randint(k1, (16,), 0, 5)
    x0 = jax.random.randint(k2, (16,), 0, 5)
    pm, po = PA.fold_facenet_aug(*(torch.from_numpy(np.asarray(a))
                                   for a in (jdeg, y0, x0)), 112, 112)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    imgs = torch.from_numpy(uint8_batch(2, b=4))
    outs = [PA.facenet_aug(torch.Generator().manual_seed(s), imgs)
            for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1])
    assert float((outs[0] - outs[2]).abs().max()) > 1e-3
    assert float(outs[0].abs().max()) <= 1.0 + 1e-6
    with pytest.raises(ValueError, match="square"):
        PA.facenet_aug(g, torch.zeros((1, 8, 10, 3), dtype=torch.uint8))


def test_transform_facenet_aug_is_facenet_aug():
    imgs = torch.from_numpy(uint8_batch(3, b=4))
    got = PT.get_transform("facenet_aug")(imgs,
                                          torch.Generator().manual_seed(5))
    want = PA.facenet_aug(torch.Generator().manual_seed(5), imgs)
    assert torch.equal(got, want)
    # rank1_aug draws from the generator too (tests/test_torch_rank1_aug.py
    # holds it to the JAX package)
    got = PT.get_transform("rank1_aug")(imgs,
                                        torch.Generator().manual_seed(5))
    want = PA.rank1_vn_celeb_aug(torch.Generator().manual_seed(5), imgs)
    assert got.shape == imgs.shape and torch.equal(got, want)


# ---------------------------------------------------------------------------
# models: dropout and the flax layout
# ---------------------------------------------------------------------------


def test_mlp_dropout_rate_and_scale():
    """Train mode drops ~p of the hidden units with the generator's mask
    and scales the rest by 1/(1-p); the same generator state gives the
    same mask; eval mode computes what it did without dropout."""
    x = torch.ones((200, 2048))
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.5, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert torch.all(y[kept] == 2.0)
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(dropout(x, 0.5, g2), y)
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, None)
    m = seeded_init_(MLPModel(8, 3), torch.Generator().manual_seed(1))
    z = torch.randn(5, 8)
    plain = MLPModel(8, 3, dropout_prob=0.0)
    plain.load_state_dict(m.state_dict())
    assert torch.equal(m.eval()(z), plain.train()(z))
    m.train()
    a = m(z, generator=torch.Generator().manual_seed(2))
    b = m(z, generator=torch.Generator().manual_seed(3))
    assert not torch.equal(a, b)


def test_state_dict_to_jax_inverts_state_dict_from_jax():
    """The flax layout of an iresnet (conv, BatchNorm, PReLU, dense) and
    of the MLP: JAX's modules apply to it and agree with the port's (cos
    > 0.9999), and state_dict_from_jax gives the weights back exactly."""
    enc, jvars = load_pair(IResNet((1, 1, 1, 1)), seed=21)
    back = state_dict_to_jax(enc)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(np_tree(jvars))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(np_tree(jvars))):
        np.testing.assert_array_equal(a, b)
    faces = np.random.default_rng(0).uniform(-1, 1, (2, 112, 112, 3)).astype(
        np.float32)
    want = np.asarray(JI.IResNet(layers=(1, 1, 1, 1)).apply(
        back, jnp.asarray(faces)))
    with torch.no_grad():
        got = enc(torch.from_numpy(faces).permute(0, 3, 1, 2)).numpy()
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.9999
    mlp = seeded_init_(MLPModel(512, 9), torch.Generator().manual_seed(4))
    sd = state_dict_from_jax(state_dict_to_jax(mlp.state_dict()))
    assert all(torch.equal(sd[k], v) for k, v in mlp.state_dict().items())


# ---------------------------------------------------------------------------
# ClassificationTrainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["learning", "plateau"])
def test_classification_trainer_matches_jax(toy_embedding_dataset, tmp_path,
                                            case):
    """train() of both trainers from the same weights: per epoch, train and
    val loss, accuracy and the rate within rtol 1e-4; the same early-stop
    epoch, checkpoint file names and log_loss.txt rows (epochs exact,
    losses within rtol 1e-4); final weights within 1e-4. ``learning``:
    rate 1e-5 halved every epoch, 5 epochs; ``plateau``: rate 1e-3, where
    the toy set saturates at once and early stop ends the run."""
    if case == "learning":
        kw = dict(epochs=5, lr=1e-5, save_period=2)
    else:
        kw = dict(epochs=20, lr=1e-3, save_period=1, patience=1)
    jt = jax_trainer(emb_config(toy_embedding_dataset, tmp_path / "jax",
                                **kw))
    pt = port_trainer(emb_config(toy_embedding_dataset, tmp_path / "port",
                                 **kw), jt)
    jlogs, plogs = record_epochs(jt, j_lr(jt)), record_epochs(pt, p_lr(pt))
    jt.train(track4plot=True)
    pt.train(track4plot=True)
    assert_logs_close(jlogs, plogs)
    if case == "plateau":
        assert len(plogs) < 20  # early stop
        assert plogs[-1][2] < 1e-3  # the plateau schedule cut the rate
    else:
        assert plogs[-1][1]["neg_log_llhood"] < plogs[0][1]["neg_log_llhood"]
    assert sorted(os.listdir(pt.save_dir)) == sorted(os.listdir(jt.save_dir))
    jrows, prows = loss_rows(jt), loss_rows(pt)
    assert len(prows) == len(jrows) == len(plogs) + 1
    assert prows[0] == jrows[0] == ["Epoch", "Train_loss", "Validation_loss"]
    for a, b in zip(prows[1:], jrows[1:]):
        assert a[0] == b[0]
        np.testing.assert_allclose([float(v) for v in a[1:]],
                                   [float(v) for v in b[1:]], rtol=1e-4,
                                   atol=1e-6)
    assert_weights_close(jt, pt)


def test_port_checkpoint_loads_in_jax(toy_embedding_dataset, tmp_path):
    """A checkpoint the port writes is the JAX package's one-pickle dict:
    JAX's load_checkpoint + restore_variables give the port's log-probs
    (atol 1e-5), and the port's Classifier reads it too."""
    cfg = emb_config(toy_embedding_dataset, tmp_path, epochs=2, lr=1e-4,
                     save_period=2)
    pt = port_trainer(cfg)
    pt.train()
    path = pt.save_dir / "checkpoint-epoch2.ckpt"
    cp = j_load_checkpoint(str(path))
    assert {"arch", "epoch", "state_dict", "optimizer", "monitor_best",
            "config"} <= set(cp)
    assert cp["arch"] == "MLPModel" and cp["epoch"] == 2
    jmodel = JMLP(512, toy_embedding_dataset["n_classes"])
    template = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 512)))
    variables = j_restore(template, cp["state_dict"])
    x = np.random.default_rng(0).normal(size=(6, 512)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    pt.model.eval()
    with torch.no_grad():
        got = pt.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    clf = Classifier.build(512, toy_embedding_dataset["n_classes"],
                           checkpoint_path=str(path), device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(
            clf.module(torch.from_numpy(x)).numpy(), got)


def test_port_resume_is_exact(toy_embedding_dataset, tmp_path):
    """A port run resumed from its epoch-2 checkpoint continues exactly as
    the uninterrupted run (dropout 0.5 on, so the generator's state
    counts; shuffled batches, so the loader's does): epochs 3-4 logs and
    rates equal, final weights equal."""
    cfg = emb_config(toy_embedding_dataset, tmp_path / "a", epochs=4,
                     lr=1e-4, save_period=2)
    cfg["model"]["args"]["dropout_prob"] = 0.5
    full = port_trainer(cfg)
    full_logs = record_epochs(full, p_lr(full))
    full.train()
    cfg["trainer"]["save_dir"] = str(tmp_path / "b")
    cfg["trainer"]["resume_path"] = str(full.save_dir
                                        / "checkpoint-epoch2.ckpt")
    resumed = port_trainer(cfg)
    assert resumed.start_epoch == 3
    logs = record_epochs(resumed, p_lr(resumed))
    resumed.train()
    assert logs == full_logs[2:]
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_jax_checkpoint_resumes_in_port(toy_embedding_dataset, tmp_path):
    """A JAX checkpoint resumed in the port continues as the JAX trainer
    resumed from it: the weights, epoch, best metric, the reduced rate and
    Adam's moments and count come across (epochs 3-5 within rtol 1e-4,
    final weights within 1e-4)."""
    cfg = emb_config(toy_embedding_dataset, tmp_path / "j0", epochs=2,
                     save_period=2)
    first = jax_trainer(cfg)
    first.train()
    ckpt = str(first.save_dir / "checkpoint-epoch2.ckpt")
    assert JO.get_current_lr(first.opt_state) < 1e-5  # halved
    cfg["trainer"].update(epochs=5, resume_path=ckpt, save_period=100)
    trainers = {}
    for side in ("jax", "port"):
        cfg["trainer"]["save_dir"] = str(tmp_path / side)
        if side == "jax":
            t = jax_trainer(cfg)  # resumes on its first batch
            logs = record_epochs(t, j_lr(t))
        else:
            t = port_trainer(cfg)
            logs = record_epochs(t, p_lr(t))
            assert t.mnt_best == pytest.approx(first.mnt_best)
        assert t.start_epoch == 3
        t.train()
        trainers[side] = (t, logs)
    (jt, jlogs), (pt, plogs) = trainers["jax"], trainers["port"]
    assert [e for e, _, _ in plogs] == [3, 4, 5]
    assert_logs_close(jlogs, plogs)
    assert_weights_close(jt, pt)


def test_eval_result_csv_matches_jax(toy_embedding_dataset, tmp_path):
    """eval(save_result=True) of the JAX trainer after two epochs and of
    the port's with those weights: result.csv rows equal (paths, targets
    and predictions exact, probabilities within 1e-5), the padded rows of
    the last batch left out."""
    cfgs = [emb_config(toy_embedding_dataset, tmp_path / side, epochs=2,
                       lr=1e-4, save_period=100) for side in ("jax", "port")]
    for cfg in cfgs:
        cfg["val_data_loader"]["args"]["batch_size"] = 5  # 16 = 3x5 + 1
    jt = jax_trainer(cfgs[0])
    jt.train()
    trainers = [jt, port_trainer(cfgs[1], jt)]  # the trained weights
    rows = []
    for t in trainers:
        t.eval(save_result=True)
        with open(t.save_dir / "result.csv", newline="") as fp:
            rows.append(list(csv.reader(fp)))
    want, got = rows
    assert got[0] == want[0] == ["Path", "Target", "Prediction",
                                 "Probability"]
    assert len(got) == len(want) == 17
    for a, b in zip(got[1:], want[1:]):
        assert a[:3] == b[:3]
        assert abs(float(a[3]) - float(b[3])) <= 1e-5


# ---------------------------------------------------------------------------
# AugClassificationTrainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def face_dataset(tmp_path_factory):
    """4 classes x 5 of the repo's face PNGs resized to 112 px (4 train,
    1 val each)."""
    root = tmp_path_factory.mktemp("faces112")
    img_dir = root / "train"
    img_dir.mkdir()
    files = face_files()
    train, val = {}, {}
    for c in range(4):
        names = []
        for j in range(5):
            img = resize_bilinear(read_png(files[c * 5 + j]), (112, 112))
            write_png(str(img_dir / f"{c}_{j}.png"), img)
            names.append(f"{c}_{j}.png")
        train[str(c)], val[str(c)] = names[:-1], names[-1:]
    (root / "train.json").write_text(json.dumps(train))
    (root / "val.json").write_text(json.dumps(val))
    return root


def aug_config(root, save_dir, transform, epochs=3, lr=1e-4):
    return {
        "transforms": {"name": transform, "resize": False,
                       "encoder_img_size": 112},
        "metrics": ["accuracy"],
        "loss": "neg_log_llhood",
        "trainer": {
            "name": "AugClassificationTrainer", "resume_path": "",
            "save_dir": str(save_dir), "device": "CPU", "log_step": 100,
            "do_validation": True, "validation_step": 1, "epochs": epochs,
            "tracked_metric": ["val_neg_log_llhood", "min"],
            "patience": 10, "save_period": 10, "track4plot": False,
            "chosen_idx_enc": 2,
            "encoders": [
                {"name": "InceptionResnetV1", "args": {"pretrained": None}},
                {"name": "resnet101", "args": {"use_se": True}},
                {"name": "iresnet100", "args": {"pretrained": False}},
            ],
        },
        "optimizer": {"name": "Adam", "args": {"lr": lr,
                                               "weight_decay": 1e-4}},
        "lr_scheduler": {"name": "ReduceLROnPlateau",
                         "args": dict(HALVING)},
    }


def loaders(pkg, root):
    train = pkg.DataLoader(pkg.VNCelebDataset(str(root / "train"),
                                              str(root / "train.json")),
                           batch_size=8, shuffle=True, seed=123)
    val = pkg.DataLoader(pkg.VNCelebDataset(str(root / "train"),
                                            str(root / "val.json")),
                         batch_size=8)
    return train, val


def test_aug_trainer_matches_jax(face_dataset, tmp_path):
    """uint8 112 px faces -> the default transform -> a frozen shallow
    iresnet (weights carried across) -> MLP: three epochs of both
    trainers, per-epoch logs and rates within rtol 1e-4, MLP weights
    within 1e-4."""
    enc, jvars = load_pair(IResNet((1, 1, 1, 1)), seed=21)
    cfg = aug_config(face_dataset, tmp_path / "jax", "default")
    jt = JAug(copy.deepcopy(cfg), JMLP(512, 4, dropout_prob=0.0), seed=123,
              encoder=JI.IResNet(layers=(1, 1, 1, 1)),
              encoder_variables=jvars)
    jt.setup_loader(*loaders(JD, face_dataset))
    jt._ensure_ready(next(iter(jt.val_loader)))
    mlp = build_model("MLPModel", input_dim=512, num_classes=4,
                      dropout_prob=0.0)
    mlp.load_state_dict(state_dict_from_jax(np_tree(jt.variables)))
    cfg["trainer"]["save_dir"] = str(tmp_path / "port")
    pt = PAug(copy.deepcopy(cfg), mlp, seed=123, device="cpu", encoder=enc)
    pt.setup_loader(*loaders(PD, face_dataset))
    jlogs, plogs = record_epochs(jt, j_lr(jt)), record_epochs(pt, p_lr(pt))
    for epoch in (1, 2, 3):
        jt._train_epoch(epoch)
        pt._train_epoch(epoch)
    assert_logs_close(jlogs, plogs)
    assert_weights_close(jt, pt)


def test_aug_trainer_facenet_aug_learns_with_frozen_encoder(face_dataset,
                                                            tmp_path):
    """With facenet_aug on the CPU (K1's plain version, no launch), the
    training loss falls over 8 epochs; the encoder's weights are unchanged
    and no gradient reaches them; resnet101 (chosen_idx_enc 1) builds the
    frozen SE-IR encoder; more than one device outside a process group
    that ``parallel.launch`` started raises (it builds a mesh of the
    launched processes; tests/test_torch_parallel.py runs it)."""
    enc = seeded_init_(IResNet((1, 1, 1, 1)), torch.Generator().manual_seed(3))
    w0 = {k: v.clone() for k, v in enc.state_dict().items()}
    mlp = build_model("MLPModel", input_dim=512, num_classes=4,
                      dropout_prob=0.0)
    cfg = aug_config(face_dataset, tmp_path, "facenet_aug", epochs=8,
                     lr=1e-3)
    del cfg["lr_scheduler"]
    pt = PAug(cfg, mlp, seed=123, device="cpu", encoder=enc)
    pt.setup_loader(*loaders(PD, face_dataset))
    before = kernels.launch_counts()
    logs = record_epochs(pt, p_lr(pt))
    pt.train()
    assert kernels.launch_counts() == before
    losses = [log["neg_log_llhood"] for _, log, _ in logs]
    assert losses[-1] < 0.5 * losses[0], losses
    assert all(p.grad is None and not p.requires_grad
               for p in pt.encoder.parameters())
    for k, v in pt.encoder.state_dict().items():
        assert torch.equal(v, w0[k]), k
    assert not pt.encoder.training
    cfg["trainer"]["chosen_idx_enc"] = 1  # the SE-IR encoder, frozen
    se = PAug(cfg, mlp, device="cpu").encoder
    assert type(se).__name__ == "ResNetSE" and not se.training
    assert not any(p.requires_grad for p in se.parameters())
    cfg["trainer"]["chosen_idx_enc"] = 2
    cfg["trainer"]["n_devices"] = 2
    with pytest.raises(RuntimeError, match="parallel.launch"):
        PAug(cfg, mlp, device="cpu", encoder=enc)


# ---------------------------------------------------------------------------
# registry and the CLIs
# ---------------------------------------------------------------------------


def test_registry_lists_valid_names():
    assert set(registry.DATASETS) == {"VNCelebDataset", "VNCelebEmbDataset"}
    assert set(registry.TRAINERS) == {"ClassificationTrainer",
                                      "AugClassificationTrainer"}
    assert registry.get_loss("neg_log_llhood") is PL.neg_log_llhood
    assert registry.get_metric("accuracy") is PL.accuracy
    for fn, what in ((registry.build_dataset, "VNCelebEmbDataset"),
                     (registry.build_trainer, "ClassificationTrainer"),
                     (registry.get_loss, "neg_log_llhood"),
                     (registry.get_metric, "accuracy")):
        with pytest.raises(KeyError, match=what):
            fn("nope")


def test_cli_train_and_eval_on_cpu(toy_embedding_dataset, tmp_path):
    """cli.train.main -d CPU writes the run dirs, checkpoints, info.txt and
    log_loss.txt; cli.eval.main on its best checkpoint writes result.csv
    with one row per validation sample; without -d CPU on a machine
    without a card both raise."""
    cfg = emb_config(toy_embedding_dataset, tmp_path / "saved", epochs=4,
                     lr=1e-4)
    cfg["trainer"]["device"] = "TPU"
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    trainer = p_train.main(["-c", str(path), "-d", "CPU"])
    names = sorted(os.listdir(trainer.save_dir))
    assert names == ["checkpoint-epoch4.ckpt", "model_best.ckpt"]
    rows = loss_rows(trainer)
    assert [r[0] for r in rows] == ["Epoch", "1", "2", "3", "4"]
    assert (trainer.log_dir / "info.txt").exists()
    eval_cfg = copy.deepcopy(cfg)
    eval_cfg["trainer"].update(
        resume_path=str(trainer.save_dir / "model_best.ckpt"),
        save_result=True, save_dir=str(tmp_path / "eval"))
    eval_path = tmp_path / "eval.json"
    eval_path.write_text(json.dumps(eval_cfg))
    ev = p_eval.main(["-c", str(eval_path), "-d", "CPU"])
    with open(ev.save_dir / "result.csv", newline="") as fp:
        result = list(csv.reader(fp))
    assert len(result) == 1 + toy_embedding_dataset["n_classes"]
    assert sum(r[1] == r[2] for r in result[1:]) >= 12  # learned
    with open(trainer.save_dir / "model_best.ckpt", "rb") as fp:
        assert pickle.load(fp)["epoch"] >= 1
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; the no-card contract is moot")
    for main in (p_train.main, p_eval.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-c", str(path)])
