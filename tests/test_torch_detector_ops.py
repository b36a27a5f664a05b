"""Detector training's pieces in the port against the JAX package, on the
CPU: the train-time box math and batched prior matching, the MultiBox
loss and its gradients, AdamW with optax's cosine decay, the synthetic
scenes, the export of a fitted net, the train-mode stage 1 (no K6) and
the kernel fold cache under training's in-place writes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from vn_celeb_face_recognition_tpu.models.retinaface import (
    RetinaFaceNet as JNet,
)
from vn_celeb_face_recognition_tpu.models.torch_convert import (
    convert_state_dict,
    flax_to_torch_state_dict,
)
from vn_celeb_face_recognition_tpu.ops import boxes as JB
from vn_celeb_face_recognition_tpu.training import detector as JD
from vn_celeb_face_recognition_tpu.training.multibox_loss import (
    multibox_loss as j_multibox_loss,
)
from vn_celeb_face_recognition_tpu_torch.models import retinaface as TR
from vn_celeb_face_recognition_tpu_torch.models.convert import (
    export_state_dict,
)
from vn_celeb_face_recognition_tpu_torch.models.layers import load_npz
from vn_celeb_face_recognition_tpu_torch.ops import boxes as TB
from vn_celeb_face_recognition_tpu_torch.training import detector as TD
from vn_celeb_face_recognition_tpu_torch.training.multibox_loss import (
    mined_negatives,
    multibox_loss,
)
from vn_celeb_face_recognition_tpu_torch.training.optim import (
    make_adamw_cosine,
)
from vn_celeb_face_recognition_tpu_torch.utils import kernels
from vn_celeb_face_recognition_tpu_torch.utils.frames import (
    face_files,
    read_png,
)

VAR = (0.1, 0.2)
CFG = TR.cfg_mnet


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _priors(size=64):
    return TB.make_priors((size, size), CFG["min_sizes"], CFG["steps"])


def _boxes(gen, n, lo=0.1, hi=0.4):
    c = gen.uniform(0.2, 0.8, (n, 2))
    s = gen.uniform(lo, hi, (n, 2))
    return np.concatenate([c - s / 2, c + s / 2], axis=1).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads while this module runs, whatever the machine:
    the suite runs several test processes at once, and torch's default of
    one thread per core in each of them oversubscribes the CPU; and the
    f32 sums of a train-mode forward (batch statistics over every
    position) round by the thread count, which the tolerances here were
    measured at. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1])
def test_box_math_matches_jax(seed):
    gen = np.random.default_rng(seed)
    pri = _priors(128)[gen.integers(0, 672, 40)]
    a, b = _boxes(gen, 7), _boxes(gen, 40, 0.02, 0.5)
    lms = gen.uniform(0.1, 0.9, (40, 10)).astype(np.float32)
    pairs = [
        (TB.jaccard(_t(a), _t(b)), JB.jaccard(jnp.asarray(a), jnp.asarray(b))),
        (TB.point_form(_t(pri)), JB.point_form(jnp.asarray(pri))),
        (TB.encode_boxes(_t(b), _t(pri), VAR),
         JB.encode_boxes(jnp.asarray(b), jnp.asarray(pri), VAR)),
        (TB.encode_landmarks(_t(lms), _t(pri), VAR),
         JB.encode_landmarks(jnp.asarray(lms), jnp.asarray(pri), VAR)),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # decode inverts encode
    np.testing.assert_allclose(
        TB.decode_boxes(TB.encode_boxes(_t(b), _t(pri), VAR), _t(pri),
                        VAR).numpy(), b, rtol=1e-5, atol=1e-6)


def _gt_case(case, gen, g=4):
    """[3, g] padded GT sets exercising one matching rule each."""
    b = 3
    truths = np.zeros((b, g, 4), np.float32)
    labels = np.ones((b, g), np.int32)
    landms = gen.uniform(0.1, 0.9, (b, g, 10)).astype(np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        n = 1 + (i + 1) % g
        truths[i, :n] = _boxes(gen, n)
        valid[i, :n] = True
        # padded rows hold arbitrary numbers
        truths[i, n:] = gen.uniform(-5, 5, (g - n, 4))
    if case == "dropped":
        # a box far smaller than any prior: best IoU <= 0.2, not forced
        truths[0, 1] = (0.5, 0.5, 0.502, 0.502)
        valid[0, 1] = True
    elif case == "shared":
        # two GT with one best prior: the higher index claims it
        truths[1, 1] = truths[1, 0]
        truths[1, 2] = truths[1, 0] + np.float32(1e-3)
        valid[1, :3] = True
    elif case == "ignore":
        labels[:, 0] = -1
    return truths, labels, landms, valid


@pytest.mark.parametrize("case", ["random", "dropped", "shared", "ignore"])
def test_match_priors_batched_matches_jax_vmap(case):
    gen = np.random.default_rng(["random", "dropped", "shared",
                                 "ignore"].index(case))
    truths, labels, landms, valid = _gt_case(case, gen)
    pri = _priors(64)
    got = TB.match_priors(_t(truths), _t(labels), _t(landms), _t(pri), VAR,
                          0.35, _t(valid))
    want = jax.vmap(lambda t, lab, lm, v: JB.match_priors(
        t, lab, lm, jnp.asarray(pri), VAR, 0.35, v))(
        jnp.asarray(truths), jnp.asarray(labels), jnp.asarray(landms),
        jnp.asarray(valid))
    loc, conf, landm = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[1].numpy(), conf)
    np.testing.assert_allclose(got[0].numpy(), loc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), landm, rtol=1e-5, atol=1e-5)
    assert (conf != 0).any()
    if case == "ignore":
        assert (conf == -1).any()
    if case == "dropped":
        # the dropped GT's best prior is not forced to it
        bt = JB.jaccard(jnp.asarray(truths[0]),
                        JB.point_form(jnp.asarray(pri)))
        assert float(np.asarray(bt)[1].max()) <= 0.2
    if case == "shared":
        # GT 0-2 share one best prior, which GT 2 (the highest) claims;
        # each prior's own best GT would be GT 0 (ties to the lower index)
        pf = TB.point_form(_t(pri))
        best = torch.argmax(TB.jaccard(_t(truths[1, :3]), pf), dim=1)
        assert len(set(best.tolist())) == 1
        p = int(best[0])
        enc = TB.encode_boxes(_t(truths[1, 2]), _t(pri[p]), VAR)
        np.testing.assert_allclose(got[0][1, p].numpy(), enc.numpy(),
                                   rtol=1e-6)


def _loss_inputs(seed, tied):
    gen = np.random.default_rng(seed)
    b, p = 2, 96
    loc = gen.normal(size=(b, p, 4)).astype(np.float32)
    landm = gen.normal(size=(b, p, 10)).astype(np.float32)
    conf = gen.normal(size=(b, p, 2)).astype(np.float32)
    loc_t = gen.normal(size=(b, p, 4)).astype(np.float32) * 2
    landm_t = gen.normal(size=(b, p, 10)).astype(np.float32) * 2
    conf_t = np.zeros((b, p), np.int32)
    conf_t[0, gen.choice(p, 5, replace=False)] = 1
    conf_t[1, gen.choice(p, 3, replace=False)] = -1
    conf_t[1, 7] = 1
    if tied:
        # flat-gray scenes: most negatives share one logit pair, so the
        # mining boundary (7 a positive) falls inside a run of ties
        conf[:, 10:] = (0.3, -0.2)
    return (loc, conf, landm), (loc_t, conf_t, landm_t)


@pytest.mark.parametrize("seed,tied", [(0, False), (1, True), (2, True)])
def test_multibox_loss_and_gradients_match_jax(seed, tied):
    preds, targets = _loss_inputs(seed, tied)
    jt = tuple(jnp.asarray(t) for t in targets)

    def jloss(p):
        return j_multibox_loss(p, jt)["loss"]

    want = j_multibox_loss(tuple(jnp.asarray(x) for x in preds), jt)
    want_grads = jax.grad(jloss)(tuple(jnp.asarray(x) for x in preds))
    tp = [_t(x).requires_grad_(True) for x in preds]
    got = multibox_loss(tuple(tp), tuple(_t(t) for t in targets))
    for k in ("loss", "loss_loc", "loss_conf", "loss_landm"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)
    got["loss"].backward()
    for t, w in zip(tp, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_mined_negatives_take_ties_by_lower_index():
    ce = torch.tensor([[0.5, 1.0, 1.0, 1.0, 1.0, 0.1, 2.0, 1.0]])
    pos = torch.zeros(1, 8, dtype=torch.bool)
    pos[0, 6] = True  # the largest loss is a positive: not a negative
    # 1 positive x 2.9 -> 2 negatives (truncated), from the run of 1.0s
    got = mined_negatives(ce, pos, 2.9)
    assert got.tolist() == [[False, True, True, False, False, False, False,
                             False]]
    # capped at P - 1, and never a positive
    got = mined_negatives(ce, pos, 100.0)
    assert int(got.sum()) == 7 and not bool((got & pos).any())


def test_adamw_cosine_matches_optax():
    gen = np.random.default_rng(3)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params0 = [gen.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[gen.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    lr, steps = 1e-2, 4  # the schedule reaches its floor inside the run
    tx = optax.adamw(optax.cosine_decay_schedule(lr, steps, 0.01),
                     weight_decay=5e-4)
    jp = [jnp.asarray(p) for p in params0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(_t(p.copy())) for p in params0]
    opt, sched = make_adamw_cosine(tp, lr, steps)
    lrs = []
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        lrs.append(opt.param_groups[0]["lr"])
        for p, x in zip(tp, g):
            p.grad = _t(x)
        opt.step()
        sched.step()
        for p, w in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-6)
    sched_fn = optax.cosine_decay_schedule(lr, steps, 0.01)
    np.testing.assert_allclose(lrs, [float(sched_fn(t)) for t in range(5)],
                               rtol=1e-6)


@pytest.fixture(scope="module")
def crops():
    from PIL import Image

    files = face_files()
    pil = [np.asarray(Image.open(f).convert("RGB"), np.uint8) for f in files]
    port = [read_png(f) for f in files]
    for a, b in zip(pil, port):
        np.testing.assert_array_equal(a, b)
    with np.load("meta_data/crop_landmarks.npz") as z:
        lms = z["landmarks"]
    return port, lms


@pytest.mark.parametrize("seed,size,max_faces",
                         [(0, 256, 3), (1, 256, 6), (0, 640, 6),
                          (1, 640, 3)])
def test_synth_batch_bit_equal_to_jax(crops, seed, size, max_faces):
    imgs, lms = crops
    want = JD.synth_batch(np.random.default_rng(seed), 3, size, imgs, lms,
                          max_faces=max_faces)
    got = TD.synth_batch(np.random.default_rng(seed), 3, size, imgs, lms,
                         max_faces=max_faces)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(TD.template_landmarks(127),
                                  JD.template_landmarks(127))


def test_cached_fold_refolds_after_adamw_and_bn_update():
    """K6's fold cache keys on tensor versions: a train-mode forward
    (running statistics) and a foreach AdamW step must each re-fold; the
    evaluations drop folds anyway, for a fused step, which leaves the
    versions as they were."""
    net = TR.RetinaFaceNet(phase="train").train()
    stage1 = net.body.stage1
    calls = []

    def fold():
        calls.append(1)
        return len(calls)

    def cached():
        return kernels.cached_fold(stage1, "test", fold)

    frames = _t(np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3),
                                                  dtype=np.uint8))
    assert cached() == 1 and cached() == 1
    loc, conf, landm = net(frames)  # batch statistics update
    assert cached() == 2 and cached() == 2
    (loc.square().mean() + conf.square().mean()).backward()
    opt, _ = make_adamw_cosine(net.parameters(), 1e-3, 10)
    opt.step()
    assert cached() == 3 and cached() == 3
    fused = torch.optim.AdamW(net.parameters(), lr=1e-3, fused=True)
    fused.step()
    with TD.evaluating(net):
        assert not net.training and net.phase == "test"
        assert cached() == 4
    assert net.training and net.phase == "train"


def test_export_key_set_and_round_trip(tmp_path):
    jnet = JNet(backbone=CFG["name"], out_channel=CFG["out_channel"],
                phase="train")
    shapes = jax.eval_shape(lambda k, x: jnet.init(k, x, train=False),
                            jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)))
    want_keys = set(flax_to_torch_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)))
    net = TR.RetinaFaceNet(phase="train")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for v in net.state_dict().values():
            if v.is_floating_point():
                v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
    sd = export_state_dict(net)
    assert set(sd) == want_keys and len(sd) == 253
    assert all(v.dtype == np.float32 for v in sd.values())
    path = tmp_path / "fit.npz"
    np.savez_compressed(path, **sd)
    back = export_state_dict(load_npz(TR.RetinaFaceNet(), str(path)))
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # and through the JAX package's reader and writer
    again = flax_to_torch_state_dict(convert_state_dict(dict(sd)))
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(again[k]), v, err_msg=k)


def test_train_mode_stage1_never_reaches_k6(monkeypatch):
    def k6(*args, **kwargs):
        raise AssertionError("K6 reached")

    monkeypatch.setattr(TR, "mnet_stage1", k6)
    net = TR.RetinaFaceNet(phase="train").train()
    frames = torch.zeros((2, 32, 32, 3), dtype=torch.uint8)
    loc, conf, landm = net(frames)
    assert conf.requires_grad and loc.shape == (2, 42, 4)
    with pytest.raises(AssertionError, match="K6 reached"):
        with TD.evaluating(net):
            net(frames)
    assert net.training


def test_raw_logits_in_train_phase_softmax_in_test():
    net = TR.RetinaFaceNet(phase="train").eval()
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (1, 32, 32, 3), dtype=np.uint8))
    with torch.no_grad():
        raw = net(frames)[1]
        net.phase = "test"
        soft = net(frames)[1]
    torch.testing.assert_close(soft, torch.softmax(raw, -1))
    assert TR.RetinaFace(phase="train", device="cpu").net.phase == "train"
