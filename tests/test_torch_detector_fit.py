"""Detector training in the port against the JAX package, on the CPU: the
train-phase net (raw logits, batch statistics), one SSD train step, the
evaluations (K6's and K3's plain versions here), the export read by the
JAX detector, the MTCNN landmark probe and the ``fit_detector`` CLI."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from vn_celeb_face_recognition_tpu.models import retinaface as JR
from vn_celeb_face_recognition_tpu.models.torch_convert import (
    convert_state_dict,
    flax_to_torch_state_dict,
)
from vn_celeb_face_recognition_tpu.ops import boxes as JB
from vn_celeb_face_recognition_tpu.training import detector as JD
from vn_celeb_face_recognition_tpu_torch.cli import fit_detector as FD
from vn_celeb_face_recognition_tpu_torch.models import retinaface as TR
from vn_celeb_face_recognition_tpu_torch.models.convert import (
    export_state_dict,
)
from vn_celeb_face_recognition_tpu_torch.models.layers import load_npz
from vn_celeb_face_recognition_tpu_torch.training import detector as TD

SUB = np.array((104.0, 117.0, 123.0), np.float32)
CFG = TR.cfg_mnet
VAR = tuple(CFG["variance"])
CACHE = os.path.join(FD.ROOT, "meta_data", "crop_landmarks.npz")


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


@pytest.fixture(scope="module")
def crops():
    imgs = FD.load_crops()
    with np.load(CACHE) as z:
        return imgs, z["landmarks"]


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The fitted weights as JAX variables, carried over to the port
    through flax_to_torch_state_dict and an npz (non-trivial running
    statistics)."""
    with np.load(TR.WEIGHTS_NPZ) as z:
        jvars = convert_state_dict({k: z[k] for k in z.files})
    path = tmp_path_factory.mktemp("carried") / "w.npz"
    np.savez(path, **flax_to_torch_state_dict(jvars))
    return jvars, str(path)


def jax_train_net():
    return JR.RetinaFaceNet(backbone=CFG["name"],
                            out_channel=CFG["out_channel"], phase="train")


def port_train_net(path):
    return load_npz(TR.RetinaFaceNet(phase="train"), path).train()


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def assert_vars_close(net, jvars, what, atol, rtol=0.0):
    got = convert_state_dict(export_state_dict(net))
    want = dict(leaves(jvars[what]))
    for k, v in leaves(got[what]):
        np.testing.assert_allclose(v, want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("shape", [(2, 128, 128), (1, 96, 128)])
def test_train_phase_net_matches_flax(carried, shape):
    jvars, path = carried
    frames = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    (jl, jc, jm), mutated = jax.jit(lambda v, x: jax_train_net().apply(
        v, x.astype(jnp.float32) - SUB, train=True,
        mutable=["batch_stats"]))(jvars, jnp.asarray(frames))
    net = port_train_net(path)
    loc, conf, landm = net(torch.from_numpy(frames))
    for got, want in ((loc, jl), (conf, jc), (landm, jm)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    # raw logits, not probabilities
    assert float(conf.detach().abs().max()) > 1.0
    # within 1e-5 absolute and relative: stage 1's variances reach ~7e3,
    # where one f32 ulp is 5e-4
    assert_vars_close(net, {"batch_stats": mutated["batch_stats"]},
                      "batch_stats", 1e-5, 1e-5)


def train_step_pair(carried, crops, size, batch, lr=1e-5, seed=3):
    """One SGD step of each package from the same weights on the same
    synthetic batch: (port losses, port net, JAX losses, JAX variables).

    The rate keeps the weights' tolerance above rounding. Both packages'
    f32 gradients of stage 1 (raw pixels in, batch statistics over every
    position) carry rounding of up to ~0.5 absolute here, more with fewer
    CPU threads (longer serial sums); a LeakyReLU input within that
    rounding of 0 also takes opposite slopes in the two (at seed 3 one
    element of stage2.3's depthwise BatchNorm output is -2.9e-6, moving
    its channel's bias gradient by 4%). At lr 1e-5 that is at most ~5e-6
    in the weights; ``check_step`` also holds the whole step in relative
    L2."""
    jvars, path = carried
    imgs, lms = crops
    frames, boxes, labels, landms, valid = TD.synth_batch(
        np.random.default_rng(seed), batch, size, imgs, lms, max_faces=3)
    priors = JB.make_priors((size, size), CFG["min_sizes"], CFG["steps"])
    tx = optax.sgd(lr)
    jstep = JD.make_detection_train_step(jax_train_net(), priors, VAR, tx)
    params, stats, _, jlosses = jstep(
        jvars["params"], jvars["batch_stats"], tx.init(jvars["params"]),
        *(jnp.asarray(x) for x in (frames, boxes, labels, landms, valid)))
    net = port_train_net(path)
    step = TD.make_detection_train_step(
        net, torch.from_numpy(priors), VAR,
        torch.optim.SGD(net.parameters(), lr=lr))
    losses = step(*(torch.from_numpy(x) for x in (frames, boxes, labels,
                                                  landms, valid)))
    return losses, net, jlosses, {"params": params, "batch_stats": stats}


def check_step(losses, net, jlosses, jvars, start, loss_rtol, params_tol,
               stats_tol, stats_rtol, step_rtol):
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(losses[k]), float(v),
                                   rtol=loss_rtol, err_msg=k)
    assert float(losses["loss_conf"]) > 0 and float(losses["loss_loc"]) > 0
    assert_vars_close(net, jvars, "params", params_tol)
    assert_vars_close(net, jvars, "batch_stats", stats_tol, stats_rtol)
    # the whole step (both packages' updates), relative L2
    got = dict(leaves(convert_state_dict(export_state_dict(net))["params"]))
    want = dict(leaves(jvars["params"]))
    before = dict(leaves(start["params"]))
    num = den = 0.0
    for k, w in want.items():
        step = w.astype(np.float64) - before[k]
        num += float(((got[k] - w).astype(np.float64) ** 2).sum())
        den += float((step ** 2).sum())
    assert (num / den) ** 0.5 <= step_rtol, (num / den) ** 0.5


def test_train_step_matches_jax_sgd(carried, crops):
    losses, net, jlosses, jvars = train_step_pair(carried, crops, 128, 2)
    assert all(not v.requires_grad for v in losses.values())
    # statistics: 1e-5 absolute and 2e-5 relative. On these scenes stage
    # 1's running means reach 26, and the port's CPU f32 statistics with
    # one or two torch threads lie up to 1.4e-5 relative from an f64
    # forward (with eight, and the JAX package's, within 2e-6)
    check_step(losses, net, jlosses, jvars, carried[0], 1e-5, 1e-5, 1e-5,
               2e-5, 3e-2)
    # the step moved the weights and the statistics
    with np.load(carried[1]) as z:
        moved = {k: float(np.abs(export_state_dict(net)[k] - z[k]).max())
                 for k in z.files}
    assert moved["body.stage1.0.0.weight"] > 0
    assert moved["body.stage1.0.1.running_mean"] > 0


@pytest.mark.slow
def test_train_step_matches_jax_sgd_full_width(carried, crops):
    """The tool's own frame size, a batch of 2 at 640 px. Stage 1's
    batch statistics reduce 204,800 values a channel, and the packages'
    f32 reductions differ there by up to 3e-4 relative (6.8e-4 in a
    running mean near 2), the losses by up to 4e-4 (loss_loc); the
    whole step by 12% relative L2 (CPU f32 gradients at this size lie
    3-11% from f64, tools/torch_fit_precision.py)."""
    losses, net, jlosses, jvars = train_step_pair(carried, crops, 640, 2)
    check_step(losses, net, jlosses, jvars, carried[0], 1e-3, 1e-4, 1e-3,
               1e-3, 0.25)


def test_eval_fns_match_jax(crops):
    """conf_sparsity and detection_recall on the fitted weights, held by a
    train-phase net in train mode (the evaluations switch it to eval mode
    and back), against the JAX functions on synthetic and bench frames of
    256 px."""
    imgs, lms = crops
    size = 256
    jrf = JR.RetinaFace(backbone_cfg="cfg_mnet", weights_path=TR.WEIGHTS_NPZ)
    conf_fn, detect_fn = JD.make_eval_fns(jrf, 4, size)
    rf = TR.RetinaFace(backbone_cfg="cfg_mnet", weights_path=TR.WEIGHTS_NPZ,
                       device="cpu")
    rf.net = load_npz(TR.RetinaFaceNet(phase="train"), TR.WEIGHTS_NPZ).train()
    frames, boxes, _, _, valid = TD.synth_batch(
        np.random.default_rng(FD.EVAL_SEED), 4, size, imgs, lms, max_faces=6)
    bframes, bboxes, bvalid = FD.bench_boxes(4, size)
    for fr, bx, va in ((frames, boxes * size, valid),
                       (bframes, bboxes, bvalid)):
        want_s = JD.conf_sparsity(jrf, fr, conf_fn=conf_fn)
        want_r = JD.detection_recall(jrf, fr, bx, va, detect_fn=detect_fn)
        got_s = TD.conf_sparsity(rf, fr)
        got_r = TD.detection_recall(rf, fr, bx, va)
        assert got_r == want_r
        assert abs(got_s - want_s) <= 1.0, (got_s, want_s)
    assert rf.net.training and rf.net.phase == "train"
    assert want_r > 0  # the fitted net finds the bench faces


def test_export_loads_in_both_detectors(carried, tmp_path):
    """A train-phase port net with every weight and statistic moved off
    the fitted ones, exported: the JAX RetinaFace and the port's load it
    and give the same head outputs (eval mode)."""
    net = port_train_net(carried[1])
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for v in net.state_dict().values():
            if v.is_floating_point():
                v.mul_(torch.rand(v.shape, generator=gen) * 0.2 + 0.9)
    path = str(tmp_path / "fit.npz")
    np.savez_compressed(path, **export_state_dict(net))
    frames = np.random.default_rng(9).integers(0, 256, (2, 64, 96, 3),
                                               dtype=np.uint8)
    jrf = JR.RetinaFace(backbone_cfg="cfg_mnet", weights_path=path)
    want = jax.jit(lambda v, x: jrf.net.apply(v, x - SUB, train=False))(
        jrf.variables, jnp.asarray(frames, jnp.float32))
    rf = TR.RetinaFace(backbone_cfg="cfg_mnet", weights_path=path,
                       device="cpu")
    with TD.evaluating(net), torch.no_grad():
        trained = net(torch.from_numpy(frames))
        got = rf.net(torch.from_numpy(frames))
    for g, t, w in zip(got, trained, want):
        torch.testing.assert_close(g, t, rtol=0, atol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_probe_crop_landmarks_matches_cache(crops):
    """Five of the 20 crops, both sizes among them (127 and 181 px);
    chip_smoke.py's phase 29 probes all 20, on the card and the CPU."""
    imgs, cached = crops
    pick = [0, 5, 9, 13, 17]
    got = TD.probe_crop_landmarks([imgs[i] for i in pick], device="cpu")
    assert got.shape == (len(pick), 5, 2)
    assert {imgs[i].shape[0] for i in pick} == {127, 181}
    np.testing.assert_allclose(got, cached[pick], atol=0.5)
    # no crop fell back to the template, here or in the cache
    for pts, i in zip(got, pick):
        assert not np.allclose(pts, TD.template_landmarks(imgs[i].shape[0]))


def test_fit_detector_cli_on_cpu(crops, tmp_path, monkeypatch):
    """Two steps at 128 px with an evaluation after each; a missing
    landmark cache is probed (here: the vendored points) and written."""
    cache = tmp_path / "lms.npz"
    monkeypatch.setattr(FD, "probe_crop_landmarks",
                        lambda c, device: crops[1].copy())
    out = tmp_path / "fit" / "rf.npz"
    res = FD.main(["-dv", "cpu", "--steps", "2", "--size", "128", "--batch",
                   "2", "--eval_every", "1", "--landmarks_cache", str(cache),
                   "--out", str(out)])
    with np.load(cache) as z:
        np.testing.assert_array_equal(z["landmarks"], crops[1])
    assert [s for s, _ in res["evals"]] == [1, 2]
    assert all(np.isfinite(v).all() and v.shape == (2,)
               for v in res["losses"].values())
    with np.load(out) as z:
        assert len(z.files) == 253
        assert all(np.isfinite(z[k]).all() for k in z.files)
    meta = json.load(open(str(out) + ".json"))
    assert meta["steps"] == 2 and meta["size"] == 128
    assert meta["synth_recall_iou50"] == res["evals"][-1][1][1]
    # the written weights are the trained net's
    sd = export_state_dict(res["fit"].net)
    with np.load(out) as z:
        for k in z.files:
            np.testing.assert_array_equal(z[k], sd[k])


def test_fit_detector_defaults():
    args = FD.build_arg_parser().parse_args([])
    assert args.out == os.path.join("saved", "retinaface_mnet025_fit.npz")
    jax_pkg = os.path.join(FD.ROOT, "vn_celeb_face_recognition_tpu")
    assert not os.path.abspath(args.out).startswith(jax_pkg + os.sep)
    assert (args.steps, args.batch, args.size, args.max_faces, args.lr,
            args.device) == (1500, 8, 640, 6, 1e-3, "cuda")
    assert args.landmarks_cache == CACHE
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FD.main(["--steps", "1"])
