"""The port's ``parallel/`` (the process-group mesh, the DP x TP step, the
launcher, GlobalBatchNorm) and the trainers on a mesh, against the JAX
package's mesh on the 8 virtual CPU devices of tests/conftest.py.

The port runs in gloo processes that ``parallel.launch`` starts, one
launch a world size in module fixtures (each with a 120 s limit and one
torch thread a process); the functions they run are in
tests/torch_parallel_workers.py, which imports no JAX. The same seeded
numpy inputs and the same weights go through both packages, and through
the port's one-process path. Dropout is 0 wherever JAX is compared (the
packages' generators differ); the port's mesh runs are held to its one-
process runs with dropout on. Each test states its tolerance.
"""

import copy
import csv
import functools
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import train as j_train
import torch_parallel_workers as W
from torch_shared import once_a_run
from vn_celeb_face_recognition_tpu import data as JD
from vn_celeb_face_recognition_tpu.models.mlp import MLPModel as JMLP
from vn_celeb_face_recognition_tpu.parallel import data_sharding as j_sharding
from vn_celeb_face_recognition_tpu.parallel import make_dp_train_step as j_step
from vn_celeb_face_recognition_tpu.parallel import make_mesh as j_mesh
from vn_celeb_face_recognition_tpu.training.checkpoint import (
    load_checkpoint as j_load_checkpoint,
)
from vn_celeb_face_recognition_tpu.training.checkpoint import (
    restore_variables as j_restore,
)
from vn_celeb_face_recognition_tpu.training.optim import (
    make_optimizer as j_optimizer,
)
from vn_celeb_face_recognition_tpu.training.trainer import (
    AugClassificationTrainer as JAug,
)
from vn_celeb_face_recognition_tpu_torch import data as PD
from vn_celeb_face_recognition_tpu_torch.cli import eval as p_eval
from vn_celeb_face_recognition_tpu_torch.cli import train as p_train
from vn_celeb_face_recognition_tpu_torch.models.convert import (
    export_state_dict,
    load_state_dict_blocks,
    state_dict_from_jax,
    state_dict_to_jax,
)
from vn_celeb_face_recognition_tpu_torch.models.layers import (
    batch_norm,
    dropout,
)
from vn_celeb_face_recognition_tpu_torch.models.mlp import MLPModel
from vn_celeb_face_recognition_tpu_torch.parallel import (
    LaunchError,
    Mesh,
    launch,
    make_mesh,
    shard_mlp,
)
from vn_celeb_face_recognition_tpu_torch.parallel.launch import (
    resolve_devices,
)
from vn_celeb_face_recognition_tpu_torch.parallel.mesh import mlp_blocks
from vn_celeb_face_recognition_tpu_torch.pipeline import Classifier
from vn_celeb_face_recognition_tpu_torch.utils.frames import (
    face_files,
    read_png,
    resize_bilinear,
    write_png,
)

from test_torch_parallel_engine import TinyEnc, port_enc_state
from test_train_slice import make_config

LAUNCH = dict(timeout=120, threads=1)
DIM, CLASSES, N = 64, 8, 16
# 11 real rows, then the loader's zero-weight padding: at n_data 2 the
# blocks carry 8 and 3 real rows
WEIGHT = np.r_[np.ones(11), np.zeros(5)].astype(np.float32)
SHAPES = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def numpy_sd(variables):
    return {k: v.numpy() for k, v in
            state_dict_from_jax(np_tree(variables)).items()}


@pytest.fixture(scope="module")
def inputs():
    gen = np.random.default_rng(0)
    batch = {"data": gen.normal(size=(N, DIM)).astype(np.float32),
             "target": gen.integers(0, CLASSES, N).astype(np.int64),
             "weight": WEIGHT}
    variables = JMLP(DIM, CLASSES, dropout_prob=0.0).init(
        jax.random.PRNGKey(0), jnp.zeros((1, DIM)))
    x = gen.normal(size=(16, 4, 5, 5)).astype(np.float32) * 2.0 + 0.5
    x[8:] *= 3.0  # the blocks' statistics differ from the global ones
    bn = (x, gen.normal(size=x.shape).astype(np.float32),
          gen.normal(size=4).astype(np.float32),
          gen.normal(size=4).astype(np.float32))
    tp_x = gen.normal(size=(N, DIM)).astype(np.float32)
    return batch, variables, bn, tp_x


@pytest.mark.parametrize("shape", SHAPES)
def test_rank_layout_and_blocks_match_jax(inputs, runs, shape):
    """rank = d * n_model + m, and each rank's shard_batch block equals the
    addressable shard of jax.device_put(x, data_sharding(mesh, x.ndim)) on
    the device at (d, m) of JAX's mesh (exactly)."""
    batch = inputs[0]
    layout = runs["port"][shape]["layout"]
    mesh = j_mesh(*shape)
    devices = mesh.devices
    for key, x in batch.items():
        placed = jax.device_put(x, j_sharding(mesh, x.ndim))
        shards = placed.addressable_shards
        assert len(shards) == shape[0] * shape[1]
        for shard in shards:
            d, m = (int(i[0]) for i in np.nonzero(devices == shard.device))
            got = layout[d * shape[1] + m]
            assert got["rank"] == d * shape[1] + m
            assert tuple(got["coords"]) == (d, m)
            np.testing.assert_array_equal(got["blocks"][key],
                                          np.asarray(shard.data))


def jax_mesh_steps(shape, batch, variables, steps=3):
    mesh = j_mesh(*shape)
    tx = j_optimizer("Adam", {"lr": 1e-3, "weight_decay": 1e-4})
    step, place_state, place_batch = j_step(
        mesh, JMLP(DIM, CLASSES, dropout_prob=0.0), tx, donate=False)
    v, o = place_state(variables, tx.init(variables["params"]))
    b = place_batch(dict(batch, target=batch["target"].astype(np.int32)))
    losses = []
    with mesh:
        for _ in range(steps):
            v, o, loss, _ = step(v, o, b, jax.random.PRNGKey(3))
            losses.append(float(loss))
    return losses, numpy_sd(v)


@pytest.mark.parametrize("shape", SHAPES)
def test_dp_tp_step_matches_jax_and_one_process(inputs, runs, shape):
    """Three make_dp_train_step steps (MLP 64-2048-8, Adam with L2, dropout
    0) from the same weights on a batch whose zero-weight tail falls
    unevenly over the data blocks: losses within rtol 1e-4 of JAX's mesh
    step and of the port's one-process step, weights within 1e-4. Averaging
    the blocks' own mean losses instead gives another loss."""
    batch, variables = inputs[:2]
    got = runs["port"][shape]["steps"]
    want_losses, want_state = runs["jax_steps"][shape]
    one = runs["one_steps"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-4)
    for k, v in want_state.items():
        np.testing.assert_allclose(got["state"][k], v, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(got["state"][k], one["state"][k],
                                   atol=1e-4, err_msg=k)
    if shape[0] > 1:
        # the per-rank variant, the mean of the blocks' own weighted means,
        # is off the first step's loss by far more than the tolerance
        with torch.no_grad():
            logp = W.mlp_from(numpy_sd(variables)).eval()(
                torch.from_numpy(batch["data"]))
        w = torch.from_numpy(WEIGHT)
        t = torch.from_numpy(batch["target"])
        nll = -logp.gather(1, t[:, None])[:, 0] * w
        blocks = [nll[i:i + 8].sum() / w[i:i + 8].sum() for i in (0, 8)]
        per_rank = float(sum(blocks) / 2)
        assert abs(per_rank - want_losses[0]) > 1e-2 * want_losses[0]


def test_tp_dropout_rate_scale_and_global_mask(inputs, runs):
    """At (1, 2), p = 0.5: each model rank's dropout block holds 0 or 2
    (the 1 / (1 - p) scale) at a rate within 0.47-0.53, the blocks side by
    side are the one-process [16, 2048] mask exactly, and the sharded MLP's
    train-mode output equals the one-process MLP's (the same generator) to
    1e-5."""
    batch, variables, _, tp_x = inputs
    tp = runs["port"][(1, 2)]["tp"]
    masks = [r["mask"] for r in tp]
    for mask in masks:
        assert set(np.unique(mask)) <= {0.0, 2.0}
        assert 0.47 <= float((mask == 0).mean()) <= 0.53
    want = dropout(torch.ones(N, 2048), 0.5, torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(np.concatenate(masks, 1), want.numpy())
    mlp = W.mlp_from(numpy_sd(variables), dropout_prob=0.5).train()
    out = mlp(torch.from_numpy(tp_x), generator=torch.Generator().manual_seed(9))
    for r in tp:
        np.testing.assert_allclose(r["out"], out.detach().numpy(), atol=1e-5)


def test_global_batchnorm_matches_one_batchnorm(inputs, runs):
    """GlobalBatchNorm over 2 data ranks against one BatchNorm (flax's
    train-mode semantics, layers.batch_norm) on the global batch: output,
    input gradient, weight and bias gradients and the running statistics
    within 1e-5. The blocks' own statistics give outputs off by far more."""
    x, up, weight, bias = inputs[2]
    bn = torch.nn.BatchNorm2d(4, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = batch_norm(bn, xt)
    (out * torch.from_numpy(up)).sum().backward()
    for shape in ((2, 1), (2, 2)):
        ranks = runs["port"][shape]["bn"]
        d_ranks = [ranks[d * shape[1]] for d in range(shape[0])]
        np.testing.assert_allclose(
            np.concatenate([r["out"] for r in d_ranks]),
            out.detach().numpy(), atol=1e-5)
        np.testing.assert_allclose(
            np.concatenate([r["x_grad"] for r in d_ranks]),
            xt.grad.numpy(), atol=1e-5)
        for r in ranks:
            np.testing.assert_allclose(
                r["affine_grad"],
                np.concatenate([bn.weight.grad, bn.bias.grad]), atol=1e-5)
            np.testing.assert_allclose(
                r["running"], np.stack([bn.running_mean.detach().numpy(),
                                        bn.running_var.detach().numpy()]),
                atol=1e-5)
    with torch.no_grad():
        local = batch_norm(torch.nn.BatchNorm2d(4).train(),
                           torch.from_numpy(x[:8]))
        whole = batch_norm(torch.nn.BatchNorm2d(4).train(),
                           torch.from_numpy(x))
    assert float((local - whole[:8]).abs().max()) > 1e-2


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------


def emb_config(data, save_dir, n_devices=1, epochs=1):
    """The toy embedding config, batches of 12 (80 = 6 x 12 + 8 train rows,
    16 = 12 + 4 validation rows: a data block of padding alone), dropout
    0, a learning rate at which the loss falls."""
    cfg = make_config(data, save_dir, epochs=epochs, batch_size=12)
    cfg["model"]["args"]["dropout_prob"] = 0.0
    cfg["optimizer"]["args"]["lr"] = 1e-4
    cfg["trainer"].update(n_devices=n_devices, save_period=epochs)
    return cfg


@pytest.fixture(scope="module")
def face_root(tmp_path_factory):
    """4 classes x 5 of the repo's face PNGs at 112 px (4 train, 1 val)."""
    root = tmp_path_factory.mktemp("faces112")
    (root / "train").mkdir()
    files = face_files()
    train, val = {}, {}
    for c in range(4):
        names = []
        for j in range(5):
            img = resize_bilinear(read_png(files[c * 5 + j]), (112, 112))
            write_png(str(root / "train" / f"{c}_{j}.png"), img)
            names.append(f"{c}_{j}.png")
        train[str(c)], val[str(c)] = names[:-1], names[-1:]
    (root / "train.json").write_text(json.dumps(train))
    (root / "val.json").write_text(json.dumps(val))
    return root


def aug_config(root, save_dir, transform, n_devices):
    ds = {"data_dir": str(root / "train")}
    return {
        "train_dataset": {"args": dict(ds, label_file=str(root /
                                                           "train.json"))},
        "val_dataset": {"args": dict(ds, label_file=str(root / "val.json"))},
        "transforms": {"name": transform, "resize": False,
                       "encoder_img_size": 112},
        "metrics": ["accuracy"], "loss": "neg_log_llhood",
        "trainer": {
            "name": "AugClassificationTrainer", "resume_path": "",
            "save_dir": str(save_dir), "device": "CPU", "log_step": 100,
            "do_validation": True, "validation_step": 1, "epochs": 1,
            "tracked_metric": ["val_neg_log_llhood", "min"], "patience": 10,
            "save_period": 10, "track4plot": False, "n_devices": n_devices,
        },
        "optimizer": {"name": "Adam", "args": {"lr": 1e-3,
                                               "weight_decay": 1e-4}},
    }


@pytest.fixture(scope="module")
def runs(inputs, toy_embedding_dataset, face_root, tmp_path_factory):
    """Everything the tests compare, computed once a run
    (``torch_shared.once_a_run``: numpy and plain Python; the checkpoints
    stay under the computing worker's temporary directory)."""
    return once_a_run(tmp_path_factory, "parallel_runs", lambda: compute_runs(
        inputs, toy_embedding_dataset, face_root, tmp_path_factory))


def compute_runs(inputs, toy_embedding_dataset, face_root, tmp_path_factory):
    """The port's mesh runs are two launches started first, in threads:
    (2, 1), (1, 2) and the trainers at n_devices 2 and at a (1, 2) mesh in
    one launch of 2, (2, 2) in one of 4. Meanwhile JAX's mesh steps and
    trainers at n_devices 2 (its mesh of 2 virtual devices) and the port's
    one-process runs go here, all from the same weights."""
    batch, variables, bn, tp_x = inputs
    tmp = tmp_path_factory.mktemp("trainers")
    jt, _, _ = j_train.build_trainer_from_config(
        emb_config(toy_embedding_dataset, tmp / "jax", 2))
    jt.model = JMLP(512, toy_embedding_dataset["n_classes"],
                    dropout_prob=0.0)
    jt._ensure_ready(next(iter(jt.val_loader)))
    emb_state = numpy_sd(jt.variables)
    enc_vars = TinyEnc().init(jax.random.PRNGKey(21),
                              jnp.zeros((1, 112, 112, 3)))
    enc_state = port_enc_state(enc_vars)
    cfg = aug_config(face_root, tmp / "jax_aug", "default", 2)
    ja = JAug(copy.deepcopy(cfg), JMLP(512, 4, dropout_prob=0.0), seed=123,
              encoder=TinyEnc(), encoder_variables=enc_vars)
    ja.setup_loader(
        JD.DataLoader(JD.VNCelebDataset(**cfg["train_dataset"]["args"]),
                      batch_size=6, shuffle=True, seed=123),
        JD.DataLoader(JD.VNCelebDataset(**cfg["val_dataset"]["args"]),
                      batch_size=6))
    ja._ensure_ready(next(iter(ja.val_loader)))
    aug_state = numpy_sd(ja.variables)
    aug_cfgs = {t: aug_config(face_root, tmp / f"aug_{t}", t, 2)
                for t in ("default", "facenet_aug", "rank1_aug")}
    tp_cfg = emb_config(toy_embedding_dataset, tmp / "tp", 1, epochs=2)
    trainer_args = (emb_config(toy_embedding_dataset, tmp / "port2", 2),
                    aug_cfgs, emb_state, aug_state, enc_state, tp_cfg)
    args = (batch, numpy_sd(variables), bn, tp_x)
    with ThreadPoolExecutor(2) as pool:
        two = pool.submit(launch, W.mesh_checks, 2, "cpu", [(2, 1), (1, 2)],
                          *args, trainer_args, **LAUNCH)
        four = pool.submit(launch, W.mesh_checks, 4, "cpu", [(2, 2)], *args,
                           **LAUNCH)
        jax_steps = {shape: jax_mesh_steps(shape, batch, variables)
                     for shape in SHAPES}
        one_steps = W.dp_steps(None, numpy_sd(variables), batch)
        j_emb = jt._train_epoch(1)
        j_emb = (j_emb, numpy_sd(jt.variables))
        j_aug = ja._train_epoch(1)
        j_aug = (j_aug, numpy_sd(ja.variables))
        port1 = {
            "emb": W.emb_trainer(emb_config(toy_embedding_dataset,
                                            tmp / "port1"), emb_state),
            "aug": {t: W.aug_trainer(
                dict(c, trainer=dict(c["trainer"], n_devices=1)),
                aug_state, enc_state)
                for t, c in aug_cfgs.items()},
            "tp": W.emb_trainer(dict(tp_cfg, trainer=dict(
                tp_cfg["trainer"], save_dir=str(tmp / "tp1"))), emb_state,
                epochs=2),
        }
        port = two.result()
        port.update(four.result())
    return {"port": port, "jax_steps": jax_steps, "one_steps": one_steps,
            "jax": {"emb": j_emb, "aug": j_aug}, "port1": port1,
            "port2": port.pop("trainers"),
            "n_classes": toy_embedding_dataset["n_classes"]}


def assert_log_close(got, want, rtol=1e-4):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-6,
                                   err_msg=k)


def assert_state_close(got, want, atol=1e-3):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)


def test_classification_trainer_n_devices_2(runs):
    """ClassificationTrainer with n_devices 2, one epoch (train and
    validation, the last batches padded unevenly over the blocks): the
    log's losses and accuracies within rtol 1e-4 of JAX's trainer at
    n_devices 2 and of the port's at 1; weights within 1e-3."""
    j_log, j_state = runs["jax"]["emb"]
    got = runs["port2"]["emb"]
    one = runs["port1"]["emb"]
    assert_log_close(got["logs"][0], j_log)
    assert_log_close(got["logs"][0], one["logs"][0])
    assert_state_close(got["state"], j_state)
    assert_state_close(got["state"], one["state"])


def test_aug_trainer_n_devices_2_and_global_augmentation(runs):
    """AugClassificationTrainer (tests/test_engine.py's tiny encoder frozen,
    112 px faces,
    batches of 6: the last one 4 real rows) with n_devices 2, one epoch:
    with the default transform, the log within rtol 1e-4 of JAX's trainer
    at n_devices 2 and of the port's at 1, MLP weights within 1e-3. With
    facenet_aug and rank1_aug every augmented global batch (the ranks'
    blocks gathered) equals the one-process batch exactly: the draws are
    made for the global batch."""
    j_log, j_state = runs["jax"]["aug"]
    got = runs["port2"]["aug"]
    one = runs["port1"]["aug"]
    assert_log_close(got["default"]["log"], j_log)
    assert_log_close(got["default"]["log"], one["default"]["log"])
    assert_state_close(got["default"]["state"], j_state)
    for t in ("facenet_aug", "rank1_aug"):
        assert len(got[t]["augmented"]) == len(one[t]["augmented"]) == 3
        for a, b in zip(got[t]["augmented"], one[t]["augmented"]):
            np.testing.assert_array_equal(a, b)
        assert_log_close(got[t]["log"], one[t]["log"], rtol=1e-5)


def test_tp_trainer_checkpoint_loads_in_port_and_jax(runs):
    """The embedding trainer at a (1, 2) mesh (its MLP sharded over the
    model axis) for two epochs: its logs and weights are the one-process
    run's (rtol 1e-4, 1e-4); the checkpoint rank 0 wrote holds the whole
    MLP, which the JAX package restores and the port's one-process
    Classifier reads, giving the same log-probabilities (1e-5)."""
    got, one = runs["port2"]["tp"], runs["port1"]["tp"]
    for a, b in zip(got["logs"], one["logs"]):
        assert_log_close(a, b)
    assert_state_close(got["state"], one["state"], atol=1e-4)
    path = f"{got['save_dir']}/checkpoint-epoch2.ckpt"
    cp = j_load_checkpoint(path)
    n_classes = runs["n_classes"]
    jmodel = JMLP(512, n_classes)
    template = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 512)))
    x = np.random.default_rng(1).normal(size=(5, 512)).astype(np.float32)
    want = np.asarray(jmodel.apply(j_restore(template, cp["state_dict"]),
                                   jnp.asarray(x)))
    clf = Classifier.build(512, n_classes, checkpoint_path=path,
                           device="cpu")
    np.testing.assert_allclose(clf(x), want, atol=1e-5)
    whole = W.mlp_from(got["state"]).eval()
    with torch.no_grad():
        np.testing.assert_allclose(whole(torch.from_numpy(x)).numpy(), want,
                                   atol=1e-5)


def test_cli_train_and_eval_n_devices_2(toy_embedding_dataset, tmp_path,
                                        monkeypatch):
    """cli.train with trainer.n_devices 2 and -d CPU runs two gloo
    processes (each launch given a 120 s limit here): rank 0 writes
    log_loss.txt and the checkpoints; the losses are the one-process
    run's (rtol 1e-4). cli.eval of the 2-process checkpoint with
    n_devices 2 writes the result.csv of a one-process eval (the
    validation blocks gathered, the padding rows left out)."""
    for cli in (p_train, p_eval):
        monkeypatch.setattr(cli, "launch", functools.partial(launch,
                                                             **LAUNCH))
    rows = {}
    for n in (1, 2):
        cfg = emb_config(toy_embedding_dataset, tmp_path / f"n{n}", n,
                         epochs=2)
        path = tmp_path / f"cfg{n}.json"
        path.write_text(json.dumps(cfg))
        out = p_train.main(["-c", str(path), "-d", "CPU"])
        log_dir = out["log_dir"] if n == 2 else out.log_dir
        save_dir = out["save_dir"] if n == 2 else out.save_dir
        rows[n] = (tmp_path / log_dir / "log_loss.txt").read_text().split()
        assert (tmp_path / save_dir / "checkpoint-epoch2.ckpt").exists()
    assert rows[1][0] == rows[2][0] == "Epoch,Train_loss,Validation_loss"
    assert len(rows[2]) == 3
    for a, b in zip(rows[1][1:], rows[2][1:]):
        np.testing.assert_allclose([float(v) for v in b.split(",")],
                                   [float(v) for v in a.split(",")],
                                   rtol=1e-4)
    results = {}
    for n in (1, 2):
        cfg = emb_config(toy_embedding_dataset, tmp_path / f"eval{n}", n)
        cfg["trainer"].update(resume_path=str(
            tmp_path / save_dir / "checkpoint-epoch2.ckpt"), save_result=True)
        path = tmp_path / f"eval{n}.json"
        path.write_text(json.dumps(cfg))
        out = p_eval.main(["-c", str(path), "-d", "CPU"])
        res_dir = out["save_dir"] if n == 2 else out.save_dir
        with open(tmp_path / res_dir / "result.csv", newline="") as fp:
            results[n] = list(csv.reader(fp))
    assert len(results[2]) == len(results[1]) == 17
    for a, b in zip(results[2], results[1]):
        assert a[:3] == b[:3]
        if a[3] != "Probability":
            assert abs(float(a[3]) - float(b[3])) <= 1e-5


def test_a_raising_rank_fails_the_launch_in_time():
    """Rank 1 raises while rank 0 waits for it in an all-reduce: the launch
    raises LaunchError with rank 1's traceback well inside its limit, and
    no process is left."""
    start = time.monotonic()
    with pytest.raises(LaunchError, match="rank 1 fails on purpose"):
        launch(W.raise_on_rank_1, 2, "cpu", **LAUNCH)
    assert time.monotonic() - start < 60


def test_a_hanging_rank_fails_the_launch_at_its_limit():
    """Rank 1 never joins rank 0's all-reduce: the launch raises LaunchError
    at its 5 s limit (past the processes' start), and stops both."""
    start = time.monotonic()
    with pytest.raises(LaunchError, match="ran past its 5 s limit"):
        launch(W.hang_on_rank_1, 2, "cpu", timeout=5, threads=1)
    assert time.monotonic() - start < 30


@pytest.mark.parametrize("m", [0, 1])
def test_jax_mlp_tree_loads_into_a_sharded_mlp_and_back(inputs, m):
    """models.convert.load_state_dict_blocks with mesh.mlp_blocks: a whole
    JAX MLP tree loads into model rank m's shards of a (1, 2) mesh exactly
    as shard_mlp cuts the whole port MLP (dense_1 rows and bias block m,
    dense_2 columns block m, dense_2's bias whole); the blocks of both
    ranks side by side, through export_state_dict and state_dict_to_jax,
    are the JAX tree again (no process group: the cut needs none)."""
    variables = inputs[1]
    tree = np_tree(variables)
    whole = W.mlp_from(numpy_sd(variables))
    parts = []
    for rank in (0, 1):
        mesh = Mesh(rank, {"data": 1, "model": 2}, (0, rank), None, None,
                    torch.device("cpu"))
        want = shard_mlp(mesh, copy.deepcopy(whole))
        got = load_state_dict_blocks(
            shard_mlp(mesh, MLPModel(DIM, CLASSES)),
            state_dict_from_jax(tree), mlp_blocks(mesh))
        assert got.dense_1.weight.shape == (1024, DIM)
        assert got.dense_2.weight.shape == (CLASSES, 1024)
        for k, v in want.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k
        parts.append(export_state_dict(got))
    back = {"dense_1.weight": np.concatenate(
                [p["dense_1.weight"] for p in parts], 0),
            "dense_1.bias": np.concatenate([p["dense_1.bias"] for p in parts]),
            "dense_2.weight": np.concatenate(
                [p["dense_2.weight"] for p in parts], 1),
            "dense_2.bias": parts[0]["dense_2.bias"]}
    flat = jax.tree_util.tree_leaves_with_path(state_dict_to_jax(back))
    want_flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat) == len(want_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(leaf, want_flat[path])


@pytest.mark.parametrize("count", [2, 3])
def test_loader_blocks_make_up_the_global_batch(toy_embedding_dataset,
                                                count):
    """DataLoader.set_block: the blocks of every process, side by side, are
    the one-process batches (shuffled, the last padded with copies of the
    global batch's first sample, a block of padding alone included)."""
    ds = PD.VNCelebEmbDataset(toy_embedding_dataset["emb_dir"],
                              toy_embedding_dataset["train_json"])
    whole = list(PD.DataLoader(ds, batch_size=12, shuffle=True, seed=5))
    blocks = []
    for i in range(count):
        loader = PD.DataLoader(ds, batch_size=12, shuffle=True, seed=5)
        loader.set_block(i, count)
        blocks.append(list(loader))
    assert whole[-1]["weight"].sum() == 8
    for b, want in enumerate(whole):
        for key in ("data", "target", "weight"):
            got = np.concatenate([blk[b][key] for blk in blocks])
            np.testing.assert_array_equal(got, want[key])
        assert sum((blk[b]["path"] for blk in blocks), []) == want["path"]


def test_no_fallback_and_device_counts():
    """A CUDA launch without a card raises instead of running gloo on the
    CPU; asking for more cards than are visible exits with the JAX CLI's
    message; 0 on the CPU is one process; a mesh needs a launched group."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; the no-card contract is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch(W.raise_on_rank_1, 2, "cuda", **LAUNCH)
    with pytest.raises(SystemExit, match="requested but only 0 device"):
        resolve_devices(2, "cuda")
    assert resolve_devices(0, "cpu") == 1
    with pytest.raises(RuntimeError, match="parallel.launch"):
        make_mesh(2, device="cpu")
