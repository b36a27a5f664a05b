"""Functions that ``parallel.launch`` runs in the gloo processes of
tests/test_torch_parallel.py and tests/test_torch_parallel_engine.py.

A spawned process imports this module to find its function, so it imports
torch and the port only: the JAX oracle stays in the test process. Each
function returns, from rank 0, what every rank computed (gathered with
``all_gather_object``) as numpy.
"""

import copy
import time

import numpy as np
import torch
import torch.distributed as dist

from vn_celeb_face_recognition_tpu_torch import registry
from vn_celeb_face_recognition_tpu_torch.data import DataLoader
from vn_celeb_face_recognition_tpu_torch.models.layers import (
    batch_norm,
    dropout,
)
from vn_celeb_face_recognition_tpu_torch.models.mlp import MLPModel
from vn_celeb_face_recognition_tpu_torch.parallel import (
    GlobalBatchNorm,
    gather_mlp,
    make_dp_train_step,
    make_mesh,
    shard_batch,
)
from vn_celeb_face_recognition_tpu_torch.parallel.collectives import (
    all_gather_rows,
)
from vn_celeb_face_recognition_tpu_torch.training.optim import make_optimizer


def gathered(value):
    """Every rank's ``value``, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def numpy_state(module):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def mlp_from(state, dropout_prob=0.0):
    n_classes = state["dense_2.weight"].shape[0]
    mlp = MLPModel(state["dense_1.weight"].shape[1], n_classes, dropout_prob)
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return mlp


# ---------------------------------------------------------------------------
# the mesh, the step, dropout, BatchNorm
# ---------------------------------------------------------------------------


def mesh_layout(mesh, batch):
    """This rank's coordinates and its shard_batch blocks."""
    placed = shard_batch(mesh, batch)
    return {"rank": mesh.rank, "coords": mesh.coords,
            "blocks": {k: v.numpy() for k, v in placed.items()
                       if isinstance(v, torch.Tensor)}}


def dp_steps(mesh, state, batch, steps=3, lr=1e-3):
    """``steps`` steps of make_dp_train_step (Adam, L2 1e-4, dropout 0) from
    ``state``: the losses and the whole MLP after them."""
    mlp = mlp_from(state)
    opt = make_optimizer("Adam", {"lr": lr, "weight_decay": 1e-4},
                         mlp.parameters())
    step, place_state, place_batch = make_dp_train_step(mesh, mlp, opt)
    place_state(mlp, opt)
    placed = place_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    gen = torch.Generator().manual_seed(1)
    losses, accs = [], []
    for _ in range(steps):
        loss, metrics = step(placed, gen)
        losses.append(float(loss))
        accs.append(float(metrics["accuracy"]))
    if mesh is not None:
        gather_mlp(mesh, mlp, opt)
    return {"losses": losses, "accuracy": accs, "state": numpy_state(mlp)}


def tp_dropout(mesh, x, state, p=0.5):
    """Under a (1, n_model) mesh: this rank's dropout mask block of a
    [B, 2048] layer, and the sharded MLP's train-mode output at ``p``."""
    gen = torch.Generator().manual_seed(7)
    ones = torch.ones(x.shape[0], 2048 // mesh.n_model)
    mask = dropout(ones, p, gen, cols=(mesh.m, mesh.n_model))
    mlp = mlp_from(state, dropout_prob=p)
    opt = make_optimizer("SGD", {"lr": 0.0}, mlp.parameters())
    make_dp_train_step(mesh, mlp, opt)[1](mlp, opt)
    mlp.train()
    out = mlp(torch.from_numpy(x), generator=torch.Generator().manual_seed(9))
    return {"mask": mask.numpy(), "out": out.detach().numpy()}


def global_bn(mesh, x, up, weight, bias):
    """GlobalBatchNorm over the data group on this rank's block of ``x``:
    output, the input's and the affine terms' gradients of sum(out * up)
    and the running statistics after the step."""
    bn = torch.nn.BatchNorm2d(x.shape[1], momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    bn = GlobalBatchNorm.convert(bn, mesh.data_group).train()
    rows = x.shape[0] // mesh.n_data
    blk = slice(mesh.d * rows, (mesh.d + 1) * rows)
    xb = torch.from_numpy(x[blk]).requires_grad_(True)
    out = batch_norm(bn, xb)
    (out * torch.from_numpy(up[blk])).sum().backward()
    grads = torch.cat([bn.weight.grad, bn.bias.grad])
    dist.all_reduce(grads, group=mesh.data_group)
    return {"out": out.detach().numpy(), "x_grad": xb.grad.numpy(),
            "affine_grad": grads.numpy(),
            "running": np.stack([bn.running_mean.numpy(),
                                 bn.running_var.numpy()])}


def mesh_checks(shapes, batch, state, bn_inputs, tp_x, trainer_args=None):
    """For each (n_data, n_model) in ``shapes`` (over this launch's world):
    the layout and blocks, three steps, and at n_model > 1 the TP dropout;
    GlobalBatchNorm on the first shape with n_data > 1; then
    ``trainer_checks(*trainer_args)`` when given."""
    out = {}
    if trainer_args is not None:
        out["trainers"] = trainer_checks(*trainer_args)
    bn_done = False
    for shape in shapes:
        mesh = make_mesh(*shape, device="cpu")
        res = {"layout": gathered(mesh_layout(mesh, batch)),
               "steps": dp_steps(mesh, state, batch)}
        if mesh.n_model > 1:
            res["tp"] = gathered(tp_dropout(mesh, tp_x, state))
        if mesh.n_data > 1 and not bn_done:
            res["bn"] = gathered(global_bn(mesh, *bn_inputs))
            bn_done = True
        out[shape] = res
    return out


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------


def _record(trainer):
    """The transform's outputs of every train step, recorded."""
    seen = []
    orig = trainer._prepare_input

    def wrapped(data, train):
        x = orig(data, train)
        if train:
            seen.append(x.detach().clone())
        return x

    trainer._prepare_input = wrapped
    return seen


def emb_trainer(cfg, state, mesh=None, epochs=1):
    """The embedding ClassificationTrainer of ``cfg`` (its n_devices, or
    ``mesh``) from the MLP ``state``: the epoch logs, the whole MLP after
    them and the run's model directory."""
    from vn_celeb_face_recognition_tpu_torch.cli.train import (
        build_trainer_from_config,
    )

    cfg = copy.deepcopy(cfg)
    if mesh is None:
        trainer, _, _ = build_trainer_from_config(cfg, device="cpu")
    else:
        train_ds = registry.build_dataset(cfg["train_dataset"]["name"],
                                          **cfg["train_dataset"]["args"])
        val_ds = registry.build_dataset(cfg["val_dataset"]["name"],
                                        **cfg["val_dataset"]["args"])
        model = mlp_from(state)
        trainer = registry.build_trainer(cfg["trainer"]["name"], cfg, model,
                                         seed=123, device="cpu", mesh=mesh)
        trainer.setup_loader(
            DataLoader(train_ds, seed=123, **cfg["train_data_loader"]["args"]),
            DataLoader(val_ds, **cfg["val_data_loader"]["args"]))
    if mesh is None:
        trainer.model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in state.items()})
    logs = [trainer._train_epoch(e) for e in range(1, epochs + 1)]
    if getattr(trainer.model, "mesh", None) is not None:
        trainer.save_checkpoint_file(epochs, save_best=False)
        gather_mlp(trainer.mesh, trainer.model)
    return {"logs": logs, "state": numpy_state(trainer.model),
            "save_dir": str(trainer.save_dir)}


def aug_trainer(cfg, state, enc_state):
    """AugClassificationTrainer of ``cfg`` (its n_devices) with the tiny
    encoder of ``enc_state`` frozen: one epoch's log, the whole MLP, and
    the transform's outputs of every train step gathered into global
    batches."""
    cls = registry.TRAINERS["AugClassificationTrainer"]
    trainer = cls(copy.deepcopy(cfg), mlp_from(state), seed=123,
                  device="cpu", encoder=tiny_enc(enc_state))
    train_ds = registry.build_dataset("VNCelebDataset",
                                      **cfg["train_dataset"]["args"])
    val_ds = registry.build_dataset("VNCelebDataset",
                                    **cfg["val_dataset"]["args"])
    trainer.setup_loader(DataLoader(train_ds, seed=123, batch_size=6,
                                    shuffle=True),
                         DataLoader(val_ds, batch_size=6))
    seen = _record(trainer)
    log = trainer._train_epoch(1)
    if trainer.mesh is not None:
        seen = [all_gather_rows(x, trainer.mesh.data_group) for x in seen]
    return {"log": log, "state": numpy_state(trainer.model),
            "augmented": [x.numpy() for x in seen]}


def trainer_checks(emb_cfg, aug_cfgs, state, aug_state, enc_state, tp_cfg):
    """At n_devices 2: the embedding trainer, the aug trainer (one config
    a transform), and at a (1, 2) mesh the embedding trainer whose MLP is
    sharded, checkpointed whole."""
    out = {"emb": emb_trainer(emb_cfg, state),
           "aug": {name: aug_trainer(cfg, aug_state, enc_state)
                   for name, cfg in aug_cfgs.items()}}
    mesh = make_mesh(1, 2, device="cpu")
    out["tp"] = emb_trainer(tp_cfg, state, mesh=mesh, epochs=2)
    return out


def raise_on_rank_1():
    """Rank 1 raises while rank 0 waits in a collective."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    t = torch.zeros(1)
    dist.all_reduce(t)
    return "unreachable"


def hang_on_rank_1():
    """Rank 1 never reaches the collective rank 0 waits in."""
    if dist.get_rank() == 1:
        time.sleep(600)
    t = torch.zeros(1)
    dist.all_reduce(t)
    return "unreachable"


# ---------------------------------------------------------------------------
# the engine and the encoder apply
# ---------------------------------------------------------------------------


class TinyEnc(torch.nn.Module):
    """Conv(8, 3x3, stride 4, no padding) -> spatial mean -> Dense(512):
    the tiny encoder of tests/test_engine.py, in NCHW."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3, stride=4)
        self.dense = torch.nn.Linear(8, 512)

    def forward(self, x):
        return self.dense(self.conv(x).mean(dim=(2, 3)))


def tiny_enc(state):
    enc = TinyEnc()
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return enc.eval()


def make_engine(mesh, enc_state, clf_state, det, **kw):
    from vn_celeb_face_recognition_tpu_torch.models.mtcnn import MTCNN
    from vn_celeb_face_recognition_tpu_torch.pipeline.engine import (
        FusedRecognitionEngine,
    )

    return FusedRecognitionEngine(
        MTCNN(device="cpu", **det), tiny_enc(enc_state),
        mlp_from(clf_state), target_fs=112, mesh=mesh, **kw)


def outputs_np(out):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def engine_checks(chunks, enc_state, clf_state, det, adaptive, enc_x):
    """On a data mesh of the world: ``process`` of each (name, frames,
    face_cap) chunk; ``process_adaptive`` of ``adaptive`` (frames, buckets,
    hint) with the bucket each rank ran at and its hint after
    ``observe``; the sharded Encoder apply on ``enc_x``. Every rank's
    outputs."""
    from vn_celeb_face_recognition_tpu_torch.pipeline.recognition import (
        Encoder,
    )

    mesh = make_mesh(device="cpu")
    res = {}
    for name, frames, cap in chunks:
        eng = make_engine(mesh, enc_state, clf_state, det, face_cap=cap)
        res[name] = gathered(outputs_np(eng.process(frames)))
    frames, buckets, hint = adaptive
    eng = make_engine(mesh, enc_state, clf_state, det, face_cap=buckets,
                      face_hint=hint)
    first = outputs_np(eng.process(frames))
    eng._face_hint = hint
    out = eng.process_adaptive(frames)
    eng.observe(out)
    res["adaptive"] = gathered({"first": first, "out": outputs_np(out),
                                "hint": eng._face_hint})
    apply = Encoder(tiny_enc(enc_state), mesh=mesh)
    res["encoder"] = gathered(apply(enc_x))
    return res
