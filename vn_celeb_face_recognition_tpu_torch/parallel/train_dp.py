"""The multi-device training step: data parallel over 'data' x tensor
parallel over 'model'.

Counterpart of ``vn_celeb_face_recognition_tpu/parallel/train_dp.py``. The
JAX step is one SPMD program whose loss is the weighted NLL of the whole
global batch, ``-sum(w log p) / max(sum(w), 1)``. Each rank of the port
holds one data block and computes its share of that loss, ``its weighted
mean x max(its weight sum, 1) / max(the global weight sum, 1)`` (the
loader's padding rows weigh 0, so the ranks' weight sums differ and
per-rank means must not be averaged); the shares sum to the global loss,
so the gradients summed over the data group are its gradients. Accuracy
is summed the same way. The MLP head is sharded over the model axis
(``shard_mlp``), the rest replicated; the optimizer steps each rank's
shard (Adam and its L2 term act element by element, so sharded equals
whole).

Random draws inside the step (the transform's augmentation, dropout) are
drawn for the global batch and cut to the rank's block
(``utils.blocks``), so a step equals the one-process step.
"""

import torch

from ..training.losses import accuracy, neg_log_llhood
from .collectives import (
    all_reduce_grads,
    all_reduce_values,
    data_block,
    total_weight,
    weighted_share,
)
from .mesh import is_mlp, replicate, shard_batch, shard_mlp as _shard_mlp


def make_dp_train_step(mesh, model, optimizer, encoder=None, transform=None,
                       shard_mlp=True):
    """Build ``(train_step, place_state, place_batch)``.

    ``train_step(batch, generator) -> (loss, {"accuracy": acc})``, global
    values as 0-d tensors, takes one optimizer step on ``model`` in place;
    ``batch`` is placed by ``place_batch`` (this rank's block on the mesh's
    device) and ``generator`` draws the transform's and dropout's
    randomness, seeded alike on every rank. ``place_state(model,
    optimizer)`` replicates the model (and the frozen ``encoder``) from
    rank 0 and, with ``shard_mlp``, shards an MLP head over the model axis.
    ``encoder`` runs frozen under ``torch.no_grad()`` on the transformed
    (NHWC, given to it NCHW) batch. ``mesh`` None builds the one-process
    step."""

    def step(batch, generator):
        with data_block(mesh):
            x = batch["data"]
            if transform is not None:
                x = transform(x, generator)
            if x.dim() == 4:
                x = x.permute(0, 3, 1, 2)
            if encoder is not None:
                with torch.no_grad():
                    x = encoder(x).to(torch.float32)
            target, weight = batch["target"], batch["weight"]
            total = total_weight(weight, mesh)
            model.train()
            out = model(x, generator=generator)
            loss = weighted_share(neg_log_llhood(out, target, weight), weight,
                                  total)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            all_reduce_grads(list(model.parameters()), mesh)
            optimizer.step()
            with torch.no_grad():
                acc = weighted_share(accuracy(out.detach(), target, weight),
                                     weight, total)
                vals = all_reduce_values(torch.stack([loss.detach(), acc]),
                                         mesh)
        return vals[0], {"accuracy": vals[1]}

    def place_state(model_, optimizer_):
        if mesh is None:
            return model_, optimizer_
        replicate(mesh, model_)
        if encoder is not None:
            replicate(mesh, encoder)
        if shard_mlp and is_mlp(model_):
            _shard_mlp(mesh, model_, optimizer_)
        return model_, optimizer_

    def place_batch(batch):
        if mesh is None:
            return batch
        return shard_batch(mesh, batch)

    return step, place_state, place_batch
