"""Differentiable collectives over a mesh axis, and BatchNorm with global
statistics. They work on gloo (CPU tensors) and NCCL (CUDA tensors)
alike.

  * ``copy_to_model``: identity forward, all-reduce over the model group
    in backward (the input of a column-parallel layer);
  * ``reduce_from_model``: all-reduce over the model group forward,
    identity backward (the output of a row-parallel layer);
  * ``all_reduce_sum``: all-reduce over a group (the data axis) with the
    matching gradient, the sum of the upstream gradients of every rank;
  * ``all_gather_rows``: the data blocks of every rank concatenated
    along the leading axis (no gradient);
  * the data-parallel step's sums (``total_weight``, ``weighted_share``,
    ``all_reduce_values``, ``all_reduce_grads``) and ``data_block``, the
    context in which a rank's random draws are the global batch's
    (``parallel.train_dp`` explains them);
  * ``GlobalBatchNorm``: a BatchNorm whose train-mode statistics are the
    data group's: the all-reduced sum, count and sum of squared
    deviations. Forward, gradients and running statistics are those of
    one BatchNorm over the global batch, as under a JAX mesh, where XLA
    all-reduces flax's statistics. (``torch.nn.SyncBatchNorm`` refuses
    CPU tensors, so it could not be held to the JAX package on the CPU.)
"""

import contextlib

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..utils.blocks import batch_block


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    """Forward and backward both all-reduce (sum): the output on every
    rank is the sum of all ranks' inputs, so the gradient of a rank's
    input is the sum of every rank's upstream gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x, mesh):
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x, mesh):
    return _ReduceFromModel.apply(x, mesh.model_group)


def all_reduce_sum(x, group):
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_gather_rows(x, group):
    """Every rank's ``x`` (equal shapes) concatenated along axis 0, in
    rank order: the data blocks back into the global batch."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class GlobalBatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm (any input rank >= 2, channels on axis 1) whose train-mode
    statistics are over the data group's global batch: the mean from the
    all-reduced sum and count, the biased variance from the all-reduced
    sum of squared deviations from it (two passes, as one BatchNorm
    computes it). The running statistics move as ``layers.batch_norm``
    moves them (flax's semantics: the biased variance). Eval mode uses
    the running statistics."""

    global_stats = True  # ``layers.batch_norm`` hands train mode here

    def __init__(self, num_features, group, eps=1e-5, momentum=0.1,
                 affine=True, track_running_stats=True):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)
        self.group = group

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected an input of rank >= 2, got {x.dim()}")

    def forward(self, x):
        if not self.training:
            return nn.functional.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps)
        dtype = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dtype)
        axes = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        count = torch.tensor([x.numel() // x.shape[1]], dtype=dtype,
                             device=x.device)
        sums = all_reduce_sum(torch.cat([xf.sum(axes), count]), self.group)
        n = sums[-1].detach()
        mean = sums[:-1] / n
        centred = xf - mean.view(shape)
        var = all_reduce_sum((centred * centred).sum(axes), self.group) / n
        out = centred * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            out = out * self.weight.to(dtype).view(shape) \
                + self.bias.to(dtype).view(shape)
        if self.track_running_stats:
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(
                    mean.detach(), alpha=self.momentum)
                self.running_var.mul_(1.0 - self.momentum).add_(
                    var.detach(), alpha=self.momentum)
        return out.to(x.dtype)

    @classmethod
    def convert(cls, module, group):
        """``module`` with every BatchNorm replaced by a GlobalBatchNorm over
        ``group`` that shares its parameters and buffers (an optimizer
        built over ``module.parameters()`` steps them as before)."""
        if isinstance(module, nn.modules.batchnorm._BatchNorm) and not \
                isinstance(module, cls):
            out = cls(module.num_features, group, module.eps,
                      module.momentum, module.affine,
                      module.track_running_stats)
            if module.affine:
                out.weight, out.bias = module.weight, module.bias
            if module.track_running_stats:
                out.running_mean = module.running_mean
                out.running_var = module.running_var
                out.num_batches_tracked = module.num_batches_tracked
            out.train(module.training)
            return out
        for name, child in module.named_children():
            setattr(module, name, cls.convert(child, group))
        return module


def total_weight(weight, mesh):
    """The global batch's weight sum (a 0-d tensor, no gradient)."""
    total = weight.detach().sum().to(torch.float32)
    if mesh is not None:
        dist.all_reduce(total, group=mesh.data_group)
    return total


def weighted_share(local_mean, weight, total):
    """This rank's share of a global weighted mean from its own weighted
    mean (``losses._weighted_mean``: clamped at a weight sum of 1) and the
    global weight sum."""
    local = torch.clamp(weight.sum().to(local_mean.dtype), min=1.0)
    return local_mean * (local / torch.clamp(total.to(local_mean.dtype),
                                             min=1.0))


@torch.no_grad()
def all_reduce_values(values, mesh):
    """A stacked tensor of shares summed over the data group."""
    if mesh is not None:
        dist.all_reduce(values, group=mesh.data_group)
    return values


@torch.no_grad()
def all_reduce_grads(params, mesh):
    """Sum every parameter's gradient over the data group, in one flat
    buffer (one collective a step)."""
    grads = [p.grad for p in params if p.grad is not None]
    if mesh is None or not grads:
        return
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.data_group)
    for g, reduced in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(reduced)


def data_block(mesh):
    """The context in which a rank's draws are the global batch's."""
    if mesh is None:
        return contextlib.nullcontext()
    return batch_block(mesh.d, mesh.n_data)
