"""A ('data', 'model') process-group mesh and the sharding helpers.

Counterpart of ``vn_celeb_face_recognition_tpu/parallel/mesh.py``. The JAX
package runs one SPMD program over a device mesh and XLA inserts the
collectives; the port runs one process per device under
``torch.distributed`` (``parallel.launch`` starts them) and each process
holds its part:

  * ``data`` axis: the leading (batch) axis of a global batch, one
    contiguous block a data rank (JAX's ``P("data")``);
  * ``model`` axis: the MLP head tensor-parallel, Megatron's column ->
    row pairing (``shard_mlp``); everything else is replicated.

Ranks are laid out as ``rank = d * n_model + m``, as
``np.asarray(devices).reshape(n_data, n_model)`` lays out JAX's devices.
Every rank makes every data-axis and model-axis group with
``dist.new_group``, in the same order, and keeps its own two.
"""

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This process's place in the mesh: its world ``rank``, ``shape``
    ``{"data": n_data, "model": n_model}``, its coordinates ``(d, m)``,
    the process groups of its data axis (the ranks with its ``m``) and
    model axis (the ranks with its ``d``), and its device."""

    rank: int
    shape: dict
    coords: tuple
    data_group: object
    model_group: object
    device: torch.device

    @property
    def n_data(self):
        return self.shape["data"]

    @property
    def n_model(self):
        return self.shape["model"]

    @property
    def d(self):
        return self.coords[0]

    @property
    def m(self):
        return self.coords[1]


def make_mesh(n_data=None, n_model=1, device="cuda"):
    """The mesh over the initialised default process group: ``n_data``
    defaults to the world size over ``n_model``, and ``n_data * n_model``
    must be the world size. ``device`` "cuda" places this rank on
    ``cuda:<current device>`` (``launch`` sets it to the local rank) and
    needs the NCCL backend; "cpu" needs gloo. Neither falls back."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group; "
                           "run under parallel.launch")
    world = dist.get_world_size()
    n_model = int(n_model)
    n_data = world // n_model if n_data is None else int(n_data)
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} processes; the group has "
                         f"{world}")
    kind = torch.device(device).type
    backend = dist.get_backend()
    want = {"cuda": "nccl", "cpu": "gloo"}.get(kind)
    if want is None:
        raise ValueError(f"unknown mesh device {device!r}")
    if backend != want:
        raise RuntimeError(f"a {kind} mesh runs on the {want} backend; the "
                           f"process group is {backend}")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if kind == "cuda" else torch.device("cpu"))
    rank = dist.get_rank()
    d, m = divmod(rank, n_model)
    data_group = model_group = None
    for i in range(n_data):  # model axes, one a data coordinate
        g = dist.new_group([i * n_model + j for j in range(n_model)])
        if i == d:
            model_group = g
    for j in range(n_model):  # data axes, one a model coordinate
        g = dist.new_group([i * n_model + j for i in range(n_data)])
        if j == m:
            data_group = g
    return Mesh(rank, {"data": n_data, "model": n_model}, (d, m),
                data_group, model_group, dev)


@dataclass(frozen=True)
class Sharding:
    """How a tensor lies on the mesh: ``axis`` "data" (its leading axis in
    ``n_data`` contiguous blocks) or None (replicated)."""

    mesh: Mesh
    axis: object = None

    def index(self, n):
        """The slice of a leading axis of ``n`` this rank holds."""
        if self.axis is None:
            return slice(0, n)
        n_data = self.mesh.n_data
        if n % n_data:
            raise ValueError(f"a leading axis of {n} does not split into "
                             f"{n_data} equal data blocks")
        block = n // n_data
        return slice(self.mesh.d * block, (self.mesh.d + 1) * block)

    def place(self, x):
        """This rank's part of ``x`` (numpy or tensor) on the mesh's
        device."""
        part = x[self.index(len(x))]
        if not isinstance(part, torch.Tensor):
            part = torch.as_tensor(part)
        return part.to(self.mesh.device)


def data_sharding(mesh, rank=1):
    """The leading (batch) axis over 'data' (JAX's ``P("data", None,
    ...)``; ``rank`` is kept for the same signature)."""
    del rank
    return Sharding(mesh, "data")


def replicated_sharding(mesh):
    return Sharding(mesh, None)


def shard_batch(mesh, batch):
    """Every array of a batch dict cut to this rank's data block on the
    mesh's device; a list (the loader's paths) is cut the same way, any
    other value kept."""
    sharding = data_sharding(mesh)
    out = {}
    for k, v in batch.items():
        if hasattr(v, "ndim"):
            out[k] = sharding.place(v)
        elif isinstance(v, list):
            out[k] = v[sharding.index(len(v))]
        else:
            out[k] = v
    return out


@torch.no_grad()
def replicate(mesh, module_or_tensors):
    """Broadcast a module's parameters and buffers (or a list of tensors)
    from world rank 0 to every rank, in place; moves a module to the
    mesh's device first. Returns what it was given."""
    if isinstance(module_or_tensors, torch.nn.Module):
        module_or_tensors.to(mesh.device)
        tensors = list(module_or_tensors.parameters()) + list(
            module_or_tensors.buffers())
    else:
        tensors = list(module_or_tensors)
    for t in tensors:
        dist.broadcast(t.data, src=0)
    return module_or_tensors


# the MLP's tensor-parallel layout: parameter -> the dimension cut over
# the model axis (dense_2's bias stays whole)
MLP_SHARDS = {"dense_1.weight": 0, "dense_1.bias": 0, "dense_2.weight": 1}


def mlp_blocks(mesh):
    """``shard_mlp``'s layout on this rank as ``models.convert
    .load_state_dict_blocks`` takes it: key -> (dim, m, n_model)."""
    return {k: (dim, mesh.m, mesh.n_model) for k, dim in MLP_SHARDS.items()}


def is_mlp(model):
    """Whether ``model`` is the MLP head (``shard_mlp`` takes it)."""
    return hasattr(model, "dense_1") and hasattr(model, "dense_2")


def _params(mlp):
    return dict(mlp.named_parameters())


@torch.no_grad()
def shard_mlp(mesh, mlp, optimizer=None):
    """The counterpart of ``mlp_param_sharding``: model rank ``m`` keeps
    ``dense_1``'s output rows block ``m`` and its bias block, and
    ``dense_2``'s input columns block ``m``; ``dense_2``'s bias stays
    whole and is added once after the reduction. In place: the Parameter
    objects stay the same, so an optimizer built over them steps the
    shards; its state (Adam's moments) is cut the same way. Sets
    ``mlp.mesh``, which selects the MLP's tensor-parallel forward."""
    params = _params(mlp)
    for name, dim in MLP_SHARDS.items():
        p = params[name]
        whole = p.shape[dim]
        if whole % mesh.n_model:
            raise ValueError(f"{name}: {whole} does not split into "
                             f"{mesh.n_model} model blocks")
        block = whole // mesh.n_model
        for t in [p] + _param_state(optimizer, p):
            t.data = t.data.narrow(dim, mesh.m * block, block).contiguous()
    mlp.mesh = mesh
    return mlp


@torch.no_grad()
def gather_mlp(mesh, mlp, optimizer=None):
    """The inverse of ``shard_mlp`` (every rank calls it): the blocks
    gathered over the model axis, so the MLP (and the optimizer's state)
    is whole again on every rank. Checkpoints are written whole."""
    params = _params(mlp)
    for name, dim in MLP_SHARDS.items():
        p = params[name]
        for t in [p] + _param_state(optimizer, p):
            t.data = _gather(mesh, t.data, dim)
    mlp.mesh = None
    return mlp


def _param_state(optimizer, p):
    """The optimizer's per-element state tensors of ``p`` (its scalars,
    Adam's step, stay as they are)."""
    if optimizer is None:
        return []
    return [v for v in optimizer.state.get(p, {}).values()
            if isinstance(v, torch.Tensor) and v.shape == p.shape]


def _gather(mesh, t, dim):
    parts = [torch.empty_like(t) for _ in range(mesh.n_model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=dim)
