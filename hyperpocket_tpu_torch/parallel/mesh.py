"""The (data, model) mesh over the process group, and the sharding rules.

Counterpart of ``hyperpocket_tpu/parallel/mesh.py``. JAX places arrays on a
``jax.sharding.Mesh`` of devices and XLA inserts the collectives; here each
rank is one device of a ``(data, model)`` grid, laid out row-major as JAX's
``reshape(n_data, n_model)``: rank ``d * n_model + m``. The collectives are
explicit:

* **data axis**: each rank holds its rows of every batch; the loss is a
  sum over the batch, so a rank's loss is a partial sum and its gradients
  are *summed* over the data group (``all_reduce_grads``).
* **model axis** (tensor parallelism of the hypernetwork): Megatron's pair
  on the widest matmuls, under ``param_shardings``' rule. ``trunk[-1]`` is
  column-parallel (its output channels split), the fused head row-parallel
  (its 2048-wide contraction split). ``copy_to_group`` (identity forward,
  all-reduce backward) feeds ``trunk[-1]``; ``reduce_from_group``
  (all-reduce forward, identity backward) sums the heads' partial products.
  Each rank's optimizer moments cover its shard only.

A group is a ``torch.distributed`` process group; an axis of size 1 inside
a larger grid has no group, and its collectives are the identity.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.distributed as dist
from torch import nn

from hyperpocket_tpu_torch.parallel.distributed import is_initialized, rank, world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """This rank's place in a ``(data, model)`` grid of the process group."""

    def __init__(self, n_data: int, n_model: int, groups: dict, rank_: int):
        self.shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
        self._groups = groups
        self.rank = rank_

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        n_model = self.shape[MODEL_AXIS]
        return self.rank // n_model if axis == DATA_AXIS else self.rank % n_model

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None at size 1)."""
        return self._groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"rank={self.rank})")


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """Build the ``(data, model)`` mesh over every rank; data defaults to all of them.

    Raises when the grid needs more ranks than the group has, as JAX's
    does for devices, and when it leaves ranks out.
    """
    world = world_size()
    if n_data is None:
        n_data = world // n_model
    used = n_data * n_model
    if used > world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {used} devices, have {world}")
    if used < world:
        raise ValueError(f"mesh {n_data}x{n_model} leaves {world - used} of {world} ranks out; "
                         "every rank of the process group must be in the mesh")
    if not is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.initialize_multihost first")
    me = rank()
    groups = {DATA_AXIS: None, MODEL_AXIS: None}
    if n_model == 1:
        groups[DATA_AXIS] = dist.group.WORLD
    elif n_data == 1:
        groups[MODEL_AXIS] = dist.group.WORLD
    else:
        # every rank creates every group, in the same order
        for m in range(n_model):
            ranks = [d * n_model + m for d in range(n_data)]
            g = dist.new_group(ranks)
            if me in ranks:
                groups[DATA_AXIS] = g
        for d in range(n_data):
            ranks = [d * n_model + m for m in range(n_model)]
            g = dist.new_group(ranks)
            if me in ranks:
                groups[MODEL_AXIS] = g
    return Mesh(n_data, n_model, groups, me)


# ---------------------------------------------------------------------------
# Collectives


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (the identity for None)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order.

    One collective into one tensor, which a CUDA graph captures (the
    data-parallel serving forward, ``serving.py``)."""
    if group is None:
        return t
    t = t.contiguous()
    world = dist.get_world_size(group)
    out = t.new_empty((world * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out if dim == 0 else torch.cat(out.chunk(world), dim=dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient backward."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward."""
    return _ReduceFromGroup.apply(x, group)


def all_reduce_grads(params, group) -> None:
    """Sum the gradients of ``params`` over ``group`` with one collective."""
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    start = 0
    for g in grads:
        g.copy_(flat[start:start + g.numel()].view_as(g))
        start += g.numel()


# ---------------------------------------------------------------------------
# Batches and parameters


def batch_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of an ``n``-row batch split over the data axis."""
    n_data = mesh.size(DATA_AXIS)
    if n % n_data:
        raise ValueError(f"batch of {n} rows does not divide the {n_data}-way data axis")
    per = n // n_data
    start = mesh.index(DATA_AXIS) * per
    return slice(start, start + per)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each global batch array (split over the data axis)."""
    out = tuple(a[batch_rows(mesh, a.shape[0])] for a in arrays)
    return out[0] if len(out) == 1 else out


def replicate(mesh: Mesh, module_or_tensor):
    """Broadcast a tensor, or a module's parameters and buffers, from rank 0."""
    tensors = ([module_or_tensor] if isinstance(module_or_tensor, torch.Tensor)
               else list(module_or_tensor.parameters()) + list(module_or_tensor.buffers()))
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return module_or_tensor


def param_shardings(mesh: Mesh, model: nn.Module) -> dict[str, int | None]:
    """For each parameter name, the torch dimension the model axis splits, or None.

    The rule of ``hyperpocket_tpu/parallel/mesh.py::param_shardings``, with
    torch's ``(out, in)`` weights: ``hyper_network.trunk[-1]`` is
    column-parallel (weight dim 0, its bias), ``hyper_network.heads.weight``
    row-parallel over the 2048-wide contraction (dim 1; JAX's
    ``P(model, None)`` on ``(in, out)``). Everything else is replicated, as
    is everything when the model axis has size 1.
    """
    names = [n for n, _ in model.named_parameters()]
    if mesh.size(MODEL_AXIS) == 1:
        return dict.fromkeys(names)
    last = f"hyper_network.trunk.{len(model.hyper_network.trunk) - 1}."
    split = {last + "weight": 0, last + "bias": 0, "hyper_network.heads.weight": 1}
    return {n: split.get(n) for n in names}


def _sharded(mesh: Mesh, model: nn.Module) -> list[tuple[nn.Parameter, int]]:
    by_name = dict(model.named_parameters())
    return [(by_name[n], d) for n, d in param_shardings(mesh, model).items() if d is not None]


def _local(mesh: Mesh, t: torch.Tensor, dim: int) -> torch.Tensor:
    n_model = mesh.size(MODEL_AXIS)
    if t.shape[dim] % n_model:
        raise ValueError(f"dimension {dim} of size {t.shape[dim]} does not divide the "
                         f"{n_model}-way model axis")
    size = t.shape[dim] // n_model
    return t.narrow(dim, mesh.index(MODEL_AXIS) * size, size).clone()


def shard_params(mesh: Mesh, model: nn.Module) -> dict[str, int | None]:
    """Keep this rank's shard of each parameter ``param_shardings`` splits, in
    place, and turn on the hypernetwork's tensor-parallel forward. Build the
    optimizer after this, so its moments cover the shards only."""
    for p, dim in _sharded(mesh, model):
        p.data = _local(mesh, p.data, dim)
    if mesh.size(MODEL_AXIS) > 1:
        model.hyper_network.tp_group = mesh.group(MODEL_AXIS)
    return param_shardings(mesh, model)


@contextlib.contextmanager
def unsharded(mesh: Mesh | None, model: nn.Module,
              optimizer: torch.optim.Optimizer | None = None) -> Iterator[None]:
    """Inside, every sharded parameter and its optimizer slots hold the full
    tensors, gathered over the model axis; on exit each rank keeps its shard
    of whatever they then hold. A checkpoint saved inside is the one-process
    file; one loaded inside is re-sharded on exit. Every rank must enter.
    """
    sharded = [] if mesh is None else _sharded(mesh, model)
    if not sharded:
        yield
        return
    group = mesh.group(MODEL_AXIS)
    state = optimizer.state if optimizer is not None else {}

    def slots(p):
        return [k for k, v in state.get(p, {}).items()
                if isinstance(v, torch.Tensor) and v.shape == p.shape]

    for p, dim in sharded:
        for k in slots(p):
            state[p][k] = all_gather_cat(state[p][k], group, dim)
        p.data = all_gather_cat(p.data, group, dim)
    try:
        yield
    finally:
        for p, dim in sharded:
            for k in slots(p):
                state[p][k] = _local(mesh, state[p][k], dim)
            p.data = _local(mesh, p.data, dim)
