"""Point-axis sharding of the NN distance: a ring over the process group.

Counterpart of ``hyperpocket_tpu/parallel/point_sharding.py``. Each rank
holds a contiguous shard of the point axis of both clouds (``shard_points``
cuts it). Queries ``a`` stay on their rank; the key shard ``b`` and its
travelling minima rotate one rank forward per hop with
``batch_isend_irecv``, and after ``world`` hops they are home. Each hop is
the port's NN dispatcher (``ops/nn.py::nn_distance_auto``): on CUDA clouds
K1 twice when the shards have equal point counts, K5 when they differ; on
CPU clouds the matrix form of ``ops/chamfer.py``, in the clouds' dtype.

Indices are global. A merge takes a hop's value only when it is strictly
smaller, so on exactly equal distances the first shard visited in ring
order wins (the owner of hop ``t`` is ``(me - t) % n``), as in JAX's ring;
the unsharded op keeps the lowest global index instead. Real float clouds
do not tie.

The gradient is an ``autograd.Function``: backward all-gathers both clouds,
the global indices and the cotangents along the point axis (two
collectives: the floats packed, the indices packed) and runs
``ops/chamfer.py::nn_backward`` (K2) on them, so a d1 term's contribution to
a key on another rank reaches it, and the result is the unsharded NN
subgradient exactly; each rank keeps its rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from hyperpocket_tpu_torch.ops.chamfer import nn_backward
from hyperpocket_tpu_torch.ops.nn import nn_distance_auto
from hyperpocket_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    all_gather_cat,
    reduce_from_group,
)


def _ring_group(group):
    """A Mesh's data axis, a process group, or None for the whole world."""
    if isinstance(group, Mesh):
        group = group.group(DATA_AXIS)
    return dist.group.WORLD if group is None else group


def shard_points(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's contiguous shard of ``x``'s point axis (dim 1)."""
    group = _ring_group(group)
    n = dist.get_world_size(group)
    if x.shape[1] % n:
        raise ValueError(f"point count {x.shape[1]} must divide the {n}-way ring")
    per = x.shape[1] // n
    return x[:, dist.get_rank(group) * per:(dist.get_rank(group) + 1) * per]


def _rotate(tensors: list[torch.Tensor], group, me: int, n: int) -> list[torch.Tensor]:
    """Send each tensor one rank forward and receive the previous rank's."""
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    received = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in received]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


def _gather_points(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Every rank's (B, n, ...) tensors concatenated along dim 1 in rank
    order, by one all-gather of them packed (one dtype)."""
    every = all_gather_cat(torch.cat([t.reshape(-1) for t in tensors])[None], group)
    out, start = [], 0
    for t in tensors:
        part = every[:, start:start + t.numel()].reshape(every.shape[0], *t.shape)
        out.append(part.transpose(0, 1).reshape(t.shape[0], -1, *t.shape[2:]))
        start += t.numel()
    return out


def _ring_forward(a: torch.Tensor, b: torch.Tensor, group):
    me, n = dist.get_rank(group), dist.get_world_size(group)
    if n > 1:  # a shard of another shape would leave a receive unmatched
        shapes = torch.tensor([a.shape[0], a.shape[1], b.shape[1]], device=a.device)
        every = all_gather_cat(shapes[None], group)
        if not bool((every == every[:1]).all()):
            raise ValueError(f"the ring's shards differ in shape across ranks: "
                             f"{every.tolist()} (batch, queries, keys)")
    n_local, m_local = a.shape[1], b.shape[1]
    b_cur = b.contiguous()
    d2 = i2 = d1 = i1 = None
    for t in range(n):
        owner = (me - t) % n  # the home rank of the visiting key shard
        hop_d1, hop_i1, hop_d2, hop_i2 = nn_distance_auto(a, b_cur)
        hop_i1 = hop_i1 + owner * m_local
        hop_i2 = hop_i2 + me * n_local
        if t == 0:
            d1, i1, d2, i2 = hop_d1, hop_i1, hop_d2, hop_i2
        else:
            take1 = hop_d1 < d1
            d1, i1 = torch.where(take1, hop_d1, d1), torch.where(take1, hop_i1, i1)
            take2 = hop_d2 < d2
            d2, i2 = torch.where(take2, hop_d2, d2), torch.where(take2, hop_i2, i2)
        if n > 1:
            b_cur, d2, i2 = _rotate([b_cur, d2, i2], group, me, n)
    return d1, i1, d2, i2


class _RingNN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, group):
        d1, i1, d2, i2 = _ring_forward(a, b, group)
        ctx.group = group
        ctx.save_for_backward(a, b, i1, i2)
        ctx.mark_non_differentiable(i1, i2)
        return d1, i1, d2, i2

    @staticmethod
    def backward(ctx, g1, _gi1, g2, _gi2):
        a, b, i1, i2 = ctx.saved_tensors
        group = ctx.group
        if g1 is None:
            g1 = torch.zeros(i1.shape, dtype=a.dtype, device=a.device)
        if g2 is None:
            g2 = torch.zeros(i2.shape, dtype=b.dtype, device=b.device)
        a_all, b_all, g1_all, g2_all = _gather_points([a, b, g1.to(a.dtype), g2.to(a.dtype)],
                                                      group)
        i1_all, i2_all = _gather_points([i1, i2], group)
        da, db = nn_backward(a_all, b_all, i1_all, i2_all, g1_all, g2_all)
        me = dist.get_rank(group)
        n_local, m_local = a.shape[1], b.shape[1]
        return (da[:, me * n_local:(me + 1) * n_local],
                db[:, me * m_local:(me + 1) * m_local], None)


def nn_distance_point_sharded(a: torch.Tensor, b: torch.Tensor, group=None):
    """Bidirectional exact NN distance with both point axes sharded over a ring.

    ``a`` (B, N/n, 3) and ``b`` (B, M/n, 3) are this rank's shards of the
    point axes (every rank's of the same shape); ``group`` is a process
    group, a ``Mesh`` (its data axis) or None (the whole world). Returns
    ``(dist1 (B, N/n), idx1, dist2 (B, M/n), idx2)``, ``ops.chamfer.nn_distance``'s
    contract for this rank's rows, with global int32 indices. Only the
    distances carry gradients.
    """
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"expected shards (B, N, 3) and (B, M, 3), got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    return _RingNN.apply(a, b, _ring_group(group))


def chamfer_loss_point_sharded(gts: torch.Tensor, preds: torch.Tensor,
                               group=None) -> torch.Tensor:
    """The reference ChamferLoss (sum of the minima both ways over the whole
    batch) of point-sharded clouds: the global value on every rank,
    differentiable to this rank's shards."""
    group = _ring_group(group)
    d1, _, d2, _ = nn_distance_point_sharded(gts, preds, group)
    return reduce_from_group(d1.sum() + d2.sum(), group)
