"""Chamfer distance and exact nearest-neighbour distance, plain PyTorch.

Port of ``hyperpocket_tpu/ops/chamfer.py``:

* ``chamfer_loss``: squared pairwise distances through the
  ``|x|^2 + |y|^2 - 2<x,y>`` expansion, then the *sum* of per-point minima
  in both directions over the whole batch (one scalar). Its gradient goes
  through ``amin``, which splits a tie evenly, as ``jnp.min`` does.
* ``nn_distance``: squared NN distances in both directions with their
  argmin indices, as an ``autograd.Function`` whose backward is
  ``nn_backward``.
* ``nn_backward`` (called K2 in the port's notes): ``da = 2 g (a - b[idx])``
  plus the scatter-add of ``-da`` into b, for both directions. It is a
  ``torch.gather`` and an ``index_add_``; the JAX package's one-hot matmul
  form of the same gather and scatter exists only for the TPU.

``ops/nn.py`` sends the training loss to the CUDA kernels on fp32,
128-aligned clouds; fp64 and unaligned clouds take this module.
"""

from __future__ import annotations

import torch


def batch_pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``P[b, i, j] = |x[b, i] - y[b, j]|^2`` as ``|x|^2 + |y|^2 - 2 x.y``.

    x (B, N, D), y (B, M, D) -> (B, N, M), in the wider of the two dtypes.
    As in the JAX package, each squared norm is taken in its cloud's own
    dtype and only the product in the wider one.
    """
    dtype = torch.promote_types(x.dtype, y.dtype)
    xx = torch.sum(x * x, dim=-1)
    yy = torch.sum(y * y, dim=-1)
    xy = torch.bmm(x.to(dtype), y.to(dtype).transpose(1, 2))
    return xx[..., :, None] + yy[..., None, :] - 2.0 * xy


def chamfer_loss(gts: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """Sum over batch and points of the NN squared distances, both directions."""
    p = batch_pairwise_sqdist(gts, preds)
    return torch.sum(torch.amin(p, dim=1)) + torch.sum(torch.amin(p, dim=2))


def chamfer_per_cloud(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-cloud symmetric Chamfer, mean of the minima both ways: (B,)."""
    p = batch_pairwise_sqdist(x, y)
    return torch.amin(p, dim=2).mean(dim=1) + torch.amin(p, dim=1).mean(dim=1)


def directed_hausdorff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``max_i min_j |a_i - b_j|`` per cloud: (B,)."""
    p = batch_pairwise_sqdist(a, b)
    return torch.sqrt(torch.clamp_min(torch.amin(p, dim=2), 0.0)).amax(dim=1)


def _gather_scatter_direction(a: torch.Tensor, b: torch.Tensor, idx: torch.Tensor,
                              g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One direction for a batch: ``(da (B, K, 3), db (B, M, 3))``.

    ``da = 2 g (a - b[idx])``; ``db`` accumulates ``-da`` at ``idx``.
    """
    batch, m = b.shape[0], b.shape[1]
    idx = idx.long()
    b_nn = torch.gather(b, 1, idx[..., None].expand(-1, -1, b.shape[2]))
    da = 2.0 * g[..., None] * (a - b_nn)
    rows = (idx + m * torch.arange(batch, device=idx.device)[:, None]).reshape(-1)
    db = torch.zeros((batch * m, b.shape[2]), dtype=da.dtype, device=da.device)
    db.index_add_(0, rows, -da.reshape(-1, b.shape[2]))
    return da, db.view(batch, m, -1)


def nn_backward(a: torch.Tensor, b: torch.Tensor, idx1: torch.Tensor, idx2: torch.Tensor,
                g1: torch.Tensor, g2: torch.Tensor):
    """Gradients ``(da, db)`` of ``dist1``/``dist2`` given their cotangents.

    dist1 (B, N) are a's distances into b at ``idx1``; dist2 (B, M) b's into
    a at ``idx2``.
    """
    da_direct, db_scatter = _gather_scatter_direction(a, b, idx1, g1)
    db_direct, da_scatter = _gather_scatter_direction(b, a, idx2, g2)
    return da_direct + da_scatter, db_direct + db_scatter


def _nn_forward(a: torch.Tensor, b: torch.Tensor):
    p = batch_pairwise_sqdist(a, b)
    return (torch.amin(p, dim=2), torch.argmin(p, dim=2).int(),
            torch.amin(p, dim=1), torch.argmin(p, dim=1).int())


class _NNDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        dist1, idx1, dist2, idx2 = _nn_forward(a, b)
        ctx.save_for_backward(a, b, idx1, idx2)
        ctx.mark_non_differentiable(idx1, idx2)
        return dist1, idx1, dist2, idx2

    @staticmethod
    def backward(ctx, g1, _gi1, g2, _gi2):
        a, b, idx1, idx2 = ctx.saved_tensors
        return nn_backward(a, b, idx1, idx2, g1, g2)


def nn_distance(a: torch.Tensor, b: torch.Tensor):
    """Bidirectional NN squared distances and first-argmin indices.

    a (B, N, 3), b (B, M, 3) -> (dist1 (B, N), idx1 (B, N) int32,
    dist2 (B, M), idx2 (B, M) int32). Only the distances carry gradients.
    """
    return _NNDistance.apply(a, b)
