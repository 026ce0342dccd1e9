"""Nearest-neighbour kernels K1 and K3, and the Chamfer-loss dispatch.

Counterpart of ``hyperpocket_tpu/ops/pallas_nn.py``:

* ``nn_one_direction`` (K1, ``csrc/nn_one_direction.cu``): for each query
  the squared distance to the nearest key and that key's first index.
* ``nn_min_fused`` (K3, ``csrc/nn_min_fused.cu``): the minimum distances in
  both directions, without indices, from one pass.
* ``chamfer_loss_streaming``: the Chamfer sum. With no gradient needed it
  runs K3 once; under autograd K1 runs twice, the indices are saved, and the
  backward is ``ops/chamfer.py::nn_backward``.
* ``chamfer_loss_auto``: the training loss's dispatch. fp32 CUDA clouds
  take the streaming path at any point counts; fp64 (the trajectory-parity
  mode) takes ``ops/chamfer.py::chamfer_loss``, as in the JAX package. CPU
  clouds keep the JAX package's gate: fp32 with both point counts
  multiples of 128 take the streaming path (the plain versions of the
  kernels), everything else the plain loss.
* the metric dispatchers ``nn_min_dists``, ``chamfer_per_cloud_auto``,
  ``directed_hausdorff_auto`` (K3) and ``nn_distance_auto`` (K1 twice): the
  matrix forms of ``ops/chamfer.py`` for CPU clouds, the kernels for CUDA
  clouds at any point counts (fp32 only; anything else raises). The JAX
  package's 128-multiple gate fits Mosaic's lane layout, which the CUDA
  kernels do not have.

Both kernels compute a distance as the TPU kernels do: ``d = 0; for c in
0..2: diff = k_c - q_c; d += diff * diff``, each step rounded on its own.
The plain versions ``nn_one_direction_reference`` and
``nn_min_fused_reference`` do the same on tensors, so kernel and plain
version agree bit for bit and their indices are equal. A wrapper runs the
plain version for a CPU tensor; for a CUDA tensor it launches its kernel or
raises. ``<wrapper>.launches`` counts kernel launches.

The JAX package computes the grad forward at N != M with K5
(``_nn_fused_planes``), which is not ported yet: the port runs K1 twice
there, the JAX package's own route when K5's tile does not fit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hyperpocket_tpu_torch.ops._build import library
from hyperpocket_tpu_torch.ops.chamfer import (
    chamfer_loss,
    chamfer_per_cloud,
    directed_hausdorff,
    nn_backward,
    nn_distance,
)


def _check(q: torch.Tensor, k: torch.Tensor) -> None:
    if q.ndim != 3 or k.ndim != 3 or q.shape[2] != 3 or k.shape[2] != 3:
        raise ValueError(f"expected clouds (B, N, 3) and (B, M, 3), got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    if q.shape[0] != k.shape[0]:
        raise ValueError(f"batch sizes differ: {q.shape[0]} and {k.shape[0]}")


def _sqdist_reference(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, N, M) squared distances with the kernels' arithmetic, in fp32."""
    q, k = q.float(), k.float()
    d = None
    for c in range(3):
        diff = k[:, None, :, c] - q[:, :, None, c]
        sq = diff * diff
        d = sq if d is None else d + sq
    return d


def nn_one_direction_reference(q: torch.Tensor, k: torch.Tensor):
    """Plain version of K1: (dist (B, N) fp32, idx (B, N) int32)."""
    _check(q, k)
    d = _sqdist_reference(q, k)
    return torch.amin(d, dim=2), torch.argmin(d, dim=2).int()


def nn_min_fused_reference(q: torch.Tensor, k: torch.Tensor):
    """Plain version of K3: (dist1 (B, N), dist2 (B, M)) fp32."""
    _check(q, k)
    d = _sqdist_reference(q, k)
    return torch.amin(d, dim=2), torch.amin(d, dim=1)


def _kernel_args(name: str, q: torch.Tensor, k: torch.Tensor) -> None:
    """Raise on what the CUDA kernels do not take."""
    if q.device.type != "cuda" or k.device != q.device:
        raise ValueError(f"{name} runs on CUDA or CPU tensors on one device, got "
                         f"{q.device} and {k.device}")
    if q.dtype != torch.float32 or k.dtype != torch.float32:
        raise ValueError(f"{name} takes fp32 clouds, got {q.dtype} and {k.dtype}")
    if not (q.is_contiguous() and k.is_contiguous()):
        raise ValueError(f"{name} takes contiguous clouds")
    if min(q.shape[0], q.shape[1], k.shape[1]) == 0:
        raise ValueError(f"{name} takes at least one cloud of at least one point, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")


@functools.cache
def _c_function(symbol: str):
    fn = getattr(library(), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(symbol: str, q, k, out_a, out_b) -> None:
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _c_function(symbol)(q.data_ptr(), k.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
                                 q.shape[0], q.shape[1], k.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} kernel launch failed with CUDA error {rc}")


def nn_one_direction(q: torch.Tensor, k: torch.Tensor):
    """K1: q (B, N, 3), k (B, M, 3) -> (dist (B, N) fp32, idx (B, N) int32)."""
    _check(q, k)
    if q.device.type == "cpu" and k.device.type == "cpu":
        return nn_one_direction_reference(q, k)
    _kernel_args("nn_one_direction", q, k)
    dist = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    idx = torch.empty(q.shape[:2], dtype=torch.int32, device=q.device)
    _launch("hpcd_nn_one_direction", q, k, dist, idx)
    nn_one_direction.launches += 1
    return dist, idx


nn_one_direction.launches = 0


def nn_min_fused(q: torch.Tensor, k: torch.Tensor):
    """K3: q (B, N, 3), k (B, M, 3) -> (dist1 (B, N), dist2 (B, M)) fp32."""
    _check(q, k)
    if q.device.type == "cpu" and k.device.type == "cpu":
        return nn_min_fused_reference(q, k)
    _kernel_args("nn_min_fused", q, k)
    dist1 = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    dist2 = torch.empty(k.shape[:2], dtype=torch.float32, device=q.device)
    _launch("hpcd_nn_min_fused", q, k, dist1, dist2)
    nn_min_fused.launches += 1
    return dist1, dist2


nn_min_fused.launches = 0


class _ChamferStreaming(torch.autograd.Function):
    """Chamfer sum under autograd: K1 twice forward, ``nn_backward`` backward."""

    @staticmethod
    def forward(ctx, gts, preds):
        d_gt, i_gt = nn_one_direction(gts, preds)
        d_pred, i_pred = nn_one_direction(preds, gts)
        ctx.save_for_backward(gts, preds, i_gt, i_pred)
        return d_gt.sum() + d_pred.sum()

    @staticmethod
    def backward(ctx, g):
        gts, preds, i_gt, i_pred = ctx.saved_tensors
        return nn_backward(gts, preds, i_gt, i_pred, g.expand(i_gt.shape),
                           g.expand(i_pred.shape))


def chamfer_loss_streaming(gts: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """Sum over batch and points of the NN squared distances, both directions.

    The same value as ``ops/chamfer.py::chamfer_loss``, from the kernels:
    K3 when no gradient is needed, else K1 twice with the backward through
    the saved indices. Gradients differ from ``chamfer_loss``'s only at
    near-tied argmins, where both are valid subgradients.
    """
    _check(gts, preds)
    gts, preds = gts.contiguous(), preds.contiguous()
    if torch.is_grad_enabled() and (gts.requires_grad or preds.requires_grad):
        return _ChamferStreaming.apply(gts, preds)
    d_gt, d_pred = nn_min_fused(gts, preds)
    return d_gt.sum() + d_pred.sum()


def pallas_shapes_ok(n: int, m: int) -> bool:
    """The JAX package's streaming gate: both point counts multiples of 128."""
    return n % 128 == 0 and m % 128 == 0


def chamfer_loss_auto(gts: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """The streaming kernels for fp32 clouds (on the CPU only at 128-aligned
    counts, the JAX package's gate), else the plain loss."""
    fp32 = gts.dtype == torch.float32 and preds.dtype == torch.float32
    on_cpu = gts.device.type == "cpu" and preds.device.type == "cpu"
    if fp32 and (not on_cpu or pallas_shapes_ok(gts.shape[1], preds.shape[1])):
        return chamfer_loss_streaming(gts, preds)
    return chamfer_loss(gts, preds)


# ---------------------------------------------------------------------------
# The metric dispatchers of ``pallas_nn.py`` (MMD, UHD, TMD and the CD
# matrices of the generative metrics): ``ops/chamfer.py``'s matrix forms for
# CPU clouds, fp64 included; the kernels for anything else, which launch or
# raise.


def _metric_kernels(a: torch.Tensor, b: torch.Tensor) -> bool:
    return not (a.device.type == "cpu" and b.device.type == "cpu")


def nn_min_dists(a: torch.Tensor, b: torch.Tensor):
    """(dist1 (B, N), dist2 (B, M)): NN squared distances without indices."""
    if _metric_kernels(a, b):
        return nn_min_fused(a.contiguous(), b.contiguous())
    d1, _, d2, _ = nn_distance(a, b)
    return d1, d2


class _NNDistanceKernels(torch.autograd.Function):
    """``nn_distance`` from K1 twice; backward through the indices (K2)."""

    @staticmethod
    def forward(ctx, a, b):
        dist1, idx1 = nn_one_direction(a, b)
        dist2, idx2 = nn_one_direction(b, a)
        ctx.save_for_backward(a, b, idx1, idx2)
        ctx.mark_non_differentiable(idx1, idx2)
        return dist1, idx1, dist2, idx2

    @staticmethod
    def backward(ctx, g1, _gi1, g2, _gi2):
        a, b, idx1, idx2 = ctx.saved_tensors
        return nn_backward(a, b, idx1, idx2, g1, g2)


def nn_distance_auto(a: torch.Tensor, b: torch.Tensor):
    """``ops/chamfer.py::nn_distance`` through K1 (twice) where the kernels apply.

    The JAX package's single-pass K5 (``_nn_fused_planes``) is not ported
    yet; two K1 launches give the same distances and first-argmin indices.
    """
    if _metric_kernels(a, b):
        return _NNDistanceKernels.apply(a.contiguous(), b.contiguous())
    return nn_distance(a, b)


def chamfer_per_cloud_auto(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-cloud Chamfer, the mean of the minima both ways: (B,)."""
    if _metric_kernels(x, y):
        d1, d2 = nn_min_fused(x.contiguous(), y.contiguous())
        return d1.mean(dim=1) + d2.mean(dim=1)
    return chamfer_per_cloud(x, y)


def directed_hausdorff_auto(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``max_i min_j |a_i - b_j|`` per cloud (UHD's inner op): (B,)."""
    if _metric_kernels(a, b):
        dist, _ = nn_min_fused(a.contiguous(), b.contiguous())
        return torch.sqrt(torch.clamp_min(dist, 0.0)).amax(dim=1)
    return directed_hausdorff(a, b)
