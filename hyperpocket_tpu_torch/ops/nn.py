"""Nearest-neighbour kernels K1, K3, K5 and K9, and the Chamfer dispatch.

Counterpart of ``hyperpocket_tpu/ops/pallas_nn.py``:

* ``nn_one_direction`` (K1, ``csrc/nn_one_direction.cu``): for each query
  the squared distance to the nearest key and that key's first index.
* ``nn_min_fused`` (K3, ``csrc/nn_min_fused.cu``): the minimum distances in
  both directions, without indices, from one pass.
* ``nn_fused_planes`` (K5, ``csrc/nn_fused_planes.cu``): the minima and
  first argmins in both directions from one pass; ties on the key side go
  to the lowest query index.
* ``chamfer_loss_grad`` (K9, ``csrc/chamfer_loss_grad.cu``): the per-sample
  Chamfer sum and both gradient fields from one host call.
* ``nn_fused_split``: how K5 and K9 cut each cloud's keys across blocks.
* ``nn_forward``: the grad forward of the NN ops, the counterpart of
  ``_nn_forward_pallas``: K5 when the clouds differ in size, K1 twice when
  they are equal (the JAX package's policy). ``nn_distance_pallas`` is an
  autograd function on it, with the backward ``ops/chamfer.py::nn_backward``.
* ``chamfer_loss_streaming``: the Chamfer sum. With no gradient needed it
  runs K3 once; under autograd ``nn_forward``, the indices are saved, and
  the backward is ``nn_backward``.
* ``chamfer_loss_fused``: the same value; under autograd K9 runs once and
  the backward scales the saved gradient fields.
* ``chamfer_loss_auto``: the training loss's dispatch, decided by
  ``chamfer_grad_route``. fp32 CUDA clouds under autograd take K9
  (``chamfer_loss_fused``), which the H100 runs faster than the streaming
  value and gradient, unless deterministic algorithms are on (then, and
  with no gradient needed, the streaming path); fp64 (the
  trajectory-parity mode) takes ``ops/chamfer.py::chamfer_loss``, as in
  the JAX package. CPU clouds keep the JAX package's gate: fp32 with both
  point counts multiples of 128 take the streaming path (the plain
  versions of the kernels), everything else the plain loss.
* the metric dispatchers ``nn_min_dists``, ``chamfer_per_cloud_auto``,
  ``directed_hausdorff_auto`` (K3) and ``nn_distance_auto``
  (``nn_distance_pallas``): the matrix forms of ``ops/chamfer.py`` for CPU
  clouds, the kernels for CUDA clouds at any point counts (fp32 only;
  anything else raises). The JAX package's 128-multiple and VMEM-tile
  gates fit Mosaic, which the CUDA kernels do not have.

The kernels compute a distance as the TPU kernels do: ``d = 0; for c in
0..2: diff = k_c - q_c; d += diff * diff``, each step rounded on its own.
The plain versions (``*_reference``) do the same on tensors, so kernel and
plain version agree bit for bit and their indices are equal; K9's sums use
atomics and agree to rounding. A wrapper runs the plain version for a CPU
tensor; for a CUDA tensor it launches its kernel or raises.
``<wrapper>.launches`` counts kernel launches.
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


def nn_fused_planes_reference(q: torch.Tensor, k: torch.Tensor):
    """Plain version of K5: (dist1, idx1 (B, N); dist2, idx2 (B, M)), fp32 / int32."""
    _check(q, k)
    d = _sqdist_reference(q, k)
    return (torch.amin(d, dim=2), torch.argmin(d, dim=2).int(),
            torch.amin(d, dim=1), torch.argmin(d, dim=1).int())


def chamfer_loss_grad_reference(gts: torch.Tensor, preds: torch.Tensor):
    """Plain version of K9: (loss (B,), grad_gts (B, N, 3), grad_preds (B, M, 3)) fp32.

    The per-sample sum of both directions' minima, and ``nn_backward`` on
    K5's first argmins with unit cotangents.
    """
    gts, preds = gts.float(), preds.float()
    d1, i1, d2, i2 = nn_fused_planes_reference(gts, preds)
    ga, gb = nn_backward(gts, preds, i1, i2, torch.ones_like(d1), torch.ones_like(d2))
    return d1.sum(dim=1) + d2.sum(dim=1), ga, gb


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
def _c_function(symbol: str, n_pointers: int, n_ints: int):
    fn = getattr(library(), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(symbol: str, q, k, *outs, split: tuple[int, ...] = ()) -> None:
    """Call ``symbol(q, k, *outs, B, N, M, *split, stream)``; raise on an error."""
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _c_function(symbol, 2 + len(outs), 3 + len(split))(
            q.data_ptr(), k.data_ptr(), *(o.data_ptr() for o in outs),
            q.shape[0], q.shape[1], k.shape[1], *split, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} kernel launch failed with CUDA error {rc}")


# csrc/nn_fused.cuh's sweep (K5, K9): blocks of 128 threads with 8 queries
# each, 4 blocks resident on an SM at its register limit
FUSED_QUERIES = 1024
FUSED_BLOCKS_PER_SM = 4
FUSED_MIN_KEYS = 128  # the fewest keys a split is cut to
FUSED_KEY_ALIGN = 32


def nn_fused_split(batch: int, n: int, m: int, sms: int) -> tuple[int, int]:
    """(splits, length): K5/K9's sweep cuts each cloud's m keys into
    ``splits`` runs of ``length`` keys, the last one possibly shorter and
    none empty.

    The grid is (cloud, 1024-query tile, split). ``splits`` is the largest
    count that keeps the grid within one wave of ``sms`` SMs at
    ``FUSED_BLOCKS_PER_SM`` blocks each (at least 1, and no run but the last
    under ``FUSED_MIN_KEYS`` keys); ``length`` is rounded up to a multiple
    of 32.
    B=64 at 1024x2048 gives (8, 256): 512 blocks for 528 places.
    """
    if min(batch, n, m, sms) < 1:
        raise ValueError(f"nn_fused_split takes positive counts, got batch={batch}, n={n}, "
                         f"m={m}, sms={sms}")
    tiles = -(-n // FUSED_QUERIES)
    splits = max(1, min(sms * FUSED_BLOCKS_PER_SM // (batch * tiles), m // FUSED_MIN_KEYS))
    length = -(-m // splits)
    length = -(-length // FUSED_KEY_ALIGN) * FUSED_KEY_ALIGN
    return -(-m // length), length


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def nn_fused_planes(q: torch.Tensor, k: torch.Tensor):
    """K5: q (B, N, 3), k (B, M, 3) -> (dist1, idx1 (B, N); dist2, idx2 (B, M))."""
    _check(q, k)
    if q.device.type == "cpu" and k.device.type == "cpu":
        return nn_fused_planes_reference(q, k)
    _kernel_args("nn_fused_planes", q, k)
    b, n, m = q.shape[0], q.shape[1], k.shape[1]
    split = nn_fused_split(b, n, m, _sm_count(q.device))
    # both directions in one buffer each: (b, n) for the queries, then (b, m)
    dist = torch.empty(b * (n + m), dtype=torch.float32, device=q.device)
    idx = torch.empty(b * (n + m), dtype=torch.int32, device=q.device)
    words = torch.empty(b * (n + m), dtype=torch.int64, device=q.device)
    _launch("hpcd_nn_fused_planes", q, k, dist, idx, words, split=split)
    nn_fused_planes.launches += 1
    return (dist[:b * n].view(b, n), idx[:b * n].view(b, n),
            dist[b * n:].view(b, m), idx[b * n:].view(b, m))


nn_fused_planes.launches = 0


def chamfer_loss_grad(gts: torch.Tensor, preds: torch.Tensor):
    """K9: gts (B, N, 3), preds (B, M, 3) -> (loss (B,), grad_gts, grad_preds) fp32.

    The gradients are those of ``loss.sum()`` through the first argmins.
    CPU clouds of any float dtype are taken in fp32, as the TPU kernel
    casts; CUDA clouds must be fp32.
    """
    _check(gts, preds)
    if gts.device.type == "cpu" and preds.device.type == "cpu":
        return chamfer_loss_grad_reference(gts, preds)
    _kernel_args("chamfer_loss_grad", gts, preds)
    b = gts.shape[0]
    if b > 65535:
        raise ValueError(f"chamfer_loss_grad takes at most 65535 clouds, got {b}")
    n, m = gts.shape[1], preds.shape[1]
    split = nn_fused_split(b, n, m, _sm_count(gts.device))
    ga = torch.empty_like(gts)
    # grad_preds and the loss in one buffer, which the kernel's fill zeroes
    gb_loss = torch.empty(b * (3 * m + 1), dtype=torch.float32, device=gts.device)
    words = torch.empty(b * (n + m), dtype=torch.int64, device=gts.device)
    _launch("hpcd_chamfer_loss_grad", gts, preds, ga, gb_loss, words, split=split)
    chamfer_loss_grad.launches += 1
    return gb_loss[3 * b * m:], ga, gb_loss[:3 * b * m].view(b, m, 3)


chamfer_loss_grad.launches = 0


def nn_forward(a: torch.Tensor, b: torch.Tensor):
    """(dist1, idx1, dist2, idx2): K5 when N != M, else K1 once each way."""
    if a.shape[1] != b.shape[1]:
        return nn_fused_planes(a, b)
    dist1, idx1 = nn_one_direction(a, b)
    dist2, idx2 = nn_one_direction(b, a)
    return dist1, idx1, dist2, idx2


class _ChamferStreaming(torch.autograd.Function):
    """Chamfer sum under autograd: ``nn_forward`` forward, ``nn_backward`` backward."""

    @staticmethod
    def forward(ctx, gts, preds):
        d_gt, i_gt, d_pred, i_pred = nn_forward(gts, preds)
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
    K3 when no gradient is needed, else ``nn_forward`` (K1 twice, or K5
    when N != M) with the backward through the saved indices. Gradients
    differ from ``chamfer_loss``'s only at near-tied argmins, where both
    are valid subgradients.
    """
    _check(gts, preds)
    gts, preds = gts.contiguous(), preds.contiguous()
    if torch.is_grad_enabled() and (gts.requires_grad or preds.requires_grad):
        return _ChamferStreaming.apply(gts, preds)
    d_gt, d_pred = nn_min_fused(gts, preds)
    return d_gt.sum() + d_pred.sum()


class _ChamferFused(torch.autograd.Function):
    """Chamfer sum under autograd: K9 forward, the saved fields scaled backward."""

    @staticmethod
    def forward(ctx, gts, preds):
        loss, ga, gb = chamfer_loss_grad(gts, preds)
        ctx.save_for_backward(ga, gb)
        return loss.sum()

    @staticmethod
    def backward(ctx, g):
        ga, gb = ctx.saved_tensors
        want_a, want_b = ctx.needs_input_grad
        return g * ga if want_a else None, g * gb if want_b else None


def chamfer_loss_fused(gts: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """``chamfer_loss_streaming``'s value; under autograd from K9 in one pass.

    With no gradient needed it is ``chamfer_loss_streaming`` (K3). Under
    autograd the forward launches K9 once and keeps both gradient fields;
    the backward multiplies them by the cotangent. The JAX package keeps it
    off its training loss (slower than the streaming value and gradient on
    v5e); on the card ``chamfer_loss_auto`` takes it where
    ``chamfer_grad_route`` says "k9".
    """
    _check(gts, preds)
    gts, preds = gts.contiguous(), preds.contiguous()
    if torch.is_grad_enabled() and (gts.requires_grad or preds.requires_grad):
        return _ChamferFused.apply(gts, preds)
    return chamfer_loss_streaming(gts, preds)


def pallas_shapes_ok(n: int, m: int) -> bool:
    """The JAX package's streaming gate: both point counts multiples of 128."""
    return n % 128 == 0 and m % 128 == 0


def chamfer_grad_route(gts, preds) -> str:
    """The route ``chamfer_loss_auto`` takes: "k9", "streaming" or "plain".

    Decided from the clouds' device type, dtype, point counts and whether a
    gradient is needed, before any launch (the arguments may be anything
    with ``device``, ``dtype``, ``shape`` and ``requires_grad``):

    * "plain" (``ops/chamfer.py::chamfer_loss``): clouds not both fp32
      (fp64 is the trajectory-parity mode), and CPU clouds whose point
      counts are not both multiples of 128: the JAX package's gate.
    * "streaming" (``chamfer_loss_streaming``): other CPU clouds (the
      kernels' plain versions, as the JAX package's streaming path); CUDA
      clouds with no gradient needed (K3 once); and CUDA clouds under
      ``torch.are_deterministic_algorithms_enabled()``, since K9 sums both
      gradient fields with fp32 ``atomicAdd``s and two runs of one step may
      differ in the last bits, while the streaming backward's ``index_add_``
      is deterministic under that setting. This follows the caller's
      explicit setting; it is no fallback: a K9 that fails to build or
      launch raises.
    * "k9" (``chamfer_loss_fused``: one K9 launch a loss, the saved fields
      scaled in the backward): fp32 CUDA clouds under autograd otherwise.
      The JAX package keeps K9 off its training loss because it lost on
      v5e; on the H100 it wins at every shape measured. Value and gradient
      at B=64 through ``train/losses.py::reconstruction_loss``, ms a call,
      the two routes in turns (A B B A, twice) in one process on an NVIDIA
      H100 80GB HBM3 at 700.00 W (``chip_smoke.py`` phase 27):

      ==================  ===========  ====================================
      points (gt x pred)  K9           K1 twice, or K5, + the K2 backward
      ==================  ===========  ====================================
      2048 x 2048         0.299-0.394  0.643-0.876
      2048 x 1024         0.217-0.404  0.634-0.875
      ==================  ===========  ====================================
    """
    if gts.dtype != torch.float32 or preds.dtype != torch.float32:
        return "plain"
    if gts.device.type == "cpu" and preds.device.type == "cpu":
        return "streaming" if pallas_shapes_ok(gts.shape[1], preds.shape[1]) else "plain"
    if (torch.is_grad_enabled() and (gts.requires_grad or preds.requires_grad)
            and not torch.are_deterministic_algorithms_enabled()):
        return "k9"
    return "streaming"


def chamfer_loss_auto(gts: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """The training loss's Chamfer sum, through ``chamfer_grad_route``'s
    route; ``chamfer_loss_auto.route`` keeps the last route taken."""
    route = chamfer_grad_route(gts, preds)
    chamfer_loss_auto.route = route
    if route == "k9":
        return chamfer_loss_fused(gts, preds)
    if route == "streaming":
        return chamfer_loss_streaming(gts, preds)
    return chamfer_loss(gts, preds)


chamfer_loss_auto.route = None


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
    """``nn_distance`` from ``nn_forward``; backward through the indices (K2)."""

    @staticmethod
    def forward(ctx, a, b):
        dist1, idx1, dist2, idx2 = nn_forward(a, b)
        ctx.save_for_backward(a, b, idx1, idx2)
        ctx.mark_non_differentiable(idx1, idx2)
        return dist1, idx1, dist2, idx2

    @staticmethod
    def backward(ctx, g1, _gi1, g2, _gi2):
        a, b, idx1, idx2 = ctx.saved_tensors
        return nn_backward(a, b, idx1, idx2, g1, g2)


def nn_distance_pallas(a: torch.Tensor, b: torch.Tensor):
    """``ops/chamfer.py::nn_distance`` from the kernels: (dist1, idx1, dist2, idx2).

    The forward is ``nn_forward`` (K5 when N != M, K1 twice when N == M; the
    plain versions for CPU clouds), the backward ``nn_backward`` through the
    first argmins. Only the distances carry gradients.
    """
    _check(a, b)
    return _NNDistanceKernels.apply(a.contiguous(), b.contiguous())


def nn_distance_auto(a: torch.Tensor, b: torch.Tensor):
    """``nn_distance_pallas`` for CUDA clouds, the matrix form for CPU ones."""
    if _metric_kernels(a, b):
        return nn_distance_pallas(a, b)
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
