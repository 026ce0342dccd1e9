"""Approximate Earth Mover's Distance, with kernels K6 and K7.

Port of ``hyperpocket_tpu/ops/emd.py`` and of the two TPU kernels of
``hyperpocket_tpu/ops/pallas_emd.py``:

* ``approx_match``: the 9 soft-matching rounds of ``approxmatch.cu`` at
  temperatures ``-4^j``, j = 7..-1, with row and column budgets from C
  integer division, returning the (B, N, M) match.
* ``_streaming_cost``: the same rounds accumulating ``sum(match * |x - y|)``
  without carrying the match; distances through
  ``ops/chamfer.py::batch_pairwise_sqdist``. The plain forward.
* ``_match_cost_bwd_plain``: the match recomputed in chunks of 16 pairs and
  the ``matchcostgrad`` formulas, ``rsqrt(max(d^2, 1e-20))``. The plain
  backward.
* ``match_cost_fwd_kernel`` (K6, ``csrc/emd_match_cost.cu``) and
  ``match_cost_bwd_kernel`` (K7, ``csrc/emd_match_cost_grad.cu``): the rounds
  in one block per cloud pair, recomputing every distance. K7 sums
  ``wd * (x_i - y_j)`` pair by pair, where the plain backward and the TPU
  kernel factor it as ``x * sum(wd) - sum(wd * y)``; the factored form
  cancels where points nearly coincide (see the CUDA source). Their plain
  versions ``match_cost_fwd_reference`` / ``match_cost_bwd_reference`` do the
  same arithmetic on tensors (distances from ``ops/nn.py::_sqdist_reference``,
  per-element products as the kernels form them) in chunks over the batch;
  the tests and ``chip_smoke.py`` hold the kernels to them. A wrapper runs the
  plain version for a CPU tensor; for a CUDA tensor it launches its kernel or
  raises. ``<wrapper>.launches`` counts kernel launches.
* ``match_cost``: an ``autograd.Function`` whose route follows the device:
  CPU tensors take the plain forward and backward (any float dtype, fp64
  included), CUDA tensors K6 and K7 (fp32 only; anything else raises). The
  JAX package's further gates, B >= 16 and point counts multiples of 128,
  bound Mosaic's compile cost and fit the TPU's lane layout; the CUDA
  kernels have neither cost, so the port does not carry them over.
* ``earth_mover_distance``: ``match_cost / N`` per pair; equal point counts
  only. On the CPU in chunks of at most 300 pairs, the JAX package's bound
  on the plain route's (B, N, M) buffers; K6 keeps no such buffer and takes
  the whole batch in one launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hyperpocket_tpu_torch.ops._build import library
from hyperpocket_tpu_torch.ops.chamfer import batch_pairwise_sqdist
from hyperpocket_tpu_torch.ops.nn import _sqdist_reference

# -4^j for j = 7..0, then -0.25 (approxmatch.cu:55-60)
_LEVELS = tuple(-(4.0 ** j) for j in range(7, -2, -1))
_BWD_CHUNK = 16  # pairs per chunk of the plain backward
_REFERENCE_CHUNK = 8  # pairs per chunk of the kernels' plain versions
# a block holds both clouds and the four budget vectors in shared memory
_MAX_SHARED_BYTES = 227 * 1024


def _match_multipliers(n: int, m: int) -> tuple[float, float]:
    """Row/column budgets with C integer-division semantics (approxmatch.cu:36-42)."""
    if n >= m:
        return 1.0, float(n // m)
    return float(m // n), 1.0


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.ndim != 3 or y.ndim != 3 or x.shape[2] != 3 or y.shape[2] != 3:
        raise ValueError(f"expected clouds (B, N, 3) and (B, M, 3), got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"batch sizes differ: {x.shape[0]} and {y.shape[0]}")


def _round(kern, remain_l, remain_r):
    """One round's ratio_l, sumr, ratio_r and the new remain_r from ``kern`` (B, N, M)."""
    ratio_l = remain_l / (torch.einsum("bnm,bm->bn", kern, remain_r) + 1e-9)
    sumr = torch.einsum("bnm,bn->bm", kern, ratio_l) * remain_r
    ratio_r = torch.clamp_max(remain_r / (sumr + 1e-9), 1.0) * remain_r
    return ratio_l, ratio_r, torch.clamp_min(remain_r - sumr, 0.0)


def _budgets(x, n: int, m: int):
    multi_l, multi_r = _match_multipliers(n, m)
    b = x.shape[0]
    return (torch.full((b, n), multi_l, dtype=x.dtype, device=x.device),
            torch.full((b, m), multi_r, dtype=x.dtype, device=x.device))


def approx_match(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Soft match between x (B, N, 3) and y (B, M, 3) -> (B, N, M)."""
    n, m = x.shape[1], y.shape[1]
    d2 = batch_pairwise_sqdist(x, y)
    remain_l, remain_r = _budgets(x, n, m)
    match = torch.zeros_like(d2)
    for level in _LEVELS:
        kern = torch.exp(level * d2)
        ratio_l, ratio_r, remain_r = _round(kern, remain_l, remain_r)
        w = kern * ratio_l[:, :, None] * ratio_r[:, None, :]
        match = match + w
        remain_l = torch.clamp_min(remain_l - w.sum(dim=2), 0.0)
    return match


def _cost_from_match(x, y, match):
    d2 = torch.clamp_min(batch_pairwise_sqdist(x, y), 0.0)
    return torch.sum(match * torch.sqrt(d2), dim=(1, 2))


def _streaming_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The 9 rounds accumulating the cost without carrying the match: (B,)."""
    n, m = x.shape[1], y.shape[1]
    d2 = batch_pairwise_sqdist(x, y)
    dist = torch.sqrt(torch.clamp_min(d2, 0.0))
    remain_l, remain_r = _budgets(x, n, m)
    cost = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
    for level in _LEVELS:
        kern = torch.exp(level * d2)
        ratio_l, ratio_r, remain_r = _round(kern, remain_l, remain_r)
        cost = cost + torch.einsum("bn,bn->b", ratio_l,
                                   torch.einsum("bnm,bm->bn", kern * dist, ratio_r))
        w_row = ratio_l * torch.einsum("bnm,bm->bn", kern, ratio_r)
        remain_l = torch.clamp_min(remain_l - w_row, 0.0)
    return cost


def _match_cost_bwd_chunk(x, y):
    match = approx_match(x, y)
    d2 = torch.clamp_min(batch_pairwise_sqdist(x, y), 1e-20)
    mt = match * torch.rsqrt(d2)
    gx = x * mt.sum(dim=2)[..., None] - torch.einsum("bnm,bmd->bnd", mt, y)
    gy = y * mt.sum(dim=1)[..., None] - torch.einsum("bnm,bnd->bmd", mt, x)
    return gx, gy


def _match_cost_bwd_plain(x: torch.Tensor, y: torch.Tensor):
    """``(gx, gy)`` for a unit cotangent, 16 pairs at a time."""
    parts = [_match_cost_bwd_chunk(x[s:s + _BWD_CHUNK], y[s:s + _BWD_CHUNK])
             for s in range(0, x.shape[0], _BWD_CHUNK)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


# ---------------------------------------------------------------------------
# K6 and K7 and their plain versions


def _rounds_reference(x, y, accumulate) -> None:
    """The kernels' rounds on tensors: ``accumulate(d, w, ratio_l)`` in phase C.

    ``w = exp(level * d) * ratio_r`` (B, N, M), without ratio_l, as the
    kernels form it; d from ``_sqdist_reference``, the kernels' arithmetic.
    """
    n, m = x.shape[1], y.shape[1]
    d = _sqdist_reference(x, y)
    remain_l, remain_r = _budgets(d, n, m)
    for level in _LEVELS:
        kern = torch.exp(level * d)
        ratio_l, ratio_r, remain_r = _round(kern, remain_l, remain_r)
        w = kern * ratio_r[:, None, :]
        accumulate(d, w, ratio_l)
        remain_l = torch.clamp_min(remain_l - w.sum(dim=2) * ratio_l, 0.0)


def _fwd_reference_chunk(x, y):
    cost = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)

    def accumulate(d, w, ratio_l):
        nonlocal cost
        cost = cost + ((w * torch.sqrt(d)).sum(dim=2) * ratio_l).sum(dim=1)

    _rounds_reference(x, y, accumulate)
    return cost


def _bwd_reference_chunk(x, y):
    x, y = x.float(), y.float()
    gx, gy = torch.zeros_like(x), torch.zeros_like(y)

    def accumulate(d, w, ratio_l):
        # each weight times its own difference, one coordinate at a time
        wd = w * ratio_l[:, :, None] * torch.rsqrt(torch.clamp_min(d, 1e-20))
        for c in range(3):
            t = wd * (x[:, :, None, c] - y[:, None, :, c])
            gx[..., c] += t.sum(dim=2)
            gy[..., c] -= t.sum(dim=1)

    _rounds_reference(x, y, accumulate)
    return gx, gy


def match_cost_fwd_reference(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: cost (B,) fp32, the kernel's arithmetic."""
    _check(x, y)
    return torch.cat([_fwd_reference_chunk(x[s:s + _REFERENCE_CHUNK], y[s:s + _REFERENCE_CHUNK])
                      for s in range(0, x.shape[0], _REFERENCE_CHUNK)])


def match_cost_bwd_reference(x: torch.Tensor, y: torch.Tensor):
    """Plain version of K7: ``(gx (B, N, 3), gy (B, M, 3))`` fp32 for a unit cotangent."""
    _check(x, y)
    parts = [_bwd_reference_chunk(x[s:s + _REFERENCE_CHUNK], y[s:s + _REFERENCE_CHUNK])
             for s in range(0, x.shape[0], _REFERENCE_CHUNK)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _kernel_args(name: str, x: torch.Tensor, y: torch.Tensor) -> None:
    """Raise on what the CUDA kernels do not take."""
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"{name} runs on CUDA or CPU tensors on one device, got "
                         f"{x.device} and {y.device}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(f"{name} takes fp32 clouds, got {x.dtype} and {y.dtype}")
    if min(x.shape[0], x.shape[1], y.shape[1]) == 0:
        raise ValueError(f"{name} takes at least one cloud of at least one point, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    shared = 24 * (x.shape[1] + y.shape[1])
    if shared > _MAX_SHARED_BYTES:
        raise ValueError(f"{name}: N + M = {x.shape[1] + y.shape[1]} needs {shared} bytes of "
                         f"shared memory per block, above {_MAX_SHARED_BYTES}")


@functools.cache
def _c_function(symbol: str, n_pointers: int):
    fn = getattr(library(), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(symbol: str, x: torch.Tensor, y: torch.Tensor, *outs: torch.Tensor) -> None:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _c_function(symbol, 2 + len(outs))(
            x.data_ptr(), y.data_ptr(), *(o.data_ptr() for o in outs),
            x.shape[0], x.shape[1], y.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} kernel launch failed with CUDA error {rc}")


def match_cost_fwd_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K6: x (B, N, 3), y (B, M, 3) -> cost (B,) fp32."""
    _check(x, y)
    if x.device.type == "cpu" and y.device.type == "cpu":
        return match_cost_fwd_reference(x, y)
    _kernel_args("match_cost_fwd_kernel", x, y)
    x, y = x.contiguous(), y.contiguous()
    cost = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    _launch("hpcd_emd_match_cost", x, y, cost)
    match_cost_fwd_kernel.launches += 1
    return cost


match_cost_fwd_kernel.launches = 0


def match_cost_bwd_kernel(x: torch.Tensor, y: torch.Tensor):
    """K7: ``(gx (B, N, 3), gy (B, M, 3))`` fp32 for a unit cotangent."""
    _check(x, y)
    if x.device.type == "cpu" and y.device.type == "cpu":
        return match_cost_bwd_reference(x, y)
    _kernel_args("match_cost_bwd_kernel", x, y)
    x, y = x.contiguous(), y.contiguous()
    gx, gy = torch.empty_like(x), torch.empty_like(y)
    _launch("hpcd_emd_match_cost_grad", x, y, gx, gy)
    match_cost_bwd_kernel.launches += 1
    return gx, gy


match_cost_bwd_kernel.launches = 0


# ---------------------------------------------------------------------------
# the op


class _MatchCost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        ctx.kernels = not (x.device.type == "cpu" and y.device.type == "cpu")
        ctx.save_for_backward(x, y)
        return match_cost_fwd_kernel(x, y) if ctx.kernels else _streaming_cost(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        bwd = match_cost_bwd_kernel if ctx.kernels else _match_cost_bwd_plain
        gx, gy = bwd(x, y)
        g = g[:, None, None]
        return gx * g, gy * g


def match_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Approximate EMD ``sum(match * |x - y|)`` per cloud pair -> (B,).

    The gradient treats the match as a constant (``matchcostgrad``).
    """
    _check(x, y)
    return _MatchCost.apply(x, y)


def earth_mover_distance(sample: torch.Tensor, ref: torch.Tensor,
                         batch_size: int | None = None) -> torch.Tensor:
    """Normalised approximate EMD per pair, ``match_cost / N`` -> (B,).

    Requires equal point counts. On the CPU at most 300 pairs go to one
    ``match_cost`` call; on a card the whole batch (or ``batch_size`` pairs).
    """
    if sample.ndim == 2:
        sample = sample[None]
    if ref.ndim == 2:
        ref = ref[None]
    b, n = sample.shape[0], sample.shape[1]
    if ref.shape[1] != n:
        raise ValueError(f"EMD requires equal point counts, got {n} vs {ref.shape[1]}")
    if ref.shape[0] != b:
        raise ValueError(f"sample/ref batch mismatch: {b} vs {ref.shape[0]}")
    chunk = batch_size or b
    if sample.device.type == "cpu":
        chunk = min(chunk, 300)
    outs = [match_cost(sample[s:s + chunk], ref[s:s + chunk]) for s in range(0, b, chunk)]
    return torch.cat(outs) / float(n)
