"""Adam with low-precision moments, one pass a tensor: the CUDA kernel and its plain version.

The update of ``train/optim.py::AdamLowp``, the JAX package's
``scale_by_adam_lowp`` (``hyperpocket_tpu/train/optim.py``) chained with
``-lr`` and Adam's or AdamW's weight decay. In JAX it is XLA inside the
jitted step, as the NN backward (K2) is; it is not a TPU kernel. The plain
version ``adam_lowp_update_reference`` is the per-tensor torch arithmetic
``AdamLowp`` ran before the kernel, about 20 elementwise kernels a tensor;
``csrc/adam_lowp.cu`` computes the same arithmetic in one pass (its
header gives the formula and the rounding of each step), so on the card
the two agree bit for bit.

``bc1`` and ``bc2`` (``1 - b^count`` in fp32) are device scalars that the
caller computes with torch's ops from its on-device count; the kernel reads
them through pointers, so a captured step replays with each replay's count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hyperpocket_tpu_torch.ops._build import library
from hyperpocket_tpu_torch.utils import profiling

# the dtype codes of csrc/adam_lowp.cu
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@torch.no_grad()
def adam_lowp_update_reference(p, g, mu, nu, bc1, bc2, *, lr: float, b1: float, b2: float,
                               eps: float, weight_decay: float = 0.0, decoupled: bool = False):
    """One step of ``scale_by_adam_lowp`` and ``-lr`` on one tensor, in place.

    ``mu`` and ``nu`` are computed in ``g``'s dtype from the stored values
    and rounded to their own dtype on store; the update reads the stored
    moments in fp32. ``decoupled`` selects AdamW's decay (added to the
    update) over Adam's (added to the gradient). Returns p, mu and nu.
    """
    f32 = torch.float32
    if weight_decay and not decoupled:
        g = g + weight_decay * p
    mu.copy_(b1 * mu.to(g.dtype) + (1 - b1) * g)
    nu.copy_(b2 * nu.to(g.dtype) + (1 - b2) * g * g)
    update = (mu.to(f32) / bc1) / (torch.sqrt(nu.to(f32) / bc2) + eps)
    if weight_decay and decoupled:
        update = update + weight_decay * p
    p.add_((-lr * update).to(p.dtype))
    return p, mu, nu


@functools.cache
def _kernel():
    fn = library().hpcd_adam_lowp
    # c_float rounds each Python scalar to fp32, as torch's CUDA kernels read
    # one for fp32, bf16 and fp16 tensors alike
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float] * 7 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def adam_lowp_update(p, g, mu, nu, bc1, bc2, *, lr: float, b1: float, b2: float, eps: float,
                     weight_decay: float = 0.0, decoupled: bool = False):
    """One step of Adam with low-precision moments on one tensor, in place.

    CPU tensors run ``adam_lowp_update_reference``. CUDA tensors launch
    ``csrc/adam_lowp.cu`` once on the current stream, or raise: p and g
    fp32, bf16 or fp16 of one dtype, mu and nu of one dtype among the same
    three, all contiguous, of one shape, on one device with the fp32
    scalars bc1 and bc2. ``adam_lowp_update.launches`` counts kernel
    launches. Under a profiler the values updated are counted into
    ``utils/profiling.py``'s totals as ``adam_lowp.values`` (``tally``: in a
    scanned epoch once a call, at the capture of the step or, where the
    call replays a kept graph, from what its capture collected). Returns
    p, mu and nu.
    """
    profiling.tally("adam_lowp.values", p.numel())
    tensors = (p, g, mu, nu, bc1, bc2)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, decoupled=decoupled)
    if all(t.device.type == "cpu" for t in tensors):
        return adam_lowp_update_reference(p, g, mu, nu, bc1, bc2, **kw)
    if p.device.type != "cuda" or any(t.device != p.device for t in tensors):
        raise ValueError("adam_lowp_update runs on CUDA or CPU tensors on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if (g.dtype != p.dtype or mu.dtype != nu.dtype or p.dtype not in _KINDS
            or mu.dtype not in _KINDS):
        raise ValueError("the adam_lowp kernel takes p and g of one dtype and mu and nu of one "
                         "dtype, each fp32, bf16 or fp16; got p "
                         f"{p.dtype}, g {g.dtype}, mu {mu.dtype}, nu {nu.dtype}")
    if bc1.dtype != torch.float32 or bc2.dtype != torch.float32 or bc1.numel() != 1 \
            or bc2.numel() != 1:
        raise ValueError("the adam_lowp kernel takes bc1 and bc2 as fp32 scalars")
    if not all(t.shape == p.shape and t.is_contiguous() for t in (g, mu, nu)) \
            or not p.is_contiguous():
        raise ValueError("the adam_lowp kernel updates contiguous p, mu and nu of g's shape in "
                         f"place; got shapes {[tuple(t.shape) for t in (p, g, mu, nu)]}")
    if p.numel() == 0:
        return p, mu, nu
    decay = bool(weight_decay)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = _kernel()(
            p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), bc1.data_ptr(),
            bc2.data_ptr(), b1, 1 - b1, b2, 1 - b2, weight_decay, eps, -lr,
            int(decay and not decoupled),
            int(decay and decoupled), p.numel(), _KINDS[p.dtype], _KINDS[mu.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"adam_lowp kernel launch failed with CUDA error {rc}")
    adam_lowp_update.launches += 1
    return p, mu, nu


adam_lowp_update.launches = 0
