"""Fused hypernetwork-head Adam update (K11): the CUDA kernel and its plain version.

Counterpart of ``hyperpocket_tpu/ops/pallas_head_adam.py``: one pass over
the head weight that forms its gradient from the trunk activations ``h``
(B, K) and the head-output cotangent ``dout`` (B, N), then applies Adam to
the weight and both moments in place. The port's head is an
``nn.Linear(K, N)``, so the weight and the moments are (N, K):
``dw = dout^T h``, never a transpose of the 156 MB weight. The kernel is
``csrc/head_adam.cu`` (its header says how it is laid out on the H100);
``head_adam_update_reference`` is the same arithmetic in plain PyTorch.

The six scalars come from ``adam_scalars`` with the step count after its
increment, as optax counts. Moments may be fp32 or bf16; their update runs
in fp32 and is rounded on store, and the weight's update uses the fp32
values before that rounding, as the TPU kernel does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hyperpocket_tpu_torch.ops._build import library


def adam_scalars(lr: float, b1: float, b2: float, eps: float, count: int) -> torch.Tensor:
    """fp32 ``[lr, b1, b2, eps, 1 - b1^t, 1 - b2^t]`` for ``head_adam_update``.

    ``count`` is the step number after the increment; the powers are taken
    in fp32.
    """
    f32 = torch.float32
    t = torch.tensor(float(count), dtype=f32)
    b1_, b2_ = torch.tensor(b1, dtype=f32), torch.tensor(b2, dtype=f32)
    return torch.stack([torch.tensor(lr, dtype=f32), b1_, b2_, torch.tensor(eps, dtype=f32),
                        1.0 - b1_ ** t, 1.0 - b2_ ** t])


def _check(h, dout, p, m, v, scalars) -> None:
    if h.ndim != 2 or dout.ndim != 2 or h.shape[0] != dout.shape[0]:
        raise ValueError(f"expected h (B, K) and dout (B, N), got {tuple(h.shape)} and "
                         f"{tuple(dout.shape)}")
    want = (dout.shape[1], h.shape[1])
    for name, t in (("p", p), ("m", m), ("v", v)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected (N, K) = {want}")
    if p.dtype != torch.float32:
        raise ValueError(f"the head weight p must be fp32, got {p.dtype}")
    if m.dtype != v.dtype or m.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"moments must share fp32 or bf16, got {m.dtype} and {v.dtype}")
    if tuple(scalars.shape) != (6,):
        raise ValueError(f"expected 6 Adam scalars, got shape {tuple(scalars.shape)}")


@torch.no_grad()
def head_adam_update_reference(h, dout, p, m, v, scalars):
    """Plain version of K11: ``torch.mm`` for dw, then the elementwise Adam in fp32.

    Updates p, m and v in place and returns them.
    """
    _check(h, dout, p, m, v, scalars)
    lr, b1, b2, eps, bc1, bc2 = scalars.to(device=p.device, dtype=torch.float32).unbind()
    dw = torch.mm(dout.to(h.dtype).float().T, h.float())
    m32 = b1 * m.float() + (1.0 - b1) * dw
    v32 = b2 * v.float() + (1.0 - b2) * dw * dw
    p.sub_(lr * ((m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)))
    m.copy_(m32)
    v.copy_(v32)
    return p, m, v


@functools.cache
def _kernel():
    fn = library().hpcd_head_adam
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def head_adam_update(h, dout, p, m, v, scalars):
    """K11: one Adam step of the head weight p (N, K) from h (B, K) and dout (B, N).

    p, m and v are updated in place and returned. A CUDA tensor launches the
    kernel on the current stream (or raises); CPU tensors run
    ``head_adam_update_reference``. ``dout`` is taken in ``h``'s dtype.
    ``head_adam_update.launches`` counts kernel launches.
    """
    _check(h, dout, p, m, v, scalars)
    tensors = (h, dout, p, m, v)
    if all(t.device.type == "cpu" for t in tensors):
        return head_adam_update_reference(h, dout, p, m, v, scalars)
    if any(t.device != p.device for t in tensors) or p.device.type != "cuda":
        raise ValueError("head_adam_update runs on CUDA or CPU tensors on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the head-Adam kernel takes fp32 or bf16 h, got {h.dtype}")
    dout = dout.to(h.dtype).contiguous()
    h = h.contiguous()
    if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
        raise ValueError("the head-Adam kernel updates contiguous p, m and v in place")
    if p.shape[1] % 4 or any(t.data_ptr() % 16 for t in (p, m, v)):
        raise ValueError("the head-Adam kernel needs K a multiple of 4 and 16-byte aligned "
                         "p, m and v")
    if h.shape[0] == 0:
        raise ValueError("the head-Adam kernel takes a batch of at least one row")
    lr, b1, b2, eps, bc1, bc2 = scalars.tolist()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = _kernel()(h.data_ptr(), dout.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
                       lr, b1, b2, eps, bc1, bc2, h.shape[0], p.shape[0], p.shape[1],
                       int(h.dtype == torch.bfloat16), int(m.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"head_adam kernel launch failed with CUDA error {rc}")
    head_adam_update.launches += 1
    return p, m, v


head_adam_update.launches = 0
