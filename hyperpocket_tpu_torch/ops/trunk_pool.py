"""Fused encoder trunk + max-pool: the CUDA kernel and its plain version.

Counterpart of ``hyperpocket_tpu/ops/pallas_encoder.py::trunk_pooled``: x
(B, N, 3) bf16 and the encoder's five pointwise layers -> (B, 512) bf16, the
max over points of the five-layer stack, with bf16 rounding after every
layer. The kernel is ``csrc/trunk_pool.cu`` (its header says how it is laid
out on the H100); ``trunk_pooled_reference`` is the same arithmetic in plain
PyTorch.

``layers`` is a sequence of ``(weight, bias)`` pairs in ``nn.Linear`` layout:
weight (out, in), bias (out,) or None.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from hyperpocket_tpu_torch.ops._build import library

WIDTHS = (3, 64, 128, 256, 512, 512)

Layers = Sequence[tuple[torch.Tensor, torch.Tensor | None]]


def _check(layers: Layers, x: torch.Tensor) -> None:
    if x.ndim != 3 or x.shape[2] != 3:
        raise ValueError(f"expected x of shape (B, N, 3), got {tuple(x.shape)}")
    if x.shape[1] % 8:
        raise ValueError(f"N={x.shape[1]} must be a multiple of 8 for the fused trunk kernel")
    if len(layers) != len(WIDTHS) - 1:
        raise ValueError(f"expected {len(WIDTHS) - 1} layers, got {len(layers)}")
    for i, (w, b) in enumerate(layers):
        want = (WIDTHS[i + 1], WIDTHS[i])
        if tuple(w.shape) != want:
            raise ValueError(f"layer {i} weight {tuple(w.shape)}, expected {want}")
        if b is not None and tuple(b.shape) != (WIDTHS[i + 1],):
            raise ValueError(f"layer {i} bias {tuple(b.shape)}, expected ({WIDTHS[i + 1]},)")


def _bias(w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    return b if b is not None else torch.zeros(w.shape[0], dtype=w.dtype, device=w.device)


def trunk_pooled_reference(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: fp32 math on bf16 operands, bf16 per layer.

    Layer 1 adds the three products to the bias one at a time, as the kernel
    does; layers 2-5 are an fp32 matmul plus the fp32 bias. ReLU follows
    layers 1-4. The max over points is taken in fp32 and stored as bf16.
    """
    _check(layers, x)
    bf16 = torch.bfloat16
    ws = [w.to(bf16).float() for w, _ in layers]
    bs = [_bias(w, b).to(bf16).float() for w, b in layers]
    xf = x.to(bf16).float()
    acc = bs[0].expand(*xf.shape[:2], -1)
    for k in range(3):
        acc = acc + xf[..., k : k + 1] * ws[0][:, k]
    h = torch.relu(acc).to(bf16)
    for i in range(1, len(ws)):
        a = torch.matmul(h.float(), ws[i].T) + bs[i]
        h = (torch.relu(a) if i < len(ws) - 1 else a).to(bf16)
    return h.float().amax(dim=1).to(bf16)


@functools.cache
def _kernel():
    fn = library().hpcd_trunk_pool_bf16
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def trunk_pooled(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """x (B, N, 3) -> pooled features (B, 512) bf16.

    A CUDA tensor launches the kernel on the current stream (or raises);
    a CPU tensor runs ``trunk_pooled_reference``. ``trunk_pooled.launches``
    counts kernel launches.
    """
    _check(layers, x)
    if x.device.type == "cpu":
        return trunk_pooled_reference(layers, x)
    if x.device.type != "cuda":
        raise ValueError(f"trunk_pooled runs on CUDA or CPU tensors, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the trunk kernel takes bf16 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the trunk kernel takes a contiguous x")
    if x.shape[0] == 0:
        raise ValueError("the trunk kernel takes a batch of at least one cloud")
    args = []
    for w, b in layers:
        for t in (w, _bias(w, b)):
            t = t.to(torch.bfloat16).contiguous()
            if t.device != x.device:
                raise ValueError(f"layer tensor on {t.device}, x on {x.device}")
            if t.data_ptr() % 4:
                raise ValueError("the trunk kernel reads layer tensors as 4-byte words")
            args.append(t)
    batch, n = x.shape[:2]
    pooled = torch.empty((batch, WIDTHS[-1]), dtype=torch.float32, device=x.device)
    out = torch.empty((batch, WIDTHS[-1]), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel()(x.data_ptr(), *(t.data_ptr() for t in args), pooled.data_ptr(),
                       out.data_ptr(), batch, n, stream)
    if rc != 0:
        raise RuntimeError(f"trunk_pool kernel launch failed with CUDA error {rc}")
    trunk_pooled.launches += 1
    return out


trunk_pooled.launches = 0
