"""Fused encoder trunk + max-pool: the CUDA kernels and their plain versions.

Counterparts of ``hyperpocket_tpu/ops/pallas_encoder.py``:

* ``trunk_pooled`` (K4): x (B, N, 3) bf16 and the encoder's five pointwise
  layers -> (B, 512) bf16, the max over points of the five-layer stack,
  with bf16 rounding after every layer;
* ``trunk_pooled_argmax`` (K8): the same pooled values and, per channel,
  the first point where the maximum is reached, (B, 512) int32 — the
  training forward, whose backward routes each channel's cotangent to that
  point.

Both kernels are ``csrc/trunk_pool.cu`` (its header says how it is laid out
on the H100); ``trunk_pooled_reference`` and
``trunk_pooled_argmax_reference`` are the same arithmetic in plain PyTorch.
K4 is registered as the custom op ``hyperpocket::trunk_pooled`` (x and flat
weight and bias lists; its CUDA kernel launches K4, its CPU kernel runs the
plain version, its fake kernel gives the (B, 512) bf16 shape), which
``torch.export`` keeps as one node of an exported serving program.

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


def _stack_reference(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """The five layers with the kernels' arithmetic: (B, N, 512) bf16.

    Layer 1 adds the three products to the bias one at a time, as the kernels
    do; layers 2-5 are an fp32 matmul plus the fp32 bias. ReLU follows
    layers 1-4; every layer's output is rounded to bf16.
    """
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
    return h


def trunk_pooled_reference(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: the max over points, taken in fp32, stored as bf16."""
    _check(layers, x)
    return _stack_reference(layers, x).float().amax(dim=1).to(torch.bfloat16)


def trunk_pooled_argmax_reference(layers: Layers, x: torch.Tensor):
    """Plain version of K8: (pooled (B, 512) bf16, first argmax (B, 512) int32).

    ``torch.max`` over points returns the first index of equal maxima.
    """
    _check(layers, x)
    pooled, idx = torch.max(_stack_reference(layers, x).float(), dim=1)
    return pooled.to(torch.bfloat16), idx.int()


@functools.cache
def _kernel(symbol: str, n_pointers: int):
    fn = getattr(library(), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_alignment(args: list[torch.Tensor]) -> None:
    """Raise on layer tensors the kernels cannot read, ``args`` being
    [w1, b1, ..., w5, b5]: the weights of layers 2-5 reach shared memory by
    TMA, which takes 16-byte aligned rows; the rest are read in 4-byte words."""
    for i, t in enumerate(args):
        layer, is_bias = divmod(i, 2)
        align = 4 if is_bias or layer == 0 else 16
        if t.data_ptr() % align:
            name = "bias" if is_bias else "weight"
            raise ValueError(f"the trunk kernel takes a {align}-byte aligned layer {layer + 1} "
                             f"{name}, got address {t.data_ptr():#x}")


def _kernel_operands(layers: Layers, x: torch.Tensor) -> list[torch.Tensor]:
    """The layers as contiguous bf16 tensors on x's device; raise on what the kernels refuse."""
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
            args.append(t)
    _check_alignment(args)
    return args


def _launch(symbol: str, x: torch.Tensor, args: list[torch.Tensor],
            outs: list[torch.Tensor]) -> None:
    batch, n = x.shape[:2]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel(symbol, 1 + len(args) + len(outs))(
            x.data_ptr(), *(t.data_ptr() for t in args), *(t.data_ptr() for t in outs),
            batch, n, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} kernel launch failed with CUDA error {rc}")


def trunk_pooled(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """K4: x (B, N, 3) -> pooled features (B, 512) bf16.

    Calls the custom op ``hyperpocket::trunk_pooled`` with the layers as
    flat weight and bias lists (an absent bias as zeros), so that
    ``torch.export`` records K4 as one node that launches the kernel when
    the exported program runs. A CUDA tensor launches the kernel on the
    current stream (or raises); a CPU tensor runs
    ``trunk_pooled_reference``. ``trunk_pooled.launches`` counts kernel
    launches.
    """
    return torch.ops.hyperpocket.trunk_pooled(x, [w for w, _ in layers],
                                              [_bias(w, b) for w, b in layers])


trunk_pooled.launches = 0


@torch.library.custom_op("hyperpocket::trunk_pooled", mutates_args=(), device_types="cpu")
def _trunk_pooled_op(x: torch.Tensor, weights: list[torch.Tensor],
                     biases: list[torch.Tensor]) -> torch.Tensor:
    return trunk_pooled_reference(list(zip(weights, biases)), x)


@_trunk_pooled_op.register_kernel("cuda")
def _trunk_pooled_cuda(x: torch.Tensor, weights: list[torch.Tensor],
                       biases: list[torch.Tensor]) -> torch.Tensor:
    layers = list(zip(weights, biases))
    _check(layers, x)
    args = _kernel_operands(layers, x)
    shape = (x.shape[0], WIDTHS[-1])
    pooled = torch.empty(shape, dtype=torch.float32, device=x.device)
    out = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    _launch("hpcd_trunk_pool_bf16", x, args, [pooled, out])
    trunk_pooled.launches += 1
    return out


@_trunk_pooled_op.register_fake
def _trunk_pooled_fake(x: torch.Tensor, weights: list[torch.Tensor],
                       biases: list[torch.Tensor]) -> torch.Tensor:
    _check(list(zip(weights, biases)), x)
    return x.new_empty((x.shape[0], WIDTHS[-1]), dtype=torch.bfloat16)


def trunk_pooled_argmax(layers: Layers, x: torch.Tensor):
    """K8: x (B, N, 3) -> (pooled (B, 512) bf16, first argmax (B, 512) int32).

    A CUDA tensor launches the kernel on the current stream (or raises);
    a CPU tensor runs ``trunk_pooled_argmax_reference``.
    ``trunk_pooled_argmax.launches`` counts kernel launches.
    """
    _check(layers, x)
    if x.device.type == "cpu":
        return trunk_pooled_argmax_reference(layers, x)
    args = _kernel_operands(layers, x)
    shape = (x.shape[0], WIDTHS[-1])
    keys = torch.empty(shape, dtype=torch.int64, device=x.device)
    out = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    idx = torch.empty(shape, dtype=torch.int32, device=x.device)
    _launch("hpcd_trunk_pool_argmax_bf16", x, args, [keys, out, idx])
    trunk_pooled_argmax.launches += 1
    return out, idx


trunk_pooled_argmax.launches = 0
