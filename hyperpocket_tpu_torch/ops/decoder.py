"""Fused per-sample target-network decode (K10): the CUDA kernels and their plain version.

Counterpart of ``hyperpocket_tpu/ops/pallas_decoder.py``. Each sample's MLP
``3 -> layer_out_channels... -> 3`` is sliced from its row of the
hypernetwork's flat weight vector (per layer a row-major (out, in) block,
then the bias when there is one, the layout of
``models/target_network.py``) and run on its points, with ReLU after every
layer but the last. ``decode_batch`` is the custom op
``hyperpocket::decode_batch``: its CUDA kernel launches
``csrc/decode_batch_tc.cu`` (bf16 on the tensor cores, hidden layers up to
256 channels) or ``csrc/decode_batch.cu`` (the CUDA cores: fp32, and the
bf16 widths the tensor-core kernel cannot hold), chosen from the widths
before any launch, and raises on anything else (more than ``MAX_LAYERS``
layers, a layer wider than ``MAX_WIDTH``: ``takes_widths``, by which the
model sends such decoders to the ``bmm`` chain); its CPU kernel runs
``decode_batch_reference``, and its fake kernel gives the points' shape, so
that ``torch.export`` keeps K10 as one node of an exported serving program.
All accumulate in fp32 and round each layer to the points' dtype in one of
two ways (``round_product``): false is the TPU kernel's arithmetic (the
first layer sums from the bias, the others add it in fp32, one rounding a
layer), the default of direct calls; true is the JAX model's ``bmm`` chain
(the product rounded, then the sum with the bias), which the model's
inference forward (``models/full_model.py``) asks for. Forward only, as in
the JAX package: the training forward decodes through the chain of
``models/target_network.py``. ``decode_batch.launches`` counts kernel
launches, ``decode_batch.launches_bf16_simt`` those of bf16 widths on the
CUDA-core kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from hyperpocket_tpu_torch.ops._build import library
from hyperpocket_tpu_torch.ops.nn import _sm_count

MAX_WIDTH = 4096  # channels a layer may have on the card
MAX_LAYERS = 16  # layers the card's kernels take
_MAX_SHARED_BYTES = 227 * 1024  # dynamic shared memory a block may have on the H100
_BF16_BLOCKS_PER_SM = 2  # bf16 blocks resident on an SM (~200 registers x 128 threads, 82 KB)
_SIMT_BLOCKS_PER_SM = 1  # CUDA-core blocks an SM holds: 256 threads at 211-254 registers


def _widths(layer_out_channels) -> list[int]:
    return [3, *(int(c) for c in layer_out_channels), 3]


def _flat_width(ch: list[int], use_bias: bool) -> int:
    """Values a flat row holds for the channel counts ``ch`` (3 first and last)."""
    return sum(i * o + (o if use_bias else 0) for i, o in zip(ch[:-1], ch[1:]))


def split_flat_weights(flat_weights: torch.Tensor, layer_out_channels, use_bias: bool):
    """(B, W) flat rows -> per-layer ((B, in, out) weights, (B, 1, out) biases).

    The weights come back transposed to (in, out); without ``use_bias`` the
    biases are zeros. Raises when the widths do not consume exactly W values.
    """
    ch = _widths(layer_out_channels)
    need = _flat_width(ch, use_bias)
    if need != flat_weights.shape[1]:
        raise ValueError(f"flat weight vector not fully consumed: the layers take {need} "
                         f"values, the vector holds {flat_weights.shape[1]}")
    b = flat_weights.shape[0]
    ws, bs = [], []
    offset = 0
    for in_ch, out_ch in zip(ch[:-1], ch[1:]):
        w = flat_weights[:, offset:offset + out_ch * in_ch]
        offset += out_ch * in_ch
        ws.append(w.reshape(b, out_ch, in_ch).transpose(1, 2))
        if use_bias:
            bs.append(flat_weights[:, offset:offset + out_ch].reshape(b, 1, out_ch))
            offset += out_ch
        else:
            bs.append(flat_weights.new_zeros((b, 1, out_ch)))
    return ws, bs


def _check(flat_weights: torch.Tensor, points: torch.Tensor) -> None:
    if flat_weights.ndim != 2 or points.ndim != 3 or points.shape[2] != 3:
        raise ValueError(f"expected flat weights (B, W) and points (B, N, 3), got "
                         f"{tuple(flat_weights.shape)} and {tuple(points.shape)}")
    if flat_weights.shape[0] != points.shape[0]:
        raise ValueError(f"batch sizes differ: {flat_weights.shape[0]} and {points.shape[0]}")


def decode_batch_reference(flat_weights: torch.Tensor, points: torch.Tensor,
                           layer_out_channels, use_bias: bool = True,
                           round_product: bool = False) -> torch.Tensor:
    """Plain version of K10: (B, W) x (B, N, 3) -> (B, N, 3) in the points' dtype.

    ``round_product`` false is the TPU kernel's arithmetic: each layer's fp32
    sum (the first layer's started from the bias, the others' bias added in
    fp32) rounded once to the points' dtype. True is the JAX model's chain
    (``models/target_network.py``): every layer's fp32 dot rounded, the bias
    added and the sum rounded again.
    """
    _check(flat_weights, points)
    dtype = points.dtype
    ws, bs = split_flat_weights(flat_weights.to(dtype), layer_out_channels, use_bias)

    def finish(acc, b, relu):
        h = (acc.to(dtype) + b).to(dtype) if round_product else (acc + b.float()).to(dtype)
        return torch.relu(h) if relu else h

    x = points.float()
    w0 = ws[0].float()
    # the input layer elementwise, one coordinate at a time
    acc = torch.zeros_like(bs[0], dtype=torch.float32) if round_product else bs[0].float()
    for c in range(3):
        acc = acc + x[..., c:c + 1] * w0[:, c:c + 1, :]
    if round_product:
        h = finish(acc, bs[0], len(ws) > 1)
    else:
        h = (torch.relu(acc) if len(ws) > 1 else acc).to(dtype)
    for li, (w, b) in enumerate(zip(ws[1:], bs[1:]), start=1):
        h = finish(torch.bmm(h.float(), w.float()), b, li < len(ws) - 1)
    return h


def _channels(layer_out_channels) -> list[int]:
    return [int(c) for c in layer_out_channels]


@functools.cache
def _symbol(name: str, argtypes: tuple, restype):
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


_QUERY_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int)
_LAUNCH_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5


def takes_widths(layer_out_channels) -> bool:
    """Whether the card's kernels take these hidden widths: at most
    ``MAX_LAYERS`` layers of 1 to ``MAX_WIDTH`` channels (with the 3-channel
    input and output). ``models/full_model.py`` routes the inference decode
    by it when a model is built."""
    ch = _widths(layer_out_channels)
    return len(ch) - 1 <= MAX_LAYERS and max(ch) <= MAX_WIDTH and min(ch) >= 1


class _Plan(NamedTuple):
    """What a launch for some widths needs, computed once."""
    widths: ctypes.Array   # the channel counts as a C array
    n_layers: int
    flat: int              # the flat row's length
    route: str             # "tc": decode_batch_tc.cu; "simt": decode_batch.cu
    quantum: int           # a block's tile is a multiple of this many points
    blocks_per_sm: int     # blocks an SM holds, for the tile choice


@functools.cache
def _plan(channels: tuple, use_bias: bool, bf16: bool) -> _Plan:
    """The kernel for these widths and its tile quantum, chosen from the
    widths alone: bf16 runs the tensor-core kernel where it holds the
    widths, else (wider bf16 layers, and every fp32 width) the CUDA-core
    kernel. Raises for more than ``MAX_LAYERS`` layers or a layer wider than
    ``MAX_WIDTH`` channels. Builds the kernels' library."""
    ch = _widths(channels)
    if not takes_widths(channels):
        raise ValueError(f"decode_batch takes at most {MAX_LAYERS} layers of 1 to {MAX_WIDTH} "
                         f"channels, got the widths {ch}")
    widths = (ctypes.c_int * len(ch))(*ch)
    args = (ctypes.addressof(widths), len(ch) - 1, int(use_bias))
    flat = _flat_width(ch, use_bias)
    if bf16:
        need = _symbol("hpcd_decode_batch_bf16_smem_bytes", _QUERY_ARGS, ctypes.c_longlong)(*args)
        if 0 <= need <= _MAX_SHARED_BYTES:
            quantum = _symbol("hpcd_decode_batch_bf16_tile_quantum", _QUERY_ARGS,
                              ctypes.c_int)(*args)
            return _Plan(widths, len(ch) - 1, flat, "tc", quantum, _BF16_BLOCKS_PER_SM)
    sub_tile = ctypes.c_int()
    need = _symbol("hpcd_decode_batch_plan", _QUERY_ARGS + (ctypes.c_int, ctypes.c_void_p),
                   ctypes.c_longlong)(*args, 2 if bf16 else 4, ctypes.addressof(sub_tile))
    if need < 0:
        raise ValueError(f"decode_batch: the CUDA-core kernel cannot take the widths {ch}")
    return _Plan(widths, len(ch) - 1, flat, "simt", sub_tile.value, _SIMT_BLOCKS_PER_SM)


def tile_points(batch: int, n: int, quantum: int, sms: int,
                blocks_per_sm: int = _BF16_BLOCKS_PER_SM) -> int:
    """Points a block decodes, a multiple of ``quantum``: each sample is cut
    into as many tiles as keep the grid within one wave of ``blocks_per_sm``
    blocks on each of the card's ``sms`` SMs (one tile a sample from B >
    blocks_per_sm x sms on: each block stages its sample's weights once).
    Measured on the H100 (PERF.md): for bf16, one wave of about 2 blocks an
    SM beat the cut for 4."""
    tiles = max(1, sms * blocks_per_sm // batch)
    per_tile = -(-n // tiles)
    return max(quantum, -(-per_tile // quantum) * quantum)


def decode_batch(flat_weights: torch.Tensor, points: torch.Tensor, layer_out_channels,
                 use_bias: bool = True, round_product: bool = False) -> torch.Tensor:
    """K10: (B, W) flat weights x (B, N, 3) points -> (B, N, 3) in the points' dtype.

    With ``round_product`` the rounding of
    ``models/target_network.py::batched_target_network_forward`` (equal up to
    summation order), else the TPU kernel's (one rounding a layer). Calls
    the op ``hyperpocket::decode_batch``: CUDA points must be fp32 or bf16
    and the weights are taken in the points' dtype; CPU tensors run
    ``decode_batch_reference``.
    """
    _check(flat_weights, points)
    return torch.ops.hyperpocket.decode_batch(flat_weights, points,
                                              _channels(layer_out_channels), bool(use_bias),
                                              bool(round_product))


decode_batch.launches = 0
decode_batch.launches_bf16_simt = 0  # of them, bf16 widths on the CUDA-core kernel


@torch.library.custom_op("hyperpocket::decode_batch", mutates_args=(), device_types="cpu")
def _decode_batch_op(flat_weights: torch.Tensor, points: torch.Tensor,
                     layer_out_channels: list[int], use_bias: bool,
                     round_product: bool = False) -> torch.Tensor:
    return decode_batch_reference(flat_weights, points, layer_out_channels, use_bias,
                                  round_product)


@_decode_batch_op.register_kernel("cuda")
def _decode_batch_cuda(flat_weights: torch.Tensor, points: torch.Tensor,
                       layer_out_channels: list[int], use_bias: bool,
                       round_product: bool = False) -> torch.Tensor:
    _check(flat_weights, points)
    if points.device.type != "cuda" or flat_weights.device != points.device:
        raise ValueError(f"decode_batch runs on CUDA or CPU tensors on one device, got "
                         f"{flat_weights.device} and {points.device}")
    if points.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the decode kernel takes fp32 or bf16 points, got {points.dtype}")
    if min(points.shape[0], points.shape[1]) == 0:
        raise ValueError(f"decode_batch takes at least one cloud of at least one point, got "
                         f"{tuple(points.shape)}")
    bf16 = points.dtype == torch.bfloat16
    plan = _plan(tuple(layer_out_channels), use_bias, bf16)
    if plan.flat != flat_weights.shape[1]:
        raise ValueError(f"flat weight vector not fully consumed: the layers take {plan.flat} "
                         f"values, the vector holds {flat_weights.shape[1]}")
    flat = flat_weights.to(points.dtype).contiguous()
    points = points.contiguous()
    out = torch.empty_like(points)
    batch, n = points.shape[:2]
    tile = tile_points(batch, n, plan.quantum, _sm_count(points.device), plan.blocks_per_sm)
    args = (flat.data_ptr(), points.data_ptr(), out.data_ptr(), ctypes.addressof(plan.widths),
            plan.n_layers, int(use_bias), batch, n, plan.flat)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        if plan.route == "tc":
            fn = _symbol("hpcd_decode_batch_bf16", _LAUNCH_ARGS + (ctypes.c_int,) * 2
                         + (ctypes.c_void_p,), ctypes.c_int)
            rc = fn(*args, tile, int(round_product), stream)
        else:
            fn = _symbol("hpcd_decode_batch", _LAUNCH_ARGS + (ctypes.c_int,) * 3
                         + (ctypes.c_void_p,), ctypes.c_int)
            rc = fn(*args, 2 if bf16 else 4, tile, int(round_product), stream)
    if rc != 0:
        raise RuntimeError(f"decode_batch kernel launch failed with CUDA error {rc}")
    decode_batch.launches += 1
    if bf16 and plan.route == "simt":
        decode_batch.launches_bf16_simt += 1
    return out


@_decode_batch_op.register_fake
def _decode_batch_fake(flat_weights: torch.Tensor, points: torch.Tensor,
                       layer_out_channels: list[int], use_bias: bool,
                       round_product: bool = False) -> torch.Tensor:
    _check(flat_weights, points)
    return torch.empty_like(points)
