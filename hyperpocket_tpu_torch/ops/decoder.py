"""Fused per-sample target-network decode (K10): the CUDA kernels and their plain version.

Counterpart of ``hyperpocket_tpu/ops/pallas_decoder.py``. Each sample's MLP
``3 -> layer_out_channels... -> 3`` is sliced from its row of the
hypernetwork's flat weight vector (per layer a row-major (out, in) block,
then the bias when there is one, the layout of
``models/target_network.py``) and run on its points, with ReLU after every
layer but the last. ``decode_batch`` is the custom op
``hyperpocket::decode_batch``: its CUDA kernel launches
``csrc/decode_batch_tc.cu`` (bf16, tensor cores) or ``csrc/decode_batch.cu``
(fp32, CUDA cores) and raises on anything else, its CPU kernel runs
``decode_batch_reference``, and its fake kernel gives the points' shape, so
that ``torch.export`` keeps K10 as one node of an exported serving program.
All follow the TPU kernel's arithmetic: fp32 accumulation, the bias added
in fp32 (the first layer starts from it), and each layer's output rounded
once to the points' dtype. Forward only, as in the JAX package: the
model's inference forward decodes through the op
(``models/full_model.py``), its training forward through the ``bmm`` chain
of ``models/target_network.py``. ``decode_batch.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hyperpocket_tpu_torch.ops._build import library
from hyperpocket_tpu_torch.ops.nn import _sm_count

_MAX_SHARED_BYTES = 227 * 1024  # dynamic shared memory a block may have on the H100
_BF16_BLOCKS_PER_SM = 2  # bf16 blocks resident on an SM (~200 registers x 128 threads, 82 KB)


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
                           layer_out_channels, use_bias: bool = True) -> torch.Tensor:
    """Plain version of K10: (B, W) x (B, N, 3) -> (B, N, 3) in the points' dtype."""
    _check(flat_weights, points)
    dtype = points.dtype
    ws, bs = split_flat_weights(flat_weights.to(dtype), layer_out_channels, use_bias)
    ws, bs = [w.float() for w in ws], [b.float() for b in bs]
    x = points.float()
    # the input layer elementwise from the bias, one coordinate at a time
    acc = bs[0]
    for c in range(3):
        acc = acc + x[..., c:c + 1] * ws[0][:, c:c + 1, :]
    if len(ws) == 1:
        return acc.to(dtype)
    h = torch.relu(acc).to(dtype)
    for w, b in zip(ws[1:-1], bs[1:-1]):
        h = torch.relu(torch.bmm(h.float(), w) + b).to(dtype)
    return (torch.bmm(h.float(), ws[-1]) + bs[-1]).to(dtype)


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


@functools.cache
def _plan(channels: tuple, use_bias: bool, bf16: bool):
    """What a launch for these widths needs, computed once: (the channel
    counts as a C array, the layer count, the flat row's length, the shared
    memory a block needs or -1 when the kernel cannot take the widths, and
    the bf16 kernel's tile quantum). Builds the kernels' library."""
    ch = _widths(channels)
    widths = (ctypes.c_int * len(ch))(*ch)
    args = (ctypes.addressof(widths), len(ch) - 1, int(use_bias))
    prefix = "hpcd_decode_batch_bf16" if bf16 else "hpcd_decode_batch"
    need = _symbol(f"{prefix}_smem_bytes", _QUERY_ARGS, ctypes.c_longlong)(*args)
    quantum = (_symbol("hpcd_decode_batch_bf16_tile_quantum", _QUERY_ARGS, ctypes.c_int)(*args)
               if bf16 else 0)
    return widths, len(ch) - 1, _flat_width(ch, use_bias), need, quantum


def tile_points(batch: int, n: int, quantum: int, sms: int) -> int:
    """Points a bf16 block decodes, a multiple of ``quantum``: each sample
    is cut into as many tiles as keep the grid within one wave of
    ``_BF16_BLOCKS_PER_SM`` blocks on each of the card's ``sms`` SMs (one
    tile a sample from B > 2 sms on: each block stages its sample's weights
    once). Measured on the H100 (PERF.md): one wave of about 2 blocks an SM
    beat the cut for 4."""
    tiles = max(1, sms * _BF16_BLOCKS_PER_SM // batch)
    per_tile = -(-n // tiles)
    return max(quantum, -(-per_tile // quantum) * quantum)


def decode_batch(flat_weights: torch.Tensor, points: torch.Tensor, layer_out_channels,
                 use_bias: bool = True) -> torch.Tensor:
    """K10: (B, W) flat weights x (B, N, 3) points -> (B, N, 3) in the points' dtype.

    Equal to ``models/target_network.py::batched_target_network_forward`` up
    to summation order and rounding: one bf16 rounding per layer, where the
    chain rounds the product and then the sum with the bias. Calls the op
    ``hyperpocket::decode_batch``: CUDA points must be fp32 or bf16 and the
    weights are taken in the points' dtype; CPU tensors run
    ``decode_batch_reference``.
    """
    _check(flat_weights, points)
    return torch.ops.hyperpocket.decode_batch(flat_weights, points,
                                              _channels(layer_out_channels), bool(use_bias))


decode_batch.launches = 0


@torch.library.custom_op("hyperpocket::decode_batch", mutates_args=(), device_types="cpu")
def _decode_batch_op(flat_weights: torch.Tensor, points: torch.Tensor,
                     layer_out_channels: list[int], use_bias: bool) -> torch.Tensor:
    return decode_batch_reference(flat_weights, points, layer_out_channels, use_bias)


@_decode_batch_op.register_kernel("cuda")
def _decode_batch_cuda(flat_weights: torch.Tensor, points: torch.Tensor,
                       layer_out_channels: list[int], use_bias: bool) -> torch.Tensor:
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
    widths, n_layers, w, need, quantum = _plan(tuple(layer_out_channels), use_bias, bf16)
    if w != flat_weights.shape[1]:
        raise ValueError(f"flat weight vector not fully consumed: the layers take {w} "
                         f"values, the vector holds {flat_weights.shape[1]}")
    if need < 0 or need > _MAX_SHARED_BYTES:
        raise ValueError(f"decode_batch: widths {_widths(layer_out_channels)} need {need} bytes "
                         f"of shared memory per block, above {_MAX_SHARED_BYTES}"
                         + (" (or a layer wider than 256 channels)" if bf16 else ""))
    flat = flat_weights.to(points.dtype).contiguous()
    points = points.contiguous()
    out = torch.empty_like(points)
    batch, n = points.shape[:2]
    args = (flat.data_ptr(), points.data_ptr(), out.data_ptr(), ctypes.addressof(widths),
            n_layers, int(use_bias), batch, n, w)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        if bf16:
            fn = _symbol("hpcd_decode_batch_bf16", _LAUNCH_ARGS + (ctypes.c_int, ctypes.c_void_p),
                         ctypes.c_int)
            rc = fn(*args, tile_points(batch, n, quantum, _sm_count(points.device)), stream)
        else:
            fn = _symbol("hpcd_decode_batch", _LAUNCH_ARGS + (ctypes.c_void_p,), ctypes.c_int)
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"decode_batch kernel launch failed with CUDA error {rc}")
    decode_batch.launches += 1
    return out


@_decode_batch_op.register_fake
def _decode_batch_fake(flat_weights: torch.Tensor, points: torch.Tensor,
                       layer_out_channels: list[int], use_bias: bool) -> torch.Tensor:
    _check(flat_weights, points)
    return torch.empty_like(points)
