"""Fused per-sample target-network decode (K10): the CUDA kernel and its plain version.

Counterpart of ``hyperpocket_tpu/ops/pallas_decoder.py``. Each sample's MLP
``3 -> layer_out_channels... -> 3`` is sliced from its row of the
hypernetwork's flat weight vector (per layer a row-major (out, in) block,
then the bias when there is one, the layout of
``models/target_network.py``) and run on its points, with ReLU after every
layer but the last. ``decode_batch`` takes ``csrc/decode_batch.cu`` for
CUDA tensors (or raises) and ``decode_batch_reference`` for CPU tensors.
Both follow the TPU kernel's arithmetic: fp32 accumulation, the bias added
in fp32 (the first layer starts from it), and each layer's output rounded
once to the points' dtype. Forward only, as in the JAX package; the model's
own decode stays the ``bmm`` chain of ``models/target_network.py``.
``decode_batch.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hyperpocket_tpu_torch.ops._build import library

_MAX_SHARED_BYTES = 227 * 1024  # dynamic shared memory a block may have on the H100

def _widths(layer_out_channels) -> list[int]:
    return [3, *(int(c) for c in layer_out_channels), 3]


def split_flat_weights(flat_weights: torch.Tensor, layer_out_channels, use_bias: bool):
    """(B, W) flat rows -> per-layer ((B, in, out) weights, (B, 1, out) biases).

    The weights come back transposed to (in, out); without ``use_bias`` the
    biases are zeros. Raises when the widths do not consume exactly W values.
    """
    ch = _widths(layer_out_channels)
    need = sum(i * o + (o if use_bias else 0) for i, o in zip(ch[:-1], ch[1:]))
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


@functools.cache
def _kernel():
    fn = library().hpcd_decode_batch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _smem_bytes_fn():
    fn = library().hpcd_decode_batch_smem_bytes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn


def decode_batch(flat_weights: torch.Tensor, points: torch.Tensor, layer_out_channels,
                 use_bias: bool = True) -> torch.Tensor:
    """K10: (B, W) flat weights x (B, N, 3) points -> (B, N, 3) in the points' dtype.

    Equal to ``models/target_network.py::batched_target_network_forward`` up
    to summation order (the same per-layer rounding in bf16). CUDA points
    must be fp32 or bf16; the weights are taken in the points' dtype.
    """
    _check(flat_weights, points)
    if points.device.type == "cpu" and flat_weights.device.type == "cpu":
        return decode_batch_reference(flat_weights, points, layer_out_channels, use_bias)
    if points.device.type != "cuda" or flat_weights.device != points.device:
        raise ValueError(f"decode_batch runs on CUDA or CPU tensors on one device, got "
                         f"{flat_weights.device} and {points.device}")
    if points.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the decode kernel takes fp32 or bf16 points, got {points.dtype}")
    split_flat_weights(flat_weights, layer_out_channels, use_bias)  # views; checks the width
    ch = _widths(layer_out_channels)
    if min(points.shape[0], points.shape[1]) == 0:
        raise ValueError(f"decode_batch takes at least one cloud of at least one point, got "
                         f"{tuple(points.shape)}")
    widths = (ctypes.c_int * len(ch))(*ch)
    need = _smem_bytes_fn()(ctypes.addressof(widths), len(ch) - 1, int(use_bias))
    if need < 0 or need > _MAX_SHARED_BYTES:
        raise ValueError(f"decode_batch: widths {ch} need {need} bytes of shared memory per "
                         f"block, above {_MAX_SHARED_BYTES}")
    flat = flat_weights.to(points.dtype).contiguous()
    points = points.contiguous()
    out = torch.empty_like(points)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = _kernel()(flat.data_ptr(), points.data_ptr(), out.data_ptr(),
                       ctypes.addressof(widths), len(ch) - 1, int(use_bias),
                       int(points.dtype == torch.bfloat16), points.shape[0], points.shape[1],
                       flat.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"decode_batch kernel launch failed with CUDA error {rc}")
    decode_batch.launches += 1
    return out


decode_batch.launches = 0
