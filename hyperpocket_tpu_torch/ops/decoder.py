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
inference forward (``models/full_model.py``) asks for. ``decode_batch.launches``
counts kernel launches, ``decode_batch.launches_bf16_simt`` those of bf16
widths on the CUDA-core kernel.

The JAX package trains through the chain of ``models/target_network.py``;
the port does too everywhere but where ``decode_grad_route`` says "k10": bf16
under autograd on the card, at widths the tensor-core kernel and the
backward kernel take. There ``decode_batch_train`` decodes through K10 in
the chain's rounding and differentiates with respect to the flat weights
through ``decode_batch_grad``, the op ``hyperpocket::decode_batch_grad``:
its CUDA kernel launches ``csrc/decode_batch_grad.cu`` (the forward
recomputed a tile at a time, the chain's backward on the tensor cores, and
a pass that sums the chunks of points in a fixed order), its CPU kernel
runs ``decode_batch_grad_reference``; ``decode_batch_grad.launches`` counts
its launches.
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


# ---------------------------------------------------------------------------
# The training decode: K10's forward and its backward with respect to the
# flat weights.

GRAD_TILE = 128  # points a tile of csrc/decode_batch_grad.cu (its kTile: 16 a warp)
_GRAD_MAX_HIDDEN = 128  # channels of the widest hidden layer it takes (its kKF x 16)
_GRAD_UNITS = 80  # 16 x 16 blocks of dW its block holds in registers (kWarps x kSlots)


def _round16(v: int) -> int:
    return -(-v // 16) * 16


class GradLayout(NamedTuple):
    """A block's layout in ``csrc/decode_batch_grad.cu`` for some widths."""
    smem_bytes: int  # shared memory a block takes
    flat: int        # the flat row's length
    words: tuple     # the kernel's ``Layout``, its ints in its order


@functools.cache
def grad_layout(channels: tuple, use_bias: bool) -> GradLayout | None:
    """The layout ``decode_batch_grad``'s kernel takes for these widths, or
    None where it cannot take them: a hidden layer wider than 128 channels,
    more than 80 blocks of 16 x 16 in the weights' gradient (what its warps
    hold in registers), or the weights and a tile's activations and
    gradients beyond a block's shared memory. Widths it takes, the
    tensor-core K10 (``csrc/decode_batch_tc.cu``: up to 256 channels, the
    weights and the row's copy in a block) takes too.

    A block stages the weights (layer 0 fp32 (3, out), the others bf16
    (out, in) padded to multiples of 16 and to a row stride of in + 8) and
    each layer's fp32 bias, then a tile's A_l and dZ_l (bf16, stride + 8)
    and the fp32 db; every dW block of 16 x 16 is one unit, unit u in slot
    u // 8 of warp u % 8."""
    ch = _widths(channels)
    if not takes_widths(channels) or max(ch[1:-1], default=0) > _GRAD_MAX_HIDDEN:
        return None
    ins, outs = ch[:-1], ch[1:]
    kpad, npad = [_round16(i) for i in ins], [_round16(o) for o in outs]
    units = [li | mb << 8 | nb << 16 for li in range(len(ins))
             for mb in range(npad[li] // 16) for nb in range(kpad[li] // 16)]
    if len(units) > _GRAD_UNITS:
        return None
    w_src, b_src, w_dst, b_dst, a_dst, z_dst = [], [], [], [], [], []
    src = dst = 0
    for li, (i, o) in enumerate(zip(ins, outs)):
        w_src.append(src)
        b_src.append(src + i * o if use_bias else -1)
        src += i * o + (o if use_bias else 0)
        w_dst.append(dst)
        dst = _round16(dst + (12 * npad[0] if li == 0 else 2 * npad[li] * (kpad[li] + 8)))
        b_dst.append(dst)
        dst = _round16(dst + 4 * npad[li])
    for kp, np_ in zip(kpad, npad):
        a_dst.append(dst)
        z_dst.append(dst + 2 * GRAD_TILE * (kp + 8))
        dst += 2 * GRAD_TILE * (kp + 8 + np_ + 8)
    db_off = [sum(npad[:li]) for li in range(len(npad))]
    db_dst, dst = dst, dst + 4 * sum(npad)
    if dst > _MAX_SHARED_BYTES:
        return None

    def rows(v):
        return (*v, *[0] * (MAX_LAYERS - len(v)))

    words = (len(ins), *rows(ins), *rows(outs), *rows(npad), *rows(kpad), *rows(w_src),
             *rows(b_src), *rows(w_dst), *rows(b_dst), *rows(a_dst), *rows(z_dst),
             *rows(db_off), db_dst, *units, *[-1] * (_GRAD_UNITS - len(units)), src, dst)
    return GradLayout(dst, src, words)


def decode_grad_route(flat_weights, points, layer_out_channels, use_bias: bool = True) -> str:
    """The route of the training forward's decode: "k10" or "chain".

    Decided from the inputs before any launch (the arguments may be
    anything with ``device``, ``dtype`` and ``requires_grad``) and torch's
    grad mode: "k10" (``decode_batch_train``: K10's tensor-core forward and
    ``decode_batch_grad``) for bf16 flat weights and points on a CUDA device
    under autograd, points that need no gradient, and widths that the
    backward takes, and with them K10 (``grad_layout``: hidden layers of at
    most 128 channels, the backward's registers and a block's shared
    memory); "chain"
    (``models/target_network.py``) for everything else: fp32 and fp64
    (fp32's step is bound by its GEMMs, and its limits would need a kernel
    of their own), the CPU, and wider decoders.
    """
    fused = (flat_weights.device.type == "cuda" and points.device.type == "cuda"
             and flat_weights.dtype == torch.bfloat16 and points.dtype == torch.bfloat16
             and torch.is_grad_enabled() and not points.requires_grad
             and grad_layout(tuple(_channels(layer_out_channels)), bool(use_bias)) is not None)
    return "k10" if fused else "chain"


def decode_batch_grad_reference(flat_weights: torch.Tensor, points: torch.Tensor,
                                grad_out: torch.Tensor, layer_out_channels,
                                use_bias: bool = True) -> torch.Tensor:
    """Plain version of ``decode_batch_grad``: the gradient (B, W) of the
    chain's decode (``models/target_network.py``) with respect to the flat
    weights, given the output's gradient ``grad_out`` (B, N, 3), in the
    points' dtype.

    The chain's arithmetic under autograd: the forward recomputed (each
    product rounded, the bias added and the sum rounded), then from the last
    layer dW = dZ^T A and db = the sum of dZ over the points, sums in fp32
    (fp64 for fp64) rounded once, and dZ of the layer below = dZ W rounded,
    where its activation is above 0.
    """
    _check(flat_weights, points)
    dtype = points.dtype
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    ws, bs = split_flat_weights(flat_weights.to(dtype), layer_out_channels, use_bias)
    acts, h = [], points
    for li, (w, b) in enumerate(zip(ws, bs)):
        acts.append(h)
        z = torch.bmm(h.to(wide), w.to(wide)).to(dtype)
        if use_bias:
            z = (z.to(wide) + b.to(wide)).to(dtype)
        h = torch.relu(z) if li < len(ws) - 1 else z
    dz = grad_out.to(dtype)
    parts = []
    for li in range(len(ws) - 1, -1, -1):
        a = acts[li]
        part = [torch.bmm(dz.to(wide).transpose(1, 2), a.to(wide)).to(dtype).flatten(1)]
        if use_bias:
            part.append(dz.to(wide).sum(1).to(dtype))
        parts[:0] = part
        if li:
            da = torch.bmm(dz.to(wide), ws[li].transpose(1, 2).to(wide)).to(dtype)
            dz = torch.where(a > 0, da, torch.zeros_like(da))
    return torch.cat(parts, dim=1)


def grad_chunks(batch: int, n: int, sms: int) -> tuple[int, int]:
    """(chunks a sample, points a chunk) of ``decode_batch_grad``'s launch:
    each sample cut into as many chunks (of whole tiles) as keep the grid
    within one block on each of the card's ``sms`` SMs, at least one."""
    tiles = -(-n // GRAD_TILE)
    per = -(-tiles // max(1, min(tiles, sms // batch)))
    return -(-tiles // per), per * GRAD_TILE


def decode_batch_grad(flat_weights: torch.Tensor, points: torch.Tensor, grad_out: torch.Tensor,
                      layer_out_channels, use_bias: bool = True) -> torch.Tensor:
    """The chain's decode's gradient (B, W) with respect to the flat weights
    (``decode_batch_grad_reference``'s arithmetic, equal up to summation
    order), through the op ``hyperpocket::decode_batch_grad``: CUDA tensors
    must all be bf16; CPU tensors run the plain version."""
    _check(flat_weights, points)
    if grad_out.shape != points.shape:
        raise ValueError(f"the output's gradient {tuple(grad_out.shape)} is not shaped as the "
                         f"points {tuple(points.shape)}")
    return torch.ops.hyperpocket.decode_batch_grad(flat_weights, points, grad_out,
                                                   _channels(layer_out_channels), bool(use_bias))


decode_batch_grad.launches = 0


@torch.library.custom_op("hyperpocket::decode_batch_grad", mutates_args=(), device_types="cpu")
def _decode_batch_grad_op(flat_weights: torch.Tensor, points: torch.Tensor,
                          grad_out: torch.Tensor, layer_out_channels: list[int],
                          use_bias: bool) -> torch.Tensor:
    return decode_batch_grad_reference(flat_weights, points, grad_out, layer_out_channels,
                                       use_bias)


@functools.cache
def _grad_words(channels: tuple, use_bias: bool) -> ctypes.Array:
    """``grad_layout``'s ints as a C array; raises where the kernel cannot
    take the widths."""
    layout = grad_layout(channels, use_bias)
    if layout is None:
        raise ValueError(f"decode_batch_grad cannot take the widths {_widths(channels)}: "
                         f"decode_grad_route sends them to the chain")
    return (ctypes.c_int * len(layout.words))(*layout.words)


@_decode_batch_grad_op.register_kernel("cuda")
def _decode_batch_grad_cuda(flat_weights: torch.Tensor, points: torch.Tensor,
                            grad_out: torch.Tensor, layer_out_channels: list[int],
                            use_bias: bool) -> torch.Tensor:
    _check(flat_weights, points)
    tensors = (flat_weights, points, grad_out)
    if any(t.device != points.device for t in tensors) or points.device.type != "cuda":
        raise ValueError(f"decode_batch_grad runs on CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"the decode's backward kernel takes bf16, got "
                         f"{[t.dtype for t in tensors]}")
    if grad_out.shape != points.shape or min(points.shape[0], points.shape[1]) == 0:
        raise ValueError(f"decode_batch_grad takes at least one cloud of at least one point and "
                         f"its gradient, got {tuple(points.shape)} and {tuple(grad_out.shape)}")
    channels = tuple(layer_out_channels)
    words, flat_len = _grad_words(channels, use_bias), grad_layout(channels, use_bias).flat
    if flat_len != flat_weights.shape[1]:
        raise ValueError(f"flat weight vector not fully consumed: the layers take {flat_len} "
                         f"values, the vector holds {flat_weights.shape[1]}")
    flat, points, grad_out = (t.contiguous() for t in tensors)
    batch, n = points.shape[:2]
    chunks, chunk_points = grad_chunks(batch, n, _sm_count(points.device))
    partial = torch.empty(batch * chunks * flat_len, dtype=torch.float32, device=points.device)
    out = torch.empty_like(flat)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        fn = _symbol("hpcd_decode_batch_grad_bf16", (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6
                     + (ctypes.c_void_p,), ctypes.c_int)
        rc = fn(flat.data_ptr(), points.data_ptr(), grad_out.data_ptr(), out.data_ptr(),
                partial.data_ptr(), ctypes.addressof(words), len(words), GRAD_TILE, batch, n,
                chunks, chunk_points, stream)
    if rc != 0:
        raise RuntimeError(f"decode_batch_grad kernel launch failed with CUDA error {rc}")
    decode_batch_grad.launches += 1
    return out


@_decode_batch_grad_op.register_fake
def _decode_batch_grad_fake(flat_weights: torch.Tensor, points: torch.Tensor,
                            grad_out: torch.Tensor, layer_out_channels: list[int],
                            use_bias: bool) -> torch.Tensor:
    _check(flat_weights, points)
    return flat_weights.new_empty(flat_weights.shape, dtype=points.dtype)


class _DecodeTrain(torch.autograd.Function):
    """K10 in the chain's rounding, differentiated with respect to the flat
    weights by ``decode_batch_grad``. Saves the flat weights and the points
    only: the backward recomputes the activations."""

    @staticmethod
    def forward(ctx, flat_weights, points, channels, use_bias):
        ctx.save_for_backward(flat_weights, points)
        ctx.channels, ctx.use_bias = channels, use_bias
        return torch.ops.hyperpocket.decode_batch(flat_weights, points, channels, use_bias, True)

    @staticmethod
    def backward(ctx, grad):
        flat_weights, points = ctx.saved_tensors
        grad_flat = torch.ops.hyperpocket.decode_batch_grad(
            flat_weights, points, grad.to(points.dtype), ctx.channels, ctx.use_bias)
        return grad_flat.to(flat_weights.dtype), None, None, None


def decode_batch_train(flat_weights: torch.Tensor, points: torch.Tensor, layer_out_channels,
                       use_bias: bool = True) -> torch.Tensor:
    """The training forward's decode on ``decode_grad_route``'s "k10":
    ``models/target_network.py::batched_target_network_forward``'s value and
    flat-weight gradient (equal up to summation order), through K10 and
    ``decode_batch_grad``. The points get no gradient."""
    _check(flat_weights, points)
    return _DecodeTrain.apply(flat_weights, points, _channels(layer_out_channels),
                              bool(use_bias))
