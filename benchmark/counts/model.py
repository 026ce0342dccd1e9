"""FLOPs of the completion model a cloud, and each hand-written kernel's
least time, counted from the configuration's widths.

The model counts are ``bench.py``'s ``flops_per_cloud`` (matmul MACs x 2,
elementwise work left out), freed of JAX and extended with the backward
that training needs. The kernel bounds are ``chip_smoke.py``'s ``bound``,
``pair_bound`` and ``trunk_bound``: the larger of the bytes at the HBM rate
and the operations at their peak, each input byte read once and each output
byte written once.
"""

from __future__ import annotations

from benchmark.counts import peaks

TRUNK = (3, 64, 128, 256, 512, 512)  # the encoders' pointwise layers
FC = 512
HYPER_TRUNK = (64, 128, 512, 1024, 2048)
K9_INSTRUCTIONS_A_PAIR = 14  # the key-split sweep (PERF.md, K5/K9)


def mlp_macs(sizes) -> int:
    return sum(int(a) * int(b) for a, b in zip(sizes[:-1], sizes[1:]))


def decoder_widths(layer_out_channels) -> tuple[int, ...]:
    return (3, *layer_out_channels, 3)


def flat_weight_count(layer_out_channels, use_bias: bool = True) -> int:
    ch = decoder_widths(layer_out_channels)
    return sum((ch[i - 1] + int(use_bias)) * ch[i] for i in range(1, len(ch)))


def decode_macs_a_point(layer_out_channels) -> int:
    """MACs of the target network a point: 18,720 for 3-32-64-128-64-3."""
    return mlp_macs(decoder_widths(layer_out_channels))


def _sizes(model: dict) -> tuple[int, int, tuple[int, ...]]:
    """(random encoder size, real encoder size, decoder channels) of a
    config's ``full_model`` section."""
    return (int(model["random_encoder"]["output_size"]),
            int(model["real_encoder"]["output_size"]),
            tuple(model["target_network"]["layer_out_channels"]))


def serve_flops_a_cloud(model: dict, n_existing: int, n_out: int) -> float:
    """Inference with the latent noise given: the real encoder, the
    hypernetwork and the decode (1.05 GFLOP for the 3D-EPN chair model)."""
    rand, real, chans = _sizes(model)
    macs = mlp_macs(TRUNK) * n_existing + FC * FC + FC * real
    macs += mlp_macs((rand + real, *HYPER_TRUNK)) + HYPER_TRUNK[-1] * flat_weight_count(chans)
    macs += decode_macs_a_point(chans) * n_out
    return 2.0 * macs


def _trunk_backward_macs() -> int:
    """The encoder trunk's backward a cloud: its max-pool routes each of the
    512 channels' cotangents to one point, so the backward recomputes the
    stack on those 512 rows and backpropagates them; the last layer's row c
    carries cotangent in channel c alone (an elementwise product)."""
    rows = TRUNK[-1]
    inner = mlp_macs(TRUNK[:-1])
    return rows * (mlp_macs(TRUNK) + 2 * inner + 2 * TRUNK[-2])


def train_flops_a_cloud(model: dict, n_existing: int, n_missing: int, n_out: int) -> float:
    """A train step a cloud: the training forward (both encoders of a
    HyperPocket), the backward of every layer (twice its forward MACs, the
    trunks' as ``_trunk_backward_macs``) and the Chamfer cross term both
    ways (3 MACs a pair forward, 6 more backward)."""
    rand, real, chans = _sizes(model)
    head = HYPER_TRUNK[-1] * flat_weight_count(chans)
    dense = mlp_macs((rand + real, *HYPER_TRUNK)) + head + decode_macs_a_point(chans) * n_out
    trunk_fwd = trunk_bwd = 0
    for size, n, heads in ((real, n_existing, 1), (rand, n_missing, 2)):  # mu; mu and std
        if size > 0:
            trunk_fwd += mlp_macs(TRUNK) * n
            trunk_bwd += _trunk_backward_macs()
            dense += FC * FC + FC * size * heads
    chamfer = 9 * n_out * n_out
    return 2.0 * (trunk_fwd + trunk_bwd + 3 * dense + chamfer)


def val_flops_a_cloud(model: dict, n_existing: int, n_out: int) -> float:
    """A val step a cloud: the inference forward with the VAE's mu as the
    latent (both encoders of a HyperPocket) and the Chamfer distances."""
    rand, real, chans = _sizes(model)
    flops = serve_flops_a_cloud(model, n_existing, n_out)
    if rand > 0 and real > 0:
        flops += 2.0 * (mlp_macs(TRUNK) * n_existing + FC * FC + 2 * FC * rand)
    return flops + 2.0 * 3 * n_out * n_out


def bound_s(bytes_moved: float, op_seconds: float) -> float:
    """The least time for the work: the larger of the bytes over the HBM
    rate and the operations' time at their peak rate."""
    return max(bytes_moved / peaks.HBM_BYTES_S, op_seconds)


def k4_trunk_bound_s(batch: int, n: int) -> float:
    """K4 (``trunk_pooled``, bf16): layers 2-5 on the tensor cores, layer 1
    (K=3) at the fp32 rate; the clouds, the 0.87 MB of layers and the pooled
    output each moved once."""
    rows = batch * n
    macs = [TRUNK[i] * TRUNK[i + 1] for i in range(len(TRUNK) - 1)]
    layer_bytes = 2 * sum(m + TRUNK[i + 1] for i, m in enumerate(macs))
    return bound_s(rows * 3 * 2 + layer_bytes + batch * TRUNK[-1] * 2,
                   2 * rows * sum(macs[1:]) / peaks.BF16_FLOPS
                   + 2 * rows * macs[0] / peaks.FP32_FLOPS)


def k10_decode_bound_s(batch: int, n: int, layer_out_channels, dtype: str) -> float:
    """K10 (``decode_batch``): 18,720 MACs a point for the chair decoder at
    the dtype's dense peak; each cloud's flat weights, its points and its
    output moved once."""
    size = peaks.DTYPE_BYTES[dtype]
    byts = size * batch * (flat_weight_count(layer_out_channels) + 2 * n * 3)
    return bound_s(byts, 2.0 * batch * n * decode_macs_a_point(layer_out_channels)
                   / peaks.DENSE_FLOPS[dtype])


def k9_chamfer_bound_s(batch: int, n_gt: int, n_pred: int) -> float:
    """K9 (``chamfer_loss_grad``): the sweep's 14 fp32 instructions a
    (query, key) pair; both clouds read once, the two gradient fields and
    the loss written once."""
    pairs = batch * n_gt * n_pred
    return bound_s(4 * 3 * batch * (n_gt + n_pred) * 2 + 4,
                   K9_INSTRUCTIONS_A_PAIR * pairs / peaks.FP32_LANE_RATE)
