"""Target network: a tiny per-sample MLP decoded from a flat weight vector.

Port of ``hyperpocket_tpu/models/target_network.py``: channels
``3 -> layer_out_channels... -> 3``; each layer's weight is sliced from the
flat vector as a row-major (out, in) matrix followed (if ``use_bias``) by the
bias; hidden layers use ReLU, the output layer is linear. The batch runs as
one ``bmm`` chain, as the JAX package keeps its decode on XLA's batched
matmuls.
"""

from __future__ import annotations

import torch


def layer_shapes(layer_out_channels: list[int]) -> list[tuple[int, int]]:
    ch = [3] + list(layer_out_channels) + [3]
    return [(ch[i], ch[i - 1]) for i in range(1, len(ch))]  # (out, in)


def batched_target_network_forward(flat_weights: torch.Tensor, points: torch.Tensor,
                                   layer_out_channels: list[int],
                                   use_bias: bool = True) -> torch.Tensor:
    """(B, W) weights x (B, N, 3) points -> (B, N, 3)."""
    shapes = layer_shapes(layer_out_channels)
    batch = flat_weights.shape[0]
    x = points
    offset = 0
    for li, (out_ch, in_ch) in enumerate(shapes):
        w = flat_weights[:, offset:offset + out_ch * in_ch].reshape(batch, out_ch, in_ch)
        offset += out_ch * in_ch
        x = torch.bmm(x, w.transpose(1, 2))
        if use_bias:
            x = x + flat_weights[:, None, offset:offset + out_ch]
            offset += out_ch
        if li < len(shapes) - 1:
            x = torch.relu(x)
    if offset != flat_weights.shape[1]:
        raise ValueError(
            f"flat weight vector not fully consumed: used {offset} of {flat_weights.shape[1]}")
    return x
