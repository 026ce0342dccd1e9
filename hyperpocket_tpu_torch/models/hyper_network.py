"""Hypernetwork: latent -> flat weight vector of the per-sample target network.

Port of ``hyperpocket_tpu/models/hyper_network.py``: an MLP trunk
``Z -> 64 -> 128 -> 512 -> 1024 -> 2048`` (ReLU between, none after the
last) and one fused head ``2048 -> sum(target_layer_sizes)`` whose output
concatenates every target layer's flattened weight and bias in layer order.
Each head's row block is initialised as its own layer (Xavier-ReLU with that
head's fan-out), or with torch's default ``nn.Linear`` reset when
``freeze_layers_learning`` is set. Frozen heads are also used detached, the
counterpart of the JAX package's ``lax.stop_gradient``, and
``train/optim.py`` leaves them out of the optimizer.
"""

from __future__ import annotations

import torch
from torch import nn

from hyperpocket_tpu_torch.models.initializers import (
    dense,
    dense_init_,
    torch_default_linear_,
    xavier_relu_,
)

TRUNK_SIZES = (64, 128, 512, 1024, 2048)


def target_layer_sizes(layer_out_channels: list[int], use_bias: bool) -> list[int]:
    """Per-layer flattened parameter counts: ``(in + use_bias) * out``."""
    ch = [3] + list(layer_out_channels) + [3]
    bias = int(use_bias)
    return [(ch[i - 1] + bias) * ch[i] for i in range(1, len(ch))]


def target_weight_count(layer_out_channels: list[int], use_bias: bool) -> int:
    return sum(target_layer_sizes(layer_out_channels, use_bias))


class HyperNetwork(nn.Module):
    def __init__(self, input_size: int, layer_out_channels: list[int], *,
                 use_bias: bool = True, target_network_use_bias: bool = True,
                 freeze_heads: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.freeze_heads = freeze_heads
        dims = (input_size,) + TRUNK_SIZES
        self.trunk = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], bias=use_bias) for i in range(len(TRUNK_SIZES)))
        sizes = target_layer_sizes(layer_out_channels, target_network_use_bias)
        self.heads = nn.Linear(TRUNK_SIZES[-1], sum(sizes))
        generator = generator if generator is not None else torch.Generator()
        for layer in self.trunk:
            dense_init_(layer, generator)
        if freeze_heads:
            # one bound for every head: all share fan_in = 2048
            torch_default_linear_(self.heads, generator)
        else:
            start = 0
            for size in sizes:
                xavier_relu_(self.heads.weight[start:start + size], generator)
                start += size
            with torch.no_grad():
                self.heads.bias.zero_()

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        """latent (B, Z) -> flat target-network weights (B, sum(sizes))."""
        h = latent
        for i, layer in enumerate(self.trunk):
            h = dense(layer, h)
            if i < len(self.trunk) - 1:
                h = torch.relu(h)
        w, b = self.heads.weight, self.heads.bias
        if self.freeze_heads:
            w, b = w.detach(), b.detach()
        return nn.functional.linear(h, w.to(h.dtype), b.to(h.dtype))
