"""Weight initialisers, drawn from an explicit ``torch.Generator``.

Port of ``hyperpocket_tpu/models/initializers.py``: Xavier-uniform with ReLU
gain and zero bias for every layer, and torch's default ``nn.Linear`` reset
for the frozen hypernetwork heads. Weights are in ``nn.Linear`` layout
(out, in). The draws do not reproduce JAX's bits; ``convert.py`` carries
weights across where both packages must hold the same ones.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def xavier_relu_bound(fan_in: int, fan_out: int) -> float:
    """a in U(-a, a): gain * sqrt(6 / (fan_in + fan_out)), gain = sqrt(2)."""
    return math.sqrt(2.0) * math.sqrt(6.0 / (fan_in + fan_out))


@torch.no_grad()
def xavier_relu_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Fill an (out, in) weight, or a row block of one, in place."""
    fan_out, fan_in = weight.shape
    bound = xavier_relu_bound(fan_in, fan_out)
    weight.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def dense_init_(linear: nn.Linear, generator: torch.Generator) -> None:
    """Xavier-ReLU weight and zero bias: the reference's weights_init state."""
    xavier_relu_(linear.weight, generator)
    if linear.bias is not None:
        linear.bias.zero_()


@torch.no_grad()
def torch_default_linear_(linear: nn.Linear, generator: torch.Generator) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias."""
    bound = 1.0 / math.sqrt(linear.in_features)
    linear.weight.uniform_(-bound, bound, generator=generator)
    if linear.bias is not None:
        linear.bias.uniform_(-bound, bound, generator=generator)


def dense(linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``linear`` applied with its parameters cast to ``x``'s dtype at use.

    The JAX package casts the fp32 master parameters to the compute dtype
    inside ``apply``; the cast is a no-op on parameters already in that dtype
    (``FullModel.serving_params``).
    """
    b = None if linear.bias is None else linear.bias.to(x.dtype)
    return nn.functional.linear(x, linear.weight.to(x.dtype), b)
