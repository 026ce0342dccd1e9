"""PointNet-style encoder.

Port of ``hyperpocket_tpu/models/encoder.py``: five pointwise layers
3->64->128->256->512->512 (ReLU between, none after the last), a global max
over points, FC 512->512 + ReLU, then a ``mu`` head and (VAE only) a ``std``
head whose output is log-sigma. ReLU is plain everywhere: the configs'
``relu_slope`` is ignored, as in the JAX package.

Inference (``fast=True``) sends the trunk to the fused kernel
(``ops/trunk_pool.py``) under the JAX package's gate: bf16 input with N a
multiple of 8. Every other case runs the plain matmul chain and a max over
points.
"""

from __future__ import annotations

import torch
from torch import nn

from hyperpocket_tpu_torch.models.initializers import dense, dense_init_
from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled

CONV_CHANNELS = (3, 64, 128, 256, 512, 512)


class Encoder(nn.Module):
    def __init__(self, output_size: int, use_bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        ch = CONV_CHANNELS
        self.conv = nn.ModuleList(
            nn.Linear(ch[i], ch[i + 1], bias=use_bias) for i in range(len(ch) - 1))
        # fc / mu / std always have biases in the reference (encoder.py:31-37)
        self.fc = nn.Linear(512, 512)
        self.mu = nn.Linear(512, output_size)
        self.std = nn.Linear(512, output_size)
        generator = generator if generator is not None else torch.Generator()
        for layer in (*self.conv, self.fc, self.mu, self.std):
            dense_init_(layer, generator)

    def conv_stack(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, layer in enumerate(self.conv):
            h = dense(layer, h)
            if i < len(self.conv) - 1:
                h = torch.relu(h)
        return h

    def trunk(self, x: torch.Tensor, *, fast: bool = False) -> torch.Tensor:
        """x (B, N, 3) -> pooled features after fc + ReLU (B, 512)."""
        if fast and x.dtype == torch.bfloat16 and x.shape[1] % 8 == 0:
            pooled = trunk_pooled([(layer.weight, layer.bias) for layer in self.conv], x)
        else:
            pooled = self.conv_stack(x).amax(dim=1)
        return torch.relu(dense(self.fc, pooled))

    def forward(self, x: torch.Tensor, *, is_vae: bool,
                generator: torch.Generator | None = None, fast: bool = False,
                eps: torch.Tensor | None = None):
        """``mu`` (B, Z) when not VAE; else ``(z, mu, sigma)``, sigma = exp(std head)."""
        logit = self.trunk(x, fast=fast)
        mu = dense(self.mu, logit)
        if not is_vae:
            return mu
        raw_std = dense(self.std, logit)
        if generator is None and eps is None:
            raise ValueError("VAE encoder forward requires a generator or explicit eps")
        return reparameterize(generator, mu, raw_std, eps=eps), mu, torch.exp(raw_std)


def reparameterize(generator: torch.Generator | None, mu: torch.Tensor,
                   raw_std: torch.Tensor, eps: torch.Tensor | None = None) -> torch.Tensor:
    """z = eps * exp(raw_std) + mu; eps is drawn in fp32 then cast, or given."""
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, dtype=torch.float32,
                          device=mu.device)
    return eps.to(device=mu.device, dtype=mu.dtype) * torch.exp(raw_std) + mu
