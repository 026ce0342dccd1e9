"""PointNet-style encoder.

Port of ``hyperpocket_tpu/models/encoder.py``: five pointwise layers
3->64->128->256->512->512 (ReLU between, none after the last), a global max
over points, FC 512->512 + ReLU, then a ``mu`` head and (VAE only) a ``std``
head whose output is log-sigma. ReLU is plain everywhere: the configs'
``relu_slope`` is ignored, as in the JAX package.

Inference (``fast=True``) sends the trunk to the fused kernel K4
(``ops/trunk_pool.py::trunk_pooled``) under the JAX package's gate: bf16
input with N a multiple of 8. Otherwise a cloud of at least 2 x C_out
points (1024) runs ``_ConvPooledSparse``, whose backward recomputes only the
pool's argmax rows, and a smaller cloud the plain matmul chain and a max
over points. With ``HPCD_TRUNK_FUSED_FWD=1`` in the environment (the JAX
package's opt-in, read at every call), a bf16 cloud of at least 2 x C_out
points with N a multiple of 8 runs ``_ConvPooledSparseFused`` instead: the
same backward, with the forward and the argmax from the fused kernel K8
(``trunk_pooled_argmax``), so no (B, N, C) activation is written.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from hyperpocket_tpu_torch.models.initializers import dense, dense_init_, linear
from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled, trunk_pooled_argmax

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
        elif x.shape[1] >= 2 * self.conv[-1].out_features:
            params = []
            for layer in self.conv:
                params += [layer.weight.to(x.dtype),
                           None if layer.bias is None else layer.bias.to(x.dtype)]
            fused = (x.dtype == torch.bfloat16 and x.shape[1] % 8 == 0
                     and os.environ.get("HPCD_TRUNK_FUSED_FWD") == "1")
            pooled = (_ConvPooledSparseFused if fused else _ConvPooledSparse).apply(x, *params)
        else:
            # amax splits the gradient of a tie evenly, as jnp.max does
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


def _stack(params, x: torch.Tensor) -> list[torch.Tensor]:
    """The five layers on x; returns every pre-activation (ReLU after all but the last)."""
    pre, h = [], x
    n_layers = len(params) // 2
    for i in range(n_layers):
        a = linear(h, params[2 * i], params[2 * i + 1])
        pre.append(a)
        h = torch.relu(a) if i < n_layers - 1 else a
    return pre


class _ConvPooledSparse(torch.autograd.Function):
    """Conv stack + max over points, with a backward through the argmax rows only.

    Port of ``_conv_pooled_sparse`` (``hyperpocket_tpu/models/encoder.py``).
    The max-pool routes each output channel's cotangent to one point, so the
    backward gathers those <= C_out "virtual rows" (one per channel, at the
    pool's first argmax), recomputes the stack on them, and backprops C_out
    rows instead of N; nothing (B, N, C)-sized is saved. The last layer has
    no ReLU and row c carries cotangent only in channel c, so its weight
    gradient and its input cotangent are elementwise products. Ties route to
    the first argmax, as torch's max backward and the JAX package do.

    Inputs: x (B, N, 3) and the layers' (weight (out, in), bias or None)
    flattened, all in x's dtype.
    """

    @staticmethod
    def forward(ctx, x, *params):
        pooled, amax = torch.max(_stack(params, x)[-1], dim=1)  # first argmax on ties
        ctx.save_for_backward(x, amax, *params)
        ctx.mark_non_differentiable(amax)
        return pooled

    @staticmethod
    def backward(ctx, dpooled):
        x, amax, *params = ctx.saved_tensors
        ws, bs = params[0::2], params[1::2]
        batch, n = x.shape[:2]
        x_v = torch.gather(x, 1, amax[..., None].expand(-1, -1, x.shape[2]))  # (B, C, 3)
        pre = _stack(params, x_v)
        hs = [x_v] + [torch.relu(a) for a in pre[:-1]]  # each layer's input
        grads: list = [None] * len(params)
        last = len(ws) - 1
        grads[2 * last] = torch.einsum("bci,bc->ci", hs[last], dpooled)
        if bs[last] is not None:
            grads[2 * last + 1] = dpooled.sum(dim=0)
        dh = dpooled[:, :, None] * ws[last][None, :, :]  # (B, C_out, C_in)
        for i in range(last - 1, -1, -1):
            dh = dh * (pre[i] > 0).to(dh.dtype)  # the ReLU after layer i
            grads[2 * i] = torch.einsum("brk,brc->ck", hs[i], dh)
            if bs[i] is not None:
                grads[2 * i + 1] = dh.sum(dim=(0, 1))
            dh = torch.einsum("brc,ck->brk", dh, ws[i])
        dx = None
        if ctx.needs_input_grad[0]:
            rows = (amax + n * torch.arange(batch, device=amax.device)[:, None]).reshape(-1)
            dx = torch.zeros((batch * n, x.shape[2]), dtype=dh.dtype, device=dh.device)
            dx.index_add_(0, rows, dh.reshape(-1, x.shape[2]))
            dx = dx.view_as(x)
        return (dx, *grads)


class _ConvPooledSparseFused(_ConvPooledSparse):
    """``_ConvPooledSparse`` with its forward from the fused kernel K8.

    Port of ``_conv_pooled_sparse_fused`` (``hyperpocket_tpu/models/encoder.py``):
    ``trunk_pooled_argmax`` returns the pooled values and the first argmax
    per channel (a CUDA tensor launches K8 or raises; a CPU tensor takes its
    plain version), and the backward is the parent's virtual-row backward on
    that argmax. bf16 only; the kernel's sums run in another order than the
    recompute in the backward, so the two agree to bf16 rounding, not bit for
    bit, as in the JAX package.
    """

    @staticmethod
    def forward(ctx, x, *params):
        pooled, amax = trunk_pooled_argmax(list(zip(params[0::2], params[1::2])), x)
        ctx.save_for_backward(x, amax.long(), *params)
        return pooled
