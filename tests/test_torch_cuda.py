"""CUDA kernels of hyperpocket_tpu_torch against their plain versions, on the card.

Every test here needs a GPU and skips without one. The file imports no JAX,
so it runs on a machine without it; tests/conftest.py imports JAX, so run it
there with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import pytest
import torch

from hyperpocket_tpu_torch.models.encoder import Encoder
from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled, trunk_pooled_reference

pytestmark = pytest.mark.cuda

BF16_ATOL = 2e-2  # bf16 per-layer rounding, the JAX package's bound for this kernel


@pytest.fixture
def layers():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(0)
    enc = Encoder(128, generator=gen)
    # initialisation zeroes the biases; distinct ones per channel, as trained
    # weights have, show a bias read from the wrong channel
    return [(l.weight.to("cuda", torch.bfloat16),
             (torch.randn(l.out_features, generator=gen) * 0.1).to("cuda", torch.bfloat16))
            for l in enc.conv]


def _cloud(b: int, n: int, seed: int = 0) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((b, n, 3), generator=g, device="cuda") * 0.3).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(64, 1024), (3, 200), (1, 8), (2, 72)])
def test_trunk_kernel_matches_reference(layers, shape):
    x = _cloud(*shape)
    before = trunk_pooled.launches
    got = trunk_pooled(layers, x)
    torch.cuda.synchronize()
    assert trunk_pooled.launches == before + 1
    want = trunk_pooled_reference(layers, x)
    assert got.dtype == torch.bfloat16 and got.shape == (shape[0], 512)
    assert (got.float() - want.float()).abs().max().item() <= BF16_ATOL


def test_trunk_kernel_ties_and_negative_maxima(layers):
    base = _cloud(2, 64, seed=1)
    x = torch.cat([base, base], dim=1).contiguous()
    got = trunk_pooled(layers, x)
    assert torch.equal(got, trunk_pooled(layers, base.contiguous()))
    # layer 5 has no ReLU: biases shifted by -2 drive the maxima below zero
    # and keep them above -4, where one bf16 step (0.031) exceeds the bound
    neg = list(layers)
    neg[4] = (layers[4][0], layers[4][1] - 2.0)
    got = trunk_pooled(neg, x).float()
    want = trunk_pooled_reference(neg, x).float()
    assert (got < 0).any()
    assert (got - want).abs().max().item() <= BF16_ATOL


def test_trunk_kernel_rejects_what_it_cannot_take(layers):
    x = _cloud(2, 64)
    with pytest.raises(ValueError, match="bf16"):
        trunk_pooled(layers, x.float())
    with pytest.raises(ValueError, match="contiguous"):
        trunk_pooled(layers, x[:, ::2])
    with pytest.raises(ValueError, match="multiple of 8"):
        trunk_pooled(layers, _cloud(2, 60))
