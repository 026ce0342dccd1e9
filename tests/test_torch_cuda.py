"""CUDA kernels of hyperpocket_tpu_torch against their plain versions, on the card.

Every test here needs a GPU and skips without one. The file imports no JAX,
so it runs on a machine without it; tests/conftest.py imports JAX, so run it
there with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import pytest
import torch

from hyperpocket_tpu_torch.models.encoder import Encoder
from hyperpocket_tpu_torch.ops.chamfer import chamfer_loss
from hyperpocket_tpu_torch.ops.nn import (
    chamfer_loss_streaming,
    nn_min_fused,
    nn_min_fused_reference,
    nn_one_direction,
    nn_one_direction_reference,
)
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _points(b: int, n: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, n, 3), generator=g, device="cuda") * 0.3


def _nn_case(case: str):
    if case == "ties":  # every key twice, 64 points apart: exact ties, first index wins
        keys = _points(2, 64, 3)
        return _points(2, 256, 4), torch.cat([keys, keys], dim=1).contiguous()
    if case == "one_point":  # every point of a cloud equal
        q, k = _points(2, 1, 5), _points(2, 1, 6)
        return q.expand(2, 128, 3).contiguous(), k.expand(2, 96, 3).contiguous()
    b, n, m = {"B64_2048": (64, 2048, 2048), "ragged": (3, 200, 136),
               "long_keys": (2, 300, 4500)}[case]
    return _points(b, n, 1), _points(b, m, 2)


NN_CASES = ["B64_2048", "ragged", "long_keys", "ties", "one_point"]


@pytest.mark.parametrize("case", NN_CASES)
def test_nn_one_direction_kernel_matches_reference(cuda, case):
    q, k = _nn_case(case)
    before = nn_one_direction.launches
    dist, idx = nn_one_direction(q, k)
    torch.cuda.synchronize()
    assert nn_one_direction.launches == before + 1
    want_d, want_i = nn_one_direction_reference(q, k)
    assert dist.dtype == torch.float32 and idx.dtype == torch.int32
    assert torch.equal(idx, want_i)
    assert (dist - want_d).abs().max().item() <= 1e-6


@pytest.mark.parametrize("case", NN_CASES)
def test_nn_min_fused_kernel_matches_reference(cuda, case):
    q, k = _nn_case(case)
    before = nn_min_fused.launches
    d1, d2 = nn_min_fused(q, k)
    torch.cuda.synchronize()
    assert nn_min_fused.launches == before + 1
    want1, want2 = nn_min_fused_reference(q, k)
    assert d1.shape == want1.shape and d2.shape == want2.shape
    assert (d1 - want1).abs().max().item() <= 1e-6
    assert (d2 - want2).abs().max().item() <= 1e-6


def test_chamfer_streaming_value_and_grad_match_plain(cuda):
    gts, preds = _points(8, 2048, 7), _points(8, 2048, 8).requires_grad_()
    got = chamfer_loss_streaming(gts, preds)
    (g_got,) = torch.autograd.grad(got, preds)
    want = chamfer_loss(gts, preds)
    (g_want,) = torch.autograd.grad(want, preds)
    assert abs(got.item() - want.item()) <= 1e-5 * abs(want.item())
    # argmin near-ties may route differently: tests/test_pallas_nn.py's bound
    assert (g_got - g_want).abs().max().item() <= 5e-3
    with torch.no_grad():
        before = nn_min_fused.launches
        value = chamfer_loss_streaming(gts, preds)
        assert nn_min_fused.launches == before + 1
    assert abs(value.item() - got.item()) <= 1e-5 * abs(got.item())


def test_nn_kernels_reject_what_they_cannot_take(cuda):
    q, k = _points(2, 64, 0), _points(2, 32, 1)
    with pytest.raises(ValueError, match="fp32"):
        nn_one_direction(q.double(), k.double())
    with pytest.raises(ValueError, match="contiguous"):
        nn_min_fused(q[:, ::2], k)
    with pytest.raises(ValueError, match="one device"):
        nn_one_direction(q, k.cpu())
