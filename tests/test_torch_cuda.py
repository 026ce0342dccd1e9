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


# (1, 8), (1, 136), (5, 128) and (3, 200) give 1, 2, 5 and 6 tiles: odd counts
# leave the second CTA of the last cluster without a tile
@pytest.mark.parametrize("shape", [(64, 1024), (3, 200), (1, 8), (2, 72), (1, 136), (5, 128)])
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


# K6/K7 (ops/emd.py): costs within rtol 1e-4 (tests/test_pallas_emd.py);
# gradients within relative L2 1e-4 and every entry within 1e-2 of the
# tensor's largest: kernel and plain version, both fp32, part by up to 4.0e-3
# of it at a few entries (B4_2048x1024), where a broken kernel reads 0.26 or
# more (PERF.md)
EMD_CASES = {
    "B8_1024": (8, 1024, 1024),
    "B4_2048x1024": (4, 2048, 1024),  # budget multiplier 2
    "B4_1024x2048": (4, 1024, 2048),
    "B3_300x128": (3, 300, 128),  # multiplier 2 by integer division
    "ragged_B3_200x136": (3, 200, 136),
    "B1_512": (1, 512, 512),
    "coincident_B2_256": (2, 256, 256),  # x == y: the 1e-20 clamp of K7
}


def _emd_case(case: str):
    b, n, m = EMD_CASES[case]
    x = _points(b, n, 11)
    return (x, x.clone()) if case.startswith("coincident") else (x, _points(b, m, 12))


def _close_grad(got, want, rel_l2=1e-4, most=1e-2, atol=1e-6):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert (got - want).norm().item() <= rel_l2 * want.norm().item() + atol
    assert (got - want).abs().max().item() <= most * want.abs().max().item() + atol


@pytest.mark.parametrize("case", list(EMD_CASES))
def test_emd_match_cost_kernel_matches_reference(cuda, case):
    from hyperpocket_tpu_torch.ops.emd import match_cost_fwd_kernel, match_cost_fwd_reference

    x, y = _emd_case(case)
    before = match_cost_fwd_kernel.launches
    got = match_cost_fwd_kernel(x, y)
    torch.cuda.synchronize()
    assert match_cost_fwd_kernel.launches == before + 1
    want = match_cost_fwd_reference(x, y)
    assert got.shape == (x.shape[0],) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    assert torch.equal(match_cost_fwd_kernel(x, y), got)  # a fixed summation order


@pytest.mark.parametrize("case", list(EMD_CASES))
def test_emd_match_cost_grad_kernel_matches_reference(cuda, case):
    from hyperpocket_tpu_torch.ops.emd import match_cost_bwd_kernel, match_cost_bwd_reference

    x, y = _emd_case(case)
    before = match_cost_bwd_kernel.launches
    gx, gy = match_cost_bwd_kernel(x, y)
    torch.cuda.synchronize()
    assert match_cost_bwd_kernel.launches == before + 1
    want_x, want_y = match_cost_bwd_reference(x, y)
    _close_grad(gx, want_x)
    _close_grad(gy, want_y)
    again = match_cost_bwd_kernel(x, y)
    assert torch.equal(again[0], gx) and torch.equal(again[1], gy)


def test_emd_descent_kernels_vs_plain(cuda):
    """tests/test_pallas_emd.py's descent check: K6/K7 against the plain route."""
    from hyperpocket_tpu_torch.ops.emd import (
        _match_cost_bwd_plain,
        _streaming_cost,
        match_cost,
        match_cost_bwd_kernel,
        match_cost_fwd_kernel,
    )

    x0, target = _points(16, 128, 13), _points(16, 128, 14)

    def through_kernels(x):
        x.requires_grad_()
        loss = match_cost(x, target).sum() / (16 * 128)
        return loss, torch.autograd.grad(loss, x)[0]

    def through_plain(x):
        return (_streaming_cost(x, target).sum() / (16 * 128),
                _match_cost_bwd_plain(x, target)[0] / (16 * 128))

    def run(value_and_grad):
        x, losses = x0.clone(), []
        for _ in range(10):
            loss, g = value_and_grad(x)
            losses.append(loss.item())
            x = (x - 0.05 * g).detach()
        return losses

    launches = match_cost_fwd_kernel.launches, match_cost_bwd_kernel.launches
    kernels = run(through_kernels)
    assert (match_cost_fwd_kernel.launches - launches[0],
            match_cost_bwd_kernel.launches - launches[1]) == (10, 10)
    plain = run(through_plain)
    assert plain[-1] < plain[0]
    torch.testing.assert_close(torch.tensor(kernels), torch.tensor(plain), rtol=2e-3, atol=0)


def test_emd_kernels_reject_what_they_cannot_take(cuda):
    from hyperpocket_tpu_torch.ops.emd import match_cost, match_cost_fwd_kernel

    x, y = _points(2, 64, 0), _points(2, 32, 1)
    with pytest.raises(ValueError, match="fp32"):
        match_cost_fwd_kernel(x.double(), y.double())
    with pytest.raises(ValueError, match="one device"):
        match_cost_fwd_kernel(x, y.cpu())
    with pytest.raises(ValueError, match="shared memory"):
        match_cost_fwd_kernel(_points(1, 6000, 2), _points(1, 6000, 3))
    # match_cost on a card launches the kernels or raises: no plain fallback
    with pytest.raises(ValueError, match="fp32"):
        match_cost(x.double(), y.double())
    with pytest.raises(ValueError, match="one device"):
        match_cost(x, y.cpu())


def test_earth_mover_distance_one_launch_per_batch(cuda):
    """On a card the whole batch goes to K6 at once (no 300-pair chunks)."""
    from hyperpocket_tpu_torch.ops.emd import (
        earth_mover_distance,
        match_cost_fwd_kernel,
        match_cost_fwd_reference,
    )

    x, y = _points(512, 64, 15), _points(512, 64, 16)
    before = match_cost_fwd_kernel.launches
    got = earth_mover_distance(x, y)
    torch.cuda.synchronize()
    assert match_cost_fwd_kernel.launches == before + 1
    torch.testing.assert_close(got, match_cost_fwd_reference(x, y) / 64, rtol=1e-4, atol=0)


@pytest.mark.parametrize("shape", [(3, 200, 136), (2, 1024, 2048), (2, 512, 512)])
def test_metric_dispatchers_launch_kernels_at_any_shape(cuda, shape):
    """fp32 CUDA clouds take K3 and, for nn_distance_auto, K5 (N != M) or K1
    twice (N == M) at ragged counts too, and agree with ops/chamfer.py."""
    from hyperpocket_tpu_torch.ops import chamfer, nn

    b, n, m = shape
    a, c = _points(b, n, 17), _points(b, m, 18)
    kernels = (nn.nn_min_fused, nn.nn_one_direction, nn.nn_fused_planes)
    before = [k.launches for k in kernels]
    mins = nn.nn_min_dists(a, c)
    per_cloud = nn.chamfer_per_cloud_auto(a, c)
    hausdorff = nn.directed_hausdorff_auto(a, c)
    dist1, idx1, dist2, idx2 = nn.nn_distance_auto(a, c)
    torch.cuda.synchronize()
    want_launches = (3, 0, 1) if n != m else (3, 2, 0)
    assert tuple(k.launches - n0 for k, n0 in zip(kernels, before)) == want_launches
    a64, c64 = a.double(), c.double()
    want1, _, want2, _ = chamfer.nn_distance(a64, c64)
    for got, want in ((mins[0], want1), (mins[1], want2), (dist1, want1), (dist2, want2),
                      (per_cloud, chamfer.chamfer_per_cloud(a64, c64)),
                      (hausdorff, chamfer.directed_hausdorff(a64, c64))):
        torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-6)
    assert torch.equal(idx1, nn.nn_one_direction_reference(a, c)[1])
    assert torch.equal(idx2, nn.nn_one_direction_reference(c, a)[1])
    for fn in (nn.nn_min_dists, nn.chamfer_per_cloud_auto, nn.directed_hausdorff_auto,
               nn.nn_distance_auto):
        with pytest.raises(ValueError, match="fp32"):
            fn(a.double(), c.double())


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("n, m", [(1000, 1000), (1000, 2048), (1024, 2048)])
def test_chamfer_loss_auto_launches_kernels_at_any_count(cuda, n, m, deterministic):
    """fp32 CUDA clouds take K9 once under grad (``chamfer_grad_route``),
    or under deterministic algorithms K1 twice (N == M) or K5 once (N != M),
    and K3 without grad, at counts off the 128 grid; fp64 keeps the plain
    chain."""
    from hyperpocket_tpu_torch.ops import nn

    kernels = (nn.nn_one_direction, nn.nn_min_fused, nn.nn_fused_planes, nn.chamfer_loss_grad)
    gts, preds = _points(4, n, 19), _points(4, m, 20).requires_grad_()
    before = [k.launches for k in kernels]
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        loss = nn.chamfer_loss_auto(gts, preds)
        (grad,) = torch.autograd.grad(loss, preds)
        with torch.no_grad():
            value = nn.chamfer_loss_auto(gts, preds)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    want_launches = ((0, 1, 0, 1) if not deterministic
                     else (2, 1, 0, 0) if n == m else (0, 1, 1, 0))
    assert tuple(k.launches - n0 for k, n0 in zip(kernels, before)) == want_launches
    want = chamfer_loss(gts.double(), preds.detach().double())
    assert abs(loss.item() - want.item()) <= 1e-5 * want.item()
    assert abs(value.item() - want.item()) <= 1e-5 * want.item()
    assert bool(torch.isfinite(grad).all())
    before = [k.launches for k in kernels]
    nn.chamfer_loss_auto(gts.double(), preds.detach().double())
    assert [k.launches for k in kernels] == before


# K5 (ops/nn.py::nn_fused_planes): the same distance arithmetic as K1 and the
# plain version, so distances are bit-equal and indices equal, against both
# the plain version and K1 run once each way. The sweep cuts the keys into
# splits (ops/nn.py::nn_fused_split): the dup_split, ragged_split and
# one_tile cases straddle them.

K5_CASES = NN_CASES + ["B64_1024x2048", "B64_2048x1024", "dup_both", "dup_adjacent",
                       "dup_split", "dup_split_even", "ragged_split", "one_tile"]


def _k5_case(case: str):
    if case == "dup_both":  # every query and every key twice: ties in both directions
        q, k = _points(2, 128, 21), _points(2, 96, 22)
        return torch.cat([q, q], dim=1).contiguous(), torch.cat([k, k], dim=1).contiguous()
    if case == "dup_adjacent":  # copies in neighbouring lanes: ties through the butterfly
        q, k = _points(2, 128, 29), _points(2, 96, 30)
        return q.repeat_interleave(2, dim=1), k.repeat_interleave(2, dim=1)
    if case.startswith("dup_split"):  # key j again at j + ceil(M / 2), in another split
        half = _points(4, 1001 if case == "dup_split" else 1000, 31)
        return _points(4, 600, 32), torch.cat([half, half[:, :1000]], dim=1).contiguous()
    if case == "ragged_split":  # M a multiple of neither the split count nor 32
        return _points(8, 700, 33), _points(8, 1000, 34)
    if case == "one_tile":  # one query tile, many splits
        return _points(1, 64, 35), _points(1, 4500, 36)
    if case in ("B64_1024x2048", "B64_2048x1024"):
        n, m = (int(v) for v in case[4:].split("x"))
        return _points(64, n, 23), _points(64, m, 24)
    return _nn_case(case)


@pytest.mark.parametrize("case", K5_CASES)
def test_nn_fused_planes_kernel_matches_reference_and_k1(cuda, case):
    from hyperpocket_tpu_torch.ops.nn import nn_fused_planes, nn_fused_planes_reference

    q, k = _k5_case(case)
    before = nn_fused_planes.launches
    got = nn_fused_planes(q, k)
    torch.cuda.synchronize()
    assert nn_fused_planes.launches == before + 1
    assert [t.dtype for t in got] == [torch.float32, torch.int32] * 2
    k1 = (*nn_one_direction(q, k), *nn_one_direction(k, q))
    for g, plain, one in zip(got, nn_fused_planes_reference(q, k), k1):
        assert torch.equal(g, plain) and torch.equal(g, one)
    if case == "dup_both":
        assert int(got[1].max()) < 96 and int(got[3].max()) < 128
    if case == "dup_adjacent":  # the first of each pair of copies
        assert not bool((got[1] % 2).any()) and not bool((got[3] % 2).any())
    if case.startswith("dup_split"):
        from hyperpocket_tpu_torch.ops.nn import _sm_count, nn_fused_split

        splits, length = nn_fused_split(*q.shape[:2], k.shape[1], _sm_count(q.device))
        assert splits > 1 and length < 1000  # the two copies lie in different splits
        assert int(got[1].max()) < k.shape[1] - 1000
    again = nn_fused_planes(q, k)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def _fused_outputs(symbol: str, q, k):
    b, n, m = q.shape[0], q.shape[1], k.shape[1]
    words = torch.empty(b * (n + m), dtype=torch.int64, device=q.device)
    if symbol == "hpcd_nn_fused_planes":
        return (torch.empty(b * (n + m), device=q.device),
                torch.empty(b * (n + m), dtype=torch.int32, device=q.device), words)
    return torch.empty_like(q), torch.empty(b * (3 * m + 1), device=q.device), words


@pytest.mark.parametrize("split", [(1, 4500), (2, 2272), (3, 1500), (36, 128), (141, 32)])
def test_k5_and_k9_give_the_planner_result_at_any_split(cuda, split):
    """One split of 4500 keys is five chunks through the double buffer; every
    valid split gives K5's bits and K9's values to their tolerance."""
    from hyperpocket_tpu_torch.ops import nn

    q, k = _nn_case("long_keys")
    out = _fused_outputs("hpcd_nn_fused_planes", q, k)
    nn._launch("hpcd_nn_fused_planes", q, k, *out, split=split)
    torch.cuda.synchronize()
    want = nn.nn_fused_planes(q, k)
    assert torch.equal(out[0], torch.cat([want[0].flatten(), want[2].flatten()]))
    assert torch.equal(out[1], torch.cat([want[1].flatten(), want[3].flatten()]))
    ga, gb_loss, words = _fused_outputs("hpcd_chamfer_loss_grad", q, k)
    nn._launch("hpcd_chamfer_loss_grad", q, k, ga, gb_loss, words, split=split)
    torch.cuda.synchronize()
    want_loss, want_ga, want_gb = nn.chamfer_loss_grad_reference(q, k)
    torch.testing.assert_close(gb_loss[-2:], want_loss, rtol=1e-5, atol=0)
    _close_to_scale(ga, want_ga)
    _close_to_scale(gb_loss[:-2].view_as(want_gb), want_gb)


@pytest.mark.parametrize("symbol", ["hpcd_nn_fused_planes", "hpcd_chamfer_loss_grad"])
@pytest.mark.parametrize("split", [(1, 63), (2, 31), (3, 32), (0, 64), (1, 0)])
def test_k5_and_k9_refuse_a_split_that_does_not_cover_the_keys(cuda, symbol, split):
    from hyperpocket_tpu_torch.ops import nn

    q, k = _points(2, 100, 37), _points(2, 64, 38)
    with pytest.raises(RuntimeError, match="CUDA error"):
        nn._launch(symbol, q, k, *_fused_outputs(symbol, q, k), split=split)


def test_nn_distance_pallas_backward_through_k5(cuda):
    from hyperpocket_tpu_torch.ops import chamfer, nn

    a, c = _points(8, 1024, 25), _points(8, 2048, 26).requires_grad_()
    before = nn.nn_fused_planes.launches, nn.nn_one_direction.launches
    d1, i1, d2, i2 = nn.nn_distance_pallas(a, c)
    (g,) = torch.autograd.grad(d1.sum() + 2.0 * d2.sum(), c)
    assert (nn.nn_fused_planes.launches - before[0], nn.nn_one_direction.launches - before[1]) \
        == (1, 0)
    _, want_g = chamfer.nn_backward(a, c.detach(), i1, i2, torch.ones_like(d1),
                                    torch.full_like(d2, 2.0))
    torch.testing.assert_close(g, want_g, rtol=0, atol=1e-6)


# K9 (ops/nn.py::chamfer_loss_grad): the loss within 1e-5 relative of the
# plain version's, and both gradient fields within 1e-5 of the tensor's
# largest entry (atomic sums land in a changing order).


def _close_to_scale(got, want, tol=1e-5):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.parametrize("case", K5_CASES)
def test_chamfer_loss_grad_kernel_matches_reference(cuda, case):
    from hyperpocket_tpu_torch.ops.nn import (
        chamfer_loss_grad,
        chamfer_loss_grad_reference,
        nn_min_fused,
    )

    q, k = _k5_case(case)
    before = chamfer_loss_grad.launches
    loss, ga, gb = chamfer_loss_grad(q, k)
    torch.cuda.synchronize()
    assert chamfer_loss_grad.launches == before + 1
    want_loss, want_ga, want_gb = chamfer_loss_grad_reference(q, k)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    d1, d2 = nn_min_fused(q, k)
    torch.testing.assert_close(loss, d1.sum(dim=1) + d2.sum(dim=1), rtol=1e-5, atol=0)
    _close_to_scale(ga, want_ga)
    _close_to_scale(gb, want_gb)


def test_chamfer_loss_fused_value_and_grad(cuda):
    from hyperpocket_tpu_torch.ops.nn import (
        chamfer_loss_fused,
        chamfer_loss_grad,
        chamfer_loss_grad_reference,
        chamfer_loss_streaming,
    )

    gts, preds = _points(8, 2048, 27).requires_grad_(), _points(8, 1024, 28).requires_grad_()
    before = chamfer_loss_grad.launches
    loss = chamfer_loss_fused(gts, preds)
    g1 = torch.autograd.grad(loss, (gts, preds), retain_graph=True)
    g3 = torch.autograd.grad(3.0 * loss, (gts, preds))
    assert chamfer_loss_grad.launches == before + 1
    with torch.no_grad():
        value = chamfer_loss_streaming(gts, preds)
        assert abs(chamfer_loss_fused(gts, preds).item() - value.item()) == 0
    assert chamfer_loss_grad.launches == before + 1
    assert abs(loss.item() - value.item()) <= 1e-5 * value.item()
    _, want_ga, want_gb = chamfer_loss_grad_reference(gts.detach(), preds.detach())
    _close_to_scale(g1[0], want_ga)
    _close_to_scale(g1[1], want_gb)
    for a, b in zip(g3, g1):
        torch.testing.assert_close(a, 3.0 * b, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="fp32"):
        chamfer_loss_grad(gts.detach().double(), preds.detach().double())


# K10 (ops/decoder.py::decode_batch) vs its plain version, in both roundings:
# fp32 (CUDA cores, csrc/decode_batch.cu) within 2e-5 (summation order,
# tests/test_pallas_decoder.py's bound; relative to the output's largest entry
# where it passes 1); bf16 (tensor cores, csrc/decode_batch_tc.cu, or the
# CUDA-core kernel's bf16 instantiation for wider layers) within one bf16 step
# of the value or 2e-2 of the output's largest entry (a hidden value near a
# rounding boundary may round one step apart in the two summation orders and
# carry that through the later layers).

DECODE_CHANNELS = [(32, 64, 128, 64), (8, 16), (16,), ()]
# widths the tensor-core kernel cannot hold: a layer wider than 256 channels,
# weights above a block's shared memory, and the widest layer K10 takes
WIDE_DECODE_CHANNELS = [(272,), (256, 256), (512, 1024, 512), (4096,), (32, 4096, 32)]


def _decode_inputs(channels, use_bias, batch, n, dtype, seed=0):
    from hyperpocket_tpu_torch.models.hyper_network import target_weight_count

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = target_weight_count(list(channels), use_bias)
    flat = torch.randn((batch, w), generator=g, device="cuda") * 0.2
    pts = torch.randn((batch, n, 3), generator=g, device="cuda") * 0.5
    return flat.to(dtype), pts.to(dtype)


@pytest.mark.parametrize("shape", [(3, 64), (2, 1000), (4, 2048)])
@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("channels", DECODE_CHANNELS)
def test_decode_batch_kernel_matches_reference_fp32(cuda, channels, use_bias, shape):
    from hyperpocket_tpu_torch.models.target_network import batched_target_network_forward
    from hyperpocket_tpu_torch.ops.decoder import decode_batch, decode_batch_reference

    flat, pts = _decode_inputs(channels, use_bias, *shape, torch.float32)
    before = decode_batch.launches
    got = decode_batch(flat, pts, channels, use_bias)
    torch.cuda.synchronize()
    assert decode_batch.launches == before + 1
    assert got.shape == pts.shape and got.dtype == torch.float32
    want = decode_batch_reference(flat, pts, channels, use_bias)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    chain = batched_target_network_forward(flat, pts, list(channels), use_bias)
    torch.testing.assert_close(got, chain, rtol=2e-5, atol=2e-5)
    assert torch.equal(decode_batch(flat, pts, channels, use_bias), got)


def _decode_bf16_close(got, want):
    err = (got.float() - want.float()).abs()
    return bool((err <= torch.maximum(_bf16_step(want.float()),
                                      2e-2 * want.float().abs().max())).all())


@pytest.mark.parametrize("shape", [(3, 64), (2, 1000), (4, 2048), (1, 1), (256, 2048)])
@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("channels", DECODE_CHANNELS)
def test_decode_batch_kernel_matches_reference_bf16(cuda, channels, use_bias, shape):
    from hyperpocket_tpu_torch.models.target_network import batched_target_network_forward
    from hyperpocket_tpu_torch.ops.decoder import decode_batch, decode_batch_reference

    flat, pts = _decode_inputs(channels, use_bias, *shape, torch.bfloat16, seed=1)
    before = decode_batch.launches
    got = decode_batch(flat, pts, channels, use_bias)
    torch.cuda.synchronize()
    assert decode_batch.launches == before + 1
    assert got.shape == pts.shape and got.dtype == torch.bfloat16
    assert _decode_bf16_close(got, decode_batch_reference(flat, pts, channels, use_bias))
    chain = batched_target_network_forward(flat, pts, list(channels), use_bias)
    assert (got.float() - chain.float()).abs().max() <= 0.05 * max(1.0, chain.abs().max())
    # weights given in fp32 are rounded to the points' bf16 first
    assert torch.equal(decode_batch(flat.float(), pts, channels, use_bias), got)


@pytest.mark.parametrize("channels", [(20,), (24, 40), (200, 72), (256,)])
def test_decode_batch_bf16_kernel_pads_other_widths(cuda, channels):
    """Widths that are no multiple of 16 or 8 (zero padding, the element-wise
    staging path) and the instantiation for up to 256 channels."""
    from hyperpocket_tpu_torch.ops.decoder import decode_batch, decode_batch_reference

    flat, pts = _decode_inputs(channels, True, 5, 129, torch.bfloat16, seed=2)
    got = decode_batch(flat, pts, channels)
    assert _decode_bf16_close(got, decode_batch_reference(flat, pts, channels))


@pytest.mark.parametrize("first", [1, 2, 3, 5])
def test_decode_batch_bf16_rows_that_start_2_byte_aligned(cuda, first):
    """A row is 38,022 bytes at the chair widths, so an odd sample's row
    starts 2 bytes off a 4-byte boundary: the kernel copies rows from the
    16-byte boundary below and shifts them into place. The batch from sample
    ``first`` on gives the whole batch's bits for those samples."""
    from hyperpocket_tpu_torch.ops.decoder import decode_batch, decode_batch_reference

    channels = (32, 64, 128, 64)
    flat, pts = _decode_inputs(channels, True, 8, 300, torch.bfloat16, seed=3)
    whole = decode_batch(flat, pts, channels)
    part = decode_batch(flat[first:], pts[first:], channels)
    assert flat[first:].data_ptr() % 16 != 0
    assert torch.equal(part, whole[first:])
    assert _decode_bf16_close(part, decode_batch_reference(flat[first:], pts[first:], channels))


def test_decode_batch_kernel_rejects_what_it_cannot_take(cuda):
    from hyperpocket_tpu_torch.ops.decoder import decode_batch

    flat, pts = _decode_inputs((8, 16), True, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="not fully consumed"):
        decode_batch(flat[:, :-1], pts, (8, 16))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        decode_batch(flat.double(), pts.double(), (8, 16))
    with pytest.raises(ValueError, match="one device"):
        decode_batch(flat.cpu(), pts, (8, 16))
    before = decode_batch.launches
    for channels in ((4097,), (8,) * 16):  # a layer above 4096 channels; 17 layers
        for dtype in (torch.float32, torch.bfloat16):
            wide, wpts = _decode_inputs(channels, True, 1, 8, dtype)
            with pytest.raises(ValueError, match="at most 16 layers of 1 to 4096 channels"):
                decode_batch(wide, wpts, channels)
    assert decode_batch.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", DECODE_CHANNELS)
def test_decode_batch_chain_rounding_matches_reference(cuda, channels, dtype):
    """``round_product=True``, the model route's rounding, against the plain
    version's; in bf16 it rounds where the ``bmm`` chain rounds."""
    from hyperpocket_tpu_torch.models.target_network import batched_target_network_forward
    from hyperpocket_tpu_torch.ops.decoder import decode_batch, decode_batch_reference

    flat, pts = _decode_inputs(channels, True, 4, 2048, dtype, seed=7)
    got = decode_batch(flat, pts, channels, round_product=True)
    want = decode_batch_reference(flat, pts, channels, round_product=True)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert _decode_bf16_close(got, want)
        chain = batched_target_network_forward(flat, pts, list(channels), True)
        # the same roundings as the chain, so closer to it than the kernel's rounding
        assert (got.float() - chain.float()).abs().mean() < (
            decode_batch(flat, pts, channels).float() - chain.float()).abs().mean()


@pytest.mark.parametrize("round_product", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", WIDE_DECODE_CHANNELS)
def test_decode_batch_wide_widths_match_reference(cuda, channels, dtype, round_product):
    """The CUDA-core kernel at widths the tensor-core kernel cannot hold, its
    weights resident in shared memory or streamed through it; bf16 counts
    its launches apart."""
    from hyperpocket_tpu_torch.ops.decoder import decode_batch, decode_batch_reference

    flat, pts = _decode_inputs(channels, True, 2, 300, dtype, seed=8)
    flat = flat * 0.25  # keeps the wider layers' outputs of order 1
    before = (decode_batch.launches, decode_batch.launches_bf16_simt)
    got = decode_batch(flat, pts, channels, round_product=round_product)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (decode_batch.launches - before[0], decode_batch.launches_bf16_simt - before[1]) == (
        1, int(bf16))
    want = decode_batch_reference(flat, pts, channels, round_product=round_product)
    if bf16:
        assert _decode_bf16_close(got, want)
        # one rounding apart stays inside the gate: the outputs equal their own
        # rounding's plain version more often than the other's
        other = decode_batch_reference(flat, pts, channels, round_product=not round_product)
        assert (got == want).float().mean() > (got == other).float().mean()
    else:
        limit = 2e-5 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=2e-5, atol=limit)


@pytest.mark.parametrize("first", [1, 2, 3, 5])
def test_decode_batch_fp32_rows_that_start_4_byte_aligned(cuda, first):
    """An fp32 row is 76,044 bytes at the chair widths, so a sample's row
    starts 4, 8 or 12 bytes off a 16-byte boundary: the kernel copies rows
    from the boundary below. The batch from sample ``first`` on gives the
    whole batch's bits for those samples."""
    from hyperpocket_tpu_torch.ops.decoder import decode_batch

    channels = (32, 64, 128, 64)
    flat, pts = _decode_inputs(channels, True, 8, 300, torch.float32, seed=3)
    whole = decode_batch(flat, pts, channels)
    part = decode_batch(flat[first:], pts[first:], channels)
    assert flat[first:].data_ptr() % 16 != 0
    assert torch.equal(part, whole[first:])


def test_decode_op_opcheck_on_cuda(cuda):
    """``hyperpocket::decode_batch``'s schema, fake tensor and dispatch checks
    with CUDA tensors, in both dtypes; every call through the op launches K10."""
    from hyperpocket_tpu_torch.ops.decoder import decode_batch

    channels = [32, 64, 128, 64]
    for dtype in (torch.float32, torch.bfloat16):
        flat, pts = _decode_inputs(channels, True, 2, 300, dtype, seed=4)
        torch.library.opcheck(torch.ops.hyperpocket.decode_batch.default,
                              (flat, pts, channels, True))
        before = decode_batch.launches
        torch.ops.hyperpocket.decode_batch(flat, pts, channels, True)
        torch.cuda.synchronize()
        assert decode_batch.launches == before + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_served_request_launches_k10_once(cuda, dtype):
    """The chair model at full width: a ``make_serving_fn`` request decodes
    through K10 once (and runs K4 once in bf16), as one replay of its graph;
    the first request of a signature also runs the forward once eagerly, its
    warm-up, so it counts each kernel twice. A train step launches no K10."""
    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.models.full_model import FullModel
    from hyperpocket_tpu_torch.ops.decoder import decode_batch

    cfg = _settings("config_3depn_chair.json")["full_model"]
    cfg["compute_dtype"] = dtype
    model = FullModel.from_config(cfg, torch.Generator().manual_seed(6))
    f = serving.make_serving_fn(model, num_output_points=2048, device=cuda)
    existing = _points(4, 1024, seed=13)
    noise = torch.randn((4, model.get_noise_size()), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(14)) * 0.13
    k4 = 1 if dtype == "bfloat16" else 0
    for seed, runs in ((3, 2), (4, 1)):  # warm-up and replay, then a replay
        before = (decode_batch.launches, trunk_pooled.launches)
        out = f(existing, noise, seed)
        torch.cuda.synchronize()
        assert (decode_batch.launches - before[0], trunk_pooled.launches - before[1]) == (
            runs, runs * k4)
        assert out.shape == (4, 2048, 3) and bool(torch.isfinite(out).all())
    model = model.to(cuda)
    before = decode_batch.launches
    rec, _, _ = model.apply(existing, existing, torch.Generator(device=cuda).manual_seed(1),
                            1.0, num_output_points=2048, training=True)
    torch.cuda.synchronize()
    assert decode_batch.launches == before and rec.shape == (4, 2048, 3)


@pytest.mark.parametrize("channels", [(272,), (4100,), (8,) * 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inference_with_widths_k10_cannot_take_raises(cuda, dtype, channels):
    """No width raises. A 272-channel target layer, which the tensor-core
    kernel cannot hold, decodes through K10 once (bf16 on the CUDA-core
    kernel), with the chain's rounding, within K10's gates of the plain
    version on its own flat weights. A decoder beyond K10's limits (a layer
    of 4100 channels, 17 layers) takes the ``bmm`` chain, fixed when the
    model is built: K10 launches no time and the output is the chain's."""
    from hyperpocket_tpu_torch.models.full_model import FullModel
    from hyperpocket_tpu_torch.models.target_network import batched_target_network_forward
    from hyperpocket_tpu_torch.ops.decoder import decode_batch, decode_batch_reference

    cfg = _settings("config_3depn_chair.json")["full_model"]
    cfg["compute_dtype"] = dtype
    cfg["target_network"]["layer_out_channels"] = list(channels)
    model = FullModel.from_config(cfg, torch.Generator().manual_seed(6)).to(cuda)
    beyond = channels != (272,)
    assert model.decode_route == ("chain" if beyond else "k10")
    cd = model.compute_torch_dtype
    existing = _points(2, 1024, seed=15)
    noise = torch.randn((2, model.get_noise_size()), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(16)) * 0.13
    balls = torch.rand((2, 512, 3), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(17)) - 0.5
    before = (decode_batch.launches, decode_batch.launches_bf16_simt)
    out = model.apply(existing, existing, None, 1.0, num_output_points=512, training=False,
                      noise=noise, ball_points=balls)
    torch.cuda.synchronize()
    assert (decode_batch.launches - before[0], decode_batch.launches_bf16_simt - before[1]) == (
        (0, 0) if beyond else (1, int(dtype == "bfloat16")))
    with torch.no_grad():
        latent, _, _ = model._get_latent(existing.to(cd), existing.to(cd), None, False,
                                         noise.to(cd), None)
        flat = model.hyper_network(latent)
        if beyond:
            chain = batched_target_network_forward(flat, balls.to(cd), list(channels), True)
            assert torch.equal(out, chain.float())
            return
        want = decode_batch_reference(flat, balls.to(cd), [272], True,
                                      round_product=True).float()
    assert out.shape == (2, 512, 3) and bool(torch.isfinite(out).all())
    if dtype == "bfloat16":
        assert _decode_bf16_close(out, want)
    else:
        limit = 2e-5 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(out, want, rtol=2e-5, atol=limit)


# K8 (ops/trunk_pool.py::trunk_pooled_argmax): the pooled values are K4's,
# bit for bit (one layer chain), and the index is the first point where the
# kernel's own per-point values reach them: K4 on a cloud of 8 copies of one
# point gives that point's values, the same bits as inside any tile, and
# torch.max over them (first index of equal maxima) must give K8's values
# and indices exactly. Against the plain version (another summation order,
# so a layer may round one bf16 step apart and carry that through the
# layers after it): pooled within BF16_ATOL, the plain value at the kernel's
# point within BF16_ATOL of the plain maximum, and the indices equal where
# the plain maximum leads its channel by more than 2 BF16_ATOL.


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 step at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(1e-30)))
    return torch.exp2(e - 7)


def _per_point_kernel_values(layers, x):
    """K4's values at every point of x: (B, N, 512) bf16."""
    b, n = x.shape[:2]
    copies = x.reshape(b * n, 1, 3).expand(b * n, 8, 3).contiguous()
    return trunk_pooled(layers, copies).view(b, n, 512)


def _check_argmax(layers, x, pooled, idx):
    from hyperpocket_tpu_torch.ops.trunk_pool import _stack_reference

    values = _per_point_kernel_values(layers, x).float()
    own_max, own_idx = torch.max(values, dim=1)
    assert torch.equal(pooled.float(), own_max) and torch.equal(idx, own_idx.int())
    stack = _stack_reference(layers, x).float()  # (B, N, 512)
    top2 = stack.topk(2, dim=1).values
    want_max, want_idx = torch.max(stack, dim=1)
    assert (pooled.float() - want_max).abs().max().item() <= BF16_ATOL
    at_idx = torch.gather(stack, 1, idx.long()[:, None, :])[:, 0]
    assert (want_max - at_idx).max().item() <= BF16_ATOL
    clear = (top2[:, 0] - top2[:, 1]) > 2 * BF16_ATOL
    assert torch.equal(idx[clear], want_idx[clear].int())


@pytest.mark.parametrize("shape", [(64, 1024), (3, 200), (1, 8), (2, 72), (1, 136), (5, 128)])
def test_trunk_argmax_kernel_matches_reference(layers, shape):
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled_argmax

    x = _cloud(*shape)
    before = trunk_pooled_argmax.launches
    pooled, idx = trunk_pooled_argmax(layers, x)
    torch.cuda.synchronize()
    assert trunk_pooled_argmax.launches == before + 1
    assert pooled.dtype == torch.bfloat16 and idx.dtype == torch.int32
    assert pooled.shape == idx.shape == (shape[0], 512)
    assert bool((idx >= 0).all()) and bool((idx < shape[1]).all())
    assert torch.equal(pooled, trunk_pooled(layers, x))
    _check_argmax(layers, x, pooled, idx)
    again = trunk_pooled_argmax(layers, x)
    assert torch.equal(again[0], pooled) and torch.equal(again[1], idx)


@pytest.mark.parametrize("base_points", [64, 128, 200, 72, 192])
def test_trunk_argmax_first_index_of_duplicates(layers, base_points):
    """Every point twice, base_points apart (in one tile, or in another tile):
    the first copy's index wins. 128 and 72 put the copies in the two CTAs of
    one cluster; 192 (three tiles a cloud) also in tiles of two clusters."""
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled_argmax

    base = _cloud(2, base_points, seed=2)
    x = torch.cat([base, base], dim=1).contiguous()
    pooled, idx = trunk_pooled_argmax(layers, x)
    assert int(idx.max()) < base_points
    base_pooled, base_idx = trunk_pooled_argmax(layers, base)
    assert torch.equal(pooled, base_pooled) and torch.equal(idx, base_idx)


def test_trunk_argmax_kernel_rejects_what_it_cannot_take(layers):
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled_argmax

    x = _cloud(2, 64)
    with pytest.raises(ValueError, match="bf16"):
        trunk_pooled_argmax(layers, x.float())
    with pytest.raises(ValueError, match="multiple of 8"):
        trunk_pooled_argmax(layers, _cloud(2, 60))


# K11 (ops/head_adam.py::head_adam_update): the kernel sums dw over the batch
# in order, cuBLAS in another, so dw differs by fp32 rounding. With a state
# at count > 1 the update is smooth in dw: p within two fp32 steps of p plus
# 1e-5 lr on all but 1e-4 of the entries, and within 2 lr everywhere (a
# near-zero dw may flip the update's sign); m and v within one bf16 step
# (bf16) or 1e-6 relative (fp32), plus 1e-6 of the tensor's largest entry
# for values that cancel to near zero.


def _head_adam_close(p, m, v, want, lr):
    """The bounds above; returns the share of p beyond the tight bound."""
    err = (p - want[0]).abs()
    tight = 2 * torch.finfo(torch.float32).eps * want[0].abs() + 1e-5 * lr
    assert err.max().item() <= 2 * lr
    share = (err > tight).float().mean().item()
    assert share <= 1e-4
    for got_t, want_t in ((m, want[1]), (v, want[2])):
        diff = (got_t.float() - want_t.float()).abs()
        floor = 1e-6 * want_t.float().abs().max()
        if got_t.dtype == torch.bfloat16:
            assert bool((diff <= _bf16_step(want_t.float()) + floor).all())
        else:
            assert bool((diff <= 1e-6 * want_t.abs() + floor).all())
    return share


def _head_state(n, k, b, moment_dtype, in_dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn((b, k), generator=g, device="cuda").to(in_dtype)
    dout = (torch.randn((b, n), generator=g, device="cuda") * 1e-2).to(in_dtype)
    p = torch.randn((n, k), generator=g, device="cuda") * 0.02
    m = (torch.randn((n, k), generator=g, device="cuda") * 1e-3).to(moment_dtype)
    v = (torch.rand((n, k), generator=g, device="cuda") * 1e-5).to(moment_dtype)
    return h, dout, p, m, v


@pytest.mark.parametrize("n, k, b", [(339, 256, 8), (19011, 2048, 64), (40, 64, 70)])
@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_head_adam_kernel_matches_reference(cuda, n, k, b, moment_dtype, in_dtype):
    from hyperpocket_tpu_torch.ops.head_adam import (
        adam_scalars,
        head_adam_update,
        head_adam_update_reference,
    )

    lr = 1e-4
    sc = adam_scalars(lr, 0.9, 0.999, 1e-8, 5)
    h, dout, p, m, v = _head_state(n, k, b, moment_dtype, in_dtype)
    want = head_adam_update_reference(h, dout, p.clone(), m.clone(), v.clone(), sc)
    before = head_adam_update.launches
    got = head_adam_update(h, dout, p, m, v, sc)
    torch.cuda.synchronize()
    assert head_adam_update.launches == before + 1
    assert got[0] is p and got[1] is m and got[2] is v
    _head_adam_close(p, m, v, want, lr)
    # a fixed summation order: the same inputs give the same bits
    h2, dout2, p2, m2, v2 = _head_state(n, k, b, moment_dtype, in_dtype)
    head_adam_update(h2, dout2, p2, m2, v2, sc)
    assert torch.equal(p2, p) and torch.equal(m2, m) and torch.equal(v2, v)


def test_head_adam_kernel_rejects_what_it_cannot_take(cuda):
    from hyperpocket_tpu_torch.ops.head_adam import adam_scalars, head_adam_update

    sc = adam_scalars(1e-4, 0.9, 0.999, 1e-8, 1)
    h, dout, p, m, v = _head_state(40, 64, 4, torch.float32, torch.float32)
    with pytest.raises(ValueError, match="one device"):
        head_adam_update(h.cpu(), dout, p, m, v, sc)
    with pytest.raises(ValueError, match="share"):
        head_adam_update(h, dout, p, m, v.to(torch.bfloat16), sc)
    with pytest.raises(ValueError, match="multiple of 4"):
        head_adam_update(h[:, :62], dout, p[:, :62].contiguous(), m[:, :62].contiguous(),
                         v[:, :62].contiguous(), sc)


def test_fused_training_trunk_launches_k8_once(monkeypatch):
    """HPCD_TRUNK_FUSED_FWD=1: a bf16 encoder's training trunk launches K8
    once; its output and gradients follow the unfused trunk's (bf16 rounding
    of two summation orders: outputs within 5% of their scale, gradients
    within 10% relative L2)."""
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled_argmax

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    enc = Encoder(128, generator=torch.Generator().manual_seed(3)).cuda()
    x = _cloud(4, 1024, seed=4)

    def run(fused):
        if fused:
            monkeypatch.setenv("HPCD_TRUNK_FUSED_FWD", "1")
        else:
            monkeypatch.delenv("HPCD_TRUNK_FUSED_FWD", raising=False)
        enc.zero_grad(set_to_none=True)
        bf = {n: p.to(torch.bfloat16) for n, p in enc.named_parameters()}
        mu = torch.func.functional_call(enc, bf, (x,), {"is_vae": False})
        mu.float().square().sum().backward()
        return mu.float().detach(), [p.grad.clone() for p in enc.conv.parameters()]

    before = trunk_pooled_argmax.launches
    got, got_grads = run(True)
    torch.cuda.synchronize()
    assert trunk_pooled_argmax.launches == before + 1
    want, want_grads = run(False)
    assert trunk_pooled_argmax.launches == before + 1
    assert (got - want).abs().max().item() <= 0.05 * want.abs().max().item()
    for g, w in zip(got_grads, want_grads):
        assert (g - w).norm().item() <= 0.1 * w.norm().item()


# ---------------------------------------------------------------------------
# K4 as the custom op hyperpocket::trunk_pooled, the exported artifact, and
# the HyperRec configuration's steps


def test_trunk_op_opcheck_on_cuda(layers):
    """The op's schema, fake tensor and dispatch checks with CUDA tensors;
    every call through the op launches K4. The op has no gradient (K4 serves
    inference), so the checks take tensors that need none."""
    x = _cloud(2, 64, seed=2)
    weights, biases = [w.detach() for w, _ in layers], [b.detach() for _, b in layers]
    torch.library.opcheck(torch.ops.hyperpocket.trunk_pooled.default, (x, weights, biases))
    before = trunk_pooled.launches
    got = torch.ops.hyperpocket.trunk_pooled(x, weights, biases)
    torch.cuda.synchronize()
    assert trunk_pooled.launches == before + 1
    assert (got.float() - trunk_pooled_reference(layers, x).float()).abs().max() <= BF16_ATOL


def _settings(name: str) -> dict:
    import json
    from pathlib import Path

    return json.loads((Path(__file__).resolve().parents[1] / "settings" / name).read_text())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exported_artifact_serves_on_the_card(cuda, dtype):
    """The chair model at full width exported on the card: the artifact's
    completion is make_serving_fn's for the same seed (fp32 within 1e-5 of
    the output's scale, bf16 within 2e-2: K4's bound), and the bf16 program
    holds the op and launches K4 once a call (a replay), plus once in the
    first call's warm-up."""
    import io

    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.models.full_model import FullModel

    cfg = _settings("config_3depn_chair.json")["full_model"]
    cfg["compute_dtype"] = dtype
    model = FullModel.from_config(cfg, torch.Generator().manual_seed(5))
    batch, n_existing, n_out = 4, 1024, 2048
    data = serving.export_completion(model, batch=batch, n_existing=n_existing,
                                     num_output_points=n_out, device=cuda)
    f = serving.load_completion(data)
    assert f.meta["device"].startswith("cuda")
    targets = {str(n.target) for n in torch.export.load(io.BytesIO(data)).graph.nodes}
    assert ("hyperpocket.trunk_pooled.default" in targets) == (dtype == "bfloat16")
    assert "hyperpocket.decode_batch.default" in targets
    existing = _points(batch, n_existing, seed=8)
    noise = torch.randn((batch, model.get_noise_size()), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(9)) * 0.13
    want = serving.make_serving_fn(model, num_output_points=n_out, device=cuda)(
        existing, noise, 21)
    from hyperpocket_tpu_torch.ops.decoder import decode_batch

    before = trunk_pooled.launches, decode_batch.launches
    got = f(existing, noise, 21)
    again = f(existing, noise, 21)
    torch.cuda.synchronize()
    assert trunk_pooled.launches == before[0] + (3 if dtype == "bfloat16" else 0)
    assert decode_batch.launches == before[1] + 3
    assert got.shape == (batch, n_out, 3) and got.dtype == torch.float32 and got.is_cuda
    assert torch.equal(got, again)
    tol = 1e-5 if dtype == "float32" else BF16_ATOL
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


def test_hyperrec_steps_launch_k1_twice_and_k3(cuda):
    """settings/config_completion.json's model (HyperRec) at full width: a
    train step launches K9 once (K1 twice under deterministic algorithms)
    and no K3 or K10, a val step K3 and K10 once, and the trunk runs no K4
    in fp32."""
    from hyperpocket_tpu_torch.models.full_model import FullModel
    from hyperpocket_tpu_torch.ops.decoder import decode_batch
    from hyperpocket_tpu_torch.ops.nn import chamfer_loss_grad
    from hyperpocket_tpu_torch.train import optim, trainer

    config = _settings("config_completion.json")
    model = FullModel.from_config(config["full_model"],
                                  torch.Generator().manual_seed(7)).to(cuda)
    assert model.mode == "hyper_rec"
    tr = config["training"]
    opt = optim.make_optimizer(tr["optimizer"], optim.trainable_parameters(model))
    train_step = trainer.make_train_step(model, opt, float(tr["loss_coef"]))
    val_step = trainer.make_val_step(model, float(tr["loss_coef"]))
    partial, gt = _points(6, 2048, seed=10), _points(6, 2048, seed=11)
    gen = torch.Generator(device=cuda).manual_seed(12)
    kernels = (nn_one_direction, chamfer_loss_grad, nn_min_fused, trunk_pooled, decode_batch)
    before = [k.launches for k in kernels]
    loss, loss_r, loss_k, rec = train_step(partial, None, gt, gen, 1.0, 2048)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [0, 1, 0, 0, 0]
    assert torch.isfinite(loss) and rec.shape == (6, 2048, 3) and loss_k.item() == 0.0
    before = [k.launches for k in kernels]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        train_step(partial, None, gt, gen, 1.0, 2048)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 0, 0, 0, 0]
    before = [k.launches for k in kernels]
    val_loss, val_rec = val_step(partial[:4], None, gt[:4], gen, 1.0, 2048)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [0, 0, 1, 0, 1]
    assert torch.isfinite(val_loss) and val_rec.shape == (4, 2048, 3)


# ---------------------------------------------------------------------------
# The parallel layer over a one-rank NCCL group (NCCL takes one rank per card;
# larger worlds run on gloo in tests/test_torch_parallel_*.py)


@pytest.fixture
def nccl_group(cuda, tmp_path):
    from hyperpocket_tpu_torch.parallel import distributed

    assert distributed.initialize_multihost(f"file://{tmp_path}/store", 1, 0, device="cuda")
    yield torch.distributed.group.WORLD
    distributed.shutdown()


@pytest.mark.parametrize("n, m", [(2048, 2048), (1024, 2048), (300, 136)])
def test_ring_chamfer_on_one_rank_goes_through_the_nn_kernels(nccl_group, n, m):
    """One hop: K1 twice at N == M, K5 once at N != M; the indices are K5's or
    K1's own and the gradient that of ``nn_backward`` on them."""
    from hyperpocket_tpu_torch.ops.chamfer import nn_backward
    from hyperpocket_tpu_torch.ops.nn import nn_forward, nn_fused_planes
    from hyperpocket_tpu_torch.parallel.point_sharding import (
        chamfer_loss_point_sharded,
        nn_distance_point_sharded,
    )

    a = _points(4, n, seed=20).requires_grad_(True)
    b = _points(4, m, seed=21).requires_grad_(True)
    before = (nn_one_direction.launches, nn_fused_planes.launches)
    d1, i1, d2, i2 = nn_distance_point_sharded(a, b, nccl_group)
    torch.cuda.synchronize()
    launched = (nn_one_direction.launches - before[0], nn_fused_planes.launches - before[1])
    assert launched == ((2, 0) if n == m else (0, 1))
    w1, wi1, w2, wi2 = nn_forward(a.detach(), b.detach())
    assert torch.equal(d1, w1) and torch.equal(i1, wi1)
    assert torch.equal(d2, w2) and torch.equal(i2, wi2)
    loss = chamfer_loss_point_sharded(a, b, nccl_group)
    assert torch.equal(loss, (w1.sum() + w2.sum()))
    ga, gb = torch.autograd.grad(loss, (a, b))
    want_a, want_b = nn_backward(a.detach(), b.detach(), wi1, wi2, torch.ones_like(w1),
                                 torch.ones_like(w2))
    assert torch.allclose(ga, want_a, atol=1e-6) and torch.allclose(gb, want_b, atol=1e-6)


def test_data_parallel_train_step_on_one_rank_is_the_one_process_step(nccl_group):
    """The chair model at full width, fp32, B=8: the mesh step (global draws,
    NCCL all-reduce of the gradients and losses) gives the one-process step's
    bits, with deterministic algorithms (K2's ``index_add_`` sums by CUDA
    atomics otherwise, and two one-process runs differ in the last bits)."""
    import copy

    from hyperpocket_tpu_torch.models.full_model import FullModel
    from hyperpocket_tpu_torch.parallel import make_mesh
    from hyperpocket_tpu_torch.train import optim, trainer

    config = _settings("config_3depn_chair.json")
    base = FullModel.from_config(config["full_model"], torch.Generator().manual_seed(9)).to("cuda")
    tr = config["training"]
    existing, missing, gt = (_points(8, n, seed=s) for n, s in ((1024, 30), (1024, 31), (2048, 32)))
    outs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mesh in (None, make_mesh(1, 1)):
            model = copy.deepcopy(base)
            opt = optim.make_optimizer(tr["optimizer"], optim.trainable_parameters(model))
            step = trainer.make_train_step(model, opt, float(tr["loss_coef"]), mesh)
            gen = torch.Generator(device="cuda").manual_seed(33)
            losses = [torch.stack(step(existing, missing, gt, gen, 1.0, 2048)[:3])
                      for _ in range(2)]
            outs.append((torch.stack(losses), [p.detach().clone() for p in model.parameters()]))
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(p, q) for p, q in zip(outs[0][1], outs[1][1]))


def test_sharded_pairs_and_dp_serving_on_one_rank(nccl_group):
    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.eval.metrics import pairwise_emd_cd_multi
    from hyperpocket_tpu_torch.models.full_model import FullModel
    from hyperpocket_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 1)
    rows, cols = _points(5, 256, seed=40), _points(14, 256, seed=41).view(2, 7, 256, 3)
    want = pairwise_emd_cd_multi(rows, cols, 32)
    got = pairwise_emd_cd_multi(rows, cols, 32, mesh=mesh)
    assert all((g == w).all() for g, w in zip(got, want))
    config = _settings("config_3depn_chair.json")
    config["full_model"]["compute_dtype"] = "bfloat16"
    model = FullModel.from_config(config["full_model"], torch.Generator().manual_seed(10))
    existing = _points(8, 1024, seed=42)
    noise = _points(8, model.get_noise_size(), seed=43)[..., 0] * 0.1
    plain = serving.make_serving_fn(model, num_output_points=2048, device="cuda")
    dp = serving.make_serving_fn(model, num_output_points=2048, device="cuda", mesh=mesh)
    assert torch.equal(dp(existing, noise, 5), plain(existing, noise, 5))
    kw = dict(batch=8, n_existing=1024, num_output_points=2048, device="cuda")
    artifact = serving.load_completion(serving.export_completion(model, **kw))
    dp_artifact = serving.load_completion(serving.export_completion(model, data_parallel=1, **kw))
    assert torch.equal(dp_artifact(existing, noise, 5), artifact(existing, noise, 5))


# ---------------------------------------------------------------------------
# Scanned epochs (train/epoch_scan.py): the train and val steps as replays of
# a CUDA graph, against the eager steps on the same draws, bit for bit under
# deterministic algorithms (K2's index_add_ sums by atomics otherwise)

SCAN_STEPS, SCAN_BATCH = 4, 8


def _kernel_counts() -> dict:
    from hyperpocket_tpu_torch.ops import launch_counters

    return {f"{owner.__name__}.{attr}": getattr(owner, attr)
            for owner, attr in launch_counters()}


def _launched(before: dict) -> dict:
    return {k: n - before[k] for k, n in _kernel_counts().items() if n != before[k]}


def _scan_vs_eager(dtype: str, train: bool, mesh=None, steps: int = SCAN_STEPS) -> dict:
    """The chair model at full width in ``dtype``, one epoch of ``steps``
    stacked batches of SCAN_BATCH through the epoch function and through the
    eager step, from one model copy each: rows, last reconstruction,
    parameters, launches, and the epoch function."""
    import copy

    from hyperpocket_tpu_torch.models.full_model import FullModel
    from hyperpocket_tpu_torch.train import optim, trainer

    config = _settings("config_3depn_chair.json")
    config["full_model"]["compute_dtype"] = dtype
    base = FullModel.from_config(config["full_model"], torch.Generator().manual_seed(11)).to("cuda")
    tr, coef = config["training"], float(config["training"]["loss_coef"])
    data = [_points(steps * SCAN_BATCH, n, seed=s).view(steps, SCAN_BATCH, n, 3)
            for n, s in ((1024, 50), (1024, 51), (2048, 52))]
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mode in ("eager", "scan"):
            model = copy.deepcopy(base)
            opt = optim.make_optimizer(tr["optimizer"], optim.trainable_parameters(model))
            gens = [torch.Generator(device="cuda").manual_seed(60 + s) for s in range(steps)]
            before = _kernel_counts()
            fn = None
            if mode == "scan":
                fn = (trainer.make_train_epoch_scan(model, opt, coef, mesh) if train
                      else trainer.make_val_epoch_scan(model, coef, mesh))
                rows, rec = fn(*data, gens, 1.0, 2048)
            else:
                step = (trainer.make_train_step(model, opt, coef, mesh) if train
                        else trainer.make_val_step(model, coef, mesh))
                rows = []
                for s in range(steps):
                    *losses, rec = step(data[0][s], data[1][s], data[2][s], gens[s], 1.0, 2048)
                    rows.append(torch.stack(losses) if train else losses[0])
                rows = torch.stack(rows)
            torch.cuda.synchronize()
            out[mode] = {"rows": rows, "rec": rec, "launches": _launched(before), "fn": fn,
                         "params": [p.detach().clone() for p in model.parameters()]}
    finally:
        torch.use_deterministic_algorithms(False)
    return out


@pytest.mark.parametrize("case", ["float32", "bfloat16", "bfloat16_k8"])
def test_train_epoch_graph_equals_the_eager_loop(cuda, case, monkeypatch):
    """Forward, backward and Adam (capturable) captured once and replayed a
    step: the eager steps' losses, reconstruction and parameters bit for bit;
    ``.launches`` counts each replay's kernels (K1 twice, K8 twice with
    HPCD_TRUNK_FUSED_FWD=1) and the rehearsal's."""
    if case.endswith("_k8"):
        monkeypatch.setenv("HPCD_TRUNK_FUSED_FWD", "1")
    res = _scan_vs_eager(case.removesuffix("_k8"), train=True)
    eager, scan = res["eager"], res["scan"]
    assert torch.equal(scan["rows"], eager["rows"]) and torch.equal(scan["rec"], eager["rec"])
    assert all(torch.equal(p, q) for p, q in zip(scan["params"], eager["params"]))
    fn = scan["fn"]
    assert (fn.replays, fn.captures, fn.rehearsals) == (SCAN_STEPS, 1, 1)
    per_step = {"nn_one_direction.launches": 2}
    if case.endswith("_k8"):
        per_step["trunk_pooled_argmax.launches"] = 2
    assert eager["launches"] == {k: SCAN_STEPS * n for k, n in per_step.items()}
    assert scan["launches"] == {k: (SCAN_STEPS + 1) * n for k, n in per_step.items()}
    assert fn.launches_per_replay == {k.removesuffix(".launches"): n for k, n in per_step.items()}
    assert fn.capture_ms > 0 and bool(torch.isfinite(scan["rows"]).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_val_epoch_graph_equals_the_eager_loop(cuda, dtype):
    """The val step (K3, K10, and K4 twice in bf16) captured and replayed."""
    res = _scan_vs_eager(dtype, train=False)
    eager, scan = res["eager"], res["scan"]
    assert torch.equal(scan["rows"], eager["rows"]) and torch.equal(scan["rec"], eager["rec"])
    per_step = {"nn_min_fused.launches": 1, "decode_batch.launches": 1}
    if dtype == "bfloat16":
        per_step["trunk_pooled.launches"] = 2
    assert eager["launches"] == {k: SCAN_STEPS * n for k, n in per_step.items()}
    assert scan["launches"] == {k: (SCAN_STEPS + 1) * n for k, n in per_step.items()}
    assert scan["fn"].replays == SCAN_STEPS


def test_train_epoch_graph_on_a_one_rank_nccl_mesh(nccl_group):
    """The step under a (1, 1) mesh: the NCCL all-reduce of the gradients and
    of the losses is captured with it, and the replays give the eager mesh
    steps' bits."""
    from hyperpocket_tpu_torch.parallel import make_mesh

    res = _scan_vs_eager("float32", train=True, mesh=make_mesh(1, 1), steps=3)
    eager, scan = res["eager"], res["scan"]
    assert torch.equal(scan["rows"], eager["rows"])
    assert all(torch.equal(p, q) for p, q in zip(scan["params"], eager["params"]))
    assert scan["fn"].replays == 3


def test_a_body_that_syncs_the_host_raises_naming_the_line(cuda):
    """``.item()`` inside the captured body: GraphCaptureError naming that
    line, the counts untouched, and the card still works after it."""
    from hyperpocket_tpu_torch.models.full_model import FullModel
    from hyperpocket_tpu_torch.train.epoch_scan import EpochScan, GraphCaptureError

    cfg = _settings("config_3depn_chair.json")["full_model"]
    model = FullModel.from_config(cfg, torch.Generator().manual_seed(12))

    def body(existing, missing, gt, epoch, num_points, vae_eps, ball_points):
        total = existing.sum()
        scale = total.item()  # a host sync
        return (total * scale)[None], existing

    fn = EpochScan(body, model=model)
    data = [_points(2 * 4, n, seed=70).view(2, 4, n, 3) for n in (1024, 1024, 2048)]
    gens = [torch.Generator(device="cuda").manual_seed(s) for s in range(2)]
    before = _kernel_counts()
    with pytest.raises(GraphCaptureError, match=r"scale = total\.item\(\)"):
        fn(*data, gens, 1.0, 2048)
    assert _launched(before) == {} and fn.replays == 0
    assert torch.ones(3, device=cuda).sum().item() == 3.0


def test_k4_and_k8_replay_after_an_in_place_weight_update(layers):
    """K4 and K8 encode their TMA maps at capture: with the weights and the
    input updated in place, replays give the eager kernels' outputs on the
    new values."""
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled_argmax

    x = _cloud(4, 1024, seed=3)
    trunk_pooled(layers, x), trunk_pooled_argmax(layers, x)  # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        pooled = trunk_pooled(layers, x)
        pooled8, idx8 = trunk_pooled_argmax(layers, x)
    for step in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(pooled, trunk_pooled(layers, x))
        want8, want_idx = trunk_pooled_argmax(layers, x)
        assert torch.equal(pooled8, want8) and torch.equal(idx8, want_idx)
        with torch.no_grad():
            for w, b in layers:
                w.mul_(-1.25)
                b.add_(0.0625)
            x.copy_(_cloud(4, 1024, seed=4 + step))


# ---------------------------------------------------------------------------
# Serving graphs (serving.py through utils/cuda_graph.py::GraphCache): the
# forward captured once per input signature and replayed, against the eager
# forward on the same seed bit for bit. A signature's first call warms up
# (one eager forward, counted) and replays; every later call replays once.


def _chair(dtype: str, seed: int):
    from hyperpocket_tpu_torch.models.full_model import FullModel

    cfg = _settings("config_3depn_chair.json")["full_model"]
    cfg["compute_dtype"] = dtype
    return FullModel.from_config(cfg, torch.Generator().manual_seed(seed))


def _request(model, batch: int, seed: int):
    existing = _points(batch, 1024, seed=seed)
    noise = torch.randn((batch, model.get_noise_size()), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed + 1)) * 0.13
    return existing, noise


def _eager(served, existing, noise, seed: int) -> torch.Tensor:
    """The eager forward of a request: ``FullModel.apply`` drawing the ball
    points from a generator seeded with the request's seed."""
    return served.apply(existing, None, torch.Generator(device="cuda").manual_seed(seed), 1e9,
                        num_output_points=2048, training=False, noise=noise)


def _per_call(dtype: str, runs: int) -> dict:
    """The launches of ``runs`` forwards of the chair model: K10 once, K4 once in bf16."""
    return {"decode_batch.launches": runs,
            **({"trunk_pooled.launches": runs} if dtype == "bfloat16" else {})}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_serving_equals_the_eager_forward(cuda, dtype):
    """``make_serving_fn`` replays one graph: each call equals the eager
    forward with the same seed bit for bit, call 1's output is unchanged
    after call 2, and the counters read 2 launches of each kernel for the
    first call (warm-up and replay) and 1 for the second."""
    from hyperpocket_tpu_torch import serving

    model = _chair(dtype, 20)
    f = serving.make_serving_fn(model, num_output_points=2048, device=cuda)
    existing, noise = _request(model, 4, 21)
    before = _kernel_counts()
    first = f(existing, noise, 3)
    torch.cuda.synchronize()
    assert _launched(before) == _per_call(dtype, 2)
    kept = first.clone()
    before = _kernel_counts()
    second = f(existing, noise, 4)
    torch.cuda.synchronize()
    assert _launched(before) == _per_call(dtype, 1)
    assert torch.equal(first, kept) and not torch.equal(first, second)
    assert len(f.graphs.graphs) == 1 and f.graphs.replays == 2
    served = model.serving_params().to(cuda)
    assert torch.equal(first, _eager(served, existing, noise, 3))
    assert torch.equal(second, _eager(served, existing, noise, 4))


def test_a_second_batch_size_captures_a_second_graph(cuda):
    """Batches 4, 8, 4: two captures, three replays, each output the eager one."""
    from hyperpocket_tpu_torch import serving

    model = _chair("bfloat16", 22)
    f = serving.make_serving_fn(model, num_output_points=2048, device=cuda)
    served = model.serving_params().to(cuda)
    before = _kernel_counts()
    for batch in (4, 8, 4):
        existing, noise = _request(model, batch, 23 + batch)
        assert torch.equal(f(existing, noise, batch), _eager(served, existing, noise, batch))
    assert [key[0][0][0] for key in f.graphs.graphs] == [4, 8]  # the existing clouds' batch
    assert f.graphs.replays == 3 and len(f.graphs.first_call_ms) == 2
    assert all(g.pool_bytes > 0 and g.capture_ms > 0 for g in f.graphs.graphs.values())
    # two warm-ups, three replays and the three eager references
    assert _launched(before) == _per_call("bfloat16", 2 + 3 + 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_artifact_equals_its_eager_program(cuda, dtype):
    """``load_completion`` captures its program once and replays it: each
    call equals the loaded module called directly on the same ball points."""
    import io

    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.ops.sampling import generate_target_network_input_batch

    model = _chair(dtype, 30)
    data = serving.export_completion(model, batch=4, n_existing=1024, num_output_points=2048,
                                     device=cuda)
    f = serving.load_completion(data)
    program = torch.export.load(io.BytesIO(data)).module()
    existing, noise = _request(model, 4, 31)
    meta = f.meta
    for seed in (6, 7):
        got = f(existing, noise, seed)
        balls = generate_target_network_input_batch(
            meta["target_network_input"], torch.Generator(device=cuda).manual_seed(seed),
            meta["epoch"], 4, 2048, method=meta["ball_method"])
        with torch.no_grad():
            assert torch.equal(got, program(existing, noise, balls))
    assert len(f.graphs.graphs) == 1 and f.graphs.replays == 2


def test_graphed_dp_serving_on_one_rank_equals_the_eager_forward(nccl_group):
    """``make_serving_fn(mesh=)`` and a ``data_parallel=1`` artifact over a
    one-rank NCCL group: the all-gather is captured with the forward, and
    the replays give the eager forward's bits."""
    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.parallel import make_mesh

    model = _chair("bfloat16", 32)
    dp = serving.make_serving_fn(model, num_output_points=2048, device="cuda",
                                 mesh=make_mesh(1, 1))
    kw = dict(batch=4, n_existing=1024, num_output_points=2048, device="cuda")
    artifact = serving.load_completion(serving.export_completion(model, **kw))
    dp_artifact = serving.load_completion(serving.export_completion(model, data_parallel=1, **kw))
    served = model.serving_params().to("cuda")
    existing, noise = _request(model, 4, 33)
    for seed in (8, 9):
        assert torch.equal(dp(existing, noise, seed), _eager(served, existing, noise, seed))
        assert torch.equal(dp_artifact(existing, noise, seed), artifact(existing, noise, seed))
    assert dp.graphs.replays == dp_artifact.graphs.replays == 2
    assert len(dp.graphs.graphs) == len(dp_artifact.graphs.graphs) == 1


def test_a_served_forward_that_syncs_the_host_raises_naming_the_line(cuda, monkeypatch):
    """``.item()`` inside the served forward: GraphCaptureError naming that
    line, the warm-up's launches counted and the capture's taken back, no
    graph kept, and the card still works after it. Nothing serves eagerly:
    the next call captures again and raises again."""
    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.models.hyper_network import HyperNetwork
    from hyperpocket_tpu_torch.utils.cuda_graph import GraphCaptureError

    inner = HyperNetwork.forward

    def forward(self, latent, **kwargs):
        latent.abs().max().item()  # a host sync
        return inner(self, latent, **kwargs)

    monkeypatch.setattr(HyperNetwork, "forward", forward)
    model = _chair("bfloat16", 34)
    f = serving.make_serving_fn(model, num_output_points=2048, device=cuda)
    existing, noise = _request(model, 4, 35)
    for _ in range(2):
        before = _kernel_counts()
        with pytest.raises(GraphCaptureError, match=r"latent\.abs\(\)\.max\(\)\.item\(\)"):
            f(existing, noise, 1)
        torch.cuda.synchronize()
        assert _launched(before) == _per_call("bfloat16", 1)
    assert f.graphs.graphs == {} and f.graphs.replays == 0
    assert torch.ones(3, device=cuda).sum().item() == 3.0


def test_infer_writes_the_plys_of_the_eager_forward(cuda, tmp_path, monkeypatch):
    """``infer --config``, ``infer --artifact`` and ``infer --latent-prior``
    through the graphs write the PLYs, byte for byte, that they write with
    the graph cache made to call its function eagerly."""
    import json
    import os

    import numpy as np

    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.convert import save_jax_npz
    from hyperpocket_tpu_torch.data.plyio import save_ply
    from hyperpocket_tpu_torch.eval.latent_stats import LatentGaussian, save_latent_gaussian
    from hyperpocket_tpu_torch.train.config import get_results_dir_path
    from hyperpocket_tpu_torch.utils.cuda_graph import GraphCache

    config = _settings("config_3depn_chair.json")
    config["full_model"]["compute_dtype"] = "bfloat16"
    config["results_root"] = str(tmp_path / "results")
    model = _chair("bfloat16", 36)
    training = get_results_dir_path(config, "training")
    os.makedirs(os.path.join(training, "weights"))
    os.makedirs(os.path.join(training, "metrics"))
    save_jax_npz(os.path.join(training, "weights", "00001_model.npz"), model)
    np.save(os.path.join(training, "metrics", "00001_val.npy"), np.array([[1.0]]))
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(config))
    rng = np.random.default_rng(37)
    plys = []
    for i, n in enumerate((3000, 1500, 2500)):
        plys.append(str(tmp_path / f"scan{i}.ply"))
        save_ply(plys[-1], rng.normal(size=(n, 3)).astype(np.float32) * 0.2 + np.float32(i))
    art = str(tmp_path / "chair.pt2")
    assert serving.main(["export", "-c", str(cfg), "--out", art, "--batch", "4"]) == 0
    zdim = model.get_noise_size()
    prior = str(tmp_path / "prior.npz")
    save_latent_gaussian(LatentGaussian(rng.normal(size=zdim).astype(np.float32) * 0.1,
                                        np.eye(zdim, dtype=np.float32) * 0.13), prior)
    runs = {"config": ["--config", str(cfg), "--batch", "4", "--noise-std", "0.13"],
            "artifact": ["--artifact", art, "--noise-std", "0.13"],
            "latent_prior": ["--artifact", art, "--latent-prior", prior]}

    def written(route: str) -> dict:
        out = {}
        for name, args in runs.items():
            out_dir = tmp_path / route / name
            assert serving.main(["infer", *args, "--inputs", *plys, "--out-dir", str(out_dir),
                                 "--samples", "2", "--seed", "5"]) == 0
            out.update({f"{name}/{p.name}": p.read_bytes() for p in out_dir.glob("*.ply")})
        return out

    def call_eagerly(self, *inputs, seed=None):
        """The cache's function called directly, its generator seeded as a call seeds it."""
        self.generator.manual_seed(int(seed))
        return self.fn(*inputs)

    graphed = written("graphed")
    monkeypatch.setattr(GraphCache, "__call__", call_eagerly)
    eager = written("eager")
    assert len(graphed) == 18 and graphed == eager


# ---------------------------------------------------------------------------
# The training path's dispatch: the Chamfer route (K9 by default, the
# streaming value and gradient under deterministic algorithms) and the
# bf16-moment Adam's one pass a tensor (ops/adam_lowp.py), bit for bit with
# its plain version.

ADAM_SHAPES = [(19, 64), (1001,), (3, 5, 7), (4,), (512, 129)]  # vector body and tails


def _adam_run(param_dtype, moment_dtype: str, kind: str, wd: float, plain: bool,
              graphed: bool = False, seed: int = 0):
    """Three AdamLowp steps on ADAM_SHAPES from one seed: (p, mu, nu) a tensor."""
    from hyperpocket_tpu_torch.ops import adam_lowp
    from hyperpocket_tpu_torch.train import optim

    g = torch.Generator(device="cuda").manual_seed(seed)
    params = [torch.nn.Parameter((torch.randn(s, generator=g, device="cuda") * 0.02)
                                 .to(param_dtype)) for s in ADAM_SHAPES]
    grads = [[(torch.randn(s, generator=g, device="cuda")
               * 10.0 ** torch.randint(-6, 1, s, generator=g, device="cuda")).to(param_dtype)
              for s in ADAM_SHAPES] for _ in range(3)]
    opt = optim.make_optimizer({"type": kind, "hyperparams": {
        "lr": 1e-3, "weight_decay": wd, "moment_dtype": moment_dtype}}, params)
    own = optim.adam_lowp_update
    if plain:
        optim.adam_lowp_update = adam_lowp.adam_lowp_update_reference
    try:
        for i, step_grads in enumerate(grads):
            for p, grad in zip(params, step_grads):
                if p.grad is None:
                    p.grad = grad.clone()
                else:
                    p.grad.copy_(grad)
            if graphed and i == 1:
                graph = torch.cuda.CUDAGraph()
                torch.cuda.synchronize()
                with torch.cuda.graph(graph):
                    opt.step()
            if graphed and i >= 1:
                graph.replay()
            else:
                opt.step()
    finally:
        optim.adam_lowp_update = own
    torch.cuda.synchronize()
    return [(p.detach(), opt.state[p]["mu"], opt.state[p]["nu"]) for p in params]


@pytest.mark.parametrize("kind", ["Adam", "AdamW"])
@pytest.mark.parametrize("moment_dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_adam_lowp_kernel_matches_plain(cuda, param_dtype, moment_dtype, kind):
    """One launch a tensor and step; parameters and both moments bit-equal
    to the plain torch arithmetic on the card over three steps."""
    from hyperpocket_tpu_torch.ops.adam_lowp import adam_lowp_update

    before = adam_lowp_update.launches
    got = _adam_run(param_dtype, moment_dtype, kind, 0.05, plain=False, seed=3)
    assert adam_lowp_update.launches == before + 3 * len(ADAM_SHAPES)
    want = _adam_run(param_dtype, moment_dtype, kind, 0.05, plain=True, seed=3)
    assert adam_lowp_update.launches == before + 3 * len(ADAM_SHAPES)
    for g, w in zip(got, want):
        assert g[1].dtype == getattr(torch, moment_dtype)
        assert all(torch.equal(a, b) for a, b in zip(g, w))


@pytest.mark.parametrize("moment_dtype", ["bfloat16", "float16"])
def test_adam_lowp_captured_step_replays_as_eager(cuda, moment_dtype):
    """AdamLowp's step captured once (bc1 and bc2 read through pointers, the
    count on the device) and replayed twice: the eager steps' bits."""
    got = _adam_run(torch.float32, moment_dtype, "Adam", 0.0, plain=False, graphed=True, seed=4)
    want = _adam_run(torch.float32, moment_dtype, "Adam", 0.0, plain=False, seed=4)
    plain = _adam_run(torch.float32, moment_dtype, "Adam", 0.0, plain=True, seed=4)
    for g, w, q in zip(got, want, plain):
        assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(g, w, q))


def test_adam_lowp_rejects_what_it_cannot_take(cuda):
    from hyperpocket_tpu_torch.ops.adam_lowp import adam_lowp_update

    p = torch.zeros(8, device=cuda)
    mu = torch.zeros(8, device=cuda, dtype=torch.bfloat16)
    bc = torch.ones((), device=cuda)
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    with pytest.raises(ValueError, match="float64"):
        adam_lowp_update(p.double(), p.double(), mu, mu.clone(), bc, bc, **kw)
    with pytest.raises(ValueError, match="bfloat16"):
        adam_lowp_update(p, p.clone(), mu, mu.float(), bc, bc, **kw)
    with pytest.raises(ValueError, match="one device"):
        adam_lowp_update(p, p.cpu(), mu, mu.clone(), bc, bc, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        q = torch.zeros(16, device=cuda)[::2]
        adam_lowp_update(q, q.clone(), mu, mu.clone(), bc, bc, **kw)


def _chair_step(dtype: str, batch: int = 8):
    from hyperpocket_tpu_torch.models.full_model import FullModel
    from hyperpocket_tpu_torch.train import optim, trainer

    config = _settings("config_3depn_chair.json")
    config["full_model"]["compute_dtype"] = dtype
    model = FullModel.from_config(config["full_model"], torch.Generator().manual_seed(31)).cuda()
    opt = optim.make_optimizer(config["training"]["optimizer"], optim.trainable_parameters(model))
    step = trainer.make_train_step(model, opt, float(config["training"]["loss_coef"]))
    data = [_points(batch, n, seed=s) for n, s in ((1024, 32), (1024, 33), (2048, 34))]
    return model, step, data


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_launches_on_each_route(cuda, dtype, deterministic):
    """A train step at the chair's shapes launches K9 once and K1 never, or
    under deterministic algorithms K1 twice (the streaming route) and K9
    never; the route is recorded."""
    from hyperpocket_tpu_torch.ops import nn

    model, step, (existing, missing, gt) = _chair_step(dtype)
    gen = torch.Generator(device=cuda).manual_seed(35)
    before = _kernel_counts()
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        loss, *_ = step(existing, missing, gt, gen, 1.0, 2048)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    launched = _launched(before)
    want = ({"nn_one_direction.launches": 2} if deterministic
            else {"chamfer_loss_grad.launches": 1})
    assert {k: launched.get(k, 0) for k in ("nn_one_direction.launches",
                                            "chamfer_loss_grad.launches")} == {
        "nn_one_direction.launches": 0, "chamfer_loss_grad.launches": 0, **want}
    assert nn.chamfer_loss_auto.route == ("streaming" if deterministic else "k9")
    assert bool(torch.isfinite(loss))


def test_k9_route_first_step_gradients_match_streaming(cuda, monkeypatch):
    """The first step's gradients through K9 and through the streaming route
    from the same weights and draws: every trainable gradient within 1e-3
    relative L2 (the phase-8 gate), and the loss's gradient at the
    reconstruction within 1e-5 of its scale (both take the first argmins of
    the same distances, so no near-tie flips them; atomic sums part the
    last bits)."""
    from hyperpocket_tpu_torch.ops import nn
    from hyperpocket_tpu_torch.ops.sampling import generate_target_network_input_batch
    from hyperpocket_tpu_torch.train import optim
    from hyperpocket_tpu_torch.train.losses import kld_loss, reconstruction_loss

    model, _, (existing, missing, gt) = _chair_step("float32", batch=16)
    gen = torch.Generator(device=cuda).manual_seed(36)
    balls = generate_target_network_input_batch(model.target_network_input, gen, 1.0, 16, 2048)
    eps = torch.randn((16, model.get_noise_size()), generator=gen, device=cuda)
    params = optim.trainable_parameters(model)
    own = nn.chamfer_grad_route

    def grads(route):
        monkeypatch.setattr(nn, "chamfer_grad_route",
                            own if route == "k9" else
                            lambda g, p: "streaming" if own(g, p) == "k9" else own(g, p))
        model.zero_grad(set_to_none=True)
        rec, mu, sigma = model.apply(existing, missing, None, 1.0, num_output_points=2048,
                                     training=True, vae_eps=eps, ball_points=balls)
        rec.retain_grad()
        (reconstruction_loss(gt, rec, 0.05) + kld_loss(mu, sigma, 16)).backward()
        assert nn.chamfer_loss_auto.route == route
        return rec.grad.clone(), [p.grad.clone() for p in params if p.grad is not None]

    rec_k9, k9 = grads("k9")
    rec_st, st = grads("streaming")
    assert (rec_k9 - rec_st).abs().max().item() <= 1e-5 * rec_st.abs().max().item()
    flat_k9, flat_st = torch.cat([g.flatten() for g in k9]), torch.cat([g.flatten() for g in st])
    assert ((flat_k9 - flat_st).norm() / flat_st.norm()).item() <= 1e-3
