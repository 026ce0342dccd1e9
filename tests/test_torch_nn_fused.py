"""K5 and K9's plain versions, nn_distance_pallas and chamfer_loss_fused vs the JAX package.

The plain versions of K5 (``nn_fused_planes_reference``) and K9
(``chamfer_loss_grad_reference``, ``hyperpocket_tpu_torch/ops/nn.py``) are
held to the Pallas kernels ``_nn_fused_planes`` and ``_chamfer_loss_grad``
run in interpret mode at the JAX tests' shapes (N a multiple of 128, M of
8): K5's indices equal and distances within 1e-6 (the same arithmetic);
K9's loss within 1e-5 relative and its gradient fields within 1e-5 (the
fp32 parity budget: the Pallas kernel forms its sums through one-hot
contractions in another order). The ops built on them are held to the JAX
ops under ``jax.grad``. The CUDA kernels are held to these plain versions
on the card in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperpocket_tpu.ops import pallas_nn as jnn
from hyperpocket_tpu_torch.ops import nn
from tests.test_torch_nn import _t

NN_TOL = 1e-6
FP32_TOL = 1e-5


def _clouds(case: str, seed: int = 0):
    """(q, k) float32 numpy clouds, N a multiple of 128 and M of 8."""
    rng = np.random.default_rng(seed)
    if case == "ties":  # every query and every key twice: exact ties both ways
        q = (rng.standard_normal((2, 128, 3)) * 0.3).astype(np.float32)
        k = (rng.standard_normal((2, 64, 3)) * 0.3).astype(np.float32)
        return np.concatenate([q, q], axis=1), np.concatenate([k, k], axis=1)
    (b, n), m = {"rect": ((2, 256), 128), "multi_tile": ((1, 1024), 256),
                 "ragged_keys": ((2, 256), 136)}[case]
    return ((rng.standard_normal((b, n, 3)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, m, 3)) * 0.3).astype(np.float32))


@pytest.mark.parametrize("case", ["multi_tile", "rect", "ties"])
def test_nn_fused_planes_reference_matches_pallas_interpret(case):
    q, k = _clouds(case)
    want = jnn._nn_fused_planes(jnp.asarray(q), jnp.asarray(k), tile_n=256, interpret=True)
    got = nn.nn_fused_planes_reference(*_t(q, k))
    for g, w in zip(got[1::2], want[1::2]):  # idx1, idx2
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[0::2], want[0::2]):  # dist1, dist2
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=NN_TOL, rtol=0)
    # the same bits and indices as K1's plain version run once each way
    d1, i1 = nn.nn_one_direction_reference(*_t(q, k))
    d2, i2 = nn.nn_one_direction_reference(*_t(k, q))
    for g, w in zip(got, (d1, i1, d2, i2)):
        assert torch.equal(g, w)
    if case == "ties":  # the first copy wins on both sides
        assert int(got[1].max()) < 64 and int(got[3].max()) < 128


def test_cpu_wrappers_of_k5_and_k9_take_the_plain_path():
    q, k = _t(*_clouds("rect"))
    before = (nn.nn_fused_planes.launches, nn.chamfer_loss_grad.launches)
    for g, w in zip(nn.nn_fused_planes(q, k), nn.nn_fused_planes_reference(q, k)):
        assert torch.equal(g, w)
    for g, w in zip(nn.chamfer_loss_grad(q, k), nn.chamfer_loss_grad_reference(q, k)):
        assert torch.equal(g, w)
    assert (nn.nn_fused_planes.launches, nn.chamfer_loss_grad.launches) == before
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        nn.nn_fused_planes(q[..., :2], k)


@pytest.mark.parametrize("case,want", [("rect", ["K5"]), ("square", ["K1", "K1"])])
def test_nn_forward_takes_k5_when_the_counts_differ(monkeypatch, case, want):
    calls = []
    one, planes = nn.nn_one_direction, nn.nn_fused_planes
    monkeypatch.setattr(nn, "nn_one_direction", lambda q, k: calls.append("K1") or one(q, k))
    monkeypatch.setattr(nn, "nn_fused_planes", lambda q, k: calls.append("K5") or planes(q, k))
    q, k = _clouds("rect")
    if case == "square":
        k = q[:, ::-1].copy()
    a, b = _t(q, k, requires_grad=True)
    d1, i1, d2, i2 = nn.nn_distance_pallas(a, b)
    assert calls == want
    (d1.sum() + d2.sum()).backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape


@pytest.mark.parametrize("case", ["rect", "ties"])
def test_nn_distance_pallas_and_its_gradient_match_jax(case):
    a, b = _clouds(case, seed=4)
    rng = np.random.default_rng(4)
    g1 = rng.standard_normal(a.shape[:2]).astype(np.float32)
    g2 = rng.standard_normal(b.shape[:2]).astype(np.float32)
    ta, tb = _t(a, b, requires_grad=True)
    d1, i1, d2, i2 = nn.nn_distance_pallas(ta, tb)
    ((d1 * torch.tensor(g1)).sum() + (d2 * torch.tensor(g2)).sum()).backward()

    def weighted(a_, b_):
        e1, _, e2, _ = jnn.nn_distance_pallas(a_, b_)
        return jnp.sum(e1 * g1) + jnp.sum(e2 * g2)

    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want = jnn.nn_distance_pallas(ja, jb)
    want_ga, want_gb = jax.grad(weighted, argnums=(0, 1))(ja, jb)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(d1.detach().numpy(), np.asarray(want[0]), atol=NN_TOL, rtol=0)
    np.testing.assert_allclose(d2.detach().numpy(), np.asarray(want[2]), atol=NN_TOL, rtol=0)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_ga), atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_gb), atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("case", ["ragged_keys", "multi_tile_ragged", "ties"])
def test_chamfer_loss_grad_reference_matches_pallas_interpret(case):
    if case == "multi_tile_ragged":  # tests/test_pallas_nn.py::test_fused_loss_grad_multi_tile
        rng = np.random.default_rng(7)
        x = (rng.standard_normal((1, 512, 3)) * 0.3).astype(np.float32)
        y = (rng.standard_normal((1, 136, 3)) * 0.3).astype(np.float32)
    else:
        x, y = _clouds(case, seed=2)
    loss, ga, gb = jnn._chamfer_loss_grad(jnp.asarray(x), jnp.asarray(y), tile_n=128,
                                          interpret=True)
    got_loss, got_ga, got_gb = nn.chamfer_loss_grad_reference(*_t(x, y))
    assert got_loss.shape == (x.shape[0],)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(loss), rtol=FP32_TOL, atol=0)
    np.testing.assert_allclose(got_ga.numpy(), np.asarray(ga), atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(got_gb.numpy(), np.asarray(gb), atol=FP32_TOL, rtol=0)


def test_chamfer_loss_fused_value_and_grads_match_jax(monkeypatch):
    x, y = _clouds("rect", seed=1)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    want = float(jnn.chamfer_loss_fused(jx, jy))
    want_gx, want_gy = jax.grad(jnn.chamfer_loss_fused, argnums=(0, 1))(jx, jy)
    calls = []
    grad_fn, min_fn = nn.chamfer_loss_grad, nn.nn_min_fused
    monkeypatch.setattr(nn, "chamfer_loss_grad", lambda q, k: calls.append("K9") or grad_fn(q, k))
    monkeypatch.setattr(nn, "nn_min_fused", lambda q, k: calls.append("K3") or min_fn(q, k))

    g, p = _t(x, y, requires_grad=True)
    loss = nn.chamfer_loss_fused(g, p)
    assert calls == ["K9"] and "ChamferFused" in type(loss.grad_fn).__name__
    gx, gy = torch.autograd.grad(loss, (g, p), retain_graph=True)
    gx3, gy3 = torch.autograd.grad(3.0 * loss, (g, p))
    assert abs(loss.item() - want) <= FP32_TOL * abs(want)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(gy.numpy(), np.asarray(want_gy), atol=FP32_TOL, rtol=0)
    # the cotangent only scales the saved fields
    np.testing.assert_allclose(gx3.numpy(), 3.0 * gx.numpy(), rtol=1e-6)
    np.testing.assert_allclose(gy3.numpy(), 3.0 * gy.numpy(), rtol=1e-6)
    with torch.no_grad():  # the primal is chamfer_loss_streaming's: K3
        value = nn.chamfer_loss_fused(g, p)
    assert calls == ["K9", "K3"]
    assert abs(value.item() - want) <= FP32_TOL * abs(want)


# K5/K9's key splits (ops/nn.py::nn_fused_split): the kernels' grid is
# (cloud, 1024-query tile, split), and the C side refuses a split that does
# not cover the keys with non-empty runs.

SPLIT_SHAPES = [(64, 1024, 2048, 132), (64, 2048, 1024, 132), (64, 2048, 2048, 132),
                (1, 64, 4500, 132), (2, 300, 4500, 132), (3, 200, 136, 132),
                (4, 600, 2001, 132), (8, 700, 1000, 132), (1, 1, 1, 1), (60, 2048, 2048, 132),
                (512, 1024, 1024, 132), (64, 1024, 2048, 114)]


@pytest.mark.parametrize("batch,n,m,sms", SPLIT_SHAPES)
def test_nn_fused_split_covers_every_key_once_in_order(batch, n, m, sms):
    splits, length = nn.nn_fused_split(batch, n, m, sms)
    assert splits >= 1 and length >= 1 and length % nn.FUSED_KEY_ALIGN == 0
    runs = [range(s * length, min((s + 1) * length, m)) for s in range(splits)]
    assert all(len(r) > 0 for r in runs)  # no split is empty
    assert [j for r in runs for j in r] == list(range(m))  # each key once, in order
    blocks = batch * -(-n // nn.FUSED_QUERIES) * splits
    # one wave at most, unless the clouds' tiles alone fill it
    assert splits == 1 or blocks <= sms * nn.FUSED_BLOCKS_PER_SM
    # no run is cut below the floor, unless the whole cloud is shorter
    assert length >= min(m, nn.FUSED_MIN_KEYS)


@pytest.mark.parametrize("shape,want", [((64, 1024, 2048), (8, 256)), ((64, 2048, 1024), (4, 256)),
                                        ((64, 2048, 2048), (4, 512)),
                                        ((1, 64, 4500), (29, 160)), ((3, 200, 136), (1, 160))])
def test_nn_fused_split_at_the_smoke_shapes(shape, want):
    """The H100's 132 SMs: B=64 at 1024x2048 is 64 tiles x 8 splits, 512
    blocks for its 528 places; at N=2048, 128 tiles x 4."""
    assert nn.nn_fused_split(*shape, 132) == want


@pytest.mark.parametrize("args", [(0, 64, 64, 132), (2, 0, 64, 132), (2, 64, 0, 132),
                                  (2, 64, 64, 0), (-1, 64, 64, 132)])
def test_nn_fused_split_refuses_empty_counts(args):
    with pytest.raises(ValueError, match="positive counts"):
        nn.nn_fused_split(*args)
