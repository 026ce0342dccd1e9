"""Port's NN kernels' plain versions, Chamfer losses and sparse max-pool vs the JAX package.

K1 and K3's plain versions (``hyperpocket_tpu_torch/ops/nn.py``) are held to
the Pallas kernels run in interpret mode: indices equal, distances within
1e-6 (the same arithmetic, so the same bits up to XLA's own rounding). The
losses and their gradients are held to the JAX functions at the fp32 parity
budget (1e-5); the kernels themselves are held to the plain versions on the
card in tests/test_torch_cuda.py.
"""

from __future__ import annotations

from os.path import dirname, join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperpocket_tpu.models.encoder import _conv_pooled_sparse, _conv_stack, init_encoder
from hyperpocket_tpu.ops import chamfer as jchamfer
from hyperpocket_tpu.ops import pallas_nn as jnn
from hyperpocket_tpu_torch.convert import params_from_jax
from hyperpocket_tpu_torch.models.encoder import Encoder, _ConvPooledSparse
from hyperpocket_tpu_torch.ops import chamfer, nn
from tests.test_torch_trunk_pool import random_biases

torch.set_float32_matmul_precision("highest")

NN_TOL = 1e-6
FP32_TOL = 1e-5
GOLDEN = np.load(join(dirname(__file__), "golden_ops.npz"))


def _clouds(case: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    shapes = {"rect": ((2, 256), (2, 128)), "square": ((2, 256), (2, 256))}
    if case == "ties":  # every key twice, 64 points apart: exact ties, first index wins
        keys = (rng.standard_normal((2, 64, 3)) * 0.3).astype(np.float32)
        q = (rng.standard_normal((2, 256, 3)) * 0.3).astype(np.float32)
        return q, np.concatenate([keys, keys], axis=1)
    (b, n), (_, m) = shapes[case]
    return ((rng.standard_normal((b, n, 3)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, m, 3)) * 0.3).astype(np.float32))


def _t(*arrays, requires_grad=False):
    out = tuple(torch.tensor(a, requires_grad=requires_grad) for a in arrays)
    return out if len(out) > 1 else out[0]


@pytest.mark.parametrize("case", ["rect", "square", "ties"])
def test_nn_one_direction_reference_matches_pallas_interpret(case):
    q, k = _clouds(case)
    for a, b in ((q, k), (k, q)):
        want_d, want_i = jnn._nn_one_direction(jnp.asarray(a), jnp.asarray(b), interpret=True)
        got_d, got_i = nn.nn_one_direction_reference(*_t(a, b))
        assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=NN_TOL, rtol=0)
    if case == "ties":  # the key at j and j + 64 are equal: the index is always < 64
        assert int(nn.nn_one_direction_reference(*_t(q, k))[1].max()) < 64


@pytest.mark.parametrize("case", ["rect", "square", "ties"])
def test_nn_min_fused_reference_matches_pallas_interpret(case):
    q, k = _clouds(case)
    want1, want2 = jnn._nn_min_fused(jnp.asarray(q), jnp.asarray(k), interpret=True)
    got1, got2 = nn.nn_min_fused_reference(*_t(q, k))
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=NN_TOL, rtol=0)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=NN_TOL, rtol=0)
    # the two plain versions give the same bits
    assert torch.equal(got1, nn.nn_one_direction_reference(*_t(q, k))[0])
    assert torch.equal(got2, nn.nn_one_direction_reference(*_t(k, q))[0])


def test_cpu_wrappers_take_the_plain_path():
    q, k = _t(*_clouds("rect"))
    before = (nn.nn_one_direction.launches, nn.nn_min_fused.launches)
    d, i = nn.nn_one_direction(q, k)
    d1, d2 = nn.nn_min_fused(q, k)
    assert (nn.nn_one_direction.launches, nn.nn_min_fused.launches) == before
    want_d, want_i = nn.nn_one_direction_reference(q, k)
    assert torch.equal(d, want_d) and torch.equal(i, want_i) and torch.equal(d1, want_d)
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        nn.nn_one_direction(q[..., :2], k)


@pytest.mark.parametrize("case", ["rect", "square", "ties"])
def test_chamfer_loss_auto_value_and_grads_match_jax(case):
    """fp32 aligned clouds: the streaming path on both sides (Pallas interpret in JAX)."""
    gts, preds = _clouds(case, seed=1)
    assert nn.pallas_shapes_ok(gts.shape[1], preds.shape[1])
    want = float(jnn.chamfer_loss_auto(jnp.asarray(gts), jnp.asarray(preds)))
    want_ga, want_gb = jax.grad(jnn.chamfer_loss_streaming, argnums=(0, 1))(
        jnp.asarray(gts), jnp.asarray(preds))
    g, p = _t(gts, preds, requires_grad=True)
    got = nn.chamfer_loss_auto(g, p)
    assert got.grad_fn is not None and "ChamferStreaming" in type(got.grad_fn).__name__
    got.backward()
    assert abs(got.item() - want) <= FP32_TOL * abs(want)
    # the same indices give the same gradient, up to the scatter's summation order
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(want_ga), atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_gb), atol=FP32_TOL, rtol=0)


def test_streaming_dispatch_follows_the_need_for_a_gradient(monkeypatch):
    calls = []
    one, fused = nn.nn_one_direction, nn.nn_min_fused
    monkeypatch.setattr(nn, "nn_one_direction", lambda q, k: calls.append("K1") or one(q, k))
    monkeypatch.setattr(nn, "nn_min_fused", lambda q, k: calls.append("K3") or fused(q, k))
    gts, preds = _clouds("rect")
    g, p = _t(gts, preds)
    value = nn.chamfer_loss_streaming(g, p)
    assert calls == ["K3"]
    p.requires_grad_()
    with torch.no_grad():
        nn.chamfer_loss_streaming(g, p)
    assert calls == ["K3", "K3"]
    graded = nn.chamfer_loss_streaming(g, p)
    assert calls == ["K3", "K3", "K1", "K1"]
    assert abs(graded.item() - value.item()) <= FP32_TOL * value.item()


@pytest.mark.parametrize("dtype,n,m", [("float64", 256, 128), ("float32", 100, 70),
                                       ("float32", 256, 136)])
def test_chamfer_loss_auto_falls_back_to_the_plain_loss(dtype, n, m):
    rng = np.random.default_rng(2)
    gts = (rng.standard_normal((2, n, 3)) * 0.3).astype(dtype)
    preds = (rng.standard_normal((2, m, 3)) * 0.3).astype(dtype)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn, "chamfer_loss_streaming", lambda *a: calls.append(1))
        g, p = _t(gts, preds, requires_grad=True)
        got = nn.chamfer_loss_auto(g, p)
    assert not calls
    got.backward()
    with jax.enable_x64(dtype == "float64"):
        ja, jb = jnp.asarray(gts), jnp.asarray(preds)
        want = float(jnn.chamfer_loss_auto(ja, jb))
        want_ga, want_gb = jax.grad(jchamfer.chamfer_loss, argnums=(0, 1))(ja, jb)
    tol = 1e-12 if dtype == "float64" else FP32_TOL
    assert got.dtype == getattr(torch, dtype)
    assert abs(got.item() - want) <= tol * abs(want)
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(want_ga), atol=tol, rtol=0)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_gb), atol=tol, rtol=0)


def test_plain_ops_match_jax():
    x, y = _clouds("rect", seed=3)
    tx, ty = _t(x, y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(chamfer.batch_pairwise_sqdist(tx, ty).numpy(),
                               np.asarray(jchamfer.batch_pairwise_sqdist(jx, jy)),
                               atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(chamfer.chamfer_per_cloud(tx, ty).numpy(),
                               np.asarray(jchamfer.chamfer_per_cloud(jx, jy)), rtol=FP32_TOL)
    np.testing.assert_allclose(chamfer.directed_hausdorff(tx, ty).numpy(),
                               np.asarray(jchamfer.directed_hausdorff(jx, jy)), rtol=FP32_TOL)


def test_nn_distance_and_its_backward_match_jax():
    a, b = _clouds("rect", seed=4)
    rng = np.random.default_rng(4)
    g1 = rng.standard_normal(a.shape[:2]).astype(np.float32)
    g2 = rng.standard_normal(b.shape[:2]).astype(np.float32)
    ta, tb = _t(a, b, requires_grad=True)
    d1, i1, d2, i2 = chamfer.nn_distance(ta, tb)
    ((d1 * torch.tensor(g1)).sum() + (d2 * torch.tensor(g2)).sum()).backward()

    def weighted(a_, b_):
        e1, _, e2, _ = jchamfer.nn_distance(a_, b_)
        return jnp.sum(e1 * g1) + jnp.sum(e2 * g2)

    want = jchamfer.nn_distance(jnp.asarray(a), jnp.asarray(b))
    want_ga, want_gb = jax.grad(weighted, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(d1.detach().numpy(), np.asarray(want[0]), atol=FP32_TOL)
    np.testing.assert_allclose(d2.detach().numpy(), np.asarray(want[2]), atol=FP32_TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_ga), atol=FP32_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_gb), atol=FP32_TOL)


def test_plain_ops_match_the_golden_values():
    x, y = _t(GOLDEN["x"], GOLDEN["y"])
    np.testing.assert_allclose(chamfer.chamfer_loss(x, y).item(), float(GOLDEN["chamfer_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(chamfer.chamfer_per_cloud(x, y).numpy(),
                               GOLDEN["chamfer_per_cloud"], rtol=1e-5)
    np.testing.assert_allclose(chamfer.directed_hausdorff(x, y).numpy(), GOLDEN["hausdorff"],
                               rtol=1e-5, atol=1e-6)
    d1, i1, d2, i2 = chamfer.nn_distance(x, y)
    np.testing.assert_allclose(d1.numpy(), GOLDEN["nn_d1"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(d2.numpy(), GOLDEN["nn_d2"], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(i1.numpy(), GOLDEN["nn_i1"])
    np.testing.assert_array_equal(i2.numpy(), GOLDEN["nn_i2"])


# ---------------------------------------------------------------------------
# The encoder's training trunk: _ConvPooledSparse vs _conv_pooled_sparse


def _encoder_pair(seed: int = 0):
    params = random_biases(init_encoder(jax.random.key(seed), 16), seed)
    enc = Encoder(16)
    enc.load_state_dict(params_from_jax(params))
    return params, enc


def _trunk_inputs(case: str, n: int):
    rng = np.random.default_rng(5)
    if case == "ties":  # the cloud twice over: every channel's max is tied, first row wins
        half = (rng.standard_normal((2, n // 2, 3)) * 0.3).astype(np.float32)
        return np.concatenate([half, half], axis=1)
    return (rng.standard_normal((2, n, 3)) * 0.3).astype(np.float32)


def _port_conv_grads(enc: Encoder, x: torch.Tensor, cot: np.ndarray, pool):
    enc.zero_grad()
    params = []
    for layer in enc.conv:
        params += [layer.weight, layer.bias]
    pooled = pool(x, params)
    (pooled * torch.tensor(cot)).sum().backward()
    return pooled, [(l.weight.grad.T.numpy(), l.bias.grad.numpy()) for l in enc.conv]


@pytest.mark.parametrize("case", ["random", "ties"])
def test_sparse_max_pool_backward_matches_jax(case):
    """N >= 2 * C_out: gradients through the argmax rows, ties to the first one."""
    params, enc = _encoder_pair()
    xs = _trunk_inputs(case, 1024)
    cot = np.random.default_rng(6).standard_normal((2, 512)).astype(np.float32)
    x = torch.tensor(xs, requires_grad=True)
    pooled, got = _port_conv_grads(enc, x, cot, lambda x_, p: _ConvPooledSparse.apply(x_, *p))

    def loss(conv, x_):
        return jnp.sum(_conv_pooled_sparse(conv, x_) * cot)

    want_conv, want_x = jax.grad(loss, argnums=(0, 1))(params["conv"], jnp.asarray(xs))
    np.testing.assert_allclose(pooled.detach().numpy(),
                               np.asarray(_conv_pooled_sparse(params["conv"], jnp.asarray(xs))),
                               atol=FP32_TOL, rtol=FP32_TOL)
    for (gw, gb), want in zip(got, want_conv):
        scale = max(1.0, float(np.abs(want["w"]).max()))
        np.testing.assert_allclose(gw, np.asarray(want["w"]), atol=FP32_TOL * scale, rtol=1e-4)
        np.testing.assert_allclose(gb, np.asarray(want["b"]), atol=FP32_TOL * scale, rtol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_x), atol=FP32_TOL, rtol=1e-4)
    if case == "ties":  # every cotangent lands in the first copy of the cloud
        assert not x.grad[:, 512:].any()
        assert enc.trunk(torch.tensor(xs)).grad_fn is not None


def test_small_cloud_max_pool_splits_ties_like_jnp_max():
    """N < 2 * C_out: the plain chain and amax, whose gradient splits ties evenly."""
    params, enc = _encoder_pair(1)
    xs = _trunk_inputs("ties", 128)
    cot = np.random.default_rng(7).standard_normal((2, 512)).astype(np.float32)
    x = torch.tensor(xs, requires_grad=True)
    _, got = _port_conv_grads(enc, x, cot, lambda x_, p: enc.conv_stack(x_).amax(dim=1))

    def loss(conv, x_):
        return jnp.sum(jnp.max(_conv_stack(conv, x_), axis=1) * cot)

    want_conv, want_x = jax.grad(loss, argnums=(0, 1))(params["conv"], jnp.asarray(xs))
    for (gw, gb), want in zip(got, want_conv):
        scale = max(1.0, float(np.abs(want["w"]).max()))
        np.testing.assert_allclose(gw, np.asarray(want["w"]), atol=FP32_TOL * scale, rtol=1e-4)
        np.testing.assert_allclose(gb, np.asarray(want["b"]), atol=FP32_TOL * scale, rtol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_x), atol=FP32_TOL, rtol=1e-4)
    # the tie's gradient is split: both copies of the cloud receive half
    np.testing.assert_allclose(x.grad[:, :64].numpy(), x.grad[:, 64:].numpy(), atol=1e-6)


@pytest.mark.parametrize("n,sparse", [(1024, True), (1000, False)])
def test_encoder_trunk_takes_the_sparse_pool_from_2x_c_out_points(n, sparse):
    _, enc = _encoder_pair(2)
    x = torch.tensor(_trunk_inputs("random", n))
    names, todo = set(), [enc.trunk(x).grad_fn]
    while todo:  # every node of the autograd graph
        fn = todo.pop()
        names.add(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions if f is not None]
    assert any("ConvPooledSparse" in name for name in names) == sparse
