"""Port's approximate EMD (hyperpocket_tpu_torch/ops/emd.py) vs the JAX package.

Both sides get the same numpy clouds. The plain forward is held to the JAX
XLA route (rtol 1e-5 in fp32, 1e-10 in fp64); the plain versions of the
kernels K6/K7 to the TPU kernels in interpret mode and to ``jax.grad`` of
the XLA route. Costs are held to rtol 1e-4 (tests/test_pallas_emd.py).
Gradients are held to 1e-4 of each tensor's largest magnitude plus 1e-6:
an elementwise rtol of 1e-4 is out of reach of any fp32 route here, since
gx = x * sum(wd) - sum(wd * y) cancels. On (2, 128, 3) clouds the JAX
package's own two routes (Pallas interpret and ``jax.grad`` of XLA) differ
by 1.3e-5 where the gradient's largest entry is 1.0, and every fp32 route,
theirs and the port's, lies 1-2.5e-5 from the fp64 gradient.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperpocket_tpu.ops import emd as jemd
from hyperpocket_tpu.ops.pallas_emd import match_cost_pallas_bwd, match_cost_pallas_fwd
from hyperpocket_tpu_torch.ops import emd

SHAPES = {"128x128": (128, 128), "128x32": (128, 32)}  # 128x32: budget multiplier 4
COST_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _clouds(n: int, m: int, batch: int = 2, seed: int = 0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((batch, n, 3)) * 0.3).astype(dtype),
            (rng.standard_normal((batch, m, 3)) * 0.3).astype(dtype))


def _close_to_scale(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max() + atol, (err, np.abs(want).max())


@pytest.mark.parametrize("shape", list(SHAPES))
def test_streaming_cost_fp32(shape):
    x, y = _clouds(*SHAPES[shape])
    want = np.asarray(jemd._streaming_cost(x, y))
    got = emd._streaming_cost(torch.tensor(x), torch.tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_streaming_cost_fp64():
    x, y = _clouds(128, 128, dtype=np.float64)
    with jax.enable_x64(True):
        want = np.asarray(jemd._streaming_cost(jnp.asarray(x), jnp.asarray(y)))
    got = emd._streaming_cost(torch.tensor(x), torch.tensor(y)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_approx_match_and_cost_from_match():
    x, y = _clouds(128, 32)
    want = np.asarray(jemd.approx_match(x, y))
    got = emd.approx_match(torch.tensor(x), torch.tensor(y))
    _close_to_scale(got.numpy(), want)
    cost = emd._cost_from_match(torch.tensor(x), torch.tensor(y), got).numpy()
    np.testing.assert_allclose(cost, np.asarray(jemd._match_cost_reference(x, y)), rtol=1e-5)
    # rows carry the budget multiL = 1, columns multiR = 4 at most
    assert np.all(got.sum(dim=2).numpy() <= 1.0 + 1e-5)
    assert np.all(got.sum(dim=1).numpy() <= 4.0 + 1e-5)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fwd_reference_matches_tpu_kernel(shape):
    x, y = _clouds(*SHAPES[shape])
    want = np.asarray(match_cost_pallas_fwd(x, y, interpret=True))
    got = emd.match_cost_fwd_reference(torch.tensor(x), torch.tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=COST_RTOL)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_bwd_matches_tpu_kernel_and_jax_grad(shape, monkeypatch):
    x, y = _clouds(*SHAPES[shape])
    kernel_gx, kernel_gy = match_cost_pallas_bwd(x, y, interpret=True)
    monkeypatch.setenv("HPCD_EMD_IMPL", "xla")
    grad_gx, grad_gy = jax.grad(lambda a, b: jnp.sum(jemd.match_cost(a, b)),
                                argnums=(0, 1))(x, y)
    xt, yt = torch.tensor(x), torch.tensor(y)
    for name, (gx, gy) in {"reference": emd.match_cost_bwd_reference(xt, yt),
                           "plain": emd._match_cost_bwd_plain(xt, yt)}.items():
        for got, want in ((gx, kernel_gx), (gy, kernel_gy), (gx, grad_gx), (gy, grad_gy)):
            _close_to_scale(got.numpy(), want)


def test_match_cost_autograd_matches_jax_grad(monkeypatch):
    """``match_cost``'s backward scales the gradients by the cotangent."""
    x, y = _clouds(128, 32)
    w = np.asarray([0.5, -2.0], np.float32)
    monkeypatch.setenv("HPCD_EMD_IMPL", "xla")
    want = jax.grad(lambda a, b: jnp.sum(jemd.match_cost(a, b) * w), argnums=(0, 1))(x, y)
    xt, yt = torch.tensor(x, requires_grad=True), torch.tensor(y, requires_grad=True)
    (emd.match_cost(xt, yt) * torch.tensor(w)).sum().backward()
    _close_to_scale(xt.grad.numpy(), want[0])
    _close_to_scale(yt.grad.numpy(), want[1])


def test_descent_trajectory_matches_jax(monkeypatch):
    """The JAX package's descent check (tests/test_pallas_emd.py) on the plain route."""
    rng = np.random.default_rng(3)
    x0 = (rng.standard_normal((16, 128, 3)) * 0.3).astype(np.float32)
    target = (rng.standard_normal((16, 128, 3)) * 0.3).astype(np.float32)
    monkeypatch.setenv("HPCD_EMD_IMPL", "xla")
    vg = jax.jit(jax.value_and_grad(lambda a: jnp.sum(jemd.match_cost(a, target)) / (16 * 128)))
    x, want = jnp.asarray(x0), []
    for _ in range(10):
        val, g = vg(x)
        want.append(float(val))
        x = x - 0.05 * g
    xt, tt, got = torch.tensor(x0), torch.tensor(target), []
    for _ in range(10):
        xt.requires_grad_()
        loss = emd.match_cost(xt, tt).sum() / (16 * 128)
        (g,) = torch.autograd.grad(loss, xt)
        got.append(loss.item())
        xt = (xt - 0.05 * g).detach()
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_dispatch(monkeypatch):
    """CPU tensors take the plain forward and backward, in fp32 and fp64."""
    launches = emd.match_cost_fwd_kernel.launches, emd.match_cost_bwd_kernel.launches
    for dtype in (np.float32, np.float64):
        xa, ya = _clouds(128, 32, dtype=dtype)
        x, y = torch.tensor(xa, requires_grad=True), torch.tensor(ya, requires_grad=True)
        cost = emd.match_cost(x, y)
        assert cost.dtype == x.dtype
        assert torch.equal(cost, emd._streaming_cost(x, y))
        gx, gy = torch.autograd.grad(cost.sum(), (x, y))
        want_x, want_y = emd._match_cost_bwd_plain(x.detach(), y.detach())
        assert torch.equal(gx, want_x) and torch.equal(gy, want_y)
    assert (emd.match_cost_fwd_kernel.launches, emd.match_cost_bwd_kernel.launches) == launches
    # the JAX package's route variable selects nothing in the port
    monkeypatch.setenv("HPCD_EMD_IMPL", "pallas")
    x, y = (torch.tensor(a) for a in _clouds(128, 32))
    assert torch.equal(emd.match_cost(x, y), emd._streaming_cost(x, y))


def test_kernel_wrappers_on_cpu_run_the_plain_versions():
    x, y = (torch.tensor(a) for a in _clouds(64, 48))
    launches = emd.match_cost_fwd_kernel.launches, emd.match_cost_bwd_kernel.launches
    assert torch.equal(emd.match_cost_fwd_kernel(x, y), emd.match_cost_fwd_reference(x, y))
    for got, want in zip(emd.match_cost_bwd_kernel(x, y), emd.match_cost_bwd_reference(x, y)):
        assert torch.equal(got, want)
    assert (emd.match_cost_fwd_kernel.launches, emd.match_cost_bwd_kernel.launches) == launches
    # the reference's batch chunks change nothing
    xs, ys = (torch.tensor(a) for a in _clouds(32, 32, batch=2 * emd._REFERENCE_CHUNK + 1))
    whole = emd.match_cost_fwd_reference(xs, ys)
    single = torch.cat([emd.match_cost_fwd_reference(xs[i:i + 1], ys[i:i + 1])
                        for i in range(xs.shape[0])])
    torch.testing.assert_close(whole, single, rtol=1e-6, atol=0)


def test_earth_mover_distance(monkeypatch):
    x, y = _clouds(64, 64, batch=3)
    want = np.asarray(jemd.earth_mover_distance(x, y))
    got = emd.earth_mover_distance(torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    chunked = emd.earth_mover_distance(torch.tensor(x), torch.tensor(y), batch_size=1)
    torch.testing.assert_close(chunked, got, rtol=1e-6, atol=0)
    # on the CPU at most 300 pairs go to one match_cost call
    calls = []
    monkeypatch.setattr(emd, "match_cost", lambda a, b: calls.append(a.shape[0]) or
                        torch.zeros(a.shape[0]))
    emd.earth_mover_distance(torch.zeros(512, 4, 3), torch.zeros(512, 4, 3))
    assert calls == [300, 212]
    monkeypatch.undo()
    single = emd.earth_mover_distance(torch.tensor(x[0]), torch.tensor(y[0]))
    assert single.shape == (1,)
    with pytest.raises(ValueError, match="equal point counts"):
        emd.earth_mover_distance(torch.tensor(x), torch.tensor(y[:, :32]))
    with pytest.raises(ValueError, match="batch mismatch"):
        emd.earth_mover_distance(torch.tensor(x), torch.tensor(y[:2]))
