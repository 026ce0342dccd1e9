"""Port's fused trunk + first argmax (K8, ``ops/trunk_pool.py``) vs the JAX package.

The plain version ``trunk_pooled_argmax_reference`` is held to the Pallas
kernel ``trunk_pooled_argmax`` run in interpret mode: pooled values within
the bf16 bound of tests/test_pallas_encoder.py (2e-2). Indices: the two
evaluate the layers with fp32 sums in other orders, so a layer may round
one bf16 step apart; where the maximum leads its channel by more than twice
the bound the indices are equal, elsewhere each side's point holds a value
within the bound of the maximum. Duplicated points: the first copy wins.
The encoder's fused training forward (``HPCD_TRUNK_FUSED_FWD=1`` in both
packages) is held to the JAX encoder's at the bf16 tolerances of
tests/test_torch_train.py (outputs 5%, gradients 10% relative L2 overall,
30% per tensor). The CUDA kernel is held to the plain version on the card in
tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperpocket_tpu.models.encoder import encoder_forward
from hyperpocket_tpu.ops.pallas_encoder import trunk_pooled_argmax as jax_trunk_pooled_argmax
from hyperpocket_tpu_torch.convert import params_from_jax
from hyperpocket_tpu_torch.models import encoder as pencoder
from hyperpocket_tpu_torch.models.encoder import Encoder
from hyperpocket_tpu_torch.ops.trunk_pool import (
    _stack_reference,
    trunk_pooled_argmax,
    trunk_pooled_argmax_reference,
    trunk_pooled_reference,
)
from tests.test_torch_trunk_pool import _jax_conv, _port_layers

torch.set_float32_matmul_precision("highest")

BF16_ATOL = 2e-2
BF16_TOL, GRAD_TOTAL, GRAD_EACH = 0.05, 0.1, 0.3


def _bf16_layers(conv):
    return [(w.to(torch.bfloat16), b.to(torch.bfloat16)) for w, b in _port_layers(conv)]


def _points(case: str) -> np.ndarray:
    rng = np.random.default_rng(4)
    if case.startswith("dup"):  # every point twice, n points apart
        n = int(case[3:])
        base = rng.standard_normal((2, n, 3)).astype(np.float32) * 0.3
        return np.concatenate([base, base], axis=1)
    b, n = {"B3_N200": (3, 200), "B2_N1024": (2, 1024), "B1_N8": (1, 8)}[case]
    return rng.standard_normal((b, n, 3)).astype(np.float32) * 0.3


@pytest.mark.parametrize("case", ["B3_N200", "B2_N1024", "B1_N8", "dup64", "dup200"])
def test_reference_matches_jax_kernel_interpret(case):
    conv = list(_jax_conv(jnp.bfloat16)["conv"])
    xs = _points(case)
    want_pooled, want_idx = jax_trunk_pooled_argmax(conv, jnp.asarray(xs, jnp.bfloat16),
                                                    interpret=True)
    want_pooled = np.asarray(want_pooled, np.float32)
    want_idx = np.asarray(want_idx)
    layers = _bf16_layers(conv)
    x = torch.from_numpy(xs).to(torch.bfloat16)
    pooled, idx = trunk_pooled_argmax_reference(layers, x)
    assert pooled.dtype == torch.bfloat16 and idx.dtype == torch.int32
    assert pooled.shape == idx.shape == (xs.shape[0], 512)
    assert torch.equal(pooled, trunk_pooled_reference(layers, x))
    np.testing.assert_allclose(pooled.float().numpy(), want_pooled, atol=BF16_ATOL)

    stack = _stack_reference(layers, x).float().numpy()  # (B, N, 512)
    top2 = -np.sort(-stack, axis=1)[:, :2]
    clear = (top2[:, 0] - top2[:, 1]) > 2 * BF16_ATOL
    np.testing.assert_array_equal(idx.numpy()[clear], want_idx[clear])
    at_jax = np.take_along_axis(stack, want_idx[:, None, :], axis=1)[:, 0]
    assert (top2[:, 0] - at_jax).max() <= BF16_ATOL
    if case.startswith("dup"):
        half = xs.shape[1] // 2
        assert idx.max().item() < half and want_idx.max() < half


def test_reference_picks_the_first_of_equal_maxima():
    conv = list(_jax_conv(jnp.bfloat16)["conv"])
    layers = _bf16_layers(conv)
    xs = _points("dup64")
    x = torch.from_numpy(xs).to(torch.bfloat16)
    _, idx = trunk_pooled_argmax_reference(layers, x)
    _, first_half = trunk_pooled_argmax_reference(layers, x[:, :64].contiguous())
    assert torch.equal(idx, first_half)


def test_cpu_wrapper_takes_plain_path():
    layers = _bf16_layers(_jax_conv(jnp.bfloat16)["conv"])
    x = torch.from_numpy(_points("B3_N200")).to(torch.bfloat16)
    before = trunk_pooled_argmax.launches
    got = trunk_pooled_argmax(layers, x)
    assert trunk_pooled_argmax.launches == before
    want = trunk_pooled_argmax_reference(layers, x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="multiple of 8"):
        trunk_pooled_argmax(layers, x[:, :60])


def _encoders(dtype=jnp.float32):
    params = _jax_conv(dtype)
    enc = Encoder(128)
    enc.load_state_dict(params_from_jax(params))
    return params, enc


def _jax_value_and_grads(params, xs, dpooled_seed=5):
    g = np.random.default_rng(dpooled_seed).standard_normal((xs.shape[0], 128)).astype(np.float32)

    def f(p, x):
        mu = encoder_forward(jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p),
                             x.astype(jnp.bfloat16), is_vae=False)
        return jnp.sum(mu.astype(jnp.float32) * g), mu

    (_, mu), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(xs))
    return np.asarray(mu, np.float32), params_from_jax(jax.device_get(gp)), np.asarray(gx), g


def _port_value_and_grads(enc, xs, g):
    x = torch.from_numpy(xs).requires_grad_()
    enc.zero_grad(set_to_none=True)
    bf = {n: p.to(torch.bfloat16) for n, p in enc.named_parameters()}
    mu = torch.func.functional_call(enc, bf, (x.to(torch.bfloat16),), {"is_vae": False})
    (mu.float() * torch.from_numpy(g)).sum().backward()
    return mu.float().detach().numpy(), {n: p.grad for n, p in enc.named_parameters()}, x.grad


def test_fused_training_forward_matches_jax(monkeypatch):
    """HPCD_TRUNK_FUSED_FWD=1 in both packages: the encoder's bf16 forward
    and its gradients, through K8's plain version and the sparse backward."""
    monkeypatch.setenv("HPCD_TRUNK_FUSED_FWD", "1")
    params, enc = _encoders()
    xs = np.random.default_rng(6).standard_normal((2, 1024, 3)).astype(np.float32) * 0.3
    calls = []
    inner = pencoder.trunk_pooled_argmax
    monkeypatch.setattr(pencoder, "trunk_pooled_argmax",
                        lambda *a: calls.append(1) or inner(*a))
    want_mu, want_grads, want_gx, g = _jax_value_and_grads(params, xs)
    got_mu, got_grads, got_gx = _port_value_and_grads(enc, xs, g)
    assert len(calls) == 1
    scale = np.abs(want_mu).max()
    assert np.abs(got_mu - want_mu).max() <= BF16_TOL * scale
    diff2 = norm2 = 0.0
    for name, want in want_grads.items():
        got = got_grads[name]
        if got is None:  # the std head, off a non-VAE forward: JAX's gradient is zero
            assert not want.any(), name
            continue
        rel = (got - want).norm() / want.norm().clamp_min(1e-30)
        assert rel <= GRAD_EACH, f"{name}: relative L2 {rel}"
        diff2 += float((got - want).norm() ** 2)
        norm2 += float(want.norm() ** 2)
    assert diff2 <= GRAD_TOTAL ** 2 * norm2
    gx_rel = np.linalg.norm(got_gx.numpy() - want_gx) / np.linalg.norm(want_gx)
    assert gx_rel <= GRAD_EACH


@pytest.mark.parametrize("env, dtype, n, fused", [
    ("1", torch.bfloat16, 1024, True),
    (None, torch.bfloat16, 1024, False),
    ("0", torch.bfloat16, 1024, False),
    ("1", torch.float32, 1024, False),
    ("1", torch.bfloat16, 1028, False),  # N % 8 != 0
    ("1", torch.bfloat16, 1000, False),  # N < 2 x C_out: the plain chain
])
def test_fused_forward_gate_matches_jax(monkeypatch, env, dtype, n, fused):
    """The JAX gate: not fast, N >= 2 C_out, bf16, N % 8 == 0, HPCD_TRUNK_FUSED_FWD=1."""
    if env is None:
        monkeypatch.delenv("HPCD_TRUNK_FUSED_FWD", raising=False)
    else:
        monkeypatch.setenv("HPCD_TRUNK_FUSED_FWD", env)
    calls = []
    names = ("_ConvPooledSparse", "_ConvPooledSparseFused")
    inner = {name: getattr(pencoder, name).apply for name in names}
    for name in names:
        monkeypatch.setattr(getattr(pencoder, name), "apply", classmethod(
            lambda c, *a, name=name: calls.append(name) or inner[name](*a)))
    _, enc = _encoders()
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((1, n, 3)).astype(np.float32))
    enc.to(dtype).trunk(x.to(dtype))
    sparse = n >= 1024
    assert calls == (["_ConvPooledSparseFused"] if fused else
                     ["_ConvPooledSparse"] if sparse else [])
