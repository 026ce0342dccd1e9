"""K10's plain version (``hyperpocket_tpu_torch/ops/decoder.py``) vs the JAX package.

``decode_batch_reference`` is held to the Pallas ``decode_batch`` run in
interpret mode, for the JAX tests' channel lists with and without bias: fp32
within 2e-5 (tests/test_pallas_decoder.py's bound: the hidden layers' dot
products sum in another order) and bf16 within 0.05 (the same per-layer
rounding; a value near a rounding boundary may land one bf16 step apart and
carry that through the layers after it). ``split_flat_weights`` keeps the
reference layout. The CUDA kernel is held to the plain version on the card
in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperpocket_tpu.models.hyper_network import target_weight_count
from hyperpocket_tpu.ops import pallas_decoder as jdec
from hyperpocket_tpu_torch.models.target_network import batched_target_network_forward
from hyperpocket_tpu_torch.ops import decoder

CHANNELS = [(32, 64, 128, 64), (8, 16), (16,), ()]
WIDE_CHANNELS = [(272,), (256, 256), (512, 1024, 512)]
TOL = {"float32": 2e-5, "bfloat16": 0.05}


def _random_inputs(channels, use_bias, batch=3, n=64, seed=0):
    """tests/test_pallas_decoder.py's inputs, from a numpy seed."""
    w = target_weight_count(list(channels), use_bias)
    rng = np.random.default_rng(seed)
    flat = (rng.standard_normal((batch, w)) * 0.2).astype(np.float32)
    pts = (rng.standard_normal((batch, n, 3)) * 0.5).astype(np.float32)
    return flat, pts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("channels", CHANNELS)
def test_decode_batch_reference_matches_pallas_interpret(channels, use_bias, dtype):
    flat, pts = _random_inputs(channels, use_bias)
    jdt = getattr(jnp, dtype)
    want = jdec.decode_batch(jnp.asarray(flat, jdt), jnp.asarray(pts, jdt), channels, use_bias,
                             interpret=True)
    tdt = getattr(torch, dtype)
    tflat, tpts = torch.tensor(flat).to(tdt), torch.tensor(pts).to(tdt)
    before = decoder.decode_batch.launches
    got = decoder.decode_batch(tflat, tpts, channels, use_bias)  # CPU: the plain version
    assert decoder.decode_batch.launches == before
    assert torch.equal(got, decoder.decode_batch_reference(tflat, tpts, channels, use_bias))
    assert got.dtype == tdt and got.shape == pts.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    # and the model's own bmm chain on the same inputs
    chain = batched_target_network_forward(tflat, tpts, list(channels), use_bias)
    np.testing.assert_allclose(got.float().numpy(), chain.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", WIDE_CHANNELS)
def test_decode_batch_reference_matches_pallas_interpret_at_wide_widths(channels, dtype):
    """Widths the card's bf16 tensor-core kernel cannot hold (a layer wider
    than 256 channels, or weights above a block's shared memory), which the
    CUDA-core kernel takes, within the bounds above taken relative to the
    output's largest entry; the weights are scaled down so that the wider
    layers do not grow the outputs."""
    flat, pts = _random_inputs(channels, True, batch=2, n=32, seed=4)
    flat = flat * 0.25
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jdec.decode_batch(jnp.asarray(flat, jdt), jnp.asarray(pts, jdt), channels, True,
                             interpret=True)
    got = decoder.decode_batch(torch.tensor(flat).to(tdt), torch.tensor(pts).to(tdt), channels)
    want = np.asarray(want, np.float32)
    tol = TOL[dtype] * np.abs(want).max()  # the outputs' scale is ~0.15
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_decode_batch_reference_takes_the_weights_in_the_points_dtype():
    channels = (8, 16)
    flat, pts = _random_inputs(channels, True, batch=2, n=32, seed=3)
    tflat, tpts = torch.tensor(flat), torch.tensor(pts).to(torch.bfloat16)
    got = decoder.decode_batch_reference(tflat, tpts, channels)
    assert torch.equal(got, decoder.decode_batch_reference(tflat.to(torch.bfloat16), tpts,
                                                           channels))


def test_split_flat_weights_layout():
    """The reference order: the (out, in) weight block, then the bias, per layer."""
    flat = torch.arange(31, dtype=torch.float32)[None, :]
    ws, bs = decoder.split_flat_weights(flat, [4], True)
    assert ws[0].shape == (1, 3, 4) and bs[0].shape == (1, 1, 4)
    assert ws[1].shape == (1, 4, 3) and bs[1].shape == (1, 1, 3)
    np.testing.assert_array_equal(ws[0][0].numpy(),
                                  np.arange(12, dtype=np.float32).reshape(4, 3).T)
    np.testing.assert_array_equal(bs[0][0, 0].numpy(), np.arange(12, 16, dtype=np.float32))
    jws, jbs = jdec.split_flat_weights(jnp.asarray(flat.numpy()), [4], True)
    for got, want in zip(ws + bs, jws + jbs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ws, bs = decoder.split_flat_weights(flat[:, :24], [4], False)
    assert not any(b.any() for b in bs)
    np.testing.assert_array_equal(ws[1][0].numpy(),
                                  np.arange(12, 24, dtype=np.float32).reshape(3, 4).T)


def test_split_flat_weights_rejects_leftover():
    for width in (32, 30):  # one value left over, one missing
        with pytest.raises(ValueError, match="not fully consumed"):
            decoder.split_flat_weights(torch.zeros((1, width)), [4], True)
        with pytest.raises(ValueError, match="not fully consumed"):
            decoder.decode_batch(torch.zeros((1, width)), torch.zeros((1, 8, 3)), [4], True)


def test_ops_package_exports_the_jax_names_without_building():
    import hyperpocket_tpu.ops as jops
    import hyperpocket_tpu_torch.ops as pops
    from hyperpocket_tpu_torch.ops import _build

    # the JAX package's ball-sampling names have batched counterparts in ops/sampling.py
    jax_names = set(jops.__all__) - {"sample_uniform_ball", "generate_target_network_input"}
    assert jax_names | {"chamfer_loss_fused", "decode_batch"} == set(pops.__all__)
    assert all(callable(getattr(pops, name)) for name in pops.__all__)
    assert pops.decode_batch is decoder.decode_batch
    assert _build.library.cache_info().currsize == 0
