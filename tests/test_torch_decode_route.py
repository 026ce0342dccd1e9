"""K10 as the op ``hyperpocket::decode_batch``, and the inference forward's route through it.

On the CPU the op runs ``decode_batch_reference`` (the CUDA kernels are
held to it on the card in tests/test_torch_cuda.py). The port's
``apply(training=False)`` decodes through the op in fp32 and bf16 and is held
to the JAX package's ``apply(training=False)``, which keeps its ``bmm``
chain, on shared weights, ball points and noise: fp32 within 1e-5 (the
parity budget; the two sum the hidden layers in another order), bf16 within
5% of the output's largest magnitude (tests/test_torch_models.py's budget;
the route asks the op for the chain's rounding, the product rounded and
then its sum with the bias, and tests/test_torch_rounding.py holds it at
seeds 0-11). The training forward and fp64 and fp16 keep the chain.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hyperpocket_tpu_torch.models.full_model import (
    MODE_HYPER_CLOUD,
    MODE_HYPER_POCKET,
    MODE_HYPER_REC,
)
from hyperpocket_tpu_torch.models.hyper_network import target_weight_count
from hyperpocket_tpu_torch.ops import decoder
from tests.test_torch_models import FP32_TOL, inputs, model_pair, run_jax, run_port, tiny_config

CHANNELS = [(32, 64, 128, 64), (8, 16), (16,), ()]
MODES = [MODE_HYPER_POCKET, MODE_HYPER_REC, MODE_HYPER_CLOUD]


def _decode_inputs(channels, use_bias, batch=3, n=64, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    w = target_weight_count(list(channels), use_bias)
    flat = torch.from_numpy((rng.standard_normal((batch, w)) * 0.2).astype(np.float32))
    pts = torch.from_numpy((rng.standard_normal((batch, n, 3)) * 0.5).astype(np.float32))
    return flat.to(dtype), pts.to(dtype)


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("channels", CHANNELS)
def test_decode_op_opcheck(channels, use_bias):
    """Schema, fake tensor and dispatch checks of ``hyperpocket::decode_batch``."""
    flat, pts = _decode_inputs(channels, use_bias)
    torch.library.opcheck(torch.ops.hyperpocket.decode_batch.default,
                          (flat, pts, list(channels), use_bias))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_decode_op_on_the_cpu_is_the_plain_version(dtype):
    channels = (32, 64, 128, 64)
    flat, pts = _decode_inputs(channels, True, batch=2, n=100, seed=1, dtype=dtype)
    before = decoder.decode_batch.launches
    got = torch.ops.hyperpocket.decode_batch(flat, pts, list(channels), True)
    assert torch.equal(got, decoder.decode_batch_reference(flat, pts, channels, True))
    assert torch.equal(decoder.decode_batch(flat, pts, channels, True), got)
    assert decoder.decode_batch.launches == before  # the CPU launches nothing
    with torch._subclasses.fake_tensor.FakeTensorMode():
        out = torch.ops.hyperpocket.decode_batch(torch.empty(5, flat.shape[1], dtype=dtype),
                                                 torch.empty(5, 7, 3, dtype=dtype),
                                                 list(channels), True)
    assert tuple(out.shape) == (5, 7, 3) and out.dtype == dtype
    with pytest.raises(ValueError, match="not fully consumed"):
        torch.ops.hyperpocket.decode_batch(flat[:, 1:], pts, list(channels), True)


@pytest.fixture
def decode_calls(monkeypatch):
    """Counts the forward's calls of ``decoder.decode_batch`` (the op's wrapper)."""
    calls = []
    real = decoder.decode_batch

    def counted(*args, **kwargs):
        calls.append(args[1].dtype)
        return real(*args, **kwargs)

    monkeypatch.setattr(decoder, "decode_batch", counted)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_inference_forward_decodes_through_the_op_like_jax(mode, dtype, decode_calls):
    """tests/test_torch_models.py's weights and inputs (seed 0), on which its
    budgets hold for the chain route too."""
    jmodel, params, port = model_pair(tiny_config(mode, compute_dtype=dtype))
    data = inputs(port)
    got = run_port(port, data, noise=True)
    want = run_jax(jmodel, params, data, noise=True)
    assert decode_calls == [getattr(torch, dtype)]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    else:
        assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()
    assert port.fused_decode(False)
    assert not port.fused_decode(True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_forward_keeps_the_chain(dtype, decode_calls):
    _, _, port = model_pair(tiny_config(compute_dtype=dtype), seed=8)
    t = {k: torch.from_numpy(v) for k, v in inputs(port, seed=8).items()}
    rec, mu, sigma = port.apply(t["existing"], t["missing"], None, 100.0,
                                num_output_points=t["ball_points"].shape[1], training=True,
                                vae_eps=t["vae_eps"], ball_points=t["ball_points"])
    assert decode_calls == []
    rec.sum().backward()  # the chain carries the gradient to the hypernetwork
    assert port.hyper_network.heads.weight.grad is not None


@pytest.mark.parametrize("dtype", ["float64", "float16"])
def test_fp64_and_fp16_inference_keep_the_chain(dtype, decode_calls):
    _, _, port = model_pair(tiny_config(compute_dtype=dtype), seed=9)
    port = port.to(getattr(torch, dtype)) if dtype == "float64" else port
    data = inputs(port, seed=9)
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    out = port.apply(t["existing"], t["missing"], None, 100.0,
                     num_output_points=t["ball_points"].shape[1], training=False,
                     noise=t["noise"], ball_points=t["ball_points"])
    assert decode_calls == []
    assert not port.fused_decode(False)
    assert out.dtype == (torch.float64 if dtype == "float64" else torch.float32)
    assert bool(torch.isfinite(out).all())
