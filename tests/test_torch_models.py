"""Port's models (hyperpocket_tpu_torch/models) vs the JAX package on shared weights.

Weights go across with ``convert.params_from_jax``; both sides get the same
numpy inputs, ball points, VAE noise and latent noise. fp32 is held to the
ROADMAP parity budget (1e-5); bf16, where the JAX side runs the Pallas trunk
in interpret mode, to 5% of the output's largest magnitude.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperpocket_tpu.models import full_model as jfm
from hyperpocket_tpu.models.encoder import encoder_forward, init_encoder
from hyperpocket_tpu.models.hyper_network import (
    hyper_network_forward,
    init_hyper_network,
    target_layer_sizes as jax_target_layer_sizes,
    target_weight_count as jax_target_weight_count,
)
from hyperpocket_tpu.models.target_network import (
    batched_target_network_forward as jax_decode,
)
from hyperpocket_tpu_torch.convert import params_from_jax
from hyperpocket_tpu_torch.models.encoder import Encoder
from hyperpocket_tpu_torch.models.full_model import (
    MODE_HYPER_CLOUD,
    MODE_HYPER_POCKET,
    MODE_HYPER_REC,
    FullModel,
)
from hyperpocket_tpu_torch.models.hyper_network import (
    HyperNetwork,
    target_layer_sizes,
    target_weight_count,
)
from hyperpocket_tpu_torch.models.initializers import xavier_relu_bound
from hyperpocket_tpu_torch.models.target_network import batched_target_network_forward
from tests.test_torch_trunk_pool import random_biases
from tests.test_train_integration import make_config

torch.set_float32_matmul_precision("highest")

B, N, N_OUT = 2, 64, 128
FP32_TOL = 1e-5
SIZES = {MODE_HYPER_POCKET: (16, 16), MODE_HYPER_REC: (0, 16), MODE_HYPER_CLOUD: (16, 0)}


def tiny_config(mode: str = MODE_HYPER_POCKET, **overrides) -> dict:
    cfg = make_config("/none", "/none")["full_model"]
    rand, real = SIZES[mode]
    cfg["random_encoder"] = {**cfg["random_encoder"], "output_size": rand}
    cfg["real_encoder"] = {**cfg["real_encoder"], "output_size": real}
    cfg.update(overrides)
    return cfg


def model_pair(cfg: dict, seed: int = 0):
    """(JAX model, JAX params, port model holding the same weights).

    The biases are drawn anew, distinct per channel, as in trained weights.
    """
    jmodel = jfm.FullModel.from_config(cfg)
    params = random_biases(jmodel.init(jax.random.key(seed)), seed)
    port = FullModel.from_config(cfg)
    port.load_state_dict(params_from_jax(params))
    return jmodel, params, port


def inputs(model, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    z = max(model.get_noise_size(), 1)
    return {
        "existing": rng.standard_normal((B, N, 3)).astype(np.float32) * 0.3,
        "missing": rng.standard_normal((B, N, 3)).astype(np.float32) * 0.3,
        "noise": rng.standard_normal((B, model.get_noise_size())).astype(np.float32) * 0.13,
        "vae_eps": rng.standard_normal((B, z)).astype(np.float32),
        "ball_points": rng.uniform(-0.5, 0.5, (B, N_OUT, 3)).astype(np.float32),
    }


def run_jax(jmodel, params, data, noise: bool):
    return np.asarray(jmodel.apply(
        params, jnp.asarray(data["existing"]), jnp.asarray(data["missing"]),
        jax.random.key(1), jnp.asarray(100.0), num_output_points=N_OUT, training=False,
        noise=jnp.asarray(data["noise"]) if noise else None,
        vae_eps=jnp.asarray(data["vae_eps"]), ball_points=jnp.asarray(data["ball_points"])),
        np.float32)


def run_port(port, data, noise: bool):
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    return port.apply(t["existing"], t["missing"], None, 100.0, num_output_points=N_OUT,
                      training=False, noise=t["noise"] if noise else None,
                      vae_eps=t["vae_eps"], ball_points=t["ball_points"]).numpy()


@pytest.mark.parametrize("is_vae", [False, True])
def test_encoder_parity_fp32(is_vae):
    params = random_biases(init_encoder(jax.random.key(3), 16), 3)
    enc = Encoder(16)
    enc.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((B, N, 3)).astype(np.float32)
    eps = rng.standard_normal((B, 16)).astype(np.float32)
    want = encoder_forward(params, jnp.asarray(xs), is_vae=is_vae, eps=jnp.asarray(eps))
    with torch.no_grad():
        got = enc(torch.from_numpy(xs), is_vae=is_vae, eps=torch.from_numpy(eps))
    want = want if is_vae else (want,)
    got = got if is_vae else (got,)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FP32_TOL, rtol=FP32_TOL)


def test_vae_encoder_needs_generator_or_eps():
    with pytest.raises(ValueError, match="generator or explicit eps"):
        Encoder(4)(torch.zeros((1, 8, 3)), is_vae=True)


@pytest.mark.parametrize("freeze", [False, True])
def test_hyper_network_parity_fp32(freeze):
    channels = [8, 16, 8]
    params = random_biases(
        init_hyper_network(jax.random.key(4), 32, channels, freeze_heads=freeze), 4)
    hn = HyperNetwork(32, channels, freeze_heads=freeze)
    hn.load_state_dict(params_from_jax(params))
    latent = np.random.default_rng(4).standard_normal((B, 32)).astype(np.float32)
    want = hyper_network_forward(params, jnp.asarray(latent), freeze_heads=freeze)
    with torch.no_grad():
        got = hn(torch.from_numpy(latent))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("use_bias", [True, False])
def test_target_network_parity_fp32(use_bias):
    channels = [8, 16, 8]
    w = sum(target_layer_sizes(channels, use_bias))
    rng = np.random.default_rng(5)
    flat = rng.standard_normal((B, w)).astype(np.float32) * 0.3
    pts = rng.uniform(-1, 1, (B, N_OUT, 3)).astype(np.float32)
    want = jax_decode(jnp.asarray(flat), jnp.asarray(pts), channels, use_bias)
    got = batched_target_network_forward(torch.from_numpy(flat), torch.from_numpy(pts),
                                         channels, use_bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_TOL, rtol=FP32_TOL)


def test_target_network_checks_the_vector_is_consumed():
    flat = torch.zeros((1, sum(target_layer_sizes([4], True)) + 1))
    with pytest.raises(ValueError, match="not fully consumed"):
        batched_target_network_forward(flat, torch.zeros((1, 8, 3)), [4], True)


@pytest.mark.parametrize("channels,use_bias", [([32, 64, 128, 64], True), ([8, 16], False)])
def test_target_layer_sizes_match_jax(channels, use_bias):
    assert target_layer_sizes(channels, use_bias) == jax_target_layer_sizes(channels, use_bias)
    assert target_weight_count(channels, use_bias) == jax_target_weight_count(channels, use_bias)


@pytest.mark.parametrize("mode", [MODE_HYPER_POCKET, MODE_HYPER_REC, MODE_HYPER_CLOUD])
@pytest.mark.parametrize("noise", [True, False])
def test_full_model_apply_parity_fp32(mode, noise):
    jmodel, params, port = model_pair(tiny_config(mode))
    assert port.mode == jmodel.mode == mode
    data = inputs(port)
    want = run_jax(jmodel, params, data, noise)
    got = run_port(port, data, noise)
    assert got.shape == (B, N_OUT, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("mode", [MODE_HYPER_POCKET, MODE_HYPER_REC, MODE_HYPER_CLOUD])
def test_full_model_apply_parity_bf16(mode):
    """bf16 compute: JAX reaches the Pallas trunk (interpret), the port its plain trunk."""
    jmodel, params, port = model_pair(tiny_config(mode, compute_dtype="bfloat16"))
    data = inputs(port, seed=1)
    want = run_jax(jmodel, params, data, noise=True)
    got = run_port(port, data, noise=True)
    assert got.dtype == np.float32  # sub-fp32 compute hands fp32 back
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_serving_params_cast_once_and_match():
    _, _, port = model_pair(tiny_config(compute_dtype="bfloat16"))
    served = port.serving_params()
    assert all(p.dtype == torch.bfloat16 for p in served.parameters())
    assert all(p.dtype == torch.float32 for p in port.parameters())
    data = inputs(port, seed=2)
    np.testing.assert_array_equal(run_port(served, data, True), run_port(port, data, True))
    fp32 = FullModel.from_config(tiny_config())
    assert fp32.serving_params() is fp32


def test_no_encoder_is_rejected():
    cfg = tiny_config()
    cfg["random_encoder"]["output_size"] = 0
    cfg["real_encoder"]["output_size"] = 0
    with pytest.raises(ValueError, match="non zero output"):
        FullModel.from_config(cfg)


@pytest.mark.parametrize("freeze", [False, True])
def test_init_follows_the_reference(freeze):
    cfg = tiny_config()
    cfg["target_network"] = {**cfg["target_network"], "freeze_layers_learning": freeze}
    gen = torch.Generator().manual_seed(7)
    model = FullModel.from_config(cfg, gen)
    for layer in model.real_encoder.conv:
        bound = xavier_relu_bound(layer.in_features, layer.out_features)
        assert layer.weight.abs().max() <= bound and layer.weight.abs().max() > 0.5 * bound
        assert torch.count_nonzero(layer.bias) == 0
    heads = model.hyper_network.heads
    sizes = target_layer_sizes(list(cfg["target_network"]["layer_out_channels"]), True)
    if freeze:  # torch's default Linear reset, bias included
        assert heads.weight.abs().max() <= 1 / np.sqrt(2048)
        assert torch.count_nonzero(heads.bias) > 0
    else:  # each head's row block has its own Xavier bound
        start = 0
        for size in sizes:
            block = heads.weight[start:start + size]
            assert block.abs().max() <= xavier_relu_bound(2048, size)
            start += size
        assert torch.count_nonzero(heads.bias) == 0
    again = FullModel.from_config(cfg, torch.Generator().manual_seed(7))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
