"""Port's fused trunk (hyperpocket_tpu_torch/ops/trunk_pool.py) vs the JAX package.

The plain version is held to the Pallas kernel run in interpret mode; the
CUDA kernel itself is held to the plain version on the card in
tests/test_torch_cuda.py.
"""

from __future__ import annotations

import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperpocket_tpu.models.encoder import _trunk, init_encoder
from hyperpocket_tpu.ops.pallas_encoder import trunk_pooled as jax_trunk_pooled
from hyperpocket_tpu_torch.convert import params_from_jax
from hyperpocket_tpu_torch.models.encoder import Encoder
from hyperpocket_tpu_torch.ops import _build
from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled, trunk_pooled_reference

torch.set_float32_matmul_precision("highest")

BF16_ATOL = 2e-2  # bf16 per-layer rounding, as tests/test_pallas_encoder.py


def random_biases(tree, seed: int = 0, scale: float = 0.1):
    """``tree`` with every bias leaf ("b") drawn anew, distinct per channel.

    Initialisation zeroes the biases and trained weights do not; a bias read
    from the wrong channel shows only when the channels differ.
    """
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if getattr(path[-1], "key", None) != "b":
            return leaf
        return jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32) * scale, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _jax_conv(dtype=jnp.float32):
    params = random_biases(init_encoder(jax.random.key(0), 128))
    return jax.tree_util.tree_map(lambda a: a.astype(dtype), params)


def _port_layers(conv) -> list[tuple[torch.Tensor, torch.Tensor]]:
    return [(torch.tensor(np.asarray(l["w"], np.float32).T),
             torch.tensor(np.asarray(l["b"], np.float32))) for l in conv]


def _points(case: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    if case == "ties":  # every point duplicated 64 rows later: exact ties in the max
        base = rng.standard_normal((2, 64, 3)).astype(np.float32) * 0.3
        return np.concatenate([base, base], axis=1)
    return rng.standard_normal((4, 256, 3)).astype(np.float32) * 0.3


@pytest.mark.parametrize("case", ["random", "ties", "negative"])
def test_reference_matches_jax_kernel_interpret(case):
    conv = list(_jax_conv(jnp.bfloat16)["conv"])
    if case == "negative":  # layer 5 has no ReLU: shifted biases drive the maxima below
        # zero, and above -4, where one bf16 step (0.031) exceeds the bound
        conv[4] = {**conv[4], "b": conv[4]["b"] - 2.0}
    xs = _points(case)
    want = jax_trunk_pooled(conv, jnp.asarray(xs, jnp.bfloat16), interpret=True)
    layers = [(w.to(torch.bfloat16), b.to(torch.bfloat16)) for w, b in _port_layers(conv)]
    got = trunk_pooled_reference(layers, torch.from_numpy(xs).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (xs.shape[0], 512)
    if case == "negative":
        assert (got.float() < 0).any()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_ATOL)


@pytest.mark.parametrize("n", [64, 1024])
def test_fp32_plain_trunk_matches_jax(n):
    params = _jax_conv()
    enc = Encoder(128)
    enc.load_state_dict(params_from_jax(params))
    xs = np.random.default_rng(1).standard_normal((2, n, 3)).astype(np.float32)
    want = np.asarray(_trunk(params, jnp.asarray(xs), fast=True))
    got = enc.trunk(torch.from_numpy(xs), fast=True).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_cpu_wrapper_takes_plain_path():
    conv = _jax_conv(jnp.bfloat16)["conv"]
    layers = [(w.to(torch.bfloat16), b.to(torch.bfloat16)) for w, b in _port_layers(conv)]
    x = torch.from_numpy(_points("random")).to(torch.bfloat16)
    before = trunk_pooled.launches
    got = trunk_pooled(layers, x)
    assert trunk_pooled.launches == before
    assert torch.equal(got, trunk_pooled_reference(layers, x))


def test_encoder_dispatch_gate_matches_jax():
    """bf16 with N % 8 == 0 takes the fused path; other N take the plain chain."""
    params = _jax_conv()
    enc = Encoder(128)
    enc.load_state_dict(params_from_jax(params))
    enc = enc.to(torch.bfloat16)
    xs = np.random.default_rng(2).standard_normal((2, 60, 3)).astype(np.float32) * 0.3
    x = torch.from_numpy(xs).to(torch.bfloat16)
    # N=60: both paths are the plain chain, bit for bit
    assert torch.equal(enc.trunk(x, fast=True), enc.trunk(x, fast=False))
    with pytest.raises(ValueError, match="multiple of 8"):
        trunk_pooled([(l.weight, l.bias) for l in enc.conv], x)


def test_wrapper_rejects_bad_layers():
    conv = _jax_conv()["conv"]
    layers = _port_layers(conv)
    x = torch.zeros((1, 8, 3))
    with pytest.raises(ValueError, match="expected 5 layers"):
        trunk_pooled(layers[:4], x)
    bad = list(layers)
    bad[2] = (layers[2][0].T, layers[2][1])
    with pytest.raises(ValueError, match="layer 2 weight"):
        trunk_pooled(bad, x)
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        trunk_pooled(layers, torch.zeros((1, 8, 4)))


def test_reference_without_bias_uses_zero_bias():
    conv = _jax_conv()["conv"]
    layers = _port_layers(conv)
    x = torch.from_numpy(_points("random")).to(torch.bfloat16)
    zero = [(w, torch.zeros_like(b)) for w, b in layers]
    assert torch.equal(trunk_pooled_reference([(w, None) for w, _ in layers], x),
                       trunk_pooled_reference(zero, x))


def test_build_failure_raises(tmp_path):
    """A failing nvcc raises with its output; nothing falls back."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fake compiler error' >&2\nexit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    with pytest.raises(RuntimeError, match="fake compiler error"):
        _build.build(tmp_path / "out", nvcc=str(fake))
    assert not any(p.name.endswith(".so") for p in (tmp_path / "out").iterdir())


def test_build_hash_covers_sources_and_flags(monkeypatch, tmp_path):
    assert [p.name for p in _build.sources()] == [
        "nn_min_fused.cu", "nn_one_direction.cu", "trunk_pool.cu"]
    base = _build.source_hash()
    assert base == _build.source_hash() and len(base) == 16
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.source_hash() != base
    monkeypatch.undo()
    files = sorted(_build.CSRC.glob("*.cu*"))
    assert "nn_common.cuh" in [f.name for f in files]
    for edited in ("trunk_pool.cu", "nn_common.cuh"):  # a source, and a header beside them
        copy = tmp_path / edited / "csrc"
        copy.mkdir(parents=True)
        for f in files:
            (copy / f.name).write_bytes(f.read_bytes() + (b"\n// edited\n" if f.name == edited
                                                          else b""))
        monkeypatch.setattr(_build, "CSRC", copy)
        assert _build.source_hash() != base
        monkeypatch.undo()
    assert _build.source_hash() == base
    assert os.path.basename(_build.BUILD_ROOT) == "_build"
