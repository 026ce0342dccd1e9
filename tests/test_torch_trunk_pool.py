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
from hyperpocket_tpu_torch.ops import _build, trunk_pool
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
        "adam_lowp.cu", "chamfer_loss_grad.cu", "decode_batch.cu", "decode_batch_grad.cu",
        "decode_batch_tc.cu", "emd_match_cost.cu", "emd_match_cost_grad.cu", "head_adam.cu",
        "nn_fused_planes.cu", "nn_min_fused.cu", "nn_one_direction.cu", "trunk_pool.cu"]
    base = _build.source_hash()
    assert base == _build.source_hash() and len(base) == 16
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.source_hash() != base
    monkeypatch.undo()
    files = sorted(_build.CSRC.glob("*.cu*"))
    assert {"nn_common.cuh", "nn_fused.cuh", "emd_common.cuh"} <= {f.name for f in files}
    # a source, and the headers beside them
    for edited in ("trunk_pool.cu", "nn_common.cuh", "nn_fused.cuh", "emd_common.cuh"):
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


def _aligned_layers() -> list[torch.Tensor]:
    """[w1, b1, ..., w5, b5] as fresh (aligned) bf16 tensors."""
    widths = trunk_pool.WIDTHS
    out = []
    for i in range(len(widths) - 1):
        out += [torch.zeros((widths[i + 1], widths[i]), dtype=torch.bfloat16),
                torch.zeros(widths[i + 1], dtype=torch.bfloat16)]
    return out


def _offset(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A copy of t whose data starts ``nbytes`` past an aligned address."""
    flat = torch.zeros(t.numel() + 16, dtype=t.dtype)
    shift = (-flat.data_ptr() % 64 + nbytes) // t.element_size()
    view = flat[shift:shift + t.numel()].view(t.shape)
    assert view.data_ptr() % 64 == nbytes
    return view


@pytest.mark.parametrize("index, nbytes, ok", [
    (2, 8, False),   # w2 8 bytes off: TMA takes 16-byte aligned rows
    (8, 2, False),   # w5 2 bytes off
    (6, 16, True),   # w4 16 bytes off: fine
    (5, 2, False),   # b3 read in 4-byte words
    (5, 4, True),
    (0, 4, True),    # w1 is read in plain loads
    (0, 2, False),
])
def test_alignment_check_refuses_what_the_copies_cannot_take(index, nbytes, ok):
    args = _aligned_layers()
    trunk_pool._check_alignment(args)
    args[index] = _offset(args[index], nbytes)
    if ok:
        trunk_pool._check_alignment(args)
    else:
        layer, is_bias = divmod(index, 2)
        with pytest.raises(ValueError, match=f"aligned layer {layer + 1} "
                                             f"{'bias' if is_bias else 'weight'}"):
            trunk_pool._check_alignment(args)


def test_ptxas_report_reads_registers_and_spills():
    log = """nvcc -c trunk_pool.cu
ptxas info    : Compiling entry function '_Z17trunk_pool_kernelILb1EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z17trunk_pool_kernelILb1EEvv
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 640 bytes cmem[0]
ptxas info    : Compiling entry function '_Z12fill_neg_infPfi' for 'sm_90a'
ptxas info    : Function properties for _Z12fill_neg_infPfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 8 registers, 364 bytes cmem[0]
ptxas info    : Compiling entry function '_Z17trunk_pool_kernelILb0EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z17trunk_pool_kernelILb0EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 167 registers, 48 bytes smem, 640 bytes cmem[0]
"""
    assert _build.ptxas_report(log, "trunk_pool_kernel") == [
        {"function": "_Z17trunk_pool_kernelILb1EEvv", "spill_stores": 8, "spill_loads": 4,
         "registers": 168, "static_smem": 0},
        {"function": "_Z17trunk_pool_kernelILb0EEvv", "spill_stores": 0, "spill_loads": 0,
         "registers": 167, "static_smem": 48},
    ]
    assert "-v" in _build.NVCC_FLAGS and "-Xptxas" in _build.NVCC_FLAGS
