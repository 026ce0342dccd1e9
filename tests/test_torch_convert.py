"""Weights across packages (hyperpocket_tpu_torch/convert.py) vs JAX's checkpoints."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from hyperpocket_tpu.train import checkpoint as jax_ckpt
from hyperpocket_tpu_torch.convert import (
    jax_leaf_names,
    load_jax_npz,
    params_from_jax,
    save_jax_npz,
)
from hyperpocket_tpu_torch.models.full_model import (
    MODE_HYPER_CLOUD,
    MODE_HYPER_POCKET,
    MODE_HYPER_REC,
    FullModel,
)
from tests.test_torch_models import inputs, model_pair, run_jax, run_port, tiny_config

MODES = [MODE_HYPER_POCKET, MODE_HYPER_REC, MODE_HYPER_CLOUD]


def _jax_path_name(path) -> str:
    """A ``tree_flatten_with_path`` key path -> the port's parameter name."""
    parts = [str(k.key) if hasattr(k, "key") else str(k.idx) for k in path]
    parts[-1] = {"w": "weight", "b": "bias"}[parts[-1]]
    return ".".join(parts)


def _config(mode: str, use_bias: bool, freeze: bool = False) -> dict:
    cfg = tiny_config(mode)
    for enc in ("random_encoder", "real_encoder"):
        cfg[enc] = {**cfg[enc], "use_bias": use_bias}
    cfg["hyper_network"] = {**cfg["hyper_network"], "use_bias": use_bias}
    cfg["target_network"] = {**cfg["target_network"], "freeze_layers_learning": freeze}
    return cfg


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("use_bias,freeze", [(True, False), (False, False), (True, True)])
def test_leaf_order_matches_jax_tree_flatten(mode, use_bias, freeze):
    cfg = _config(mode, use_bias, freeze)
    jmodel, params, port = model_pair(cfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    assert jax_leaf_names(port) == [_jax_path_name(p) for p, _ in flat]
    state = port.state_dict()
    assert set(state) == set(jax_leaf_names(port))
    for path, leaf in flat:
        name = _jax_path_name(path)
        t = state[name].T if name.endswith(".weight") else state[name]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("mode", MODES)
def test_jax_checkpoint_loads_into_port(tmp_path, mode):
    jmodel, params, _ = model_pair(tiny_config(mode), seed=11)
    path = str(tmp_path / "00003_model.npz")
    jax_ckpt.save_tree(path, params)  # with the structure fingerprint
    port = load_jax_npz(path, FullModel.from_config(tiny_config(mode)))
    data = inputs(port, seed=5)
    np.testing.assert_allclose(run_port(port, data, True), run_jax(jmodel, params, data, True),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_port_checkpoint_loads_in_jax_bit_equal(tmp_path, mode):
    jmodel, params, port = model_pair(tiny_config(mode), seed=12)
    path = str(tmp_path / "00004_model.npz")
    save_jax_npz(path, port)
    template = jmodel.init(jax.random.key(99))
    back = jax_ckpt.load_tree(path, template)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_round_trip_is_exact(tmp_path):
    _, _, port = model_pair(tiny_config(), seed=13)
    path = str(tmp_path / "m.npz")
    save_jax_npz(path, port)
    other = load_jax_npz(path, FullModel.from_config(tiny_config(), torch.Generator()))
    for (n, a), (m, b) in zip(port.state_dict().items(), other.state_dict().items()):
        assert n == m and torch.equal(a, b)


def test_loader_checks_leaf_count_and_shapes(tmp_path):
    _, params, _ = model_pair(tiny_config(MODE_HYPER_POCKET))
    path = str(tmp_path / "pocket.npz")
    jax_ckpt.save_tree(path, params)
    with pytest.raises(ValueError, match="leaves"):
        load_jax_npz(path, FullModel.from_config(tiny_config(MODE_HYPER_REC)))
    wider = tiny_config(MODE_HYPER_POCKET)
    wider["real_encoder"] = {**wider["real_encoder"], "output_size": 24}
    with pytest.raises(ValueError, match="shape"):
        load_jax_npz(path, FullModel.from_config(wider))


def test_params_from_jax_transposes_weights():
    _, params, _ = model_pair(tiny_config())
    state = params_from_jax(params)
    w = np.asarray(params["hyper_network"]["heads"]["w"])
    assert tuple(state["hyper_network.heads.weight"].shape) == w.T.shape
    np.testing.assert_array_equal(state["hyper_network.heads.weight"].numpy(), w.T)
