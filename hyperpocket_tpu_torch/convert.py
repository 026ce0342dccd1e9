"""Carry weights between the JAX package's parameter tree and ``FullModel``.

The JAX package stores a dense weight as ``(in, out)`` and applies it as
``x @ w``; ``nn.Linear`` stores ``(out, in)``, so every weight is transposed
on the way across, the (2048, 19011) hypernetwork head included. Module
names mirror the JAX tree's keys (``real_encoder.conv.0.weight`` is
``params["real_encoder"]["conv"][0]["w"]``).

JAX checkpoints (``hyperpocket_tpu/train/checkpoint.py``) are ``.npz`` files
of positional leaves ``arr_0..arr_k`` in ``jax.tree_util.tree_flatten``
order: sorted dict keys, list items in order, ``b`` before ``w``. The
structure fingerprint they may carry (``__structure__``) hashes JAX's
treedef repr, which cannot be rebuilt without JAX: the loader skips it and
checks the leaf count and every shape instead. ``save_jax_npz`` writes no
fingerprint, which the JAX loader accepts with the same shape checks.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from hyperpocket_tpu_torch.models.full_model import FullModel

_TORCH_NAME = {"w": "weight", "b": "bias"}


def jax_leaf_names(model: FullModel) -> list[str]:
    """The model's parameter names in the JAX checkpoint's leaf order."""

    def linear(prefix: str, module) -> list[str]:
        return [f"{prefix}.{n}" for n in ("bias", "weight") if getattr(module, n) is not None]

    def encoder(prefix: str, enc) -> list[str]:
        names = []
        for i, layer in enumerate(enc.conv):
            names += linear(f"{prefix}.conv.{i}", layer)
        for head in ("fc", "mu", "std"):
            names += linear(f"{prefix}.{head}", getattr(enc, head))
        return names

    hn = model.hyper_network
    names = linear("hyper_network.heads", hn.heads)
    for i, layer in enumerate(hn.trunk):
        names += linear(f"hyper_network.trunk.{i}", layer)
    if model.random_encoder_output_size > 0:
        names += encoder("random_encoder", model.random_encoder)
    if model.real_encoder_output_size > 0:
        names += encoder("real_encoder", model.real_encoder)
    return names


def _jax_layout(name: str, a):
    """A weight goes (out, in) <-> (in, out); a bias is unchanged."""
    return a.T if name.endswith(".weight") else a


def params_from_jax(tree: dict[str, Any],
                    dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> a ``FullModel`` state_dict in ``dtype``."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    out: dict[str, torch.Tensor] = {}

    def walk(node, path: list[str]) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            name = ".".join(path[:-1] + [_TORCH_NAME[path[-1]]])
            out[name] = torch.tensor(_jax_layout(name, np.asarray(node, dtype=np_dtype)))

    walk(tree, [])
    return out


def params_to_jax(model: torch.nn.Module) -> dict[str, Any]:
    """A model's parameters as the JAX parameter tree, numpy leaves in their dtype.

    The inverse of ``params_from_jax``: weights go back to ``(in, out)`` and
    numbered modules (``conv.0``, ``trunk.3``) become lists.
    """
    tree: dict[str, Any] = {}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[{"weight": "w", "bias": "b"}[leaf]] = _jax_layout(name, t.detach().cpu().numpy())

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def load_jax_npz(path: str, model: FullModel) -> FullModel:
    """Load a JAX positional checkpoint into ``model`` (in place) and return it."""
    names = jax_leaf_names(model)
    state = model.state_dict()
    with np.load(path) as data:
        n_leaves = sum(1 for f in data.files if f.startswith("arr_"))
        if n_leaves != len(names):
            raise ValueError(f"{path}: checkpoint has {n_leaves} leaves, model has {len(names)}")
        loaded = {}
        for i, name in enumerate(names):
            arr = data[f"arr_{i}"]
            want = tuple(_jax_layout(name, state[name]).shape)
            if arr.shape != want:
                raise ValueError(f"{path}: leaf {i} ({name}) shape {arr.shape}, expected {want}")
            loaded[name] = torch.tensor(_jax_layout(name, arr.astype(np.float32)))
    model.load_state_dict(loaded)
    return model


def save_jax_npz(path: str, model: FullModel) -> None:
    """Write ``model``'s fp32 parameters as a JAX positional checkpoint."""
    state = model.state_dict()
    leaves = [_jax_layout(n, state[n].detach().float().cpu().numpy()) for n in jax_leaf_names(model)]
    np.savez(path, *[np.ascontiguousarray(a) for a in leaves])
