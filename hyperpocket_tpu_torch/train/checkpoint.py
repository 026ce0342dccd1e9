"""Restore a trained model from the JAX package's results tree.

Part of ``hyperpocket_tpu/train/checkpoint.py``: the epoch lookup and the
reference's restore policies ``latest`` / ``best_val`` / explicit int
(core/setup.py:80-101), and ``restore_trained_model``, which builds the
model from a config and loads ``weights/{epoch:05}_model.npz`` through
``convert.load_jax_npz``. Saving checkpoints comes with the training loop.
"""

from __future__ import annotations

import re
from os import listdir
from os.path import exists, join

import numpy as np
import torch

from hyperpocket_tpu_torch.convert import load_jax_npz
from hyperpocket_tpu_torch.models.full_model import FullModel
from hyperpocket_tpu_torch.train.config import get_results_dir_path

_EPOCH_RE = re.compile(r"^(?P<n>\d+)_(model\.npz|model\.pth|[DEG]\.pth)$")


def _saved_epochs(weights_path: str) -> set[int]:
    if not exists(weights_path):
        return set()
    return {int(m.group("n")) for f in listdir(weights_path) if (m := _EPOCH_RE.match(f))}


def find_latest_epoch(dirpath: str) -> int:
    """Max epoch among saved weights (reference utils/util.py:13-23)."""
    if exists(join(dirpath, "weights")):
        dirpath = join(dirpath, "weights")
    return max(_saved_epochs(dirpath), default=0)


def resolve_restore_epoch(metrics_path: str, epoch: int, restore_policy,
                          weights_path: str | None = None) -> int:
    """``latest`` -> epoch; ``best_val`` -> argmin of the saved val curve + 1,
    among epochs whose weights exist when ``weights_path`` is given; else int."""
    if restore_policy == "latest":
        return epoch
    if restore_policy == "best_val":
        val = np.load(join(metrics_path, f"{epoch:05}_val.npy"), allow_pickle=True)
        val = np.asarray(val, dtype=np.float64).reshape(len(val), -1)[:, 0]
        if weights_path is not None:
            saved = _saved_epochs(weights_path)
            candidates = [e for e in range(1, len(val) + 1) if e in saved]
            if candidates:
                return min(candidates, key=lambda e: val[e - 1])
        return int(np.argmin(val)) + 1
    try:
        return int(restore_policy)
    except (TypeError, ValueError):
        raise ValueError(
            "`[epoch]` value can take only values: `latest`, `best_val` or positive integer"
        )


def restore_trained_model(config: dict, restore_policy=None,
                          device: str | torch.device = "cpu"):
    """(model, epoch) from a training config's results tree.

    The model is built from ``config["full_model"]`` and restored with
    ``restore_policy`` (default: the config's ``experiments.epoch``, else
    ``latest``). Raises FileNotFoundError when no checkpoint exists.
    """
    training_dir = get_results_dir_path(config, "training")
    weights_path = join(training_dir, "weights")
    metrics_path = join(training_dir, "metrics")
    latest = find_latest_epoch(weights_path)
    if latest <= 0:
        raise FileNotFoundError(f"no weights found at {weights_path}")
    if restore_policy is None:
        restore_policy = config.get("experiments", {}).get("epoch", "latest")
    epoch = resolve_restore_epoch(metrics_path, latest, restore_policy, weights_path)
    generator = torch.Generator().manual_seed(int(config["setup"]["seed"]))
    model = FullModel.from_config(config["full_model"], generator)
    load_jax_npz(join(weights_path, f"{epoch:05}_model.npz"), model)
    return model.to(device), epoch
