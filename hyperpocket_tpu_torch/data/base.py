"""Point-count resampling, as ``hyperpocket_tpu/data/base.py::resample_pcd``."""

from __future__ import annotations

import numpy as np


def resample_pcd(pcd: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """Random drop/duplicate to exactly n points; the same draws as the JAX package."""
    idx = rng.permutation(pcd.shape[0])
    if idx.shape[0] < n:
        idx = np.concatenate([idx, rng.integers(0, pcd.shape[0], size=n - pcd.shape[0])])
    return pcd[idx[:n]]
