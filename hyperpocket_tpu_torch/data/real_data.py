"""Real-scan normalisation, as ``hyperpocket_tpu/data/real_data.py::_get_scales``."""

from __future__ import annotations

import numpy as np


def get_scales(pcd: np.ndarray) -> tuple[np.ndarray, float]:
    """(center, scale): ``(pcd - center) / scale`` fits the cloud in the 0.9 box."""
    axis_mins = pcd.min(axis=0)
    axis_maxs = pcd.max(axis=0)
    scale = float((axis_maxs - axis_mins).max())
    return (axis_maxs + axis_mins) / 2, scale / 0.9
