"""Real-scan dataset (.npy objects, scenes and boxes).

Port of ``hyperpocket_tpu/data/real_data.py`` (numpy, no framework): object
scans are centred and scaled into the 0.9 box and resampled to 1024 points
with numpy's global RNG, as in the JAX package; ``inverse_scale[_to_scene]``
undoes the normalisation back into scene coordinates.
"""

from __future__ import annotations

from os import listdir
from os.path import join

import numpy as np

from hyperpocket_tpu_torch.data.base import resample_pcd


def get_scales(pcd: np.ndarray) -> tuple[np.ndarray, float]:
    """(center, scale): ``(pcd - center) / scale`` fits the cloud in the 0.9 box."""
    axis_mins = pcd.min(axis=0)
    axis_maxs = pcd.max(axis=0)
    scale = float((axis_maxs - axis_mins).max())
    return (axis_maxs + axis_mins) / 2, scale / 0.9


class RealDataNPYDataset:
    """``object*``, ``object_box*`` and ``scen*`` .npy files of one directory."""

    def __init__(self, root_dir: str):
        self.root_dir = root_dir
        self.scenes: list[str] = []
        self.objs: list[str] = []
        self.boxes: list[str] = []
        for f in sorted(listdir(root_dir)):
            if f.startswith("object_box"):
                self.boxes.append(f)
            elif f.startswith("object"):
                self.objs.append(f)
            elif f.startswith("scen"):
                self.scenes.append(f)

    _get_scales = staticmethod(get_scales)

    def __len__(self) -> int:
        return len(self.objs)

    def __getitem__(self, idx: int):
        pcd = self.get_full_object(idx)
        center, scale = get_scales(pcd)
        return resample_pcd((pcd - center) / scale, 1024), 0, 0, idx

    def get_full_object(self, idx: int) -> np.ndarray:
        return np.load(join(self.root_dir, self.objs[idx])).astype(np.float32)

    def get_scene(self, idx: int) -> np.ndarray:
        if not self.scenes:
            raise ValueError("Dataset does not include scenes")
        return np.load(join(self.root_dir, self.scenes[idx])).astype(np.float32)

    def get_obj_box(self, idx: int) -> np.ndarray:
        if not self.boxes:
            raise ValueError("Dataset does not include object boxes")
        return np.load(join(self.root_dir, self.boxes[idx])).astype(np.float32)

    def inverse_scale(self, idx: int, scaled_pcd: np.ndarray) -> np.ndarray:
        center, scale = get_scales(self.get_full_object(idx))
        _, scaled_scale = get_scales(scaled_pcd)
        return (scaled_pcd / scaled_scale * scale) + center

    def inverse_scale_to_scene(self, idx: int, scaled_pcd: np.ndarray) -> np.ndarray:
        return np.concatenate([self.get_scene(idx), self.inverse_scale(idx, scaled_pcd)])
