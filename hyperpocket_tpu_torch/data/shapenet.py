"""MissingShapeNet: pre-sliced ShapeNet clouds (existing/missing pockets).

A copy of ``hyperpocket_tpu/data/shapenet.py`` (numpy) reading the same
tree and making the same draws.

Directory layout and item semantics match reference ``datasets/shapenet.py``:

* model list mode (PCN lists ``<root>/{train,val,test}.list`` of
  ``<synset>/<model>`` lines, shapenet.py:31-38) or directory-walk mode with
  an 85/5/10 split per category (shapenet.py:40-61);
* items: ``slices/{existing,missing}/<cat>/<k>~<model>.ply`` plus ground
  truth ``<cat>/<model>.ply`` (shapenet.py:85-87); ``num_samples`` slice
  variants per cloud (idx // num_samples picks the model, idx % num_samples
  the slice, shapenet.py:67-78);
* optional shared random z-rotation of all three clouds (shapenet.py:73-92);
* gen-test mode reads ``test_gen/{right,left,gt}`` with existing/missing
  resampled to 1024 (shapenet.py:80-83).
"""

from __future__ import annotations

import math
import os
from os.path import join

import numpy as np

from hyperpocket_tpu_torch.data.base import resample_pcd
from hyperpocket_tpu_torch.data.category_mapping import (
    normalize_classes,
    synth_id_to_category,
    synth_id_to_number,
)
from hyperpocket_tpu_torch.data.plyio import load_ply

PCN_DEFAULT_CLASSES = (
    "02691156", "02933112", "02958343", "03001627",
    "03636649", "04256520", "04379243", "04530566",
)


def _rotation_z(degrees: float) -> np.ndarray:
    rad = math.radians(degrees)
    c, s = math.cos(rad), math.sin(rad)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=np.float32)


class MissingShapeNetDataset:
    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        classes: list[str] | None = None,
        is_random_rotated: bool = False,
        num_samples: int = 4,
        use_pcn_model_list: bool = True,
        is_gen: bool = False,
        cache: bool = False,
    ):
        self.root_dir = root_dir
        self.split = split
        self.is_random_rotated = is_random_rotated
        self.use_pcn_model_list = use_pcn_model_list
        self.is_gen = is_gen
        self.num_samples = 1 if is_gen else num_samples
        # optional in-RAM file cache: at 0.7 ms/step the disk is the
        # bottleneck, and the full 2048-pt MSN corpus is only ~700 MB
        self._cache: dict[str, np.ndarray] | None = {} if cache else None
        classes = normalize_classes(list(classes or []))

        if use_pcn_model_list:
            with open(join(root_dir, split + ".list")) as fh:
                lines = [line.strip() for line in fh if line.strip()]
            if classes:
                lines = [ln for ln in lines if ln.split("/")[0] in classes]
            self.names = lines
        else:
            if not classes:
                classes = [c for c in synth_id_to_category if os.path.isdir(join(root_dir, c))]
            names: list[str] = []
            for cat in classes:
                files = sorted(f for f in os.listdir(join(root_dir, cat)) if f != ".DS_Store")
                n = len(files)
                if split == "train":
                    chosen = files[: int(0.85 * n)]
                elif split == "val":
                    chosen = files[int(0.85 * n) : int(0.9 * n)]
                else:
                    chosen = files[int(0.9 * n) :]
                names.extend(f"{cat}/{f[:-4] if f.endswith('.ply') else f}" for f in chosen)
            self.names = names

    def __len__(self) -> int:
        return len(self.names) * self.num_samples

    def _load(self, path: str) -> np.ndarray:
        if self._cache is None:
            return load_ply(path)
        cloud = self._cache.get(path)
        if cloud is None:
            cloud = load_ply(path)
            self._cache[path] = cloud
        return cloud

    def __getitem__(self, idx: int):
        cat, model = self.names[idx // self.num_samples].split("/")
        scan_idx = str(idx % self.num_samples)
        fname = model + ".ply"
        if self.is_gen and self.split == "test":
            existing = resample_pcd(self._load(join(self.root_dir, "test_gen", "right", cat, fname)), 1024)
            missing = resample_pcd(self._load(join(self.root_dir, "test_gen", "left", cat, fname)), 1024)
            gt = self._load(join(self.root_dir, "test_gen", "gt", cat, fname))
        else:
            existing = self._load(join(self.root_dir, "slices", "existing", cat, scan_idx + "~" + fname))
            missing = self._load(join(self.root_dir, "slices", "missing", cat, scan_idx + "~" + fname))
            gt = self._load(join(self.root_dir, cat, fname))
        if self.is_random_rotated:
            rot = _rotation_z(np.random.randint(360))
            existing = existing @ rot
            missing = missing @ rot
            gt = gt @ rot
        return existing, missing, gt, synth_id_to_number[cat]

    # ------------------------------------------------------------------
    @classmethod
    def _per_class(cls, root_dir, split, classes=None, **kwargs):
        classes = normalize_classes(list(classes or []))
        if not classes:
            classes = list(PCN_DEFAULT_CLASSES) if kwargs.get("use_pcn_model_list", True) else list(synth_id_to_category)
        return {
            synth_id_to_category[cat]: cls(root_dir=root_dir, split=split, classes=[cat], **kwargs)
            for cat in classes
        }

    @classmethod
    def get_validation_datasets(cls, root_dir, classes=None, **kwargs):
        kwargs.pop("is_gen", None)
        return cls._per_class(root_dir, "val", classes, **kwargs)

    @classmethod
    def get_test_datasets(cls, root_dir, classes=None, **kwargs):
        return cls._per_class(root_dir, "test", classes, **kwargs)
