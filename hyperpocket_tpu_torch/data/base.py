"""Dataset factory, concatenation and point-count resampling.

Port of ``hyperpocket_tpu/data/base.py`` (numpy, no framework). Datasets
yield ``(existing, missing, gt, label)`` with clouds as (N, 3) float32
arrays. ``get_datasets`` returns ``(train, val_dict, test_dict)`` for the
``shapenet`` (MissingShapeNet) and ``3depn`` families; Completion3D is not
ported yet.
"""

from __future__ import annotations

import numpy as np


class ConcatDataset:
    """Sequential concatenation of datasets (bounds-checked)."""

    def __init__(self, parts):
        self.parts = list(parts)
        self._lens = [len(p) for p in self.parts]

    def __len__(self) -> int:
        return sum(self._lens)

    def __getitem__(self, idx: int):
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        for part, n in zip(self.parts, self._lens):
            if idx < n:
                return part[idx]
            idx -= n
        raise IndexError(idx)


def get_datasets(config: dict):
    """The config's ``dataset`` section -> (train, val_dataset_dict, test_dataset_dict)."""
    name = config["name"]
    if name == "shapenet":
        from hyperpocket_tpu_torch.data.shapenet import MissingShapeNetDataset

        common = dict(
            root_dir=config["path"],
            classes=config.get("classes", []),
            is_random_rotated=config.get("is_rotated", False),
            num_samples=config.get("num_samples", 1),
            use_pcn_model_list=True,
            cache=config.get("cache", False),
        )
        train = MissingShapeNetDataset(split="train", **common)
        val = MissingShapeNetDataset.get_validation_datasets(**common)
        test = MissingShapeNetDataset.get_test_datasets(
            is_gen=config.get("gen_test_set", False), **common)
        return train, val, test
    if name == "completion":
        raise NotImplementedError(
            "the Completion3D dataset is not ported yet (ROADMAP.md, open items: "
            "'Completion3D dataset')")
    if name == "3depn":
        from hyperpocket_tpu_torch.data.category_mapping import normalize_classes
        from hyperpocket_tpu_torch.data.shapenet_3depn import ShapeNet3DEPNDataset

        classes = config.get("classes", [])
        common = dict(
            root_dir=config["path"],
            num_samples=config.get("num_samples", 4),
            cache=config.get("cache", False),
            split_by_csv=config.get("split_by_csv", False),
        )
        if config.get("multiclass_train", False) and len(classes) > 1:
            # one train set per distinct class (a name and its synset id are one)
            train = ConcatDataset([
                ShapeNet3DEPNDataset(split="train", classes=[c], **common)
                for c in dict.fromkeys(normalize_classes(list(classes)))
            ])
        else:
            train = ShapeNet3DEPNDataset(split="train", classes=classes, **common)
        val = ShapeNet3DEPNDataset.get_validation_datasets(classes=classes, **common)
        test = ShapeNet3DEPNDataset.get_test_datasets(config["path"], classes=classes)
        return train, val, test
    raise ValueError(
        f"Invalid dataset name. Expected `shapenet`, `completion` or `3depn`. Got: `{name}`")


def resample_pcd(pcd: np.ndarray, n: int, rng: np.random.Generator | None = None) -> np.ndarray:
    """Random drop/duplicate to exactly n points; the same draws as the JAX package.

    With ``rng=None`` the draws come from numpy's global legacy RNG
    (``np.random.permutation``/``randint``), as in the JAX package, so that
    ``utils/logging_setup.py::seed_setup`` followed by the same reads gives
    the same items in both packages.
    """
    if rng is None:
        idx = np.random.permutation(pcd.shape[0])
        if idx.shape[0] < n:
            idx = np.concatenate([idx, np.random.randint(pcd.shape[0], size=n - pcd.shape[0])])
    else:
        idx = rng.permutation(pcd.shape[0])
        if idx.shape[0] < n:
            idx = np.concatenate([idx, rng.integers(0, pcd.shape[0], size=n - pcd.shape[0])])
    return pcd[idx[:n]]
