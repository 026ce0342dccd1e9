"""Completion3D benchmark dataset (.h5 partial/gt pairs).

Port of ``hyperpocket_tpu/data/completion3d.py`` (numpy and h5py, no
framework): ``<split>.list`` names the models, read from
``<split>/partial/<id>.h5`` and ``<split>/gt/<id>.h5``; the test split has
no ground truth (gt := existing), and ``missing`` is the scalar placeholder
0 on every split. ``h5py`` is imported by the reader only.
"""

from __future__ import annotations

import os

import numpy as np

from hyperpocket_tpu_torch.data.category_mapping import normalize_classes, synth_id_to_category

_DEFAULT_VAL_CLASSES = (
    "02691156", "02933112", "02958343", "03001627",
    "03636649", "04256520", "04379243", "04530566",
)


def _load_h5(path: str) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        return np.array(f["data"]).astype(np.float32)


class Completion3DDataset:
    def __init__(self, root_dir: str, split: str = "train", classes=None, model_list=None):
        self.root_dir = root_dir
        self.split = split
        if model_list is None:
            with open(os.path.join(root_dir, f"{split}.list")) as fh:
                lines = [line.strip() for line in fh if line.strip()]
            if classes:  # category names are accepted beside synset ids
                classes = normalize_classes(list(classes))
                lines = [ln for ln in lines if ln.split("/")[0] in classes]
            self.model_list = lines
        else:
            self.model_list = list(model_list)

    def __len__(self) -> int:
        return len(self.model_list)

    def __getitem__(self, index: int):
        name = self.model_list[index]
        existing = _load_h5(os.path.join(self.root_dir, self.split, "partial", name + ".h5"))
        if self.split != "test":
            gt = _load_h5(os.path.join(self.root_dir, self.split, "gt", name + ".h5"))
        else:
            gt = existing
        return existing, 0, gt, name

    @classmethod
    def get_validation_datasets(cls, root_dir, classes=None, **kwargs):
        """{category name: val dataset}, the default eight classes when none are given."""
        classes = normalize_classes(list(classes or _DEFAULT_VAL_CLASSES))
        lists: dict[str, list[str]] = {c: [] for c in classes}
        with open(os.path.join(root_dir, "val.list")) as fh:
            for line in fh:
                line = line.strip()
                if line and line.split("/")[0] in lists:
                    lists[line.split("/")[0]].append(line)
        return {
            synth_id_to_category[cat]: cls(root_dir=root_dir, split="val", model_list=models)
            for cat, models in lists.items()
        }

    @classmethod
    def get_test_datasets(cls, root_dir, **kwargs):
        return {"all": cls(root_dir=root_dir, split="test")}
