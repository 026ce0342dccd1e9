"""3D-EPN dataset: pre-sliced train/val plies + raw partial-scan test pairs.

A copy of ``hyperpocket_tpu/data/shapenet_3depn.py`` (numpy) reading the
same tree and making the same draws.

Matches reference ``datasets/shapenet_3depn.py``:

* train/val: items from ``slices/{existing,missing,gt}/<cat>/`` with
  ``num_samples`` slice variants per shape (3depn.py:125-135);
* test: pairs a partial scan ``<model>__{0..7}__.ply`` (chosen by a fixed
  ``random.Random(1234)`` stream, 3depn.py:100,107) rotated by the fixed
  axis-swap matrix (3depn.py:139-143) and resampled to 1024, with the
  complete cloud resampled to 2048 (3depn.py:106-123);
* split membership from ``shapenet-official-split.csv`` applies to the TEST
  split only (3depn.py:80-89). REFERENCE QUIRK, preserved by default: the
  train and val branches both list the whole ``slices/gt/<cat>/`` dir
  (3depn.py:101-104) and the reference slicer pools the CSV's train AND val
  models into that one tree (util_scripts/generate_partial_dataset.py:79) —
  so the reference's 3D-EPN "val" dataset is item-for-item its train set,
  and best_val selects on training data. ``dataset.split_by_csv: true``
  (framework extension, off for parity) filters train/val by the official
  CSV labels for a genuinely held-out val split (PARITY.md).
"""

from __future__ import annotations

import csv
import logging
import os
import random
from os.path import exists, join

import numpy as np

from hyperpocket_tpu_torch.data.category_mapping import normalize_classes, synth_id_to_category
from hyperpocket_tpu_torch.data.plyio import load_ply

_DEFAULT_VAL_CLASSES = ("02691156", "03001627", "04379243")

# z-up -> y-up axis swap used for the raw sdf scans (3depn.py:139-143)
_AXIS_SWAP = np.array(
    [[2.22044605e-16, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 2.22044605e-16]],
    dtype=np.float64,
)


def sample_point_cloud_by_n(points: np.ndarray, n_pts: int, rng: random.Random | None = None) -> np.ndarray:
    """Resample to n points by random choice with replacement (3depn.py:18-49)."""
    chooser = rng if rng is not None else random
    n = points.shape[0]
    if n_pts > n:
        extra = [chooser.randrange(n) for _ in range(n_pts - n)]
        return np.concatenate([points, points[extra]], axis=0)
    if n_pts < n:
        idx = [chooser.randrange(n) for _ in range(n_pts)]
        return points[idx]
    return points


def collect_split_by_id(csv_path: str, cat_id: str) -> dict[str, list[str]]:
    """Parse the official split CSV -> {train/validation/test: [model ids]}."""
    info: dict[str, list[str]] = {"train": [], "validation": [], "test": []}
    unknown: dict[str, int] = {}
    with open(csv_path) as fh:
        for i, row in enumerate(csv.reader(fh)):
            if i == 0 or row[1] != cat_id:
                continue
            split = row[-1]
            if split == "val":
                key = "validation"
            elif split in info:
                key = split
            else:
                # a malformed label would otherwise vanish from train AND val
                # (bucketed into test) with no trace — make it visible
                key = "test"
                unknown[split] = unknown.get(split, 0) + 1
            info[key].append(row[-2])
    if unknown:
        logging.getLogger().warning(
            "split CSV %s: %d rows with unrecognized split labels %s for "
            "category %s — bucketed into 'test' (absent from train/val)",
            csv_path, sum(unknown.values()), sorted(unknown), cat_id)
    return info


def _load_mesh_vertices(path: str) -> np.ndarray:
    """Vertices of a ply (meshes allowed; faces ignored)."""
    return load_ply(path)


class ShapeNet3DEPNDataset:
    def __init__(self, root_dir: str, split: str = "train", classes=None, num_samples: int = 4,
                 cache: bool = False, split_by_csv: bool = False):
        self.root_dir = root_dir
        self.split = split
        # optional in-RAM file cache (dataset.cache) — same semantics as the
        # MissingShapeNet cache (shapenet.py): a 400-epoch run re-reads every
        # slice file 400x otherwise. Cached arrays are never mutated in place
        # downstream (the loader stacks copies).
        self._cache: dict[str, np.ndarray] | None = {} if cache else None
        # names ('chair') accepted alongside synset ids — see
        # category_mapping.normalize_classes (superset of the reference, which
        # requires ids here: shapenet_3depn.py:77-78 uses classes[0] as a
        # directory name directly)
        classes = normalize_classes(list(classes or []))
        if split == "test":
            if not classes:
                raise ValueError("3depn test split requires an explicit class")
            self.cat_pc_root = join(root_dir, "ShapeNetPointCloud", classes[0])
            self.cat_pc_raw_root = join(root_dir, "shapenet_dim32_sdf_pc", classes[0])
            names = []
            with open(join(root_dir, "shapenet-official-split.csv")) as fh:
                for i, row in enumerate(csv.reader(fh)):
                    if i == 0 or row[1] != classes[0]:
                        continue
                    if row[-1] == "test":
                        names.append(row[-2])
            self.shape_names = [
                n
                for n in names
                if exists(join(self.cat_pc_root, n + ".ply"))
                and exists(join(self.cat_pc_raw_root, f"{n}__0__.ply"))
            ]
            # The reference consumes Random(1234) once per __getitem__ call,
            # which is only reproducible for a strictly sequential pass (and
            # races under threaded loading). We draw the whole scan-choice
            # sequence up front — identical to the reference's canonical
            # sequential access order, but deterministic under any order.
            rng = random.Random(1234)  # fixed stream from the original publication
            self._raw_choice = [rng.randint(0, 7) for _ in self.shape_names]
        else:
            if len(classes) > 1:
                # REFERENCE QUIRK, preserved: the train/val branches read
                # classes[0] ONLY (reference shapenet_3depn.py:102-104), so a
                # multi-class 3depn TRAINING config silently trains on the
                # first class while per-category val covers all of them. The
                # reference only ever ships per-class 3depn configs, so it
                # never trips this; warn loudly instead of silently dropping
                # categories. dataset.multiclass_train: true (framework
                # extension, data/base.py::get_datasets) concatenates real
                # per-class train sets instead.
                logging.getLogger().warning(
                    "3depn %s split uses ONLY the first class %s of %s "
                    "(reference parity; set dataset.multiclass_train=true "
                    "for a concatenated multi-class train set)",
                    split, classes[0], classes)
            self.cat = classes[0]
            self.shape_names = sorted(os.listdir(join(root_dir, "slices", "gt", classes[0])))
            if split_by_csv:
                # framework extension (dataset.split_by_csv; module
                # docstring): restrict to the official CSV's labels so val
                # is genuinely held out — by default (reference parity) the
                # slicer pools train+val models into slices/ and BOTH
                # branches list the whole dir, making val == train
                info = collect_split_by_id(
                    join(root_dir, "shapenet-official-split.csv"), classes[0])
                want = set(info["train" if split == "train" else "validation"])
                self.shape_names = [
                    n for n in self.shape_names if n.rsplit(".", 1)[0] in want
                ]
            self.num_samples = num_samples

    def __len__(self) -> int:
        if self.split == "test":
            return len(self.shape_names)
        return len(self.shape_names) * self.num_samples

    def __getitem__(self, index: int):
        index = int(index)  # np.int64 indices break random.Random under numpy>=2
        if self.split == "test":
            raw_n = self._raw_choice[index]
            # per-index RNG for the resampling (the reference uses the global
            # random module, which is neither thread-safe nor reproducible;
            # deviation documented in PARITY.md)
            rng = random.Random(1234 * 1_000_003 + index)
            raw = _load_mesh_vertices(
                join(self.cat_pc_raw_root, f"{self.shape_names[index]}__{raw_n}__.ply")
            ).astype(np.float64)
            raw = (_AXIS_SWAP @ raw.T).T
            raw = sample_point_cloud_by_n(raw, 1024, rng).astype(np.float32)
            real = _load_mesh_vertices(join(self.cat_pc_root, self.shape_names[index] + ".ply"))
            real = sample_point_cloud_by_n(real, 2048, rng).astype(np.float32)
            return raw, 0, real, self.shape_names[index]
        fname = self.shape_names[index // self.num_samples]
        scan = str(index % self.num_samples)
        existing = self._load(join(self.root_dir, "slices", "existing", self.cat, scan + "~" + fname))
        missing = self._load(join(self.root_dir, "slices", "missing", self.cat, scan + "~" + fname))
        gt = self._load(join(self.root_dir, "slices", "gt", self.cat, fname))
        return existing, missing, gt, fname[:-4]

    def _load(self, path: str) -> np.ndarray:
        if self._cache is None:
            return load_ply(path)
        cloud = self._cache.get(path)
        if cloud is None:
            cloud = load_ply(path)
            self._cache[path] = cloud
        return cloud

    @classmethod
    def get_validation_datasets(cls, root_dir, classes=None, **kwargs):
        classes = normalize_classes(list(classes or _DEFAULT_VAL_CLASSES))
        return {
            synth_id_to_category[cat]: cls(root_dir=root_dir, split="val", classes=[cat], **kwargs)
            for cat in classes
        }

    @classmethod
    def get_test_datasets(cls, root_dir, classes=None, **kwargs):
        classes = normalize_classes(list(classes or []))
        return {
            synth_id_to_category[cat]: cls(root_dir=root_dir, split="test", classes=[cat], **kwargs)
            for cat in classes
        }
