"""The loader's resident route (``data/loader.py``) against its host route, on the CPU.

A loader given a device keeps a cached corpus whose items are fixed on that
device and gathers each epoch's batches there. Its batches are held bit for
bit to the host route's (values, dtype and shape; labels as the host route
collates them) for a shuffled train loader with ``drop_last``, a val loader
with a ragged tail and each rank of a two-way ``process_shard``. The host
route runs, and ``loader.resident`` stays at 0, where the dataset is not
cached, is randomly rotated, has items of mixed shapes, no device is
passed, or the corpus is over the memory budget. A Trainer on a cached
3D-EPN tree trains scanned and stepped epochs bit-equal to one on the same
tree uncached.
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hyperpocket_tpu_torch.data import loader as loader_mod
from hyperpocket_tpu_torch.data.loader import BatchLoader
from hyperpocket_tpu_torch.data.plyio import save_ply
from hyperpocket_tpu_torch.data.shapenet import MissingShapeNetDataset
from hyperpocket_tpu_torch.data.shapenet_3depn import ShapeNet3DEPNDataset
from hyperpocket_tpu_torch.train import trainer as trainer_mod
from hyperpocket_tpu_torch.utils import profiling
from tests.test_data import make_synthetic_shapenet
from tests.test_train_integration import make_config

CHAIR = "03001627"
EPOCHS = 2


def make_3depn_slices(root, n_models: int = 5, num_samples: int = 2, n_gt: int = 64,
                      n_part: int = 32, seed: int = 0) -> None:
    """A sliced 3D-EPN chair tree (``slices/{existing,missing,gt}``) and an
    official split CSV with no test rows."""
    rng = np.random.default_rng(seed)
    for kind in ("existing", "missing", "gt"):
        os.makedirs(join(root, "slices", kind, CHAIR), exist_ok=True)
    for i in range(n_models):
        name = f"m{i:02d}.ply"
        gt = rng.standard_normal((n_gt, 3)).astype(np.float32) * 0.2
        save_ply(join(root, "slices", "gt", CHAIR, name), gt)
        for k in range(num_samples):
            order = np.argsort(gt @ rng.standard_normal(3))
            save_ply(join(root, "slices", "existing", CHAIR, f"{k}~{name}"), gt[order[:n_part]])
            save_ply(join(root, "slices", "missing", CHAIR, f"{k}~{name}"), gt[order[-n_part:]])
    with open(join(root, "shapenet-official-split.csv"), "w") as fh:
        fh.write("id,synsetId,subSynsetId,modelId,split\n")


def tree_3depn_config(root, results, cache: bool, mode: str, batch: int = 4) -> dict:
    """The tiny training config on a 3D-EPN tree of 10 items: 2 train
    batches of 4 (drop_last) and 3 val batches (4, 4 and a ragged 2)."""
    config = make_config(root, results, max_epoch=EPOCHS, batch=batch)
    config["dataset"] = {"name": "3depn", "path": str(root), "classes": [CHAIR],
                         "num_samples": 2, "cache": cache}
    config["training"].update(epoch_mode=mode, min_save_epoch=EPOCHS)
    return config


@pytest.fixture(autouse=True)
def clean_totals():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def epn_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("epn")
    make_3depn_slices(root)
    return root


@pytest.fixture(scope="module")
def msn_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("msn")
    make_synthetic_shapenet(root, n_models=6, num_samples=2, n_gt=64, n_part=32)
    return root


def _batches(loader: BatchLoader, epoch: int) -> list[tuple]:
    return list(loader.epoch(epoch))


def _assert_same_batches(resident: list[tuple], host: list[tuple]) -> None:
    assert len(resident) == len(host) > 0
    for got, want in zip(resident, host):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray) and w.dtype == np.float32:
                assert torch.is_tensor(g) and g.dtype == torch.float32
                assert g.shape == w.shape and torch.equal(g, torch.from_numpy(w))
            elif isinstance(w, np.ndarray):
                assert isinstance(g, np.ndarray) and g.dtype == w.dtype
                assert np.array_equal(g, w)
            else:
                assert g == w


ROUTE_CASES = {
    # name: (dataset kind, split, loader kwargs)
    "train_shuffled_drop_last": ("3depn", "train", dict(batch_size=4, shuffle=True,
                                                        drop_last=True, seed=5)),
    "val_ragged_tail": ("3depn", "val", dict(batch_size=4, shuffle=False, drop_last=False)),
    "shard_0_of_2": ("3depn", "train", dict(batch_size=4, shuffle=True, drop_last=True,
                                            seed=5, process_shard=(0, 2))),
    "shard_1_of_2": ("3depn", "train", dict(batch_size=4, shuffle=True, drop_last=True,
                                            seed=5, process_shard=(1, 2))),
    "shapenet_int_labels": ("shapenet", "train", dict(batch_size=3, shuffle=True,
                                                      drop_last=False, seed=2)),
}


def _dataset(kind: str, split: str, epn_root, msn_root, **kwargs):
    if kind == "3depn":
        return ShapeNet3DEPNDataset(str(epn_root), split=split, classes=[CHAIR], num_samples=2,
                                    **kwargs)
    return MissingShapeNetDataset(str(msn_root), split=split, num_samples=2, **kwargs)


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_resident_batches_equal_the_host_batches(case, workers, epn_root, msn_root):
    kind, split, kwargs = ROUTE_CASES[case]
    ds = _dataset(kind, split, epn_root, msn_root, cache=True)
    assert ds.items_fixed
    host = BatchLoader(ds, num_workers=workers, **kwargs)
    resident = BatchLoader(ds, num_workers=workers, device="cpu", **kwargs)
    with profile(activities=[ProfilerActivity.CPU]):
        for epoch in range(1, EPOCHS + 1):
            _assert_same_batches(_batches(resident, epoch), _batches(host, epoch))
    assert resident.resident and not host.resident
    got = {k: n for k, (n, _) in profiling.totals().items()}
    assert got["loader.resident"] == EPOCHS
    # the host loader's items and batches, and as many again gathered
    assert got["loader.items"] == 2 * sum(sum(map(len, host._batch_indices(e)))
                                          for e in range(1, EPOCHS + 1))
    assert got["loader.collate"] == 2 * sum(len(host._batch_indices(e))
                                            for e in range(1, EPOCHS + 1))


def test_the_prefix_batches_are_rows_of_one_stack(epn_root):
    ds = _dataset("3depn", "val", epn_root, None, cache=True)
    batches = _batches(BatchLoader(ds, 4, num_workers=0, device="cpu"), 0)
    assert [len(b[0]) for b in batches] == [4, 4, 2]
    for col in (0, 1, 2):
        stack = trainer_mod._stack_of([b[col] for b in batches[:2]])
        assert stack.shape[:2] == (2, 4) and stack.data_ptr() == batches[0][col].data_ptr()
    # rows that are not one stack's are stacked anew
    apart = [batches[1][0], batches[0][0]]
    stacked = trainer_mod._stack_of(apart)
    assert torch.equal(stacked, torch.stack(apart)) and stacked.data_ptr() != apart[1].data_ptr()


class _Mixed:
    """Fixed items whose first column has two shapes."""

    items_fixed = True

    def __len__(self):
        return 6

    def __getitem__(self, i):
        n = 4 if i < 3 else 5
        return np.full((n, 3), i, np.float32), 0, np.zeros((8, 3), np.float32), "cat"


HOST_CASES = ("cache_off", "random_rotation", "mixed_shapes", "no_device", "over_budget")


@pytest.mark.parametrize("case", HOST_CASES)
def test_the_host_route_runs_where_the_corpus_cannot_be_resident(case, epn_root, msn_root,
                                                                 monkeypatch):
    device = "cpu"
    if case == "cache_off":
        ds = _dataset("3depn", "train", epn_root, msn_root, cache=False)
    elif case == "random_rotation":
        ds = _dataset("shapenet", "train", epn_root, msn_root, cache=True,
                      is_random_rotated=True)
    elif case == "mixed_shapes":
        ds = _Mixed()
    else:
        ds = _dataset("3depn", "train", epn_root, msn_root, cache=True)
        if case == "no_device":
            device = None
        else:  # 10 items of 128 fp32 points: 15,360 bytes, over a quarter of 60,000
            monkeypatch.setattr(loader_mod, "_free_bytes", lambda dev: 60_000)
    loader = BatchLoader(ds, 3, num_workers=2, device=device)
    with profile(activities=[ProfilerActivity.CPU]):
        batches = _batches(loader, 0) + _batches(loader, 1)
    assert not loader.resident
    assert isinstance(batches[0][0], np.ndarray)
    got = {k: n for k, (n, _) in profiling.totals().items()}
    assert got.get("loader.resident", 0) == 0 and got["loader.collate"] >= 2


def test_the_budget_admits_a_corpus_within_a_quarter(epn_root, monkeypatch):
    ds = _dataset("3depn", "train", epn_root, None, cache=True)
    monkeypatch.setattr(loader_mod, "_free_bytes", lambda dev: 4 * 15_360)
    loader = BatchLoader(ds, 3, num_workers=0, device="cpu")
    assert torch.is_tensor(_batches(loader, 0)[0][0]) and loader.resident


@pytest.mark.parametrize("kind,split,kwargs,fixed", [
    ("shapenet", "train", dict(cache=True), True),
    ("shapenet", "val", dict(cache=True), True),
    ("shapenet", "test", dict(cache=True), True),
    ("shapenet", "train", dict(cache=False), False),
    ("shapenet", "train", dict(cache=True, is_random_rotated=True), False),
    ("shapenet", "test", dict(cache=True, is_gen=True), False),
    ("3depn", "train", dict(cache=True), True),
    ("3depn", "val", dict(cache=True), True),
    ("3depn", "val", dict(cache=False), False),
    ("3depn", "test", dict(cache=True), False),
])
def test_items_fixed_says_when_an_item_is_a_pure_function_of_its_index(
        epn_root, msn_root, kind, split, kwargs, fixed):
    assert _dataset(kind, split, epn_root, msn_root, **kwargs).items_fixed is fixed


# ---------------------------------------------------------------------------
# the Trainer's trajectory on the resident route


def _run(config) -> dict:
    """Two epochs of ``Trainer.run`` with every train epoch's rows, sample and val result."""
    t = trainer_mod.Trainer(config, device="cpu")
    rec = {"rows": [], "latest": [], "val": []}
    train_epoch, val_epoch = t.train_epoch, t.val_epoch

    def recorded_train(epoch):
        stats, latest = train_epoch(epoch)
        rec["rows"].append(t.last_step_losses.copy())
        rec["latest"].append(latest)
        return stats, latest

    def recorded_val(epoch):
        out = val_epoch(epoch)
        rec["val"].append(out)
        return out

    t.train_epoch, t.val_epoch = recorded_train, recorded_val
    t.run(plot_samples=False)
    rec["params"] = {k: v.detach().clone() for k, v in t.model.state_dict().items()}
    rec["state"] = {name: {k: v.clone() for k, v in t.optimizer.state[p].items()}
                    for name, p in t.model.named_parameters() if p in t.optimizer.state}
    rec["trainer"] = t
    return rec


def _equal(a, b, what: str) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b), what
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b), what
    else:
        assert a == b, what


@pytest.mark.parametrize("mode", ["scan", "step"])
def test_the_resident_trainer_trains_as_the_host_trainer(epn_root, tmp_path, mode):
    runs = {cache: _run(tree_3depn_config(epn_root, tmp_path / str(cache), cache, mode))
            for cache in (True, False)}
    resident, host = runs[True], runs[False]
    for key in ("rows", "latest", "val", "params", "state"):
        _equal(resident[key], host[key], key)
    t_res, t_host = resident["trainer"], host["trainer"]
    assert t_res.train_loader.resident and not t_host.train_loader.resident
    assert all(v.resident for v in t_res.val_loaders.values())
    assert t_res._seed_counter == t_host._seed_counter and t_res.updates == t_host.updates
    assert [r.shape for r in resident["rows"]] == [(2, 3)] * EPOCHS
    scans = (t_res.scan_invocations, t_res.val_scan_invocations)
    assert scans == ((EPOCHS, EPOCHS) if mode == "scan" else (0, 0))
    for latest in resident["latest"]:
        assert all(isinstance(a, np.ndarray) for a in latest)
    for _, samples in resident["val"]:
        assert all(isinstance(a, np.ndarray) for s in samples.values() for a in s)


def test_a_resident_data_parallel_shard_is_the_shard_of_the_host_batches(epn_root):
    """Each rank's rows of the resident corpus are its rows of the host batches."""
    ds = _dataset("3depn", "train", epn_root, None, cache=True)
    kwargs = dict(shuffle=True, drop_last=True, seed=3, num_workers=0)
    whole = _batches(BatchLoader(ds, 4, device="cpu", **kwargs), 2)
    ranks = [_batches(BatchLoader(ds, 4, device="cpu", process_shard=(r, 2), **kwargs), 2)
             for r in range(2)]
    for k, batch in enumerate(whole):
        for col in (0, 1, 2):
            assert torch.equal(torch.cat([ranks[r][k][col] for r in range(2)]), batch[col])
        assert ranks[0][k][3] + ranks[1][k][3] == batch[3]

