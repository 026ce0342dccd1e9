"""Port's Completion3D, real-scan and PLY-element readers vs the JAX package, and
``config_completion.json`` (HyperRec on Completion3D) through the port's CLI.

The datasets must give the JAX package's items on the same files after the
same numpy seed; PLY elements must be written byte for byte as the JAX
writer writes them and read back as the JAX reader reads them;
``completion3d_submission``'s h5 files must hold the JAX experiment's
completions within 1e-5 when both get the JAX package's draws.
"""

from __future__ import annotations

import glob
import json
import os
from os.path import basename, join
from zipfile import ZipFile

import h5py
import numpy as np
import pytest
import torch

from hyperpocket_tpu.data import base as jbase
from hyperpocket_tpu.data import plyio as jax_plyio
from hyperpocket_tpu.data.real_data import RealDataNPYDataset as JaxRealData
from hyperpocket_tpu.eval import experiments as jexp
from hyperpocket_tpu_torch import cli
from hyperpocket_tpu_torch import data as pdata
from hyperpocket_tpu_torch.data import base as pbase
from hyperpocket_tpu_torch.data import plyio
from hyperpocket_tpu_torch.data.completion3d import Completion3DDataset
from hyperpocket_tpu_torch.data.real_data import RealDataNPYDataset
from hyperpocket_tpu_torch.eval import experiments as pexp
from hyperpocket_tpu_torch.models.full_model import MODE_HYPER_REC
from hyperpocket_tpu_torch.train.config import get_results_dir_path
from tests.test_torch_eval import JaxDraws, root_logging  # noqa: F401  (fixture)
from tests.test_torch_models import model_pair, tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AIRPLANE, CHAIR, TABLE = "02691156", "03001627", "04379243"
ATOL_ART = 1e-5


def make_completion3d(root, n_points: int = 64, seed: int = 0) -> dict[str, list[str]]:
    """A Completion3D tree: ``<split>.list`` and ``<split>/{partial,gt}/<cat>/<id>.h5``
    (the test split has no gt), two categories in train and val and one more
    in val only; clouds of ``n_points`` points."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    lists = {"train": [f"{c}/{c}_t{i}" for c in (AIRPLANE, CHAIR) for i in range(3)],
             "val": [f"{c}/{c}_v{i}" for c in (AIRPLANE, CHAIR, TABLE) for i in range(2)],
             "test": [f"all/test{i}" for i in range(5)]}
    for split, names in lists.items():
        with open(join(root, f"{split}.list"), "w") as fh:
            fh.write("\n".join(names) + "\n\n")
        for name in names:
            for kind in ("partial", "gt") if split != "test" else ("partial",):
                path = join(root, split, kind, name + ".h5")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with h5py.File(path, "w") as fh:
                    fh.create_dataset("data", data=rng.standard_normal((n_points, 3)) * 0.3)
    return lists


def _same_items(got, want) -> None:
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert len(g) == len(w) == 4
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


@pytest.mark.parametrize("classes", [[], [CHAIR], ["chair", "airplane"]])
def test_completion3d_matches_jax(tmp_path, classes):
    lists = make_completion3d(tmp_path)
    cfg = {"name": "completion", "path": str(tmp_path), "classes": classes}
    train, val, test = pbase.get_datasets(cfg)
    jtrain, jval, jtest = jbase.get_datasets(cfg)
    assert isinstance(train, Completion3DDataset)
    assert train.model_list == jtrain.model_list
    _same_items(train, jtrain)
    assert list(val) == list(jval)
    for cat in jval:
        assert val[cat].model_list == jval[cat].model_list
        _same_items(val[cat], jval[cat])
    assert list(test) == list(jtest) == ["all"]
    _same_items(test["all"], jtest["all"])
    existing, missing, gt, name = test["all"][0]
    np.testing.assert_array_equal(gt, existing)  # no gt in the test split
    assert missing == 0 and name == lists["test"][0]
    if not classes:  # the default eight val classes, empty ones included
        assert len(val) == 8 and len(val["table"]) == 2 and len(val["car"]) == 0
    else:
        assert len(train) == 3 * len(classes)
    with pytest.raises(ValueError, match="unknown dataset class"):
        Completion3DDataset(str(tmp_path), classes=["spaceship"])


def test_real_data_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    for i in range(3):
        np.save(tmp_path / f"object_{i}.npy", rng.normal(size=(700 + 300 * i, 3)) * 2.0 + i)
        np.save(tmp_path / f"object_box_{i}.npy", rng.normal(size=(8, 3)))
        np.save(tmp_path / f"scene_{i}.npy", rng.normal(size=(500, 3)) * 5.0)
    got, want = RealDataNPYDataset(str(tmp_path)), JaxRealData(str(tmp_path))
    assert (got.objs, got.boxes, got.scenes) == (want.objs, want.boxes, want.scenes)
    assert len(got) == len(want) == 3
    np.random.seed(4)  # both resample with numpy's global RNG
    jitems = [want[i] for i in range(3)]
    np.random.seed(4)
    _same_items([got[i] for i in range(3)], jitems)
    assert got[0][0].shape == (1024, 3) and np.abs(got[0][0]).max() <= 0.45 + 1e-6
    scaled = rng.normal(size=(2048, 3)).astype(np.float32) * 0.3
    for i in range(3):
        for name in ("get_full_object", "get_scene", "get_obj_box"):
            np.testing.assert_array_equal(getattr(got, name)(i), getattr(want, name)(i))
        np.testing.assert_array_equal(got.inverse_scale(i, scaled), want.inverse_scale(i, scaled))
        np.testing.assert_array_equal(got.inverse_scale_to_scene(i, scaled),
                                      want.inverse_scale_to_scene(i, scaled))
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    c, s = RealDataNPYDataset._get_scales(pts)
    jc, js = JaxRealData._get_scales(pts)
    np.testing.assert_array_equal(c, jc)
    assert s == js
    objects_only = tmp_path / "objects"
    objects_only.mkdir()
    np.save(objects_only / "object_0.npy", pts)
    bare = RealDataNPYDataset(str(objects_only))
    with pytest.raises(ValueError, match="scenes"):
        bare.get_scene(0)
    with pytest.raises(ValueError, match="object boxes"):
        bare.get_obj_box(0)


def _elements(rng, lib):
    """Every scalar type, lists of several count/value types, a face element and
    an element with no rows, built with ``lib``'s ``ListProperty``."""
    n = 7
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    vertex = [("x", pts[:, 0]), ("y", pts[:, 1]), ("z", pts[:, 2]),
              ("nx", rng.normal(size=n)), ("red", rng.integers(0, 255, n).astype(np.uint8)),
              ("c", rng.integers(-128, 127, n).astype(np.int8)),
              ("s", rng.integers(-999, 999, n).astype(np.int16)),
              ("us", rng.integers(0, 60000, n).astype(np.uint16)),
              ("i", rng.integers(-10**6, 10**6, n).astype(np.int32)),
              ("u", rng.integers(0, 10**9, n).astype(np.uint32))]
    listed = [("tags", lib.ListProperty([list(range(k)) for k in range(n)], "ushort", "short")),
              ("w", lib.ListProperty([rng.normal(size=k % 3) for k in range(n)], "uchar",
                                     "double"))]
    faces = ("face", [("vertex_indices", lib.ListProperty(
        [[0, 1, 2], [2, 3, 4, 5], [], [6, 0, 1]], "uchar", "int")), ("flag", np.arange(4, dtype=np.uint8))])
    return [("camera", [("k", np.arange(2, dtype=np.float32))]), faces,
            ("vertex", vertex + listed), ("empty", [("e", np.zeros(0, np.int32))])]


def _same_elements(got, want) -> None:
    assert [name for name, _ in got] == [name for name, _ in want]
    for (_, gprops), (_, wprops) in zip(got, want):
        assert [p for p, _ in gprops] == [p for p, _ in wprops]
        for (_, g), (_, w) in zip(gprops, wprops):
            if isinstance(w, jax_plyio.ListProperty):
                assert isinstance(g, plyio.ListProperty)
                assert (g.count_type, g.value_type) == (w.count_type, w.value_type)
                assert len(g.rows) == len(w.rows)
                for a, b in zip(g.rows, w.rows):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
            else:
                assert g.dtype == w.dtype and g.dtype.isnative
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fmt", ["binary_little_endian", "binary_big_endian", "ascii"])
def test_ply_elements_match_jax(tmp_path, fmt):
    mine, theirs = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    comments = ("made by a test", "two comments")
    plyio.save_ply_elements(mine, _elements(np.random.default_rng(2), plyio), fmt=fmt,
                            comments=comments)
    jax_plyio.save_ply_elements(theirs, _elements(np.random.default_rng(2), jax_plyio),
                                fmt=fmt, comments=comments)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got = plyio.load_ply_elements(theirs)
    _same_elements(got, jax_plyio.load_ply_elements(theirs))
    np.testing.assert_array_equal(plyio.load_ply(mine), jax_plyio._load_ply_numpy(mine))
    # a round trip through the port's own writer
    again = str(tmp_path / "again.ply")
    plyio.save_ply_elements(again, got, fmt=fmt, comments=comments)
    with open(again, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_ply_elements_refusals(tmp_path):
    with pytest.raises(ValueError, match="overflows"):
        plyio.ListProperty([list(range(300))], "uchar", "int")
    with pytest.raises(ValueError, match="unknown PLY type"):
        plyio.ListProperty([[1]], "uchar", "int128")
    with pytest.raises(ValueError, match="lengths differ"):
        plyio.save_ply_elements(str(tmp_path / "a.ply"),
                                [("v", [("x", np.zeros(2)), ("y", np.zeros(3))])])
    with pytest.raises(ValueError, match="unsupported PLY format"):
        plyio.save_ply_elements(str(tmp_path / "a.ply"), [], fmt="binary")
    with pytest.raises(ValueError, match="no PLY scalar type"):
        plyio.save_ply_elements(str(tmp_path / "a.ply"), [("v", [("x", np.zeros(2, np.int64))])])
    path = tmp_path / "cut.ply"
    plyio.save_ply_elements(str(path), _elements(np.random.default_rng(3), plyio))
    path.write_bytes(path.read_bytes()[:-40])
    with pytest.raises(plyio.PlyParseError, match="truncated"):
        plyio.load_ply_elements(str(path))
    assert plyio.ListProperty([[1, 2]]) == plyio.ListProperty([[1, 2]])
    assert plyio.ListProperty([[1, 2]]) != plyio.ListProperty([[1, 2]], "uint", "int")


def test_data_package_exports_the_jax_names():
    import hyperpocket_tpu.data as jdata

    ported = set(jdata.__all__) - {"Dataset"}  # the typing Protocol is not ported
    assert set(pdata.__all__) == ported
    assert all(hasattr(pdata, name) for name in ported)


def test_completion3d_submission_matches_jax(tmp_path):
    """The h5 files and the zip of the submission experiment, both packages fed
    the JAX package's draws, on a HyperRec model."""
    make_completion3d(tmp_path / "data", n_points=64)
    jmodel, params, port = model_pair(tiny_config(MODE_HYPER_REC), seed=6)
    datasets = jbase.get_datasets({"name": "completion", "path": str(tmp_path / "data")})[2]
    pdatasets = pbase.get_datasets({"name": "completion", "path": str(tmp_path / "data")})[2]
    jctx = jexp.ExperimentContext(jmodel, params, epoch=5, seed=3)
    pctx = pexp.ExperimentContext(port.eval(), epoch=5, seed=3, device="cpu",
                                  draws=JaxDraws(jmodel))
    jexp.completion3d_submission(jctx, datasets, str(tmp_path / "jax"), 5, batch_size=2)
    pexp.completion3d_submission(pctx, pdatasets, str(tmp_path / "port"), 5, batch_size=2)
    files = sorted(glob.glob(str(tmp_path / "jax" / "completion3d_submission" / "*.h5")))
    assert [basename(f) for f in files] == [f"test{i}.h5" for i in range(5)]
    for f in files:
        with h5py.File(f) as want, h5py.File(
                tmp_path / "port" / "completion3d_submission" / basename(f)) as got:
            assert got["data"].shape == want["data"].shape == (2048, 3)
            np.testing.assert_allclose(got["data"][()], want["data"][()], atol=ATOL_ART)
    with ZipFile(tmp_path / "port" / "submission.zip") as a, \
            ZipFile(tmp_path / "jax" / "submission.zip") as b:
        assert a.namelist() == b.namelist() == [f"all/test{i}.h5" for i in range(5)]


def test_config_completion_through_the_cli(tmp_path, root_logging):  # noqa: F811
    """``settings/config_completion.json``, its model unchanged, through
    ``cli.main``: one training epoch on a synthetic Completion3D tree (the
    Trainer drops the scalar ``missing``), saved, then experiments mode's
    ``completion3d_submission`` from that checkpoint."""
    make_completion3d(tmp_path / "data", n_points=64)
    with open(join(REPO, "settings", "config_completion.json")) as fh:
        config = json.load(fh)
    config["dataset"]["path"] = str(tmp_path / "data")
    config["results_root"] = str(tmp_path / "results")
    tr = config["training"]
    tr.update(max_epoch=1, min_save_epoch=0)
    tr["dataloader"]["train"].update(batch_size=2, num_workers=1)
    tr["dataloader"]["val"].update(batch_size=2, num_workers=1)
    trainer = cli.main(config, device="cpu")
    assert trainer.model.mode == MODE_HYPER_REC
    assert len(trainer.train_losses) == 1 and np.isfinite(trainer.train_losses[0]).all()
    assert np.isfinite(trainer.val_losses[0]).all()
    assert len(trainer.last_step_losses) == 3  # 6 train items at batch 2
    weights = get_results_dir_path(config, "training")
    assert os.path.exists(join(weights, "weights", "00001_model.npz"))

    config["mode"] = "experiments"
    config["experiments"]["settings"]["completion3d_submission"]["batch_size"] = 2
    ctx = cli.main(config, device="cpu")
    assert ctx.epoch == 1
    out = get_results_dir_path(config, "experiments")
    h5s = sorted(glob.glob(join(out, "completion3d_submission", "*.h5")))
    assert len(h5s) == 5
    with h5py.File(h5s[0]) as fh:
        rec = fh["data"][()]
    assert rec.shape == (2048, 3) and np.isfinite(rec).all()
    with ZipFile(join(out, "submission.zip")) as zf:
        assert len(zf.namelist()) == 5
    assert torch.get_default_dtype() == torch.float32
