"""Port's experiments path (hyperpocket_tpu_torch/eval, data, cli) vs the JAX package.

Both sides get the same numpy clouds, the same weights (``params_from_jax``)
and, through the port's ``draws`` hook, the JAX package's own random draws
(``jax.random.normal(key(s))`` for the latent noise, the ball points under
the second half of ``split(key(s))``). Metric matrices, ``fixed/``
artifacts and per-experiment results are held to the JAX package's: NN
dispatchers and artifacts within 1e-5, metrics and results within 1e-4
(EMD runs 9 rounds of fp32 sums in another order), coverage and 1-NN
accuracies equal, JSD within 1e-12 (the same numpy code). Datasets must give
the same items after the same ``seed_setup``.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from os.path import basename, join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperpocket_tpu.data import base as jbase
from hyperpocket_tpu.eval import evaluation as jevaluation
from hyperpocket_tpu.eval import experiments as jexp
from hyperpocket_tpu.eval import metrics as jmetrics
from hyperpocket_tpu.eval.latent_stats import (
    collect_val_missing_halves as jax_collect_halves,
    fit_latent_gaussian as jax_fit_latent_gaussian,
)
from hyperpocket_tpu.ops import pallas_nn as jnn
from hyperpocket_tpu.ops.sampling import generate_target_network_input_batch as jax_balls
from hyperpocket_tpu.utils.logging_setup import seed_setup as jax_seed_setup
from hyperpocket_tpu_torch import cli
from hyperpocket_tpu_torch.convert import save_jax_npz
from hyperpocket_tpu_torch.data import base as pbase
from hyperpocket_tpu_torch.data.plyio import load_ply, save_ply
from hyperpocket_tpu_torch.eval import evaluation as pevaluation
from hyperpocket_tpu_torch.eval import experiments as pexp
from hyperpocket_tpu_torch.eval import metrics as pmetrics
from hyperpocket_tpu_torch.eval.latent_stats import LatentGaussian, fit_latent_gaussian
from hyperpocket_tpu_torch.ops import nn as pnn
from hyperpocket_tpu_torch.train.config import get_results_dir_path
from hyperpocket_tpu_torch.utils.logging_setup import seed_setup
from tests.test_data import CAT, make_synthetic_shapenet
from tests.test_torch_models import model_pair, tiny_config
from tests.test_train_integration import make_config
from util_scripts.make_synthetic_3depn import CHAIR, make_synthetic_3depn

torch.set_float32_matmul_precision("highest")

ATOL_ART = 1e-5
RTOL_METRIC = 1e-4


def _clouds(b: int, n: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((b, n, 3)) * 0.3).astype(np.float32)


# ---------------------------------------------------------------------------
# dispatchers


@pytest.mark.parametrize("name", ["nn_min_dists", "chamfer_per_cloud_auto",
                                  "directed_hausdorff_auto", "nn_distance_auto"])
def test_dispatchers_match_jax(name):
    a, b = _clouds(2, 128, 0), _clouds(2, 96, 1)
    want = getattr(jnn, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(pnn, name)(torch.tensor(a), torch.tensor(b))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=ATOL_ART, atol=1e-7)


# ---------------------------------------------------------------------------
# metrics on 6 refs and 5 samples of 128 points

REFS, SAMPLES = _clouds(6, 128, 2), _clouds(5, 128, 3)


def test_pairwise_emd_cd_and_emd_cd():
    want = jmetrics.pairwise_emd_cd(SAMPLES, REFS, batch_size=4, row_block=2)
    got = pmetrics.pairwise_emd_cd(SAMPLES, REFS, batch_size=4, row_block=2, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == (5, 6)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL_METRIC)
    want = jmetrics.EMD_CD(SAMPLES, REFS[:5], batch_size=2, reduced=False)
    got = pmetrics.EMD_CD(SAMPLES, REFS[:5], batch_size=2, reduced=False, device="cpu")
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL_METRIC)


@pytest.mark.parametrize("rows", ["shared", "per_object"])
def test_pairwise_emd_cd_multi(rows):
    cols = np.stack([SAMPLES, _clouds(5, 128, 4)])  # G=2 objects, S=5
    row_pcs = REFS if rows == "shared" else np.stack([REFS, _clouds(6, 128, 5)])
    # 60 pairs in blocks of 16: the last block is padded
    want = jmetrics.pairwise_emd_cd_multi(row_pcs, cols, pair_block=16)
    got = pmetrics.pairwise_emd_cd_multi(row_pcs, cols, pair_block=16, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == (2, 6, 5)
        np.testing.assert_allclose(g, w, rtol=RTOL_METRIC)
    # one object through the per-object matrices is that object's own matrix
    single = pmetrics.pairwise_emd_cd(row_pcs[1] if rows == "per_object" else REFS, cols[1],
                                      batch_size=5, device="cpu")
    np.testing.assert_allclose(got[0][1], single[0].numpy(), rtol=1e-6)


def test_pairwise_emd_cd_multi_mesh_is_not_ported():
    """The mesh is ported (tests/test_torch_parallel_serve.py holds it to the
    unsharded call over two ranks); one that needs more ranks than the
    process has raises the JAX package's error."""
    from hyperpocket_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        pmetrics.pairwise_emd_cd_multi(REFS, SAMPLES[None], mesh=make_mesh(2, 1),
                                       device="cpu")


def test_mmd_cov_and_multi():
    m_cd, m_emd = jmetrics.pairwise_emd_cd_multi(REFS, np.stack([SAMPLES, SAMPLES[::-1]]),
                                                 pair_block=64)
    want = jmetrics.mmd_cov_multi(m_cd, m_emd)
    got = pmetrics.mmd_cov_multi(m_cd, m_emd)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k.startswith("cov"):
                assert g[k] == w[k], k
            else:
                assert g[k] == pytest.approx(w[k], rel=RTOL_METRIC), k
    w1 = jmetrics.mmd_cov(jnp.asarray(m_cd[0]).T)
    g1 = pmetrics.mmd_cov(m_cd[0].T)
    assert float(g1["cov(Coverage)"]) == float(w1["cov(Coverage)"])
    for k in ("mmd(Fidelity)", "mmd_smp"):
        assert float(g1[k]) == pytest.approx(float(w1[k]), rel=RTOL_METRIC)
    want_all = jmetrics.compute_all_metrics(SAMPLES, REFS, batch_size=4)
    got_all = pmetrics.compute_all_metrics(SAMPLES, REFS, batch_size=4, device="cpu")
    for k in want_all:
        assert float(got_all[k]) == pytest.approx(float(want_all[k]), rel=RTOL_METRIC), k
    sets = np.stack([SAMPLES, SAMPLES[::-1]])
    want_multi = jmetrics.compute_all_metrics_multi(sets, REFS, pair_block=64)
    got_multi = pmetrics.compute_all_metrics_multi(sets, REFS, pair_block=64, device="cpu")
    for g, w in zip(got_multi, want_multi):
        assert g == pytest.approx(w, rel=RTOL_METRIC)


DEFAULT_DEVICE_CALLS = {
    "EMD_CD": lambda: pmetrics.EMD_CD(SAMPLES, REFS[:5], batch_size=2),
    "pairwise_emd_cd": lambda: pmetrics.pairwise_emd_cd(SAMPLES, REFS, batch_size=4),
    "pairwise_emd_cd_multi": lambda: pmetrics.pairwise_emd_cd_multi(REFS, SAMPLES[None]),
    "compute_all_metrics": lambda: pmetrics.compute_all_metrics(SAMPLES, REFS, batch_size=4),
    "compute_all_metrics_multi": lambda: pmetrics.compute_all_metrics_multi(SAMPLES[None], REFS),
    "minimum_matching_distance": lambda: pevaluation.minimum_matching_distance(SAMPLES, REFS, 4),
    "uhd_process": lambda: pevaluation.uhd_process("no_such_dir"),
    "tmd_process": lambda: pevaluation.tmd_process("no_such_dir"),
    "compute_trimesh_chamfer": lambda: pevaluation.compute_trimesh_chamfer(REFS[0], SAMPLES[0]),
    "ExperimentContext": lambda: pexp.ExperimentContext(None, epoch=1),
    "run_experiments": lambda: pexp.run_experiments({}, "no_such_dir"),
    "fit_latent_gaussian": lambda: fit_latent_gaussian(None, SAMPLES),
}


@pytest.mark.parametrize("name", list(DEFAULT_DEVICE_CALLS))
def test_eval_entry_points_default_to_the_card(name):
    """Without a device, numpy inputs go to CUDA; on a host without it the call raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA, so the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEFAULT_DEVICE_CALLS[name]()


def test_metrics_keep_a_tensor_on_its_device():
    got = pmetrics.pairwise_emd_cd(torch.tensor(SAMPLES), torch.tensor(REFS), batch_size=4)
    want = pmetrics.pairwise_emd_cd(SAMPLES, REFS, batch_size=4, device="cpu")
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and torch.equal(g, w)


@pytest.mark.parametrize("k,sqrt", [(1, False), (3, True)])
def test_knn_matches_jax(k, sqrt):
    rng = np.random.default_rng(6)
    mxx, mxy, myy = (rng.uniform(0, 1, s).astype(np.float32) for s in ((6, 6), (6, 5), (5, 5)))
    want = jmetrics.knn(mxx, mxy, myy, k, sqrt=sqrt)
    got = pmetrics.knn(mxx, mxy, myy, k, sqrt=sqrt)
    assert set(got) == set(want)
    for key in want:
        assert float(got[key]) == pytest.approx(float(want[key]), abs=1e-6), key
    batch_want = jmetrics.knn_batch_1nna(mxx, np.stack([mxy, mxy[::-1]]), np.stack([myy, myy]))
    batch_got = pmetrics.knn_batch_1nna(mxx, np.stack([mxy, mxy[::-1]]), np.stack([myy, myy]))
    for key in batch_want:
        np.testing.assert_allclose(batch_got[key].numpy(), np.asarray(batch_want[key]), atol=1e-6)


def test_trimesh_chamfer_and_prior_sampling():
    a, b = _clouds(1, 128, 16)[0], _clouds(1, 96, 17)[0]
    want = jevaluation.compute_trimesh_chamfer(a, b, offset=0.1, scale=2.0)
    got = pevaluation.compute_trimesh_chamfer(a, b, offset=0.1, scale=2.0, device="cpu")
    assert got == pytest.approx(want, rel=ATOL_ART)
    prior = LatentGaussian(np.float32([1.0, -2.0]), np.float32([[0.5, 0.0], [0.2, 0.1]]))
    draws = prior.sample(torch.Generator().manual_seed(0), 20000)
    assert draws.shape == (20000, 2)
    np.testing.assert_allclose(draws.mean(0).numpy(), prior.mean, atol=0.02)
    np.testing.assert_allclose(np.cov(draws.numpy().T), prior.scale_tril @ prior.scale_tril.T,
                               atol=0.01)


def test_batch_loader_matches_jax():
    from hyperpocket_tpu.data.loader import BatchLoader as JaxLoader
    from hyperpocket_tpu_torch.data.loader import BatchLoader

    items = [(np.full((4, 3), i, np.float32), 0, np.full((8, 3), -i, np.float32), f"m{i}")
             for i in range(11)]
    for kwargs in ({"shuffle": True, "seed": 3}, {"drop_last": True}, {"num_workers": 0}):
        want = list(JaxLoader(items, 4, **kwargs).epoch(2))
        got = list(BatchLoader(items, 4, **kwargs).epoch(2))
        assert len(got) == len(want) == len(BatchLoader(items, 4, **kwargs))
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jsd_matches_jax():
    a, b = _clouds(5, 128, 7) * 0.5, _clouds(6, 128, 8) * 0.5
    want = jmetrics.jsd_between_point_cloud_sets(a, b)
    assert pmetrics.jsd_between_point_cloud_sets(a, b) == pytest.approx(want, abs=1e-12)
    grid = pmetrics.entropy_of_occupancy_grid(b, 28, True)[1]
    assert pmetrics.jsd_between_point_cloud_sets(a, ref_grid=grid) == pytest.approx(want,
                                                                                   abs=1e-12)


# ---------------------------------------------------------------------------
# datasets


def _items(ds) -> list:
    return [ds[i] for i in range(len(ds))]


def _assert_same_items(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def _same_datasets(cfg: dict, seed: int = 5):
    jax_seed_setup(seed)
    j_train, j_val, j_test = jbase.get_datasets(cfg)
    want = [_items(j_train)] + [_items(d) for d in (*j_val.values(), *j_test.values())]
    seed_setup(seed)
    p_train, p_val, p_test = pbase.get_datasets(cfg)
    assert list(p_val) == list(j_val) and list(p_test) == list(j_test)
    got = [_items(p_train)] + [_items(d) for d in (*p_val.values(), *p_test.values())]
    for g, w in zip(got, want):
        _assert_same_items(g, w)
    return p_test


def _write_test_gen(root, rng):
    for side in ("left", "right", "gt"):
        os.makedirs(join(root, "test_gen", side, CAT), exist_ok=True)
    gt = rng.standard_normal((2048, 3)).astype(np.float32)
    order = gt[:, 1].argsort()
    save_ply(join(root, "test_gen", "left", CAT, "model005.ply"), gt[order[:900]])
    save_ply(join(root, "test_gen", "right", CAT, "model005.ply"), gt[order[900:]])
    save_ply(join(root, "test_gen", "gt", CAT, "model005.ply"), gt)


@pytest.mark.parametrize("gen", [False, True])
def test_shapenet_datasets_match_jax(tmp_path, gen):
    make_synthetic_shapenet(tmp_path, n_models=6, num_samples=2)
    _write_test_gen(tmp_path, np.random.default_rng(11))
    cfg = {"name": "shapenet", "path": str(tmp_path), "classes": ["airplane"],
           "is_rotated": True, "num_samples": 2, "gen_test_set": gen}
    test = _same_datasets(cfg)
    existing, missing, gt, _ = test["airplane"][0]
    if gen:  # resampled from 1148 and 900 points with numpy's global RNG
        assert existing.shape == missing.shape == (1024, 3) and gt.shape == (2048, 3)


def _make_3depn(root, n_models: int = 5) -> list[str]:
    """Synthetic raw 3D-EPN tree; the last 3 models are test, the rest train, sliced."""
    make_synthetic_3depn(str(root), {CHAIR: n_models}, seed=0)
    names = [f"syn{CHAIR[-3:]}_{i:04d}" for i in range(n_models)]
    with open(join(root, "shapenet-official-split.csv"), "w") as fh:
        fh.write("id,synsetId,modelId,split\n")
        for i, name in enumerate(names):
            fh.write(f"{i},{CHAIR},{name},{'test' if i >= n_models - 3 else 'train'}\n")
    rng = np.random.default_rng(1)
    for name in names[:n_models - 3]:
        gt = load_ply(join(root, "ShapeNetPointCloud", CHAIR, name + ".ply"))[:2048]
        for kind in ("gt", "existing", "missing"):
            os.makedirs(join(root, "slices", kind, CHAIR), exist_ok=True)
        save_ply(join(root, "slices", "gt", CHAIR, name + ".ply"), gt)
        for k in range(2):
            order = np.argsort(gt @ rng.standard_normal(3))
            save_ply(join(root, "slices", "existing", CHAIR, f"{k}~{name}.ply"), gt[order[1024:]])
            save_ply(join(root, "slices", "missing", CHAIR, f"{k}~{name}.ply"), gt[order[:1024]])
    return names


@pytest.mark.parametrize("fmt", ["binary_little_endian", "binary_big_endian", "ascii"])
def test_load_ply_reads_mesh_vertices(tmp_path, fmt):
    """3D-EPN's mesh files: a vertex element with extra properties, faces after it."""
    from hyperpocket_tpu.data.plyio import ListProperty, save_ply_elements
    from hyperpocket_tpu.data.plyio import load_ply as jax_load_ply

    v = _clouds(1, 50, 14)[0]
    normals = _clouds(1, 50, 15)[0]
    faces = ListProperty([[0, 1, 2], [2, 3, 4, 5], [6, 7, 8]], "uchar", "int")
    path = str(tmp_path / "mesh.ply")
    save_ply_elements(path, [
        ("vertex", [("x", v[:, 0]), ("y", v[:, 1]), ("z", v[:, 2]), ("nx", normals[:, 0]),
                    ("ny", normals[:, 1]), ("nz", normals[:, 2])]),
        ("face", [("vertex_indices", faces)]),
    ], fmt=fmt)
    got = load_ply(path)
    np.testing.assert_array_equal(got, v)
    np.testing.assert_array_equal(got, jax_load_ply(path))


def test_3depn_datasets_match_jax(tmp_path):
    _make_3depn(tmp_path)
    cfg = {"name": "3depn", "path": str(tmp_path), "classes": [CHAIR], "num_samples": 2}
    test = _same_datasets(cfg)
    raw, placeholder, real, name = test["chair"][0]
    assert raw.shape == (1024, 3) and real.shape == (2048, 3) and placeholder == 0
    # Completion3D: one train, val and test model, the same items as the JAX package's
    import h5py

    c3d = tmp_path / "completion"
    for split, kinds in (("train", ("partial", "gt")), ("val", ("partial", "gt")),
                         ("test", ("partial",))):
        os.makedirs(c3d / split, exist_ok=True)
        (c3d / f"{split}.list").write_text(f"{CHAIR}/m_{split}\n")
        for kind in kinds:
            os.makedirs(c3d / split / kind / CHAIR, exist_ok=True)
            with h5py.File(c3d / split / kind / CHAIR / f"m_{split}.h5", "w") as fh:
                fh.create_dataset("data", data=_clouds(1, 64, 16)[0])
    test = _same_datasets({"name": "completion", "path": str(c3d)})
    existing, placeholder, gt, name = test["all"][0]
    assert existing.shape == (64, 3) and placeholder == 0 and name == f"{CHAIR}/m_test"
    np.testing.assert_array_equal(gt, existing)


# ---------------------------------------------------------------------------
# experiments


class JaxDraws:
    """The JAX package's draws for a counter value, through the port's hook."""

    def __init__(self, jmodel):
        self.jmodel = jmodel

    def noise(self, seed, batch, mean, std, source):
        """The JAX context's ``_noise`` ("normal") and ``_noise_prior`` ("empirical")."""
        eps = jax.random.normal(jax.random.key(jnp.uint32(seed)),
                                (batch, self.jmodel.get_noise_size()))
        if source == "empirical":
            return torch.tensor(np.asarray(jnp.asarray(mean) + eps @ jnp.asarray(std).T))
        return torch.tensor(np.asarray(mean + std * eps))

    def balls(self, seed, batch, num_points, epoch):
        _, k_pts = jax.random.split(jax.random.key(jnp.uint32(seed)))
        pts = jax_balls(self.jmodel.target_network_input, k_pts, jnp.asarray(epoch), batch,
                        num_points, method=self.jmodel.ball_method)
        return torch.tensor(np.asarray(pts))


@pytest.fixture(scope="module")
def models():
    jmodel, params, port = model_pair(tiny_config(), seed=3)
    return jmodel, params, port.eval()


def _contexts(models, seed: int = 7):
    jmodel, params, port = models
    return (jexp.ExperimentContext(jmodel, params, epoch=5, seed=seed),
            pexp.ExperimentContext(port, epoch=5, seed=seed, device="cpu",
                                   draws=JaxDraws(jmodel)))


def _objects(n_obj: int, n_missing: int, seed: int) -> list[tuple]:
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((64, 3)) * 0.3).astype(np.float32),
             (rng.standard_normal((n_missing, 3)) * 0.3).astype(np.float32),
             (rng.standard_normal((128, 3)) * 0.3).astype(np.float32), "chair")
            for _ in range(n_obj)]


def test_draws_hook_reproduces_jax(models):
    jctx, pctx = _contexts(models)
    existing = _clouds(3, 64, 9)
    for _ in range(2):  # the counters advance together
        noise = jctx.sample_noise(3, 0.0, 0.13)
        np.testing.assert_allclose(pctx.sample_noise(3, 0.0, 0.13), noise, atol=1e-7)
        np.testing.assert_allclose(pctx.complete(existing, noise, num_points=96),
                                   jctx.complete(existing, noise, num_points=96), atol=ATOL_ART)
    missing = _clouds(3, 64, 10)
    np.testing.assert_allclose(pctx.complete_from_missing(existing, missing, num_points=32),
                               jctx.complete_from_missing(existing, missing, num_points=32),
                               atol=ATOL_ART)
    with pytest.raises(ValueError, match="fit_latent_prior"):
        pctx.sample_noise(2, 0.0, 0.1, source="empirical")
    # the empirical draw: the same fitted prior in both contexts
    jmodel, params, _ = models
    jctx.latent_prior = jax_fit_latent_gaussian(jmodel, params, _clouds(6, 64, 11), batch_size=4)
    pctx.latent_prior = LatentGaussian(jctx.latent_prior.mean, jctx.latent_prior.scale_tril)
    np.testing.assert_allclose(pctx.sample_noise(3, 0.0, 0.0, source="empirical"),
                               jctx.sample_noise(3, 0.0, 0.0, source="empirical"), atol=1e-6)


def test_fixed_and_mmd_tmd_uhd_match_jax(models, tmp_path):
    datasets = {"chair": _objects(3, 64, 12)}
    kwargs = dict(noises_per_item=3, batch_size=2, std=0.13, num_points=128)
    out = {}
    for tag, ctx, mod in zip(("jax", "port"), _contexts(models), (jexp, pexp)):
        mod.fixed(ctx, datasets, str(tmp_path / tag), 5, **kwargs)
        out[tag] = mod.compute_mmd_tmd_uhd(ctx, datasets, str(tmp_path / tag), 5, batch_size=4)
    files = sorted(glob.glob(str(tmp_path / "jax" / "fixed" / "*.npy")))
    assert len(files) == 3 * 3 + 3
    assert [basename(f) for f in files] == sorted(
        basename(f) for f in glob.glob(str(tmp_path / "port" / "fixed" / "*.npy")))
    for f in files:
        want = np.load(f)
        got = np.load(str(tmp_path / "port" / "fixed" / basename(f)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL_ART)
    for tag in ("jax", "port"):
        with open(tmp_path / tag / "compute_mmd_tmd_uhd" / "5res.json") as fh:
            assert json.load(fh) == pytest.approx(out[tag])
    assert out["port"] == pytest.approx(out["jax"], rel=RTOL_METRIC)
    assert set(out["port"]) == {"MMD * 1000", "UHD * 100", "TMD * 100"}


def test_evaluate_generativity_matches_jax(models, tmp_path):
    # 1024-point missing halves: EMD pairs them with the completions' 1024
    # lowest-y points, as on the real datasets
    datasets = {"chair": _objects(2, 1024, 13)}
    kwargs = dict(batch_size=2, std=0.05, dispatch_clouds=4, include_1nna=True)
    res = {}
    for tag, ctx, mod in zip(("jax", "port"), _contexts(models, seed=21), (jexp, pexp)):
        mod.evaluate_generativity(ctx, datasets, str(tmp_path / tag), 5, **kwargs)
        with open(tmp_path / tag / "evaluate_generativity" / "5eval_gen_by_cat.json") as fh:
            res[tag] = json.load(fh)["chair"]
    assert set(res["port"]) == set(res["jax"])
    assert any(k.startswith("1-NN-EMD") for k in res["port"])
    for k, want in res["jax"].items():
        if k.startswith(("cov", "1-NN")):
            assert res["port"][k] == want, k
        else:
            assert res["port"][k] == pytest.approx(want, rel=RTOL_METRIC), k
    with pytest.raises(ValueError, match="evaluate_generativity.parallel_data=2"):
        pexp.evaluate_generativity(_contexts(models)[1], datasets, str(tmp_path), 5,
                                   parallel_data=2)


@pytest.fixture
def root_logging():
    """Give back the handlers and levels that ``logging_setup`` replaces."""
    root = logging.getLogger()
    handlers = root.handlers[:]
    levels = {name: logging.getLogger(name).level for name in ("", "torch", "urllib3")}
    yield
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:] = handlers
    for name, level in levels.items():
        logging.getLogger(name).setLevel(level)


def test_cli_runs_experiments_with_latent_prior(models, tmp_path, root_logging, monkeypatch):
    """``cli.main`` in experiments mode, the config's latent prior fitted on val halves;
    in training mode it hands the config's Telegram logger to ``Trainer.run``."""
    jmodel, params, port = models
    root, results = tmp_path / "data", tmp_path / "results"
    make_synthetic_shapenet(root, n_models=6, n_gt=64, n_part=32)
    config = make_config(root, results, max_epoch=1)
    config["full_model"] = tiny_config()
    config["mode"] = "experiments"
    config["experiments"] = {
        "epoch": "best_val",
        "latent_prior": {"max_items": 8, "batch_size": 4},
        "settings": {
            "fixed": {"execute": True, "std": 0.05, "noises_per_item": 4, "batch_size": 2,
                      "num_points": 64, "noise_source": "empirical"},
            "compute_mmd_tmd_uhd": {"execute": True, "batch_size": 4},
            "evaluate_generativity": {"execute": False},
            "temp_exp": {"execute": True},
        },
    }
    training = get_results_dir_path(config, "training")
    os.makedirs(join(training, "weights"))
    os.makedirs(join(training, "metrics"))
    save_jax_npz(join(training, "weights", "00002_model.npz"), port)
    np.save(join(training, "metrics", "00002_val.npy"), np.array([[3.0], [2.0]]))

    ctx = cli.main(config, device="cpu")
    result_dir = get_results_dir_path(config, "experiments")
    assert ctx.epoch == 2
    recs = sorted(glob.glob(join(result_dir, "fixed", "*_reconstruction.npy")))
    assert len(recs) == 4 and np.load(recs[0]).shape == (3, 64)
    with open(join(result_dir, "compute_mmd_tmd_uhd", "2res.json")) as fh:
        res = json.load(fh)
    assert set(res) == {"MMD * 1000", "UHD * 100", "TMD * 100"}
    assert all(np.isfinite(v) for v in res.values())
    assert os.path.exists(join(result_dir, "log.txt"))
    assert {"fixed_s", "compute_mmd_tmd_uhd_s", "temp_exp_s"} <= set(ctx.timings)

    # the prior is the JAX package's fit on the same halves and weights
    _, val, _ = jbase.get_datasets(config["dataset"])
    want = jax_fit_latent_gaussian(jmodel, params, jax_collect_halves(val, 8), batch_size=4)
    assert isinstance(ctx.latent_prior, LatentGaussian)
    np.testing.assert_allclose(ctx.latent_prior.mean, want.mean, rtol=RTOL_METRIC, atol=1e-6)
    np.testing.assert_allclose(ctx.latent_prior.scale_tril, want.scale_tril, rtol=RTOL_METRIC,
                               atol=1e-6)

    from hyperpocket_tpu_torch.train import trainer as ptrainer
    from hyperpocket_tpu_torch.utils.telegram import TelegramLogger

    runs = []

    class Recorder(ptrainer.Trainer):
        def run(self, **kwargs):
            runs.append(kwargs)

    monkeypatch.setattr(ptrainer, "Trainer", Recorder)
    monkeypatch.setattr(TelegramLogger, "_instance", None)
    cli.main({**config, "mode": "training",
              "telegram_logger": {"enable": True, "bot_token": "t", "chat_id": "c"}},
             device="cpu")
    assert isinstance(runs[0]["tg_logger"], TelegramLogger)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(config)


def test_unported_parts_raise(models, tmp_path, monkeypatch):
    """The parts an earlier port left out now run as the JAX package's:
    ``fixed(save_plots=True)`` writes the JAX package's file set, pngs
    included, and ``make_tsne_reduction`` hands t-SNE the JAX package's
    latents and target-network weights (a recording stand-in for
    scikit-learn's TSNE, whose optimisation is not what is compared)."""
    names = {}
    for tag, ctx, mod in zip(("jax", "port"), _contexts(models), (jexp, pexp)):
        mod.fixed(ctx, {"chair": _objects(2, 64, 1)}, str(tmp_path / tag), 1, batch_size=2,
                  noises_per_item=1, num_points=64, save_plots=True)
        names[tag] = sorted(os.listdir(tmp_path / tag / "fixed"))
    assert names["port"] == names["jax"] and any(n.endswith(".png") for n in names["port"])

    from sklearn import manifold

    seen = {"jax": [], "port": []}

    class RecordingTSNE:
        def __init__(self, **kwargs):
            self.kwargs = kwargs

        def fit_transform(self, x):
            seen[tag].append((np.asarray(x, np.float64), self.kwargs))
            return np.asarray(x, np.float64)[:, :2]

    monkeypatch.setattr(manifold, "TSNE", RecordingTSNE)
    clouds = {"chair": _objects(4, 64, 2)}
    for tag, ctx, mod in zip(("jax", "port"), _contexts(models), (jexp, pexp)):
        mod.make_tsne_reduction(ctx, clouds, str(tmp_path / tag), 1, amount=3)
    assert len(seen["port"]) == len(seen["jax"]) == 2  # latents, then target weights
    for (got, got_kw), (want, want_kw) in zip(seen["port"], seen["jax"]):
        assert got.shape == want.shape and got.shape[0] == 6 and got_kw == want_kw
        np.testing.assert_allclose(got, want, rtol=RTOL_METRIC, atol=1e-5)
    for f in ("latent_tsne", "tnw_tsne", "latent_dist", "tnw_dist"):
        np.testing.assert_allclose(np.load(tmp_path / "port" / "temp_exp" / f"chair_{f}.npy"),
                                   np.load(tmp_path / "jax" / "temp_exp" / f"chair_{f}.npy"),
                                   rtol=RTOL_METRIC, atol=1e-5)
    with pytest.raises(FileNotFoundError, match="'fixed' experiment must run first"):
        pexp.compute_mmd_tmd_uhd(_contexts(models)[1], {"chair": []}, str(tmp_path), 1)
    assert set(pexp.experiment_functions_dict) == set(jexp.experiment_functions_dict)
