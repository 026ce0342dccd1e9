"""The port's last utilities vs the JAX package, and its subpackages' exports.

* ``utils/augment.py`` and ``utils/sphere_triangles.py``: the cases of
  tests/test_utils.py, and the same arrays as the JAX package's for the
  same seeds.
* ``utils/profiling.py``: ``StepTimer`` (tests/test_utils.py's case) and
  ``trace``, a Chrome trace from ``torch.profiler``.
* ``utils/telegram.py``: the cases of tests/test_observability.py with a
  mocked ``requests``; ``cli.main`` hands the logger to ``Trainer.run``.
* ``data/native.py``: the cases of tests/test_native.py (the library
  ``make -C native`` builds; skipped where it does not load), and
  ``plyio.load_ply`` reads ASCII files through its numpy parser.
* Every name the subpackages export imports, and each is one the JAX
  package's subpackage exports or the port's counterpart of one.
"""

from __future__ import annotations

import importlib
import json
import sys
import types

import numpy as np
import pytest

from hyperpocket_tpu.utils import augment as jaugment
from hyperpocket_tpu.utils import sphere_triangles as jsphere
from hyperpocket_tpu_torch.data import native, plyio
from hyperpocket_tpu_torch.utils import augment, sphere_triangles
from hyperpocket_tpu_torch.utils.profiling import StepTimer, trace
from hyperpocket_tpu_torch.utils.telegram import TelegramLogger


def test_rand_rotation_is_orthonormal_and_the_jax_packages():
    for seed in range(5):
        m = augment.rand_rotation_matrix(seed=seed)
        np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-10)
        assert np.linalg.det(m) == pytest.approx(1.0)
        np.testing.assert_array_equal(m, jaugment.rand_rotation_matrix(seed=seed))
    m = augment.rand_rotation_matrix(deflection=1e-9, seed=1)
    np.testing.assert_allclose(np.abs(m), np.eye(3), atol=1e-3)


def test_noise_rotation_and_z_rotate_augmentations():
    np.random.seed(0)
    out = augment.add_gaussian_noise_to_pcloud(np.zeros((10, 3)), mu=0, sigma=1)
    np.testing.assert_allclose(out[:, 0], out[:, 1])  # one scalar per point
    np.testing.assert_allclose(out[:, 0], out[:, 2])
    pts = np.random.default_rng(0).standard_normal((64, 3))
    np.random.seed(1)
    got = augment.add_rotation_to_pcloud(pts)
    np.random.seed(1)
    np.testing.assert_array_equal(got, jaugment.add_rotation_to_pcloud(pts))
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), np.linalg.norm(pts, axis=1),
                               atol=1e-10)

    class Conf:
        gauss_augment = None
        z_rotate = True

    pts = np.random.default_rng(1).standard_normal((32, 3))
    np.testing.assert_allclose(augment.apply_augmentations(pts, Conf())[:, 2], pts[:, 2],
                               atol=1e-12)


@pytest.mark.parametrize("method", sorted(sphere_triangles.METHODS))
def test_sphere_triangulation_matches_jax(method):
    points, tris = sphere_triangles.generate(method, 2)
    assert points.shape[0] == tris.shape[0] * 3
    np.testing.assert_allclose(np.linalg.norm(points, axis=1), 1.0, atol=1e-6)
    assert tris.max() == points.shape[0] - 1
    want_points, want_tris = jsphere.generate(method, 2)
    np.testing.assert_array_equal(points, want_points)
    np.testing.assert_array_equal(tris, want_tris)
    assert sphere_triangles.generate("edge", 3)[1].shape[0] == 8 * 4 ** 3


def test_step_timer_and_trace(tmp_path):
    import torch

    t = StepTimer(window=4)
    for _ in range(3):
        t.start()
        t.stop(items=8)
    assert t.mean_step_seconds > 0 and t.items_per_second > 0
    with pytest.raises(RuntimeError):
        t.stop()
    with trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    with open(tmp_path / "tr" / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)


@pytest.fixture
def fake_requests(monkeypatch):
    calls = []

    def post(url, data=None, files=None, timeout=None):
        calls.append({"url": url, "data": data, "files": files})

    mod = types.ModuleType("requests")
    mod.post = post
    monkeypatch.setitem(sys.modules, "requests", mod)
    return calls


def test_telegram_posts_text_and_images(fake_requests, tmp_path):
    tg = TelegramLogger("token123", "chat456")
    tg.log("hello")
    assert "bottoken123/sendMessage" in fake_requests[0]["url"]
    assert fake_requests[0]["data"]["text"] == "hello"
    paths = []
    for i in range(2):
        p = tmp_path / f"img{i}.png"
        p.write_bytes(b"fakepng")
        paths.append(str(p))
    tg.log_images(paths, caption="cap")
    assert "sendMediaGroup" in fake_requests[1]["url"]
    assert len(fake_requests[1]["files"]) == 2


def test_telegram_swallows_errors_and_is_a_singleton(monkeypatch):
    mod = types.ModuleType("requests")

    def post(*a, **k):
        raise ConnectionError("no network")

    mod.post = post
    monkeypatch.setitem(sys.modules, "requests", mod)
    tg = TelegramLogger("t", "c")
    tg.log("must not raise")
    tg.log_images(["/nonexistent.png"], "x")
    TelegramLogger._instance = None
    a = TelegramLogger.get_logger({"bot_token": "x", "chat_id": "y"})
    assert TelegramLogger.get_logger({"bot_token": "other", "chat_id": "z"}) is a
    TelegramLogger._instance = None


def test_cli_hands_the_telegram_logger_to_the_trainer(monkeypatch, fake_requests):
    from hyperpocket_tpu_torch import cli
    from hyperpocket_tpu_torch.train import trainer

    seen = {}

    class FakeTrainer:
        def __init__(self, config, device):
            self.device = device
            self.log = types.SimpleNamespace(info=lambda *a: None)

        def run(self, tg_logger=None):
            seen["logger"] = tg_logger
            tg_logger.log("Epoch: 1 saved")

    monkeypatch.setattr(trainer, "Trainer", FakeTrainer)
    TelegramLogger._instance = None
    cli.main({"mode": "training", "telegram_logger": {"enable": True, "bot_token": "tok",
                                                      "chat_id": "chat"}}, device="cpu")
    assert isinstance(seen["logger"], TelegramLogger) and seen["logger"].bot_token == "tok"
    assert fake_requests[0]["data"] == {"chat_id": "chat", "text": "Epoch: 1 saved"}
    TelegramLogger._instance = None


# ---------------------------------------------------------------------------
# data/native.py: the cases of tests/test_native.py


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("native/libhpcd.so does not load here (make -C native builds it)")


def test_native_roundtrip_parity(lib, tmp_path):
    pts = np.random.default_rng(0).standard_normal((777, 3)).astype(np.float32)
    plyio.save_ply(tmp_path / "a.ply", pts)
    native.save_ply(str(tmp_path / "b.ply"), pts)
    np.testing.assert_array_equal(native.load_ply(str(tmp_path / "a.ply")), pts)
    np.testing.assert_array_equal(plyio._load_ply_numpy(tmp_path / "b.ply"), pts)
    assert plyio.reader() == "native"


def test_native_skips_extra_columns(lib, tmp_path):
    n = 16
    rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("c", "<f4")])
    rng = np.random.default_rng(1)
    for k in rec.dtype.names:
        rec[k] = rng.standard_normal(n)
    p = tmp_path / "extra.ply"
    with open(p, "wb") as fh:
        fh.write((f"ply\nformat binary_little_endian 1.0\nelement vertex {n}\n"
                  "property float x\nproperty float y\nproperty float z\n"
                  "property float confidence\nend_header\n").encode())
        fh.write(rec.tobytes())
    out = native.load_ply(str(p))
    np.testing.assert_array_equal(out[:, 0], rec["x"])
    np.testing.assert_array_equal(out[:, 2], rec["z"])


def test_native_batch_load_and_error(lib, tmp_path):
    pts = np.random.default_rng(2).standard_normal((128, 3)).astype(np.float32)
    paths = []
    for i in range(8):
        plyio.save_ply(tmp_path / f"c{i}.ply", pts + i)
        paths.append(str(tmp_path / f"c{i}.ply"))
    batch = native.load_ply_batch(paths, 128)
    assert batch.shape == (8, 128, 3)
    for i in range(8):
        np.testing.assert_array_equal(batch[i], pts + i)
    plyio.save_ply(tmp_path / "short.ply", pts[:10])
    with pytest.raises(IOError, match="short.ply"):
        native.load_ply_batch(paths[:2] + [str(tmp_path / "short.ply")], 128)


def test_load_ply_reads_ascii_through_numpy(tmp_path):
    p = tmp_path / "ascii.ply"
    p.write_text("ply\nformat ascii 1.0\nelement vertex 2\n"
                 "property float x\nproperty float y\nproperty float z\nend_header\n"
                 "1 2 3\n4 5 6\n")
    np.testing.assert_allclose(plyio.load_ply(p), [[1, 2, 3], [4, 5, 6]])


# ---------------------------------------------------------------------------


EXPORTS = {
    # subpackage: the JAX package's names the port exports as its own
    "train": {"kld_loss", "reconstruction_loss", "make_optimizer", "make_lr_schedule",
              "find_latest_epoch", "resolve_restore_epoch", "Trainer"},
    "eval": {"EMD_CD", "compute_all_metrics", "jsd_between_point_cloud_sets", "mmd_cov",
             "pairwise_emd_cd"},
    "models": {"reparameterize", "target_weight_count", "batched_target_network_forward",
               "FullModel"},
    "utils": {"logging_setup", "seed_setup", "TelegramLogger"},
    "parallel": {"make_mesh", "param_shardings", "shard_batch", "replicate",
                 "chamfer_loss_point_sharded", "nn_distance_point_sharded"},
}


@pytest.mark.parametrize("sub", sorted(EXPORTS))
def test_subpackage_exports_import(sub):
    port = importlib.import_module(f"hyperpocket_tpu_torch.{sub}")
    jax_names = set(importlib.import_module(f"hyperpocket_tpu.{sub}").__all__)
    assert EXPORTS[sub] <= set(port.__all__) and EXPORTS[sub] <= jax_names
    for name in port.__all__:
        assert getattr(port, name) is not None, name
        assert getattr(port, name).__module__.startswith("hyperpocket_tpu_torch."), name
