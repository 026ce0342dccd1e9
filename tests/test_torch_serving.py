"""Port's serving path: sampling, serving fn, the infer CLI, and what it reads."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from os.path import join

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperpocket_tpu.data import plyio as jax_plyio
from hyperpocket_tpu.data.base import resample_pcd as jax_resample_pcd
from hyperpocket_tpu.data.real_data import RealDataNPYDataset
from hyperpocket_tpu.ops.sampling import progressive_normalize as jax_progressive_normalize
from hyperpocket_tpu.train import checkpoint as jax_ckpt
from hyperpocket_tpu.train import config as jax_config
from hyperpocket_tpu_torch import serving
from hyperpocket_tpu_torch.convert import save_jax_npz
from hyperpocket_tpu_torch.data.base import resample_pcd
from hyperpocket_tpu_torch.data.plyio import PlyParseError, load_ply, save_ply
from hyperpocket_tpu_torch.data.real_data import get_scales
from hyperpocket_tpu_torch.models.full_model import FullModel
from hyperpocket_tpu_torch.ops.sampling import (
    generate_target_network_input_batch,
    progressive_normalize,
    sample_uniform_ball_batch,
)
from hyperpocket_tpu_torch.train import checkpoint as ckpt
from hyperpocket_tpu_torch.train import config as port_config
from tests.test_torch_models import tiny_config
from tests.test_train_integration import make_config

B, N_EXIST, N_OUT = 2, 64, 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("epoch", [1.0, 37.0, 100.0, 250.0, 1e9])
def test_progressive_normalize_matches_jax(epoch):
    pts = np.random.default_rng(0).uniform(-1, 1, (3, 256, 3)).astype(np.float32)
    want = np.asarray(jax_progressive_normalize(jnp.asarray(pts), jnp.asarray(epoch), 100))
    got = progressive_normalize(torch.from_numpy(pts), epoch, 100).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("method", ["exact", "rejection"])
def test_ball_samples_lie_in_the_unit_ball(method):
    g = torch.Generator().manual_seed(0)
    pts = sample_uniform_ball_batch(g, 4, 512, method=method)
    assert pts.shape == (4, 512, 3) and pts.dtype == torch.float32
    norms = pts.norm(dim=-1)
    assert norms.max() < 1.0
    # uniform in the ball: P(|p| < 0.5) = 1/8
    assert abs((norms < 0.5).float().mean().item() - 0.125) < 0.03
    again = sample_uniform_ball_batch(torch.Generator().manual_seed(0), 4, 512, method=method)
    assert torch.equal(pts, again)


def test_rejection_keeps_draw_order():
    g = torch.Generator().manual_seed(1)
    pts = sample_uniform_ball_batch(g, 2, 64, method="rejection")
    raw = torch.rand((2, 192, 3), generator=torch.Generator().manual_seed(1)) * 2.0 - 1.0
    for b in range(2):
        inside = raw[b][raw[b].norm(dim=-1) < 1.0][:64]
        assert torch.equal(pts[b], inside)


def test_unknown_ball_method_raises():
    with pytest.raises(ValueError, match="unknown ball-sampling method"):
        sample_uniform_ball_batch(torch.Generator(), 1, 8, method="grid")


def test_serving_epoch_pushes_points_onto_the_sphere():
    cfg = tiny_config()["target_network_input"]
    pts = generate_target_network_input_batch(cfg, torch.Generator().manual_seed(2), 1e9, 2, 256)
    np.testing.assert_allclose(pts.norm(dim=-1).numpy(), 1.0, atol=1e-6)


def _served(seed=0):
    model = FullModel.from_config(tiny_config(), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    existing = rng.standard_normal((B, N_EXIST, 3)).astype(np.float32) * 0.3
    noise = rng.standard_normal((B, model.get_noise_size())).astype(np.float32)
    return model, existing, noise


def test_serving_fn_is_deterministic_per_seed():
    model, existing, noise = _served()
    f = serving.make_serving_fn(model, num_output_points=N_OUT, device="cpu")
    out = f(existing, noise, 7)
    assert out.shape == (B, N_OUT, 3) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert torch.equal(out, f(existing, noise, 7))
    assert not torch.equal(out, f(existing, noise, 8))


def test_serving_fn_takes_a_module_or_a_state_dict():
    model, existing, noise = _served()
    other = FullModel.from_config(tiny_config(), torch.Generator().manual_seed(5))
    by_module = serving.make_serving_fn(model, other, num_output_points=N_OUT, device="cpu")
    by_state = serving.make_serving_fn(model, other.state_dict(), num_output_points=N_OUT,
                                       device="cpu")
    assert torch.equal(by_module(existing, noise, 3), by_state(existing, noise, 3))


def test_serving_fn_bf16_returns_fp32():
    model = FullModel.from_config(tiny_config(compute_dtype="bfloat16"))
    _, existing, noise = _served()
    out = serving.make_serving_fn(model, num_output_points=N_OUT, device="cpu")(
        existing, noise, 0)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model, _, _ = _served()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.make_serving_fn(model, num_output_points=N_OUT)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.main(["infer", "--config", "x.json", "--inputs", "a.ply", "--out-dir", "o"])


def _stage_checkpoint(tmp_path, epochs=(1, 3), val=(2.0, 1.0, 3.0)):
    config = make_config(tmp_path / "data", tmp_path / "results")
    config["full_model"] = tiny_config()
    model = FullModel.from_config(config["full_model"], torch.Generator().manual_seed(9))
    training_dir = port_config.get_results_dir_path(config, "training")
    os.makedirs(join(training_dir, "weights"))
    os.makedirs(join(training_dir, "metrics"))
    for e in epochs:
        save_jax_npz(join(training_dir, "weights", f"{e:05}_model.npz"), model)
    np.save(join(training_dir, "metrics", f"{max(epochs):05}_val"), np.array([[v] for v in val]))
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(config, fh)
    return config, cfg_path, model


def test_infer_cli_writes_completions(tmp_path, capsys):
    config, cfg_path, _ = _stage_checkpoint(tmp_path)
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((50, 90, 64)):
        pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.2 + np.float32(5.0 * (i + 1))
        p = str(tmp_path / f"scan{i}.ply")
        save_ply(p, pts)
        paths.append(p)
    out_dir = str(tmp_path / "completions")
    rc = serving.main(["infer", "--config", cfg_path, "--inputs", *paths, "--out-dir", out_dir,
                       "--batch", str(B), "--n-existing", str(N_EXIST), "--points", str(N_OUT),
                       "--samples", "2", "--noise-std", "0.13", "--epoch", "latest",
                       "--device", "cpu"])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["restored_epoch"] == 3 and len(res["written"]) == 6
    for path in res["written"]:
        i = int(os.path.basename(path)[len("scan")])
        rec = load_ply(path)
        assert rec.shape == (N_OUT, 3) and np.all(np.isfinite(rec))
        # mapped back into the input's coordinate frame
        assert np.abs(rec.mean(axis=0) - 5.0 * (i + 1)).max() < 2.0
    a, b = (load_ply(p) for p in res["written"][:2])
    assert np.abs(a - b).max() > 0  # distinct noise per sample


def test_restore_policies_match_jax(tmp_path):
    config, _, model = _stage_checkpoint(tmp_path)
    training_dir = port_config.get_results_dir_path(config, "training")
    weights, metrics = join(training_dir, "weights"), join(training_dir, "metrics")
    assert ckpt.find_latest_epoch(training_dir) == jax_ckpt.find_latest_epoch(training_dir) == 3
    assert ckpt.find_latest_epoch(str(tmp_path / "nothing")) == 0
    for policy in ("latest", "best_val", "1", 2):
        for wp in (None, weights):
            assert (ckpt.resolve_restore_epoch(metrics, 3, policy, wp)
                    == jax_ckpt.resolve_restore_epoch(metrics, 3, policy, wp))
    with pytest.raises(ValueError, match="positive integer"):
        ckpt.resolve_restore_epoch(metrics, 3, "newest")
    restored, epoch = ckpt.restore_trained_model(config, "best_val")
    assert epoch == 1  # val argmin is epoch 2, which has no weights
    for a, b in zip(restored.parameters(), model.parameters()):
        assert torch.equal(a, b)
    config["results_root"] = str(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_trained_model(config)


@pytest.mark.parametrize("cfg_file", ["config_3depn_chair.json", None])
def test_results_dir_matches_jax(cfg_file):
    if cfg_file:
        with open(join(REPO, "settings", cfg_file)) as fh:
            config = json.load(fh)
    else:
        config = make_config("/data", "/results")
    for mode in ("training", "experiments"):
        assert (port_config.get_results_dir_path(config, mode)
                == jax_config.get_results_dir_path(config, mode))


@pytest.mark.parametrize("fmt", ["binary_little_endian", "binary_big_endian", "ascii"])
def test_ply_reader_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(37, 3)).astype(np.float32)
    path = str(tmp_path / "cloud.ply")
    jax_plyio.save_ply_elements(path, [
        ("camera", [("k", np.arange(2, dtype=np.int32))]),
        ("vertex", [("nx", pts[:, 0] * 2), ("x", pts[:, 0]), ("y", pts[:, 1]),
                    ("z", pts[:, 2].astype(np.float64)), ("red", np.ones(37, np.uint8))]),
    ], fmt=fmt)
    np.testing.assert_array_equal(load_ply(path), jax_plyio.load_ply(path))


@pytest.mark.parametrize("fmt", ["binary_little_endian", "ascii"])
def test_ply_reader_rejects_vertex_lists(tmp_path, fmt):
    """Lists on the vertex are read past, as the JAX reader does; a file cut
    inside the vertex rows is refused."""
    pts = np.random.default_rng(5).normal(size=(4, 3)).astype(np.float32)
    path = tmp_path / "lists.ply"
    jax_plyio.save_ply_elements(str(path), [
        ("vertex", [("idx", jax_plyio.ListProperty([[1], [2, 3], [], [4]])), ("x", pts[:, 0]),
                    ("y", pts[:, 1]), ("z", pts[:, 2])]),
    ], fmt=fmt)
    np.testing.assert_array_equal(load_ply(path), pts)
    data = path.read_bytes()
    cut = data[:len(data) - (8 if fmt != "ascii" else len(data.splitlines(True)[-1]))]
    path.write_bytes(cut)
    with pytest.raises(PlyParseError, match="truncated"):
        load_ply(path)


def _ply_case(path: str, case: str) -> None:
    """One of the five files of the reader's parity test, written with the JAX writer."""
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(6, 3)).astype(np.float32)
    faces = ("face", [("vertex_indices", jax_plyio.ListProperty(
        [[0, 1, 2], [2, 3, 4, 5], []], count_type="uchar", value_type="int"))])
    vertex = [("x", pts[:, 0]), ("y", pts[:, 1]), ("z", pts[:, 2])]
    listed = [("n", jax_plyio.ListProperty([[1.5], [], [2.0, 3.0], [4.0], [], [5.0, 6.0, 7.0]],
                                            count_type="uchar", value_type="float")),
              *vertex, ("tag", jax_plyio.ListProperty([[1, 2], [], [3], [], [4], [5]]))]
    elements, fmt = {
        "binary_vertex_list": ([("vertex", listed)], "binary_little_endian"),
        "binary_face_first": ([faces, ("vertex", vertex)], "binary_little_endian"),
        "ascii_vertex_list": ([faces, ("vertex", listed)], "ascii"),
        "big_endian": ([faces, ("vertex", listed)], "binary_big_endian"),
        "plain": ([("vertex", vertex)], "binary_little_endian"),
    }[case]
    jax_plyio.save_ply_elements(path, elements, fmt=fmt)


@pytest.mark.parametrize("case", ["binary_vertex_list", "binary_face_first", "ascii_vertex_list",
                                  "big_endian", "plain"])
def test_ply_reader_matches_jax_numpy_reader(tmp_path, case):
    """The port's reader returns exactly what ``_load_ply_numpy`` returns."""
    path = str(tmp_path / f"{case}.ply")
    _ply_case(path, case)
    got = load_ply(path)
    want = jax_plyio._load_ply_numpy(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (6, 3)
    np.testing.assert_array_equal(got, want)


def test_ply_writer_matches_jax_bytes(tmp_path):
    pts = np.random.default_rng(4).normal(size=(20, 3)).astype(np.float32)
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    save_ply(a, pts)
    jax_plyio.save_ply(b, pts)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_resample_and_scales_match_jax():
    pts = np.random.default_rng(5).normal(size=(50, 3)).astype(np.float32) + 3.0
    for n in (20, 80):
        np.testing.assert_array_equal(
            resample_pcd(pts, n, np.random.default_rng(6)),
            jax_resample_pcd(pts, n, rng=np.random.default_rng(6)))
    c, s = get_scales(pts)
    jc, js = RealDataNPYDataset._get_scales(pts)
    np.testing.assert_array_equal(c, jc)
    assert s == js


def test_port_imports_without_jax():
    """The serving path, its artifact and prior and the data readers import
    neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import hyperpocket_tpu_torch.serving, hyperpocket_tpu_torch.convert\n"
        "import hyperpocket_tpu_torch.data, hyperpocket_tpu_torch.data.completion3d\n"
        "import hyperpocket_tpu_torch.data.real_data, hyperpocket_tpu_torch.eval.latent_stats\n"
        "import hyperpocket_tpu_torch.ops.trunk_pool, hyperpocket_tpu_torch.cli\n"
        "bad = [m for m in sys.modules if m == 'hyperpocket_tpu' or m.startswith('hyperpocket_tpu.')"
        " or m.startswith('jax')]\n"
        "assert bad == ['jax'], bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "HPCD_PLATFORM"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
