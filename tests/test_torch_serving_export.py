"""Port's serving artifact, ``fit-prior`` and ``infer --artifact/--latent-prior`` vs the JAX package.

The artifact (``serving.export_completion`` / ``load_completion``) must give
``make_serving_fn``'s completion for the same seed, and its exported
program, fed the ball points directly, the JAX ``FullModel.apply`` on the
same weights within the fp32 parity budget (1e-5). The CLI is held to the
JAX CLI's cases (``tests/test_serving.py``) on checkpoints the JAX package
writes, and ``fit-prior``'s npz to the JAX CLI's within 1e-4. Everything
runs on the CPU; the card's cases are in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from os.path import exists, join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperpocket_tpu import serving as jax_serving
from hyperpocket_tpu.eval.latent_stats import load_latent_gaussian as jax_load_prior
from hyperpocket_tpu.models.full_model import FullModel as JaxFullModel
from hyperpocket_tpu.train import checkpoint as jax_ckpt
from hyperpocket_tpu_torch import serving
from hyperpocket_tpu_torch.data.plyio import load_ply, save_ply
from hyperpocket_tpu_torch.eval.latent_stats import (
    LatentGaussian,
    load_latent_gaussian,
    save_latent_gaussian,
)
from hyperpocket_tpu_torch.models.full_model import (
    MODE_HYPER_CLOUD,
    MODE_HYPER_POCKET,
    MODE_HYPER_REC,
    FullModel,
)
from hyperpocket_tpu_torch.ops import trunk_pool
from hyperpocket_tpu_torch.train.config import get_results_dir_path
from tests.test_data import make_synthetic_shapenet
from tests.test_torch_models import model_pair, tiny_config
from tests.test_torch_trunk_pool import random_biases
from tests.test_train_integration import make_config

torch.set_float32_matmul_precision("highest")

B, N_EXIST, N_OUT = 2, 64, 128
FP32_TOL = 1e-5
PRIOR_TOL = 1e-4
MODES = [MODE_HYPER_POCKET, MODE_HYPER_REC, MODE_HYPER_CLOUD]


def _inputs(model, n_existing=N_EXIST, seed=0):
    rng = np.random.default_rng(seed)
    existing = rng.standard_normal((B, n_existing, 3)).astype(np.float32) * 0.3
    noise = rng.standard_normal((B, model.get_noise_size())).astype(np.float32) * 0.13
    return existing, noise


def _export(model, **kw):
    kw = {"batch": B, "n_existing": N_EXIST, "num_output_points": N_OUT, "epoch": 50.0,
          "device": "cpu", **kw}
    return serving.export_completion(model, **kw)


def _graph_targets(data: bytes) -> set[str]:
    program = torch.export.load(io.BytesIO(data))
    return {str(n.target) for n in program.graph.nodes if n.op == "call_function"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_existing", [N_EXIST, 1024])
def test_artifact_round_trip_equals_serving_fn(mode, dtype, n_existing):
    """The same seed gives make_serving_fn's completion; at 1024 points the
    fp32 encoders take the sparse max-pool, as on the card, and bf16 ones K4's
    op at both counts; both dtypes decode through K10's op."""
    model = FullModel.from_config(tiny_config(mode, compute_dtype=dtype),
                                  torch.Generator().manual_seed(1))
    data = _export(model, n_existing=n_existing)
    assert isinstance(data, bytes)
    f = serving.load_completion(data)
    assert f.meta["batch"] == B and f.meta["n_existing"] == n_existing
    assert f.meta["noise_size"] == model.get_noise_size() and f.meta["device"] == "cpu"
    existing, noise = _inputs(model, n_existing)
    direct = serving.make_serving_fn(model, num_output_points=N_OUT, epoch=50.0, device="cpu")
    out = f(existing, noise, 7)
    assert out.shape == (B, N_OUT, 3) and out.dtype == torch.float32
    assert torch.equal(out, direct(existing, noise, 7))
    assert torch.equal(out, f(existing, noise, 7))
    assert not torch.equal(out, f(existing, noise, 8))
    # HyperCloud serves from the given noise alone and runs no encoder
    ops = _graph_targets(data)
    assert (("hyperpocket.trunk_pooled.default" in ops)
            == (dtype == "bfloat16" and mode != MODE_HYPER_CLOUD))
    assert "hyperpocket.decode_batch.default" in ops


@pytest.mark.parametrize("mode", MODES)
def test_exported_program_matches_jax_apply(mode):
    """The program with injected ball points vs JAX ``apply(ball_points=...)``."""
    jmodel, params, port = model_pair(tiny_config(mode), seed=4)
    existing, noise = _inputs(port, seed=5)
    balls = np.random.default_rng(6).uniform(-1, 1, (B, N_OUT, 3)).astype(np.float32)
    program = torch.export.load(io.BytesIO(_export(port))).module()
    got = program(torch.from_numpy(existing), torch.from_numpy(noise), torch.from_numpy(balls))
    want = jmodel.apply(params, jnp.asarray(existing), None, jax.random.key(0),
                        jnp.asarray(50.0), num_output_points=N_OUT, training=False,
                        noise=jnp.asarray(noise), ball_points=jnp.asarray(balls))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FP32_TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_trunk_op_opcheck(bias):
    """``hyperpocket::trunk_pooled``: schema, fake tensor and dispatch checks on
    the CPU, and the plain version's values through the op."""
    gen = torch.Generator().manual_seed(3)
    w = trunk_pool.WIDTHS
    layers = [(torch.randn(w[i + 1], w[i], generator=gen) * 0.2,
               torch.randn(w[i + 1], generator=gen) * 0.1 if bias else None)
              for i in range(len(w) - 1)]
    x = (torch.randn(2, 64, 3, generator=gen) * 0.3).to(torch.bfloat16)
    weights = [wt for wt, _ in layers]
    biases = [trunk_pool._bias(wt, b) for wt, b in layers]
    torch.library.opcheck(torch.ops.hyperpocket.trunk_pooled.default, (x, weights, biases))
    before = trunk_pool.trunk_pooled.launches
    got = trunk_pool.trunk_pooled(layers, x)
    assert trunk_pool.trunk_pooled.launches == before  # the CPU takes the plain version
    assert torch.equal(got, trunk_pool.trunk_pooled_reference(layers, x))
    fake = torch._subclasses.fake_tensor.FakeTensorMode()
    with fake:
        out = torch.ops.hyperpocket.trunk_pooled(
            torch.empty(5, 24, 3, dtype=torch.bfloat16),
            [torch.empty(t.shape) for t in weights], [torch.empty(t.shape) for t in biases])
    assert tuple(out.shape) == (5, 512) and out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="multiple of 8"):
        trunk_pool.trunk_pooled(layers, x[:, :63])


def _with_meta(data: bytes, **changes) -> bytes:
    """The artifact with its stored settings changed (as if exported elsewhere)."""
    src = zipfile.ZipFile(io.BytesIO(data))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as dst:
        for item in src.infolist():
            content = src.read(item.filename)
            if item.filename.endswith(serving.META_FILE):
                content = json.dumps({**json.loads(content), **changes}).encode()
            dst.writestr(item, content)
    return out.getvalue()


def test_artifact_refuses_an_absent_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = FullModel.from_config(tiny_config(compute_dtype="bfloat16"))
    data = _with_meta(_export(model), device="cuda:0")
    assert serving.artifact_meta(data)["device"] == "cuda:0"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.load_completion(data)
    path = tmp_path / "cuda.pt2"
    path.write_bytes(data)
    save_ply(tmp_path / "a.ply", np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.main(["infer", "--artifact", str(path), "--inputs", str(tmp_path / "a.ply"),
                      "--out-dir", str(tmp_path / "o")])
    assert not exists(tmp_path / "o" / "a_completion.ply")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.export_completion(model, batch=B, n_existing=N_EXIST)
    with pytest.raises(ValueError, match="not a completion artifact"):
        serving.artifact_meta(_plain_program())


def _plain_program() -> bytes:
    buf = io.BytesIO()
    torch.export.save(torch.export.export(torch.nn.ReLU(), (torch.zeros(3),)), buf)
    return buf.getvalue()


def test_data_parallel_export():
    model = FullModel.from_config(tiny_config())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _export(model, data_parallel=2)
    existing, noise = _inputs(model)
    one = serving.load_completion(_export(model, data_parallel=1))
    assert torch.equal(one(existing, noise, 3), serving.load_completion(_export(model))(
        existing, noise, 3))


def _jax_checkpoint(tmp_path, data_root=None):
    """A JAX-written checkpoint at epoch 3 of ``make_config``'s model; the config path."""
    config = make_config(data_root or tmp_path / "data", tmp_path / "results")
    model = JaxFullModel.from_config(config["full_model"])
    params = random_biases(model.init(jax.random.key(config["setup"]["seed"])), 2)
    training_dir = get_results_dir_path(config, "training")
    jax_ckpt.save_checkpoint(join(training_dir, "weights"), join(training_dir, "metrics"), 3,
                             params, {"dummy": jnp.zeros((1,))}, {"lr": 1e-3},
                             [[1.0, 1.0, 0.0]], [[2.0]])
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(config, fh)
    return config, cfg_path, model


def _scans(tmp_path) -> list[str]:
    """Three ragged inputs shifted away from the origin: resampling, padding of
    the last batch (3 jobs, batch 2) and the box denormalisation."""
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((50, 90, 64)):
        p = str(tmp_path / f"scan{i}.ply")
        save_ply(p, rng.normal(size=(n, 3)).astype(np.float32) * 0.2 + np.float32(5.0 * (i + 1)))
        paths.append(p)
    return paths


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_export_and_infer_artifact(tmp_path, capsys):
    """``export`` from a JAX-written checkpoint, then ``infer --artifact``."""
    config, cfg_path, jmodel = _jax_checkpoint(tmp_path)
    out_path = str(tmp_path / ("model" + serving.ARTIFACT_SUFFIX))
    flags = ["-c", cfg_path, "--batch", str(B), "--n-existing", str(N_EXIST),
             "--points", str(N_OUT)]
    assert serving.main([*flags, "--out", out_path, "--device", "cpu"]) == 0
    meta = _last_json(capsys)
    jax_out = str(tmp_path / "model.jaxexp")
    assert jax_serving.main([*flags, "--out", jax_out]) == 0
    jax_meta = _last_json(capsys)
    assert set(meta) == set(jax_meta)
    for key in ("restored_epoch", "batch", "n_existing", "num_output_points", "noise_size",
                "data_parallel", "compute_dtype"):
        assert meta[key] == jax_meta[key], key
    assert meta["platform"] == "cpu" and meta["bytes"] == os.path.getsize(out_path)
    with open(out_path + ".json") as fh:
        assert json.load(fh) == meta
    assert serving.artifact_meta(open(out_path, "rb").read())["epoch"] == 3.0

    inputs = _scans(tmp_path)
    out_dir = str(tmp_path / "completions")
    assert serving.main(["infer", "--artifact", out_path, "--inputs", *inputs,
                         "--out-dir", out_dir, "--seed", "3"]) == 0
    res = _last_json(capsys)
    assert res["artifact"] == out_path and len(res["written"]) == 3
    for i, path in enumerate(sorted(res["written"])):
        rec = load_ply(path)
        assert rec.shape == (N_OUT, 3) and np.all(np.isfinite(rec))
        # denormalised back into the input's coordinate frame
        assert np.abs(rec.mean(axis=0) - 5.0 * (i + 1)).max() < 2.0

    # the artifact serves what the config route serves for the same seed and draws
    cfg_dir = str(tmp_path / "from_config")
    assert serving.main(["infer", "--config", cfg_path, "--inputs", *inputs, "--out-dir",
                         cfg_dir, "--seed", "3", "--batch", str(B), "--n-existing",
                         str(N_EXIST), "--points", str(N_OUT), "--device", "cpu"]) == 0
    for path in _last_json(capsys)["written"]:
        np.testing.assert_array_equal(load_ply(path),
                                      load_ply(join(out_dir, os.path.basename(path))))

    # several samples: distinct noises give distinct files
    assert serving.main(["infer", "--artifact", out_path, "--inputs", inputs[0], "--out-dir",
                         out_dir, "--samples", "3", "--noise-std", "0.13"]) == 0
    res = _last_json(capsys)
    assert len(res["written"]) == 3
    a, b = (load_ply(p) for p in res["written"][:2])
    assert np.abs(a - b).max() > 0

    # --latent-prior: the noise is the fitted Gaussian's draw
    z = jmodel.get_noise_size()
    prior_path = str(tmp_path / "prior.npz")
    save_latent_gaussian(LatentGaussian(mean=np.full((z,), 0.5, np.float32),
                                        scale_tril=0.01 * np.eye(z, dtype=np.float32)),
                         prior_path)
    emp = str(tmp_path / "emp")
    assert serving.main(["infer", "--artifact", out_path, "--inputs", inputs[0], "--out-dir",
                         emp, "--samples", "2", "--latent-prior", prior_path]) == 0
    res = _last_json(capsys)
    assert len(res["written"]) == 2
    # the same draws by hand: eps from the seed's numpy stream after the resampling
    rng = np.random.default_rng(0)
    pts = load_ply(inputs[0])
    center, scale = serving.get_scales(pts)
    ex = serving.resample_pcd((pts - center) / scale, N_EXIST, rng)
    lg = load_latent_gaussian(prior_path)
    noise = lg.mean + rng.standard_normal((B, z)).astype(np.float32) @ lg.scale_tril.T
    f = serving.load_completion(open(out_path, "rb").read())
    want = f(np.stack([ex, ex]), noise, 0).numpy()
    for k, path in enumerate(res["written"]):
        np.testing.assert_allclose(load_ply(path), want[k] * scale + center, atol=1e-5)

    # a prior of another dim is refused before any completion
    save_latent_gaussian(LatentGaussian(mean=np.zeros((z + 1,), np.float32),
                                        scale_tril=np.eye(z + 1, dtype=np.float32)), prior_path)
    with pytest.raises(SystemExit, match="noise_size"):
        serving.main(["infer", "--artifact", out_path, "--inputs", inputs[0],
                      "--out-dir", str(tmp_path / "refused"), "--latent-prior", prior_path])
    assert not exists(tmp_path / "refused")
    # the artifact fixes the shapes and the device
    with pytest.raises(SystemExit):
        serving.main(["infer", "--artifact", out_path, "--inputs", inputs[0],
                      "--out-dir", out_dir, "--batch", "4"])
    # the explicit "export" spelling resolves to the exporter
    with pytest.raises(SystemExit):
        serving.main(["export", "--help"])


def test_fit_prior_matches_jax_cli(tmp_path, capsys):
    """``fit-prior`` on a JAX-written checkpoint: the npz within 1e-4 of the JAX CLI's."""
    make_synthetic_shapenet(tmp_path / "data", n_models=6, n_gt=64, n_part=32)
    _, cfg_path, jmodel = _jax_checkpoint(tmp_path, tmp_path / "data")
    flags = ["fit-prior", "-c", cfg_path, "--max-items", "6", "--batch-size", "2"]
    np.random.seed(11)  # the datasets' resampling draws from numpy's global RNG
    assert jax_serving.main([*flags, "--out", str(tmp_path / "jax.npz")]) == 0
    want_meta = _last_json(capsys)
    np.random.seed(11)
    assert serving.main([*flags, "--out", str(tmp_path / "port.npz"), "--device", "cpu"]) == 0
    meta = _last_json(capsys)
    assert {k: meta[k] for k in ("epoch", "fitted_on", "dim")} == {
        k: want_meta[k] for k in ("epoch", "fitted_on", "dim")}
    assert meta["dim"] == jmodel.get_noise_size() and meta["fitted_on"] > 0
    got, want = load_latent_gaussian(meta["out"]), jax_load_prior(want_meta["out"])
    np.testing.assert_allclose(got.mean, want.mean, rtol=PRIOR_TOL, atol=1e-6)
    np.testing.assert_allclose(got.scale_tril, want.scale_tril, rtol=PRIOR_TOL, atol=1e-6)
    assert np.allclose(got.scale_tril, np.tril(got.scale_tril))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serving.main([*flags, "--out", str(tmp_path / "x.npz")])
