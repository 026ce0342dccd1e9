"""Port's Trainer, checkpoints and CLI training mode vs the JAX package.

Both Trainers run the tiny config of tests/test_train_integration.py on the
synthetic MissingShapeNet tree of tests/test_data.py, in fp64
(``param_dtype``/``compute_dtype`` float64, the trajectory-parity mode),
from the same weights, with the same VAE noise and ball points through
``injection_provider`` and, in the val steps, through each package's
sampler (patched here). The loaders' batches are fp64 too (both packages'
``collate``, patched here): with fp32 ground truth the JAX package's jitted
Chamfer rounds part of its distance expansion in fp32, 1e-10 to 1e-9
relative from its own eager value, which the port reproduces. Per-step
losses, epoch means and val losses agree
within 1e-9 relative, saved leaves within 1e-9 of each leaf's largest
magnitude, and each package resumes from the other's checkpoint to the same
next epoch (1e-9). The bf16-moment Adam is held to ``scale_by_adam_lowp``:
moments bit-equal where both round the same fp32, updates within 1e-6
relative.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperpocket_tpu.data import loader as jloader
from hyperpocket_tpu.models import full_model as jfm
from hyperpocket_tpu.train import checkpoint as jckpt
from hyperpocket_tpu.train import optim as joptim
from hyperpocket_tpu_torch import cli
from hyperpocket_tpu_torch.convert import params_from_jax
from hyperpocket_tpu_torch.data import loader as ploader
from hyperpocket_tpu_torch.models import full_model as pfm
from hyperpocket_tpu_torch.train import checkpoint as ckpt
from hyperpocket_tpu_torch.train import optim, trainer
from tests.test_data import make_synthetic_shapenet
from tests.test_train_integration import make_config

RTOL = 1e-9
Z, N_GT, N_PART, BATCH = 16, 64, 32, 2


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    make_synthetic_shapenet(root, n_models=6, n_gt=N_GT, n_part=N_PART)
    return root


def _config(data_root, results_root, max_epoch=2, dtype="float64", **training):
    config = make_config(data_root, results_root, max_epoch=max_epoch, batch=BATCH)
    config["training"].update(param_dtype=dtype, compute_dtype=dtype, **training)
    for part in ("train", "val"):
        config["training"]["dataloader"][part]["num_workers"] = 0
    return config


def _injection(epoch: int, i: int) -> dict:
    rng = np.random.default_rng((epoch, i))
    return {"vae_eps": rng.standard_normal((BATCH, Z)).astype(np.float32),
            "ball_points": rng.uniform(-0.5, 0.5, (BATCH, N_GT, 3)).astype(np.float32)}


def _val_balls(batch: int, n: int) -> np.ndarray:
    return np.random.default_rng((batch, n)).uniform(-0.5, 0.5, (batch, n, 3)).astype(np.float32)


@pytest.fixture
def same_val_balls(monkeypatch):
    monkeypatch.setattr(jfm, "generate_target_network_input_batch",
                        lambda cfg, key, epoch, b, n, **k: jnp.asarray(_val_balls(b, n)))
    monkeypatch.setattr(pfm, "generate_target_network_input_batch",
                        lambda cfg, gen, epoch, b, n, **k: torch.from_numpy(_val_balls(b, n)))


def _record(t, inject: bool = True) -> list:
    """Every train epoch's per-step loss rows, as they come; with ``inject``
    the steps take ``_injection``'s draws."""
    rows, inner = [], t.train_epoch

    def wrapped(epoch):
        out = inner(epoch)
        rows.append(np.asarray(t.last_step_losses, np.float64).copy())
        return out

    t.train_epoch = wrapped
    if inject:
        t.injection_provider = _injection
    return rows


def _jax_trainer(config):
    from hyperpocket_tpu.train.trainer import Trainer

    return Trainer(config, use_mesh=False)


def _port_trainer(config, jax_params=None):
    t = trainer.Trainer(config, device="cpu")
    if jax_params is not None:  # the JAX trainer's initial weights
        t.model.load_state_dict(params_from_jax(jax.device_get(jax_params), torch.float64))
    return t


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _npz(path) -> list[np.ndarray]:
    with np.load(path) as data:
        return [data[f"arr_{i}"] for i in range(sum(f.startswith("arr_") for f in data.files))]


@pytest.fixture(scope="module")
def runs(data_root, tmp_path_factory):
    """Epochs 1-2 in both packages from the same weights, then epoch 3 four
    ways: each package resuming its own files and the other's."""
    root = tmp_path_factory.mktemp("runs")
    mp = pytest.MonkeyPatch()
    mp.setattr(jfm, "generate_target_network_input_batch",
               lambda cfg, key, epoch, b, n, **k: jnp.asarray(_val_balls(b, n)))
    mp.setattr(pfm, "generate_target_network_input_batch",
               lambda cfg, gen, epoch, b, n, **k: torch.from_numpy(_val_balls(b, n)))
    for module in (jloader, ploader):
        inner = module.collate
        mp.setattr(module, "collate", lambda items, inner=inner: tuple(
            a.astype(np.float64) if isinstance(a, np.ndarray) and a.dtype == np.float32 else a
            for a in inner(items)))
    out = {}
    try:
        with jax.enable_x64(True):
            jt = _jax_trainer(_config(data_root, root / "jax"))
            init = jax.tree_util.tree_map(np.array, jax.device_get(jt.params))
            out["jax_rows"] = _record(jt)
            out["jax_losses"] = jt.run(plot_samples=False)
            out["jax_best"] = jt.best_epoch_loss
            out["jax_dir"] = jt.result_dir
            shutil.copytree(root / "jax", root / "jax_for_port")
            shutil.copytree(root / "jax", root / "jax_own")

            pt = _port_trainer(_config(data_root, root / "port"), init)
            out["port_rows"] = _record(pt)
            out["port_losses"] = pt.run(plot_samples=False)
            out["port_best"] = pt.best_epoch_loss
            out["port_dir"] = pt.result_dir
            out["port_trainer"] = pt
            shutil.copytree(root / "port", root / "port_for_jax")

            epoch3 = {}
            for name, make, results in (
                    ("jax_own", _jax_trainer, "jax_own"),
                    ("jax_from_port", _jax_trainer, "port_for_jax"),
                    ("port_own", _port_trainer, "port"),
                    ("port_from_jax", _port_trainer, "jax_for_port")):
                t = make(_config(data_root, root / results, max_epoch=3))
                assert t.start_epoch == 3, name
                rows = _record(t)
                losses = t.run(plot_samples=False)
                epoch3[name] = (rows[0], np.asarray(losses[0][2], np.float64),
                                np.asarray(losses[1][2], np.float64))
            out["epoch3"] = epoch3
    finally:
        mp.undo()
    return out


def test_trainer_steps_and_epochs_match_jax_fp64(runs):
    assert len(runs["port_rows"]) == len(runs["jax_rows"]) == 2
    for got, want in zip(runs["port_rows"], runs["jax_rows"]):
        assert got.shape == want.shape == (2, 3)
        assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    (p_train, p_val), (j_train, j_val) = runs["port_losses"], runs["jax_losses"]
    assert _rel(np.asarray(p_train), np.asarray(j_train)) <= RTOL
    assert _rel(np.asarray(p_val, np.float64), np.asarray(j_val, np.float64)) <= RTOL
    # the epoch mean is the true mean of the epoch's steps
    np.testing.assert_allclose(p_train[1], runs["port_rows"][1].mean(axis=0), rtol=1e-12)
    assert runs["port_best"] == pytest.approx(runs["jax_best"], rel=RTOL)
    assert runs["port_losses"][0][1][1] < runs["port_losses"][0][0][1]


def test_saved_leaves_match_jax(runs):
    assert runs["port_dir"].split(os.sep)[-4:] == runs["jax_dir"].split(os.sep)[-4:]
    for epoch in (1, 2):
        for suffix in ("model.npz", "O.npz"):
            got = _npz(join(runs["port_dir"], "weights", f"{epoch:05}_{suffix}"))
            want = _npz(join(runs["jax_dir"], "weights", f"{epoch:05}_{suffix}"))
            assert len(got) == len(want), suffix
            for i, (g, w) in enumerate(zip(got, want)):
                assert g.shape == w.shape and g.dtype == w.dtype, (suffix, i)
                assert _rel(g, w) <= RTOL, (suffix, i, _rel(g, w))
        with np.load(join(runs["port_dir"], "weights", f"{epoch:05}_O.npz")) as data:
            assert "__structure__" not in data.files
    for name in ("train", "val"):
        got = np.load(join(runs["port_dir"], "metrics", f"00002_{name}.npy"))
        want = np.load(join(runs["jax_dir"], "metrics", f"00002_{name}.npy"))
        assert got.shape == want.shape and _rel(got, want) <= RTOL
    with open(join(runs["port_dir"], "weights", "00002_S.json")) as fh:
        port_s = json.load(fh)
    with open(join(runs["jax_dir"], "weights", "00002_S.json")) as fh:
        assert port_s == json.load(fh)


def test_each_package_resumes_the_others_checkpoint(runs):
    e3 = runs["epoch3"]
    want_rows, want_train, want_val = e3["jax_own"]
    for name in ("jax_from_port", "port_own", "port_from_jax"):
        rows, train, val = e3[name]
        assert np.abs(rows - want_rows).max() <= RTOL * np.abs(want_rows).max(), name
        assert _rel(train, want_train) <= RTOL and _rel(val, want_val) <= RTOL, name


def test_find_latest_resumable_epoch_skips_a_model_only_save(tmp_path):
    weights, metrics = tmp_path / "weights", tmp_path / "metrics"
    weights.mkdir()
    metrics.mkdir()
    for epoch in (1, 2):
        for name in (f"{epoch:05}_model.npz", f"{epoch:05}_O.npz"):
            (weights / name).write_bytes(b"")
        for name in (f"{epoch:05}_train.npy", f"{epoch:05}_val.npy"):
            (metrics / name).write_bytes(b"")
    (weights / "00003_model.npz").write_bytes(b"")
    for fn in (ckpt.find_latest_resumable_epoch, jckpt.find_latest_resumable_epoch):
        assert fn(str(weights), str(metrics)) == 2
    assert ckpt.find_latest_epoch(str(weights)) == 3
    assert ckpt.find_latest_resumable_epoch(str(tmp_path / "none"), str(metrics)) == 0


def test_async_checkpointer_defers_while_busy(runs, monkeypatch, tmp_path):
    t = runs["port_trainer"]
    release, written = threading.Event(), []

    def slow_write(weights_path, metrics_path, epoch, *rest):
        release.wait(10)
        written.append(epoch)

    monkeypatch.setattr(ckpt, "write_checkpoint", slow_write)
    args = (str(tmp_path / "w"), str(tmp_path / "m"))
    rest = (t.model, t.optimizer, t.updates, {"epoch": 0}, [], [])
    for mode, want in ((True, [1, 3]), (False, [1, 2, 3])):
        writer = ckpt.AsyncCheckpointer(drop_if_busy=mode)
        written.clear()
        release.clear()
        assert writer.submit(*args, 1, *rest)
        if mode:
            assert not writer.submit(*args, 2, *rest)  # writer busy: deferred, replaced by 3
            assert not writer.submit(*args, 3, *rest)
            assert writer.dropped == 2
            release.set()
        else:
            threading.Timer(0.2, release.set).start()
            assert writer.submit(*args, 2, *rest) and writer.submit(*args, 3, *rest)
        writer.wait()
        assert written == want


def test_async_checkpoint_writes_a_snapshot(runs, data_root, tmp_path):
    t = runs["port_trainer"]
    writer = ckpt.AsyncCheckpointer()
    before = [p.detach().clone() for p in t.model.parameters()]
    assert writer.submit(str(tmp_path / "w"), str(tmp_path / "m"), 7, t.model, t.optimizer,
                         t.updates, {"epoch": 7}, [[1.0, 1.0, 0.0]], [[2.0]])
    with torch.no_grad():  # the live parameters move on; the snapshot does not
        for p in t.model.parameters():
            p.add_(1.0)
    writer.wait()
    with torch.no_grad():
        for p, b in zip(t.model.parameters(), before):
            p.copy_(b)
    fresh = _port_trainer(_config(data_root, tmp_path / "fresh"))
    epoch, count = ckpt.restore_model_state(str(tmp_path / "w"), str(tmp_path / "m"), 7,
                                            "latest", fresh.model, fresh.optimizer)
    assert (epoch, count) == (7, t.updates)
    for got, want in zip(fresh.model.parameters(), before):
        assert torch.equal(got, want)


def test_dtype_switch_crossing_equals_a_resume_under_the_new_dtype(data_root, tmp_path,
                                                                    same_val_balls):
    """bf16 until the switch epoch, then fp32: the same as resuming the
    epoch-1 checkpoint with fp32 compute (parameters and optimizer state are
    the fp32 masters either way)."""
    switch = {"epoch": 1, "compute_dtype": "float32"}
    cfg = _config(data_root, tmp_path / "switch", dtype="float32",
                  compute_dtype_switch=switch)
    cfg["training"].update(compute_dtype="bfloat16", param_dtype="float32")
    t = trainer.Trainer(cfg, device="cpu")
    rows = _record(t)
    t.run(plot_samples=False)
    assert t.model.compute_dtype == "float32"

    cfg_a = _config(data_root, tmp_path / "manual", max_epoch=1, dtype="float32")
    cfg_a["training"]["compute_dtype"] = "bfloat16"
    ta = trainer.Trainer(cfg_a, device="cpu")
    rows_a = _record(ta)
    ta.run(plot_samples=False)
    assert ta.model.compute_dtype == "bfloat16"
    cfg_b = _config(data_root, tmp_path / "manual", max_epoch=2, dtype="float32")
    tb = trainer.Trainer(cfg_b, device="cpu")
    assert tb.start_epoch == 2 and tb.model.compute_dtype == "float32"
    rows_b = _record(tb)
    tb.run(plot_samples=False)
    np.testing.assert_array_equal(rows[0], rows_a[0])
    np.testing.assert_array_equal(rows[1], rows_b[0])
    assert not np.array_equal(rows[1], rows[0])


def test_resume_reproduces_the_uninterrupted_run_with_bf16_moments(data_root, tmp_path,
                                                                   same_val_balls):
    """The fast config's recipe (bf16 compute, bf16 Adam moments): epochs 1-2,
    then a resume at 3, gives the bits of 3 uninterrupted epochs. The steps
    draw their noise and ball points from the generators the step counter
    seeds, so the resume must restore the counter, the parameters and the
    bf16 moments exactly."""
    def config(results, max_epoch):
        cfg = _config(data_root, tmp_path / results, max_epoch=max_epoch, dtype="float32")
        cfg["training"]["compute_dtype"] = "bfloat16"
        cfg["training"]["optimizer"]["hyperparams"]["moment_dtype"] = "bfloat16"
        return cfg

    full = trainer.Trainer(config("full", 3), device="cpu")
    assert isinstance(full.optimizer, optim.AdamLowp)
    rows_full = _record(full, inject=False)
    full_train, full_val = full.run(plot_samples=False)
    trainer.Trainer(config("resumed", 2), device="cpu").run(plot_samples=False)
    resumed = trainer.Trainer(config("resumed", 3), device="cpu")
    assert resumed.start_epoch == 3 and resumed.updates == 4
    rows = _record(resumed, inject=False)
    train, val = resumed.run(plot_samples=False)
    np.testing.assert_array_equal(rows[0], rows_full[2])
    np.testing.assert_array_equal(np.asarray(train, np.float64), np.asarray(full_train, np.float64))
    np.testing.assert_array_equal(np.asarray(val, np.float64), np.asarray(full_val, np.float64))


def test_frozen_heads_stay_fixed_and_their_state_is_masked(data_root, tmp_path,
                                                            same_val_balls):
    cfg = _config(data_root, tmp_path / "frozen", max_epoch=1)
    cfg["full_model"]["target_network"]["freeze_layers_learning"] = True
    t = trainer.Trainer(cfg, device="cpu")
    heads = [p.detach().clone() for p in t.model.hyper_network.heads.parameters()]
    t.injection_provider = _injection
    t.run(plot_samples=False)
    for p, b in zip(t.model.hyper_network.heads.parameters(), heads):
        assert torch.equal(p, b)
    # optax's masked state holds no leaves for the frozen heads
    with jax.enable_x64(True):
        cfg["training"]["max_epoch"] = 2
        jt = _jax_trainer(cfg)
        assert jt.start_epoch == 2
        want = len(jax.tree_util.tree_leaves(jt.opt_state))
    assert len(_npz(join(t.weights_path, "00001_O.npz"))) == want


OPTIMIZERS = {
    "adam": {"type": "Adam", "hyperparams": {"lr": 1e-3}},
    "adam_l2": {"type": "Adam", "hyperparams": {"lr": 1e-3, "weight_decay": 0.05}},
    "adam_amsgrad": {"type": "Adam", "hyperparams": {"lr": 1e-3, "amsgrad": True}},
    "adam_bf16_moments": {"type": "Adam", "hyperparams": {"lr": 1e-3,
                                                          "moment_dtype": "bfloat16"}},
    "adamw": {"type": "AdamW", "hyperparams": {"lr": 1e-3, "weight_decay": 0.05}},
    "adamw_amsgrad": {"type": "AdamW", "hyperparams": {"lr": 1e-3, "amsgrad": True}},
    "adamw_bf16_moments": {"type": "AdamW", "hyperparams": {"lr": 1e-3,
                                                            "moment_dtype": "bfloat16"}},
    "sgd": {"type": "SGD", "hyperparams": {"lr": 1e-2}},
    "sgd_momentum": {"type": "SGD", "hyperparams": {"lr": 1e-2, "momentum": 0.9}},
    "rmsprop": {"type": "RMSprop", "hyperparams": {"lr": 1e-3}},
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_state_round_trips_through_the_jax_layout(name, tmp_path):
    """Each optimizer's state, saved in the JAX layout, has optax's leaf
    count, shapes and dtypes, and restores to the same state."""
    from hyperpocket_tpu.models import FullModel as JaxModel
    from tests.test_torch_models import tiny_config

    cfg = OPTIMIZERS[name]

    def stepped(seed):
        port = pfm.FullModel.from_config(tiny_config(), torch.Generator().manual_seed(seed))
        opt = optim.make_optimizer(cfg, port.parameters())
        for p in port.parameters():
            p.grad = torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
        opt.step()
        return port, opt

    port, opt = stepped(0)
    leaves = ckpt.optimizer_leaves(port, opt, 1)
    jmodel = JaxModel.from_config(tiny_config())
    want = jax.tree_util.tree_leaves(joptim.make_optimizer(cfg).init(jmodel.init(jax.random.key(0))))
    assert len(leaves) == len(want)
    for got, w in zip(leaves, want):
        assert tuple(got.shape) == w.shape
        assert str(got.dtype).removeprefix("torch.") == str(w.dtype)
    ckpt.save_checkpoint(str(tmp_path / "w"), str(tmp_path / "m"), 1, port, opt, 1, {}, [[0.0]],
                         [[0.0]])
    other, opt2 = stepped(1)
    assert ckpt.restore_model_state(str(tmp_path / "w"), str(tmp_path / "m"), 1, "latest",
                                    other, opt2) == (1, 1)
    for p, q in zip(port.parameters(), other.parameters()):
        assert torch.equal(p, q)
        state, restored = opt.state[p], opt2.state[q]
        assert state.keys() == restored.keys()
        for key, value in state.items():
            if torch.is_tensor(value) and value.ndim:
                assert torch.equal(value, restored[key]), (name, key)
            else:
                assert float(value) == float(restored[key]), (name, key)


@pytest.mark.parametrize("moment_dtype", ["bfloat16", "float16"])
def test_lowp_adam_matches_scale_by_adam_lowp(moment_dtype):
    rng = np.random.default_rng(3)
    shapes = [(6, 5), (7,)]
    params0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
             for scale in (1.0, 0.1, 0.5, 2.0)]
    tx = joptim.scale_by_adam_lowp(0.9, 0.999, 1e-8, moment_dtype)
    jparams = [jnp.asarray(p) for p in params0]
    state = tx.init(jparams)
    tparams = [torch.tensor(p, requires_grad=True) for p in params0]
    opt = optim.make_optimizer({"type": "Adam", "hyperparams": {"lr": 1.0,
                                                                "moment_dtype": moment_dtype}},
                               tparams)
    assert isinstance(opt, optim.AdamLowp)
    for g in grads:
        updates, state = tx.update([jnp.asarray(a) for a in g], state)
        before = [p.detach().clone() for p in tparams]
        for p, a in zip(tparams, g):
            p.grad = torch.tensor(a)
        opt.step()
        for i, p in enumerate(tparams):
            st = opt.state[p]
            mu = np.asarray(jnp.asarray(state.mu[i], jnp.float32))
            nu = np.asarray(jnp.asarray(state.nu[i], jnp.float32))
            assert str(st["exp_avg"].dtype) == f"torch.{moment_dtype}"
            assert np.array_equal(st["exp_avg"].float().numpy(), mu)
            assert np.array_equal(st["exp_avg_sq"].float().numpy(), nu)
            got_update = (p.detach() - before[i]).numpy()  # lr 1: the update itself
            np.testing.assert_allclose(got_update, -np.asarray(updates[i]), rtol=1e-6, atol=1e-7)


def test_lowp_adam_moments_are_written_as_jax_bf16_words(tmp_path):
    """bf16 moments are written as the JAX package writes them: raw 2-byte
    words, numpy ``|V2``, the bits of a JAX bf16 array of the moment."""
    from tests.test_torch_models import tiny_config

    cfg = {"type": "Adam", "hyperparams": {"lr": 1e-3, "moment_dtype": "bfloat16"}}
    port = pfm.FullModel.from_config(tiny_config(), torch.Generator().manual_seed(0))
    opt = optim.make_optimizer(cfg, port.parameters())
    for p in port.parameters():
        p.grad = torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
    opt.step()
    ckpt.save_checkpoint(str(tmp_path / "w"), str(tmp_path / "m"), 1, port, opt, 1, {}, [[0.0]],
                         [[0.0]])
    arrays = _npz(tmp_path / "w" / "00001_O.npz")
    assert arrays[3].dtype == np.dtype("V2")
    mu_heads_bias = opt.state[port.hyper_network.heads.bias]["exp_avg"]
    want = np.asarray(jnp.asarray(mu_heads_bias.float().numpy(), jnp.bfloat16))
    assert arrays[3].tobytes() == want.tobytes()


def test_moment_dtype_with_amsgrad_raises():
    p = [torch.zeros(2, requires_grad=True)]
    with pytest.raises(ValueError, match="amsgrad"):
        optim.make_optimizer({"type": "Adam", "hyperparams": {"amsgrad": True,
                                                              "moment_dtype": "bfloat16"}}, p)
    with pytest.raises(ValueError, match="amsgrad"):
        joptim.make_optimizer({"type": "Adam", "hyperparams": {"amsgrad": True,
                                                               "moment_dtype": "bfloat16"}})


def test_trainer_refuses_what_the_port_lacks(data_root, tmp_path):
    """A one-process run asked for more ranks raises the JAX package's errors
    (``make_mesh``'s and the Trainer's model-axis check); a forced mesh
    needs a process group (tests/test_torch_parallel_*.py run the groups)."""
    cfg = _config(data_root, tmp_path / "mesh")
    cfg["training"]["parallel"] = {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        trainer.Trainer(cfg, device="cpu")
    cfg["training"]["parallel"] = {"data": None, "model": 2}
    with pytest.raises(ValueError, match="parallel.model=2 does not divide 1 devices"):
        trainer.Trainer(cfg, device="cpu")
    cfg["training"]["parallel"] = {"data": None, "model": 1}
    with pytest.raises(RuntimeError, match="process group"):
        trainer.Trainer(cfg, device="cpu", use_mesh=True)
    cfg["training"]["parallel"] = {"data": None, "model": 1}
    cfg["training"]["epoch_mode"] = "scan"
    t = trainer.Trainer(cfg, device="cpu")
    assert t.epoch_mode == "scan" and t.scan_invocations == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer.Trainer(cfg)


def test_profile_writes_a_torch_trace(data_root, tmp_path, same_val_balls):
    cfg = _config(data_root, tmp_path / "prof", max_epoch=1, dtype="float32",
                  profile={"enable": True, "epochs": 1, "dir": str(tmp_path / "trace")})
    trainer.Trainer(cfg, device="cpu").run(plot_samples=False)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_cli_training_writes_the_jax_file_set(data_root, tmp_path, same_val_balls):
    """Both CLIs, one epoch with sample plots, write the same files."""
    from hyperpocket_tpu import cli as jcli

    trees = {}
    for name in ("jax", "port"):
        cfg = _config(data_root, tmp_path / name, max_epoch=1, dtype="float32")
        if name == "jax":
            jcli.main(cfg)
        else:
            t = cli.main(cfg, device="cpu")
            assert isinstance(t, trainer.Trainer) and len(t.train_losses) == 1
        base = tmp_path / name
        trees[name] = sorted(str(p.relative_to(base)) for p in base.rglob("*") if p.is_file())
    assert trees["port"] == trees["jax"]
    assert any(f.endswith("00001_O.npz") for f in trees["port"])
    assert any(f.endswith("_reconstructed.png") for f in trees["port"])
