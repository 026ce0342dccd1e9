"""Tensor parallelism, checkpoints under it, and the point-sharded ring, on four gloo ranks.

One spawn of four CPU processes (``tests/torch_parallel_workers.py``) runs
every parallel case of this module; the assertions compare its results with
one-process runs of the port and with the JAX package, here.

* Three fp64 train steps on a 2 x 2 (data, model) mesh equal the port's
  one-process steps (rtol 1e-10) and the JAX step on ``make_mesh(2, 2)``
  with ``param_shardings`` (the fp64 trajectory budget). Exactly the leaves
  JAX's rule shards are split, and their Adam moments are the shards'.
* A ``Trainer`` on the 2 x 2 mesh writes the one-process checkpoint files
  (rtol 1e-10), the JAX package reads them, and training resumes across
  the layouts in both directions and from a JAX-written checkpoint.
* The ring: at world 4 and over rank pairs, fp64, N != M and N == M, the
  distances equal ``nn_distance``'s and the indices are equal; the Chamfer
  value and gradient are within 1e-12 of the unsharded ones and of the JAX
  package's ``nn_distance_point_sharded`` on 4 and 2 virtual devices.
"""

from __future__ import annotations

import json
import shutil
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperpocket_tpu.models import full_model as jfm
from hyperpocket_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hyperpocket_tpu.parallel.mesh import opt_state_shardings, param_shardings
from hyperpocket_tpu.parallel.mesh import shard_batch as jax_shard_batch
from hyperpocket_tpu.parallel.point_sharding import (
    chamfer_loss_point_sharded as jax_ring_chamfer,
    nn_distance_point_sharded as jax_ring,
)
from hyperpocket_tpu.train import checkpoint as jckpt
from hyperpocket_tpu.train import optim as joptim
from hyperpocket_tpu.train import trainer as jtrainer
from hyperpocket_tpu_torch.convert import jax_leaf_names
from hyperpocket_tpu_torch.models.full_model import FullModel
from hyperpocket_tpu_torch.ops.chamfer import nn_distance
from hyperpocket_tpu_torch.train import trainer
from hyperpocket_tpu_torch.train.config import get_results_dir_path
from tests.test_torch_models import tiny_config
from tests.test_torch_parallel_dp import (
    ADAM,
    K,
    N_GT,
    RTOL,
    assert_trajectory,
    jax_init_fp64,
    make_data_root,
    port_steps,
    step_data,
    trainer_config,
    worker_leaves,
)
from tests.torch_parallel_workers import spawn

WORLD = 4
RING_CASES = [(2, 64, 128, 1), (2, 96, 96, 2)]  # (batch, N, M, seed): N != M, then N == M


def jax_tp_steps(jmodel, params, data: dict):
    """The JAX train step on the 2 x 2 mesh with ``param_shardings``, fp64."""
    with jax.enable_x64(True):
        mesh = jax_make_mesh(2, 2)
        tx = joptim.make_optimizer(ADAM)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        shardings = param_shardings(mesh, p)
        p = jax.tree_util.tree_map(jax.device_put, p, shardings)
        o = jax.jit(tx.init, out_shardings=opt_state_shardings(
            mesh, jax.eval_shape(tx.init, p), p, shardings))(p)
        step = jtrainer.make_train_step(jmodel, tx, 0.05)
        losses, leaves = [], []
        for k in range(K):
            ex, mi, gt = jax_shard_batch(mesh, *(jnp.asarray(data[n][k])
                                                 for n in ("existing", "missing", "gt")))
            p, o, *out, _ = step(p, o, ex, mi, gt, np.uint32(k), jnp.asarray(1.0),
                                 num_points=N_GT, vae_eps=jnp.asarray(data["vae_eps"][k]),
                                 ball_points=jnp.asarray(data["ball_points"][k]))
            losses.append([float(v) for v in out])
            leaves.append([np.array(a, copy=True) for a in jax.tree_util.tree_leaves(p)])
    return np.asarray(losses), leaves


def _weights(config) -> str:
    return join(get_results_dir_path(config, "training"), "weights")


def _run_port(config):
    t = trainer.Trainer(config, device="cpu")
    t.run(plot_samples=False)
    return t


def _jax_resave(config_from, config_to, epoch: int) -> None:
    """Restore a checkpoint with the JAX package and save it again with it."""
    cfg = dict(config_from["full_model"], compute_dtype="float64")
    jmodel = jfm.FullModel.from_config(cfg)
    with jax.enable_x64(True):
        params = jmodel.init(jax.random.key(0), dtype=jnp.float64)
        opt = joptim.make_optimizer(config_from["training"]["optimizer"]).init(params)
        src_w = _weights(config_from)
        src_m = join(get_results_dir_path(config_from, "training"), "metrics")
        _, params, opt = jckpt.restore_model_state(src_w, src_m, epoch, "latest", params, opt)
        train, val, _ = jckpt.restore_metrics(src_m, epoch)
        with open(join(src_w, f"{epoch:05}_S.json")) as fh:
            sched = json.load(fh)
        dst = get_results_dir_path(config_to, "training")
        jckpt.save_checkpoint(join(dst, "weights"), join(dst, "metrics"), epoch, params, opt,
                              sched, train, val)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    cfg = tiny_config(compute_dtype="float64")
    _, params, state = jax_init_fp64(cfg)
    np.savez(out / "state.npz", **{k: v.numpy() for k, v in state.items()})
    np.savez(out / "data.npz", **step_data())
    data_root = make_data_root(tmp_path_factory.mktemp("data"))
    configs = {tag: trainer_config(data_root, out / tag, max_epoch=3 if "3" in tag else 2)
               for tag in ("one", "tp", "one3", "from_one3", "from_jax3", "from_tp3")}
    _run_port(configs["one"])
    shutil.copytree(out / "one", out / "from_one3")
    _jax_resave(configs["one"], configs["from_jax3"], 2)
    spawn([("train_steps", dict(cfg=cfg, state_path=str(out / "state.npz"),
                                data_path=str(out / "data.npz"), n_model=2, adam=ADAM)),
           ("trainer_run", dict(config=configs["tp"], tag="tp", n_model=2)),
           ("trainer_run", dict(config=configs["from_one3"], tag="from_one3", n_model=2)),
           ("trainer_run", dict(config=configs["from_jax3"], tag="from_jax3", n_model=2)),
           ("ring", dict(cases=RING_CASES))], WORLD, out)
    return {"out": out, "cfg": cfg, "params": params, "state": state, "configs": configs}


def _npz(run, name):
    return np.load(run["out"] / f"{name}.npz")


def test_tp_steps_match_one_process_and_the_jax_mesh_fp64(run):
    res = _npz(run, "train_steps_2")
    got_leaves = [worker_leaves(res, k) for k in range(K)]
    data = step_data()
    one_losses, one_leaves = port_steps(run["cfg"], run["state"], data)
    assert_trajectory(res["losses"], got_leaves, one_losses, one_leaves, RTOL)
    jmodel = jfm.FullModel.from_config(run["cfg"])
    jax_losses, jax_leaves = jax_tp_steps(jmodel, run["params"], data)
    assert_trajectory(res["losses"], got_leaves, jax_losses, jax_leaves, 1e-9, 1e-8)


def test_only_jax_rules_leaves_are_split(run):
    """The case of tests/test_parallel.py::test_tp_sharding_rules: the port's
    split dimension of each leaf is JAX's ``param_shardings`` axis on the
    transposed weight; the local shapes and the Adam moments are halved there."""
    with open(run["out"] / "train_steps_2.json") as fh:
        meta = json.load(fh)
    port = FullModel.from_config(run["cfg"])
    names = jax_leaf_names(port)
    full = dict(port.named_parameters())
    specs = jax.tree_util.tree_leaves(
        param_shardings(jax_make_mesh(4, 2), run["params"]),
        is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    split = []
    for name, sharding in zip(names, specs):
        spec = tuple(sharding.spec) + (None,) * (2 - len(tuple(sharding.spec)))
        want = None
        if "model" in spec:
            axis = spec.index("model")
            want = (1 - axis) if name.endswith(".weight") else axis
        assert meta["specs"][name] == want, name
        shape = list(full[name].shape)
        if want is not None:
            shape[want] //= 2
            split.append(name)
        assert meta["local_shapes"][name] == shape, name
        if name in meta["moment_shapes"]:  # the real encoder's unused std head has none
            assert meta["moment_shapes"][name] == shape, name
    assert sorted(split) == ["hyper_network.heads.weight", "hyper_network.trunk.4.bias",
                             "hyper_network.trunk.4.weight"]
    # the gathered moments of the split leaves are the one-process moments' shape
    res = _npz(run, "train_steps_2")
    for name in split:
        assert res[f"m_{name}"].shape == tuple(full[name].shape)


def _assert_same_files(got_weights: str, want_weights: str, epochs) -> None:
    for epoch in epochs:
        for kind in ("model", "O"):
            name = f"{epoch:05}_{kind}.npz"
            with np.load(join(got_weights, name)) as got, np.load(join(want_weights, name)) as want:
                assert got.files == want.files
                for f in want.files:
                    w = want[f]
                    assert got[f].dtype == w.dtype and got[f].shape == w.shape, (name, f)
                    assert np.abs(got[f] - w).max() <= RTOL * max(np.abs(w).max(), 1e-30), (name, f)


def test_tp_checkpoint_is_the_one_process_file(run):
    configs = run["configs"]
    res = _npz(run, "trainer_tp")
    np.testing.assert_array_equal(res["mesh"], [2, 2])
    np.testing.assert_array_equal(res["writers"], [1, 0, 0, 0])
    _assert_same_files(_weights(configs["tp"]), _weights(configs["one"]), (1, 2))
    with np.load(join(_weights(configs["one"]), "00002_model.npz")) as want:
        want = [want[f"arr_{i}"] for i in range(len(want.files))]
    # the JAX package reads the file rank 0 wrote
    jmodel = jfm.FullModel.from_config(run["cfg"])
    with jax.enable_x64(True):
        template = jmodel.init(jax.random.key(0), dtype=jnp.float64)
        tp_dir = get_results_dir_path(configs["tp"], "training")
        _, params, _ = jckpt.restore_model_state(join(tp_dir, "weights"),
                                                 join(tp_dir, "metrics"), 2, "latest", template)
    for got, w in zip(jax.tree_util.tree_leaves(params), want):
        assert np.abs(np.asarray(got) - w).max() <= RTOL * max(np.abs(w).max(), 1e-30)


def test_resume_across_layouts_and_packages(run):
    """Epoch 3 from epoch 2's checkpoint: one process from the TP files, the
    TP mesh from one process's files and from the JAX package's, all equal
    the uninterrupted one-process run."""
    configs, out = run["configs"], run["out"]
    shutil.copytree(out / "one", out / "one3")
    want = _run_port(configs["one3"])
    assert want.start_epoch == 3
    shutil.copytree(out / "tp", out / "from_tp3")
    got = _run_port(configs["from_tp3"])
    assert got.start_epoch == 3 and got._seed_counter == want._seed_counter
    _assert_same_files(_weights(configs["from_tp3"]), _weights(configs["one3"]), (3,))
    for tag in ("from_one3", "from_jax3"):
        res = _npz(run, f"trainer_{tag}")
        assert int(res["start_epoch"]) == 3 and int(res["seed_counter"]) == want._seed_counter
        np.testing.assert_allclose(res["train"], np.asarray(want.train_losses), rtol=RTOL)
        np.testing.assert_allclose(res["val"], np.asarray(want.val_losses), rtol=RTOL)
        _assert_same_files(_weights(configs[tag]), _weights(configs["one3"]), (3,))


@pytest.mark.parametrize("case", range(len(RING_CASES)))
@pytest.mark.parametrize("size", [WORLD, 2])
def test_ring_matches_the_unsharded_nn_and_the_jax_ring(run, case, size):
    batch, n, m, seed = RING_CASES[case]
    res = _npz(run, "ring")
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(batch, n, 3, generator=g, dtype=torch.float64).requires_grad_(True)
    b = torch.randn(batch, m, 3, generator=g, dtype=torch.float64).requires_grad_(True)
    d1, i1, d2, i2 = nn_distance(a, b)
    (d1.sum() + d2.sum()).backward()
    got = {k: res[f"{case}_{size}_{k}"] for k in ("d1", "i1", "d2", "i2", "ga", "gb", "value")}
    np.testing.assert_allclose(got["d1"], d1.detach().numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got["d2"], d2.detach().numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got["i1"], i1.numpy())
    np.testing.assert_array_equal(got["i2"], i2.numpy())
    value = (d1.sum() + d2.sum()).item()
    assert abs(float(got["value"]) - value) <= 1e-12 * abs(value)
    np.testing.assert_allclose(got["ga"], a.grad.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got["gb"], b.grad.numpy(), rtol=1e-12, atol=1e-12)
    with jax.enable_x64(True):
        mesh = jax_make_mesh(size, 1)
        ring_and_grad = jax.jit(lambda x, y: (jax_ring(x, y, mesh), jax.value_and_grad(
            jax_ring_chamfer, argnums=(0, 1))(x, y, mesh)))
        (jd1, ji1, jd2, ji2), (jval, (jga, jgb)) = ring_and_grad(
            jnp.asarray(a.detach().numpy()), jnp.asarray(b.detach().numpy()))
    np.testing.assert_allclose(got["d1"], np.asarray(jd1), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got["d2"], np.asarray(jd2), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got["i1"], np.asarray(ji1))
    np.testing.assert_array_equal(got["i2"], np.asarray(ji2))
    assert abs(float(got["value"]) - float(jval)) <= 1e-12 * abs(value)
    np.testing.assert_allclose(got["ga"], np.asarray(jga), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got["gb"], np.asarray(jgb), rtol=1e-12, atol=1e-12)


def test_ring_refuses_shards_that_do_not_fit(run):
    errors = _npz(run, "ring")["errors"]
    assert "point count 18 must divide the 4-way ring" in errors[0]
    assert "differ in shape across ranks" in errors[1]
